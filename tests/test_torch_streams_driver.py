"""The port's ``StreamingDriver`` (``streams/driver.py``) against the JAX
package's over the same log, on the CPU. Both online models initialize
rows through a ``FunctionFactorInitializer`` over one numpy table, so ids
→ rows are equal and the tables stay within rtol 1e-5 / atol 1e-6 (the bar
of tests/test_torch_online.py); consumed offsets, batch and checkpoint
counts are equal. Then the recovery contract on the port: kill/restart
with zero loss and bounded duplication, the frozen-stamp checkpoint hold,
resume from a JAX driver's checkpoint, delta refresh = full refresh, and
the adaptive model's history rebuild."""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from large_scale_recommendation_tpu.core.generators import (
    SyntheticMFGenerator as JGenerator,
)
from large_scale_recommendation_tpu.core.initializers import (
    FunctionFactorInitializer as JFunctionInit,
)
from large_scale_recommendation_tpu.models.online import OnlineMF as JOnline
from large_scale_recommendation_tpu.models.online import (
    OnlineMFConfig as JConfig,
)
from large_scale_recommendation_tpu.streams import driver as jdriver
from large_scale_recommendation_tpu.streams import log as jlog
from large_scale_recommendation_tpu.streams import sources as jsrc
from large_scale_recommendation_tpu_torch.core.initializers import (
    FunctionFactorInitializer,
)
from large_scale_recommendation_tpu_torch.models.adaptive import (
    AdaptiveMF,
    AdaptiveMFConfig,
)
from large_scale_recommendation_tpu_torch.models.online import (
    OnlineMF,
    OnlineMFConfig,
)
from large_scale_recommendation_tpu_torch.streams import (
    EventLog,
    StreamingDriver,
    StreamingDriverConfig,
)
from large_scale_recommendation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
)

TOL = dict(rtol=1e-5, atol=1e-6)
RANK = 4
_INIT = np.random.default_rng(42).uniform(
    -0.3, 0.3, (4096, RANK)).astype(np.float32)


def _online(pkg="port"):
    if pkg == "jax":
        init = JFunctionInit(RANK, lambda ids: jnp.asarray(
            _INIT[np.asarray(ids)]))
        return JOnline(JConfig(num_factors=RANK, minibatch_size=64,
                               learning_rate=0.05),
                       user_initializer=init, item_initializer=init)
    init = FunctionFactorInitializer(
        RANK, lambda ids: torch.from_numpy(_INIT[ids.cpu().numpy()]))
    return OnlineMF(OnlineMFConfig(num_factors=RANK, minibatch_size=64,
                                   learning_rate=0.05),
                    user_initializer=init, item_initializer=init,
                    device="cpu")


def _fill(path, n_batches=6, batch=400, seed=0, partitions=1, log=None):
    """Append ``n_batches`` generated batches to partition 0 (the JAX
    package writes the log; both read it)."""
    log = log or jlog.EventLog(path, num_partitions=partitions, fsync=False)
    gen = JGenerator(num_users=60, num_items=40, rank=4, seed=seed)
    jsrc.pump_to_log(jsrc.GeneratorSource(gen, batch, num_batches=n_batches),
                     log)
    return log


def _assert_close(p, j):
    for pt, jt in ((p.users, j.users), (p.items, j.items)):
        np.testing.assert_array_equal(pt.id_array(), jt.id_array())
        n = pt.num_rows
        np.testing.assert_allclose(pt.array[:n].numpy(),
                                   np.asarray(jt.array)[:n], **TOL)
    assert p.step == j.step and p.consumed_offsets == j.consumed_offsets


@pytest.mark.parametrize("every", [1, 4])
def test_driver_matches_jax_over_the_same_log(tmp_path, every):
    _fill(str(tmp_path / "log"))
    cfg = dict(batch_records=500, checkpoint_every=every)
    jm, pm = _online("jax"), _online()
    jd = jdriver.StreamingDriver(
        jm, jlog.EventLog(str(tmp_path / "log"), fsync=False),
        str(tmp_path / "jck"), config=jdriver.StreamingDriverConfig(**cfg))
    pd = StreamingDriver(pm, EventLog(str(tmp_path / "log"), fsync=False),
                         str(tmp_path / "pck"),
                         config=StreamingDriverConfig(**cfg))
    assert not pd.resume() and not jd.resume()
    assert pd.run() == jd.run() == 5  # ceil(2400 / 500)
    _assert_close(pm, jm)
    pt, jt = pd.telemetry(), jd.telemetry()
    assert pt["consumed_offset"] == jt["consumed_offset"] == 2400
    assert pd.checkpoints_written == jd.checkpoints_written == \
        (5 if every == 1 else 2)
    for key in ("records_processed", "lag_records", "batches_processed"):
        assert pt[key] == jt[key]
    assert set(pt["queue"]) == set(jt["queue"])
    assert pt["queue"]["dequeued_records"] == jt["queue"]["dequeued_records"]
    ck, jck = (CheckpointManager(str(tmp_path / d)).restore()
               for d in ("pck", "jck"))
    assert ck.meta == jck.meta


class _Crash(RuntimeError):
    pass


def test_kill_restart_zero_loss_bounded_duplication(tmp_path):
    total = 6 * 400
    log = EventLog(str(_fill(str(tmp_path / "log")).directory), fsync=False)
    applied: list[tuple[int, int]] = []

    def crash_at_3(batch):
        applied.append((batch.start_offset, batch.end_offset))
        if len(applied) == 3:
            raise _Crash()

    cfg = StreamingDriverConfig(batch_records=400)
    d1 = StreamingDriver(_online(), log, str(tmp_path / "ck"), config=cfg,
                         on_batch=crash_at_3)
    with pytest.raises(_Crash):
        d1.run()
    d2 = StreamingDriver(_online(), log, str(tmp_path / "ck"), config=cfg,
                         on_batch=lambda b: applied.append(
                             (b.start_offset, b.end_offset)))
    assert d2.resume() and d2.consumed_offset == 800
    d2.run()
    covered = np.zeros(total, np.int32)
    for lo, hi in applied:
        covered[lo:hi] += 1
    assert (covered >= 1).all(), "lost ratings"
    assert sorted({r for r in applied if (covered[r[0]:r[1]] > 1).any()}) \
        == [(800, 1200)]  # exactly the one unacked batch
    assert d2.consumed_offset == total and d2.telemetry()["lag_records"] == 0


def test_crash_writes_no_checkpoint_and_retention_chases_it(tmp_path):
    log = EventLog(str(tmp_path / "log"), segment_records=256, fsync=False)
    _fill(None, n_batches=5, batch=256, log=log)
    d = StreamingDriver(_online(), log, str(tmp_path / "ck0"),
                        config=StreamingDriverConfig(batch_records=400),
                        on_batch=lambda b: (_ for _ in ()).throw(_Crash()))
    with pytest.raises(_Crash):
        d.run()
    assert CheckpointManager(str(tmp_path / "ck0")).latest_step() is None
    d = StreamingDriver(_online(), log, str(tmp_path / "ck1"),
                        config=StreamingDriverConfig(batch_records=256,
                                                     truncate_log=True))
    d.run()
    assert (log.start_offset(0), log.end_offset(0)) == (1024, 1280)


def test_checkpoint_held_while_the_stamp_is_frozen(tmp_path):
    log = EventLog(str(_fill(str(tmp_path / "log"), 3).directory),
                   fsync=False)
    model = _online()
    real_fit = model.partial_fit
    frozen = [True]

    def fit(batch, offset=None, emit_updates=False):
        return real_fit(batch, offset=None if frozen[0] else offset,
                        emit_updates=emit_updates)

    def unfreeze_after_2(batch):
        if batch.end_offset >= 800:
            frozen[0] = False

    model.partial_fit = fit
    drv = StreamingDriver(model, log, str(tmp_path / "ck"),
                          config=StreamingDriverConfig(batch_records=400),
                          on_batch=unfreeze_after_2)
    drv.run()
    # batches 1-2 held (stamp frozen), batch 3 writes the covering one
    assert drv.checkpoints_written == 1 and drv.consumed_offset == 1200
    d2 = StreamingDriver(_online(), log, str(tmp_path / "ck"),
                         config=StreamingDriverConfig(batch_records=400))
    assert d2.resume() and d2.consumed_offset == 1200


def test_resume_from_a_jax_drivers_checkpoint(tmp_path):
    """A JAX driver crashes after batch 3; a port driver and a JAX driver
    each resume from its checkpoint and drain the log: same offsets,
    tables within the bar."""
    jl = _fill(str(tmp_path / "log"))
    hits = [0]

    def crash_at_3(batch):
        hits[0] += 1
        if hits[0] == 3:
            raise _Crash()

    cfg = dict(batch_records=400, checkpoint_every=2)
    jd = jdriver.StreamingDriver(_online("jax"), jl, str(tmp_path / "ck"),
                                 config=jdriver.StreamingDriverConfig(**cfg),
                                 on_batch=crash_at_3)
    with pytest.raises(_Crash):
        jd.run()
    jm, pm = _online("jax"), _online()
    j2 = jdriver.StreamingDriver(jm, jl, str(tmp_path / "ck"),
                                 config=jdriver.StreamingDriverConfig(**cfg))
    p2 = StreamingDriver(pm, EventLog(str(tmp_path / "log"), fsync=False),
                         str(tmp_path / "ck"),
                         config=StreamingDriverConfig(**cfg))
    assert p2.resume() and p2.consumed_offset == 800
    assert j2.resume()
    _assert_close(pm, jm)
    assert p2.run() == 4
    assert j2.run() == 4
    _assert_close(pm, jm)


def test_delta_refresh_equals_a_full_refresh(tmp_path):
    log = EventLog(str(_fill(str(tmp_path / "log"), 4).directory),
                   fsync=False)
    drv = StreamingDriver(_online(), log, str(tmp_path / "ck"),
                          config=StreamingDriverConfig(batch_records=400))
    drv.run(max_batches=2)
    engine = drv.serving_engine(k=5)
    v0 = engine.version
    drv.run()  # two more batches over the same vocabulary
    assert drv.telemetry()["dirty_users"] > 0
    drv.refresh_serving(delta=True)  # raises if a delta was not possible
    assert engine.version != v0 and drv.catalog_versions[-1] == \
        engine.version
    assert drv.telemetry()["dirty_users"] == 0
    fresh = drv.model.to_model()
    assert torch.equal(engine.model.U, fresh.U)
    assert torch.equal(engine.model.V, fresh.V)
    users = np.arange(60)
    ids, scores = engine.recommend(users)
    ref_ids, ref_scores = fresh.recommend(users, k=5)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(scores, ref_scores)


def test_early_stop_surfaces_a_feeder_fault(tmp_path):
    log = EventLog(str(_fill(str(tmp_path / "log"), 3).directory),
                   fsync=False)
    real_read, faulted = log.read, threading.Event()
    calls = [0]

    def read(partition, start, n):
        calls[0] += 1
        if calls[0] > 1:
            faulted.set()
            raise RuntimeError("tail io fault")
        return real_read(partition, start, n)

    log.read = read
    drv = StreamingDriver(_online(), log, str(tmp_path / "ck"),
                          config=StreamingDriverConfig(batch_records=400),
                          on_batch=lambda b: faulted.wait(30))
    with pytest.raises(RuntimeError, match="tail io fault"):
        drv.run(max_batches=1)
    assert drv.checkpoints_written == 1


def test_lag_is_per_partition(tmp_path):
    jl = jlog.EventLog(str(tmp_path / "log"), num_partitions=2, fsync=False)
    gen = JGenerator(num_users=60, num_items=40, rank=4, seed=2)
    for p, n in ((0, 2), (1, 3)):
        jsrc.pump_to_log(jsrc.GeneratorSource(gen, 400, num_batches=n), jl,
                         partition=p)
    log = EventLog(str(tmp_path / "log"), num_partitions=2, fsync=False)
    drv = StreamingDriver(_online(), log, str(tmp_path / "ck"),
                          config=StreamingDriverConfig(batch_records=400))
    drv.run()
    tele = drv.telemetry()
    assert (tele["consumed_offset"], tele["lag_records"]) == (800, 0)
    assert log.lag({0: 800}) == 1200


def _adaptive():
    return AdaptiveMF(AdaptiveMFConfig(num_factors=RANK, minibatch_size=64,
                                       offline_every=3,
                                       offline_iterations=2), device="cpu")


def test_adaptive_crash_resume_rebuilds_history_and_swaps(tmp_path):
    log = EventLog(str(_fill(str(tmp_path / "log"), 8, 300).directory),
                   fsync=False)
    hits = [0]

    def crash_at_4(batch):
        hits[0] += 1
        if hits[0] == 4:
            raise _Crash()

    cfg = StreamingDriverConfig(batch_records=300)
    d1 = StreamingDriver(_adaptive(), log, str(tmp_path / "ck"), config=cfg,
                         on_batch=crash_at_4)
    with pytest.raises(_Crash):
        d1.run()
    m2 = _adaptive()
    d2 = StreamingDriver(m2, log, str(tmp_path / "ck"), config=cfg)
    assert d2.resume() and d2.consumed_offset == 900
    assert m2._history_rows == 900
    assert d2.resume() and m2._history_rows == 900  # no doubled rows
    engine = d2.serving_engine(k=3)
    v0 = engine.version
    d2.run()
    assert m2.retrain_count >= 1 and engine.version != v0
    assert d2.catalog_versions[0] == v0
    assert engine.version in d2.catalog_versions[1:]
    assert d2.consumed_offset == 2400


# -- StreamingDriver's registry instruments and telemetry export -----------


@pytest.fixture
def both_obs_live():
    """Live registries in both packages; the defaults restored after."""
    from large_scale_recommendation_tpu import obs as jobs
    from large_scale_recommendation_tpu.obs import registry as jreg
    from large_scale_recommendation_tpu_torch import obs

    jprev, pprev = jreg.get_registry(), obs.get_registry()
    jr, _ = jobs.enable()
    pr, _ = obs.enable()
    yield jr, pr
    jreg.set_registry(jprev)
    obs.disable()
    obs.set_registry(pprev)


# the instruments whose values do not depend on the feeder thread's timing
# (queue depth and high-water do)
EXACT = ("streams_batches_total", "streams_records_total",
         "streams_lag_records", "streams_queue_dequeued_records")


def _metric_values(reg):
    """Every ``streams_*`` instrument's name and labels, with the value of
    the ones in ``EXACT``."""
    return sorted((m["name"], sorted(m["labels"].items()),
                   m["value"] if m["name"] in EXACT else None)
                  for m in reg.snapshot()["metrics"]
                  if m["name"].startswith("streams_"))


def test_driver_publishes_the_jax_instruments(tmp_path, both_obs_live):
    """The same log through both drivers with obs on: the same
    ``streams_*`` names and labels, the same batch, record, lag and
    dequeued counts and checkpoint count (walls and the feeder's
    timing-dependent queue depths are not compared), and ``telemetry()``
    refreshes the lag and queue gauges."""
    jr, pr = both_obs_live
    _fill(str(tmp_path / "log"))
    cfg = dict(batch_records=500, checkpoint_every=2)
    jd = jdriver.StreamingDriver(
        _online("jax"), jlog.EventLog(str(tmp_path / "log"), fsync=False),
        str(tmp_path / "jck"), config=jdriver.StreamingDriverConfig(**cfg))
    pd = StreamingDriver(_online(), EventLog(str(tmp_path / "log"),
                                             fsync=False),
                         str(tmp_path / "pck"),
                         config=StreamingDriverConfig(**cfg))
    pd.run()
    jd.run()
    # a growing log: lag the telemetry pass must see
    _fill(str(tmp_path / "log"), n_batches=1, batch=100, seed=3)
    assert pd.telemetry()["lag_records"] == jd.telemetry()["lag_records"]
    assert _metric_values(pr) == _metric_values(jr)
    (pc,), (jc,) = (r.find("streams_checkpoint_s") for r in (pr, jr))
    assert pc.count == jc.count == 3
    assert pr.gauge("streams_lag_records", partition="0").value == 100


def test_telemetry_export_keeps_the_lag_gauge_fresh(tmp_path, both_obs_live):
    """The exporter publishes ``telemetry()`` on its cadence: a
    ``/metrics`` scrape after the run shows the lag ``telemetry()``
    reports, and the exporter stops cleanly."""
    from large_scale_recommendation_tpu_torch.obs.fleet import (
        parse_prometheus,
    )
    from large_scale_recommendation_tpu_torch.obs.server import (
        ObsServer,
        http_get,
    )

    _, pr = both_obs_live
    log = _fill(str(tmp_path / "log"))
    pd = StreamingDriver(_online(), EventLog(str(tmp_path / "log"),
                                             fsync=False),
                         str(tmp_path / "pck"),
                         config=StreamingDriverConfig(batch_records=500))
    task = pd.start_telemetry_export(0.02)
    assert pd.start_telemetry_export(0.02) is task  # idempotent
    server = ObsServer(registry=pr).start()
    try:
        pd.run()
        _fill(None, n_batches=1, batch=50, seed=5, log=log)
        want = pd.telemetry()["lag_records"]
        assert want == 50
        gauge = pr.gauge("streams_lag_records", partition="0")
        gauge.set(-1)  # only the exporter can put the lag back
        deadline = time.time() + 10
        while gauge.value != want and time.time() < deadline:
            time.sleep(0.02)
        code, text = http_get(server.url + "/metrics", timeout=5)
    finally:
        server.stop()
        pd.stop_telemetry_export()
    assert code == 200
    lag = [v for n, lb, v in parse_prometheus(text)
           if n == "streams_lag_records" and lb == {"partition": "0"}]
    assert lag == [50.0]
    assert task.runs >= 1 and task.errors == 0
    assert not task.running and pd._telemetry_task is None
    pd.stop_telemetry_export()  # stopping twice is a no-op
