"""The port's lineage journal (``obs.lineage``) against the JAX package's:
the same swaps, ingest marks and verdicts with explicit wall times give
equal provenance records, ``/lineagez`` snapshots, freshness summaries
(per partition) and Prometheus text (the ingest→servable histogram), and
``FreshnessCheck`` gives the same verdicts as ingest runs ahead of the
servable watermark; all compared for equality under one pinned clock.
Then the journal on the port's engine and driver on the CPU: every
``refresh`` and ``apply_delta`` stamps exactly one record keyed by the
engine's own version, the driver enriches them with its WAL watermark, a
flush joins its version back (the staleness gauge), and the
``HealthMonitor.watch_freshness`` page trips while swaps stall and clears
after one."""

import time

import numpy as np
import pytest

from large_scale_recommendation_tpu.obs import lineage as jlin
from large_scale_recommendation_tpu.obs import registry as jreg
from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.models.online import (
    OnlineMF,
    OnlineMFConfig,
)
from large_scale_recommendation_tpu_torch.obs import health as ph
from large_scale_recommendation_tpu_torch.obs import lineage as plin
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry
from large_scale_recommendation_tpu_torch.serving import ServingEngine
from large_scale_recommendation_tpu_torch.streams import (
    EventLog,
    StreamingDriver,
    StreamingDriverConfig,
    append_routed,
)
from test_torch_obs_requests import (  # noqa: F401 (fixture)
    cpu_model,
    planes,
    request_stream,
)

T0 = 1_700_000_000.0


def _script(journal, seed):
    """A seeded interleaving of ingest marks, swaps (engine stamps then
    driver enrichment, some multi-partition) and verdicts."""
    rng = np.random.default_rng(seed)
    t = T0
    offs = {0: 0, 1: 0}
    out = []
    for v in range(1, 12):
        for _ in range(int(rng.integers(1, 4))):
            p = int(rng.integers(0, 2))
            offs[p] += int(rng.integers(50, 500))
            t += float(rng.exponential(0.3))
            journal.note_ingest(offs[p], partition=p, t=t)
        t += float(rng.exponential(0.2))
        out.append(journal.record_swap(v, source="engine_refresh",
                                       wall_time=t))
        for p in (0, 1):
            if rng.random() < 0.7:
                out.append(journal.record_swap(
                    v, wal_offset_watermark=offs[p] - int(
                        rng.integers(0, 40)),
                    partition=p, train_step=v * 10, retrain_id=v // 3 or None,
                    source="stream_refresh", wall_time=t + 0.5))
        if v % 4 == 0:
            out.append(journal.record_verdict(
                v, ("PROMOTE", "HOLD", "ROLLBACK")[v % 3], reason="x",
                acted=(v % 8 == 0) or None, wall_time=t + 1.0))
        out.append(journal.observe_serve(v, requests=3) is not None)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_records_snapshot_and_freshness_equal_jax(monkeypatch, seed):
    monkeypatch.setattr(time, "time", lambda: T0 + 100.0)
    preg, jreg_ = MetricsRegistry(), jreg.MetricsRegistry()
    p = plin.LineageJournal(capacity=8, ingest_marks=16, registry=preg)
    j = jlin.LineageJournal(capacity=8, ingest_marks=16, registry=jreg_)
    assert _script(p, seed) == _script(j, seed)
    assert p.snapshot() == j.snapshot()
    assert p.snapshot(limit=3) == j.snapshot(limit=3)
    assert p.freshness() == j.freshness()
    assert p.tail(4) == j.tail(4) and len(p) == len(j)
    assert p.resolve(11) == j.resolve(11)
    assert p.resolve(1) is j.resolve(1) is None  # evicted
    assert preg.to_prometheus() == jreg_.to_prometheus()


def test_freshness_check_equal_jax(monkeypatch):
    now = [T0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    results = []
    for mod, reg in ((plin, MetricsRegistry()),
                     (jlin, jreg.MetricsRegistry())):
        now[0] = T0
        journal = mod.LineageJournal(registry=reg)
        check = mod.FreshnessCheck(journal, degraded_after_s=5.0,
                                   critical_after_s=20.0)
        seq = [check()]
        journal.note_ingest(100, t=T0)
        now[0] = T0 + 25
        seq.append(check())                      # ingest, no watermark
        now[0] = T0
        journal.record_swap(1, wal_offset_watermark=100, wall_time=T0 + 1)
        now[0] = T0 + 2
        seq.append(check())                      # covered: ok
        journal.note_ingest(200, t=T0 + 3)
        now[0] = T0 + 10
        seq.append(check())                      # 7 s behind: degraded
        now[0] = T0 + 30
        seq.append(check())                      # 27 s: critical
        journal.record_swap(2, wal_offset_watermark=200, wall_time=T0 + 31)
        now[0] = T0 + 32
        seq.append(check())                      # cleared
        results.append([(r.status, r.detail) for r in seq])
    assert results[0] == results[1]
    assert [s for s, _ in results[0]] == ["ok", "critical", "ok",
                                         "degraded", "critical", "ok"]


def test_validation_as_jax():
    for mod in (plin, jlin):
        with pytest.raises(ValueError):
            mod.LineageJournal(capacity=0)
        j = mod.LineageJournal()
        with pytest.raises(ValueError):
            j.record_verdict(1, "MAYBE")
        with pytest.raises(ValueError):
            mod.FreshnessCheck(j, degraded_after_s=-1.0)
        with pytest.raises(ValueError):
            mod.FreshnessCheck(j, degraded_after_s=5.0, critical_after_s=1.0)


def test_engine_stamps_one_record_per_swap(planes):
    obs.enable()
    journal = obs.enable_lineage()
    engine = ServingEngine(cpu_model(), k=10)
    v0 = engine.version
    assert journal.swaps == 1
    assert journal.resolve(v0)["source"] == "engine_refresh"
    v1 = engine.refresh(cpu_model(seed=5))
    rng = np.random.default_rng(0)
    v2 = engine.apply_delta(item_rows=[1, 2, 3],
                            V_rows=rng.normal(size=(3, 16)))
    assert journal.swaps == 3 and len({v0, v1, v2}) == 3
    assert journal.resolve(v2)["source"] == "engine_delta"
    assert [r["catalog_version"] for r in journal.tail()] == [v0, v1, v2]
    # a deferred delta stamps nothing until its flush, which stamps once
    engine.apply_delta(item_rows=[4], V_rows=rng.normal(size=(1, 16)),
                       defer=True)
    assert journal.swaps == 3
    v3 = engine.flush_deltas()
    assert journal.swaps == 4 and journal.resolve(v3) is not None
    # the serve-side join: the version the flush served resolves
    engine.serve(request_stream(3))
    assert obs.get_registry().gauge("lineage_staleness_s").value >= 0.0
    joins = obs.get_registry().counter("lineage_serve_joins_total",
                                       resolved="true")
    assert joins.value == 3


def _log(tmp_path, n=6000, seed=0):
    rng = np.random.default_rng(seed)
    log = EventLog(str(tmp_path / "log"), num_partitions=1, fsync=False)
    append_routed(log, rng.integers(0, 300, n), rng.integers(0, 80, n),
                  rng.normal(size=n).astype(np.float32))
    return log


def test_driver_watermarks_and_freshness_page(planes, tmp_path):
    obs.enable()
    journal = obs.enable_lineage()
    model = OnlineMF(OnlineMFConfig(num_factors=8, minibatch_size=256),
                     device="cpu")
    log = _log(tmp_path)
    drv = StreamingDriver(model, log, str(tmp_path / "ck"),
                          config=StreamingDriverConfig(batch_records=1000))
    engine = drv.serving_engine(k=5)
    assert journal.resolve(engine.version)["source"] == "engine_bind"
    monitor = ph.HealthMonitor()
    monitor.watch_freshness(journal, degraded_after_s=0.0)
    assert drv.run() == 6
    # ingest ran ahead of the bind's watermark: the page is up
    assert monitor.run()["checks"]["freshness"]["status"] == "degraded"
    drv.refresh_serving()  # the vocabulary grew: a full refresh
    rec = journal.resolve(engine.version)
    assert rec["source"] == "stream_refresh"
    assert rec["wal_offset_watermark"] == 6000
    assert rec["watermarks"] == {0: 6000}
    assert rec["train_step"] == model.step
    assert monitor.run()["checks"]["freshness"]["status"] == "ok"
    f = journal.freshness()
    assert f["servable_watermark"] == f["latest_ingest_offset"] == 6000
    hist = obs.get_registry().histogram("lineage_ingest_to_servable_s")
    # priced once: the bind's watermark (0) covered no ingest mark
    assert hist.count == 1
