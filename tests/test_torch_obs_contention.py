"""The port's concurrency plane (``obs.contention``) against the JAX
package's: ``karp_flatt_serial_fraction``, ``amdahl_speedup`` and
``decompose_window`` equal over a grid of inputs (pure host arithmetic,
compared for equality); instrumented primitives driven through the same
deterministic sequences give the same stats rows (reentrancy never
double-counts, condition waits priced as blocked time); the ``named_*``
helpers hand back raw ``threading`` primitives while the plane is off.
Then the plane on the port's runtime on the CPU: every lock site of the
serving and stream path is named as in the JAX package, a contended lock
records its wait, and a ``ParallelIngestRunner`` at N = 2 gives
``/contentionz`` a two-consumer Amdahl window whose per-partition busy time
sums to the aggregate."""

import json
import threading
import time

import numpy as np
import pytest

from large_scale_recommendation_tpu.obs import contention as jct
from large_scale_recommendation_tpu.obs import registry as jreg
from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.models.online import (
    OnlineMF,
    OnlineMFConfig,
)
from large_scale_recommendation_tpu_torch.obs import contention as pct
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry
from large_scale_recommendation_tpu_torch.obs.server import http_get
from large_scale_recommendation_tpu_torch.serving import ServingEngine
from large_scale_recommendation_tpu_torch.streams import (
    EventLog,
    ParallelIngestRunner,
    StreamingDriverConfig,
    append_routed,
)
from test_torch_obs_requests import cpu_model, planes  # noqa: F401

EFFS = [None, 0.0, -0.5, 1e-6, 0.25, 0.5, 0.9, 1.0, 1.3]


@pytest.mark.parametrize("n", [0, 1, 2, 3, 8])
def test_karp_flatt_and_amdahl_equal_jax(n):
    for e in EFFS:
        assert (pct.karp_flatt_serial_fraction(e, n)
                == jct.karp_flatt_serial_fraction(e, n))
    for s in (-0.1, 0.0, 0.05, 0.5, 1.0, 2.0):
        if n:
            assert pct.amdahl_speedup(s, n) == jct.amdahl_speedup(s, n)


@pytest.mark.parametrize("seed", range(5))
def test_decompose_window_equal_jax(seed):
    rng = np.random.default_rng(seed)
    wall = float(rng.uniform(0.0, 5.0))
    busy = {p: float(rng.uniform(-0.5, 6.0))
            for p in range(int(rng.integers(0, 5)))}
    wait = float(rng.uniform(0.0, 3.0))
    for cpu in (True, False):
        assert (pct.decompose_window(wall, busy, wait, cpu_supported=cpu)
                == jct.decompose_window(wall, busy, wait, cpu_supported=cpu))


def _exercise(tracker):
    """One deterministic single-thread sequence over the three kinds."""
    lk, rl, cv = (tracker.lock("a.lock"), tracker.rlock("a.rlock"),
                  tracker.condition("a.cond"))
    for _ in range(3):
        with lk:
            pass
    assert not lk.acquire(blocking=False) or lk.release() is None
    with rl:
        with rl:
            with rl:
                pass
    with cv:
        cv.wait(timeout=0.001)
        cv.wait_for(lambda: True)
        cv.notify()
        cv.notify_all()
    tracker.lock("a.lock")  # a second primitive shares the row
    return {r["lock"]: {k: r[k] for k in ("kind", "acquisitions",
                                          "contended", "reentrant",
                                          "cv_waits", "waiters")}
            for r in tracker.lock_window()}


def test_primitives_stats_equal_jax():
    p = _exercise(pct.ContentionTracker(registry=MetricsRegistry()))
    j = _exercise(jct.ContentionTracker(registry=jreg.MetricsRegistry()))
    assert p == j
    assert p["a.rlock"]["acquisitions"] == 1
    assert p["a.rlock"]["reentrant"] == 2
    assert p["a.cond"]["cv_waits"] == 1
    assert p["a.lock"]["acquisitions"] == 4


def test_table_cap_hands_back_raw_primitives_as_jax():
    out = []
    for mod, reg in ((pct, MetricsRegistry()), (jct, jreg.MetricsRegistry())):
        t = mod.ContentionTracker(registry=reg, max_locks=2)
        kinds = [type(t.lock(f"l{i}")).__name__ for i in range(4)]
        out.append((kinds, t.locks_dropped, t.lock_names()))
    assert out[0] == out[1]
    assert out[0][1] == 2


def test_named_helpers_are_raw_when_off(planes):
    obs.set_contention(None)
    assert type(pct.named_lock("x")) is type(threading.Lock())
    assert type(pct.named_rlock("x")) is type(threading.RLock())
    assert type(pct.named_condition("x")) is threading.Condition
    t = obs.enable_contention(start=False)
    assert isinstance(pct.named_lock("x"), pct.InstrumentedLock)
    assert isinstance(pct.named_rlock("y"), pct.InstrumentedRLock)
    assert isinstance(pct.named_condition("z"), pct.InstrumentedCondition)
    assert t.lock_names() == ["x", "y", "z"]
    obs.disable()
    assert obs.get_contention() is None and not t.running


def test_contended_wait_is_priced(planes):
    obs.enable()
    t = obs.enable_contention(start=False)
    lk = pct.named_lock("hot")
    lk.acquire()
    done = threading.Event()

    def waiter():
        with lk:
            done.set()

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.05)
    lk.release()
    th.join(timeout=5)
    assert done.is_set() and not th.is_alive()
    row = [r for r in t.lock_window() if r["lock"] == "hot"][0]
    assert row["contended"] == 1 and row["wait_s"] >= 0.04
    assert obs.get_registry().histogram("lock_wait_s", lock="hot").count == 1


def test_every_site_is_named_as_jax(planes, tmp_path):
    from large_scale_recommendation_tpu_torch.core.initializers import (
        PseudoRandomFactorInitializer,
    )
    from large_scale_recommendation_tpu_torch.models.adaptive import (
        AdaptiveMF,
        AdaptiveMFConfig,
    )
    from large_scale_recommendation_tpu_torch.store import TieredFactorStore
    from large_scale_recommendation_tpu_torch.streams import (
        IngestQueue,
        RowConflictGate,
    )

    obs.enable()
    t = obs.enable_contention(start=False)
    OnlineMF(OnlineMFConfig(num_factors=4), device="cpu")
    AdaptiveMF(AdaptiveMFConfig(num_factors=4), device="cpu")
    ServingEngine(cpu_model(50, 20, 4), k=3)
    EventLog(str(tmp_path / "log"), num_partitions=1, fsync=False)
    IngestQueue()
    RowConflictGate()
    store = TieredFactorStore(PseudoRandomFactorInitializer(4, scale=0.1),
                              slot_capacity=16, device="cpu")
    model = OnlineMF(OnlineMFConfig(num_factors=4), device="cpu")
    ParallelIngestRunner(model, EventLog(str(tmp_path / "l2"),
                                         num_partitions=2, fsync=False),
                         str(tmp_path / "ck"))
    assert set(t.lock_names()) == {
        "online.apply_lock", "adaptive.apply_lock", "serving.engine",
        "streams.wal_partition", "streams.ingest_queue",
        "streams.row_conflict_gate", "streams.barrier",
        "streams.ckpt_write", "streams.refresh", "store.tiered"}
    del store


def test_parallel_runner_window_at_two_consumers(planes, tmp_path):
    obs.enable()
    tracker = obs.enable_contention(start=False)
    rng = np.random.default_rng(0)
    log = EventLog(str(tmp_path / "log"), num_partitions=2, fsync=False)
    n = 20_000
    append_routed(log, rng.integers(0, 4000, n), rng.integers(0, 300, n),
                  rng.normal(size=n).astype(np.float32))
    model = OnlineMF(OnlineMFConfig(num_factors=8, minibatch_size=512),
                     device="cpu")
    runner = ParallelIngestRunner(
        model, log, str(tmp_path / "ck"),
        config=StreamingDriverConfig(batch_records=2000, checkpoint_every=3))
    tracker.reset_window()
    batches = sum(-(-log.end_offset(p) // 2000) for p in (0, 1))
    assert runner.run() == batches
    server = obs.ObsServer().start()
    try:
        code, body = http_get(server.url + "/contentionz", timeout=10)
    finally:
        server.stop()
    assert code == 200
    doc = json.loads(body)
    assert doc["consumers"] == 2
    assert set(doc["partitions"]) == {"0", "1"}
    assert doc["cpu_source"] == "pthread_getcpuclockid"
    busy = sum(p["busy_s"] for p in doc["partitions"].values())
    assert abs(busy - doc["busy_s"]) <= 1e-9
    assert doc["serial_fraction"] is None or 0.0 <= doc["serial_fraction"] <= 1
    names = {r["lock"] for r in doc["locks"]}
    assert {"streams.ingest_queue", "online.apply_lock",
            "streams.row_conflict_gate", "streams.barrier"} <= names
    reg = obs.get_registry()
    assert reg.counter("streams_gate_grants_total").value == batches
    assert reg.counter("streams_barrier_checkpoints_total").value >= 1


def test_sampler_cadence_starts_and_stops(planes):
    obs.enable()
    t = obs.enable_contention(interval_s=0.01)
    assert t.running
    deadline = time.time() + 5
    while time.time() < deadline and not any(
            m["name"] == "thread_cpu_frac"
            for m in obs.get_registry().snapshot()["metrics"]):
        time.sleep(0.01)
    assert any(m["name"] == "thread_cpu_frac"
               for m in obs.get_registry().snapshot()["metrics"])
    t2 = obs.enable_contention(start=False)  # re-enable stops the old one
    assert not t.running and obs.get_contention() is t2
