"""The port's ingest data-quality gate (``obs.dataquality``) against the JAX
package's: the same seeded batches — clean, NaN / Inf, out-of-range,
unknown-id (negative and past the ceilings), duplicate-key and
partition-skewed ones, with padding rows — give equal per-class counts,
``status()`` verdicts, snapshots and Prometheus text (equality: host
numpy), and ``DataQualityCheck`` / ``HealthMonitor.watch_data_quality``
surface the same verdicts, tripping on a rotten batch and clearing after
the window. Then the gate on the port's driver on the CPU: the inspector
reads each ``StreamBatch``'s host arrays before training, a rotten batch
(NaN ratings quarantined by the queue, out-of-range ratings and unknown
ids past it) trips the check, the journal carries one error-severity
``data.quality_violation`` event, and a CRITICAL trip freezes a bundle
whose ``lineage.json`` carries the ``dataq_`` gauges."""

import numpy as np
import pytest

from large_scale_recommendation_tpu.core.types import Ratings as JRatings
from large_scale_recommendation_tpu.obs import dataquality as jdq
from large_scale_recommendation_tpu.obs import health as jh
from large_scale_recommendation_tpu.obs import recorder as jrec
from large_scale_recommendation_tpu.obs import registry as jreg
from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.obs import dataquality as pdq
from large_scale_recommendation_tpu_torch.obs import health as ph
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry
from large_scale_recommendation_tpu_torch.streams.sources import StreamBatch
from test_torch_obs_requests import drop_time, planes  # noqa: F401


def _batches(seed):
    """``(users, items, ratings, weights, partition)`` batches covering
    every violation class, from one seed."""
    rng = np.random.default_rng(seed)
    out = []

    def clean(n, p=0):
        return [rng.integers(0, 1000, n), rng.integers(0, 200, n),
                rng.uniform(1, 5, n).astype(np.float32), None, p]

    out.append(clean(500))
    b = clean(400)
    b[2][rng.choice(400, 7, replace=False)] = np.nan
    b[2][3] = np.inf
    out.append(b)
    b = clean(300)
    b[2][:9] = 9.5
    b[2][9:12] = -2.0
    out.append(b)
    b = clean(300)
    b[0][:4] = -1
    b[1][4:10] = 5000
    b[0][10:12] = 10**9
    out.append(b)
    b = clean(200)
    b[0][50:80] = b[0][:30]
    b[1][50:80] = b[1][:30]
    out.append(b)
    b = clean(256)
    w = np.ones(256, np.float32)
    w[200:] = 0.0
    b[2][220:] = np.nan  # padding rows never count
    b[3] = w
    out.append(b)
    out.append(clean(2000, p=1))
    out.append(clean(20, p=2))
    out.append([np.zeros(0, np.int64)] * 2 + [np.zeros(0, np.float32),
                                               None, 0])
    return out


def _inspector(mod, registry, **kw):
    return mod.DataQualityInspector(rating_range=(1.0, 5.0),
                                    max_user_id=999, max_item_id=199,
                                    window=4, registry=registry, **kw)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("policy", [None, {"duplicate_key": (0.3, 0.8)}])
def test_counts_status_and_snapshot_equal_jax(seed, policy):
    preg, jreg_ = MetricsRegistry(), jreg.MetricsRegistry()
    p = _inspector(pdq, preg, class_policy=policy)
    j = _inspector(jdq, jreg_, class_policy=policy)
    for u, i, r, w, part in _batches(seed):
        assert (p.inspect(u, i, r, weights=w, partition=part)
                == j.inspect(u, i, r, weights=w, partition=part))
        assert p.status() == j.status()
    assert drop_time(p.snapshot()) == drop_time(j.snapshot())
    assert preg.to_prometheus() == jreg_.to_prometheus()
    assert p.violations["non_finite"] == 8
    assert p.violations["out_of_range"] == 12
    assert p.violations["out_of_vocab"] == 12
    assert p.violations["duplicate_key"] >= 30
    assert p.last_skew == j.last_skew >= 10.0


def test_check_trips_and_clears_as_jax():
    out = []
    for mod, hmod, reg in ((pdq, ph, MetricsRegistry()),
                           (jdq, jh, jreg.MetricsRegistry())):
        insp = _inspector(mod, reg)
        mon = hmod.HealthMonitor(registry=reg)
        mon.watch_data_quality(insp)
        seq = [mon.run()["checks"]["data_quality"]["status"]]
        for u, i, r, w, part in _batches(0)[:2]:
            insp.inspect(u, i, r, weights=w, partition=part)
            seq.append(mon.run()["checks"]["data_quality"]["status"])
        for _ in range(4):  # the window slides past the rotten batch
            insp.inspect(np.arange(150), np.arange(150) % 200,
                         np.full(150, 3.0, np.float32))
            seq.append(mon.run()["checks"]["data_quality"]["status"])
        check = hmod.DataQualityCheck(insp)()
        out.append((seq, check.status))
    assert out[0] == out[1]
    assert out[0][0][:3] == ["ok", "ok", "degraded"]
    assert out[0][0][-1] == "ok"


def test_inspect_batch_on_a_stream_batch_as_jax():
    rng = np.random.default_rng(2)
    n = 300
    u, i = rng.integers(-3, 1100, n), rng.integers(0, 220, n)
    r = rng.uniform(0, 6, n).astype(np.float32)
    p = _inspector(pdq, MetricsRegistry())
    j = _inspector(jdq, jreg.MetricsRegistry())
    pb = StreamBatch(ratings=Ratings.from_arrays(u, i, r), partition=1,
                     start_offset=0, end_offset=n)

    class JB:  # the JAX driver's batch surface
        ratings = JRatings.from_arrays(u, i, r)
        partition = 1

    assert p.inspect_batch(pb) == j.inspect_batch(JB)
    assert p.snapshot()["violations"]["out_of_vocab"] > 0


def test_validation_as_jax():
    for mod in (pdq, jdq):
        for kw in ({"degraded_frac": 0.0}, {"degraded_frac": 0.5,
                                            "critical_frac": 0.1},
                   {"window": 0}, {"class_policy": {"nope": (0.1, 0.2)}},
                   {"class_policy": {"duplicate_key": (0.5, 0.1)}}):
            with pytest.raises(ValueError):
                mod.DataQualityInspector(**kw)


def test_rotten_batch_trips_on_the_driver_and_bundles(planes, tmp_path):
    from large_scale_recommendation_tpu_torch.models.online import (
        OnlineMF,
        OnlineMFConfig,
    )
    from large_scale_recommendation_tpu_torch.streams import (
        EventLog,
        StreamingDriver,
        StreamingDriverConfig,
    )

    obs.enable()
    recorder, journal = obs.enable_flight_recorder(
        start=False, bundle_dir=str(tmp_path / "bundles"))
    obs.enable_lineage()
    obs.enable_contention(start=False)
    insp = pdq.DataQualityInspector(rating_range=(1.0, 5.0),
                                    max_user_id=299, max_item_id=99,
                                    class_policy={"duplicate_key": (0.5,
                                                                    0.9)})
    mon = ph.HealthMonitor()
    mon.watch_data_quality(insp)
    rng = np.random.default_rng(0)
    log = EventLog(str(tmp_path / "log"), fsync=False)
    for _ in range(2):
        log.append_arrays(0, rng.integers(0, 300, 1000),
                          rng.integers(0, 100, 1000),
                          rng.uniform(1, 5, 1000).astype(np.float32))
    bad_u = rng.integers(0, 300, 1000)
    bad_u[:200] = 10**6                       # unknown ids
    bad_r = rng.uniform(1, 5, 1000).astype(np.float32)
    bad_r[200:260] = np.nan                   # quarantined by the queue
    bad_r[260:400] = 50.0                     # out of range
    log.append_arrays(0, bad_u, rng.integers(0, 100, 1000), bad_r)
    model = OnlineMF(OnlineMFConfig(num_factors=8, minibatch_size=256),
                     device="cpu")
    drv = StreamingDriver(model, log, str(tmp_path / "ck"), inspector=insp,
                          config=StreamingDriverConfig(batch_records=1000))
    assert mon.run()["status"] == "ok"
    assert drv.run() == 3
    assert insp.batches == 3
    assert insp.violations["non_finite"] == 0  # dead-lettered upstream
    assert insp.violations["out_of_vocab"] == 200
    assert insp.violations["out_of_range"] == 140
    report = mon.run()
    assert report["status"] == "critical"
    assert report["checks"]["data_quality"]["status"] == "critical"
    events = journal.tail(100)
    kinds = [e["kind"] for e in events]
    errors = [e for e in events if e["kind"] == "data.quality_violation"
              and e["severity"] == "error"]
    assert len(errors) == 1  # the rotten batch's; the others warn (dups)
    assert "stream.dead_letter" in kinds
    bundle = recorder.last_bundle
    assert bundle is not None
    docs = obs.load_bundle(bundle)
    jrec.validate_bundle(bundle)
    names = {m["name"] for m in docs["lineage"]["data_quality"]}
    assert "dataq_violation_frac" in names
    assert docs["lineage"]["lineage"]["records"] == []
    assert isinstance(docs["contention"]["locks"], list)
    assert "note" not in docs["contention"]
