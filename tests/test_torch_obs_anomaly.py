"""The port's anomaly checks (``obs.anomaly``) against the JAX package's, on
the same numpy-seeded series: ``ewma_mean_var`` / ``ewma_zscore`` /
``rate_of_change`` within 1e-12 (both numpy float64: in practice equal),
and ``AnomalyCheck`` / ``MonotonicGrowthCheck`` verdicts (status and
detail) equal over a throughput collapse, a lag spike, a counter's rate,
non-finite samples, a leak, a ramp then a plateau and several devices.
Then the ``HealthMonitor`` watches over a live port recorder."""

import numpy as np
import pytest

from large_scale_recommendation_tpu.obs import anomaly as janom
from large_scale_recommendation_tpu.obs import health as jh
from large_scale_recommendation_tpu_torch.obs import anomaly as panom
from large_scale_recommendation_tpu_torch.obs import health as ph
from large_scale_recommendation_tpu_torch.obs.recorder import (
    FlightRecorder,
    series_key,
)
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry

TOL = 1e-12


class Series:
    """A recorder stand-in (the checks read ``series_values`` and
    ``series_names`` only): the same object feeds both packages."""

    def __init__(self, **series):
        self.series = {k: list(v) for k, v in series.items()}

    def series_names(self):
        return sorted(self.series)

    def series_values(self, key, last_n=None):
        v = self.series.get(key, [])
        return v[-last_n:] if last_n is not None else list(v)


def _walk(seed, n=60, level=100.0, noise=1.0):
    rng = np.random.default_rng(seed)
    return level + noise * rng.normal(size=n)


@pytest.mark.parametrize("alpha", [0.05, 0.25, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_ewma_math_equal_jax(alpha, seed):
    v = _walk(seed)
    for n in (1, 2, 7, len(v)):
        jm, jv = janom.ewma_mean_var(v[:n], alpha)
        pm, pv = panom.ewma_mean_var(v[:n], alpha)
        np.testing.assert_allclose(pm, jm, rtol=0, atol=TOL)
        np.testing.assert_allclose(pv, jv, rtol=0, atol=TOL)
        assert abs(panom.ewma_zscore(v[:n], alpha)
                   - janom.ewma_zscore(v[:n], alpha)) <= TOL
    flat = np.full(20, 3.0)
    flat[-1] = 4.0
    assert panom.ewma_zscore(flat, alpha) == janom.ewma_zscore(flat, alpha)


@pytest.mark.parametrize("span", [1, 3, 100])
def test_rate_of_change_equal_jax(span):
    v = _walk(4, n=30, level=0.0)
    for n in (0, 1, 5, 30):
        assert abs(panom.rate_of_change(v[:n], span)
                   - janom.rate_of_change(v[:n], span)) <= TOL


def test_math_refuses_as_jax():
    for bad in (lambda m: m.ewma_mean_var([1.0], 0.0),
                lambda m: m.ewma_mean_var([1.0], 1.5),
                lambda m: m.rate_of_change([1.0], 0)):
        for mod in (janom, panom):
            with pytest.raises(ValueError):
                bad(mod)


def _scenarios():
    walk = list(_walk(7))
    collapse = walk + [20.0]
    spike = walk + [160.0]
    mild = walk + [104.5]
    nan_last = walk + [float("nan")]
    nan_mid = walk[:30] + [float("nan")] + walk[30:] + [20.0]
    counter = list(np.cumsum(np.abs(_walk(8, level=10.0))))
    counter_stall = counter + [counter[-1]] * 2
    return {"walk": walk, "collapse": collapse, "spike": spike,
            "mild": mild, "nan_last": nan_last, "nan_mid": nan_mid,
            "short": walk[:5], "counter": counter,
            "counter_stall": counter_stall, "flat": [5.0] * 12}


CONFIGS = [dict(), dict(direction="drop"), dict(direction="spike"),
           dict(degraded_z=2.0, critical_z=4.0, warmup=4),
           dict(mode="delta", direction="drop"),
           dict(alpha=0.1, max_points=16, roc_span=3)]


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_anomaly_verdicts_equal_jax(cfg):
    rec = Series(**_scenarios())
    statuses = set()
    for name in rec.series_names():
        j = janom.AnomalyCheck(rec, name, **cfg)()
        p = panom.AnomalyCheck(rec, name, **cfg)()
        assert (p.status, p.detail) == (j.status, j.detail), name
        statuses.add(p.status)
    if not cfg:  # the default bands see every status among the scenarios
        assert statuses == {ph.OK, ph.DEGRADED, ph.CRITICAL}


def test_anomaly_config_refusals_equal_jax():
    rec = Series()
    for kw in (dict(direction="up"), dict(mode="rate"), dict(warmup=2),
               dict(degraded_z=5.0, critical_z=4.0)):
        for mod in (janom, panom):
            with pytest.raises(ValueError):
                mod.AnomalyCheck(rec, "x", **kw)


def _memory():
    base = 1e9
    leak = [base + 1e8 * i for i in range(12)]
    slow = [base + 1e7 * i for i in range(12)]
    ramp = [1e3] + [base * (1 + i) for i in range(4)] + [5 * base] * 10
    flat = [base] * 12
    key = 'device_bytes_in_use{device="cuda:%d"}'
    return {
        "leak": Series(**{key % 0: leak}),
        "slow": Series(**{key % 0: slow}),
        "ramp": Series(**{key % 0: ramp}),
        "flat": Series(**{key % 0: flat}),
        "two": Series(**{key % 0: flat, key % 1: leak}),
        "short": Series(**{key % 0: leak[:4]}),
        "none": Series(),
        "store": Series(tier_host_bytes=leak),
    }


@pytest.mark.parametrize("case", sorted(_memory()))
@pytest.mark.parametrize("cfg", [dict(), dict(min_run=4),
                                 dict(series_prefix="tier_host_bytes")],
                         ids=str)
def test_growth_verdicts_equal_jax(case, cfg):
    rec = _memory()[case]
    j = janom.MonotonicGrowthCheck(rec, **cfg)()
    p = panom.MonotonicGrowthCheck(rec, **cfg)()
    assert (p.status, p.detail) == (j.status, j.detail)


def test_growth_flags_a_leak_on_the_cards_series():
    rec = _memory()["leak"]
    assert panom.MonotonicGrowthCheck(rec)().status == ph.CRITICAL
    assert panom.MonotonicGrowthCheck(_memory()["flat"])().status == ph.OK


def _both_monitors():
    return jh.HealthMonitor(), ph.HealthMonitor(registry=MetricsRegistry())


def test_watches_register_the_jax_names():
    rec = Series()
    jm, pm = _both_monitors()
    for m in (jm, pm):
        m.watch_series(rec, "lag")
        m.watch_series(rec, "tput", name="throughput", direction="drop")
        m.watch_device_memory(rec)
        m.watch_store_memory(rec)
        m.watch_quality(rec, source="online", k=10)
    assert pm.names() == jm.names()
    jr, pr = jm.run(), pm.run()
    assert pr["status"] == jr["status"] == ph.OK
    assert {n: c["detail"] for n, c in pr["checks"].items()} == {
        n: c["detail"] for n, c in jr["checks"].items()}


def test_watch_quality_reads_the_evaluators_series():
    """Over a live recorder: the evaluator's ``eval_rmse`` exploding pages
    the monitor with no threshold configured."""
    reg = MetricsRegistry()
    rec = FlightRecorder(registry=reg)
    mon = ph.HealthMonitor(registry=MetricsRegistry())
    mon.watch_quality(rec, source="online", k=10, warmup=4)
    rmse = reg.gauge("eval_rmse", source="online")
    for x in _walk(9, n=12, level=0.9, noise=0.01):
        rmse.set(x)
        reg.gauge("eval_ndcg_at_k", source="online", k="10").set(0.3)
        rec.sample()
    assert mon.run()["status"] == ph.OK
    assert series_key("eval_rmse", {"source": "online"}) in \
        rec.series_names()
    rmse.set(5.0)
    rec.sample()
    report = mon.run()
    assert report["status"] == ph.CRITICAL
    assert report["checks"]["quality:rmse"]["detail"]["direction"] == "spike"
