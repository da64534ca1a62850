"""The port's metrics registry against the JAX package's: the same call
sequence, drawn from a numpy seed, gives the same snapshot (timestamps
aside), Prometheus text line for line, and bit-equal histogram
percentiles. Exact equality throughout: both run the same host
arithmetic."""

import json

import numpy as np
import pytest

from large_scale_recommendation_tpu.obs import registry as jreg
from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.obs import registry as preg


@pytest.fixture
def port_defaults():
    """The port's module defaults restored after the test."""
    prev = (obs.get_registry(), obs.get_tracer())
    yield
    obs.set_registry(prev[0])
    obs.set_tracer(prev[1])


LABEL_VALUES = ("a", "b", 'q"uote', "back\\slash", "new\nline", "0")


def _drive(reg, seed):
    """One seeded sequence of counter / gauge / histogram calls."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        kind = rng.integers(0, 3)
        name = f"m{rng.integers(0, 4)}_{['c', 'g', 'h'][kind]}"
        labels = {f"l{j}": LABEL_VALUES[rng.integers(0, len(LABEL_VALUES))]
                  for j in range(rng.integers(0, 3))}
        v = float(rng.lognormal(0.0, 3.0))
        if kind == 0:
            reg.counter(name, **labels).inc(v)
        elif kind == 1:
            (reg.gauge(name, **labels).set(v) if rng.random() < 0.5
             else reg.gauge(name, **labels).add(v))
        else:
            for x in rng.lognormal(-3.0, 4.0, rng.integers(1, 40)):
                reg.histogram(name, **labels).observe(float(x))
    reg.histogram("edge", side="low").observe(0.0)
    reg.histogram("edge", side="low").observe(1e-12)


def _untimed(snap):
    return {k: v for k, v in snap.items() if k != "time"}


@pytest.mark.parametrize("seed", range(5))
def test_snapshot_and_prometheus_equal_jax(seed):
    j, p = jreg.MetricsRegistry(), preg.MetricsRegistry()
    _drive(j, seed)
    _drive(p, seed)
    assert _untimed(p.snapshot()) == _untimed(j.snapshot())
    assert p.to_prometheus().splitlines() == j.to_prometheus().splitlines()
    assert p.names() == j.names()
    for name in sorted(j.names()):
        assert len(p.find(name)) == len(j.find(name))


@pytest.mark.parametrize("seed", range(3))
def test_histogram_percentiles_bit_equal(seed):
    rng = np.random.default_rng(100 + seed)
    xs = rng.lognormal(-6.0, 5.0, 5000)
    j, p = jreg.Histogram("h", ()), preg.Histogram("h", ())
    for x in xs:
        j.observe(float(x))
        p.observe(float(x))
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert p.quantile(q) == j.quantile(q)  # bit-equal
    assert p.summary() == j.summary()


def test_jsonl_lines_equal(tmp_path):
    j, p = jreg.MetricsRegistry(), preg.MetricsRegistry()
    _drive(j, 7)
    _drive(p, 7)
    j.append_jsonl(str(tmp_path / "j.jsonl"))
    p.append_jsonl(str(tmp_path / "p.jsonl"))
    lj = [_untimed(json.loads(x)) for x in open(tmp_path / "j.jsonl")]
    lp = [_untimed(json.loads(x)) for x in open(tmp_path / "p.jsonl")]
    assert lp == lj


@pytest.mark.parametrize("v", LABEL_VALUES)
def test_escape_label_equal(v):
    assert preg._escape_label(v) == jreg._escape_label(v)


def test_null_registry_hands_out_the_shared_singleton(port_defaults):
    null = preg.NullRegistry()
    assert null.counter("x", a="1") is preg.NULL_INSTRUMENT
    assert null.gauge("y") is preg.NULL_INSTRUMENT
    assert null.histogram("z") is preg.NULL_INSTRUMENT
    preg.NULL_INSTRUMENT.inc()
    preg.NULL_INSTRUMENT.observe(1.0)
    assert null.names() == set() and null.to_prometheus() == ""
    assert _untimed(null.snapshot()) == _untimed(jreg.NullRegistry()
                                                 .snapshot())
    assert obs.get_registry() is preg.NULL_REGISTRY
    reg, _ = obs.enable()
    assert obs.enabled() and obs.get_registry() is reg
    obs.disable()
    assert not obs.enabled() and obs.get_registry() is preg.NULL_REGISTRY
