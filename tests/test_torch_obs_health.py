"""The port's health layer against the JAX package's: the watchdog's loss
window over hypothesis-drawn sequences (state, trips, warnings), its
segment scan raising on a NaN row in both, ``HealthMonitor.run()``'s
report for the same checks, the SLO tracker's gauges, the checkpoint and
stream checks; and the port's rollback through ``restore_online_state``
with its heal of rows the snapshot never knew. Exact equality throughout
(host arithmetic; the finite scans read one bool)."""

import json
import math
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from large_scale_recommendation_tpu.obs import health as jh
from large_scale_recommendation_tpu.obs import registry as jreg
from large_scale_recommendation_tpu.utils import checkpoint as jckpt
from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.models.online import (
    OnlineMF,
    OnlineMFConfig,
)
from large_scale_recommendation_tpu_torch.obs import health as ph
from large_scale_recommendation_tpu_torch.obs.events import EventJournal
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry
from large_scale_recommendation_tpu_torch.utils import checkpoint as pckpt


@pytest.fixture
def port_defaults():
    prev = (obs.get_registry(), obs.get_tracer(), obs.get_events())
    yield
    obs.disable()
    obs.set_registry(prev[0])
    obs.set_tracer(prev[1])
    obs.set_events(prev[2])


def _watchdog_state(wd):
    return (wd.tripped, wd.reason, wd.warning, wd.trips,
            wd.check().status, dict(wd.check().detail))


losses = st.lists(st.one_of(
    st.floats(min_value=1e-3, max_value=10.0),
    st.sampled_from([float("nan"), float("inf"), 0.0])), max_size=30)


@settings(max_examples=60, deadline=None)
@given(seq=losses, window=st.integers(1, 6),
       tol=st.sampled_from([0.0, 0.01, 0.05, 0.5]))
def test_observe_loss_equal_jax(seq, window, tol):
    j = jh.TrainingWatchdog(policy="observe", loss_window=window,
                            loss_rise_tol=tol,
                            registry=jreg.MetricsRegistry())
    p = ph.TrainingWatchdog(policy="observe", loss_window=window,
                            loss_rise_tol=tol, registry=MetricsRegistry())
    for x in seq:
        j.observe_loss(x)
        p.observe_loss(x)
        assert _watchdog_state(p) == _watchdog_state(j)
    assert p._m_state.value == j._m_state.value


@pytest.mark.parametrize("policy", ["halt", "rollback"])
def test_halt_policies_raise_on_a_rising_loss(policy):
    for mod in (jh, ph):
        wd = mod.TrainingWatchdog(policy=policy, loss_window=3)
        with pytest.raises(mod.TrainingDivergedError) as e:
            for x in (1.0, 2.0, 4.0):
                wd.observe_loss(x)
        assert e.value.reason == "loss_divergence"
        assert not e.value.rolled_back


@pytest.mark.parametrize("where", ["U", "V", "none"])
def test_after_segment_raises_on_a_nan_row_in_both(where):
    rng = np.random.default_rng(0)
    U = rng.normal(size=(7, 4)).astype(np.float32)
    V = rng.normal(size=(5, 4)).astype(np.float32)
    if where != "none":
        (U if where == "U" else V)[3, 1] = np.nan
    out = []
    for mod, conv in ((jh, jnp.asarray), (ph, torch.from_numpy)):
        wd = mod.TrainingWatchdog(policy="halt")
        try:
            wd.after_segment(conv(U), conv(V), label="dsgd_segment")
            out.append(None)
        except mod.TrainingDivergedError as e:
            out.append((e.reason, e.detail))
        assert wd.tripped == (where != "none")
    assert out[0] == out[1]
    if where != "none":
        assert out[1] == ("non_finite_factors", {"where": "dsgd_segment"})


def test_rows_and_swap_scans_match_jax():
    U = np.ones((6, 3), np.float32)
    U[4] = np.inf
    for rows, want in (([0, 1, 5], True), ([4], False), ([], True)):
        assert ph.TrainingWatchdog._rows_finite(
            torch.from_numpy(U), np.asarray(rows, np.int64)) == want
        assert jh.TrainingWatchdog._rows_finite(
            jnp.asarray(U), np.asarray(rows, np.int64)) == want
    for mod, conv in ((jh, jnp.asarray), (ph, torch.from_numpy)):
        wd = mod.TrainingWatchdog(policy="observe")
        wd.check_swap(conv(U), conv(U[:2]))
        assert wd.reason == "non_finite_retrain"


def _checks(mod, seed, tmp_path):
    """One seeded set of checks, built the same way in both packages."""
    rng = np.random.default_rng(seed)
    reg = jreg.MetricsRegistry() if mod is jh else MetricsRegistry()
    slo = mod.SLOTracker(0.01, objective=0.9, window=16, registry=reg,
                         windows={"fast": 4})
    for x in rng.exponential(0.01, int(rng.integers(0, 40))):
        slo.record(float(x))
    wd = mod.TrainingWatchdog(policy="observe", registry=reg)
    for x in rng.random(int(rng.integers(0, 8))):
        wd.observe_loss(float(x))
    mon = mod.HealthMonitor(registry=reg)
    mon.watch_slo(slo)
    mon.watch_watchdog(wd)
    mon.register("broken", lambda: 1 / 0)
    mon.register("liar", lambda: "fine")
    mon.register("fixed", lambda: mod.degraded(note="x"))
    mgr = (jckpt if mod is jh else pckpt).CheckpointManager(
        str(tmp_path / mod.__name__))
    mon.watch_checkpoints(mgr, degraded_after_s=3600.0)
    return mon, reg, slo


def _report(mon):
    r = mon.run()
    checks = {n: (c["status"], {k: v for k, v in c["detail"].items()
                                if k not in ("directory", "error")})
              for n, c in r["checks"].items()}
    return r["status"], checks


@pytest.mark.parametrize("seed", range(6))
def test_monitor_report_equal_jax(seed, tmp_path):
    jm, jr, js = _checks(jh, seed, tmp_path)
    pm, pr, ps = _checks(ph, seed, tmp_path)
    assert _report(pm) == _report(jm)
    assert sorted(pm.names()) == sorted(jm.names())
    snap = lambda r: sorted((m["name"], sorted(m["labels"].items()),  # noqa
                             m.get("value"))
                            for m in r.snapshot()["metrics"])
    assert snap(pr) == snap(jr)
    assert ps.snapshot() == js.snapshot()
    assert ps.burn_rates() == js.burn_rates()
    pm.unregister("broken")
    jm.unregister("broken")
    assert _report(pm) == _report(jm)


def test_transitions_are_journaled(port_defaults):
    reg, _ = obs.enable()
    obs.set_events(EventJournal(registry=reg))
    state = {"s": ph.OK}
    mon = ph.HealthMonitor()
    mon.register("c", lambda: ph.CheckResult(state["s"]))
    mon.run()
    state["s"] = ph.CRITICAL
    mon.run()
    mon.run()
    state["s"] = ph.OK
    mon.run()
    kinds = [(e["kind"], e["detail"]["to_status"])
             for e in obs.get_events().events()]
    assert kinds == [("health.transition", "critical"),
                     ("health.transition", "ok")]
    assert reg.gauge("health_status").value == 0


def test_serving_check_matches_jax():
    out = []
    for mod in (jh, ph):
        slo = mod.SLOTracker(0.01, objective=0.9, window=20)
        chk = mod.ServingHealthCheck(slo)
        res = [chk().status]
        for x in [0.02] * 3 + [0.001] * 5 + [0.5] * 12:
            slo.record(x)
            res.append(chk().status)
        out.append((res, chk.min_samples))
    assert out[0] == out[1]


def test_stream_check_matches_jax():
    class Driver:
        def __init__(self):
            self.tel = {"lag_records": 0, "queue": {}}

        def telemetry(self):
            return dict(self.tel)

    out = []
    for mod in (jh, ph):
        d = Driver()
        chk = mod.StreamHealthCheck(d, degraded_lag=10, critical_lag=100)
        res = [chk().status]
        d.tel = {"lag_records": 50, "queue": {"poison_records": 2}}
        res.append(chk().status)
        d.tel = {"lag_records": 200, "queue": {"poison_records": 2}}
        res.append(chk().status)
        out.append(res)
    assert out[0] == out[1] == [ph.OK, ph.DEGRADED, ph.CRITICAL]


def test_periodic_task_runs_counts_errors_and_stops():
    calls = []

    def fn():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("flaky")

    task = ph.ensure_periodic(None, fn, 0.01, "t")
    assert ph.ensure_periodic(task, fn, 0.01, "t") is task
    deadline = time.time() + 10
    while len(calls) < 4 and time.time() < deadline:
        time.sleep(0.01)
    task.stop()
    assert not task.running
    assert task.errors == 1 and isinstance(task.last_error, RuntimeError)
    assert task.runs >= 3


def _online(seed=0):
    m = OnlineMF(OnlineMFConfig(num_factors=4, minibatch_size=64,
                                learning_rate=0.05), device="cpu")
    rng = np.random.default_rng(seed)
    return m, rng


def test_rollback_restores_the_snapshot_and_heals_new_rows(tmp_path):
    """A NaN batch under ``rollback``: the tables come back to the last
    snapshot, a row first seen after it is re-initialized by id, and the
    trip raises with ``rolled_back``."""
    model, rng = _online()
    mgr = pckpt.CheckpointManager(str(tmp_path))
    wd = ph.TrainingWatchdog(policy="rollback", manager=mgr)
    model.watchdog = wd
    batch = Ratings.from_arrays(rng.integers(0, 20, 200),
                                rng.integers(0, 10, 200),
                                rng.normal(size=200).astype(np.float32))
    model.partial_fit(batch)
    pckpt.save_online_state(mgr, model, step=1)
    saved_U = model.users.array.clone()
    # user 77 is new: the snapshot cannot restore its poisoned row
    poison = Ratings.from_arrays(np.array([3, 77]), np.array([2, 2]),
                                 np.array([np.nan, np.nan], np.float32))
    with pytest.raises(ph.TrainingDivergedError) as e:
        model.partial_fit(poison)
    assert e.value.rolled_back and wd.rollbacks == 1
    assert e.value.detail["rows_reinitialized"] >= 1
    n = saved_U.shape[0]
    assert torch.isfinite(model.users.array).all()
    assert torch.isfinite(model.items.array).all()
    rows, _ = model.users.rows_for(np.array([3]))
    assert torch.equal(model.users.array[rows], saved_U[rows])
    new_row, found = model.users.rows_for(np.array([77]))
    assert found[0] > 0
    fresh = model.users.initializer(torch.tensor([77]))
    assert torch.equal(model.users.array[new_row], fresh.float())
    assert n <= model.users.array.shape[0]
    assert ph.TrainingWatchdog(policy="observe").check().status == ph.OK
    assert wd.check().status == ph.CRITICAL
    wd.reset()
    assert wd.check().status == ph.OK and math.isclose(
        wd._m_state.value, 0.0)


# -- postmortem bundles -------------------------------------------------------


@pytest.fixture
def both_recorders(tmp_path):
    """A recorder with a ``bundle_dir`` installed in each package (registry,
    tracer and journal live); every default restored after."""
    from large_scale_recommendation_tpu import obs as jobs
    from large_scale_recommendation_tpu.obs import events as jev
    from large_scale_recommendation_tpu.obs import recorder as jrec
    from large_scale_recommendation_tpu.obs import trace as jtr

    jprev = (jreg.get_registry(), jtr.get_tracer(), jev.get_events(),
             jrec.get_recorder())
    pprev = (obs.get_registry(), obs.get_tracer(), obs.get_events(),
             obs.get_recorder(), obs.get_store())
    obs.set_store(None)
    jobs.enable()
    jrecorder, _ = jobs.enable_flight_recorder(
        start=False, bundle_dir=str(tmp_path / "jax"))
    obs.enable()
    precorder, _ = obs.enable_flight_recorder(
        start=False, bundle_dir=str(tmp_path / "port"))
    yield jrecorder, precorder
    jreg.set_registry(jprev[0])
    jtr.set_tracer(jprev[1])
    jev.set_events(jprev[2])
    jrec.set_recorder(jprev[3])
    obs.disable()
    obs.set_registry(pprev[0])
    obs.set_tracer(pprev[1])
    obs.set_events(pprev[2])
    obs.set_recorder(pprev[3])
    obs.set_store(pprev[4])


@pytest.mark.parametrize("policy", ["observe", "halt"])
def test_watchdog_trip_sets_last_bundle_as_jax(both_recorders, policy):
    """A NaN row at a segment boundary trips both watchdogs; each freezes
    one bundle, and the port's validates under either package with the
    JAX trip's trigger and detail."""
    from large_scale_recommendation_tpu.obs import recorder as jrec
    from large_scale_recommendation_tpu_torch.obs import recorder as prec

    U = np.ones((6, 3), np.float32)
    U[2, 0] = np.nan
    V = np.ones((4, 3), np.float32)
    paths = []
    for mod, conv in ((jh, jnp.asarray), (ph, torch.from_numpy)):
        wd = mod.TrainingWatchdog(policy=policy)
        assert wd.last_bundle is None
        for _ in range(2):  # the second is a re-detection: no new bundle
            try:
                wd.after_segment(conv(U), conv(V), label="dsgd_segment")
            except mod.TrainingDivergedError:
                assert policy == "halt"
            paths.append(wd.last_bundle)
    jpath, _, ppath, again = paths
    assert again == ppath and os.path.isdir(ppath)
    manifests = [m.validate_bundle(p) for m in (jrec, prec)
                 for p in (jpath, ppath)]
    for key in ("trigger", "detail", "bundle_version", "files"):
        assert len({json.dumps(m[key], sort_keys=True)
                    for m in manifests}) == 1, key
    assert manifests[-1]["trigger"] == "watchdog_trip"
    assert manifests[-1]["detail"] == {"reason": "non_finite_factors",
                                       "policy": policy,
                                       "where": "dsgd_segment"}
    assert both_recorders[1].bundles_written == 1


def test_critical_transition_freezes_one_bundle_as_jax(both_recorders):
    from large_scale_recommendation_tpu_torch.obs import recorder as prec

    jrecorder, precorder = both_recorders
    state = {"s": ph.OK}
    mons = []
    for mod in (jh, ph):
        mon = mod.HealthMonitor()
        mon.register("c", lambda mod=mod: mod.CheckResult(state["s"]))
        mons.append(mon)
    for s, want in ((ph.OK, 0), (ph.CRITICAL, 1), (ph.CRITICAL, 1),
                    (ph.DEGRADED, 1), (ph.CRITICAL, 2)):
        state["s"] = s
        for mon in mons:
            mon.run()
        assert precorder.bundles_written == jrecorder.bundles_written == want
    loaded = prec.load_bundle(precorder.last_bundle)
    assert loaded["manifest"]["trigger"] == "health_critical"
    assert loaded["manifest"]["detail"] == {"from_status": "degraded",
                                            "failing_checks": {"c":
                                                               "critical"}}
    assert loaded["health"]["status"] == ph.CRITICAL


def test_no_bundle_without_a_bundle_dir(both_recorders):
    both_recorders[1].bundle_dir = None
    wd = ph.TrainingWatchdog(policy="observe")
    wd.observe_loss(float("nan"))
    assert wd.tripped and wd.last_bundle is None
