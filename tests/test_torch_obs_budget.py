"""The port's ROLLOUT plane (``obs.budget``) against the JAX package's, from
the same seeded latency streams: equal per-version cohort snapshots and
``/budgetz`` documents (wall-clock fields dropped), equal Prometheus text,
and the same PROMOTE / HOLD / ROLLBACK verdicts with the same reasons over
warming, clean, hard-regression, soft-signal, spent-budget and eval
regressions; the pending-rollback state machine behind ``RolloutCheck`` and
its lineage stamps. All compared for equality (host arithmetic). Then the
plane on the port's engine on the CPU: requests land in the cohort of the
engine's own version, an ``apply_delta`` canary opens a second cohort, a
shed charges the live version, and the verdict engine decides between
them."""

import numpy as np
import pytest

from large_scale_recommendation_tpu.obs import budget as jbud
from large_scale_recommendation_tpu.obs import lineage as jlin
from large_scale_recommendation_tpu.obs import registry as jreg
from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.obs import budget as pbud
from large_scale_recommendation_tpu_torch.obs import lineage as plin
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry
from large_scale_recommendation_tpu_torch.serving import (
    AdmissionConfig,
    AdmissionController,
    AdmissionRejectedError,
    ServingEngine,
)
from large_scale_recommendation_tpu_torch.obs import health as ph
from test_torch_obs_requests import (  # noqa: F401 (fixture)
    cpu_model,
    drop_time,
    planes,
    request_stream,
)


def _lat(seed, n, scale):
    return np.random.default_rng(seed).exponential(scale, n).tolist()


def _feed(mod, registry, seed, canary_scale, canary_n, shed=0,
          evals=None, **kw):
    """Incumbent version 1 at a healthy 2 ms; canary version 2 at
    ``canary_scale``; explicit ``t`` for every served note."""
    b = mod.RolloutBudget(0.010, objective=0.9, fast_window=16,
                          slow_window=64, registry=registry, **kw)
    for i, lat in enumerate(_lat(seed, 200, 0.002)):
        b.note_result(1, lat, t=1000.0 + i)
    for i, lat in enumerate(_lat(seed + 1, canary_n, canary_scale)):
        b.note_result(2, lat, degraded=(i % 7 == 0), t=2000.0 + i)
    if shed:
        b.note_shed(2, shed)
    if evals is not None:
        b.note_eval(1, evals[0])
        b.note_eval(2, evals[1])
    b.note_extra(2, staleness_s=1.5)
    return b


SCENARIOS = {
    "warming": dict(canary_scale=0.002, canary_n=10),
    "clean": dict(canary_scale=0.002, canary_n=80),
    "hard_p99": dict(canary_scale=0.030, canary_n=80),
    "soft_hold": dict(canary_scale=0.0034, canary_n=60, sample_budget=512),
    "budget_spent": dict(canary_scale=0.0034, canary_n=90, sample_budget=64),
    "shed": dict(canary_scale=0.002, canary_n=80, shed=40),
    "eval": dict(canary_scale=0.002, canary_n=80,
                 evals=({"eval_rmse": 0.90, "eval_ndcg_at_k": 0.30},
                        {"eval_rmse": 1.20, "eval_ndcg_at_k": 0.31})),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_verdicts_and_snapshots_equal_jax(planes, name):
    kw = SCENARIOS[name]
    preg, jreg_ = MetricsRegistry(), jreg.MetricsRegistry()
    p = _feed(pbud, preg, 11, **kw)
    j = _feed(jbud, jreg_, 11, **kw)
    assert p.cohort(2)["first_t"] == j.cohort(2)["first_t"] == 2000.0
    assert drop_time(p.snapshot()) == drop_time(j.snapshot())
    pv = p.verdicts.evaluate(2, 1)
    jv = j.verdicts.evaluate(2, 1)
    assert pv["verdict"] == jv["verdict"]
    assert pv["reason"] == jv["reason"]
    assert drop_time(pv) == drop_time(jv)
    assert preg.to_prometheus() == jreg_.to_prometheus()
    pr, jr = pbud.RolloutCheck(p)(), jbud.RolloutCheck(j)()
    assert (pr.status, drop_time(pr.detail)) == (jr.status,
                                                drop_time(jr.detail))


def test_the_scenarios_cover_every_verdict(planes):
    seen = {}
    for name, kw in SCENARIOS.items():
        b = _feed(pbud, MetricsRegistry(), 11, **kw)
        seen[name] = b.verdicts.evaluate(2, 1)["verdict"]
    assert seen["warming"] == "HOLD" and seen["clean"] == "PROMOTE"
    assert seen["hard_p99"] == seen["shed"] == seen["eval"] == "ROLLBACK"
    assert seen["budget_spent"] == "ROLLBACK"
    assert seen["soft_hold"] == "HOLD"


def test_pending_rollback_state_machine_stamps_lineage(planes):
    out = []
    for mod, lmod, reg in ((pbud, plin, MetricsRegistry()),
                           (jbud, jlin, jreg.MetricsRegistry())):
        journal = lmod.LineageJournal(registry=reg)
        lmod.set_lineage(journal)
        try:
            b = _feed(mod, reg, 3, canary_scale=0.030, canary_n=80)
            b.verdicts.evaluate(2, 1)
            page = mod.RolloutCheck(b)()
            pending = sorted(b.verdicts.pending())
            acted = b.verdicts.mark_rolled_back(2)
            again = b.verdicts.mark_rolled_back(2)
            clear = mod.RolloutCheck(b)()
            rec = journal.resolve(2)
        finally:
            lmod.set_lineage(None)
        out.append((page.status, pending, acted, again, clear.status,
                    rec["verdict"], rec["rolled_back"],
                    b.verdicts.snapshot()["evaluations"]))
    assert out[0] == out[1]
    assert out[0][:5] == ("degraded", [2], True, False, "ok")


def test_off_docs_scope_and_validation_as_jax(planes):
    assert pbud.budgetz() == jbud.budgetz()
    assert pbud.serve_scope(1) is pbud._NULL_CONTEXT
    b = obs.enable_budget(1.0)
    with pbud.serve_scope(5):
        pass
    assert b.cohort(5)["served"] == 1
    for mod in (pbud, jbud):
        with pytest.raises(ValueError):
            mod.RolloutBudget(0.1, fast_window=100, slow_window=10)
        with pytest.raises(ValueError):
            mod.RolloutBudget(0.1, max_versions=0)
        with pytest.raises(ValueError):
            mod.RolloutBudget(0.1, min_samples=10, sample_budget=5)


def test_cohort_table_is_bounded_as_jax(planes):
    docs = []
    for mod, reg in ((pbud, MetricsRegistry()), (jbud, jreg.MetricsRegistry())):
        b = mod.RolloutBudget(0.01, max_versions=3, registry=reg)
        for v in range(6):
            b.note_result(v, 0.001 * (v + 1), t=float(v))
        docs.append((b.versions(), b.evicted, drop_time(b.snapshot())))
    assert docs[0] == docs[1]
    assert docs[0][0] == [3, 4, 5] and docs[0][1] == 3


def test_engine_cohorts_follow_the_engine_version(planes):
    obs.enable()
    obs.enable_lineage()
    budget = obs.enable_budget(10.0, objective=0.9, min_samples=8)
    engine = ServingEngine(cpu_model(), k=10, max_batch=64)
    v1 = engine.version
    engine.serve(request_stream(20, seed=2))
    rng = np.random.default_rng(4)
    rows = np.arange(0, 500, 7)
    v2 = engine.apply_delta(item_rows=rows, V_rows=rng.normal(
        size=(len(rows), 16)).astype(np.float32))
    assert v2 != v1 and engine.version == v2
    engine.serve(request_stream(15, seed=3))
    snap = budget.snapshot()
    assert set(snap["cohorts"]) == {str(v1), str(v2)}
    assert snap["cohorts"][str(v1)]["served"] == 20
    assert snap["cohorts"][str(v2)]["served"] == 15
    verdict = budget.verdicts.evaluate(v2, v1)
    assert verdict["verdict"] in ("PROMOTE", "HOLD")
    assert obs.get_lineage().resolve(v2)["verdict"] == verdict["verdict"]


def test_engine_shed_charges_the_live_version(planes):
    obs.enable()
    budget = obs.enable_budget(10.0)
    slo = ph.SLOTracker(1e-9, objective=0.9, window=16)
    adm = AdmissionController(slo, AdmissionConfig(min_samples=2))
    engine = ServingEngine(cpu_model(), k=10, max_batch=8, admission=adm)
    out = engine.serve(request_stream(60, max_users=4))
    n_shed = sum(isinstance(r, AdmissionRejectedError) for r in out)
    assert n_shed
    c = budget.cohort(engine.version)
    assert c["shed"] == n_shed and c["served"] == len(out) - n_shed
    assert c["shed_frac"] == n_shed / len(out)
