"""The port's SLO tracker (``obs.health``) and admission ladder
(``serving.admission``) against the JAX package's, on the CPU.

Bit-equal: every ``SLOTracker`` number (snapshot, burn rates, properties)
after each sample of one latency stream, and the ladder's level sequence
when both controllers watch that stream. Then the ladder's transitions,
driven by stuffing a tracker's window (escalation jumps, recovery steps
down through hysteresis, warmup cannot trip it, shedding raises the typed
error with its probe fraction), and the engine integration: degraded
results flagged, shed requests returned in order by ``serve``.
"""

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu.obs.health import SLOTracker as JSLO
from large_scale_recommendation_tpu.serving.admission import (
    AdmissionConfig as JConfig,
)
from large_scale_recommendation_tpu.serving.admission import (
    AdmissionController as JController,
)
from large_scale_recommendation_tpu_torch.data.blocking import flat_index
from large_scale_recommendation_tpu_torch.models.mf import MFModel
from large_scale_recommendation_tpu_torch.obs.health import (
    SLOTracker,
    _WindowReservoir,
)
from large_scale_recommendation_tpu_torch.serving import (
    AdmissionConfig,
    AdmissionController,
    AdmissionRejectedError,
    RetrievalConfig,
    ServingEngine,
)
from large_scale_recommendation_tpu_torch.serving.admission import (
    DEGRADE,
    NORMAL,
    SHED,
    WIDEN,
)


def latency_stream(n=300, seed=0):
    """A stream that calms, spikes and recovers: every ladder level."""
    rng = np.random.default_rng(seed)
    phases = [rng.uniform(0.0, 0.09, 60), rng.uniform(0.05, 0.2, 60),
              rng.uniform(0.1, 0.5, 60), rng.uniform(0.0, 0.12, 60),
              rng.uniform(0.0, 0.05, n - 240)]
    lat = np.concatenate(phases)
    lat[7] = np.nan  # NaN counts as violated
    return lat.tolist()


@pytest.mark.parametrize("window,objective,extras",
                         [(32, 0.9, None), (16, 0.99, {"fast": 4,
                                                       "slow": 64})])
def test_slo_tracker_bit_equal_to_jax(window, objective, extras):
    j = JSLO(target_s=0.1, objective=objective, window=window,
             windows=extras)
    t = SLOTracker(target_s=0.1, objective=objective, window=window,
                   windows=extras)
    assert t.snapshot() == j.snapshot()
    for x in latency_stream():
        j.record(x)
        t.record(x)
        assert t.snapshot() == j.snapshot()
        assert t.burn_rates() == j.burn_rates()
        assert (t.attainment, t.burn_rate, t.error_budget_remaining) == \
            (j.attainment, j.burn_rate, j.error_budget_remaining)
    assert t.count == j.count and t.violations == j.violations


def test_tracker_validation():
    with pytest.raises(ValueError, match="objective"):
        SLOTracker(0.1, objective=1.0)
    with pytest.raises(ValueError, match="window"):
        SLOTracker(0.1, window=0)
    with pytest.raises(ValueError, match="window"):
        _WindowReservoir(0)
    r = _WindowReservoir(2)
    for v in (True, True, False):
        r.push(v)
    assert (r.fill, r.violations) == (2, 1)
    assert r.stats(0.5) == (0.5, 1.0, 0.0)
    assert _WindowReservoir(3).stats(0.9) == (1.0, 0.0, 1.0)


@pytest.mark.parametrize("cfg", [dict(), dict(recover_ratio=0.5,
                                              min_samples=4, shed_probe=0.25)])
def test_level_sequence_bit_equal_to_jax(cfg):
    """Both ladders watch one latency stream (observe after every sample,
    one admission check per sample): the same level, transition count,
    shed count and admit decision at every step."""
    jslo = JSLO(target_s=0.1, objective=0.9, window=20)
    tslo = SLOTracker(target_s=0.1, objective=0.9, window=20)
    j, t = JController(jslo, JConfig(**cfg)), AdmissionController(
        tslo, AdmissionConfig(**cfg))
    levels = []
    for x in latency_stream(seed=1):
        jslo.record(x)
        tslo.record(x)
        assert t.observe() == j.observe()
        outcomes = []
        for ctl in (j, t):
            try:
                ctl.check_admit()
                outcomes.append("admit")
            except Exception as e:  # each package's own typed error
                outcomes.append((e.level, e.burn))
        assert outcomes[0] == outcomes[1]
        assert (t.level, t.transitions, t.sheds) == (j.level, j.transitions,
                                                     j.sheds)
        assert (t.widen_factor, t.degrade_active, t.widen_active) == \
            (j.widen_factor, j.degrade_active, j.widen_active)
        levels.append(t.level)
    assert set(levels) == {NORMAL, WIDEN, DEGRADE, SHED}


def make_tracker(objective=0.9, window=32):
    return SLOTracker(target_s=0.1, objective=objective, window=window)


def burn_to(slo, violation_frac, n=32):
    """Fill the window to an exact violation fraction."""
    n_viol = int(round(violation_frac * n))
    for i in range(n):
        slo.record(1.0 if i < n_viol else 0.01)


class TestLadder:
    def test_escalates_directly_to_warranted_level(self):
        slo = make_tracker()
        ctl = AdmissionController(slo, AdmissionConfig())
        burn_to(slo, 0.5)
        assert ctl.observe() == SHED and ctl.transitions == 1

    @pytest.mark.parametrize("frac,expect", [(0.05, NORMAL), (0.15, WIDEN),
                                             (0.25, DEGRADE), (0.45, SHED)])
    def test_each_threshold_maps_to_its_level(self, frac, expect):
        slo = make_tracker()
        ctl = AdmissionController(slo, AdmissionConfig())
        burn_to(slo, frac)
        assert ctl.observe() == expect

    def test_warmup_window_cannot_trip(self):
        slo = make_tracker()
        ctl = AdmissionController(slo, AdmissionConfig(min_samples=8))
        for _ in range(7):
            slo.record(1.0)
        assert ctl.observe() == NORMAL
        slo.record(1.0)
        assert ctl.observe() == SHED

    def test_recovery_steps_down_with_hysteresis(self):
        slo = make_tracker(window=20)
        ctl = AdmissionController(slo, AdmissionConfig())
        burn_to(slo, 0.5, n=20)
        assert ctl.observe() == SHED
        burn_to(slo, 0.3, n=20)  # burn 3 >= 4·0.7: hold
        assert ctl.observe() == SHED
        burn_to(slo, 0.15, n=20)  # burn 1.5 < 2.8: one step down
        assert ctl.observe() == DEGRADE
        burn_to(slo, 0.0, n=20)
        assert ctl.observe() == WIDEN
        assert ctl.observe() == NORMAL

    def test_shed_raises_typed_error_with_probe_fraction(self):
        slo = make_tracker()
        ctl = AdmissionController(slo, AdmissionConfig(shed_probe=0.25))
        burn_to(slo, 0.6)
        ctl.observe()
        assert not ctl.admit()
        outcomes = []
        for _ in range(20):
            try:
                ctl.check_admit()
                outcomes.append("admit")
            except AdmissionRejectedError as e:
                assert e.level == SHED and e.burn > 4
                outcomes.append("shed")
        assert outcomes.count("admit") == 5 and ctl.sheds == 15
        snap = ctl.snapshot()
        assert snap["level"] == SHED and snap["sheds"] == 15
        assert snap["slo"]["burn_rate"] == slo.burn_rate

    def test_config_validation(self):
        for kw, match in ((dict(widen_burn=3.0, degrade_burn=2.0),
                           "ordered"), (dict(recover_ratio=1.5),
                                        "recover_ratio"),
                          (dict(widen_factor=0.5), "widen_factor"),
                          (dict(shed_probe=0.0), "shed_probe")):
            with pytest.raises(ValueError, match=match):
                AdmissionConfig(**kw)

    def test_widen_factor_tracks_level(self):
        slo = make_tracker()
        ctl = AdmissionController(slo, AdmissionConfig(widen_factor=3.0))
        assert ctl.widen_factor == 1.0
        burn_to(slo, 0.15)
        ctl.observe()
        assert ctl.level == WIDEN and ctl.widen_factor == 3.0
        assert not ctl.degrade_active


def _model():
    rng = np.random.default_rng(20)
    return MFModel(
        U=torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32)),
        V=torch.from_numpy(rng.normal(size=(256, 8)).astype(np.float32)),
        users=flat_index(np.arange(50, dtype=np.int64)),
        items=flat_index(np.arange(256, dtype=np.int64)))


class TestEngineIntegration:
    def test_degrade_serves_stage1_only_flagged(self):
        slo = make_tracker()
        ctl = AdmissionController(slo, AdmissionConfig())
        eng = ServingEngine(_model(), k=5,
                            retrieval=RetrievalConfig(overfetch=4),
                            admission=ctl)
        exact = eng.recommend(np.arange(10))
        assert exact.degraded is False
        burn_to(slo, 0.25)  # burn 2.5: degrade band
        ctl.observe()
        res = eng.recommend(np.arange(10))
        assert res.degraded is True and ctl.degraded == 1
        # stage-1-only scores are the approximate (dequantized) ones
        assert (res[0] >= 0).all()
        assert not np.array_equal(res[1], exact[1])
        burn_to(slo, 0.0)
        ctl.observe()
        ctl.observe()
        assert eng.recommend(np.arange(10)).degraded is False

    def test_exact_engine_never_degrades(self):
        slo = make_tracker()
        ctl = AdmissionController(slo, AdmissionConfig())
        eng = ServingEngine(_model(), k=5, admission=ctl)
        burn_to(slo, 0.25)
        ctl.observe()
        assert ctl.degrade_active
        assert eng.recommend(np.arange(4)).degraded is False

    def test_shed_rejects_submit_and_recovers(self):
        slo = make_tracker()
        ctl = AdmissionController(slo, AdmissionConfig(shed_probe=0.5))
        eng = ServingEngine(_model(), k=5, admission=ctl)
        burn_to(slo, 0.6)
        ctl.observe()
        rejected = admitted = 0
        for _ in range(40):
            try:
                eng.recommend(np.arange(4))
                admitted += 1
            except AdmissionRejectedError:
                rejected += 1
        assert rejected > 0 and admitted > 0
        assert ctl.level != SHED  # probe flushes refreshed the window

    def test_serve_returns_shed_markers_in_order(self):
        slo = make_tracker()
        ctl = AdmissionController(slo, AdmissionConfig(shed_probe=0.5))
        model = _model()
        eng = ServingEngine(model, k=4, max_batch=16, admission=ctl)
        burn_to(slo, 0.6)
        ctl.observe()
        assert ctl.level == SHED
        reqs = [np.arange(i, i + 3) for i in range(12)]
        out = eng.serve(reqs)
        assert len(out) == len(reqs)
        sheds = [r for r in out if isinstance(r, AdmissionRejectedError)]
        served = [(i, r) for i, r in enumerate(out)
                  if not isinstance(r, AdmissionRejectedError)]
        assert sheds and served
        for i, r in served:
            np.testing.assert_array_equal(r[0],
                                          model.recommend(reqs[i], k=4)[0])
        assert eng._pending == []

    def test_attach_admission_swap_rebinds_adopted_tracker(self):
        eng = ServingEngine(_model(), k=4)
        assert eng.admission is None
        c1 = AdmissionController(make_tracker(), AdmissionConfig())
        eng.attach_admission(c1)
        assert eng.admission is c1 and eng._slo is c1.slo
        eng.recommend(np.arange(4))
        assert c1.slo.count > 0
        c2 = AdmissionController(make_tracker(), AdmissionConfig())
        eng.attach_admission(c2)
        before = c2.slo.count
        eng.recommend(np.arange(4))
        assert c2.slo.count > before

    def test_explicit_slo_is_not_rebound(self):
        own = make_tracker()
        eng = ServingEngine(_model(), k=4, slo=own)
        ctl = AdmissionController(make_tracker(), AdmissionConfig())
        eng.attach_admission(ctl)
        eng.recommend(np.arange(4))
        assert eng._slo is own and own.count == 1 and ctl.slo.count == 0

    def test_engine_adopts_controller_tracker(self):
        slo = make_tracker()
        eng = ServingEngine(_model(), k=5, admission=AdmissionController(
            slo, AdmissionConfig()))
        assert eng._slo is slo
        eng.recommend(np.arange(5))
        assert slo.count > 0

    def test_widen_threshold_stretches_serve_coalescing(self):
        class PinnedSLO:
            burn = 0.0
            count = 0

            def record(self, latency_s):
                self.count += 1

            @property
            def burn_rate(self):
                return self.burn

            def snapshot(self):
                return {"burn_rate": self.burn, "window_fill": 32,
                        "attainment": 1.0, "count": self.count}

        slo = PinnedSLO()
        ctl = AdmissionController(slo, AdmissionConfig(widen_factor=4.0))
        eng = ServingEngine(_model(), k=5, max_batch=16, admission=ctl)
        reqs = [np.arange(8) for _ in range(16)]
        eng.serve(reqs)
        assert ctl.level == NORMAL
        normal_flushes = eng.stats["flushes"]
        slo.burn = 1.5
        ctl.observe()
        assert ctl.level == WIDEN
        eng.stats["flushes"] = 0
        eng.serve(reqs)
        assert eng.stats["flushes"] < normal_flushes
