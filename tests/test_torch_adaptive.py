"""The port's ``AdaptiveMF`` (``models/adaptive.py``) against the JAX
package's, on the CPU, over the same batches. The online tables of both
initialize rows through a ``FunctionFactorInitializer`` over one numpy
table; each retrain's initial factors are the JAX package's own (recorded
from its ``_init_factors`` and carried across with ``convert``), since
Philox ≠ threefry. Bars: tables within the DSGD plain-route bar of
tests/test_torch_dsgd.py (rtol 2e-4 / atol 2e-5) and the ALS fit bar of
tests/test_torch_als.py (rtol 2e-3 / atol 2e-4)."""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from large_scale_recommendation_tpu.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu.core.initializers import (
    FunctionFactorInitializer as JFunctionInit,
)
from large_scale_recommendation_tpu.core.types import Ratings as JRatings
from large_scale_recommendation_tpu.models import adaptive as jadaptive
from large_scale_recommendation_tpu.models.als import ALS as JALS
from large_scale_recommendation_tpu.models.dsgd import DSGD as JDSGD
from large_scale_recommendation_tpu.models.dsgd import DSGDConfig as JDSGDConfig
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch.core.initializers import (
    FunctionFactorInitializer,
    PseudoRandomFactorInitializer,
)
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.models.adaptive import (
    AdaptiveMF,
    AdaptiveMFConfig,
)
from large_scale_recommendation_tpu_torch.models.als import ALS
from large_scale_recommendation_tpu_torch.models.dsgd import DSGD

BARS = {"dsgd": dict(rtol=2e-4, atol=2e-5), "als": dict(rtol=2e-3, atol=2e-4)}
RANK = 4
_INIT = np.random.default_rng(11).uniform(
    -0.3, 0.3, (512, RANK)).astype(np.float32)


@pytest.fixture
def retrain_inits(monkeypatch):
    """Record each JAX retrain's initial factors; the port's retrains take
    them in the same order."""
    recorded = {"dsgd": [], "als": []}
    j_dsgd, j_als = JDSGD._init_factors, JALS._init_factors

    def jax_dsgd(self, problem):
        U, V = j_dsgd(self, problem)
        recorded["dsgd"].append((np.asarray(U), np.asarray(V)))
        return U, V

    def jax_als(self, users, items):
        U, V = j_als(self, users, items)
        recorded["als"].append((np.asarray(U), np.asarray(V)))
        return U, V

    monkeypatch.setattr(JDSGD, "_init_factors", jax_dsgd)
    monkeypatch.setattr(JALS, "_init_factors", jax_als)
    monkeypatch.setattr(DSGD, "_init_factors", lambda self, problem:
                        convert.factors_from_jax(*recorded["dsgd"].pop(0),
                                                 device="cpu"))
    monkeypatch.setattr(ALS, "_init_factors", lambda self, users, items:
                        convert.factors_from_jax(*recorded["als"].pop(0),
                                                 device="cpu"))
    return recorded


def _pair(**kw):
    kw = dict(dict(num_factors=RANK, minibatch_size=64, offline_iterations=2,
                   learning_rate=0.05), **kw)
    jm = jadaptive.AdaptiveMF(jadaptive.AdaptiveMFConfig(**kw))
    pm = AdaptiveMF(AdaptiveMFConfig(**kw), device="cpu")
    jinit = JFunctionInit(RANK, lambda ids: jnp.asarray(_INIT[np.asarray(
        ids)]))
    pinit = FunctionFactorInitializer(
        RANK, lambda ids: torch.from_numpy(_INIT[ids.cpu().numpy()]))
    for t in (jm.online.users, jm.online.items):
        t.initializer = jinit
    for t in (pm.online.users, pm.online.items):
        t.initializer = pinit
    return jm, pm


def _batches(n, size=300, seed=0, users=30, items=20):
    gen = SyntheticMFGenerator(num_users=users, num_items=items, rank=3,
                               noise=0.1, seed=seed)
    return [gen.generate(size) for _ in range(n)]


def _port(b):
    return Ratings.from_arrays(*b.to_numpy())


def _assert_close(pm, jm, bar):
    for pt, jt in ((pm.online.users, jm.online.users),
                   (pm.online.items, jm.online.items)):
        np.testing.assert_array_equal(pt.id_array(), jt.id_array())
        n = pt.num_rows
        np.testing.assert_allclose(pt.array[:n].numpy(),
                                   np.asarray(jt.array)[:n], **bar)
    assert pm.online.step == jm.online.step
    assert pm.online.consumed_offsets == jm.online.consumed_offsets
    assert pm.retrain_count == jm.retrain_count
    assert pm._history_rows == jm._history_rows


@pytest.mark.parametrize("algo", ["dsgd", "als"])
def test_retrain_cadence_matches_jax(retrain_inits, algo):
    jm, pm = _pair(offline_every=3, offline_algorithm=algo)
    for k, b in enumerate(_batches(7)):
        jm.process(b, offset=(0, 300 * (k + 1)))
        pm.process(_port(b), offset=(0, 300 * (k + 1)))
    assert pm.retrain_count == 2 and pm.state == "Online"
    assert retrain_inits[algo] == []  # every recorded init was used
    _assert_close(pm, jm, BARS[algo])
    test = _batches(1, 500, seed=9)[0]
    assert abs(pm.rmse(_port(test)) - jm.rmse(test)) < 1e-3


def test_trigger_only_mode_and_online_vocabulary(retrain_inits):
    jm, pm = _pair(offline_every=None, minibatch_size=8)
    for b in _batches(3, seed=1):
        jm.process(b)
        pm.process(_port(b))
    assert pm.retrain_count == 0
    jm.trigger_batch_training()
    pm.trigger_batch_training()
    assert pm.retrain_count == jm.retrain_count == 1
    # an id seen online after the retrain keeps its online vector
    late = ([99], [1], [4.0])
    jm.process(JRatings.from_arrays(*late))
    pm.process(Ratings.from_arrays(*late))
    s = pm.predict([99, 1], [1, 1])
    assert s[0] != 0.0 and s[1] != 0.0
    np.testing.assert_allclose(s, np.asarray(jm.predict([99, 1], [1, 1])),
                               **BARS["dsgd"])
    _assert_close(pm, jm, BARS["dsgd"])


def test_history_limit_matches_jax():
    jm, pm = _pair(offline_every=None, history_limit=1000)
    for b in _batches(10, 400, seed=5):
        jm.process(b)
        pm.process(_port(b))
    assert pm._history_rows == jm._history_rows <= 1400
    got, want = pm._history_ratings(), jm._history_ratings()
    for a, b in zip(got.to_numpy(), want.to_numpy()):
        np.testing.assert_array_equal(a, np.asarray(b))


def _gated_retrain(model, gate):
    real = model._retrain

    def retrain(history):
        assert gate.wait(30)
        return real(history)

    model._retrain = retrain


def test_background_retrain_buffers_replays_and_swaps_serving(
        retrain_inits):
    """The retrain waits on an event while three batches arrive: they are
    buffered with frozen stamps; ``flush`` swaps the retrained factors in
    (the engine's catalog version moves) and replays them in order."""
    jm, pm = _pair(offline_every=None, background=True)
    gates = [threading.Event(), threading.Event()]
    _gated_retrain(jm, gates[0])
    _gated_retrain(pm, gates[1])
    engine = pm.serving_engine(k=3)
    seen = [engine.version]
    engine.on_refresh = seen.append
    batches = _batches(6, seed=4)
    for k, b in enumerate(batches[:3]):
        jm.process(b, offset=(0, 300 * (k + 1)))
        pm.process(_port(b), offset=(0, 300 * (k + 1)))
    jm.trigger_batch_training()
    pm.trigger_batch_training()
    assert pm.state == jm.state == "Batch"
    for k, b in enumerate(batches[3:], start=3):
        out = pm.process(_port(b), offset=(0, 300 * (k + 1)))
        jm.process(b, offset=(0, 300 * (k + 1)))
        assert out.user_arrays[0].size == 0  # buffered
    assert pm.online.consumed_offsets == {0: 900}  # the stamp is frozen
    assert len(seen) == 1
    gates[0].set()  # JAX first: its retrain records the initial factors
    jout = jm.flush()
    gates[1].set()
    out = pm.flush()
    assert pm.state == "Online" and pm.retrain_count == 1
    assert pm.online.consumed_offsets == {0: 1800}
    assert len(seen) == 2 and engine.version == seen[-1]
    assert not torch.equal(engine.model.V, pm.to_model().V)  # replayed
    np.testing.assert_array_equal(out.user_arrays[0], jout.user_arrays[0])
    _assert_close(pm, jm, BARS["dsgd"])


def test_a_background_retrain_fault_surfaces_and_the_buffer_survives():
    _, pm = _pair(offline_every=None, background=True)
    gate = threading.Event()

    def broken(history):
        assert gate.wait(30)
        raise RuntimeError("retrain failed")

    pm._retrain = broken
    batches = _batches(3, seed=6)
    pm.process(_port(batches[0]), offset=(0, 300))
    pm.trigger_batch_training()
    pm.process(_port(batches[1]), offset=(0, 600))  # buffered
    gate.set()
    pm._thread.join(30)
    assert not pm._thread.is_alive()
    with pytest.raises(RuntimeError, match="retrain failed"):
        pm.process(_port(batches[2]), offset=(0, 900))
    assert pm.state == "Batch" and pm.online.consumed_offsets == {0: 300}
    pm.flush()  # the next call replays the buffer, without a swap
    assert pm.state == "Online" and pm.retrain_count == 0
    assert pm.online.consumed_offsets == {0: 900} and pm.online.step == 3


def test_concurrent_applies_serialize_process():
    _, pm = _pair(offline_every=None)
    pm.enable_concurrent_applies()
    assert pm.concurrent_applies
    real, owned = pm.online.partial_fit, []

    def fit(*a, **kw):
        owned.append(pm.apply_lock._is_owned())
        return real(*a, **kw)

    pm.online.partial_fit = fit
    batches = _batches(4, seed=7)
    threads = [threading.Thread(target=pm.process, args=(_port(b),))
               for b in batches]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert owned == [True] * 4 and pm.online.step == 4


def test_adaptive_from_jax_carries_the_state(retrain_inits):
    jm, _ = _pair(offline_every=3)
    batches = _batches(6, seed=8)
    for k, b in enumerate(batches[:4]):
        jm.process(b, offset=(1, 300 * (k + 1)))
    pm = convert.adaptive_from_jax(jm, device="cpu")
    retrain_inits["dsgd"].clear()  # the port did not run JAX's first retrain
    for t in (pm.online.users, pm.online.items):
        t.initializer = FunctionFactorInitializer(
            RANK, lambda ids: torch.from_numpy(_INIT[ids.cpu().numpy()]))
    assert pm.config == AdaptiveMFConfig(**{
        f: getattr(jm.config, f) for f in AdaptiveMFConfig.__dataclass_fields__})
    assert pm.device.type == "cpu"
    _assert_close(pm, jm, dict(rtol=0, atol=0))  # carried bit for bit
    assert pm._batches_since_retrain == jm._batches_since_retrain == 1
    for k, b in enumerate(batches[4:], start=4):
        jm.process(b, offset=(1, 300 * (k + 1)))
        pm.process(_port(b), offset=(1, 300 * (k + 1)))
    assert pm.retrain_count == 2
    _assert_close(pm, jm, BARS["dsgd"])
    jm._state = "Batch"  # a retrain in flight is refused
    with pytest.raises(ValueError, match="flush"):
        convert.adaptive_from_jax(jm, device="cpu")


def test_flush_outside_batch_and_to_model():
    _, pm = _pair(offline_every=None)
    out = pm.flush()
    assert out.user_updates == [] and out.user_arrays[1].shape == (0, RANK)
    for b in _batches(2, seed=2):
        pm.process(_port(b))
    pm.trigger_batch_training()
    snap = pm.to_model()
    te = _port(_batches(1, 400, seed=3)[0])
    np.testing.assert_allclose(snap.predict(te.users, te.items),
                               pm.predict(te.users, te.items), rtol=1e-6)


def test_rank_128_retrain_stays_finite_where_the_jax_config_diverges():
    """The DSGD retrain starts at the online init scale (0.1): the JAX
    package's config (``DSGDConfig``'s init 1.0, constant lr 0.05) turns
    NaN on this history at rank 128, the port's stays finite."""
    gen = SyntheticMFGenerator(num_users=6000, num_items=300, rank=16,
                               noise=0.1, seed=3, skew_lam=2.0)
    history = gen.generate(60_000)
    jcfg = jadaptive.AdaptiveMFConfig(num_factors=128, minibatch_size=1024,
                                      learning_rate=0.05, offline_every=None,
                                      offline_iterations=3)
    jmodel = jadaptive.AdaptiveMF(jcfg)._retrain(history)
    assert not np.isfinite(np.asarray(jmodel.U)).all()
    pm = AdaptiveMF(AdaptiveMFConfig(**{
        f: getattr(jcfg, f) for f in AdaptiveMFConfig.__dataclass_fields__}),
        device="cpu")
    pm.process(_port(history))
    pm.trigger_batch_training()
    assert pm.retrain_count == 1
    assert torch.isfinite(pm.online.users.array).all()
    assert torch.isfinite(pm.online.items.array).all()
    test = _port(gen.generate(5000))
    assert pm.rmse(test) < 0.5


def test_dsgd_retrain_from_its_own_init_matches_jax_at_that_scale(
        monkeypatch):
    """The port's DSGD retrain starts from its own keyed rows at the online
    init scale (0.1); the JAX package's DSGD given ``init_scale=0.1`` and
    those initial tables, on the same history, ends within the DSGD bar."""
    pm = AdaptiveMF(AdaptiveMFConfig(num_factors=RANK, minibatch_size=64,
                                     learning_rate=0.05, offline_every=None,
                                     offline_iterations=2), device="cpu")
    inits, fitted = [], []
    real_init, real_retrain = DSGD._init_factors, pm._retrain

    def port_init(self, problem):
        U, V = real_init(self, problem)
        inits.append((U.clone(), V.clone()))
        return U, V

    monkeypatch.setattr(DSGD, "_init_factors", port_init)
    pm._retrain = lambda h: fitted.append(real_retrain(h)) or fitted[-1]
    for b in _batches(3, seed=8):
        pm.process(_port(b))
    pm.trigger_batch_training()
    assert pm.retrain_count == 1 and len(inits) == len(fitted) == 1
    (U0, V0), model = inits[0], fitted[0]
    keyed = PseudoRandomFactorInitializer(RANK, scale=0.1)
    assert torch.equal(U0, keyed(np.maximum(model.users.ids, 0)))
    assert torch.equal(V0, keyed(np.maximum(model.items.ids, 0)))

    monkeypatch.setattr(JDSGD, "_init_factors", lambda self, problem: (
        jnp.asarray(U0.numpy()), jnp.asarray(V0.numpy())))
    history = JRatings.from_arrays(*pm._history_ratings().to_numpy())
    want = JDSGD(JDSGDConfig(
        num_factors=RANK, lambda_=pm.config.lambda_, iterations=2,
        learning_rate=0.05, lr_schedule="constant", minibatch_size=64,
        init_scale=0.1)).fit(history)
    for got, ref, side in ((model.U, want.U, "users"),
                           (model.V, want.V, "items")):
        np.testing.assert_array_equal(getattr(model, side).ids,
                                      np.asarray(getattr(want, side).ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   **BARS["dsgd"])
