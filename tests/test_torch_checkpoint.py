"""Checkpoints: the port's ``utils.checkpoint`` writes and reads the JAX
package's format (``ckpt_<step>.npz``, json ``__meta__``, bf16 as a tagged
uint16 bit view), so either package restores what the other wrote, exactly;
and ``DSGD.fit`` / ``fit_device`` resume bit-equal to an uninterrupted run
on the CPU."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from large_scale_recommendation_tpu.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu.data import blocking as jblk
from large_scale_recommendation_tpu.models.dsgd import DSGD as JDSGD
from large_scale_recommendation_tpu.models.dsgd import DSGDConfig as JConfig
from large_scale_recommendation_tpu.models.mf import MFModel as JMFModel
from large_scale_recommendation_tpu.utils import checkpoint as jckpt
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.models.dsgd import DSGD, DSGDConfig
from large_scale_recommendation_tpu_torch.utils import checkpoint as ckpt


def _bits(a):
    """A bf16 table (torch or ml_dtypes numpy) as its int16 bits."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    U = rng.normal(0, 1, (40, 8)).astype(np.float32)
    V = rng.normal(0, 1e-3, (24, 8)).astype(np.float32)
    return U, V


@pytest.mark.parametrize("as_tensor", [False, True])
def test_port_round_trip_f32_and_bf16(tmp_path, as_tensor):
    U, V = _tables()
    Ub = torch.from_numpy(U).to(torch.bfloat16)
    m = ckpt.CheckpointManager(str(tmp_path))
    arrays = {"U": torch.from_numpy(U) if as_tensor else U, "Ub": Ub,
              "ids": np.arange(5)}
    path = m.save(4, arrays, {"kind": "x", "note": [1, 2]})
    assert os.path.basename(path) == "ckpt_4.npz"
    ck = m.restore()
    assert ck.step == 4 and ck.meta == {"kind": "x", "note": [1, 2]}
    assert isinstance(ck["U"], np.ndarray) and ck["U"].dtype == np.float32
    np.testing.assert_array_equal(ck["U"], U)
    assert ck["Ub"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(ck["Ub"]), _bits(Ub))
    np.testing.assert_array_equal(ck["ids"], np.arange(5))
    with np.load(path) as z:  # the on-disk encoding
        assert z["Ub"].dtype == np.uint16 and "__meta__" in z.files


def test_jax_written_restores_in_the_port(tmp_path):
    U, V = _tables(1)
    Ub = jnp.asarray(U).astype(jnp.bfloat16)
    jckpt.CheckpointManager(str(tmp_path)).save(
        7, {"U": U, "Vb": np.asarray(jnp.asarray(V).astype(jnp.bfloat16))},
        {"kind": "dsgd_segment"})
    jckpt.CheckpointManager(str(tmp_path)).save(8, {"Ub": np.asarray(Ub)})
    m = ckpt.CheckpointManager(str(tmp_path))
    assert m.steps() == [7, 8]
    ck = m.restore(7)
    assert ck.meta == {"kind": "dsgd_segment"}
    np.testing.assert_array_equal(ck["U"], U)
    vb = np.asarray(jnp.asarray(V).astype(jnp.bfloat16))
    assert ck["Vb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(ck["Vb"]), _bits(vb))
    np.testing.assert_array_equal(_bits(m.restore()["Ub"]), _bits(Ub))


def test_port_written_restores_in_jax(tmp_path):
    U, V = _tables(2)
    Ub = torch.from_numpy(U).to(torch.bfloat16)
    ckpt.CheckpointManager(str(tmp_path)).save(
        3, {"U": U, "Ub": Ub, "Vb": np.asarray(V).astype(ml_dtypes.bfloat16)},
        {"kind": "dsgd_device_segment"})
    ck = jckpt.CheckpointManager(str(tmp_path)).restore()
    assert ck.step == 3 and ck.meta == {"kind": "dsgd_device_segment"}
    np.testing.assert_array_equal(ck["U"], U)
    assert ck["Ub"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(_bits(ck["Ub"]), _bits(Ub))
    np.testing.assert_array_equal(
        _bits(ck["Vb"]), _bits(np.asarray(V).astype(ml_dtypes.bfloat16)))


def test_retention_and_empty_directory(tmp_path):
    m = ckpt.CheckpointManager(str(tmp_path / "c"), keep=2)
    assert m.latest_step() is None
    with pytest.raises(FileNotFoundError):
        m.restore()
    for s in (1, 2, 10, 3):
        m.save(s, {"x": np.full(2, s)})
    assert m.steps() == [3, 10] and m.latest_step() == 10
    assert m.restore(3)["x"].tolist() == [3, 3]
    assert sorted(os.listdir(tmp_path / "c")) == ["ckpt_10.npz", "ckpt_3.npz"]


def _jmodel(dtype):
    gen = SyntheticMFGenerator(num_users=40, num_items=30, rank=3, noise=0.1,
                               seed=3)
    train = gen.generate(800)
    p = jblk.block_problem(train, num_blocks=2, seed=0)
    rng = np.random.default_rng(0)
    U = jnp.asarray(rng.normal(0, 0.5, (p.users.num_rows, 4)), dtype)
    V = jnp.asarray(rng.normal(0, 0.5, (p.items.num_rows, 4)), dtype)
    return JMFModel(U=U, V=V, users=p.users, items=p.items), train


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mf_model_across_packages(tmp_path, dtype):
    jm, train = _jmodel(jnp.dtype(dtype))
    jckpt.save_mf_model(jckpt.CheckpointManager(str(tmp_path / "j")), jm, 5)
    tm, ck = ckpt.restore_mf_model(ckpt.CheckpointManager(
        str(tmp_path / "j")), device="cpu")
    assert ck.meta["kind"] == "mf_model" and ck.meta["rank"] == 4
    assert tm.U.dtype == getattr(torch, dtype) and tm.rank == 4
    q_u, q_i = train.users[:50], train.items[:50]
    np.testing.assert_allclose(tm.predict(q_u, q_i),
                               np.asarray(jm.predict(q_u, q_i)),
                               rtol=1e-5, atol=1e-6)
    for f in ("ids", "omega", "sorted_ids", "sorted_rows"):
        np.testing.assert_array_equal(getattr(tm.users, f),
                                      getattr(jm.users, f))
    # and back: the port's snapshot of it restores in JAX, tables exact
    ckpt.save_mf_model(ckpt.CheckpointManager(str(tmp_path / "t")), tm, 6,
                       extra_meta={"source": "port"})
    jm2, jck = jckpt.restore_mf_model(
        jckpt.CheckpointManager(str(tmp_path / "t")))
    assert jck.meta["source"] == "port"
    np.testing.assert_array_equal(np.asarray(jm2.U).view(np.uint8),
                                  np.asarray(jm.U).view(np.uint8))
    tm2, _ = ckpt.restore_mf_model(ckpt.CheckpointManager(
        str(tmp_path / "t")), device="cpu")
    assert torch.equal(tm2.V, tm.V)
    np.testing.assert_array_equal(tm2.items.sorted_rows, tm.items.sorted_rows)


# -- resume through DSGD ----------------------------------------------------


def _train(seed=1, n=3000):
    gen = SyntheticMFGenerator(num_users=64, num_items=48, rank=4, noise=0.1,
                               seed=seed, skew_lam=2.0)
    return gen.generate(n), gen.generate(400)


def _cfg(iterations=3, dtype="float32", **kw):
    base = dict(num_factors=8, lambda_=0.05, iterations=iterations,
                learning_rate=0.05, lr_schedule="warm_boost", seed=0,
                minibatch_size=128, init_scale=0.3, minibatch_sort="item",
                factor_dtype=dtype)
    return DSGDConfig(**dict(base, **kw))


def _dense(n=3000, nu=64, ni=48, seed=4):
    rng = np.random.default_rng(seed)
    u = np.minimum(rng.exponential(nu / 3, n), nu - 1).astype(np.int32)
    i = np.minimum(rng.exponential(ni / 3, n), ni - 1).astype(np.int32)
    r = rng.normal(0, 1, n).astype(np.float32)
    return u, i, r, nu, ni


def _fit(path, cfg, data, **kw):
    solver = DSGD(cfg, device="cpu")
    if path == "fit":
        return solver.fit(Ratings.from_arrays(*data.to_numpy()), num_blocks=2,
                          **kw)
    return solver.fit_device(*data, num_blocks=2, **kw)


def _same_tables(a, b):
    assert a.U.dtype == b.U.dtype
    assert torch.equal(a.U, b.U) and torch.equal(a.V, b.V)


@pytest.mark.parametrize("path", ["fit", "fit_device"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fit_3_equals_fit_2_plus_resume_1(tmp_path, path, dtype):
    data = _train()[0] if path == "fit" else _dense()
    kind = "dsgd_segment" if path == "fit" else "dsgd_device_segment"
    full_m = ckpt.CheckpointManager(str(tmp_path / "full"))
    full = _fit(path, _cfg(3, dtype), data, checkpoint_manager=full_m,
                checkpoint_every=1)
    assert full_m.steps() == [1, 2, 3]
    last = full_m.restore()
    assert last.meta == {"kind": kind, "iterations": 3}
    np.testing.assert_array_equal(_bits(last["U"]) if dtype == "bfloat16"
                                  else last["U"],
                                  _bits(full.U) if dtype == "bfloat16"
                                  else full.U.numpy())
    # fit of 2 sweeps, then a resume of 1 from its last snapshot
    m = ckpt.CheckpointManager(str(tmp_path / "split"))
    _fit(path, _cfg(2, dtype), data, checkpoint_manager=m, checkpoint_every=1)
    resumed = _fit(path, _cfg(3, dtype), data, checkpoint_manager=m,
                   checkpoint_every=1, resume=True)
    _same_tables(resumed, full)
    assert m.steps() == [1, 2, 3]
    # the newest snapshot deleted: a resume redoes its sweep, bit-equal
    os.unlink(full_m.path(3))
    again = _fit(path, _cfg(3, dtype), data, checkpoint_manager=full_m,
                 checkpoint_every=1, resume=True)
    _same_tables(again, full)
    # nothing to resume from: a fresh fit
    fresh = _fit(path, _cfg(3, dtype), data, checkpoint_manager=ckpt
                 .CheckpointManager(str(tmp_path / "none")),
                 checkpoint_every=1, resume=True)
    _same_tables(fresh, full)


def test_resume_errors(tmp_path):
    train = Ratings.from_arrays(*_train()[0].to_numpy())
    m = ckpt.CheckpointManager(str(tmp_path))
    with pytest.raises(ValueError, match="requires a checkpoint_manager"):
        DSGD(_cfg(), device="cpu").fit(train, num_blocks=2, resume=True)
    DSGD(_cfg(1), device="cpu").fit(train, num_blocks=2,
                                    checkpoint_manager=m)
    with pytest.raises(ValueError, match="kind"):  # fit's rows, fit_device
        DSGD(_cfg(), device="cpu").fit_device(
            *_dense(), num_blocks=2, checkpoint_manager=m, resume=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        DSGD(_cfg(num_factors=4), device="cpu").fit(
            train, num_blocks=2, checkpoint_manager=m, resume=True)
    # a bf16 run resumes an f32 snapshot: the cast the storage applies
    model = DSGD(_cfg(dtype="bfloat16"), device="cpu").fit(
        train, num_blocks=2, checkpoint_manager=m, resume=True)
    assert model.U.dtype == torch.bfloat16


def test_hooks_run_before_the_snapshot(tmp_path):
    train = Ratings.from_arrays(*_train()[0].to_numpy())

    class Trip:
        def after_segment(self, U, V, label):
            assert label == "dsgd_segment"
            if m.steps() == [1]:
                raise FloatingPointError("tripped")

    m = ckpt.CheckpointManager(str(tmp_path))
    solver = DSGD(_cfg(), device="cpu")
    solver.watchdog = Trip()
    with pytest.raises(FloatingPointError):
        solver.fit(train, num_blocks=2, checkpoint_manager=m,
                   checkpoint_every=1)
    assert m.steps() == [1]  # the tripped segment left no resume point


def test_jax_checkpoint_resumed_in_the_port(tmp_path):
    """JAX fits 2 sweeps with snapshots; the port resumes its third; the
    tables match JAX's own 3-sweep fit at the two routes' bar."""
    train, test = _train(seed=5)
    kw = dict(num_factors=8, lambda_=0.05, learning_rate=0.05,
              lr_schedule="warm_boost", seed=0, minibatch_size=128,
              init_scale=0.3)
    jm = jckpt.CheckpointManager(str(tmp_path))
    JDSGD(JConfig(iterations=2, **kw, kernel="pallas")).fit(
        train, num_blocks=2, checkpoint_manager=jm, checkpoint_every=1)
    j3 = JDSGD(JConfig(iterations=3, **kw, kernel="pallas")).fit(
        train, num_blocks=2, checkpoint_every=1)
    model = DSGD(DSGDConfig(iterations=3, **kw), device="cpu").fit(
        Ratings.from_arrays(*train.to_numpy()), num_blocks=2,
        checkpoint_manager=ckpt.CheckpointManager(str(tmp_path)),
        checkpoint_every=1, resume=True)
    for a, b in ((model.U, j3.U), (model.V, j3.V)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    np.testing.assert_array_equal(model.items.ids, j3.items.ids)
    tt = Ratings.from_arrays(*test.to_numpy())
    assert abs(model.rmse(tt) - j3.rmse(test)) < 1e-5
    # and the port's resumed fit wrote the JAX format back
    assert jckpt.CheckpointManager(str(tmp_path)).restore().step == 3


def test_bf16_jax_checkpoint_resumed_in_the_port(tmp_path):
    """A bf16 JAX snapshot restores exactly into a bf16 port fit: with no
    sweeps left, the port's tables are the snapshot's bits."""
    train, _ = _train(seed=6)
    kw = dict(num_factors=8, lambda_=0.05, learning_rate=0.05, seed=0,
              minibatch_size=128, init_scale=0.3, factor_dtype="bfloat16")
    jm = jckpt.CheckpointManager(str(tmp_path))
    j2 = JDSGD(JConfig(iterations=2, **kw)).fit(
        train, num_blocks=2, checkpoint_manager=jm, checkpoint_every=1)
    model = DSGD(DSGDConfig(iterations=2, **kw), device="cpu").fit(
        Ratings.from_arrays(*train.to_numpy()), num_blocks=2,
        checkpoint_manager=ckpt.CheckpointManager(str(tmp_path)),
        resume=True)
    assert model.U.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(model.U), _bits(j2.U))
    np.testing.assert_array_equal(_bits(model.V), _bits(j2.V))
    np.testing.assert_array_equal(model.users.ids, j2.users.ids)


def test_bf16_round_trip_needs_no_ml_dtypes(tmp_path):
    """The port decodes bf16 through torch: it saves and restores a bf16
    table in an interpreter where ``import ml_dtypes`` (and JAX) fail."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {repo!r})\n"
        "import torch\n"
        "from large_scale_recommendation_tpu_torch.utils import checkpoint\n"
        f"m = checkpoint.CheckpointManager({str(tmp_path)!r})\n"
        "t = torch.linspace(-3, 3, 50).to(torch.bfloat16)\n"
        "m.save(1, {'U': t})\n"
        "got = m.restore()['U']\n"
        "assert got.dtype == torch.bfloat16 and torch.equal(got, t)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


# -- online state ------------------------------------------------------------


def _online_pair():
    """A JAX and a port ``OnlineMF`` fed the same 3 batches (the port
    carried across from the JAX model after the first), with offsets."""
    from large_scale_recommendation_tpu.models.online import (
        OnlineMF as JOnline,
    )
    from large_scale_recommendation_tpu.models.online import (
        OnlineMFConfig as JOnlineConfig,
    )
    from large_scale_recommendation_tpu_torch import convert

    gen = SyntheticMFGenerator(num_users=300, num_items=120, rank=3,
                               noise=0.1, seed=5, skew_lam=2.0)
    batches = [gen.generate(400) for _ in range(3)]
    j = JOnline(JOnlineConfig(num_factors=6, learning_rate=0.05,
                              minibatch_size=64, init_capacity=16))
    j.partial_fit(batches[0], offset=(0, 400))
    p = convert.online_from_jax(j, device="cpu")
    for k, b in enumerate(batches[1:]):
        j.partial_fit(b, offset=(1, 10 * (k + 1)))
        p.partial_fit(Ratings.from_arrays(*b.to_numpy()),
                      offset=(1, 10 * (k + 1)))
    return j, p


def _fresh_port():
    from large_scale_recommendation_tpu_torch.models.online import (
        OnlineMF,
        OnlineMFConfig,
    )

    return OnlineMF(OnlineMFConfig(num_factors=6, learning_rate=0.05,
                                   minibatch_size=64, init_capacity=16),
                    device="cpu")


def _fresh_jax():
    from large_scale_recommendation_tpu.models.online import (
        OnlineMF as JOnline,
    )
    from large_scale_recommendation_tpu.models.online import (
        OnlineMFConfig as JOnlineConfig,
    )

    return JOnline(JOnlineConfig(num_factors=6, learning_rate=0.05,
                                 minibatch_size=64, init_capacity=16))


def _assert_same_online(a, b):
    """Ids in row order equal; registered rows bit-equal; step and offsets
    equal (either package on either side)."""
    for ta, tb in ((a.users, b.users), (a.items, b.items)):
        np.testing.assert_array_equal(ta.id_array(), tb.id_array())
        n = ta.num_rows

        def rows(t):
            arr = t.array[:n]
            return arr.numpy() if isinstance(arr, torch.Tensor) \
                else np.asarray(arr)

        np.testing.assert_array_equal(rows(ta), rows(tb))
    assert a.step == b.step
    assert a.consumed_offsets == b.consumed_offsets


def test_online_state_round_trip_in_the_port(tmp_path):
    _, p = _online_pair()
    m = ckpt.CheckpointManager(str(tmp_path))
    path = ckpt.save_online_state(m, p, 3, extra_meta={"note": "x"})
    assert os.path.basename(path) == "ckpt_3.npz"
    q = _fresh_port()
    ck = ckpt.restore_online_state(m, q)
    assert ck.meta["kind"] == "online_state" and ck.meta["note"] == "x"
    assert ck.meta["offsets"] == {"0": 400, "1": 20}
    _assert_same_online(q, p)
    assert q.consumed_offsets == {0: 400, 1: 20} and q.step == 3
    arrays, meta = ckpt.snapshot_online_state(p)
    assert sorted(arrays) == ["U", "V", "item_ids", "user_ids"]
    assert meta["step"] == 3
    # a restored model trains on exactly as the saved one
    b = SyntheticMFGenerator(num_users=300, num_items=120, rank=3, seed=8,
                             noise=0.1).generate(300)
    rb = Ratings.from_arrays(*b.to_numpy())
    p.partial_fit(rb)
    q.partial_fit(rb)
    assert torch.equal(p.users.array[:p.users.num_rows],
                       q.users.array[:q.users.num_rows])


def test_online_state_jax_written_restores_in_the_port(tmp_path):
    j, _ = _online_pair()
    jckpt.save_online_state(jckpt.CheckpointManager(str(tmp_path)), j, 5)
    q = _fresh_port()
    ckpt.restore_online_state(ckpt.CheckpointManager(str(tmp_path)), q)
    _assert_same_online(q, j)


def test_online_state_port_written_restores_in_jax(tmp_path):
    _, p = _online_pair()
    ckpt.save_online_state(ckpt.CheckpointManager(str(tmp_path)), p, 5)
    jq = _fresh_jax()
    jckpt.restore_online_state(jckpt.CheckpointManager(str(tmp_path)), jq)
    _assert_same_online(jq, p)


def test_online_state_of_an_empty_model(tmp_path):
    m = ckpt.CheckpointManager(str(tmp_path))
    ckpt.save_online_state(m, _fresh_port(), 1)
    q = _fresh_port()
    ckpt.restore_online_state(m, q)
    assert q.users.num_rows == 0 and q.step == 0 and q.consumed_offsets == {}
