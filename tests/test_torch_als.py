"""The port's ALS (``ops.als``, ``models.als``) and the sampled ranking
metrics against the JAX package's, on the CPU, from the same numpy inputs.

Bars (the JAX package's own): plans bit-equal (host, device, and JAX's);
one half-step rtol 2e-4 / atol 2e-5 (tests/test_als.py:226); ``fit`` and
``fit_device`` over 3 rounds from JAX's V, carried across (the port's keyed
init differs from threefry by design), rtol 2e-3 / atol 2e-4
(tests/test_als.py:106) and RMSE within 1e-4. The implicit half-step, G
included, holds the same half-step bar (measured 1.5e-7 max-abs against
JAX on both plan routes). bf16 grams against the JAX bf16 route: 2e-5 of
the largest |x| per half-step and the ``fit`` bar over 3 rounds (measured
3e-6 max-abs there; both round the same weights and targets to bf16 and
multiply in f32); within the port,
bf16 against f32 at relative error < 0.05 and RMSE gap < 0.01
(tests/test_als.py:738, :753). Sampled HR/NDCG within 1e-5 on the same
negatives; catalog coverage exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from large_scale_recommendation_tpu.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu.core.initializers import (
    PseudoRandomFactorInitializer as JInit,
)
from large_scale_recommendation_tpu.models.als import ALS as JALS
from large_scale_recommendation_tpu.models.als import ALSConfig as JConfig
from large_scale_recommendation_tpu.obs import quality as jquality
from large_scale_recommendation_tpu.ops import als as jals
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.models.als import ALS, ALSConfig
from large_scale_recommendation_tpu_torch.ops import als as als_ops
from large_scale_recommendation_tpu_torch.utils import metrics

HALF = dict(rtol=2e-4, atol=2e-5)
FIT = dict(rtol=2e-3, atol=2e-4)


def _problem(seed=0, e=2000, n_rows=60, n_other=45, k=6, skew=True):
    rng = np.random.default_rng(seed)
    out_rows = rng.integers(0, n_rows, e)
    if skew:  # hot rows: several pad classes
        out_rows[: e // 2] = rng.integers(0, 5, e // 2)
    other = rng.integers(0, n_other, e)
    vals = rng.normal(0, 1, e).astype(np.float32)
    F = rng.normal(size=(n_other, k)).astype(np.float32)
    return out_rows, other, vals, F, n_rows


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_buckets_equal(got, want):
    assert len(got) == len(want)
    for bg, bw in zip(got, want):
        assert len(bg) == len(bw)
        for a, b in zip(bg, bw):
            a, b = _np(a), _np(b)
            assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b)


def _by_row(prepared, num_rows):
    """Chunked buckets as {pad: (rows, oidx, vals, w, scale)} sorted by row,
    chunk-padding rows dropped."""
    out = {}
    for rows3, oidx3, vals3, w3, sc3 in prepared:
        pad = oidx3.shape[-1]
        rows = rows3.reshape(-1).numpy()
        keep = rows != num_rows
        order = np.argsort(rows[keep], kind="stable")
        out[pad] = tuple(a.reshape(len(rows), -1).numpy()[keep][order]
                         for a in (oidx3, vals3, w3, sc3[..., None]))
        out[pad] = (rows[keep][order],) + out[pad]
    return out


# -- plans -----------------------------------------------------------------


@pytest.mark.parametrize("min_pad", [8, 1, 16])
@pytest.mark.parametrize("skew", [True, False])
def test_host_plan_is_bit_equal_to_jax(min_pad, skew):
    out_rows, other, vals, _, n_rows = _problem(skew=skew)
    got = als_ops.build_solve_plan(out_rows, other, vals, n_rows,
                                   min_pad=min_pad)
    want = jals.build_solve_plan(out_rows, other, vals, n_rows,
                                 min_pad=min_pad)
    assert got.num_rows == want.num_rows
    assert got.padded_nnz == want.padded_nnz
    _assert_buckets_equal(got.buckets, want.buckets)


@pytest.mark.parametrize("omega,alpha", [(False, None), (True, None),
                                         (False, 4.0), (True, 7.0)])
def test_prepare_side_is_bit_equal_to_jax(omega, alpha):
    out_rows, other, vals, F, n_rows = _problem(seed=1)
    om = (np.bincount(out_rows, minlength=n_rows).astype(np.float32)
          if omega else None)
    if alpha is not None:
        vals = np.abs(vals)
    k = F.shape[1]
    plan = als_ops.build_solve_plan(out_rows, other, vals, n_rows)
    got = als_ops.prepare_side(plan, om, k, implicit_alpha=alpha,
                               device="cpu")
    want = jals.prepare_side(jals.build_solve_plan(out_rows, other, vals,
                                                   n_rows),
                             om, k, implicit_alpha=alpha)
    _assert_buckets_equal(got, want)


@pytest.mark.parametrize("omega", [False, True])
@pytest.mark.parametrize("min_pad", [8, 2, 32])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_device_plan_is_bit_equal_to_jax_and_to_the_host_plan(
        omega, min_pad, as_tensor):
    out_rows, other, vals, F, n_rows = _problem(seed=2)
    k = F.shape[1]
    om = (np.bincount(out_rows, minlength=n_rows).astype(np.float32)
          if omega else None)
    args = (out_rows, other, vals)
    if as_tensor:
        args = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    got = als_ops.device_prepare_side(
        *args, n_rows, omega=om, min_pad=min_pad, rank_for_chunking=k,
        device="cpu")
    want = jals.device_prepare_side(out_rows, other, vals, n_rows, omega=om,
                                    min_pad=min_pad, rank_for_chunking=k)
    _assert_buckets_equal(got, want)
    # host and device plans: the same buckets, row for row (the device plan
    # orders the merged min_pad bucket by count class, as JAX's does)
    host = als_ops.prepare_side(
        als_ops.build_solve_plan(out_rows, other, vals, n_rows,
                                 min_pad=min_pad), om, k, device="cpu")
    hb, db = _by_row(host, n_rows), _by_row(got, n_rows)
    assert sorted(hb) == sorted(db)
    for pad in hb:
        for a, b in zip(hb[pad], db[pad]):
            np.testing.assert_array_equal(a, b)


def test_device_plan_rejects_non_pow2_min_pad():
    out_rows, other, vals, _, n_rows = _problem()
    with pytest.raises(ValueError, match="power of 2"):
        als_ops.device_prepare_side(out_rows, other, vals, n_rows, min_pad=6,
                                    device="cpu")


def test_implicit_prepared_matches_jax_and_the_host_rebuild():
    out_rows, other, vals, F, n_rows = _problem(seed=3)
    vals = np.abs(vals)
    k = F.shape[1]
    dev = als_ops.device_prepare_side(out_rows, other, vals, n_rows,
                                      rank_for_chunking=k, device="cpu")
    got = als_ops.implicit_prepared(dev, 7.0)
    want = jals.implicit_prepared(
        jals.device_prepare_side(out_rows, other, vals, n_rows,
                                 rank_for_chunking=k), 7.0)
    # rows, partners, gram weights α·v and scales bit-equal; the targets
    # w + α·v within one f32 ulp (XLA contracts them into one FMA, torch
    # rounds the product first)
    assert len(got) == len(want)
    for bg, bw in zip(got, want):
        for j, (a, b) in enumerate(zip(bg, bw)):
            if j == 2:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1.2e-7, atol=0)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # against the host rebuild w·(1 + α·v): within 1e-6, the bar of the
    # JAX package's own test (tests/test_als.py:401)
    plan = als_ops.build_solve_plan(out_rows, other, vals, n_rows)
    host = als_ops.prepare_side(plan, None, k, implicit_alpha=7.0,
                                device="cpu")
    via = als_ops.implicit_prepared(als_ops.prepare_side(plan, None, k,
                                                         device="cpu"), 7.0)
    for bd, bh in zip(via, host):
        for a, b in zip(bd, bh):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


@pytest.mark.parametrize("nb,pad,k", [(5, 8, 6), (3000, 64, 128),
                                      (100_000, 8, 256), (1, 1, 1)])
def test_chunk_geometry_is_jax_s(nb, pad, k):
    assert als_ops._chunk_geometry(nb, pad, k, 256 << 20) == \
        jals._chunk_geometry(nb, pad, k, 256 << 20)


# -- solves ----------------------------------------------------------------


def test_solve_normal_eq_matches_jax_and_numpy():
    rng = np.random.default_rng(1)
    n, k = 6, 5
    M = rng.normal(size=(n, k, k)).astype(np.float32)
    A = np.einsum("nij,nkj->nik", M, M)
    b = rng.normal(size=(n, k)).astype(np.float32)
    s = np.array([0, 1, 2, 3, 0.5, 7], np.float32)
    for sc in (None, s):
        got = als_ops.solve_normal_eq(
            torch.from_numpy(A), torch.from_numpy(b), 0.3,
            None if sc is None else torch.from_numpy(sc)).numpy()
        want = np.asarray(jals.solve_normal_eq(
            jnp.asarray(A), jnp.asarray(b), 0.3,
            None if sc is None else jnp.asarray(sc)))
        np.testing.assert_allclose(got, want, **HALF)
        for j in range(n):
            lam = 0.3 * (1.0 if sc is None else max(sc[j], 1.0))
            ref = np.linalg.solve(A[j].astype(np.float64) + lam * np.eye(k),
                                  b[j])
            np.testing.assert_allclose(got[j], ref, rtol=1e-3, atol=1e-4)


def test_empty_rows_solve_to_zero_and_non_pd_to_nan():
    x = als_ops.solve_normal_eq(torch.zeros(3, 4, 4), torch.zeros(3, 4), 0.1)
    assert torch.equal(x, torch.zeros(3, 4))
    # an indefinite system: NaN as in JAX, no exception
    A = np.stack([np.eye(3), -5 * np.eye(3)]).astype(np.float32)
    b = np.ones((2, 3), np.float32)
    got = als_ops.solve_normal_eq(torch.from_numpy(A), torch.from_numpy(b),
                                  0.1).numpy()
    want = np.asarray(jals.solve_normal_eq(jnp.asarray(A), jnp.asarray(b),
                                           0.1))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all() and np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], want[0], **HALF)


@pytest.mark.parametrize("mode", ["direct", "als_wr", "implicit"])
@pytest.mark.parametrize("route", ["host", "device"])
def test_half_step_matches_jax(mode, route):
    out_rows, other, vals, F, n_rows = _problem(seed=4)
    n_rows += 4  # four rows without ratings
    k = F.shape[1]
    om = (np.bincount(out_rows, minlength=n_rows).astype(np.float32)
          if mode == "als_wr" else None)
    alpha = 5.0 if mode == "implicit" else None
    if alpha is not None:
        vals = np.abs(vals)
    G = (F.T @ F).astype(np.float32) if alpha is not None else None
    if route == "host":
        prep = als_ops.prepare_side(
            als_ops.build_solve_plan(out_rows, other, vals, n_rows), om, k,
            implicit_alpha=alpha, device="cpu")
        jprep = jals.prepare_side(
            jals.build_solve_plan(out_rows, other, vals, n_rows), om, k,
            implicit_alpha=alpha)
    else:
        prep = als_ops.device_prepare_side(out_rows, other, vals, n_rows,
                                           omega=om, rank_for_chunking=k,
                                           device="cpu")
        jprep = jals.device_prepare_side(out_rows, other, vals, n_rows,
                                         omega=om, rank_for_chunking=k)
        if alpha is not None:
            prep = als_ops.implicit_prepared(prep, alpha)
            jprep = jals.implicit_prepared(jprep, alpha)
    got = als_ops.solve_side(
        torch.from_numpy(F), prep, n_rows, 0.3,
        None if G is None else torch.from_numpy(G)).numpy()
    want = np.asarray(jals.solve_side(
        jnp.asarray(F), jprep, n_rows, 0.3,
        None if G is None else jnp.asarray(G)))
    assert got.shape == (n_rows, k) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **HALF)
    empty = np.bincount(out_rows, minlength=n_rows) == 0
    assert empty.any() and (got[empty] == 0).all()


def test_half_step_matches_the_scatter_add_oracle():
    out_rows, other, vals, F, n_rows = _problem(seed=5, e=512, skew=False)
    k = F.shape[1]
    prep = als_ops.prepare_side(
        als_ops.build_solve_plan(out_rows, other, vals, n_rows), None, k,
        device="cpu")
    got = als_ops.solve_side(torch.from_numpy(F), prep, n_rows, 0.2)
    t = [torch.from_numpy(np.asarray(a)) for a in (F, out_rows, other, vals)]
    A, b = als_ops.gram_stats(t[0], t[1], t[2], t[3], torch.ones(512),
                              n_rows, 128)
    jA, jb = jals.gram_stats(jnp.asarray(F), jnp.asarray(out_rows),
                             jnp.asarray(other), jnp.asarray(vals),
                             jnp.ones(512, jnp.float32), n_rows, 128)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5)
    want = als_ops.solve_normal_eq(A, b, 0.2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **HALF)
    with pytest.raises(ValueError, match="divisible"):
        als_ops.gram_stats(t[0], t[1], t[2], t[3], torch.ones(512), n_rows,
                           100)


def test_full_gram_and_rounds_match_jax():
    out_rows, other, vals, F, n_rows = _problem(seed=6, n_other=40)
    k = F.shape[1]
    np.testing.assert_allclose(als_ops._full_gram(torch.from_numpy(F)).numpy(),
                               np.asarray(jals._full_gram(jnp.asarray(F))),
                               rtol=1e-5, atol=1e-5)
    up = als_ops.build_solve_plan(out_rows, other, vals, n_rows)
    ip = als_ops.build_solve_plan(other, out_rows, vals, 40)
    jup = jals.build_solve_plan(out_rows, other, vals, n_rows)
    jip = jals.build_solve_plan(other, out_rows, vals, 40)
    om_u = np.bincount(out_rows, minlength=n_rows).astype(np.float32)
    om_v = np.bincount(other, minlength=40).astype(np.float32)
    U0 = np.zeros((n_rows, k), np.float32)
    kw = dict(lambda_=0.2, iterations=2, reg_mode="als_wr")
    U, V = als_ops.als_train_planned(torch.from_numpy(U0),
                                     torch.from_numpy(F), up, ip, om_u, om_v,
                                     **kw)
    jU, jV = jals.als_train_planned(jnp.asarray(U0), jnp.asarray(F), jup, jip,
                                    om_u, om_v, **kw)
    np.testing.assert_allclose(U.numpy(), np.asarray(jU), **FIT)
    np.testing.assert_allclose(V.numpy(), np.asarray(jV), **FIT)


@pytest.mark.parametrize("implicit", [False, True])
def test_bf16_half_step_matches_jax_bf16_and_stays_near_f32(implicit):
    rng = np.random.default_rng(11)
    e, n_rows, n_other, k = 2000, 60, 50, 8
    out_rows = rng.integers(0, n_rows, e)
    other = rng.integers(0, n_other, e)
    vals = rng.normal(size=e).astype(np.float32)
    F = rng.normal(size=(n_other, k)).astype(np.float32) * 0.3
    alpha = None
    G = jG = None
    if implicit:
        vals, alpha = np.abs(vals), 3.0
        G = torch.from_numpy(F.T @ F)
        jG = jnp.asarray(F.T @ F)
    plan = als_ops.build_solve_plan(out_rows, other, vals, n_rows)
    prep = als_ops.prepare_side(plan, None, k, implicit_alpha=alpha,
                                device="cpu")
    jprep = jals.prepare_side(
        jals.build_solve_plan(out_rows, other, vals, n_rows), None, k,
        implicit_alpha=alpha)
    x16 = als_ops.solve_side(torch.from_numpy(F), prep, n_rows, 0.05, G,
                             dtype=torch.bfloat16).numpy()
    j16 = np.asarray(jals.solve_side(jnp.asarray(F), jprep, n_rows, 0.05, jG,
                                     dtype=jnp.bfloat16))
    x32 = als_ops.solve_side(torch.from_numpy(F), prep, n_rows, 0.05,
                             G).numpy()
    assert x16.dtype == np.float32  # the solved side stays f32
    scale = np.abs(x32).max()
    assert np.abs(x16 - j16).max() <= 2e-5 * scale
    err = np.abs(x16 - x32).max() / scale
    assert err < 0.05, err
    assert not np.allclose(x16, x32)  # the bf16 route engaged


# -- the model -------------------------------------------------------------


def _data(seed=3, users=120, items=80, n=6000):
    gen = SyntheticMFGenerator(num_users=users, num_items=items, rank=4,
                               noise=0.05, seed=seed)
    return gen.generate(n), gen.generate(1000)


def _port(r):
    return Ratings.from_arrays(*r.to_numpy())


CFGS = {
    "direct": dict(num_factors=6, lambda_=0.05, iterations=3),
    "als_wr": dict(num_factors=6, lambda_=0.02, iterations=3,
                   reg_mode="als_wr"),
    "implicit": dict(num_factors=6, lambda_=0.1, iterations=3,
                     implicit_alpha=2.0),
    "bf16": dict(num_factors=6, lambda_=0.05, iterations=3,
                 gram_dtype="bf16"),
}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_fit_matches_jax_from_its_tables(name):
    train, test = _data()
    if name == "implicit":
        ru, ri, rv, _ = train.to_numpy()
        train = type(train).from_arrays(ru, ri, np.abs(rv))
    jsolver = JALS(JConfig(**CFGS[name]))
    jmodel = jsolver.fit(train)
    JU, JV = (np.asarray(a) for a in jsolver._init_factors(jmodel.users,
                                                           jmodel.items))
    solver = ALS(ALSConfig(**CFGS[name]), device="cpu")
    # the seam: JAX's initial tables replace the port's keyed init
    solver._init_factors = lambda users, items: convert.factors_from_jax(
        JU, JV, device="cpu")
    model = solver.fit(_port(train))
    for f in ("ids", "omega", "sorted_ids", "sorted_rows"):
        np.testing.assert_array_equal(getattr(model.users, f),
                                      getattr(jmodel.users, f))
        np.testing.assert_array_equal(getattr(model.items, f),
                                      getattr(jmodel.items, f))
    for a, b in ((model.U, jmodel.U), (model.V, jmodel.V)):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FIT)
    tt = _port(test)
    assert abs(model.rmse(tt) - jmodel.rmse(test)) < 1e-4
    assert abs(solver.empirical_risk(tt) - jsolver.empirical_risk(test)) \
        <= 1e-3 * abs(jsolver.empirical_risk(test))
    assert solver.round_ms == []  # CUDA events only on a card


@pytest.mark.parametrize("name", ["direct", "als_wr", "implicit"])
def test_fit_device_matches_jax_from_its_tables(name):
    train, test = _data(seed=9, users=100, items=70)
    ru, ri, rv, _ = train.to_numpy()
    if name == "implicit":
        rv = np.abs(rv)
    cfg = CFGS[name]
    jmodel = JALS(JConfig(**cfg)).fit_device(ru, ri, rv, 100, 70)
    # JAX's fit_device initial V, computed as it computes it
    seen = np.bincount(ri, minlength=70) > 0
    JV = np.asarray(JInit(cfg["num_factors"], scale=0.1)(
        np.arange(70, dtype=np.int32))) * seen[:, None]
    solver = ALS(ALSConfig(**cfg), device="cpu")
    solver._init_factors_device = lambda n, omega: torch.from_numpy(
        JV.astype(np.float32))
    model = solver.fit_device(ru, ri, rv, 100, 70)
    for side in ("users", "items"):
        for f in ("ids", "omega", "sorted_ids", "sorted_rows"):
            np.testing.assert_array_equal(
                getattr(getattr(model, side), f),
                getattr(getattr(jmodel, side), f))
    for a, b in ((model.U, jmodel.U), (model.V, jmodel.V)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FIT)
    assert abs(model.rmse(_port(test)) - jmodel.rmse(test)) < 1e-4
    # tensors in give the same model as numpy in
    m2 = ALS(ALSConfig(**cfg), device="cpu")
    m2._init_factors_device = solver._init_factors_device
    t = m2.fit_device(torch.from_numpy(ru), torch.from_numpy(ri),
                      torch.from_numpy(rv), 100, 70)
    assert torch.equal(t.U, model.U) and torch.equal(t.V, model.V)


def test_fit_and_fit_device_converge_with_their_own_init():
    train, test = _data(seed=3, n=12000)
    cfg = ALSConfig(num_factors=8, lambda_=0.05, iterations=8)
    m32 = ALS(cfg, device="cpu").fit(_port(train))
    m16 = ALS(ALSConfig(num_factors=8, lambda_=0.05, iterations=8,
                        gram_dtype="bf16"), device="cpu").fit(_port(train))
    ru, ri, rv, _ = train.to_numpy()
    md = ALS(cfg, device="cpu").fit_device(ru, ri, rv, 120, 80)
    tt = _port(test)
    r32, r16, rd = m32.rmse(tt), m16.rmse(tt), md.rmse(tt)
    assert r32 < 0.12 and rd < 0.12 and r16 < 0.12
    assert abs(r16 - r32) < 0.01, (r16, r32)
    # an id held out of fit_device's training scores exactly 0
    held = int(ru[0])
    keep = ru != held
    m2 = ALS(cfg, device="cpu").fit_device(ru[keep], ri[keep], rv[keep],
                                           120, 80)
    assert float(m2.predict(np.array([held]), np.array([0]))[0]) == 0.0


def test_errors():
    with pytest.raises(ValueError, match="gram_dtype"):
        ALS(ALSConfig(gram_dtype="fp8"), device="cpu").fit(
            _port(SyntheticMFGenerator(num_users=10, num_items=10, rank=2,
                                       seed=0).generate(100)))
    with pytest.raises(ValueError, match="gram_dtype"):
        ALS(ALSConfig(gram_dtype="int8"), device="cpu").fit_device(
            np.array([0]), np.array([0]), np.ones(1, np.float32), 1, 1)
    with pytest.raises(ValueError, match="empty"):
        ALS(device="cpu").fit(Ratings.from_arrays([], [], []))
    with pytest.raises(ValueError, match="empty"):
        ALS(device="cpu").fit_device(np.array([], np.int64),
                                     np.array([], np.int64),
                                     np.array([], np.float32), 3, 3)
    with pytest.raises(ValueError, match="dense ids"):
        ALS(device="cpu").fit_device(np.array([0, 120]), np.array([0, 0]),
                                     np.ones(2, np.float32), 120, 90)
    with pytest.raises(RuntimeError, match="fit"):
        ALS(device="cpu").predict([1], [1])


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ALS(ALSConfig())
    assert ALS(device="cpu").device.type == "cpu"


# -- sampled ranking metrics and coverage ------------------------------------


def _tables(seed=0, nu=300, ni=200, k=8):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(nu, k)).astype(np.float32)
    V = rng.normal(size=(ni, k)).astype(np.float32)
    tu = rng.integers(0, nu, 3000)
    ti = rng.integers(0, ni, 3000)
    eu = rng.integers(0, nu, 700)
    ei = rng.integers(0, ni, 700)
    return U, V, tu, ti, eu, ei


@pytest.mark.parametrize("train,mask,chunk", [
    (False, False, 1024), (True, False, 256), (True, True, 100)])
def test_sampled_ranking_metrics_match_jax(train, mask, chunk):
    U, V, tu, ti, eu, ei = _tables()
    item_mask = (np.arange(V.shape[0]) % 7 != 0) if mask else None
    kw = dict(k=10, num_negatives=50, seed=7, chunk=chunk,
              item_mask=item_mask,
              train_u=tu if train else None, train_i=ti if train else None)
    got = metrics.sampled_ranking_metrics(torch.from_numpy(U),
                                          torch.from_numpy(V), eu, ei, **kw)
    want = jquality.sampled_ranking_metrics(U, V, eu, ei, **kw)
    assert got["n"] == want["n"] == 700
    assert got["num_negatives"] == want["num_negatives"]
    assert got["valid_negatives"] == want["valid_negatives"]
    assert abs(got["hr"] - want["hr"]) <= 1e-5
    assert abs(got["ndcg"] - want["ndcg"]) <= 1e-5
    assert 0 < got["hr"] < 1


def test_sampled_ranking_metrics_empty():
    U, V, *_ = _tables()
    out = metrics.sampled_ranking_metrics(torch.from_numpy(U),
                                          torch.from_numpy(V), [], [])
    assert out["n"] == 0 and np.isnan(out["hr"])


@pytest.mark.parametrize("train,mask", [(False, False), (True, True)])
def test_catalog_coverage_matches_jax(train, mask):
    U, V, tu, ti, eu, _ = _tables(seed=1)
    item_mask = (np.arange(V.shape[0]) % 5 != 0) if mask else None
    kw = dict(k=10, item_mask=item_mask,
              train_u=tu if train else None, train_i=ti if train else None)
    users = np.unique(eu)[:64]
    got = metrics.catalog_coverage(torch.from_numpy(U), torch.from_numpy(V),
                                   users, **kw)
    want = jquality.catalog_coverage(U, V, users, **kw)
    assert got == want and 0 < got <= 1
    assert np.isnan(metrics.catalog_coverage(torch.from_numpy(U),
                                             torch.from_numpy(V), []))
