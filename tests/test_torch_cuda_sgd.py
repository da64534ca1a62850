"""The port's DSGD kernels' plain versions against the JAX package's TPU
kernels, run in interpret mode on the CPU as tests/test_pallas_sgd.py runs
them, and the port's plain ``ops.sgd`` route against the JAX one.

Tolerances: rtol 1e-5 / atol 1e-6 after one stratum (the f32 dot is reduced
in another order); rtol 2e-4 / atol 2e-5 after 3 sweeps (the bounds the JAX
package holds between its own two routes, tests/test_pallas_sgd.py).
On the card the scatter's atomics add duplicate rows in a varying order;
that tolerance is checked by chip_smoke.py and tests marked ``cuda``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from large_scale_recommendation_tpu.core import updaters as ju
from large_scale_recommendation_tpu.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu.data import blocking as jblk
from large_scale_recommendation_tpu.ops import pallas_sgd as jp
from large_scale_recommendation_tpu.ops import sgd as jsgd
from large_scale_recommendation_tpu_torch.core import updaters as tu
from large_scale_recommendation_tpu_torch.ops import cuda_sgd as tc
from large_scale_recommendation_tpu_torch.ops import sgd as tsgd

ONE = dict(rtol=1e-5, atol=1e-6)
SWEEPS = dict(rtol=2e-4, atol=2e-5)


def _t(a):
    # a copy: the in-place wrappers must never write through to the inputs
    return torch.from_numpy(np.array(a))


def _close(torch_pair, jax_pair, tol):
    for a, b in zip(torch_pair, jax_pair):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


def _blocked(k, rank, divisor, seed=0, skew=2.0):
    """A skewed blocked problem (duplicate rows inside minibatches, weight-0
    block padding) with minibatch = block / divisor; numpy arrays in the
    stratum-major layout plus initial tables."""
    gen = SyntheticMFGenerator(num_users=60, num_items=45, rank=4,
                               noise=0.1, seed=seed, skew_lam=skew)
    train = gen.generate(800)
    b = jblk.block_problem(train, num_blocks=k, seed=0).ratings.u_rows.shape[-1]
    prob = jblk.block_problem(train, num_blocks=k, seed=0,
                              minibatch_multiple=-(-b // divisor))
    r = prob.ratings
    mb = r.u_rows.shape[-1] // divisor
    icu, icv = jblk.minibatch_inv_counts(r, mb)
    rng = np.random.default_rng(seed + 100)
    U = rng.uniform(0, 0.3, (prob.users.num_rows, rank)).astype(np.float32)
    V = rng.uniform(0, 0.3, (prob.items.num_rows, rank)).astype(np.float32)
    assert (r.weights == 0).any()  # padding present
    arrs = dict(su=r.u_rows, si=r.i_rows, sv=r.values, sw=r.weights,
                ou=prob.users.omega, ov=prob.items.omega, icu=icu, icv=icv)
    return arrs, U, V, mb, prob.users.rows_per_block, prob.items.rows_per_block


def _operands(a, k, rpb_u, rpb_v, mb):
    keys = ("su", "si", "sv", "sw", "icu", "icv", "ou", "ov")
    jidx, jstr = jp.build_stratum_operands(
        *(jnp.asarray(a[x]) for x in keys), num_blocks=k, rpb_u=rpb_u,
        rpb_v=rpb_v, minibatch=mb)
    tidx, tstr = tc.build_stratum_operands(
        *(_t(a[x]) for x in keys), num_blocks=k, rpb_u=rpb_u, rpb_v=rpb_v,
        minibatch=mb)
    return (jidx, jstr), (tidx, tstr)


@pytest.mark.parametrize("k,rank,divisor", [(2, 8, 1), (3, 8, 4),
                                            (2, 32, 3)])
def test_build_stratum_operands_bit_equal(k, rank, divisor):
    a, _, _, mb, rpb_u, rpb_v = _blocked(k, rank, divisor)
    (jidx, jstr), (tidx, tstr) = _operands(a, k, rpb_u, rpb_v, mb)
    assert tidx.dtype == torch.int32 and tidx.min() >= 0
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tstr.numpy(), np.asarray(jstr))


@pytest.mark.parametrize("k,rank,divisor", [(2, 8, 1), (3, 8, 4),
                                            (2, 32, 3)])
def test_stratum_reference_matches_pallas_stratum_kernel(k, rank, divisor):
    a, U, V, mb, rpb_u, rpb_v = _blocked(k, rank, divisor, seed=k)
    (jidx, jstr), (tidx, tstr) = _operands(a, k, rpb_u, rpb_v, mb)
    kw = dict(lr=0.1, lam=0.05, minibatch=mb, num_blocks=k)
    # one compile: the stratum id is a runtime scalar of the TPU kernel
    pallas = jax.jit(functools.partial(jp.pallas_stratum_sweep,
                                       interpret=True, **kw))
    # one stratum, each s from the same tables
    for s in range(k):
        _close(tc.stratum_sweep_reference(_t(U), _t(V), tidx, tstr, s, **kw),
               pallas(jnp.asarray(U), jnp.asarray(V), jidx, jstr, s), ONE)
    # 3 sweeps, chained
    tU, tV, jU, jV = _t(U), _t(V), jnp.asarray(U), jnp.asarray(V)
    for _ in range(3):
        for s in range(k):
            tU, tV = tc.stratum_sweep_reference(tU, tV, tidx, tstr, s, **kw)
            jU, jV = pallas(jU, jV, jidx, jstr, s)
    _close((tU, tV), (jU, jV), SWEEPS)


def _visit(seed, e, rpb_u, rpb_v, rank, pad_frac, mb):
    rng = np.random.default_rng(seed)
    ur = rng.integers(0, rpb_u, e).astype(np.int32)
    ir = rng.integers(0, rpb_v, e).astype(np.int32)
    vals = rng.normal(0, 1, e).astype(np.float32)
    w = np.ones(e, np.float32)
    w[rng.random(e) < pad_frac] = 0.0
    U = rng.normal(0, 0.1, (rpb_u, rank)).astype(np.float32)
    V = rng.normal(0, 0.1, (rpb_v, rank)).astype(np.float32)
    ou = np.bincount(ur, weights=w, minlength=rpb_u).astype(np.float32)
    ov = np.bincount(ir, weights=w, minlength=rpb_v).astype(np.float32)
    from large_scale_recommendation_tpu_torch.data.native import (
        minibatch_inv_counts_flat,
    )

    icu = minibatch_inv_counts_flat(ur, w, mb)
    icv = minibatch_inv_counts_flat(ir, w, mb)
    return ur, ir, vals, w, icu, icv, ou, ov, U, V


@pytest.mark.parametrize("rank,pad_frac,mb", [(8, 0.0, 64), (8, 0.15, 32),
                                              (32, 0.1, 256)])
def test_block_reference_matches_pallas_block_kernel(rank, pad_frac, mb):
    # 256 entries over 20 / 12 rows: many duplicates in every minibatch
    ur, ir, vals, w, icu, icv, ou, ov, U, V = _visit(rank, 256, 20, 12, rank,
                                                     pad_frac, mb)
    kw = dict(lr=0.1, lam=0.05, minibatch=mb)
    got = tc.block_sweep_reference(
        _t(U), _t(V), _t(ur), _t(ir), _t(vals), _t(w), _t(icu), _t(icv),
        _t(ou), _t(ov), **kw)
    want = jp.pallas_block_sweep(
        *(jnp.asarray(x) for x in (U, V, ur, ir, vals, w, icu, icv, ou, ov)),
        gather="loop", interpret=True, **kw)
    _close(got, want, ONE)


def test_stratum_wrappers_on_cpu_use_plain_versions_and_count_nothing():
    """``stratum_sweep`` on CPU tensors equals the plain stratum reference
    (global rows vs block-local operands) and launches no kernel."""
    k, rank, divisor = 3, 8, 2
    a, U, V, mb, rpb_u, rpb_v = _blocked(k, rank, divisor, seed=5)
    _, (tidx, tstr) = _operands(a, k, rpb_u, rpb_v, mb)
    tc.reset_launch_counts()
    du, dv = tc.alloc_scratch(k, mb, rank, "cpu")
    args = [_t(a[x]) for x in ("su", "si", "sv", "sw", "icu", "icv", "ou",
                               "ov")]
    for s in range(k):
        Ug, Vg = _t(U), _t(V)
        tc.stratum_sweep(Ug, Vg, *args, s, du, dv, lr=0.2, lam=0.1,
                         minibatch=mb)
        Ur, Vr = tc.stratum_sweep_reference(_t(U), _t(V), tidx, tstr, s,
                                            lr=0.2, lam=0.1, minibatch=mb,
                                            num_blocks=k)
        np.testing.assert_allclose(Ug.numpy(), Ur.numpy(), **ONE)
        np.testing.assert_allclose(Vg.numpy(), Vr.numpy(), **ONE)
    assert tc.LAUNCHES == {"sgd_delta_kernel": 0, "sgd_scatter_kernel": 0}


def _jax_common(a, U, V):
    return (jnp.asarray(U), jnp.asarray(V),
            *(jnp.asarray(a[x]) for x in ("su", "si", "sv", "sw", "ou", "ov",
                                          "icu", "icv")))


def _torch_common(a, U, V):
    return (_t(U), _t(V),
            *(_t(a[x]) for x in ("su", "si", "sv", "sw", "ou", "ov", "icu",
                                 "icv")))


@pytest.mark.parametrize("sched,t0", [("warm_boost", 0), ("warm_boost", 1),
                                      ("inverse_sqrt", 5)])
@pytest.mark.parametrize("divisor", [1, 4])
def test_dsgd_train_cuda_matches_pallas_and_xla(sched, t0, divisor):
    k, rank, iters = 2, 8, 3
    a, U, V, mb, _, _ = _blocked(k, rank, divisor, seed=divisor)
    lr, lam = 0.05, 0.1
    js = ju.schedule_from_name(sched, lam)
    ts = tu.schedule_from_name(sched, lam)
    Up, Vp = jp.dsgd_train_pallas(
        *_jax_common(a, U, V), lr=lr, lam=lam, minibatch=mb, num_blocks=k,
        iterations=iters, interpret=True, schedule=js, t0=t0)
    Ux, Vx = jsgd.dsgd_train(
        *_jax_common(a, U, V),
        updater=ju.RegularizedSGDUpdater(learning_rate=lr, lambda_=lam,
                                         schedule=js),
        minibatch=mb, num_blocks=k, iterations=iters, collision="mean",
        t0=t0)
    tc.reset_launch_counts()
    Uc, Vc = tc.dsgd_train_cuda(
        *_torch_common(a, U, V), lr=lr, lam=lam, minibatch=mb, num_blocks=k,
        iterations=iters, schedule=ts, t0=t0)
    assert sum(tc.LAUNCHES.values()) == 0  # CPU tensors: plain versions
    Ut, Vt = tsgd.dsgd_train(
        *_torch_common(a, U, V),
        updater=tu.RegularizedSGDUpdater(learning_rate=lr, lambda_=lam,
                                         schedule=ts),
        minibatch=mb, num_blocks=k, iterations=iters, collision="mean",
        t0=t0)
    _close((Uc, Vc), (Up, Vp), SWEEPS)
    _close((Ut, Vt), (Ux, Vx), SWEEPS)
    _close((Uc, Vc), (Ux, Vx), SWEEPS)
    # the inputs are not mutated (trained copies come back)
    np.testing.assert_array_equal(_torch_common(a, U, V)[0].numpy(), U)


def test_dsgd_train_cuda_rejects_bad_layouts():
    a, U, V, mb, _, _ = _blocked(2, 8, 2)
    common = list(_torch_common(a, U, V))
    kw = dict(lr=0.1, lam=0.1, minibatch=mb, num_blocks=2, iterations=1)
    with pytest.raises(ValueError, match="divisible"):
        tc.dsgd_train_cuda(common[0][:-1], *common[1:], **kw)
    bad = common.copy()
    bad[2] = bad[2].clone()
    bad[2][0, 0, 0] = U.shape[0]
    with pytest.raises(ValueError, match="outside"):
        tc.dsgd_train_cuda(*bad, **kw)
    with pytest.raises(ValueError, match="multiple"):
        tc.dsgd_train_cuda(*common, **{**kw, "minibatch": mb + 1})


def test_cuda_contract_matches_pallas_contract():
    good = tu.RegularizedSGDUpdater()
    tc.validate_cuda_contract(good, "mean", True)
    for upd, coll, inv in ((tu.SGDUpdater(), "mean", True),
                           (good, "sum", True), (good, "mean", False)):
        with pytest.raises(ValueError, match="RegularizedSGDUpdater"):
            tc.validate_cuda_contract(upd, coll, inv)
        jupd = (ju.SGDUpdater() if isinstance(upd, tu.SGDUpdater)
                else ju.RegularizedSGDUpdater())
        with pytest.raises(ValueError, match="RegularizedSGDUpdater"):
            jp.validate_pallas_contract(jupd, coll, inv)


@pytest.mark.parametrize("collision,pre", [("mean", False), ("sum", False),
                                           ("mean", True)])
def test_plain_block_sweep_matches_jax(collision, pre):
    ur, ir, vals, w, icu, icv, ou, ov, U, V = _visit(3, 256, 20, 12, 8, 0.1,
                                                     64)
    ju_ = ju.RegularizedSGDUpdater(learning_rate=0.1, lambda_=0.05)
    tu_ = tu.RegularizedSGDUpdater(learning_rate=0.1, lambda_=0.05)
    want = jsgd.sgd_block_sweep(
        *(jnp.asarray(x) for x in (U, V, ur, ir, vals, w, ou, ov)), ju_, 2,
        64, collision, *((jnp.asarray(icu), jnp.asarray(icv)) if pre
                         else (None, None)))
    got = tsgd.sgd_block_sweep(
        *(_t(x) for x in (U, V, ur, ir, vals, w, ou, ov)), tu_, 2, 64,
        collision, *((_t(icu), _t(icv)) if pre else (None, None)))
    _close(got, want, ONE)
    with pytest.raises(ValueError, match="collision"):
        tsgd.sgd_minibatch_update(_t(U), _t(V), _t(ur), _t(ir), _t(vals),
                                  _t(w), None, None, tu_, 1, "max")


def test_scoring_rows_match_jax():
    ur, ir, vals, w, _, _, _, _, U, V = _visit(4, 300, 20, 12, 16, 0.2, 64)
    ju_, ji_ = jnp.asarray(ur), jnp.asarray(ir)
    tu_, ti_ = _t(ur).long(), _t(ir).long()
    np.testing.assert_allclose(
        tsgd.predict_rows(_t(U), _t(V), tu_, ti_).numpy(),
        np.asarray(jsgd.predict_rows(jnp.asarray(U), jnp.asarray(V), ju_,
                                     ji_)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        float(tsgd.sse_rows(_t(U), _t(V), tu_, ti_, _t(vals), _t(w))),
        float(jsgd.sse_rows(jnp.asarray(U), jnp.asarray(V), ju_, ji_,
                            jnp.asarray(vals), jnp.asarray(w))), rtol=1e-5)
    np.testing.assert_allclose(
        float(tsgd.empirical_risk_rows(_t(U), _t(V), tu_, ti_, _t(vals),
                                       _t(w), 0.1)),
        float(jsgd.empirical_risk_rows(jnp.asarray(U), jnp.asarray(V), ju_,
                                       ji_, jnp.asarray(vals),
                                       jnp.asarray(w), jnp.float32(0.1))),
        rtol=1e-5)


def test_traffic_models():
    assert tsgd.dsgd_bytes_per_sweep(1000, 128) == \
        jsgd.dsgd_bytes_per_sweep(1000, 128)
    assert tsgd.dsgd_flops_per_sweep(1000, 128) == \
        jsgd.dsgd_flops_per_sweep(1000, 128)
    # 6 table rows + 4 f32 scratch rows + 24 B of streams per rating
    assert tsgd.dsgd_bytes_per_sweep(10, 128, kernel="cuda") == \
        10 * (10 * 128 * 4 + 24)
    with pytest.raises(ValueError):
        tsgd.dsgd_bytes_per_sweep(10, 8, kernel="pallas")
