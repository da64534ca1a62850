"""The port's DSGD kernels' plain versions against the JAX package's TPU
kernels, run in interpret mode on the CPU as tests/test_pallas_sgd.py runs
them, and the port's plain ``ops.sgd`` route against the JAX one.

Tolerances: rtol 1e-5 / atol 1e-6 after one stratum (the f32 dot is reduced
in another order); rtol 2e-4 / atol 2e-5 after 3 sweeps (the bounds the JAX
package holds between its own two routes, tests/test_pallas_sgd.py). bf16
tables: every element within one bf16 ulp after one stratum (an f32
difference in the last place can flip one rounding).
On the CPU the step pair's wrappers run their plain versions (the step
plan plus kernel A's and kernel B's contracts); the kernels themselves are
checked by chip_smoke.py and the tests marked ``cuda``.
"""

import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
BF16 = jnp.bfloat16


def bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (f32 spacing × 2^16)."""
    return np.spacing(np.abs(np.asarray(x, np.float32))) * 2.0 ** 16


def assert_within_bf16_ulps(torch_pair, jax_pair, ulps=1):
    for a, b in zip(torch_pair, jax_pair):
        assert a.dtype == torch.bfloat16
        a = a.float().numpy()
        b = np.asarray(b, np.float32)
        bound = ulps * np.maximum(bf16_ulp(a), bf16_ulp(b))
        assert (np.abs(a - b) <= bound).all(), float(np.abs(a - b).max())


def _bf(a):
    """An f32 numpy table as a bf16 torch table (round to nearest even)."""
    return _t(a).to(torch.bfloat16)


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


@pytest.mark.parametrize("k,rank,divisor", [(2, 8, 1), (3, 8, 4),
                                            (2, 32, 3)])
def test_bf16_stratum_reference_matches_pallas_stratum_kernel(k, rank,
                                                               divisor):
    """The ``half=True`` branch of ``_stratum_kernel``: bf16 tables, one f32
    work pair per visit, one downcast at the visit's end."""
    a, U, V, mb, rpb_u, rpb_v = _blocked(k, rank, divisor, seed=k + 10)
    (jidx, jstr), (tidx, tstr) = _operands(a, k, rpb_u, rpb_v, mb)
    kw = dict(lr=0.1, lam=0.05, minibatch=mb, num_blocks=k)
    pallas = jax.jit(functools.partial(jp.pallas_stratum_sweep,
                                       interpret=True, **kw))
    jU, jV = jnp.asarray(U).astype(BF16), jnp.asarray(V).astype(BF16)
    for s in range(k):
        got = tc.stratum_sweep_reference(_bf(U), _bf(V), tidx, tstr, s, **kw)
        want = pallas(jU, jV, jidx, jstr, s)
        assert want[0].dtype == BF16
        assert_within_bf16_ulps(got, want)


@pytest.mark.parametrize("rank,pad_frac,mb", [(8, 0.0, 64), (8, 0.15, 32),
                                              (32, 0.1, 256)])
def test_bf16_block_reference_matches_pallas_block_kernel(rank, pad_frac,
                                                          mb):
    """The ``half=True`` branch of ``_sweep_kernel``."""
    ur, ir, vals, w, icu, icv, ou, ov, U, V = _visit(rank + 1, 256, 20, 12,
                                                     rank, pad_frac, mb)
    kw = dict(lr=0.1, lam=0.05, minibatch=mb)
    got = tc.block_sweep_reference(
        _bf(U), _bf(V), *(_t(x) for x in (ur, ir, vals, w, icu, icv, ou,
                                          ov)), **kw)
    want = jp.pallas_block_sweep(
        jnp.asarray(U).astype(BF16), jnp.asarray(V).astype(BF16),
        *(jnp.asarray(x) for x in (ur, ir, vals, w, icu, icv, ou, ov)),
        gather="loop", interpret=True, **kw)
    assert_within_bf16_ulps(got, want)


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


def _plan(a, mb):
    return tc.build_step_plan(*(_t(a[x]) for x in ("su", "si", "sv", "sw",
                                                   "icu", "icv")),
                              minibatch=mb)


def _step_pair(U, V, ou, ov, plan, s, **kw):
    """One stratum through the step pair's wrappers on CPU tensors (the
    plan plus the plain kernel-A and kernel-B versions)."""
    tc.stratum_sweep(U, V, ou, ov, plan, s, plan.new_work(U.shape[-1]), **kw)
    return U, V


def test_stratum_wrappers_on_cpu_use_plain_versions_and_count_nothing():
    """``stratum_sweep`` on CPU tensors (the step plan plus the plain
    versions of both step kernels) equals the plain stratum reference
    (global rows vs block-local operands) and launches no kernel; so do
    the per-step wrappers, step by step."""
    k, rank, divisor = 3, 8, 2
    a, U, V, mb, rpb_u, rpb_v = _blocked(k, rank, divisor, seed=5)
    _, (tidx, tstr) = _operands(a, k, rpb_u, rpb_v, mb)
    tc.reset_launch_counts()
    plan = _plan(a, mb)
    ou, ov = _t(a["ou"]), _t(a["ov"])
    work = plan.new_work(rank)
    for s in range(k):
        Ug, Vg = _step_pair(_t(U), _t(V), ou, ov, plan, s, lr=0.2, lam=0.1)
        Ur, Vr = tc.stratum_sweep_reference(_t(U), _t(V), tidx, tstr, s,
                                            lr=0.2, lam=0.1, minibatch=mb,
                                            num_blocks=k)
        np.testing.assert_allclose(Ug.numpy(), Ur.numpy(), **ONE)
        np.testing.assert_allclose(Vg.numpy(), Vr.numpy(), **ONE)
        Us, Vs = _t(U), _t(V)
        for t in range(s * plan.n_mb, (s + 1) * plan.n_mb):
            tc.sgd_item_rows(Us, Vs, ou, ov, plan, t, work, lr=0.2, lam=0.1)
            tc.sgd_user_rows(Us, Vs, ou, ov, plan, t, work, lr=0.2, lam=0.1)
        assert torch.equal(Us, Ug) and torch.equal(Vs, Vg)
    assert tc.LAUNCHES == {"sgd_item_rows_kernel": 0,
                           "sgd_user_rows_kernel": 0,
                           "bf16_to_f32_kernel": 0, "f32_to_bf16_kernel": 0}


def _layout(k, b, mb, rpb, sort, pad, seed=0):
    """A hand-made stratum-major layout: visit p of stratum s holds users
    of block p and items of block (p+s) mod k drawn from ``rpb`` rows each,
    the block's first row for 70% of the slots (so each minibatch has one
    segment longer than the 32-entry chunk per side and many short ones);
    ``pad`` turns a quarter of the slots into weight-0 padding on global
    row 0; ``sort`` orders each minibatch by user or item row (stable), as
    the blockings do. The ratings are distinct, naming each entry."""
    rng = np.random.default_rng(seed)
    p = np.arange(k)[None, :, None]
    q = (np.arange(k)[None, :] + np.arange(k)[:, None])[:, :, None] % k

    def rows(block):
        hot = rng.random((k, k, b)) < 0.7
        return (block * rpb + np.where(hot, 0, rng.integers(1, rpb, (k, k, b)))
                ).astype(np.int32)

    su, si = rows(p), rows(q)
    sw = np.ones((k, k, b), np.float32)
    if pad:
        gone = rng.random((k, k, b)) < 0.25
        sw[gone], su[gone], si[gone] = 0.0, 0, 0
    if sort is not None:
        key = (su if sort == "user" else si).reshape(-1, mb)
        order = np.argsort(key, axis=-1, kind="stable")
        su, si, sw = (np.take_along_axis(x.reshape(-1, mb), order, -1)
                      .reshape(k, k, b) for x in (su, si, sw))
    sv = rng.normal(0, 1, (k, k, b)).astype(np.float32)
    icu = rng.random((k, k, b)).astype(np.float32)
    icv = rng.random((k, k, b)).astype(np.float32)
    return dict(su=su, si=si, sv=sv, sw=sw, icu=icu, icv=icv)


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("sort", [None, "user", "item"])
@pytest.mark.parametrize("k", [2, 4])
def test_step_plan_invariants(k, sort, pad):
    """Every real entry sits in exactly one item and one user segment of
    its own step; segments are row-homogeneous, one per row and step, in
    entry order; padding is in none; the streams, the long marks and
    lists and the counts agree with the layout."""
    b, mb, rpb = 128, 64, 6
    _check_plan_invariants(_layout(k, b, mb, rpb, sort, pad, seed=k), mb,
                           sort)


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("sort", [None, "user", "item"])
@pytest.mark.parametrize("k", [2, 4])
def test_rank_step_plan_invariants(k, sort, pad):
    """The same invariants for one rank's plan on the mesh: its
    device-major strata ``[k, 1, b]`` (cell s is rating block (p,
    (p+s) mod k)), block-local rows, as ``dsgd_mesh.visit_plan`` builds
    it — every stratum s > 0 included."""
    b, mb, rpb = 128, 64, 6
    a = _layout(k, b, mb, rpb, sort, pad, seed=k + 20)
    p = k - 1
    rank = {x: np.ascontiguousarray(y[:, p:p + 1]) for x, y in a.items()}
    rank["su"] %= rpb
    rank["si"] %= rpb
    plan = _check_plan_invariants(rank, mb, sort)
    assert (plan.num_blocks, plan.visits) == (k, 1)


def _check_plan_invariants(a, mb, sort):
    """The invariants of ``build_step_plan`` over the layout ``a`` (``[S,
    P, b]``, each minibatch sorted by ``sort``); returns the plan."""
    S, P, b = a["su"].shape
    chunk = tc.SEGMENT_CHUNK
    plan = _plan(a, mb)
    n_mb = b // mb
    flat = {x: a[x].reshape(-1) for x in a}
    real = np.flatnonzero(flat["sw"] != 0)
    assert plan.steps == S * n_mb and plan.entry_base[-1] == real.size
    assert np.unique(flat["sv"]).size == flat["sv"].size
    v_ent = np.argsort(flat["sv"])[np.searchsorted(
        np.sort(flat["sv"]), plan.v_r.numpy())]  # entries by their rating
    assert len(plan.v_long) and len(plan.u_long)  # both sides have long ones
    u_epos = plan.u_epos.long().numpy()
    u_ent = v_ent[u_epos]
    for ent in (v_ent, u_ent):  # each real entry once, no padding
        np.testing.assert_array_equal(np.sort(ent), real)
    step_of = (v_ent // (P * b)) * n_mb + (v_ent % b) // mb
    np.testing.assert_array_equal(
        np.repeat(np.arange(plan.steps), np.diff(plan.entry_base)), step_of)
    np.testing.assert_array_equal(plan.v_su.numpy(), flat["su"][v_ent])
    for name, src in (("v_r", "sv"), ("v_w", "sw"), ("v_icv", "icv")):
        np.testing.assert_array_equal(getattr(plan, name).numpy(),
                                      flat[src][v_ent])
    for name, src in (("u_w", "sw"), ("u_icu", "icu")):
        np.testing.assert_array_equal(getattr(plan, name).numpy(),
                                      flat[src][u_ent])
    np.testing.assert_array_equal(plan.u_vrow.numpy(), flat["si"][u_ent])
    assert plan.rows_v == flat["si"][real].max() + 1
    assert plan.rows_u == flat["su"][real].max() + 1
    base = np.asarray(plan.entry_base)
    for side, ent, rows_of in (("v", v_ent, flat["si"]),
                               ("u", u_ent, flat["su"])):
        prow = getattr(plan, f"{side}_prow").numpy()
        rows = tc.plan_rows(getattr(plan, f"{side}_prow")).numpy()
        np.testing.assert_array_equal(rows, rows_of[ent])  # row-homogeneous
        longs = getattr(plan, f"{side}_long").numpy().reshape(-1, 2)
        long_base = getattr(plan, f"{side}_long_base")
        for t in range(plan.steps):
            r, en = rows[base[t]:base[t + 1]], ent[base[t]:base[t + 1]]
            cut = np.flatnonzero(np.diff(r)) + 1
            starts, ends = np.r_[0, cut], np.r_[cut, r.size]
            # one segment per row and step
            assert np.unique(r).size == starts.size
            assert getattr(plan, f"{side}_segments")[t] == starts.size
            assert getattr(plan, f"longest_{side}")[t] == max(
                (ends - starts).tolist(), default=0)
            for a0, a1 in zip(starts, ends):
                assert (np.diff(en[a0:a1]) > 0).all()  # entry order (stable)
                assert ((prow[base[t] + a0:base[t] + a1] < 0)
                        == (a1 - a0 > chunk)).all()
            np.testing.assert_array_equal(
                longs[long_base[t]:long_base[t + 1]],
                np.array([[base[t] + a0, base[t] + a1]
                          for a0, a1 in zip(starts, ends) if a1 - a0 > chunk],
                         dtype=np.int64).reshape(-1, 2))
    # u_epos stays inside the entry's own step
    step_u = np.repeat(np.arange(plan.steps), np.diff(base))
    assert ((u_epos >= base[step_u]) & (u_epos < base[step_u + 1])).all()
    # a step's item segments walk its visits in order, its user segments in
    # reverse (kernel B starts where kernel A ended)
    for t in range(plan.steps):
        sl = slice(plan.entry_base[t], plan.entry_base[t + 1])
        assert (np.diff((v_ent[sl] // b) % P) >= 0).all()
        assert (np.diff((u_ent[sl] // b) % P) <= 0).all()
    if sort == "item":  # each visit's item grouping is its stored order
        visit = v_ent // b
        for t in range(plan.steps):
            sl = slice(plan.entry_base[t], plan.entry_base[t + 1])
            for p in np.unique(visit[sl]):
                assert (np.diff(v_ent[sl][visit[sl] == p]) > 0).all()
    return plan


@pytest.mark.parametrize("k,rank,divisor", [(2, 8, 1), (3, 8, 4),
                                            (2, 32, 3)])
def test_step_pair_matches_pallas_stratum_kernel(k, rank, divisor):
    """The plan plus the plain kernel-A and kernel-B versions against
    ``pallas_stratum_sweep(interpret=True)``: one stratum from the same
    tables, and 3 sweeps chained."""
    a, U, V, mb, rpb_u, rpb_v = _blocked(k, rank, divisor, seed=k)
    (jidx, jstr), _ = _operands(a, k, rpb_u, rpb_v, mb)
    kw = dict(lr=0.1, lam=0.05)
    pallas = jax.jit(functools.partial(jp.pallas_stratum_sweep,
                                       interpret=True, minibatch=mb,
                                       num_blocks=k, **kw))
    plan = _plan(a, mb)
    ou, ov = _t(a["ou"]), _t(a["ov"])
    for s in range(k):
        _close(_step_pair(_t(U), _t(V), ou, ov, plan, s, **kw),
               pallas(jnp.asarray(U), jnp.asarray(V), jidx, jstr, s), ONE)
    tU, tV, jU, jV = _t(U), _t(V), jnp.asarray(U), jnp.asarray(V)
    for _ in range(3):
        for s in range(k):
            tU, tV = _step_pair(tU, tV, ou, ov, plan, s, **kw)
            jU, jV = pallas(jU, jV, jidx, jstr, s)
    _close((tU, tV), (jU, jV), SWEEPS)


@pytest.mark.parametrize("k,rank,divisor", [(2, 8, 1), (3, 8, 4),
                                            (2, 32, 3)])
def test_bf16_step_pair_matches_pallas_stratum_kernel(k, rank, divisor):
    """bf16 tables: upcast, the step pair's plain versions, one downcast
    per stratum, against the ``half=True`` branch of ``_stratum_kernel``
    within one bf16 ulp."""
    a, U, V, mb, rpb_u, rpb_v = _blocked(k, rank, divisor, seed=k + 10)
    (jidx, jstr), _ = _operands(a, k, rpb_u, rpb_v, mb)
    kw = dict(lr=0.1, lam=0.05)
    pallas = jax.jit(functools.partial(jp.pallas_stratum_sweep,
                                       interpret=True, minibatch=mb,
                                       num_blocks=k, **kw))
    plan = _plan(a, mb)
    jU, jV = jnp.asarray(U).astype(BF16), jnp.asarray(V).astype(BF16)
    for s in range(k):
        Ub, Vb = _bf(U), _bf(V)
        Uw, Vw = tc.bf16_to_f32(Ub, Vb, torch.empty(U.shape),
                                torch.empty(V.shape))
        _step_pair(Uw, Vw, _t(a["ou"]), _t(a["ov"]), plan, s, **kw)
        tc.f32_to_bf16(Uw, Vw, Ub, Vb)
        assert_within_bf16_ulps((Ub, Vb), pallas(jU, jV, jidx, jstr, s))


def _one_visit_plan(ur, ir, vals, w, icu, icv, mb):
    """A one-visit layout (k = 1, block-local rows are global) and its
    plan."""
    a = {x: y[None, None, :] for x, y in (("su", ur), ("si", ir),
                                          ("sv", vals), ("sw", w),
                                          ("icu", icu), ("icv", icv))}
    return _plan(a, mb)


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("rank,pad_frac,mb", [(8, 0.0, 64), (8, 0.15, 32),
                                              (32, 0.1, 256)])
def test_step_pair_matches_pallas_block_kernel(rank, pad_frac, mb, half):
    """One visit through the plan and the step pair's plain versions
    against ``pallas_block_sweep(interpret=True)`` (``_sweep_kernel``);
    bf16 within one bf16 ulp."""
    ur, ir, vals, w, icu, icv, ou, ov, U, V = _visit(rank + 2, 256, 20, 12,
                                                     rank, pad_frac, mb)
    plan = _one_visit_plan(ur, ir, vals, w, icu, icv, mb)
    kw = dict(lr=0.1, lam=0.05)
    Ut, Vt = (_bf(U), _bf(V)) if half else (_t(U), _t(V))
    Uw, Vw = Ut.float(), Vt.float()
    _step_pair(Uw, Vw, _t(ou), _t(ov), plan, 0, **kw)
    jU, jV = jnp.asarray(U), jnp.asarray(V)
    if half:
        jU, jV = jU.astype(BF16), jV.astype(BF16)
    want = jp.pallas_block_sweep(
        jU, jV, *(jnp.asarray(x) for x in (ur, ir, vals, w, icu, icv, ou,
                                           ov)),
        gather="loop", interpret=True, minibatch=mb, **kw)
    if half:
        assert_within_bf16_ulps((Uw.to(torch.bfloat16),
                                 Vw.to(torch.bfloat16)), want)
    else:
        _close((Uw, Vw), want, ONE)


@pytest.mark.parametrize("half", [False, True])
def test_block_sweep_matches_pallas_block_kernel(half):
    """``block_sweep`` (the mesh's per-visit wrapper) on CPU tensors: its
    plain path against ``pallas_block_sweep(interpret=True)``, in place,
    bf16 within one bf16 ulp, no launch counted; a plan of several visits
    per stratum is refused."""
    mb, rank = 32, 8
    ur, ir, vals, w, icu, icv, ou, ov, U, V = _visit(7, 256, 20, 12, rank,
                                                     0.1, mb)
    plan = _one_visit_plan(ur, ir, vals, w, icu, icv, mb)
    kw = dict(lr=0.1, lam=0.05)
    Ut, Vt = (_bf(U), _bf(V)) if half else (_t(U), _t(V))
    tc.reset_launch_counts()
    out = tc.block_sweep(Ut, Vt, _t(ou), _t(ov), plan, 0,
                         plan.new_work(rank), **kw)
    assert out[0] is Ut and out[1] is Vt
    assert not any(tc.LAUNCHES.values())
    jU, jV = jnp.asarray(U), jnp.asarray(V)
    if half:
        jU, jV = jU.astype(BF16), jV.astype(BF16)
    want = jp.pallas_block_sweep(
        jU, jV, *(jnp.asarray(x) for x in (ur, ir, vals, w, icu, icv, ou,
                                           ov)),
        gather="loop", interpret=True, minibatch=mb, **kw)
    if half:
        assert_within_bf16_ulps((Ut, Vt), want)
    else:
        _close((Ut, Vt), want, ONE)
    a, U2, V2, mb2, _, _ = _blocked(2, rank, 2, seed=3)
    with pytest.raises(ValueError, match="one visit per stratum"):
        full = _plan(a, mb2)
        tc.block_sweep(_t(U2), _t(V2), _t(a["ou"]), _t(a["ov"]), full, 0,
                       full.new_work(rank), **kw)


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("k,p", [(3, 1), (4, 3)])
def test_block_sweep_on_a_rank_plan_matches_pallas_block_kernel(k, p, half):
    """``block_sweep`` over one rank's plan of k visits (its device-major
    cells ``[k, 1, b]``, block-local rows, as ``dsgd_mesh.visit_plan``
    builds it): every stratum s, from the same tables, on U block p and V
    block (p+s) mod k, against ``pallas_block_sweep(interpret=True)`` on
    that cell; f32 at rtol 1e-5 / atol 1e-6, bf16 within one bf16 ulp."""
    rank = 8
    a, U, V, mb, rpb_u, rpb_v = _blocked(k, rank, 2, seed=k + p)
    cells = {x: np.ascontiguousarray(a[x][:, p:p + 1])
             for x in ("su", "si", "sv", "sw", "icu", "icv")}
    cells["su"] %= rpb_u
    cells["si"] %= rpb_v
    plan = _plan(cells, mb)
    kw = dict(lr=0.1, lam=0.05)
    for s in range(k):
        q = (p + s) % k
        Ub, Vb = U[p * rpb_u:(p + 1) * rpb_u], V[q * rpb_v:(q + 1) * rpb_v]
        ou = a["ou"][p * rpb_u:(p + 1) * rpb_u]
        ov = a["ov"][q * rpb_v:(q + 1) * rpb_v]
        Ut, Vt = (_bf(Ub), _bf(Vb)) if half else (_t(Ub), _t(Vb))
        tc.block_sweep(Ut, Vt, _t(ou), _t(ov), plan, s, plan.new_work(rank),
                       **kw)
        jU, jV = jnp.asarray(Ub), jnp.asarray(Vb)
        if half:
            jU, jV = jU.astype(BF16), jV.astype(BF16)
        want = jp.pallas_block_sweep(
            jU, jV, *(jnp.asarray(cells[x][s, 0]) for x in
                      ("su", "si", "sv", "sw", "icu", "icv")),
            jnp.asarray(ou), jnp.asarray(ov), gather="loop", interpret=True,
            minibatch=mb, **kw)
        if half:
            assert_within_bf16_ulps((Ut, Vt), want)
        else:
            _close((Ut, Vt), want, ONE)


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


@pytest.mark.parametrize("divisor", [1, 4])
def test_bf16_dsgd_train_cuda_matches_its_plain_twin_and_pallas(divisor):
    """``dsgd_train_cuda`` on bf16 CPU tensors runs the kernels' semantics
    through the wrappers' plain versions (upcast, f32 stratum, one downcast
    per stratum); it equals ``dsgd_train_reference`` bit for bit (the same
    arithmetic in the same order on the CPU), and tracks the JAX
    package's bf16 ``dsgd_train_pallas`` within 2 bf16 ulps after one
    sweep."""
    k, rank = 2, 8
    a, U, V, mb, _, _ = _blocked(k, rank, divisor, seed=divisor + 20)
    lr, lam = 0.05, 0.1
    common = _torch_common(a, U, V)
    common = (common[0].to(torch.bfloat16), common[1].to(torch.bfloat16),
              *common[2:])
    sched = tu.schedule_from_name("warm_boost", lam)
    kw = dict(lr=lr, lam=lam, minibatch=mb, num_blocks=k, schedule=sched)
    tc.reset_launch_counts()
    Uc, Vc = tc.dsgd_train_cuda(*common, iterations=3, **kw)
    assert sum(tc.LAUNCHES.values()) == 0
    assert Uc.dtype == torch.bfloat16 and common[0].dtype == torch.bfloat16
    Ur, Vr = tc.dsgd_train_reference(*common, iterations=3, **kw)
    assert torch.equal(Uc, Ur) and torch.equal(Vc, Vr)
    one = tc.dsgd_train_cuda(*common, iterations=1, **kw)
    jcommon = _jax_common(a, U, V)
    want = jp.dsgd_train_pallas(
        jcommon[0].astype(BF16), jcommon[1].astype(BF16), *jcommon[2:],
        lr=lr, lam=lam, minibatch=mb, num_blocks=k, iterations=1,
        interpret=True, schedule=ju.schedule_from_name("warm_boost", lam))
    assert_within_bf16_ulps(one, want, ulps=2)
    assert_within_bf16_ulps(tc.dsgd_train_reference(*common, iterations=1,
                                                    **kw), want, ulps=2)


def test_cast_wrappers_on_cpu_are_exact_and_count_nothing():
    rng = np.random.default_rng(0)
    U32 = torch.from_numpy(rng.normal(0, 1, (40, 8)).astype(np.float32))
    V32 = torch.from_numpy(rng.normal(0, 1, (24, 8)).astype(np.float32))
    Ub, Vb = torch.empty_like(U32, dtype=torch.bfloat16), \
        torch.empty_like(V32, dtype=torch.bfloat16)
    tc.reset_launch_counts()
    tc.f32_to_bf16(U32, V32, Ub, Vb)
    assert torch.equal(Ub, U32.to(torch.bfloat16))
    assert torch.equal(Vb, V32.to(torch.bfloat16))
    np.testing.assert_array_equal(  # the rounding of jnp.astype
        Ub.view(torch.int16).numpy(),
        np.asarray(jnp.asarray(U32.numpy()).astype(BF16)).view(np.int16))
    back_u, back_v = torch.empty_like(U32), torch.empty_like(V32)
    tc.bf16_to_f32(Ub, Vb, back_u, back_v)
    assert torch.equal(back_u, Ub.float()) and torch.equal(back_v, Vb.float())
    assert sum(tc.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="dtype"):
        tc.bf16_to_f32(U32, V32, back_u, back_v)
    with pytest.raises(ValueError, match="shapes"):
        tc.f32_to_bf16(U32, V32, Vb, Ub)


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
    for U_, V_ in ((common[0].half(), common[1].half()),
                   (common[0].to(torch.bfloat16), common[1])):
        with pytest.raises(ValueError, match="dtypes"):
            tc.dsgd_train_cuda(U_, V_, *common[2:], **kw)


class _HostReads(TorchDispatchMode):
    """Counts the operators that read a tensor's value back to the host
    (``int()``, ``.item()``) or reduce an index stream for it."""

    READS = ("aten._local_scalar_dense", "aten.min", "aten.max")

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += str(func.overloadpacket) in self.READS
        return func(*args, **(kwargs or {}))


def test_dsgd_train_cuda_given_a_plan_reads_nothing_back():
    """With a plan the training call checks the rows on the plan's host
    lists: no reduction of the index streams and no scalar read (on the
    card, no implicit transfer under the ``dsgd.fit`` guard); without one
    it reads only through the plan build's single batch."""
    a, U, V, mb, _, _ = _blocked(2, 8, 2)
    common = list(_torch_common(a, U, V))
    kw = dict(lr=0.1, lam=0.1, minibatch=mb, num_blocks=2, iterations=2)
    plan = tc.build_step_plan(*(common[i] for i in (2, 3, 4, 5, 8, 9)),
                              minibatch=mb)
    with _HostReads() as reads:
        got = tc.dsgd_train_cuda(*common, **kw, plan=plan)
    assert reads.count == 0
    with _HostReads() as reads:
        want = tc.dsgd_train_cuda(*common, **kw)
    assert reads.count == 4  # the plan build's two maxima and two minima
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("side,value", [(2, "rows"), (2, -1), (3, "rows"),
                                        (3, -3)])
def test_out_of_range_rows_raise_wherever_the_plan_is_built(with_plan, side,
                                                            value):
    """A real entry naming a row outside its table raises the layout
    check's ValueError whether ``dsgd_train_cuda`` builds the plan or is
    given one built by ``build_step_plan``."""
    a, U, V, mb, _, _ = _blocked(2, 8, 2)
    common = list(_torch_common(a, U, V))
    common[side] = common[side].clone()
    rows = (U if side == 2 else V).shape[0]
    assert common[5][0, 0, 0] != 0  # a real entry
    common[side][0, 0, 0] = rows if value == "rows" else value
    kw = dict(lr=0.1, lam=0.1, minibatch=mb, num_blocks=2, iterations=1)
    plan = (tc.build_step_plan(*(common[i] for i in (2, 3, 4, 5, 8, 9)),
                               minibatch=mb) if with_plan else None)
    name = "su" if side == 2 else "si"
    with pytest.raises(ValueError,
                       match=rf"{name} holds rows outside \[0, {rows}\)"):
        tc.dsgd_train_cuda(*common, **kw, plan=plan)


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
    # per rating: a gathered user row, a snapshot row, 48 B of plan and
    # error; per item row: 3 rows + ω; per user row: 2 rows + ω
    row = 128 * 4
    assert tsgd.dsgd_bytes_per_sweep(10, 128, kernel="cuda") == \
        10 * (2 * row + 48) + 10 * (3 * row + 4) + 10 * (2 * row + 4)
    assert tsgd.dsgd_bytes_per_sweep(10, 128, kernel="cuda", user_rows=4,
                                     item_rows=3) == \
        10 * (2 * row + 48) + 3 * (3 * row + 4) + 4 * (2 * row + 4)
    with pytest.raises(ValueError):
        tsgd.dsgd_bytes_per_sweep(10, 8, kernel="pallas")


# -- the variant probe -------------------------------------------------------

PROBE_SMALL = dict(rank=16, mb=256, rpb_u=300, rpb_v=120, nnz=1100)


@pytest.mark.parametrize("sort,sweeps", [(False, 1), (True, 1), (False, 2)])
def test_probe_variants_match_the_jax_variants(sort, sweeps):
    """The probe's two timed calls on the JAX probe's own visit (its
    ``_probe_inputs``, as numpy): ``"cuda"`` (the one-visit plan and the
    step pair's plain versions) against ``pallas_block_sweep(interpret=
    True)`` and ``"torch"`` against the XLA route's
    ``sgd_block_sweep``, each repeated ``sweeps`` times, at the
    per-stratum bar."""
    p = PROBE_SMALL
    e = p["nnz"] - p["nnz"] % p["mb"]
    inputs = [np.asarray(a) for a in jp._probe_inputs(
        jax.random.PRNGKey(3), p["rank"], p["mb"], p["rpb_u"], p["rpb_v"],
        e, sort)]
    rates = tc.ProbeRates()
    setups = tc._probe_setups([_t(a) for a in inputs], mb=p["mb"],
                              sweeps=sweeps, lr=0.1, lam=0.1, rates=rates)
    got = {v: setups[v]()() for v in tc.PROBE_VARIANTS}
    assert rates.plan_s > 0
    ur, ir, vals, w, icu, icv, ou, ov, U, V = (jnp.asarray(a)
                                               for a in inputs)
    upd = ju.RegularizedSGDUpdater(learning_rate=0.1, lambda_=0.1,
                                   schedule=ju.constant_lr)
    pallas, xla = (U, V), (U, V)
    for _ in range(sweeps):
        pallas = jp.pallas_block_sweep(
            *pallas, ur, ir, vals, w, icu, icv, ou, ov, lr=0.1, lam=0.1,
            minibatch=p["mb"], gather="take", interpret=True)
        xla = jsgd.sgd_block_sweep(*xla, ur, ir, vals, w, ou, ov, upd, 1,
                                   p["mb"], "mean", icu, icv)
    _close(got["cuda"], pallas, ONE)
    _close(got["torch"], xla, ONE)
    # the inputs' tables are untouched: each call sweeps copies
    np.testing.assert_array_equal(inputs[8], np.asarray(U))


@pytest.mark.parametrize("sort", [False, True])
def test_probe_inputs_follow_the_jax_recipe(sort):
    """The port's draw: rows in range and skewed to low ids, each
    minibatch sorted by user row when ``sort`` (its item rows carried
    along), unit weights, ω = max(count, 1), the per-minibatch 1/count
    scales, tables of 0.1·N(0, 1)."""
    p = PROBE_SMALL
    e = 4 * p["mb"]
    gen = torch.Generator().manual_seed(0)
    ur, ir, vals, w, icu, icv, ou, ov, U, V = (
        a.numpy() for a in tc._probe_inputs(gen, p["rank"], p["mb"],
                                            p["rpb_u"], p["rpb_v"], e, sort))
    assert ur.dtype == ir.dtype == np.int32 and vals.shape == (e,)
    assert 0 <= ur.min() and ur.max() < p["rpb_u"]
    assert 0 <= ir.min() and ir.max() < p["rpb_v"]
    assert (ur < p["rpb_u"] // 2).mean() > 0.6  # λ 2: low ids are hot
    assert (w == 1).all() and U.shape == (p["rpb_u"], p["rank"])
    assert V.shape == (p["rpb_v"], p["rank"]) and 0.08 < U.std() < 0.12
    sorted_mb = (np.diff(ur.reshape(-1, p["mb"]), axis=1) >= 0).all()
    assert sorted_mb == sort
    for rows, om, inv, n in ((ur, ou, icu, p["rpb_u"]),
                             (ir, ov, icv, p["rpb_v"])):
        np.testing.assert_array_equal(
            om, np.maximum(np.bincount(rows, minlength=n), 1))
        for mb_rows, mb_inv in zip(rows.reshape(-1, p["mb"]),
                                   inv.reshape(-1, p["mb"])):
            counts = np.bincount(mb_rows, minlength=n)
            np.testing.assert_array_equal(
                mb_inv, (1.0 / counts[mb_rows]).astype(np.float32))


def test_probe_variants_on_cpu_report_both_and_emit_the_jax_metrics():
    from large_scale_recommendation_tpu_torch import obs

    prev = (obs.get_registry(), obs.get_tracer())
    reg, tracer = obs.enable()
    try:
        out = tc.probe_variants(reps=2, sweeps=2, device="cpu",
                                **PROBE_SMALL)
    finally:
        obs.set_registry(prev[0])
        obs.set_tracer(prev[1])
    assert set(out) == set(tc.PROBE_VARIANTS) and out.plan_s > 0
    for variant, rate in out.items():
        assert isinstance(rate, float) and rate > 0
        assert reg.gauge("pallas_probe_ratings_per_s", variant=variant,
                         rank=16, sorted="false").value == rate
        assert reg.histogram("pallas_probe_sweep_s",
                             variant=variant).count == 2
    spans = [ev["name"] for ev in tracer.events() if ev.get("ph") == "X"]
    assert spans.count("pallas_probe/torch") == 3
    assert spans.count("pallas_probe/cuda") == 3
    assert not any(tc.LAUNCHES.values())


def test_probe_records_a_failing_variant(monkeypatch):
    """A variant that raises is reported as ``FAILED <type>: <msg>`` and
    counted; the others still run."""
    from large_scale_recommendation_tpu_torch import obs

    def refuse(*a, **k):
        raise RuntimeError("no plan today")

    monkeypatch.setattr(tc, "build_step_plan", refuse)
    prev = (obs.get_registry(), obs.get_tracer())
    reg, _ = obs.enable()
    try:
        out = tc.probe_variants(reps=1, device="cpu", **PROBE_SMALL)
    finally:
        obs.set_registry(prev[0])
        obs.set_tracer(prev[1])
    assert out["cuda"] == "FAILED RuntimeError: no plan today"
    assert out.plan_s is None and out["torch"] > 0
    assert reg.counter("pallas_probe_failures_total",
                       variant="cuda").value == 1


@pytest.mark.parametrize("name,counterpart", [
    ("xla", "'torch'"), ("pallas_take", "'cuda'"), ("pallas_loop", "'cuda'"),
    ("triton", "expected one of")])
def test_probe_refuses_other_variant_names(name, counterpart):
    with pytest.raises(ValueError, match=counterpart):
        tc.probe_variants(variants=("torch", name), device="cpu")


def test_probe_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.probe_variants()
