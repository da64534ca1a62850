"""The CUDA kernels on the card, against their plain versions. These tests
need a CUDA device and skip without one; on the machine with the card run

    python -m pytest --noconftest -q tests/test_torch_cuda_card.py

(``--noconftest``: the suite's conftest imports the JAX package, which that
machine does not have). Tolerance: the step kernels add each row's deltas in
a fixed order, so two kernel runs are bit-equal; against the plain version
(whose ``index_add_`` adds duplicates with atomics in a varying order on the
card, and whose dot reduces in another order) they agree to max-abs 1e-5 per
stratum; with bf16 tables, to one bf16 ulp per element (an f32 difference in
the last place can flip one rounding; magnitudes below 2^-16 count as
2^-16, where one bf16 ulp is the size of that f32 difference). The bf16
route (the pair reading and writing flagged rows of the bf16 tables) is
bit-equal to the cast route after every stratum, and the cast kernels are
exact against ``Tensor.to``. Beside them, what runs on the
card around the kernels: top-K and ranking quality against the same model
on the CPU, a resumed fit bit-equal to an uninterrupted one, a bf16
checkpoint written from the card, ALS, online MF and the serving engine
(exact, bf16, two-stage, deltas) against their CPU runs.
"""

import os

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu_torch.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu_torch.core.initializers import (
    keyed_uniform_rows,
)
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.data import blocking
from large_scale_recommendation_tpu_torch.data import device_blocking
from large_scale_recommendation_tpu_torch.models.dsgd import DSGD, DSGDConfig
from large_scale_recommendation_tpu_torch.ops import cuda_sgd

pytestmark = pytest.mark.cuda
TOL = 1e-5  # max-abs per stratum


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _problem(dev, k, rank, mb, n=20_000, seed=0, users=800, items=600,
             skew=2.0):
    gen = SyntheticMFGenerator(num_users=users, num_items=items, rank=8,
                               noise=0.1, seed=seed, skew_lam=skew)
    problem = blocking.block_problem(gen.generate(n), num_blocks=k, seed=0,
                                     minibatch_multiple=mb)
    icu, icv = blocking.minibatch_inv_counts(problem.ratings, mb)
    r = problem.ratings

    def put(a, dt):
        return torch.as_tensor(a, dtype=dt).to(dev)

    args = (put(r.u_rows, torch.int32), put(r.i_rows, torch.int32),
            put(r.values, torch.float32), put(r.weights, torch.float32),
            put(problem.users.omega, torch.float32),
            put(problem.items.omega, torch.float32),
            put(icu, torch.float32), put(icv, torch.float32))
    g = torch.Generator(device=dev).manual_seed(seed)
    U = 0.1 * torch.rand((problem.users.num_rows, rank), generator=g,
                         device=dev)
    V = 0.1 * torch.rand((problem.items.num_rows, rank), generator=g,
                         device=dev)
    return problem, args, U, V


def _plan(args, mb):
    su, si, sv, sw, _, _, icu, icv = args
    return cuda_sgd.build_step_plan(su, si, sv, sw, icu, icv, minibatch=mb)


def _operands(problem, args, k, mb):
    su, si, sv, sw, ou, ov, icu, icv = args
    return cuda_sgd.build_stratum_operands(
        su, si, sv, sw, icu, icv, ou, ov, num_blocks=k,
        rpb_u=problem.users.rows_per_block,
        rpb_v=problem.items.rows_per_block, minibatch=mb)


def _pair_counts(n, casts=0):
    return {"sgd_item_rows_kernel": n, "sgd_user_rows_kernel": n,
            "bf16_to_f32_kernel": casts, "f32_to_bf16_kernel": casts}


@pytest.mark.parametrize("k,rank,mb", [(4, 128, 512), (2, 32, 256),
                                       (3, 8, 1024), (2, 200, 128)])
def test_stratum_kernels_match_plain(dev, k, rank, mb):
    problem, args, U, V = _problem(dev, k, rank, mb)
    ou, ov = args[4], args[5]
    idx, streams = _operands(problem, args, k, mb)
    plan = _plan(args, mb)
    work = plan.new_work(rank)
    cuda_sgd.reset_launch_counts()
    for s in range(k):
        Uk, Vk = U.clone(), V.clone()
        cuda_sgd.stratum_sweep(Uk, Vk, ou, ov, plan, s, work, lr=0.5,
                               lam=0.1)
        Ur, Vr = cuda_sgd.stratum_sweep_reference(
            U, V, idx, streams, s, lr=0.5, lam=0.1, minibatch=mb,
            num_blocks=k)
        torch.cuda.synchronize()
        assert float((Uk - Ur).abs().max()) <= TOL
        assert float((Vk - Vr).abs().max()) <= TOL
    assert cuda_sgd.LAUNCHES == _pair_counts(k * plan.n_mb)


def test_delta_kernel_matches_plain_exactly_shaped(dev):
    """Kernel A and kernel B, step by step, against their plain versions
    from the same tables: kernel A's e, snapshot and V, kernel B's U (every
    slot the step uses is written: the buffers start as NaN)."""
    k, rank, mb = 4, 128, 512
    problem, args, U, V = _problem(dev, k, rank, mb, seed=1)
    ou, ov = args[4], args[5]
    plan = _plan(args, mb)
    wk, wp = plan.new_work(rank), plan.new_work(rank)
    for t in range(plan.n_mb, 2 * plan.n_mb):  # stratum 1
        for buf in wk:
            buf.fill_(float("nan"))
        n_e = plan.entry_base[t + 1] - plan.entry_base[t]
        rows = cuda_sgd.plan_rows(plan.v_prow[plan.entry_base[t]:
                                              plan.entry_base[t + 1]])
        Uk, Vk, Up, Vp = U.clone(), V.clone(), U.clone(), V.clone()
        cuda_sgd.sgd_item_rows(Uk, Vk, ou, ov, plan, t, wk, lr=0.3, lam=0.1)
        cuda_sgd.sgd_item_rows_reference(Up, Vp, ov, plan, t, wp, lr=0.3,
                                         lam=0.1)
        torch.cuda.synchronize()
        for a, b in ((wk[0][:n_e], wp[0][:n_e]), (wk[1][rows], wp[1][rows]),
                     (Vk, Vp)):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
        assert torch.equal(Uk, U)  # kernel A writes no U
        cuda_sgd.sgd_user_rows(Uk, Vk, ou, ov, plan, t, wp, lr=0.3, lam=0.1)
        cuda_sgd.sgd_user_rows_reference(Up, ou, plan, t, wp, lr=0.3,
                                         lam=0.1)
        torch.cuda.synchronize()
        torch.testing.assert_close(Uk, Up, rtol=1e-5, atol=1e-7)


def test_wrappers_reject_bad_operands(dev):
    k, rank, mb = 2, 32, 256
    problem, args, U, V = _problem(dev, k, rank, mb, n=4000)
    ou, ov = args[4], args[5]
    plan = _plan(args, mb)
    work = plan.new_work(rank)
    kw = dict(lr=0.1, lam=0.1)
    with pytest.raises(ValueError, match="dtype"):
        cuda_sgd.sgd_item_rows(U.double(), V, ou, ov, plan, 0, work, **kw)
    with pytest.raises(ValueError, match="shape"):
        cuda_sgd.sgd_user_rows(U, V, ou[:-1], ov, plan, 0, work, **kw)
    with pytest.raises(ValueError, match="one CUDA device or all on"):
        cuda_sgd.sgd_user_rows(U.cpu(), V, ou, ov, plan, 0, work, **kw)
    with pytest.raises(ValueError, match="work buffers"):
        cuda_sgd.sgd_item_rows(U, V, ou, ov, plan, 0,
                               (work[0], work[1][:, :-1].contiguous()), **kw)
    with pytest.raises(ValueError, match="outside"):
        cuda_sgd.stratum_sweep(U[:plan.rows_u - 1], V, ou[:plan.rows_u - 1],
                               ov, plan, 0, work, **kw)
    with pytest.raises(ValueError, match="rank"):
        wide = torch.zeros((U.shape[0], 512), device=dev)
        cuda_sgd.sgd_item_rows(wide, torch.zeros((V.shape[0], 512),
                                                 device=dev),
                               ou, ov, plan, 0, plan.new_work(512), **kw)


@pytest.mark.parametrize("k,rank,mb", [(4, 128, 512), (2, 200, 128)])
def test_step_kernels_are_deterministic(dev, k, rank, mb):
    """One stratum through the kernels, twice from the same tables: the
    tables come out bit-equal (no atomics; each row adds its deltas in a
    fixed order)."""
    problem, args, U, V = _problem(dev, k, rank, mb, seed=4)
    plan = _plan(args, mb)
    runs = []
    for _ in range(2):
        Uk, Vk = U.clone(), V.clone()
        cuda_sgd.stratum_sweep(Uk, Vk, args[4], args[5], plan, 1,
                               plan.new_work(rank), lr=0.5, lam=0.1)
        runs.append((Uk, Vk))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][0], U)


def test_long_segments_split_across_a_block(dev):
    """Few, skewed ids: the longest user and item segments exceed the
    chunk many times over (~500 and ~760 entries against 32), so they run
    on blocks of their own, several chunks per warp, partials added in warp
    order. Kernel vs plain within the stratum tolerance, and two kernel
    runs bit-equal."""
    k, rank, mb = 2, 128, 2048
    problem, args, U, V = _problem(dev, k, rank, mb, n=20_000, seed=6,
                                   users=24, items=16, skew=3.0)
    plan = _plan(args, mb)
    assert max(plan.longest_u) > 8 * plan.chunk
    assert max(plan.longest_v) > 8 * plan.chunk
    idx, streams = _operands(problem, args, k, mb)
    for s in range(k):
        outs = []
        for _ in range(2):
            Uk, Vk = U.clone(), V.clone()
            cuda_sgd.stratum_sweep(Uk, Vk, args[4], args[5], plan, s,
                                   plan.new_work(rank), lr=0.05, lam=0.1)
            outs.append((Uk, Vk))
        Ur, Vr = cuda_sgd.stratum_sweep_reference(
            U, V, idx, streams, s, lr=0.05, lam=0.1, minibatch=mb,
            num_blocks=k)
        torch.cuda.synchronize()
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])
        assert float((outs[0][0] - Ur).abs().max()) <= TOL
        assert float((outs[0][1] - Vr).abs().max()) <= TOL


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary (the kernels' 4-byte column route at any rank)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


# ranks of the 16-byte route (4 columns a lane: 1 or 2 chunks) and of the
# 4-byte route (rank % 4 != 0: 1 to 8 columns a lane)
COLUMN_ROUTES = [8, 32, 128, 200, 256, 7, 45, 90, 127, 150, 190, 223, 255]


@pytest.mark.parametrize("rank", COLUMN_ROUTES)
def test_step_pair_every_column_route(dev, rank):
    """One stratum through the step pair at each column route, on a
    problem with weight-0 padding and duplicate rows in every minibatch:
    within 1e-5 of ``stratum_sweep_reference`` and two runs bit-equal."""
    k, mb = 2, 256
    problem, args, U, V = _problem(dev, k, rank, mb, n=6000, seed=rank)
    sw = args[3]
    assert (sw == 0).any()  # padding
    su = args[0].reshape(-1, mb)
    assert any(torch.unique(row).numel() < mb for row in su)  # duplicates
    plan = _plan(args, mb)
    idx, streams = _operands(problem, args, k, mb)
    for s in range(k):
        runs = []
        for _ in range(2):
            Uk, Vk = U.clone(), V.clone()
            cuda_sgd.stratum_sweep(Uk, Vk, args[4], args[5], plan, s,
                                   plan.new_work(rank), lr=0.5, lam=0.1)
            runs.append((Uk, Vk))
        Ur, Vr = cuda_sgd.stratum_sweep_reference(
            U, V, idx, streams, s, lr=0.5, lam=0.1, minibatch=mb,
            num_blocks=k)
        torch.cuda.synchronize()
        assert torch.equal(runs[0][0], runs[1][0])
        assert torch.equal(runs[0][1], runs[1][1])
        assert float((runs[0][0] - Ur).abs().max()) <= TOL
        assert float((runs[0][1] - Vr).abs().max()) <= TOL


@pytest.mark.parametrize("rank", [128, 256])
def test_step_pair_on_tables_off_16_byte_boundaries(dev, rank):
    """Tables (and the snapshot) that do not start on a 16-byte boundary
    take the 4-byte route at a rank the 16-byte route would take: the same
    tables as aligned ones within 1e-5, kernel A's e and snapshot too."""
    k, mb = 2, 256
    problem, args, U, V = _problem(dev, k, rank, mb, n=6000, seed=3)
    plan = _plan(args, mb)
    e, snap = plan.new_work(rank)
    outs = []
    for shift in (False, True):
        Uk, Vk = U.clone(), V.clone()
        work = (e.clone(), snap.clone())
        if shift:
            Uk, Vk, work = _misaligned(Uk), _misaligned(Vk), (
                work[0], _misaligned(work[1]))
        cuda_sgd.stratum_sweep(Uk, Vk, args[4], args[5], plan, 1, work,
                               lr=0.5, lam=0.1)
        outs.append((Uk, Vk))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) <= TOL


@pytest.mark.parametrize("rank", [45, 256])
def test_long_segments_on_every_route(dev, rank):
    """The block-owned long segments (~500 and ~760 entries against the
    32-entry chunk) on the 4-byte route and on the 16-byte route at two
    chunks a lane (the largest shared-memory ring): within 1e-5 of the
    plain version, two runs bit-equal."""
    k, mb = 2, 2048
    problem, args, U, V = _problem(dev, k, rank, mb, n=20_000, seed=6,
                                   users=24, items=16, skew=3.0)
    plan = _plan(args, mb)
    assert max(plan.longest_u) > 8 * plan.chunk
    assert max(plan.longest_v) > 8 * plan.chunk
    idx, streams = _operands(problem, args, k, mb)
    outs = []
    for _ in range(2):
        Uk, Vk = U.clone(), V.clone()
        cuda_sgd.stratum_sweep(Uk, Vk, args[4], args[5], plan, 0,
                               plan.new_work(rank), lr=0.05, lam=0.1)
        outs.append((Uk, Vk))
    Ur, Vr = cuda_sgd.stratum_sweep_reference(
        U, V, idx, streams, 0, lr=0.05, lam=0.1, minibatch=mb, num_blocks=k)
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert float((outs[0][0] - Ur).abs().max()) <= TOL
    assert float((outs[0][1] - Vr).abs().max()) <= TOL


def test_step_with_no_real_entries(dev):
    """A one-visit plan whose second minibatch is all padding: that step
    launches both kernels on no entries (one block that returns) and
    leaves the tables as the first step left them; the visit through
    ``block_sweep`` equals ``block_sweep_reference``."""
    rank, mb, rpb_u, rpb_v = 128, 512, 300, 200
    rng = np.random.default_rng(5)

    def put(a, dt):
        return torch.as_tensor(a, dtype=dt, device=dev)

    ur = rng.integers(0, rpb_u, 2 * mb)
    ir = rng.integers(0, rpb_v, 2 * mb)
    w = np.ones(2 * mb, np.float32)
    w[mb:] = 0.0
    ur[mb:], ir[mb:] = 0, 0
    vals = rng.normal(size=2 * mb)
    icu = np.ones(2 * mb, np.float32)
    icv = np.ones(2 * mb, np.float32)
    cols = (put(ur, torch.int32), put(ir, torch.int32),
            put(vals, torch.float32), put(w, torch.float32),
            put(icu, torch.float32), put(icv, torch.float32))
    plan = cuda_sgd.build_step_plan(*(c.view(1, 1, -1) for c in cols),
                                    minibatch=mb)
    assert plan.entry_base == [0, mb, mb]
    ou = torch.ones(rpb_u, device=dev)
    ov = torch.ones(rpb_v, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    U = 0.1 * torch.rand((rpb_u, rank), generator=g, device=dev)
    V = 0.1 * torch.rand((rpb_v, rank), generator=g, device=dev)
    work = plan.new_work(rank)
    Uk, Vk = U.clone(), V.clone()
    cuda_sgd.reset_launch_counts()
    cuda_sgd.sgd_item_rows(Uk, Vk, ou, ov, plan, 0, work, lr=0.3, lam=0.1)
    cuda_sgd.sgd_user_rows(Uk, Vk, ou, ov, plan, 0, work, lr=0.3, lam=0.1)
    U1, V1 = Uk.clone(), Vk.clone()
    cuda_sgd.sgd_item_rows(Uk, Vk, ou, ov, plan, 1, work, lr=0.3, lam=0.1)
    cuda_sgd.sgd_user_rows(Uk, Vk, ou, ov, plan, 1, work, lr=0.3, lam=0.1)
    torch.cuda.synchronize()
    assert cuda_sgd.LAUNCHES == _pair_counts(2)
    assert torch.equal(Uk, U1) and torch.equal(Vk, V1)
    Ub, Vb = U.clone(), V.clone()
    cuda_sgd.block_sweep(Ub, Vb, ou, ov, plan, 0, work, lr=0.3, lam=0.1)
    Ur, Vr = cuda_sgd.block_sweep_reference(U, V, *cols, ou, ov, lr=0.3,
                                            lam=0.1, minibatch=mb)
    torch.cuda.synchronize()
    assert torch.equal(Ub, Uk) and torch.equal(Vb, Vk)
    assert float((Ub - Ur).abs().max()) <= TOL
    assert float((Vb - Vr).abs().max()) <= TOL


def test_step_kernel_attrs_report_the_launch_shape(dev):
    """Registers, shared memory and resident blocks of both step kernels
    on both column routes, as the occupancy calculator reports them: at
    least one resident block, the ring's bytes as launched."""
    for rank, vec in ((128, True), (256, True), (45, False), (255, False)):
        attrs = cuda_sgd.step_kernel_attrs(rank, vec)
        for side in ("a", "b"):
            assert 0 < attrs[f"{side}_registers"] <= 255
            assert attrs[f"{side}_smem_bytes"] > 0
            assert attrs[f"{side}_blocks_per_sm"] >= 1


def test_fit_on_card_matches_cpu_fit(dev):
    gen = SyntheticMFGenerator(num_users=500, num_items=400, rank=4,
                               noise=0.1, seed=2, skew_lam=2.0)
    train, test = gen.generate(30_000), gen.generate(2000)
    cfg = DSGDConfig(num_factors=32, lambda_=0.05, iterations=3,
                     learning_rate=0.1, lr_schedule="warm_boost",
                     minibatch_size=512, init_scale=0.1)
    cuda_sgd.reset_launch_counts()
    on_card = DSGD(cfg).fit(train, num_blocks=4)
    on_cpu = DSGD(cfg, device="cpu").fit(train, num_blocks=4)
    assert on_card.U.device.type == "cuda"
    assert cuda_sgd.LAUNCHES["sgd_item_rows_kernel"] > 0
    np.testing.assert_allclose(on_card.U.cpu().numpy(), on_cpu.U.numpy(),
                               rtol=2e-4, atol=2e-5)
    assert abs(on_card.rmse(test) - on_cpu.rmse(test)) < 1e-4
    with pytest.raises(ValueError, match="collision"):
        DSGD(DSGDConfig(collision_mode="sum")).fit(train, num_blocks=2)


def _bf16_ulps(a, b):
    """max over elements of |a − b| in units of one bf16 ulp there, the
    magnitude counted at no less than 2^-16: below it a bf16 ulp is smaller
    than the f32 atomics-order difference (~1e-7) it rounds from."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -16)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((a - b).abs() / ulp).max())


@pytest.mark.parametrize("k,rank,mb", [(4, 128, 512), (3, 8, 1024)])
def test_bf16_stratum_through_the_kernels_matches_plain_twin(dev, k, rank,
                                                             mb):
    """Upcast kernel, the f32 steps, downcast kernel: each stratum from the
    same bf16 tables, against ``stratum_sweep_reference`` on them."""
    problem, args, U, V = _problem(dev, k, rank, mb, seed=3)
    ou, ov = args[4], args[5]
    idx, streams = _operands(problem, args, k, mb)
    plan = _plan(args, mb)
    work = plan.new_work(rank)
    Ub, Vb = U.to(torch.bfloat16), V.to(torch.bfloat16)
    Uw, Vw = torch.empty_like(U), torch.empty_like(V)
    cuda_sgd.reset_launch_counts()
    for s in range(k):
        Uk, Vk = Ub.clone(), Vb.clone()
        cuda_sgd.bf16_to_f32(Uk, Vk, Uw, Vw)
        cuda_sgd.stratum_sweep(Uw, Vw, ou, ov, plan, s, work, lr=0.5,
                               lam=0.1)
        cuda_sgd.f32_to_bf16(Uw, Vw, Uk, Vk)
        Ur, Vr = cuda_sgd.stratum_sweep_reference(
            Ub, Vb, idx, streams, s, lr=0.5, lam=0.1, minibatch=mb,
            num_blocks=k)
        torch.cuda.synchronize()
        assert Ur.dtype == torch.bfloat16
        assert _bf16_ulps(Uk, Ur) <= 1.0 and _bf16_ulps(Vk, Vr) <= 1.0
    assert cuda_sgd.LAUNCHES == _pair_counts(k * plan.n_mb, casts=k)
    # the whole loop: the rounding points of the plain twin, 3 sweeps
    kw = dict(lr=0.3, lam=0.1, minibatch=mb, num_blocks=k, iterations=3)
    Uk, Vk = cuda_sgd.dsgd_train_cuda(Ub, Vb, *args, **kw)
    Ur, Vr = cuda_sgd.dsgd_train_reference(Ub, Vb, *args, **kw)
    torch.cuda.synchronize()
    assert Uk.dtype == torch.bfloat16 and Ub.dtype == torch.bfloat16
    assert float((Uk.float() - Ur.float()).abs().max()) < 1e-2


@pytest.mark.parametrize("n_u,n_v", [(4096 * 128, 1000 * 128), (37, 1001)])
def test_cast_kernels_are_exact(dev, n_u, n_v):
    g = torch.Generator(device=dev).manual_seed(0)
    U = torch.randn(n_u, generator=g, device=dev) * 3
    V = torch.randn(n_v, generator=g, device=dev) * 1e-3
    Ub, Vb = (torch.empty_like(t, dtype=torch.bfloat16) for t in (U, V))
    cuda_sgd.reset_launch_counts()
    cuda_sgd.f32_to_bf16(U, V, Ub, Vb)
    Uf, Vf = torch.empty_like(U), torch.empty_like(V)
    cuda_sgd.bf16_to_f32(Ub, Vb, Uf, Vf)
    torch.cuda.synchronize()
    assert torch.equal(Ub.view(torch.int16),
                       U.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(Vb.view(torch.int16),
                       V.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(Uf, Ub.float()) and torch.equal(Vf, Vb.float())
    assert cuda_sgd.LAUNCHES["f32_to_bf16_kernel"] == 1
    assert cuda_sgd.LAUNCHES["bf16_to_f32_kernel"] == 1


def _nan_work(U, V):
    return (torch.full(U.shape, float("nan"), device=U.device),
            torch.full(V.shape, float("nan"), device=V.device))


def _same_bits(a, b):
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


def _bf16_strata(dev, problem, args, U, V, mb, sweeps=2):
    """``sweeps`` sweeps of strata on bf16 tables through the flagged
    route (NaN work tables, so a read of an unreached row shows) and
    through the cast route (``stratum_sweep_cast``), chained: the bf16
    tables bit-equal after every stratum, the flagged route launching
    only the step pair, n_mb times each a stratum, and each stratum within
    one bf16 ulp of ``stratum_sweep_reference`` on the same tables."""
    k = problem.ratings.num_blocks
    ou, ov = args[4], args[5]
    idx, streams = _operands(problem, args, k, mb)
    plan = _plan(args, mb)
    rank = U.shape[-1]
    work, work_c = plan.new_work(rank), plan.new_work(rank)
    Ub, Vb = U.to(torch.bfloat16), V.to(torch.bfloat16)
    Uc, Vc = Ub.clone(), Vb.clone()
    Uw_c, Vw_c = torch.empty_like(U), torch.empty_like(V)
    for _ in range(sweeps):
        for s in range(k):
            Ur, Vr = cuda_sgd.stratum_sweep_reference(
                Ub, Vb, idx, streams, s, lr=0.5, lam=0.1, minibatch=mb,
                num_blocks=k)
            cuda_sgd.reset_launch_counts()
            cuda_sgd.stratum_sweep(*_nan_work(U, V), ou, ov, plan, s, work,
                                   lr=0.5, lam=0.1, store=(Ub, Vb))
            torch.cuda.synchronize()
            assert cuda_sgd.LAUNCHES == _pair_counts(plan.n_mb)
            cuda_sgd.stratum_sweep_cast(Uc, Vc, Uw_c, Vw_c, ou, ov, plan, s,
                                        work_c, lr=0.5, lam=0.1)
            torch.cuda.synchronize()
            assert _same_bits(Ub, Uc) and _same_bits(Vb, Vc)
            assert _bf16_ulps(Ub, Ur) <= 1.0 and _bf16_ulps(Vb, Vr) <= 1.0
    assert not torch.equal(Ub, U.to(torch.bfloat16))
    return plan


@pytest.mark.parametrize("rank", [7, 8, 45, 128, 256])
def test_bf16_route_bit_equal_to_the_cast_route(dev, rank):
    """The flagged bf16 route on both column routes (rank % 4 == 0: 4
    columns a lane, 8-byte ``cp.async`` of bf16 rows; else one column a
    lane, plain loads), on a problem with padding and duplicate rows:
    bit-equal to the cast route after every stratum of two sweeps."""
    k, mb = 2, 256
    problem, args, U, V = _problem(dev, k, rank, mb, n=6000, seed=rank + 1)
    _bf16_strata(dev, problem, args, U, V, mb)


@pytest.mark.parametrize("rank", [45, 256])
def test_bf16_route_long_segments(dev, rank):
    """The block-owned long segments (~500 and ~760 entries against the
    32-entry chunk) on the bf16 route: the segment's old row from the bf16
    table at its first step and back at its last, bit-equal to the cast
    route."""
    k, mb = 2, 2048
    problem, args, U, V = _problem(dev, k, rank, mb, n=20_000, seed=6,
                                   users=24, items=16, skew=3.0)
    plan = _bf16_strata(dev, problem, args, U, V, mb, sweeps=1)
    assert max(plan.longest_u) > 8 * plan.chunk
    assert max(plan.longest_v) > 8 * plan.chunk


def _offset(t, elements):
    """A contiguous copy of ``t`` whose data starts ``elements`` past an
    aligned allocation."""
    flat = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    out = flat[elements:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("rank", [128, 256])
def test_bf16_route_on_tables_off_8_byte_boundaries(dev, rank):
    """bf16 tables 2 bytes past an 8-byte boundary take the one-column
    route at a rank the 4-column route would take; against the cast route
    done with ``Tensor.copy_`` around the f32 pair on work tables 4 bytes
    past a 16-byte boundary (the same column route): bit-equal."""
    k, mb = 2, 256
    problem, args, U, V = _problem(dev, k, rank, mb, n=6000, seed=3)
    ou, ov = args[4], args[5]
    plan = _plan(args, mb)
    Ub, Vb = (_offset(t.to(torch.bfloat16), 1) for t in (U, V))
    assert Ub.data_ptr() % 8 == 2 and Vb.data_ptr() % 8 == 2
    Uc, Vc = Ub.clone(), Vb.clone()
    Uw, Vw = (_offset(t, 1) for t in (U, V))
    for s in range(k):
        cuda_sgd.stratum_sweep(*_nan_work(U, V), ou, ov, plan, s,
                               plan.new_work(rank), lr=0.5, lam=0.1,
                               store=(Ub, Vb))
        Uw.copy_(Uc)
        Vw.copy_(Vc)
        cuda_sgd.stratum_sweep(Uw, Vw, ou, ov, plan, s, plan.new_work(rank),
                               lr=0.5, lam=0.1)
        Uc.copy_(Uw)
        Vc.copy_(Vw)
        torch.cuda.synchronize()
        assert _same_bits(Ub, Uc) and _same_bits(Vb, Vc)


def test_bf16_route_step_with_no_real_entries(dev):
    """A one-visit plan whose second minibatch is all padding, through
    ``block_sweep`` on bf16 tables: both steps launch the pair (the empty
    one on no entries), no cast, and the tables are bit-equal to the cast
    route's."""
    rank, mb, rpb_u, rpb_v = 128, 512, 300, 200
    rng = np.random.default_rng(7)
    ur = rng.integers(0, rpb_u, 2 * mb)
    ir = rng.integers(0, rpb_v, 2 * mb)
    w = np.ones(2 * mb, np.float32)
    w[mb:], ur[mb:], ir[mb:] = 0.0, 0, 0
    cols = [torch.as_tensor(a, dtype=dt, device=dev) for a, dt in (
        (ur, torch.int32), (ir, torch.int32), (rng.normal(size=2 * mb),
                                               torch.float32),
        (w, torch.float32), (np.ones(2 * mb), torch.float32),
        (np.ones(2 * mb), torch.float32))]
    plan = cuda_sgd.build_step_plan(*(c.view(1, 1, -1) for c in cols),
                                    minibatch=mb)
    assert plan.entry_base == [0, mb, mb]
    ou = torch.ones(rpb_u, device=dev)
    ov = torch.ones(rpb_v, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    Ub = (0.1 * torch.rand((rpb_u, rank), generator=g, device=dev)).to(
        torch.bfloat16)
    Vb = (0.1 * torch.rand((rpb_v, rank), generator=g, device=dev)).to(
        torch.bfloat16)
    Uc, Vc, U0 = Ub.clone(), Vb.clone(), Ub.clone()
    cuda_sgd.reset_launch_counts()
    cuda_sgd.block_sweep(Ub, Vb, ou, ov, plan, 0, plan.new_work(rank),
                         lr=0.3, lam=0.1)
    torch.cuda.synchronize()
    assert cuda_sgd.LAUNCHES == _pair_counts(2)
    cuda_sgd.stratum_sweep_cast(Uc, Vc, torch.empty(Uc.shape, device=dev),
                                torch.empty(Vc.shape, device=dev), ou, ov,
                                plan, 0, plan.new_work(rank), lr=0.3,
                                lam=0.1)
    torch.cuda.synchronize()
    assert _same_bits(Ub, Uc) and _same_bits(Vb, Vc)
    assert not torch.equal(Ub, U0)


def test_bf16_route_refuses_mismatched_storage(dev):
    """The flagged route takes bf16 storage of the work tables' shapes
    only."""
    k, rank, mb = 2, 32, 256
    problem, args, U, V = _problem(dev, k, rank, mb, n=4000)
    plan = _plan(args, mb)
    work = plan.new_work(rank)
    Ub, Vb = U.to(torch.bfloat16), V.to(torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        cuda_sgd.sgd_item_rows(U, V, args[4], args[5], plan, 0, work,
                               lr=0.1, lam=0.1, store=(U, Vb))
    with pytest.raises(ValueError, match="shape"):
        cuda_sgd.stratum_sweep(U, V, args[4], args[5], plan, 0, work,
                               lr=0.1, lam=0.1, store=(Ub[:-1], Vb))


def test_bf16_table_never_reaches_an_f32_kernel(dev):
    k, rank, mb = 2, 32, 256
    problem, args, U, V = _problem(dev, k, rank, mb, n=4000)
    ou, ov = args[4], args[5]
    plan = _plan(args, mb)
    work = plan.new_work(rank)
    Ub, Vb = U.to(torch.bfloat16), V.to(torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        cuda_sgd.sgd_item_rows(Ub, Vb, ou, ov, plan, 0, work, lr=0.1,
                               lam=0.1)
    with pytest.raises(ValueError, match="dtype"):
        cuda_sgd.sgd_user_rows(Ub, Vb, ou, ov, plan, 0, work, lr=0.1,
                               lam=0.1)
    with pytest.raises(ValueError, match="dtype"):
        cuda_sgd.stratum_sweep(Ub, Vb, ou, ov, plan, 0, work, lr=0.1,
                               lam=0.1)
    with pytest.raises(ValueError, match="dtype"):
        cuda_sgd.bf16_to_f32(U, V, U.clone(), V.clone())


def test_keyed_init_is_the_same_on_the_card_and_the_host(dev):
    ids = torch.cat([torch.arange(5000), torch.tensor([2**40 + 7, 0])])
    host = keyed_uniform_rows(ids, 128, 0.08)
    card = keyed_uniform_rows(ids.to(dev), 128, 0.08)
    assert torch.equal(card.cpu(), host)


def test_fit_device_on_card_matches_its_cpu_run(dev):
    rng = np.random.default_rng(5)
    nu, ni, n = 500, 400, 30_000
    Ut = rng.normal(0, 0.5, (nu, 4)).astype(np.float32)
    Vt = rng.normal(0, 0.5, (ni, 4)).astype(np.float32)
    u = np.minimum(rng.exponential(nu / 4, n), nu - 1).astype(np.int64)
    i = np.minimum(rng.exponential(ni / 4, n), ni - 1).astype(np.int64)
    r = ((Ut[u] * Vt[i]).sum(-1) + rng.normal(0, 0.1, n)).astype(np.float32)
    hold = Ratings.from_arrays(u[:2000], i[:2000], r[:2000])
    kw = dict(num_factors=32, lambda_=0.05, iterations=3, learning_rate=0.1,
              lr_schedule="warm_boost", minibatch_size=512, init_scale=0.1)
    problem = device_blocking.device_block_problem(
        u, i, r, nu, ni, num_blocks=4, minibatch_multiple=512, seed=0,
        device="cpu")
    rmse = {}
    for dtype in ("float32", "bfloat16"):
        cfg = DSGDConfig(**kw, factor_dtype=dtype)
        cuda_sgd.reset_launch_counts()
        on_card = DSGD(cfg)._fit_problem(problem.to(dev))
        assert on_card.U.device.type == "cuda"
        assert cuda_sgd.LAUNCHES["sgd_item_rows_kernel"] > 0
        # bf16 too runs the step pair alone (the flagged route: no cast)
        assert cuda_sgd.LAUNCHES["f32_to_bf16_kernel"] == 0
        assert cuda_sgd.LAUNCHES["bf16_to_f32_kernel"] == 0
        on_cpu = DSGD(cfg, device="cpu")._fit_problem(problem)
        rmse[dtype] = on_card.rmse(hold)
        if dtype == "float32":
            assert abs(rmse[dtype] - on_cpu.rmse(hold)) < 1e-4
    assert abs(rmse["bfloat16"] - rmse["float32"]) < 0.05 * rmse["float32"]
    # the public entry point: blocking on the card, then the kernels
    cuda_sgd.reset_launch_counts()
    model = DSGD(DSGDConfig(**kw)).fit_device(
        torch.from_numpy(u).to(dev), torch.from_numpy(i).to(dev),
        torch.from_numpy(r).to(dev), nu, ni, num_blocks=4)
    assert cuda_sgd.LAUNCHES["sgd_user_rows_kernel"] > 0
    # another layout (the card's own draws), the same learning problem
    assert abs(model.rmse(hold) - rmse["float32"]) < 0.05 * rmse["float32"]


def _serving_model(dev, dtype="float32"):
    gen = SyntheticMFGenerator(num_users=600, num_items=900, rank=4,
                               noise=0.1, seed=7, skew_lam=2.0)
    train, test = gen.generate(40_000), gen.generate(3000)
    cfg = DSGDConfig(num_factors=64, lambda_=0.05, iterations=2,
                     learning_rate=0.1, lr_schedule="warm_boost",
                     minibatch_size=512, init_scale=0.1, factor_dtype=dtype)
    return DSGD(cfg).fit(train, num_blocks=4), train, test


def _on_cpu(model):
    from large_scale_recommendation_tpu_torch.models.mf import MFModel

    return MFModel(U=model.U.cpu(), V=model.V.cpu(), users=model.users,
                   items=model.items)


def _assert_topk_close(ids, scores, ids_c, scores_c, tol=1e-5):
    """Scores at tolerance position by position; ids equal wherever a score
    stands apart from its neighbours (the two devices sum the dots in
    other orders, so near-ties may swap)."""
    np.testing.assert_allclose(scores, scores_c, rtol=tol, atol=tol)
    apart = np.ones(scores_c.shape, bool)
    gap = np.abs(np.diff(scores_c, axis=1)) > 2 * tol
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    np.testing.assert_array_equal(ids[apart], ids_c[apart])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recommend_on_card_matches_cpu(dev, dtype):
    model, train, test = _serving_model(dev, dtype)
    assert model.U.device.type == "cuda"
    cpu = _on_cpu(model)
    users = np.concatenate([test.users[:500], [10**7]])
    for kw in (dict(k=10), dict(k=20, train=train)):
        ids, scores = model.recommend(users, chunk=128, **kw)
        ids_c, scores_c = cpu.recommend(users, chunk=128, **kw)
        _assert_topk_close(ids, scores, ids_c, scores_c)
        assert (ids[-1] == -1).all()
    seen = set(zip(train.users.tolist(), train.items.tolist()))
    ids, _ = model.recommend(users, k=20, train=train)
    assert not any((int(u), int(c)) in seen
                   for u, row in zip(users, ids) for c in row if c >= 0)
    got = model.ranking_quality(test.users, test.items, k=10, train=train)
    want = cpu.ranking_quality(test.users, test.items, k=10, train=train)
    assert got["n"] == want["n"] == test.n
    assert abs(got["hr"] - want["hr"]) <= 2e-3
    assert abs(got["ndcg"] - want["ndcg"]) <= 2e-3


@pytest.mark.parametrize("path,dtype", [("fit", "float32"),
                                        ("fit_device", "bfloat16")])
def test_resume_on_card_is_bit_equal(dev, tmp_path, path, dtype):
    """3 sweeps with a snapshot after each; the newest deleted, a new
    solver resumes from sweep 2: bit-equal tables (no atomics)."""
    from large_scale_recommendation_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    gen = SyntheticMFGenerator(num_users=500, num_items=400, rank=4,
                               noise=0.1, seed=8, skew_lam=2.0)
    train = gen.generate(30_000)
    cfg = DSGDConfig(num_factors=32, lambda_=0.05, iterations=3,
                     learning_rate=0.1, lr_schedule="warm_boost",
                     minibatch_size=512, init_scale=0.1, factor_dtype=dtype)
    u, i, r, _ = train.to_numpy()

    def fit(**kw):
        if path == "fit":
            return DSGD(cfg).fit(train, num_blocks=4, checkpoint_every=1,
                                 **kw)
        return DSGD(cfg).fit_device(u, i, r, 500, 400, num_blocks=4,
                                    checkpoint_every=1, **kw)

    m = CheckpointManager(str(tmp_path))
    full = fit(checkpoint_manager=m)
    assert m.steps() == [1, 2, 3]
    os.unlink(m.path(3))
    cuda_sgd.reset_launch_counts()
    resumed = fit(checkpoint_manager=m, resume=True)
    assert cuda_sgd.LAUNCHES["sgd_item_rows_kernel"] > 0  # one sweep ran
    assert resumed.U.device.type == "cuda" and resumed.U.dtype == full.U.dtype
    assert torch.equal(resumed.U, full.U) and torch.equal(resumed.V, full.V)


def test_bf16_checkpoint_round_trip_from_card(dev, tmp_path):
    from large_scale_recommendation_tpu_torch.utils import checkpoint

    model, _, test = _serving_model(dev, "bfloat16")
    m = checkpoint.CheckpointManager(str(tmp_path))
    checkpoint.save_mf_model(m, model, 2)
    with np.load(m.path(2)) as z:
        assert z["U"].dtype == np.uint16
    back, ck = checkpoint.restore_mf_model(m)  # onto the card
    assert back.U.device.type == "cuda" and back.U.dtype == torch.bfloat16
    assert torch.equal(back.U.view(torch.int16), model.U.view(torch.int16))
    assert torch.equal(back.V.view(torch.int16), model.V.view(torch.int16))
    assert ck.meta["rank"] == 64
    np.testing.assert_array_equal(back.predict(test.users, test.items),
                                  model.predict(test.users, test.items))


# -- ALS and online MF on the card (torch ops; no kernel of their own) ------


def _als_data(n=30_000, users=900, items=500, seed=12):
    gen = SyntheticMFGenerator(num_users=users, num_items=items, rank=4,
                               noise=0.05, seed=seed, skew_lam=2.0)
    return gen.generate(n), gen.generate(3_000)


@pytest.mark.parametrize("implicit", [False, True])
def test_als_device_plan_and_half_step_on_card_match_cpu(dev, implicit):
    """Device plans on the card bit-equal to the CPU's; one rank-64
    half-step within rtol 2e-4 / atol 2e-5 (implicit: 3e-3 / 3e-4)."""
    from large_scale_recommendation_tpu_torch.ops import als as als_ops

    train, _ = _als_data()
    u, i, r, _ = train.to_numpy()
    if implicit:
        r = np.abs(r)
    plans = {}
    for d in ("cpu", dev):
        p = als_ops.device_prepare_side(
            torch.as_tensor(u, device=d), torch.as_tensor(i, device=d),
            torch.as_tensor(r, device=d), 900, rank_for_chunking=64)
        plans[str(d)] = (als_ops.implicit_prepared(p, 2.0) if implicit
                         else p)
    for bc, bg in zip(plans["cpu"], plans[str(dev)]):
        for a, b in zip(bc, bg):
            assert torch.equal(a, b.cpu())
    F = keyed_uniform_rows(torch.arange(500), 64, 0.1)
    G = F.T @ F if implicit else None
    want = als_ops.solve_side(F, plans["cpu"], 900, 0.05, G)
    got = als_ops.solve_side(F.to(dev), plans[str(dev)], 900, 0.05,
                             None if G is None else G.to(dev))
    tol = dict(rtol=3e-3, atol=3e-4) if implicit else dict(rtol=2e-4,
                                                           atol=2e-5)
    torch.testing.assert_close(got.cpu(), want, **tol)
    got16 = als_ops.solve_side(F.to(dev), plans[str(dev)], 900, 0.05,
                               None if G is None else G.to(dev),
                               dtype=torch.bfloat16)
    assert (got16 - got).abs().max() <= 0.05 * got.abs().max()


@pytest.mark.parametrize("path", ["fit", "fit_device"])
def test_als_fit_on_card_matches_cpu(dev, path):
    """The keyed init is bit-equal on the card and the CPU, so the two fits
    start alike: tables within rtol 2e-3 / atol 2e-4, RMSE within 1e-4;
    one CUDA-event time per round on the card."""
    from large_scale_recommendation_tpu_torch.models.als import (
        ALS,
        ALSConfig,
    )

    train, test = _als_data()
    cfg = ALSConfig(num_factors=8, lambda_=0.1, iterations=3)
    u, i, r, _ = train.to_numpy()
    models = {}
    for d in ("cpu", None):
        solver = ALS(cfg, device=d)
        models[d] = (solver.fit(train) if path == "fit"
                     else solver.fit_device(u, i, r, 900, 500))
        assert len(solver.round_ms) == (3 if d is None else 0)
    card, cpu = models[None], models["cpu"]
    assert card.U.device.type == "cuda"
    np.testing.assert_array_equal(card.users.ids, cpu.users.ids)
    torch.testing.assert_close(card.U.cpu(), cpu.U, rtol=2e-3, atol=2e-4)
    torch.testing.assert_close(card.V.cpu(), cpu.V, rtol=2e-3, atol=2e-4)
    assert abs(card.rmse(test) - cpu.rmse(test)) <= 1e-4
    assert card.rmse(test) < 0.2  # 0.165 on the CPU


def test_sampled_metrics_on_card_match_cpu(dev):
    from large_scale_recommendation_tpu_torch.utils import metrics

    rng = np.random.default_rng(0)
    U = torch.from_numpy(rng.normal(size=(300, 16)).astype(np.float32))
    V = torch.from_numpy(rng.normal(size=(200, 16)).astype(np.float32))
    eu, ei = rng.integers(0, 300, 900), rng.integers(0, 200, 900)
    tu, ti = rng.integers(0, 300, 4000), rng.integers(0, 200, 4000)
    kw = dict(k=10, num_negatives=100, train_u=tu, train_i=ti, seed=7)
    got = metrics.sampled_ranking_metrics(U.to(dev), V.to(dev), eu, ei, **kw)
    want = metrics.sampled_ranking_metrics(U, V, eu, ei, **kw)
    assert abs(got["hr"] - want["hr"]) <= 1e-5
    assert abs(got["ndcg"] - want["ndcg"]) <= 1e-5
    assert got["valid_negatives"] == want["valid_negatives"]
    users = np.unique(eu)[:128]
    assert abs(metrics.catalog_coverage(U.to(dev), V.to(dev), users)
               - metrics.catalog_coverage(U, V, users)) <= 1e-2


def test_online_on_card_matches_cpu_and_restores_bit_equal(dev, tmp_path):
    """Four batches on the card and the CPU from the same keyed init: ids →
    rows equal, tables within rtol 1e-4 / atol 1e-5 after each; a card
    snapshot restores bit-equal, on the CPU and on the card."""
    from large_scale_recommendation_tpu_torch.models.online import (
        OnlineMF,
        OnlineMFConfig,
    )
    from large_scale_recommendation_tpu_torch.utils import checkpoint

    gen = SyntheticMFGenerator(num_users=5000, num_items=700, rank=4,
                               noise=0.1, seed=3, skew_lam=2.0)
    cfg = OnlineMFConfig(num_factors=64, learning_rate=0.05,
                         minibatch_size=1024, init_capacity=1024)
    card, cpu = OnlineMF(cfg), OnlineMF(cfg, device="cpu")
    assert card.users.array.device.type == "cuda"
    for n in range(4):
        b = gen.generate(6000)
        ups = card.partial_fit(b, offset=(0, n))
        cpu_ups = cpu.partial_fit(b, offset=(0, n))
        np.testing.assert_array_equal(ups.user_arrays[0],
                                      cpu_ups.user_arrays[0])
        for a, c in ((card.users, cpu.users), (card.items, cpu.items)):
            assert a.capacity == c.capacity
            np.testing.assert_array_equal(a.id_array(), c.id_array())
            torch.testing.assert_close(a.array.cpu(), c.array, rtol=1e-4,
                                       atol=1e-5)
    m = checkpoint.CheckpointManager(str(tmp_path))
    checkpoint.save_online_state(m, card, 4)
    for d in ("cpu", None):
        back = OnlineMF(cfg, device=d)
        checkpoint.restore_online_state(m, back)
        assert back.step == 4 and back.consumed_offsets == {0: 3}
        for a, c in ((back.users, card.users), (back.items, card.items)):
            np.testing.assert_array_equal(a.id_array(), c.id_array())
            assert torch.equal(a.array[:a.num_rows].cpu(),
                               c.array[:c.num_rows].cpu())


def _engine_model(device, num_users=300, num_items=4096, rank=16, seed=0,
                   structured=False):
    from large_scale_recommendation_tpu_torch.data.blocking import flat_index
    from large_scale_recommendation_tpu_torch.models.mf import MFModel

    rng = np.random.default_rng(seed)
    if structured:
        centers = rng.normal(size=(16, rank)) * 2.0
        V = (centers[rng.integers(0, 16, num_items)]
             + 0.3 * rng.normal(size=(num_items, rank)))
    else:
        V = rng.normal(size=(num_items, rank))
    U = rng.normal(size=(num_users, rank))
    return MFModel(
        U=torch.from_numpy(U.astype(np.float32)).to(device),
        V=torch.from_numpy(V.astype(np.float32)).to(device),
        users=flat_index(np.arange(num_users, dtype=np.int64)),
        items=flat_index(np.arange(num_items, dtype=np.int64)))


@pytest.mark.parametrize("retrieval,dtype", [(None, None),
                                             (None, "bfloat16"),
                                             ("flat", None)])
def test_serving_engine_on_card_matches_cpu(dev, retrieval, dtype):
    """The engine on the card (pinned staging, two-deep dispatch) against
    the same engine on the CPU: scores within 1e-5·max(1,|s|), ids equal
    where scores stand apart; the flat two-stage int8 codes bit-equal."""
    from large_scale_recommendation_tpu_torch.serving import (
        RetrievalConfig,
        ServingEngine,
    )

    cfg = RetrievalConfig(overfetch=4) if retrieval else None
    rng = np.random.default_rng(1)
    train = (rng.integers(0, 300, 5000), rng.integers(0, 4096, 5000))
    card = ServingEngine(_engine_model(dev), k=10, train=train,
                         max_batch=64, retrieval=cfg, dtype=dtype)
    cpu = ServingEngine(_engine_model("cpu"), k=10, train=train,
                        max_batch=64, retrieval=cfg, dtype=dtype)
    reqs = [rng.integers(0, 300, int(n)) for n in rng.integers(1, 40, 30)]
    for a, b in zip(card.serve(reqs), cpu.serve(reqs)):
        s_ref = b[1]
        assert np.all(np.abs(a[1] - s_ref)
                      <= 1e-5 * np.maximum(1.0, np.abs(s_ref)))
        apart = np.ones(s_ref.shape, bool)
        gap = np.abs(np.diff(s_ref, axis=1)) > 2e-5 * np.maximum(
            1.0, np.abs(s_ref[:, 1:]))
        apart[:, 1:] &= gap
        apart[:, :-1] &= gap
        np.testing.assert_array_equal(a[0][apart], b[0][apart])
    assert card.stats["buckets"] == cpu.stats["buckets"]
    if retrieval:
        assert torch.equal(card.retriever.catalog.q.cpu(),
                           cpu.retriever.catalog.q)
        assert torch.equal(card.retriever.catalog.scale.cpu(),
                           cpu.retriever.catalog.scale)


def test_clustered_retriever_on_card(dev):
    """The clustered build and stages on the card: recall@10 ≥ 0.95
    against the exact engine (the CPU pin), every row placed once."""
    from large_scale_recommendation_tpu_torch.serving import (
        RetrievalConfig,
        ServingEngine,
        recall_at_k,
    )

    model = _engine_model(dev, num_users=256, structured=True, seed=2)
    exact = ServingEngine(model, k=10)
    fast = ServingEngine(model, k=10, retrieval=RetrievalConfig(
        overfetch=4, n_clusters=32, n_probe=12, kmeans_sample=4096))
    cat = fast.retriever.catalog
    assert cat.slab_q.device.type == "cuda"
    assert len(np.unique(cat.pos_of_row)) == 4096
    uids = np.arange(256)
    assert recall_at_k(fast.recommend(uids)[0],
                       exact.recommend(uids)[0]) >= 0.95


def test_int8_product_exact_on_card(dev):
    from large_scale_recommendation_tpu_torch.serving.retrieval import (
        int8_scores,
    )

    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, (256, 1039)).astype(np.int8)
    b = rng.integers(-127, 128, (300, 1039)).astype(np.int8)
    a[0], b[0] = 127, -127
    got = int8_scores(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
    np.testing.assert_array_equal(got.cpu().numpy().astype(np.int64),
                                  a.astype(np.int64) @ b.astype(np.int64).T)


def test_engine_delta_on_card_equals_fresh_engine(dev):
    from large_scale_recommendation_tpu_torch.serving import (
        RetrievalConfig,
        ServingEngine,
    )

    rng = np.random.default_rng(4)
    model = _engine_model(dev, seed=4)
    eng = ServingEngine(model, k=10, retrieval=RetrievalConfig())
    v0 = eng.version
    rows = rng.choice(4096, 256, replace=False)
    vals = rng.normal(size=(256, 16)).astype(np.float32)
    assert eng.apply_delta(item_rows=rows, V_rows=vals) != v0
    fresh = ServingEngine(model, k=10, retrieval=RetrievalConfig())
    assert torch.equal(eng.retriever.catalog.q, fresh.retriever.catalog.q)
    uids = np.arange(300)
    a, b = eng.recommend(uids), fresh.recommend(uids)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


# -- the tiered store's copies on the card -------------------------------


def _store_batches(n_batches=8, users=3000, per_batch=400, items=200,
                   seed=21):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        u = np.repeat(rng.choice(users, per_batch, replace=False), 3)
        out.append(Ratings.from_arrays(
            u, rng.integers(0, items, u.size),
            rng.random(u.size).astype(np.float32)))
    return out


def _store_model(device, slots=None):
    from large_scale_recommendation_tpu_torch.core.initializers import (
        PseudoRandomFactorInitializer,
    )
    from large_scale_recommendation_tpu_torch.models.online import (
        OnlineMF,
        OnlineMFConfig,
    )
    from large_scale_recommendation_tpu_torch.store import TieredFactorStore

    cfg = OnlineMFConfig(num_factors=32, minibatch_size=256)
    m = OnlineMF(cfg, device=device)
    if slots is not None:
        m.users = TieredFactorStore(
            PseudoRandomFactorInitializer(32, scale=cfg.init_scale),
            slot_capacity=slots, device=device)
    return m


def test_store_copies_use_pinned_buffers_and_the_side_stream(dev):
    """Slot loads stage through pinned memory on a side stream, the pool is
    rebound on every load (a held binding keeps its values), and loaded
    and written-back rows are exact copies."""
    m = _store_model(dev, slots=512)
    st = m.users
    assert st.array.device.type == "cuda" and st._copy_stream is not None
    assert st._copy_stream != torch.cuda.current_stream(dev)
    ids = np.arange(1000, 1600)
    st.ensure(ids)
    rows, _ = st.rows_for(ids)
    held = st.array
    before = held.clone()
    assert st.prefetch(ids) == 512  # best effort: the pool is full
    assert st._stage.is_pinned() and st._stage_idx.is_pinned()
    assert torch.equal(held, before)  # the old binding never changed
    hot = st._row_slot[rows] >= 0
    got = st.array[torch.as_tensor(st._row_slot[rows[hot]], device=dev)]
    np.testing.assert_array_equal(got.cpu().numpy(), st.cold[rows[hot]])
    slots = st._row_slot[rows[hot]][:100]
    back = st._gather_pool(slots)
    assert st._wb.is_pinned()
    np.testing.assert_array_equal(back, st.cold[rows[hot][:100]])


def test_store_on_card_within_the_online_bar_of_the_plain_table(dev):
    """Tiered (256 slots for 400-user batches: evictions every batch)
    against the plain table on the card, and the tiered run on the card
    against the tiered run on the CPU: the online bar (the card's
    ``index_add_`` adds duplicates with atomics in any order)."""
    bs = _store_batches()
    runs = [_store_model(dev), _store_model(dev, slots=512),
            _store_model("cpu", slots=512)]
    for m in runs:
        for b in bs:
            m.partial_fit(b, emit_updates=False)
    plain, tier, cpu = runs
    n = plain.users.num_rows
    assert np.array_equal(tier.users.id_array(), plain.users.id_array())
    assert tier.users.stats.evictions > 0
    a = tier.users.full_table()[:n].cpu()
    torch.testing.assert_close(a, plain.users.array[:n].cpu(),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(a, cpu.users.full_table()[:n],
                               rtol=1e-4, atol=1e-5)
    assert tier.users.stats.snapshot()["misses"] == \
        cpu.users.stats.snapshot()["misses"]


def test_store_prefetcher_and_serving_on_card(dev):
    from large_scale_recommendation_tpu_torch.serving import ServingEngine
    from large_scale_recommendation_tpu_torch.store import StorePrefetcher

    bs = _store_batches(seed=22)
    m = _store_model(dev, slots=1024)
    pf = StorePrefetcher(m.users).start()
    try:
        for k, b in enumerate(bs):
            if k + 1 < len(bs):
                pf.submit(np.unique(bs[k + 1].users))
            m.partial_fit(b, emit_updates=False)
        pf.drain()
    finally:
        pf.stop()
    st = m.users
    assert st.stats.prefetched > 0
    n = st.num_rows
    served = st.serve_rows(np.arange(n))
    assert torch.equal(served, st.full_table()[:n])
    ids = st.id_array()[:300]
    model = m.to_model()
    a = ServingEngine(model, k=10, user_store=st).recommend(ids)
    b = ServingEngine(model, k=10).recommend(ids)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


# -- the mesh's per-visit route (block_sweep) ---------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_sweep_equals_the_stratum_launch(dev, dtype):
    """Each rank's plan as a k-rank ring builds it (its device-major cells
    ``[k, 1, b]``, ``visit_plan``): every visit (p, s) of a sweep through
    ``block_sweep``, from the same tables, bit-equal to the slices of
    ``stratum_sweep`` of stratum s, and within 1e-5 (f32) / one bf16 ulp
    of ``block_sweep_reference``; stratum 0's k visits launch the pair
    ``n_mb`` times each (no cast in bf16: the flagged route)."""
    from large_scale_recommendation_tpu_torch.parallel.dsgd_mesh import (
        visit_plan,
    )

    k, rank, mb = 4, 64, 256
    problem, args, U, V = _problem(dev, k, rank, mb)
    su, si, sv, sw, ou, ov, icu, icv = args
    ru_b, rv_b = problem.users.rows_per_block, problem.items.rows_per_block
    plan = _plan(args, mb)
    work = plan.new_work(rank)
    cells = [(su[:, p] % ru_b, si[:, p] % rv_b, sv[:, p], sw[:, p],
              icu[:, p], icv[:, p]) for p in range(k)]
    plans = [visit_plan(c, mb) for c in cells]
    assert all((vp.num_blocks, vp.visits) == (k, 1) for vp in plans)
    Ut, Vt = U.to(dtype), V.to(dtype)
    for s in range(k):
        Us, Vs = Ut.clone(), Vt.clone()
        if dtype == torch.bfloat16:
            Uw, Vw = torch.empty_like(U), torch.empty_like(V)
            cuda_sgd.bf16_to_f32(Us, Vs, Uw, Vw)
            cuda_sgd.stratum_sweep(Uw, Vw, ou, ov, plan, s, work, lr=0.5,
                                   lam=0.1)
            cuda_sgd.f32_to_bf16(Uw, Vw, Us, Vs)
        else:
            cuda_sgd.stratum_sweep(Us, Vs, ou, ov, plan, s, work, lr=0.5,
                                   lam=0.1)
        cuda_sgd.reset_launch_counts()
        swept = []
        for p in range(k):
            q = (p + s) % k
            rows_u = slice(p * ru_b, (p + 1) * ru_b)
            rows_v = slice(q * rv_b, (q + 1) * rv_b)
            Ub, Vb = Ut[rows_u].clone(), Vt[rows_v].clone()
            cuda_sgd.block_sweep(Ub, Vb, ou[rows_u], ov[rows_v], plans[p], s,
                                 plans[p].new_work(rank), lr=0.5, lam=0.1)
            swept.append((rows_u, rows_v, Ub, Vb))
        torch.cuda.synchronize()
        if s == 0:
            assert cuda_sgd.LAUNCHES == _pair_counts(k * plan.n_mb)
        for p, (rows_u, rows_v, Ub, Vb) in enumerate(swept):
            Ur, Vr = cuda_sgd.block_sweep_reference(
                Ut[rows_u], Vt[rows_v], *(a[s] for a in cells[p]),
                ou[rows_u], ov[rows_v], lr=0.5, lam=0.1, minibatch=mb)
            assert torch.equal(Ub, Us[rows_u]) and torch.equal(Vb,
                                                               Vs[rows_v])
            for a, b in ((Ub, Ur), (Vb, Vr)):
                if dtype == torch.bfloat16:
                    assert _bf16_ulps(a, b) <= 1.0
                else:
                    assert float((a - b).abs().max()) <= TOL


def test_block_sweep_refuses_a_stratum_plan(dev):
    problem, args, U, V = _problem(dev, 2, 32, 256)
    plan = _plan(args, 256)
    with pytest.raises(ValueError, match="one visit per stratum"):
        cuda_sgd.block_sweep(U, V, args[4], args[5], plan, 0,
                             plan.new_work(32), lr=0.1, lam=0.1)


def test_mesh_dsgd_world_one_equals_dsgd_on_the_card(dev):
    """``MeshDSGD`` on a one-rank partitioner (no process group) runs the
    single-card fit's launches: bit-equal tables, f32 and bf16."""
    from large_scale_recommendation_tpu_torch.parallel import (
        MeshDSGD,
        MeshDSGDConfig,
        Partitioner,
    )

    rng = np.random.default_rng(0)
    u = rng.integers(0, 500, 30_000)
    i = rng.integers(0, 300, 30_000)
    r = rng.normal(size=30_000).astype(np.float32)
    kw = dict(num_factors=32, lambda_=0.05, iterations=2, learning_rate=0.1,
              lr_schedule="constant", seed=0, minibatch_size=1024,
              init_scale=0.1)
    for dtype in ("float32", "bfloat16"):
        mesh = MeshDSGD(MeshDSGDConfig(**kw, factor_dtype=dtype),
                        partitioner=Partitioner()).fit_device(u, i, r, 500,
                                                              300)
        ref = DSGD(DSGDConfig(**kw, factor_dtype=dtype)).fit_device(
            u, i, r, 500, 300, num_blocks=1)
        assert torch.equal(mesh.U, ref.U) and torch.equal(mesh.V, ref.V)


def test_probe_cuda_variant_launches_the_step_pair(dev):
    """``probe_variants`` on the card (its default device): numeric rates
    for both variants, the step pair launched steps × (1 + reps) × sweeps
    times each, and the cuda variant's one visit within the per-stratum
    bar of ``block_sweep_reference`` on the same draw."""
    kw = dict(rank=64, mb=512, rpb_u=1000, rpb_v=400, nnz=4096)
    reps, sweeps, steps = 2, 3, 4096 // 512
    cuda_sgd.reset_launch_counts()
    out = cuda_sgd.probe_variants(reps=reps, sweeps=sweeps, **kw)
    assert set(out) == {"torch", "cuda"}, out
    assert all(isinstance(v, float) and v > 0 for v in out.values()), out
    want = steps * (1 + reps) * sweeps
    assert cuda_sgd.LAUNCHES == {"sgd_item_rows_kernel": want,
                                 "sgd_user_rows_kernel": want,
                                 "bf16_to_f32_kernel": 0,
                                 "f32_to_bf16_kernel": 0}
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = cuda_sgd._probe_inputs(gen, kw["rank"], kw["mb"], kw["rpb_u"],
                                    kw["rpb_v"], kw["nnz"], False)
    got = cuda_sgd._probe_setups(
        inputs, mb=kw["mb"], sweeps=1, lr=0.1, lam=0.1,
        rates=cuda_sgd.ProbeRates())["cuda"]()()
    ref = cuda_sgd.block_sweep_reference(*inputs[8:], *inputs[:8], lr=0.1,
                                         lam=0.1, minibatch=kw["mb"])
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= TOL
