"""The CUDA kernels on the card, against their plain versions. These tests
need a CUDA device and skip without one; on the machine with the card run

    python -m pytest --noconftest -q tests/test_torch_cuda_card.py

(``--noconftest``: the suite's conftest imports the JAX package, which that
machine does not have). Tolerance: the scatter adds duplicate rows with f32
atomics in a varying order, so kernel and plain agree to max-abs 1e-5 per
stratum, not bit for bit.
"""

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu_torch.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu_torch.data import blocking
from large_scale_recommendation_tpu_torch.models.dsgd import DSGD, DSGDConfig
from large_scale_recommendation_tpu_torch.ops import cuda_sgd

pytestmark = pytest.mark.cuda
TOL = 1e-5  # max-abs per stratum


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _problem(dev, k, rank, mb, n=20_000, seed=0):
    gen = SyntheticMFGenerator(num_users=800, num_items=600, rank=8,
                               noise=0.1, seed=seed, skew_lam=2.0)
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


@pytest.mark.parametrize("k,rank,mb", [(4, 128, 512), (2, 32, 256),
                                       (3, 8, 1024), (2, 200, 128)])
def test_stratum_kernels_match_plain(dev, k, rank, mb):
    problem, args, U, V = _problem(dev, k, rank, mb)
    su, si, sv, sw, ou, ov, icu, icv = args
    idx, streams = cuda_sgd.build_stratum_operands(
        su, si, sv, sw, icu, icv, ou, ov, num_blocks=k,
        rpb_u=problem.users.rows_per_block,
        rpb_v=problem.items.rows_per_block, minibatch=mb)
    du, dv = cuda_sgd.alloc_scratch(k, mb, rank, dev)
    cuda_sgd.reset_launch_counts()
    for s in range(k):
        Uk, Vk = U.clone(), V.clone()
        cuda_sgd.stratum_sweep(Uk, Vk, su, si, sv, sw, icu, icv, ou, ov, s,
                               du, dv, lr=0.5, lam=0.1, minibatch=mb)
        Ur, Vr = cuda_sgd.stratum_sweep_reference(
            U, V, idx, streams, s, lr=0.5, lam=0.1, minibatch=mb,
            num_blocks=k)
        torch.cuda.synchronize()
        assert float((Uk - Ur).abs().max()) <= TOL
        assert float((Vk - Vr).abs().max()) <= TOL
    n_mb = su.shape[-1] // mb
    assert cuda_sgd.LAUNCHES == {"sgd_delta_kernel": k * n_mb,
                                 "sgd_scatter_kernel": k * n_mb}


def test_delta_kernel_matches_plain_exactly_shaped(dev):
    k, rank, mb = 4, 128, 512
    problem, args, U, V = _problem(dev, k, rank, mb, seed=1)
    su, si, sv, sw, ou, ov, icu, icv = args
    planes = [a[1] for a in (su, si, sv, sw, icu, icv)]
    dk = cuda_sgd.alloc_scratch(k, mb, rank, dev)
    dp = cuda_sgd.alloc_scratch(k, mb, rank, dev)
    for d in dk:
        d.fill_(float("nan"))  # every slot, padding included, is written
    for g in range(su.shape[-1] // mb):
        cuda_sgd.sgd_delta(U, V, *planes, ou, ov, g, *dk, lr=0.3, lam=0.1,
                           minibatch=mb)
        cuda_sgd.sgd_delta_reference(U, V, *planes, ou, ov, g, *dp, lr=0.3,
                                     lam=0.1, minibatch=mb)
        torch.cuda.synchronize()
        for a, b in zip(dk, dp):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_wrappers_reject_bad_operands(dev):
    k, rank, mb = 2, 32, 256
    problem, args, U, V = _problem(dev, k, rank, mb, n=4000)
    su, si, sv, sw, ou, ov, icu, icv = args
    du, dv = cuda_sgd.alloc_scratch(k, mb, rank, dev)
    planes = [a[0] for a in (su, si, sv, sw, icu, icv)]
    with pytest.raises(ValueError, match="dtype"):
        cuda_sgd.sgd_delta(U, V, planes[0].long(), *planes[1:], ou, ov, 0,
                           du, dv, lr=0.1, lam=0.1, minibatch=mb)
    with pytest.raises(ValueError, match="shape"):
        cuda_sgd.sgd_scatter(U, V, planes[0], planes[1], planes[3], 0,
                             du[:-1], dv, minibatch=mb)
    with pytest.raises(ValueError, match="one CUDA device or all on"):
        cuda_sgd.sgd_scatter(U.cpu(), V, planes[0], planes[1], planes[3], 0,
                             du, dv, minibatch=mb)
    with pytest.raises(ValueError, match="rank"):
        wide = torch.zeros((U.shape[0], 512), device=dev)
        cuda_sgd.sgd_delta(wide, torch.zeros((V.shape[0], 512), device=dev),
                           *planes, ou, ov, 0,
                           *cuda_sgd.alloc_scratch(k, mb, 512, dev), lr=0.1,
                           lam=0.1, minibatch=mb)


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
    assert cuda_sgd.LAUNCHES["sgd_delta_kernel"] > 0
    np.testing.assert_allclose(on_card.U.cpu().numpy(), on_cpu.U.numpy(),
                               rtol=2e-4, atol=2e-5)
    assert abs(on_card.rmse(test) - on_cpu.rmse(test)) < 1e-4
    with pytest.raises(ValueError, match="collision"):
        DSGD(DSGDConfig(collision_mode="sum")).fit(train, num_blocks=2)
