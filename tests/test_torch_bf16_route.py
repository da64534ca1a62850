"""The bf16 route of the DSGD step pair on the CPU: the step plan's
first- and last-touch flags, and the flagged plain versions of kernels A
and B against the earlier route (whole-table casts around the f32 pair).

The flagged route reads a row from its bf16 table at the row's first step
of a stratum and writes it back (rounded to nearest even) at its last, with
the same f32 arithmetic in between, so its tables are bit-equal to the cast
route's after every stratum: no tolerance. The work tables start as NaN, so
a read of a row the stratum has not reached would show. The kernels
themselves are checked on the card (tests/test_torch_cuda_card.py,
chip_smoke.py); parity with the JAX package's ``half=True`` kernels is in
tests/test_torch_cuda_sgd.py.
"""

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu_torch.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu_torch.data import blocking
from large_scale_recommendation_tpu_torch.ops import cuda_sgd as tc
from large_scale_recommendation_tpu_torch.parallel.dsgd_mesh import (
    visit_plan,
)

KEYS = ("su", "si", "sv", "sw", "icu", "icv")


def _plan(a, mb):
    return tc.build_step_plan(*(torch.from_numpy(np.array(a[x]))
                                for x in KEYS), minibatch=mb)


def _expected_flags(a, mb):
    """Per real entry (flat index): its user-row and item-row touch flags
    by brute force — FIRST where its step is the row's first among the
    stratum's real entries, LAST where it is the last."""
    S, P, b = a["su"].shape
    n_mb = b // mb
    flat = {x: a[x].reshape(-1) for x in a}
    real = np.flatnonzero(flat["sw"] != 0)
    step = (real // (P * b)) * n_mb + (real % b) // mb
    out = {}
    for side, rows in (("u", flat["su"][real]), ("v", flat["si"][real])):
        key = list(zip(step // n_mb, rows))
        lo, hi = {}, {}
        for k_, t in zip(key, step):
            lo[k_] = min(lo.get(k_, t), t)
            hi[k_] = max(hi.get(k_, t), t)
        out[side] = {int(e): (tc.FIRST if t == lo[k_] else 0)
                     | (tc.LAST if t == hi[k_] else 0)
                     for e, k_, t in zip(real, key, step)}
        out[f"{side}_touched"] = [len({r for (s, r) in lo if s == s_})
                                  for s_ in range(S)]
    return out


def _check_flags(a, mb):
    """The plan's flags (both orders) and per-stratum touched rows against
    ``_expected_flags``; ratings ``sv`` must be distinct (they name the
    entries). Returns the plan and the expected flags."""
    plan = _plan(a, mb)
    want = _expected_flags(a, mb)
    sv = a["sv"].reshape(-1)
    assert np.unique(sv).size == sv.size
    order = np.argsort(sv)
    v_ent = order[np.searchsorted(sv[order], plan.v_r.numpy())]
    u_ent = v_ent[plan.u_epos.long().numpy()]
    assert plan.v_flag.dtype == torch.uint8 == plan.u_flag.dtype
    got_v = plan.v_flag.numpy()
    np.testing.assert_array_equal(
        got_v, [want["v"][e] | (tc.GATHER_FIRST if want["u"][e] & tc.FIRST
                                else 0) for e in v_ent])
    np.testing.assert_array_equal(plan.u_flag.numpy(),
                                  [want["u"][e] for e in u_ent])
    assert plan.u_touched == want["u_touched"]
    assert plan.v_touched == want["v_touched"]
    return plan, want


def _hand_layout():
    """Two strata of two visits (k = 2), minibatch 64, three steps a
    stratum; user rows 0–49 (block 0) and 50–99, item rows 0–29 and 30–59.
    Stratum 0, visit 0 holds, beside distinct filler rows:
      user 1 in step 0 only; user 2 in every step; user 4 as 40 entries of
      step 1 (a segment longer than the 32-entry chunk) and once in step 2;
      user 0 only in step 1 while weight-0 padding names row 0 in steps 0
      and 2; user 3 not at all (it appears in stratum 1).
    Returns the layout and the minibatch."""
    k, mb, n_mb = 2, 64, 3
    b = mb * n_mb
    rng = np.random.default_rng(0)
    su = np.zeros((k, k, b), np.int32)
    si = np.zeros((k, k, b), np.int32)
    sw = np.ones((k, k, b), np.float32)
    for s in range(k):
        for p in range(k):
            q = (p + s) % k
            su[s, p] = p * 50 + rng.integers(10, 50, b)
            si[s, p] = q * 30 + rng.integers(5, 30, b)
    cell = su[0, 0]  # filler rows are 10 and up
    cell[3] = 1                          # user 1: step 0 only
    cell[[4, mb + 4, 2 * mb + 4]] = 2    # user 2: every step
    cell[mb + 10:mb + 50] = 4            # user 4: 40 entries of step 1
    cell[2 * mb + 7] = 4                 # ... and once in step 2
    cell[mb + 60] = 0                    # user 0: a real entry in step 1
    for j in (5, 2 * mb + 9):            # padding on row 0, steps 0 and 2
        su[0, 0, j], si[0, 0, j], sw[0, 0, j] = 0, 0, 0.0
    su[1, 0, 7] = 3                      # user 3: stratum 1 only
    sv = rng.permutation(su.size).astype(np.float32).reshape(su.shape)
    icu = rng.random(su.shape).astype(np.float32)
    icv = rng.random(su.shape).astype(np.float32)
    return dict(su=su, si=si, sv=sv, sw=sw, icu=icu, icv=icv), mb


def test_plan_flags_on_a_hand_built_layout():
    """Each real entry's flags against the brute-force rule, and the cases
    one by one: a row touched in one step only (first and last), in every
    step (first, neither, last), never in the stratum (no flag: it is in
    no position), a long segment (one set of flags across its positions),
    padding (no segment, and it does not stretch row 0's steps)."""
    a, mb = _hand_layout()
    plan, _ = _check_flags(a, mb)
    rows = tc.plan_rows(plan.u_prow).numpy()
    flags = plan.u_flag.numpy()
    base = plan.entry_base

    def user_flags(row, stratum):
        """{step: the set of flags of the row's positions} in a stratum."""
        out = {}
        for t in range(stratum * 3, stratum * 3 + 3):
            at = np.flatnonzero(rows[base[t]:base[t + 1]] == row)
            if at.size:
                out[t - stratum * 3] = set(flags[base[t] + at].tolist())
        return out

    both = tc.FIRST | tc.LAST
    assert user_flags(1, 0) == {0: {both}}
    assert user_flags(2, 0) == {0: {tc.FIRST}, 1: {0}, 2: {tc.LAST}}
    assert user_flags(3, 0) == {}
    assert user_flags(3, 1) == {0: {both}}
    assert user_flags(4, 0) == {1: {tc.FIRST}, 2: {tc.LAST}}
    assert user_flags(0, 0) == {1: {both}}  # padding steps do not count
    assert (plan.u_prow.numpy()[rows == 4][:40] < 0).all()  # long segment
    assert max(plan.longest_u) >= 40
    # the padding entries are in no position
    assert plan.entry_base[-1] == int((a["sw"] != 0).sum())


@pytest.mark.parametrize("k", [2, 4])
def test_plan_flags_on_a_skewed_layout(k):
    """Random skewed layouts (duplicate rows inside minibatches, long
    segments, weight-0 padding) against the brute-force rule."""
    a, _, _, mb = _blocked(k, 4, seed=k)
    plan, _ = _check_flags(a, mb)
    assert len(plan.u_long) and len(plan.v_long)


@pytest.mark.parametrize("k", [2, 3])
def test_plan_flags_of_a_rank_plan(k):
    """One rank's per-visit plan ``[k, 1, b]`` (``dsgd_mesh.visit_plan``,
    block-local rows): a stratum is one visit, and the same rule gives the
    flags."""
    a, _, _, mb = _blocked(k, 4, seed=k + 7)
    p = k - 1
    cells = {x: np.ascontiguousarray(a[x][:, p:p + 1]) for x in a}
    plan, want = _check_flags(cells, mb)
    rank_plan = visit_plan(tuple(torch.from_numpy(cells[x][:, 0])
                                 for x in KEYS), mb)
    assert (rank_plan.num_blocks, rank_plan.visits) == (k, 1)
    assert torch.equal(rank_plan.v_flag, plan.v_flag)
    assert torch.equal(rank_plan.u_flag, plan.u_flag)


def _blocked(k, rank, seed=0, n=4000, divisor=2):
    """A skewed blocked problem (the port's host blocking): padding,
    duplicate rows in every minibatch and segments longer than the
    32-entry chunk on both sides; minibatch = block / ``divisor``,
    distinct ratings. Numpy arrays in the stratum-major layout, the ω and
    f32 tables."""
    gen = SyntheticMFGenerator(num_users=40, num_items=30, rank=4,
                               noise=0.1, seed=seed, skew_lam=3.0)
    train = gen.generate(n)
    b = blocking.block_problem(train, num_blocks=k,
                               seed=0).ratings.u_rows.shape[-1]
    prob = blocking.block_problem(train, num_blocks=k, seed=0,
                                  minibatch_multiple=-(-b // divisor))
    r = prob.ratings
    mb = r.u_rows.shape[-1] // divisor
    icu, icv = blocking.minibatch_inv_counts(r, mb)
    assert (r.weights == 0).any()
    rng = np.random.default_rng(seed + 1)
    sv = r.values + rng.permutation(r.values.size).reshape(
        r.values.shape).astype(np.float32) * 1e-3  # distinct
    a = dict(su=r.u_rows, si=r.i_rows, sv=sv, sw=r.weights, icu=icu, icv=icv)
    U = rng.uniform(-0.3, 0.3, (prob.users.num_rows, rank)).astype(np.float32)
    V = rng.uniform(-0.3, 0.3, (prob.items.num_rows, rank)).astype(np.float32)
    omega = (torch.from_numpy(prob.users.omega.astype(np.float32)),
             torch.from_numpy(prob.items.omega.astype(np.float32)))
    return a, omega, (U, V), mb


def _nan_like(t):
    return torch.full(t.shape, float("nan"), dtype=torch.float32)


@pytest.fixture
def no_casts(monkeypatch):
    """Any call of the cast wrappers fails the test."""
    def refuse(*args, **kw):
        raise AssertionError("the bf16 route called a whole-table cast")

    monkeypatch.setattr(tc, "bf16_to_f32", refuse)
    monkeypatch.setattr(tc, "f32_to_bf16", refuse)


@pytest.mark.parametrize("rank", [7, 8, 128])
@pytest.mark.parametrize("k", [2, 4])
def test_flagged_route_bit_equal_to_the_cast_route(k, rank):
    """Two sweeps of strata on bf16 tables, the flagged plain route (NaN
    work tables) against the cast route (whole-table casts around the f32
    pair's plain versions): bit-equal bf16 tables after every stratum, no
    launch counted; the rows a stratum never touches keep their bits."""
    a, (ou, ov), (U, V), mb = _blocked(k, rank, seed=rank + k)
    # k rows more on each side, in no entry: untouched in every stratum
    U, V = (np.concatenate([x, np.full((k, rank), 0.25, np.float32)])
            for x in (U, V))
    ou, ov = (torch.cat([o, torch.ones(k)]) for o in (ou, ov))
    plan = _plan(a, mb)
    work, work_c = plan.new_work(rank), plan.new_work(rank)
    kw = dict(lr=0.2, lam=0.05)
    Uf, Vf = (torch.from_numpy(x).to(torch.bfloat16) for x in (U, V))
    Uc, Vc = Uf.clone(), Vf.clone()
    Uw_c, Vw_c = torch.empty(U.shape), torch.empty(V.shape)
    tc.reset_launch_counts()
    for _ in range(2):
        for s in range(k):
            before = Uf.clone(), Vf.clone()
            tc.stratum_sweep(_nan_like(U), _nan_like(V), ou, ov, plan, s,
                             work, store=(Uf, Vf), **kw)
            tc.stratum_sweep_cast(Uc, Vc, Uw_c, Vw_c, ou, ov, plan, s,
                                  work_c, **kw)
            for got, want in ((Uf, Uc), (Vf, Vc)):
                assert got.dtype == torch.bfloat16
                assert torch.equal(got.view(torch.int16),
                                   want.view(torch.int16))
            sl = slice(plan.entry_base[s * plan.n_mb],
                       plan.entry_base[(s + 1) * plan.n_mb])
            for table, old, prow in ((Uf, before[0], plan.u_prow),
                                     (Vf, before[1], plan.v_prow)):
                untouched = torch.ones(table.shape[0], dtype=torch.bool)
                untouched[tc.plan_rows(prow[sl])] = False
                assert untouched.any()
                assert torch.equal(table[untouched].view(torch.int16),
                                   old[untouched].view(torch.int16))
    assert not any(tc.LAUNCHES.values())


@pytest.mark.parametrize("k", [2, 3])
def test_block_sweep_bf16_on_a_rank_plan_is_bit_equal_to_the_cast_route(
        k, no_casts):
    """``block_sweep`` (the mesh's per-visit route) on bf16 block tables
    and one rank's plan: every visit bit-equal to the cast route of that
    visit, and no cast called."""
    rank = 8
    a, (ou, ov), (U, V), mb = _blocked(k, rank, seed=k + 30)
    p = k - 1
    rpb_u, rpb_v = U.shape[0] // k, V.shape[0] // k
    cells = {x: np.ascontiguousarray(a[x][:, p:p + 1]) for x in a}
    cells["su"] = cells["su"] % rpb_u
    cells["si"] = cells["si"] % rpb_v
    plan = _plan(cells, mb)
    for s in range(k):
        q = (p + s) % k
        Ub = torch.from_numpy(U[p * rpb_u:(p + 1) * rpb_u]).to(torch.bfloat16)
        Vb = torch.from_numpy(V[q * rpb_v:(q + 1) * rpb_v]).to(torch.bfloat16)
        ou_b = ou[p * rpb_u:(p + 1) * rpb_u]
        ov_b = ov[q * rpb_v:(q + 1) * rpb_v]
        want = Ub.clone(), Vb.clone()
        Uw, Vw = want[0].float(), want[1].float()
        tc.stratum_sweep(Uw, Vw, ou_b, ov_b, plan, s, plan.new_work(rank),
                         lr=0.2, lam=0.05)
        want = Uw.to(torch.bfloat16), Vw.to(torch.bfloat16)
        out = tc.block_sweep(Ub, Vb, ou_b, ov_b, plan, s,
                             plan.new_work(rank), lr=0.2, lam=0.05)
        assert out[0] is Ub and out[1] is Vb
        for got, ref in zip((Ub, Vb), want):
            assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


def test_bf16_dsgd_train_cuda_launches_no_cast(no_casts):
    """``dsgd_train_cuda`` on bf16 tables goes through the flagged route
    alone (the cast wrappers refuse every call) and still equals its
    plain twin bit for bit."""
    k, rank = 2, 8
    a, (ou, ov), (U, V), mb = _blocked(k, rank, seed=5)
    t = {x: torch.from_numpy(np.array(a[x])) for x in KEYS}
    Ub, Vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (U, V))
    kw = dict(lr=0.1, lam=0.05, minibatch=mb, num_blocks=k, iterations=2)
    args = (t["su"], t["si"], t["sv"], t["sw"], ou, ov, t["icu"], t["icv"])
    Uc, Vc = tc.dsgd_train_cuda(Ub, Vb, *args, **kw)
    Ur, Vr = tc.dsgd_train_reference(Ub, Vb, *args, **kw)
    assert torch.equal(Uc, Ur) and torch.equal(Vc, Vr)


def test_bf16_bound_counts_each_rows_first_read_and_last_write_at_2_bytes():
    """``StepPlan.bound_bytes(rank, half=True)``: the f32 bound less one
    f32 row (2 B a column read, 2 B written) per distinct row of each
    stratum, on both sides."""
    a, _, _, mb = _blocked(2, 4, seed=9)
    plan, want = _check_flags(a, mb)
    rank = 16
    saved = (sum(want["u_touched"]) + sum(want["v_touched"])) * rank * 4
    assert plan.bound_bytes(rank, half=True) == plan.bound_bytes(rank) - saved
    assert 0 < saved < plan.bound_bytes(rank)
