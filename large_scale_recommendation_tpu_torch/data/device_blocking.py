"""On-device workload generation + DSGD blocking (counterpart of
``large_scale_recommendation_tpu.data.device_blocking``).

The host pass (``data.blocking``) builds the k×k stratum layout in numpy
and ships it to the card. Here the same pass runs in torch on the solver's
device — sort, prefix sum, scatter — so the host never materializes the
``k × k × bmax`` expansion: synthetic workloads move only scalars across
the link, and real dense-id datasets ship the raw COO triple once.

Scope: dense ids in ``[0, num_users) × [0, num_items)``. Arbitrary external
ids go through the host path, which also builds the ``IdIndex`` itself.

Every random step is split in two: a draw (``draw_permutations``:
``torch.randperm`` from explicit generators on the device) and a
deterministic transform that takes the permutations. Given the JAX
package's permutations, the layout is bit-equal to the JAX package's
(ties keep their order through stable sorts, counts are integers). Torch's
CPU and CUDA generators give different streams, so ``device_block_problem``
is deterministic per seed and per device type, not across them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.core.initializers import (
    keyed_uniform_rows,
)
from large_scale_recommendation_tpu_torch.data.blocking import IdIndex
from large_scale_recommendation_tpu_torch.data.movielens import _SHAPES
from large_scale_recommendation_tpu_torch.utils.device import resolve_device

# one generator seed per (seed, stream): the counterpart of fold_in
_STREAM_STRIDE = 1_000_003


def _generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * _STREAM_STRIDE + stream) % (1 << 63))


# --------------------------------------------------------------------------
# Synthetic generation (device)
# --------------------------------------------------------------------------


def exp_ids_from_uniform(u: torch.Tensor, lam: float,
                         n_ids: int) -> torch.Tensor:
    """The truncated-exponential inverse CDF of ``truncated_exp_ids`` on
    given f32 uniforms in [0, 1): floor(−log1p(−u·(1−e^{−λ}))/λ · n),
    clipped to n − 1. Low ids are hot. int64 ids."""
    u = u * float(np.float32(1.0 - np.exp(-lam)))
    v = torch.floor(-torch.log1p(-u) / lam * n_ids).to(torch.int64)
    return v.clamp_max(n_ids - 1)


def truncated_exp_ids(gen: torch.Generator, lam: float, n_ids: int,
                      size: int) -> torch.Tensor:
    """Skewed id draw: a discretized exponential truncated to [0, n_ids),
    on ``gen``'s device."""
    u = torch.rand(size, generator=gen, dtype=torch.float32,
                   device=gen.device)
    return exp_ids_from_uniform(u, lam, n_ids)


# Rank-16 gathers of 23.75M rows would take ~1.5 GB each: the row-wise dot
# runs in chunks of this many entries.
_SCORE_CHUNK = 1 << 20


def _planted_scores(Ut, Vt, u, i, chunk: int = _SCORE_CHUNK):
    """Row-wise ⟨Ut[u], Vt[i]⟩ in bounded-memory chunks."""
    out = torch.empty(u.shape[0], dtype=torch.float32, device=u.device)
    for a in range(0, u.shape[0], chunk):
        out[a:a + chunk] = (Ut[u[a:a + chunk]]
                            * Vt[i[a:a + chunk]]).sum(dim=-1)
    return out


def _planted_batch(seed: int, batch: int, Ut, Vt, n: int, noise: float,
                   skew_lam: float | None):
    """One batch of planted-low-rank ratings on Ut's device; ``batch``
    selects its id/noise streams (100·batch + 1..3, apart from the
    factors' streams 1, 2 and the blocking's 10..12)."""
    dev = Ut.device
    nu, ni = Ut.shape[0], Vt.shape[0]
    g_u, g_i, g_r = (_generator(seed, 100 * batch + j, dev)
                     for j in range(1, 4))
    if skew_lam is not None:
        u = truncated_exp_ids(g_u, skew_lam, nu, n)
        i = truncated_exp_ids(g_i, skew_lam, ni, n)
    else:
        u = torch.randint(0, nu, (n,), generator=g_u, device=dev)
        i = torch.randint(0, ni, (n,), generator=g_i, device=dev)
    r = _planted_scores(Ut, Vt, u, i)
    r += noise * torch.randn(n, generator=g_r, dtype=torch.float32,
                             device=dev)
    return u, i, r


def synthetic_like_device(
    name: str,
    nnz: int | None = None,
    rank: int = 16,
    noise: float = 0.3,
    seed: int = 0,
    skew_lam: float | None = 2.0,
    num_users: int | None = None,
    num_items: int | None = None,
    device=None,
):
    """Device-resident ``synthetic_like``: planted-low-rank train/holdout
    batches with the named dataset's shape, split 95/5 by volume.

    Returns ``((u, i, r), (hu, hi, hr), (num_users, num_items))``: int64
    ids and float32 ratings on ``device`` (``None`` = the card)."""
    if name not in _SHAPES:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(_SHAPES)}")
    dev = resolve_device(device)
    nu, ni, n_default = _SHAPES[name]
    nu = int(num_users) if num_users is not None else nu
    ni = int(num_items) if num_items is not None else ni
    n = int(nnz if nnz is not None else n_default)
    n_train = int(n * 0.95)
    scale = float(1.0 / np.sqrt(rank))
    Ut = scale * torch.randn((nu, rank), generator=_generator(seed, 1, dev),
                             device=dev)
    Vt = scale * torch.randn((ni, rank), generator=_generator(seed, 2, dev),
                             device=dev)
    train = _planted_batch(seed, 1, Ut, Vt, n_train, noise, skew_lam)
    hold = _planted_batch(seed, 2, Ut, Vt, n - n_train, noise, skew_lam)
    return train, hold, (nu, ni)


# --------------------------------------------------------------------------
# Blocking (device)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceBlockedProblem:
    """Stratum-major blocked problem on one device: entry ``[s, p, :]`` is
    rating block ``(p, (p+s) mod k)``, in the positional layout of
    ``ops.sgd.dsgd_train``."""

    su: torch.Tensor  # int32[k, k, bmax] global user rows
    si: torch.Tensor  # int32[k, k, bmax] global item rows
    sv: torch.Tensor  # float32[k, k, bmax]
    sw: torch.Tensor  # float32[k, k, bmax] 1=real 0=pad
    icu: torch.Tensor  # float32[k, k, bmax] 1/minibatch occurrence (users)
    icv: torch.Tensor  # float32[k, k, bmax] (items)
    omega_u: torch.Tensor  # float32[num_user_rows] occurrence counts
    omega_v: torch.Tensor  # float32[num_item_rows]
    row_of_user: torch.Tensor  # int32[num_users] dense id → global row
    row_of_item: torch.Tensor  # int32[num_items]
    id_of_user_row: torch.Tensor  # int32[num_user_rows]; 0 on padding rows
    id_of_item_row: torch.Tensor  # int32[num_item_rows]
    num_blocks: int
    rows_per_block_u: int
    rows_per_block_v: int
    nnz: int
    max_pad_ratio: float
    # the minibatch icu/icv were computed for; "mean"-collision training
    # must use this same minibatch
    minibatch: int

    def to(self, device) -> "DeviceBlockedProblem":
        """The same layout with its tensors on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def to_id_indices(self) -> tuple[IdIndex, IdIndex]:
        """The host ``IdIndex`` pair of this layout (ids seen in training
        only, as on the host path: unseen dense ids stay unknown)."""

        def side(row_of, omega, rpb):
            rows = row_of.cpu().numpy().astype(np.int64)
            om = omega.cpu().numpy()
            all_ids = np.arange(rows.shape[0], dtype=np.int64)
            present = om[rows] > 0
            ids = np.full(om.shape[0], -1, np.int64)
            ids[rows[present]] = all_ids[present]
            return IdIndex(ids=ids, num_blocks=self.num_blocks,
                           rows_per_block=rpb, omega=om,
                           sorted_ids=all_ids[present],
                           sorted_rows=rows[present])

        return (side(self.row_of_user, self.omega_u, self.rows_per_block_u),
                side(self.row_of_item, self.omega_v, self.rows_per_block_v))

    def holdout_rows(self, hu: torch.Tensor, hi: torch.Tensor):
        """Holdout ids → (user rows, item rows, f32 mask); ids absent from
        training are masked out, as ``IdIndex.rows_for`` does."""
        ur = self.row_of_user[hu.long()].long()
        ir = self.row_of_item[hi.long()].long()
        mask = ((self.omega_u[ur] > 0) & (self.omega_v[ir] > 0)).to(
            torch.float32)
        return ur, ir, mask


def validate_dense_ids(u, i, num_users: int, num_items: int,
                       ctx: str) -> None:
    """Fail on out-of-range ids before any int32 cast (a wild int64 id
    would otherwise wrap into a plausible small one). Host arrays reduce
    on the host in their own dtype; device tensors in one reduction and
    one device→host read per side."""

    def rng(a):
        if isinstance(a, torch.Tensor):
            lo, hi = torch.stack([a.min(), a.max()]).cpu().tolist()
            return int(lo), int(hi)
        a = np.asarray(a)
        return int(a.min()), int(a.max())

    lo_u, hi_u = rng(u)
    lo_i, hi_i = rng(i)
    if lo_u < 0 or hi_u >= num_users or lo_i < 0 or hi_i >= num_items:
        raise ValueError(
            f"{ctx} needs dense ids in [0, num_users) × [0, num_items); "
            f"got user range [{lo_u}, {hi_u}] vs {num_users}, item range "
            f"[{lo_i}, {hi_i}] vs {num_items}. Arbitrary external ids go "
            "through the host path (data.blocking).")


def rows_per_block(n_ids: int, num_blocks: int, row_multiple: int = 8) -> int:
    """Rows per block for a dense vocab dealt over ``num_blocks``, padded
    up to ``row_multiple``."""
    rpb = max(-(-n_ids // num_blocks), 1)
    return -(-rpb // row_multiple) * row_multiple


def _weighted_counts(u, i, w, num_users: int, num_items: int):
    """Exact per-id occurrence counts in int64 (an f32 count stalls at
    2^24); a weight-0 entry is padding and counts 0."""
    real = (w > 0).to(torch.int64)
    cu = torch.zeros(num_users, dtype=torch.int64, device=u.device)
    cv = torch.zeros(num_items, dtype=torch.int64, device=u.device)
    return cu.index_add_(0, u, real), cv.index_add_(0, i, real)


def draw_permutations(seed: int, num_users: int, num_items: int, n: int,
                      device) -> tuple[torch.Tensor, ...]:
    """The blocking's random draws: permutations of the users, the items
    and the entries, from generators on ``device``."""
    return tuple(
        torch.randperm(m, generator=_generator(seed, 10 + j, device),
                       device=device)
        for j, m in enumerate((num_users, num_items, n)))


def _assign_rows(perm, counts, k: int, rpb: int, num_rows: int):
    """Balanced block/row assignment for one side: ids in ``perm`` order,
    then a stable sort by descending count (ties stay in random order),
    dealt serpentine over the k blocks (hottest first) so per-block nnz
    stays near-equal on power-law data."""
    dev = counts.device
    n_ids = counts.shape[0]
    order = perm[torch.argsort(-counts[perm], stable=True)]
    ar = torch.arange(n_ids, dtype=torch.int64, device=dev)
    rnd, pos = ar // k, ar % k
    block = torch.where(rnd % 2 == 0, pos, k - 1 - pos)
    row_of_id = torch.empty(n_ids, dtype=torch.int64, device=dev)
    row_of_id[order] = block * rpb + rnd
    omega = torch.zeros(num_rows, dtype=torch.float32, device=dev)
    omega[row_of_id] = counts.to(torch.float32)
    id_of_row = torch.zeros(num_rows, dtype=torch.int32, device=dev)
    id_of_row[row_of_id] = ar.to(torch.int32)
    return row_of_id.to(torch.int32), omega, id_of_row


def _bucket_entries(perm, u, i, r, w, row_of_u, row_of_i, k: int,
                    rpb_u: int, rpb_v: int):
    """Entries → (stratum, user-block) buckets, made contiguous with random
    within-bucket order (``perm`` order, then a stable bucket sort).
    Weight-0 padding entries keep their slots and carry w=0."""
    urow = row_of_u[u]
    irow = row_of_i[i]
    strat = (irow // rpb_v - urow // rpb_u) % k
    flat = (strat * k + urow // rpb_u).to(torch.int64)
    # padding entries are spread round-robin over all buckets: their ids
    # are 0, so they would otherwise pile into one bucket and inflate bmax
    n = flat.shape[0]
    flat = torch.where(w > 0, flat,
                       torch.arange(n, device=flat.device) % (k * k))
    sizes = torch.bincount(flat, minlength=k * k)
    order = perm[torch.argsort(flat[perm], stable=True)]
    return (sizes, flat[order], urow[order], irow[order],
            r.to(torch.float32)[order], w.to(torch.float32)[order])


def _inv_counts_2d(rows, w, presorted: bool = False):
    """Per-entry 1/(weight-sum of its row within its minibatch), one
    minibatch per row of ``rows``: sort each minibatch by row, find each
    run's weighted size with two cummax passes and a cumsum difference,
    and un-sort. Padding (weight 0) adds nothing. ``presorted``: every
    minibatch is already ascending, so the sort and un-sort drop out
    (bit-equal result)."""
    mb = rows.shape[-1]
    j = torch.arange(mb, device=rows.device)[None, :]
    if presorted:
        sr, sw = rows, w
    else:
        sidx = torch.argsort(rows, dim=-1, stable=True)
        sr = torch.gather(rows, 1, sidx)
        sw = torch.gather(w, 1, sidx)
    diff = sr[:, 1:] != sr[:, :-1]
    ones = torch.ones_like(sr[:, :1], dtype=torch.bool)
    new = torch.cat([ones, diff], dim=-1)  # run starts
    last = torch.cat([diff, ones], dim=-1)  # run ends
    start = torch.cummax(torch.where(new, j, -1), dim=1).values
    end_rev = torch.cummax(torch.where(last, mb - 1 - j, -1).flip(1),
                           dim=1).values.flip(1)
    end = mb - 1 - end_rev
    cumw = torch.cumsum(sw, dim=-1)
    W = (torch.gather(cumw, 1, end) - torch.gather(cumw, 1, start)
         + torch.gather(sw, 1, start))
    inv_sorted = 1.0 / torch.clamp_min(W, 1.0)
    if presorted:
        return inv_sorted
    return torch.empty_like(inv_sorted).scatter_(1, sidx, inv_sorted)


def _layout(flat_s, urow_s, irow_s, vals_s, w_s, sizes, k: int, bmax: int,
            mb: int, sort_side: str | None):
    """Scatter bucket-sorted entries into the padded [k, k, bmax] layout
    and compute both sides' per-minibatch collision scales."""
    dev = flat_s.device
    n = flat_s.shape[0]
    starts = torch.cumsum(sizes, 0) - sizes
    dest = flat_s * bmax + (torch.arange(n, device=dev) - starts[flat_s])
    total = k * k * bmax

    def scatter(vals, dtype):
        out = torch.zeros(total, dtype=dtype, device=dev)
        out[dest] = vals.to(dtype)
        return out.view(-1, mb)

    su, si = scatter(urow_s, torch.int32), scatter(irow_s, torch.int32)
    sv, sw = scatter(vals_s, torch.float32), scatter(w_s, torch.float32)
    if sort_side is not None:
        # intra-minibatch locality sort: membership unchanged
        order = torch.argsort(su if sort_side == "user" else si, dim=-1,
                              stable=True)
        su, si, sv, sw = (torch.gather(a, 1, order)
                          for a in (su, si, sv, sw))
    icu = _inv_counts_2d(su, sw, presorted=sort_side == "user")
    icv = _inv_counts_2d(si, sw, presorted=sort_side == "item")
    shape = (k, k, bmax)
    return tuple(a.reshape(shape) for a in (su, si, sv, sw, icu, icv))


def device_block_problem(
    u,
    i,
    r,
    num_users: int,
    num_items: int,
    num_blocks: int,
    minibatch_multiple: int = 1,
    seed: int = 0,
    row_multiple: int = 8,
    minibatch_sort: str | None = None,
    weights=None,
    device=None,
    perms: tuple | None = None,
) -> DeviceBlockedProblem:
    """The whole blocking pass over dense-id COO arrays (numpy or
    tensors), on ``device`` (``None`` = the card). The one device→host
    read is the k² bucket-size vector, which fixes the padded block size.

    ``weights`` marks weight-0 entries as padding: they keep layout slots
    but add nothing to counts, omegas, collision scales or training.
    ``perms`` replaces the draws of ``draw_permutations`` (users, items,
    entries) with given permutations."""
    if minibatch_sort not in (None, "user", "item"):
        raise ValueError(
            f"minibatch_sort must be None|'user'|'item', got {minibatch_sort!r}")
    k = num_blocks
    if np.shape(u)[0] == 0:
        raise ValueError("device_block_problem: empty ratings input")
    validate_dense_ids(u, i, num_users, num_items, "device_block_problem")
    dev = resolve_device(device)

    def put(a, dtype):
        # host arrays are copied (they may be read-only views)
        a = a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a))
        return a.to(device=dev, dtype=dtype)

    u, i = put(u, torch.int64), put(i, torch.int64)
    r = put(r, torch.float32)
    w = (torch.ones(u.shape[0], dtype=torch.float32, device=dev)
         if weights is None else put(weights, torch.float32))
    if perms is None:
        perms = draw_permutations(seed, num_users, num_items, u.shape[0],
                                  dev)
    perm_u, perm_i, perm_e = (put(p, torch.int64) for p in perms)

    rpb_u = rows_per_block(num_users, k, row_multiple)
    rpb_v = rows_per_block(num_items, k, row_multiple)
    counts_u, counts_v = _weighted_counts(u, i, w, num_users, num_items)
    row_of_u, omega_u, id_of_ur = _assign_rows(perm_u, counts_u, k, rpb_u,
                                               k * rpb_u)
    row_of_i, omega_v, id_of_ir = _assign_rows(perm_i, counts_v, k, rpb_v,
                                               k * rpb_v)
    sizes, flat_s, urow_s, irow_s, vals_s, w_s = _bucket_entries(
        perm_e, u, i, r, w, row_of_u.long(), row_of_i.long(), k, rpb_u,
        rpb_v)

    sizes_host = sizes.cpu()  # the one device→host read
    mbm = max(minibatch_multiple, 1)
    bmax = -(-max(int(sizes_host.max()), 1) // mbm) * mbm
    su, si, sv, sw, icu, icv = _layout(flat_s, urow_s, irow_s, vals_s, w_s,
                                       sizes, k, bmax, mbm, minibatch_sort)
    nnz = (int(sizes_host.sum()) if weights is None
           else int((w > 0).sum()))
    return DeviceBlockedProblem(
        su=su, si=si, sv=sv, sw=sw, icu=icu, icv=icv,
        omega_u=omega_u, omega_v=omega_v,
        row_of_user=row_of_u, row_of_item=row_of_i,
        id_of_user_row=id_of_ur, id_of_item_row=id_of_ir,
        num_blocks=k, rows_per_block_u=rpb_u, rows_per_block_v=rpb_v,
        nnz=nnz, max_pad_ratio=(k * k * bmax) / max(nnz, 1),
        minibatch=mbm)


def recompute_inv_counts(problem: DeviceBlockedProblem, minibatch: int):
    """Collision scales for another kernel minibatch on the same layout
    (any ``minibatch`` dividing the padded block size). Returns
    ``(icu, icv)`` shaped like the problem's."""
    k, bmax = problem.num_blocks, problem.su.shape[-1]
    if bmax % minibatch != 0:
        raise ValueError(
            f"minibatch {minibatch} does not divide padded block size "
            f"{bmax}; rebuild the problem with this minibatch_multiple")
    sw = problem.sw.reshape(-1, minibatch)
    shape = (k, k, bmax)
    return (_inv_counts_2d(problem.su.reshape(-1, minibatch), sw)
            .reshape(shape),
            _inv_counts_2d(problem.si.reshape(-1, minibatch), sw)
            .reshape(shape))


def init_factors_device(problem: DeviceBlockedProblem, rank: int,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-id factor init on the problem's device, through ``id_of_*_row``:
    the same keyed rows as ``PseudoRandomFactorInitializer``, so an id gets
    the same vector as on the host path's table. Padding rows carry id 0's
    vector; no rating reaches them."""
    return (keyed_uniform_rows(problem.id_of_user_row, rank, scale),
            keyed_uniform_rows(problem.id_of_item_row, rank, scale))
