"""Plain DSGD: the Gemulla k×k stratum layout and the λ/ω SGD sweeps, in
plain PyTorch on whatever device the inputs lie on.

The layout is worked out again from the ratings and the seed, as the
DSGD solver defines it: users and items are drawn into a random order
(``torch.randperm`` from generators seeded by ``(seed, 10..12)``), sorted
by falling rating count (ties keep the random order) and dealt serpentine
over the k blocks; the entries go into (stratum, user block) buckets in a
random order, each bucket padded to a whole number of minibatches, and
each minibatch is sorted by item row. A step of stratum s takes minibatch
g of each of its k blocks; the blocks share no row, so a step is one
gather → update → scatter-add over their entries, every read before any
write:

    e      = (r − ⟨u, v⟩)·w
    Δu     = −η_t·(λ/max(ω_u, 1)·u·w − e·v) / c_u
    Δv     = −η_t·(λ/max(ω_v, 1)·v·w − e·u) / c_v

with c the weight of the row's entries in the minibatch (collisions take
the mean) and η_t the ``warm_boost`` schedule (×2.5 for two sweeps).

``step_counts`` is the yardstick of the step pair: for every step, the
distinct rows it reads and writes, and its real ratings.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.generator import generator
from portbench.reference.keyed import keyed_rows


@dataclasses.dataclass
class Layout:
    su: torch.Tensor  # int64[k, k, b] user rows (stratum, block, slot)
    si: torch.Tensor
    sv: torch.Tensor  # float32
    sw: torch.Tensor  # float32 1 = real, 0 = padding
    cu: torch.Tensor  # float32 1 / weight of the row in its minibatch
    cv: torch.Tensor
    omega_u: torch.Tensor  # float32[rows] rating counts by row
    omega_v: torch.Tensor
    row_of_user: torch.Tensor  # int64[num_users]
    row_of_item: torch.Tensor
    id_of_user_row: torch.Tensor  # int64[rows], 0 on padding rows
    id_of_item_row: torch.Tensor
    k: int
    minibatch: int


def _rows_per_block(n: int, k: int, multiple: int = 8) -> int:
    rpb = max(-(-n // k), 1)
    return -(-rpb // multiple) * multiple


def _deal(perm, counts, k: int, rpb: int):
    """Rows of one side: random order, then falling count (stable), dealt
    serpentine over the k blocks."""
    n = counts.shape[0]
    dev = counts.device
    order = perm[torch.argsort(-counts[perm], stable=True)]
    j = torch.arange(n, device=dev)
    rnd, pos = j // k, j % k
    block = torch.where(rnd % 2 == 0, pos, k - 1 - pos)
    row_of = torch.empty(n, dtype=torch.int64, device=dev)
    row_of[order] = block * rpb + rnd
    omega = torch.zeros(k * rpb, dtype=torch.float32, device=dev)
    omega[row_of] = counts.to(torch.float32)
    id_of = torch.zeros(k * rpb, dtype=torch.int64, device=dev)
    id_of[row_of] = j
    return row_of, omega, id_of


def _collision_scales(rows, w, num_rows: int):
    """Per entry 1 / max(weight of its row within its minibatch, 1); one
    minibatch per row of ``rows``."""
    nmb, mb = rows.shape
    key = (torch.arange(nmb, device=rows.device)[:, None] * num_rows
           + rows).reshape(-1)
    _, inv = torch.unique(key, return_inverse=True)
    tot = torch.zeros(int(inv.max()) + 1, dtype=torch.float32,
                      device=rows.device)
    tot.index_add_(0, inv, w.reshape(-1))
    return (1.0 / tot[inv].clamp_min(1.0)).reshape(nmb, mb)


def layout(u, i, r, num_users: int, num_items: int, k: int, minibatch: int,
           seed: int, sort: str | None = "item") -> Layout:
    dev = u.device
    n = u.shape[0]
    u, i = u.to(torch.int64), i.to(torch.int64)
    perm_u, perm_i, perm_e = (
        torch.randperm(m, generator=generator(seed, 10 + j, dev), device=dev)
        for j, m in enumerate((num_users, num_items, n)))
    rpb_u = _rows_per_block(num_users, k)
    rpb_v = _rows_per_block(num_items, k)
    cnt_u = torch.bincount(u, minlength=num_users)
    cnt_v = torch.bincount(i, minlength=num_items)
    row_u, om_u, id_u = _deal(perm_u, cnt_u, k, rpb_u)
    row_v, om_v, id_v = _deal(perm_i, cnt_v, k, rpb_v)
    ur, ir = row_u[u], row_v[i]
    bucket = ((ir // rpb_v - ur // rpb_u) % k) * k + ur // rpb_u
    sizes = torch.bincount(bucket, minlength=k * k)
    order = perm_e[torch.argsort(bucket[perm_e], stable=True)]
    bmax = -(-int(sizes.max()) // minibatch) * minibatch
    starts = torch.cumsum(sizes, 0) - sizes
    b_s = bucket[order]
    dest = b_s * bmax + (torch.arange(n, device=dev) - starts[b_s])

    def place(vals, dtype):
        out = torch.zeros(k * k * bmax, dtype=dtype, device=dev)
        out[dest] = vals.to(dtype)
        return out.view(-1, minibatch)

    su, si = place(ur[order], torch.int64), place(ir[order], torch.int64)
    sv = place(r[order], torch.float32)
    sw = place(torch.ones(n, device=dev), torch.float32)
    del order, dest, b_s, bucket, ur, ir
    if sort is not None:
        by = torch.argsort(si if sort == "item" else su, dim=-1, stable=True)
        su, si, sv, sw = (torch.gather(a, 1, by) for a in (su, si, sv, sw))
    cu = _collision_scales(su, sw, k * rpb_u)
    cv = _collision_scales(si, sw, k * rpb_v)
    shape = (k, k, bmax)
    return Layout(*(a.reshape(shape) for a in (su, si, sv, sw, cu, cv)),
                  omega_u=om_u, omega_v=om_v, row_of_user=row_u,
                  row_of_item=row_v, id_of_user_row=id_u,
                  id_of_item_row=id_v, k=k, minibatch=minibatch)


def warm_boost(lr: float, t: int, factor: float = 2.5, steps: int = 2):
    f32 = np.float32
    return float(f32(factor) * f32(lr) if t <= steps else f32(lr))


def train(lay: Layout, rank: int, *, lr: float, lam: float, sweeps: int,
          init_scale: float, dtype=torch.float32):
    """The sweeps from the keyed initial rows. ``dtype`` is the tables'
    storage: each step computes in f32 and stores in ``dtype`` (the
    control's bf16 rounds every written row)."""
    U = keyed_rows(lay.id_of_user_row, rank, init_scale).to(dtype)
    V = keyed_rows(lay.id_of_item_row, rank, init_scale).to(dtype)
    k, mb = lay.k, lay.minibatch
    steps = lay.su.shape[-1] // mb
    lam = float(np.float32(lam))
    for t in range(1, sweeps + 1):
        eta = warm_boost(lr, t)
        for s in range(k):
            for g in range(steps):
                sl = (s, slice(None), slice(g * mb, (g + 1) * mb))
                ur, ir = lay.su[sl].reshape(-1), lay.si[sl].reshape(-1)
                r, w = lay.sv[sl].reshape(-1), lay.sw[sl].reshape(-1)
                cu, cv = lay.cu[sl].reshape(-1), lay.cv[sl].reshape(-1)
                u, v = U[ur].float(), V[ir].float()
                e = (r - (u * v).sum(-1)) * w
                reg_u = (lam / lay.omega_u[ur].clamp_min(1.0)
                         * w)[:, None] * u
                reg_v = (lam / lay.omega_v[ir].clamp_min(1.0)
                         * w)[:, None] * v
                du = -eta * (reg_u - e[:, None] * v) * cu[:, None]
                dv = -eta * (reg_v - e[:, None] * u) * cv[:, None]
                if dtype == torch.float32:
                    U.index_add_(0, ur, du)
                    V.index_add_(0, ir, dv)
                else:
                    Uf, Vf = U.float(), V.float()
                    Uf.index_add_(0, ur, du)
                    Vf.index_add_(0, ir, dv)
                    U, V = Uf.to(dtype), Vf.to(dtype)
    return U.float(), V.float()


def step_counts(lay: Layout):
    """For every step (stratum s, minibatch g over the k blocks), in
    order: distinct real user rows, distinct real item rows, real
    ratings. Three int64 tensors of length k · b / minibatch."""
    k, mb = lay.k, lay.minibatch
    steps = lay.su.shape[-1] // mb
    step = torch.arange(k * steps, device=lay.su.device).view(k, 1, steps, 1)
    step = step.expand(k, k, steps, mb).reshape(-1)
    real = lay.sw.reshape(-1) > 0
    step = step[real]
    n_steps = k * steps
    out = []
    for rows, width in ((lay.su, lay.omega_u.shape[0]),
                        (lay.si, lay.omega_v.shape[0])):
        key = torch.unique(step * width + rows.reshape(-1)[real])
        out.append(torch.bincount(key // width, minlength=n_steps))
    out.append(torch.bincount(step, minlength=n_steps))
    return tuple(out)
