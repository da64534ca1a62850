"""Plain ALS with direct regularization, in plain PyTorch.

A round solves every user row with the item table fixed, then every item
row with the user table fixed: for a row x with ratings r_j of the other
side's rows y_j,

    (Σ_j y_j y_jᵀ + λ·I) x = Σ_j r_j y_j,

and a row with no ratings is 0. The start is the item table's keyed rows
(``reference/keyed.py``, scale ``init_scale``), 0 for items without
ratings. Grams, right-hand sides and solves run in float64; rows are
grouped by their rating count (padded to a power of two) and solved in
chunks of bounded memory.
"""

from __future__ import annotations

import torch

from portbench.reference.keyed import keyed_rows

_CHUNK_BYTES = 1 << 30


class _Side:
    """The ratings of one side, grouped by row: rows with ratings in
    classes of equal padded width."""

    def __init__(self, rows, other, vals, num_rows: int):
        order = torch.argsort(rows, stable=True)
        self.other = other[order].to(torch.int64)
        self.vals = vals[order].to(torch.float64)
        counts = torch.bincount(rows.to(torch.int64), minlength=num_rows)
        self.counts = counts
        self.starts = torch.cumsum(counts, 0) - counts
        self.num_rows = num_rows
        present = torch.nonzero(counts > 0).reshape(-1)
        width = torch.ceil(torch.log2(counts[present].double())).long()
        self.classes = []
        for c in torch.unique(width).tolist():
            self.classes.append((1 << int(c), present[width == c]))

    def solve(self, fixed: torch.Tensor, lam: float) -> torch.Tensor:
        k = fixed.shape[-1]
        F = fixed.to(torch.float64)
        out = torch.zeros((self.num_rows, k), dtype=torch.float64,
                          device=fixed.device)
        eye = lam * torch.eye(k, dtype=torch.float64, device=fixed.device)
        for pad, rows in self.classes:
            per_row = pad * k * 8 * 2
            step = max(1, _CHUNK_BYTES // per_row)
            j = torch.arange(pad, device=fixed.device)
            for a in range(0, rows.shape[0], step):
                rr = rows[a:a + step]
                cnt = self.counts[rr]
                pos = self.starts[rr][:, None] + j[None, :]
                live = j[None, :] < cnt[:, None]
                pos = torch.where(live, pos, 0)
                Y = F[self.other[pos]] * live[..., None]
                rv = self.vals[pos] * live
                A = torch.bmm(Y.transpose(1, 2), Y) + eye
                b = torch.bmm(Y.transpose(1, 2), rv[..., None])
                L = torch.linalg.cholesky(A)
                out[rr] = torch.cholesky_solve(b, L)[..., 0]
        return out


def fit(u, i, r, num_users: int, num_items: int, rank: int, *, lam: float,
        rounds: int, init_scale: float):
    """``rounds`` rounds from the keyed start. Returns f32 ``U``, ``V`` and
    the rating counts of users and items."""
    users = _Side(u, i, r, num_users)
    items = _Side(i, u, r, num_items)
    V = keyed_rows(torch.arange(num_items, device=u.device), rank,
                   init_scale).double()
    V = V * (items.counts > 0)[:, None]
    lam = float(torch.tensor(lam, dtype=torch.float32))
    U = None
    for _ in range(rounds):
        U = users.solve(V, lam)
        V = items.solve(U, lam)
    return U.float(), V.float(), users.counts, items.counts
