"""Plain implicit-feedback ALS (iALS: Hu, Koren & Volinsky, "Collaborative
Filtering for Implicit Feedback Datasets", ICDM 2008; Spark MLlib's
``ALS.trainImplicit``) in float64, in plain PyTorch.

A round solves every user row with the item table fixed, then every item
row with the user table fixed. For a row x with partners y_j and strengths
r_j, and Y the whole fixed table:

    (YᵀY + Σ_j α·r_j·y_j y_jᵀ + λ·I) x = Σ_j (1 + α·r_j) y_j,

which is Hu et al.'s normal equation (YᵀC_uY + λI) x = YᵀC_u p(u) with
confidence c = 1 + α·r, preference p = 1 on every pair and 0 elsewhere,
YᵀC_uY = YᵀY + Yᵀ(C_u − I)Y. Every unobserved pair counts with confidence
1 through YᵀY; nothing is sampled. A row with no pairs solves to 0. The
whole-table gram, the weighted row grams, the ridge and a Cholesky solve
run in float64; rows are grouped by their pair count (padded to a power of
two, ``reference/als.py``'s grouping) and solved in chunks of bounded
memory.

Departures from Hu et al., each as the program has it:
- r is a pair's multiplicity in the data (how often the pair occurs), not
  a play count or a watch time; the data carry one entry a pair;
- the start is the item table's keyed rows (``reference/keyed.py``, scale
  ``init_scale``), 0 for items without pairs, not random Gaussian rows;
- a fixed number of rounds, no test of convergence;
- the ridge is Hu et al.'s λ·I; MLlib's ``trainImplicit`` scales λ by the
  row's pair count (the program's ``reg_mode`` ``als_wr``), not taken.
"""

from __future__ import annotations

import torch

from portbench.reference.als import _Side
from portbench.reference.keyed import keyed_rows

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_CHUNK_BYTES = 1 << 30


class _ImplicitSide(_Side):
    """One side's pairs grouped by row, solved as iALS half-steps."""

    def solve(self, fixed: torch.Tensor, lam: float, alpha: float,
              full_gram: bool = True) -> torch.Tensor:
        """The half-step with ``fixed`` (f64) held; ``full_gram`` False
        leaves YᵀY out (a fault the check must catch)."""
        k = fixed.shape[-1]
        dev = fixed.device
        out = torch.zeros((self.num_rows, k), dtype=torch.float64,
                          device=dev)
        base = lam * torch.eye(k, dtype=torch.float64, device=dev)
        if full_gram:
            base = base + fixed.T @ fixed
        for pad, rows in self.classes:
            # the gathered rows and their weighted copy, A and its factor
            per_row = 8 * (2 * pad * k + 3 * k * k)
            step = max(1, _CHUNK_BYTES // per_row)
            j = torch.arange(pad, device=dev)
            for a in range(0, rows.shape[0], step):
                rr = rows[a:a + step]
                cnt = self.counts[rr]
                pos = self.starts[rr][:, None] + j[None, :]
                live = j[None, :] < cnt[:, None]
                pos = torch.where(live, pos, 0)
                Y = fixed[self.other[pos]] * live[..., None]
                r = self.vals[pos] * live
                Yw = Y * (alpha * r)[..., None]
                A = torch.bmm(Yw.transpose(1, 2), Y) + base
                b = torch.bmm(Y.transpose(1, 2), (live + alpha * r)[..., None])
                L = torch.linalg.cholesky(A)
                out[rr] = torch.cholesky_solve(b, L)[..., 0]
        return out


def fit(u, i, r, num_users: int, num_items: int, rank: int, *, lam: float,
        alpha: float, rounds: int, init_scale: float,
        full_gram: bool = True):
    """``rounds`` iALS rounds from the keyed start on pairs ``(u, i)`` of
    strength ``r`` (one entry a pair). Returns f32 ``U``, ``V`` and the
    pair counts of users and items."""
    users = _ImplicitSide(u, i, r, num_users)
    items = _ImplicitSide(i, u, r, num_items)
    V = keyed_rows(torch.arange(num_items, device=u.device), rank,
                   init_scale).double()
    V = V * (items.counts > 0)[:, None]
    # the program's f32 constants, widened
    lam = float(torch.tensor(lam, dtype=torch.float32))
    alpha = float(torch.tensor(alpha, dtype=torch.float32))
    U = None
    for _ in range(rounds):
        U = users.solve(V, lam, alpha, full_gram)
        V = items.solve(U, lam, alpha, full_gram)
    return U.float(), V.float(), users.counts, items.counts
