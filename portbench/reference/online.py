"""Plain online matrix factorization: micro-batches in arrival order, each
swept once in minibatches of consecutive ratings, with unregularized SGD
and collisions taken as the mean.

Tables are indexed by id. A row starts as its id's keyed row
(``reference/keyed.py``) the first time its id arrives, so the whole table
can start that way: a row no rating reached is never compared. One
minibatch, every read before any write:

    e  = r − ⟨u, v⟩;   Δu = η·e·v / c_u;   Δv = η·e·u / c_v

with c the number of the row's ratings in the minibatch.
"""

from __future__ import annotations

import torch

from portbench.reference.keyed import keyed_rows


class OnlineSGD:
    def __init__(self, num_users: int, num_items: int, rank: int, *,
                 lr: float, minibatch: int, init_scale: float, device,
                 dtype=torch.float32):
        self.U = keyed_rows(torch.arange(num_users, device=device), rank,
                            init_scale).to(dtype)
        self.V = keyed_rows(torch.arange(num_items, device=device), rank,
                            init_scale).to(dtype)
        self.lr = float(torch.tensor(lr, dtype=torch.float32))
        self.minibatch = minibatch
        self.dtype = dtype

    def batch(self, u, i, r) -> None:
        """Apply one micro-batch (int64 ids and f32 ratings on the tables'
        device)."""
        nu, ni = self.U.shape[0], self.V.shape[0]
        for a in range(0, u.shape[0], self.minibatch):
            uu, ii = u[a:a + self.minibatch], i[a:a + self.minibatch]
            rr = r[a:a + self.minibatch]
            x, y = self.U[uu].float(), self.V[ii].float()
            e = rr - (x * y).sum(-1)
            cu = torch.bincount(uu, minlength=nu)[uu].float()
            cv = torch.bincount(ii, minlength=ni)[ii].float()
            du = (self.lr * e)[:, None] * y / cu[:, None]
            dv = (self.lr * e)[:, None] * x / cv[:, None]
            if self.dtype == torch.float32:
                self.U.index_add_(0, uu, du)
                self.V.index_add_(0, ii, dv)
            else:
                U, V = self.U.float(), self.V.float()
                U.index_add_(0, uu, du)
                V.index_add_(0, ii, dv)
                self.U, self.V = U.to(self.dtype), V.to(self.dtype)
