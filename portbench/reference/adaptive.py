"""Plain adaptive matrix factorization: online SGD on every micro-batch,
and every few batches a from-scratch DSGD retrain over the history whose
rows replace the live tables' rows, in plain PyTorch on whatever device
the inputs lie on.

The model of ``OnlineSpark.buildModelCombineOffline``
(``OnlineSpark.scala:26-162``: ``ratingsHistory ∪= rs``, the online
update, every ``offlineEvery`` batches a full DSGD retrain and a wholesale
swap), composed of ``reference/online.py`` (the online step),
``reference/dsgd.py`` (the retrain) and a plain install. Departures from
it, each the deployment's:

- the history is a sliding window of the newest ``history_limit`` ratings,
  in arrival order; upstream keeps every rating;
- ids are dense rows, numbered in the order the stream first shows them
  (``first_seen_rows``); the retrain runs on those rows, and its initial
  rows are keyed by the row (``reference/keyed.py``), where upstream draws
  them at random by id;
- the retrain is ``reference/dsgd.py``'s: λ/ω regularization, the
  ``warm_boost`` schedule, the k×k strata dealt from the seed, minibatches
  with the mean collision rule; upstream's DSGD sweeps a stratum one
  rating at a time;
- the swap replaces the rows of the window's ids; a registered id that has
  no rating in the window keeps its online row (upstream's history holds
  every id, so it replaces the whole model);
- the stream waits for the retrain, as upstream's DStream fold does.

Tables are float32, with TF32 off: every product is an f32 one.
"""

from __future__ import annotations

import torch

from portbench.reference import dsgd as ref_dsgd
from portbench.reference.online import OnlineSGD

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def first_seen_rows(ids: torch.Tensor, num_ids: int):
    """Rows of ``ids`` numbered in the order they first occur:
    ``(row_of_id, id_of_row)``, int64, ``row_of_id`` −1 where an id never
    occurs."""
    n = ids.shape[0]
    pos = torch.arange(n, device=ids.device)
    first = torch.full((num_ids,), n, dtype=torch.int64, device=ids.device)
    first.scatter_reduce_(0, ids, pos, reduce="amin")
    seen = torch.nonzero(first < n).reshape(-1)
    id_of_row = seen[torch.argsort(first[seen])]
    row_of_id = torch.full((num_ids,), -1, dtype=torch.int64,
                           device=ids.device)
    row_of_id[id_of_row] = torch.arange(id_of_row.shape[0],
                                        device=ids.device)
    return row_of_id, id_of_row


def retrain(u, i, r, num_users: int, num_items: int, dsgd: dict,
            seed: int):
    """The from-scratch DSGD fit of one window (rows as dense ids, in
    arrival order) with a configuration's ``dsgd`` block: its layout and
    its ``(U, V)`` in the layout's rows."""
    lay = ref_dsgd.layout(u, i, r, num_users, num_items, dsgd["num_blocks"],
                          dsgd["minibatch_size"], seed,
                          sort=dsgd.get("minibatch_sort"))
    U, V = ref_dsgd.train(lay, dsgd["num_factors"],
                          lr=dsgd["learning_rate"], lam=dsgd["lambda_"],
                          sweeps=dsgd["iterations"],
                          init_scale=dsgd["init_scale"])
    return lay, U, V


def window_rows(lay: ref_dsgd.Layout, side: str) -> torch.Tensor:
    """The dense ids of one side that have a rating in the layout's
    window, ascending."""
    row_of, omega = ((lay.row_of_user, lay.omega_u) if side == "users"
                     else (lay.row_of_item, lay.omega_v))
    return torch.nonzero(omega[row_of] > 0).reshape(-1)


def install(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
            trained: torch.Tensor) -> torch.Tensor:
    """A new table: ``table`` with the row of each of ``ids`` replaced by
    ``trained[rows]``; every other row kept."""
    out = table.clone()
    out[ids] = trained[rows].to(out.dtype)
    return out


def online_from(U: torch.Tensor, V: torch.Tensor, *, lr: float,
                minibatch: int) -> OnlineSGD:
    """The plain online SGD starting from the given tables (copies)."""
    ref = OnlineSGD(U.shape[0], V.shape[0], U.shape[1], lr=lr,
                    minibatch=minibatch, init_scale=0.0, device=U.device)
    ref.U, ref.V = U.float().clone(), V.float().clone()
    return ref
