"""Plain two-stage retrieval with exclusions, and the recall of served
answers against the exact top-K.

The semantics of the port's flat int8 score-then-rescore path, written
again in plain torch from its description (nothing of the program is
imported):

- stage 1: each row of the query and item tables quantized to int8 by a
  symmetric scale of its own (``scale = max|row| · f32(1/127)`` in f32,
  1 for an all-zero row; ``code = round(x / scale)``, half to even, clipped
  to ±127); the integer products of the codes, exact in float64 (every
  partial sum is an integer below 2⁵³), times both scales; the user's
  training items removed; the best ``k · overfetch`` kept as candidates;
- stage 2: the candidates rescored exactly in float64, the training items
  removed again, the best ``k``.

Departures from the program, none of which moves an answer away from a
near-tie:

- the scales multiply in float64, where the program multiplies f32 scales
  in f32 and then the f32 score: a candidate can differ where two stage-1
  scores lie within f32 rounding of each other at the ``k · overfetch``-th
  place;
- the rescore is float64, where the program's is IEEE f32 (no TF32), and
  is the exact score of the candidate (gathered from the exact product);
- an excluded item is removed (−inf), where the program gives it its dead
  slot's score: the two differ only where fewer than ``k`` items survive,
  which no cell's user comes near;
- every item is real, so no item weight is added (the program adds its
  weight of 0);
- ties are broken by ``torch.topk``'s choice, not by the lower index.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.topk import _exclusions

_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def quantize(X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 codes of ``X`` (as float64) and their scales
    (float64 of the f32 scale)."""
    X = X.float()
    amax = X.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax * _INV_127.to(X.device),
                        torch.ones_like(amax))
    q = torch.round(X / scale[:, None]).clamp_(-127, 127)
    return q.double(), scale.double()


def exact_scores(U_rows, V, rows, cols) -> torch.Tensor:
    """Float64 scores of every item for each query row, the excluded
    ``(row, item)`` pairs at −inf."""
    _no_tf32()
    s = U_rows.double() @ V.double().T
    s[rows, cols] = -math.inf
    return s


def two_stage(U_rows, V, exact, rows, cols, k: int, overfetch: int,
              codes=None):
    """The plain two-stage answer of each query row: ``(candidates int64
    [b, kc], ids int64 [b, k], scores float64 [b, k])`` with ``kc =
    min(k · overfetch, n)``. ``exact`` is ``exact_scores`` of the same
    rows; ``codes`` the catalog's ``quantize(V)`` (worked out if absent)."""
    _no_tf32()
    qV, sV = quantize(V) if codes is None else codes
    qU, sU = quantize(U_rows)
    s1 = (qU @ qV.T) * (sU[:, None] * sV[None, :])
    s1[rows, cols] = -math.inf
    kc = min(k * overfetch, V.shape[0])
    cand = torch.topk(s1, kc, dim=1).indices
    del s1
    best = torch.topk(exact.gather(1, cand), k, dim=1)
    return cand, cand.gather(1, best.indices), best.values


def _hits(top: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Per row, how many of ``ids`` (−1: missing) lie in ``top``."""
    member = torch.zeros((top.shape[0], n + 1), dtype=torch.bool,
                         device=top.device)
    member.scatter_(1, top, True)
    ids = torch.where(ids >= 0, ids, n)
    return member.gather(1, ids).sum(dim=1)


def recalls(U, V, train_u, train_i, users, ids, k: int, overfetch: int,
            block: int = 128) -> tuple[float, float]:
    """Mean recall@k against the exact float64 top-k of each user in
    ``users`` (int64 [m]), less its training items, of the program's
    answers ``ids`` (int64 [m, k]) and of the plain two-stage answer:
    ``(program, reference)``; ``(nan, nan)`` for no user."""
    m = users.shape[0]
    if m == 0:
        return math.nan, math.nan
    dev, n = U.device, V.shape[0]
    order = torch.argsort(train_u, stable=True)
    tu, ti = train_u[order], train_i[order]
    starts = torch.searchsorted(
        tu, torch.arange(U.shape[0] + 1, device=dev, dtype=tu.dtype))
    codes = quantize(V)
    got = ref = 0.0
    for a in range(0, m, block):
        ub = users[a:a + block]
        r, c = _exclusions(starts, ti, ub)
        exact = exact_scores(U[ub], V, r, c)
        top = torch.topk(exact, k, dim=1).indices
        _, ref_ids, _ = two_stage(U[ub], V, exact, r, c, k, overfetch,
                                  codes=codes)
        del exact
        got += float(_hits(top, ids[a:a + block], n).sum())
        ref += float(_hits(top, ref_ids, n).sum())
    return got / (m * k), ref / (m * k)
