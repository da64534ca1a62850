"""Plain exact top-K with exclusions, and the serving cell's inputs.

``factors`` draws the catalog's tables from the seed. ``topk_gaps`` scores
every user of a sample against the whole catalog in float64, removes each
user's training items (worked out again from the raw training pairs, a
CSR by user), keeps the best ``k`` and judges the program's answers for
the same users by three numbers:

- ``bad``: answer slots that are missing (id −1), an excluded item, or an
  id repeated in its row;
- ``rank``: the widest gap by which the reference's score of the item
  served at position j lies below the reference's j-th best;
- ``score``: the widest gap between a served score and the reference's
  score of that item.

Both gaps are shares of the sample's largest best score.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.generator import generator


def factors(seed: int, num_users: int, num_items: int, rank: int, device):
    """User and item tables, entries N(0, rank^-1/2): scores of unit
    variance. Streams 7 and 8 of the seed, apart from the ratings'."""
    sd = float(rank ** -0.25)
    U = sd * torch.randn((num_users, rank),
                         generator=generator(seed, 7, device), device=device)
    V = sd * torch.randn((num_items, rank),
                         generator=generator(seed, 8, device), device=device)
    return U, V


def _exclusions(starts, items, users):
    """(row in block, item) of every training pair of ``users``."""
    counts = starts[users + 1] - starts[users]
    rows = torch.repeat_interleave(
        torch.arange(users.shape[0], device=users.device), counts)
    before = torch.cumsum(counts, 0) - counts
    offs = torch.repeat_interleave(starts[users] - before, counts)
    return rows, items[torch.arange(rows.shape[0], device=users.device)
                       + offs]


def topk_gaps(U, V, train_u, train_i, users, ids, scores, k: int,
              block: int = 2048):
    """``users`` int64 [m]; ``ids`` int64 and ``scores`` float [m, k], the
    program's answers. Returns ``(bad, rank, score)``."""
    dev = U.device
    U64, V64 = U.double(), V.double()
    order = torch.argsort(train_u, stable=True)
    tu, ti = train_u[order], train_i[order]
    starts = torch.searchsorted(
        tu, torch.arange(U.shape[0] + 1, device=dev, dtype=tu.dtype))
    bad, rank, score, scale = 0, 0.0, 0.0, 0.0
    for a in range(0, users.shape[0], block):
        ub = users[a:a + block]
        s = U64[ub] @ V64.T
        r, c = _exclusions(starts, ti, ub)
        s[r, c] = -math.inf
        best = torch.topk(s, k, dim=1).values
        got = ids[a:a + block]
        valid = got >= 0
        got_ref = s.gather(1, got.clamp_min(0))
        ok = valid & torch.isfinite(got_ref)
        srt = torch.sort(got, dim=1).values
        dup = (srt[:, 1:] == srt[:, :-1]).sum()
        bad += int((~ok).sum()) + int(dup)
        rank = max(rank, float(torch.where(
            ok, best - got_ref, torch.zeros_like(best)).max()))
        score = max(score, float(torch.where(
            ok, (scores[a:a + block].double() - got_ref).abs(),
            torch.zeros_like(best)).max()))
        scale = max(scale, float(best[:, 0].abs().max()))
    scale = max(scale, 1e-30)
    return bad, rank / scale, score / scale


def sample_mask(seed: int, n: int, every: int) -> np.ndarray:
    """One request in ``every`` (about), drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 17])
    return rng.random(n) < 1.0 / every
