"""Cases of flat stage 1 shared by the CPU tests
(``tests/test_torch_retrieval.py``: ``ops.stage1_select``'s plain version)
and the card tests (``tests/test_torch_cuda_card.py``: its kernels), each
held against the score-matrix route, and the golden cases that hold the
card's kernels to the JAX package. Imports no JAX."""

import os

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.ops import topk
from large_scale_recommendation_tpu_torch.serving import retrieval as tret


def score_matrix_route(qU, u_scale, Q, scale, item_w, er, ec, ew, kc):
    """Flat stage 1 through the ``[b, N]`` score matrix: the int8 product
    in f32, the scales' outer product, the weights, the scatter-min and
    ``lax_top_k``."""
    scores = tret.int8_scores(qU, Q)
    scores *= u_scale[:, None] * scale[None, :]
    scores += item_w[None, :]
    topk.apply_exclusions(scores, er, ec, ew)
    return scores, topk.lax_top_k(scores, kc)


def assert_same_selection(got, want, scores):
    """Values bit-equal; ``lax.top_k``'s order; each row's items distinct,
    each returned with its own score; items equal position by position
    except where their score ties the ``kc``-th value."""
    (v, r), (wv, wr) = got, want
    assert v.dtype == torch.float32 and r.dtype == torch.int64
    assert torch.equal(v.view(torch.int32), wv.view(torch.int32))
    assert torch.equal(scores.gather(1, r).view(torch.int32),
                       v.view(torch.int32))
    later = v[:, 1:]
    assert (later <= v[:, :-1]).all()
    tied = later == v[:, :-1]
    assert (r[:, 1:][tied] > r[:, :-1][tied]).all()  # lower row first
    kth = v[:, -1:]
    assert torch.equal(r[v > kth], wr[v > kth])
    assert all(len(set(row.tolist())) == len(row) for row in r)


def stage1_inputs(b, rank, n, seed, *, mask=False, repeat=None,
                  excl="random", n_pairs=64, device="cpu"):
    """One bucket's stage-1 operands on the CPU: quantized queries and
    catalog (``repeat``: the catalog drawn from that many distinct rows,
    so scores tie), item weights (``mask``: every 5th item dead) and the
    pow2-padded exclusion triple (``excl``: random pairs, duplicated and
    out of order, or ``"row0_all"``: row 0 excludes every item)."""
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n if repeat is None else repeat, rank))
    if repeat is not None:
        V = V[rng.integers(0, repeat, n)]
    U = rng.normal(size=(b, rank))
    Q, scale = tret.quantize_rows(torch.from_numpy(V.astype(np.float32)))
    qU, u_scale = tret.quantize_rows(torch.from_numpy(U.astype(np.float32)))
    item_mask = np.ones(n, bool)
    if mask:
        item_mask[::5] = False
    item_w = torch.from_numpy(topk.item_weights(n, item_mask))
    rows = rng.integers(0, b, n_pairs)
    cols = rng.integers(0, n, n_pairs)
    rows = np.concatenate([rows, rows[: n_pairs // 4]])  # duplicates
    cols = np.concatenate([cols, cols[: n_pairs // 4]])
    if excl == "row0_all":
        rows = np.concatenate([rows, np.zeros(n, np.int64)])
        cols = np.concatenate([cols, rng.permutation(n)])
    e = len(rows)
    ep = max(8, 1 << (e - 1).bit_length())
    er = np.zeros(ep, np.int32)
    ec = np.zeros(ep, np.int32)
    ew = np.full(ep, np.inf, np.float32)
    order = rng.permutation(e)  # out of order
    er[:e], ec[:e], ew[:e] = rows[order], cols[order], topk.DEAD_SLOT_OFFSET
    return tuple(t.to(device) for t in (
        qU, u_scale, Q, scale, item_w, torch.from_numpy(er),
        torch.from_numpy(ec), torch.from_numpy(ew)))


# the special cases: stage1_inputs' keywords by name
SPECIAL = {"masked": dict(mask=True),
           "repeated_rows": dict(repeat=7),
           "row0_all": dict(excl="row0_all", mask=True),
           "ties_at_kc": dict(repeat=3, n_pairs=200)}


# the JAX package's answers for the card, which has no JAX
# (tests/data/make_stage1_jax_golden.py writes them): name → (b, rank, n,
# kc, the SPECIAL case)
JAX_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                          "stage1_jax_golden.npz")
GOLDEN_CASES = {
    "odd": (7, 33, 3000, 8, None),
    "ties": (64, 64, 4000, 40, "ties_at_kc"),
    "row0_all": (16, 32, 500, 40, "row0_all"),
    "sampled": (64, 64, 250_000, 100, "masked"),  # the wide kernel
}


def golden_inputs(name):
    """A golden case's operands on the CPU, and its ``kc``."""
    b, rank, n, kc, special = GOLDEN_CASES[name]
    return stage1_inputs(b, rank, n, seed=b + rank,
                         **SPECIAL.get(special, {})), kc


def codes_sum(args) -> int:
    """A checksum of the operands' int8 codes: tells operands that drifted
    from a wrong answer."""
    return int(args[0].long().sum()) * 1_000_003 + int(args[2].long().sum())
