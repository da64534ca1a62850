"""Stage 1 of the flat int8 two-stage retriever as one fused score-and-
select (``csrc/stage1_select.cu``), beside its plain PyTorch version.

For one bucket of ``b`` query rows it returns what the score-matrix route
returned (``int8_scores``, the outer product of scales, ``+ item_w``, the
exclusions scatter-min'ed, ``lax_top_k``): ``(values f32 [b, kc], rows
int64 [b, kc])`` in ``lax.top_k``'s order, values bit-equal, the row sets
equal except among rows tied with the ``kc``-th value (the contract leaves
open which of them enters).

The kernels replace no TPU kernel: the JAX package leaves stage 1 to XLA.
They keep the ``[b, N]`` score matrix out of device memory. The scores
are computed on the tensor cores in int8 (exact int32 dots), finished in
registers with the route's f32 rounding, and radix-selected on their
order-preserving uint32 keys in rounds of 11, 11 and 10 bits, each pass
recomputing them, with no host synchronisation: a 1/16 sample of the
catalog bounds the row's ``kc``-th key from below, pass 0 counts the keys
above that bound, pass 1 the keys of the chosen bin, pass 2 those of the
next and sends every key above its bin to the output, and a finishing
kernel fills each row from pass 2's short lists (the full emit pass runs
only where ties overflow them). What bounds a pass on the card is its
per-score f32 epilogue, not the catalog's bytes or the int8 operations;
each pass stages every item group once for 128 rows, and the row tiles of
one item chunk run together, so it reads the catalog from HBM about once
and the L2 serves the repeats (``csrc/stage1_select.cu`` says more).

``stage1_select`` launches the kernels for CUDA tensors (and counts them
in ``LAUNCHES``) and runs ``stage1_select_reference`` for CPU tensors:
the same keys and rounds in torch over the whole score matrix, tied keys
taken lower row first.
There is no fallback: a CUDA tensor the kernels do not take raises.

Exclusions: the triple ``(excl_rows, excl_cols, excl_w)`` of
``ops.topk.exclusion_builder``; entries with ``excl_w >= 0`` are pads and
are ignored, duplicates apply once (a minimum). On the card the wrapper
turns it into per-row sorted ``(column, weight)`` lists with torch ops.
"""

from __future__ import annotations

import ctypes

import torch

from large_scale_recommendation_tpu_torch.ops import _build
from large_scale_recommendation_tpu_torch.ops.topk import (
    apply_exclusions,
    ieee_f32,
    lax_order,
)

# launches since the last reset: a bucket's kernel sequence
LAUNCHES = {"stage1_select_launch": 0}
MAX_RANK = 1039  # int8 products sum exactly in f32 below rank 1,040
# the three radix rounds of a uint32 key, from the top: (shift, bits)
ROUNDS = ((21, 11), (10, 11), (0, 10))
BINS = 2048
TINY = 64  # a row's list of keys in the last bin (csrc: stage1_finish_kernel)

_LIB = "stage1_select"
_bound: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    """The built library with its ctypes signatures declared."""
    global _bound
    if _bound is not None:
        return _bound
    with _build.lock(_LIB):
        if _bound is None:
            lib = _build.load_library(_LIB)
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.stage1_select_launch.restype = I
            lib.stage1_select_launch.argtypes = ([P] * 8 + [I] * 4 + [P] * 3
                                                 + [I] + [P] * 3)
            _bound = lib
    return _bound


def check_rank(rank: int) -> None:
    if rank > MAX_RANK:
        raise ValueError(f"rank {rank} >= 1040: int8 products no longer sum "
                         "exactly in f32")


def _launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def int8_scores(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """``qa @ qbᵀ`` of two int8 tables as exact integers in f32: every
    partial sum is an integer of magnitude ≤ 127²·rank, below 2²⁴ while
    rank < 1,040, so every order of summation gives the exact int32
    value."""
    check_rank(qa.shape[1])
    with ieee_f32():
        return qa.float() @ qb.float().T


def score_matrix(qU, u_scale, Q, scale, item_w, excl_rows, excl_cols,
                 excl_w) -> torch.Tensor:
    """The ``[b, N]`` f32 scores, as the kernels compute each: the exact
    int8 product, ``* (u_scale ⊗ scale)``, ``+ item_w``, the real
    exclusions (``excl_w < 0``) scatter-min'ed."""
    scores = int8_scores(qU, Q)
    scores *= u_scale[:, None] * scale[None, :]
    scores += item_w[None, :]
    real = excl_w < 0
    return apply_exclusions(scores, excl_rows[real], excl_cols[real],
                            excl_w[real])


def order_keys(scores: torch.Tensor) -> torch.Tensor:
    """Each f32 score's order-preserving uint32 key, as int64."""
    bits = scores.view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(bits >= 2**31, bits ^ 0xFFFFFFFF, bits | 2**31)


def stage1_select_reference(qU, u_scale, Q, scale, item_w, excl_rows,
                            excl_cols, excl_w, *, kc: int):
    """The kernels' plain version: the whole score matrix, its keys, the
    three histogram rounds, the emit (tied keys at ``T`` lower row
    first), then ``lax.top_k``'s order."""
    scores = score_matrix(qU, u_scale, Q, scale, item_w, excl_rows,
                          excl_cols, excl_w)
    key = order_keys(scores)
    b = key.shape[0]
    prefix = torch.zeros(b, dtype=torch.int64, device=key.device)
    k_rem = torch.full((b,), kc, dtype=torch.int64, device=key.device)
    for shift, bits in ROUNDS:
        digit = (key >> shift) & ((1 << bits) - 1)
        carry = (key >> (shift + bits)) == prefix[:, None]
        hist = torch.zeros((b, 1 << bits), dtype=torch.int64,
                           device=key.device).scatter_add_(1, digit,
                                                           carry.long())
        at_or_above = hist.flip(1).cumsum(1).flip(1)
        d = (at_or_above >= k_rem[:, None]).sum(1) - 1
        k_rem = k_rem - (at_or_above.gather(1, d[:, None])[:, 0]
                         - hist.gather(1, d[:, None])[:, 0])
        prefix = (prefix << bits) | d
    equal = key == prefix[:, None]
    take = (key > prefix[:, None]) | (equal & (equal.cumsum(1)
                                               <= k_rem[:, None]))
    rows = take.nonzero()[:, 1].view(b, kc)
    return lax_order(scores.gather(1, rows), rows)


def exclusion_lists(excl_rows, excl_cols, excl_w, b: int, n: int):
    """The triple as per-row sorted lists on its device: ``(off int32
    [b + 1], cols int32, w f32)``, row ``i``'s columns ascending in
    ``cols[off[i]:off[i + 1]]`` beside their weights; pads dropped past
    ``off[b]``. One sort of ``row · n + column`` keys (int32 where they
    fit: half the radix passes)."""
    wide = torch.int64 if b * n >= 2**31 else torch.int32
    key = torch.where(excl_w < 0, excl_rows.to(wide) * n
                      + excl_cols.to(wide), b * n)
    key, order = key.sort()
    starts = torch.arange(b + 1, dtype=wide, device=key.device) * n
    off = torch.searchsorted(key, starts).int()
    return off, (key % n).int(), excl_w.float()[order].contiguous()


def _check(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stage1_select(qU, u_scale, Q, scale, item_w, excl_rows, excl_cols,
                  excl_w, *, kc: int):
    """The top ``kc`` of one bucket's stage-1 scores (the module
    docstring): the kernels on the card, ``stage1_select_reference`` on
    the CPU."""
    b, r = qU.shape
    n = Q.shape[0]
    check_rank(r)
    if not 1 <= kc <= n:
        raise ValueError(f"kc {kc} outside [1, {n}]")
    if not qU.is_cuda:
        return stage1_select_reference(qU, u_scale, Q, scale, item_w,
                                       excl_rows, excl_cols, excl_w, kc=kc)
    dev = qU.device
    _check("qU", qU, torch.int8, (b, r), dev)
    _check("u_scale", u_scale, torch.float32, (b,), dev)
    _check("Q", Q, torch.int8, (n, r), dev)
    _check("scale", scale, torch.float32, (n,), dev)
    _check("item_w", item_w, torch.float32, (n,), dev)
    e = excl_rows.shape[0]
    for name, t in (("excl_rows", excl_rows), ("excl_cols", excl_cols),
                    ("excl_w", excl_w)):
        if t.device != dev or t.dim() != 1 or t.shape[0] != e:
            raise ValueError(f"{name}: the exclusion triple must be three "
                             f"1-D tensors of one length on {dev}")
    off, cols, w = exclusion_lists(excl_rows, excl_cols, excl_w, b, n)
    hist = torch.empty((b, BINS), dtype=torch.int32, device=dev)
    state = torch.empty((b + 1, 4), dtype=torch.int32, device=dev)
    tiny = torch.empty((b, TINY, 2), dtype=torch.int32, device=dev)
    values = torch.empty((b, kc), dtype=torch.float32, device=dev)
    rows = torch.empty((b, kc), dtype=torch.int64, device=dev)
    _launch("stage1_select_launch", _lib().stage1_select_launch(
        qU.data_ptr(), u_scale.data_ptr(), Q.data_ptr(), scale.data_ptr(),
        item_w.data_ptr(), off.data_ptr(), cols.data_ptr(), w.data_ptr(),
        b, n, r, kc, hist.data_ptr(), state.data_ptr(), tiny.data_ptr(),
        TINY, values.data_ptr(), rows.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream))
    return lax_order(values, rows)
