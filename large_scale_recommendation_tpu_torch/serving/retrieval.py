"""Approximate retrieval fast path: int8 score-then-rescore top-K
(counterpart of ``large_scale_recommendation_tpu.serving.retrieval``).

- **Stage 1 (cheap, approximate)** scores an int8-quantized catalog
  (per-row symmetric scale: ``q = round(V / scale)``, ``scale = max|row| /
  127``) and keeps the top ``k · overfetch`` candidates. Flat: one int8 ×
  int8 product over the whole catalog. Clustered: the catalog grouped
  into capacity-capped k-means slabs (an IVF layout), each query routed to
  its top ``n_probe`` clusters by centroid inner product, plus an
  overflow block every query scores.
- **Stage 2 (exact)** gathers the candidates' f32 rows, rescores them,
  applies the train-seen exclusions exactly and returns the top k. Every
  returned score is the exact f32 score of its item.
- ``stage1_only`` skips the rescore: the approximate, *degraded* operating
  point of the admission ladder.

The JAX package computes these with XLA ops (no Pallas kernel); the port
runs them as torch ops on the tables' device, except flat stage 1 on one
device:

- Flat stage 1 on one device is ``ops.stage1_select.stage1_select``: on
  the card one fused int8 tensor-core kernel family scores the catalog
  and radix-selects the top ``kc`` without a ``[bucket, N]`` score matrix;
  on the CPU its plain version. Its int8 dots are exact integers and
  JAX's op order after the product is kept (``scores * (u_scale ⊗
  scale)``, ``+ item_w``, scatter-min), so the flat candidates' values are
  bit-equal to JAX's (rows too, away from ties at the ``kc``-th value).
- Rank-sharded flat stage 1 runs the int8 × int8 product as an f32
  product of the int8 values. Every partial sum is an integer of
  magnitude ≤ 127²·rank, below 2²⁴ while rank < 1,040, so every order of
  summation gives the exact int32 value, on the CPU and on the card.
- The clustered probe loop gathers one ``[bucket, m, rank]`` slab block
  at a time (JAX's ``lax.map``); its f32 contraction sums in another
  order than XLA, so candidate sets can differ at near-ties.
- Stage 2's (query, item) membership keys are int64 (JAX packs uint32,
  since x64 is off there); the ``bucket·(n+1) ≥ 2³²`` ``ValueError`` is
  kept so the contract is the same.
- Every top-k is re-sorted to ``lax.top_k``'s order.

Rank sharding: given a ``parallel.partitioner.Partitioner`` with
``model_parallel > 1``, the int8 code tables (flat ``q``, clustered
``slab_q`` / ``ovf_q``) and the f32 rescore table hold this rank's column
slice (``'rank'`` over the model group); scales, weights, centroids and
row maps stay whole. Codes are quantized on full rows first, so they are
the same at every model size. Each contraction over the rank dimension is
a partial product summed over the model group (``all_reduce``): the int8
partials are exact integers, so stage 1's flat candidates stay bit-equal;
the f32 rescore and the probe loop sum in another order. Routing uses the
full query rows against the whole centroids. Every rank of a model group
calls ``topk`` with the same queries (the sums are collective). Without a
partitioner, or at ``model_parallel`` 1, the catalog is one device's
(the JAX package's replicated layout).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.obs.trace import span
from large_scale_recommendation_tpu_torch.ops.stage1_select import (
    int8_scores,
    stage1_select,
)
from large_scale_recommendation_tpu_torch.ops.topk import (
    DEAD_SLOT_OFFSET,
    apply_exclusions,
    ieee_f32,
    item_weights,
    lax_top_k,
)
from large_scale_recommendation_tpu_torch.parallel.collectives import (
    group_sum,
)
from large_scale_recommendation_tpu_torch.parallel.serving import (
    catalog_version,
)
from large_scale_recommendation_tpu_torch.utils.device import resolve_device
from large_scale_recommendation_tpu_torch.utils.shapes import pow2_pad

_INV_127 = float(np.float32(1.0 / 127.0))


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """Fast-path knobs: ``overfetch`` sets the stage-1 candidate budget
    (``k · overfetch``, clamped to the catalog); ``n_clusters=None`` scores
    the whole int8 catalog flat, an integer builds the clustered index
    probed at ``n_probe`` clusters per query; ``slab_slack`` sizes the
    capacity-capped slabs; ``max_bucket`` caps the fast path's micro-batch
    (the clustered gather materializes ``[bucket, slab, rank]`` per
    probe)."""

    overfetch: int = 4
    n_clusters: int | None = None
    n_probe: int = 8
    kmeans_iters: int = 5
    kmeans_sample: int = 65536
    slab_slack: float = 2.0
    spill_choices: int = 4
    max_bucket: int = 256
    seed: int = 0

    def __post_init__(self):
        if self.overfetch < 1:
            raise ValueError(f"overfetch must be >= 1, got {self.overfetch}")
        if self.n_clusters is not None and self.n_clusters < 2:
            raise ValueError(f"n_clusters must be >= 2, "
                             f"got {self.n_clusters}")
        if self.n_probe < 1:
            raise ValueError(f"n_probe must be >= 1, got {self.n_probe}")
        if self.slab_slack < 1.0:
            raise ValueError(f"slab_slack must be >= 1, "
                             f"got {self.slab_slack}")
        if self.spill_choices < 1:
            raise ValueError(f"spill_choices must be >= 1, "
                             f"got {self.spill_choices}")


def _rank_sharded(partitioner):
    """The partitioner when it shards the rank (``model_parallel > 1``),
    else None (the one-device layout)."""
    if partitioner is None or partitioner.model_parallel <= 1:
        return None
    return partitioner


def _cols(X: torch.Tensor, part) -> torch.Tensor:
    """This rank's column slice of full rows ``X`` (all of them without
    rank sharding)."""
    return X if part is None else part.rank_slice(X)


def _sum(x: torch.Tensor, part) -> torch.Tensor:
    """A partial product over the rank, summed over the model group."""
    return x if part is None else group_sum(part.model, x)


def _table(V, device=None) -> torch.Tensor:
    """``V`` as a tensor: a tensor stays on its device; anything else goes
    to ``device`` (``None``: the card)."""
    if isinstance(V, torch.Tensor):
        return V
    return torch.from_numpy(np.array(V, np.float32)).to(
        resolve_device(device))


# --------------------------------------------------------------------------
# int8 per-row quantization
# --------------------------------------------------------------------------


def quantize_rows(X) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: ``(q int8 [n, r], scale f32 [n])`` with
    ``scale = max|row| / 127`` (all-zero rows get scale 1) and ``q =
    round(X / scale)`` (half to even); ``dequant = q · scale[:, None]``,
    within ``scale / 2`` of ``X`` per element. The division by the
    constant 127 is a multiply by f32(1/127), as XLA compiles the JAX
    package's ``amax / 127.0``, so the scales are bit-equal to it."""
    X = _table(X).float()
    amax = X.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax * _INV_127, torch.ones_like(amax))
    q = torch.round(X / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q, scale) -> torch.Tensor:
    return q.float() * scale[:, None]


# --------------------------------------------------------------------------
# k-means MIPS index build (host-side; assignment via chunked matmuls)
# --------------------------------------------------------------------------


def _augment(V: np.ndarray) -> np.ndarray:
    """MIPS→NN reduction (Bachrach et al. 2014): append ``sqrt(max_norm² −
    ‖v‖²)`` so Euclidean k-means groups items by direction and norm."""
    norms2 = np.sum(V * V, axis=1)
    pad = np.sqrt(np.maximum(norms2.max() - norms2, 0.0))
    return np.concatenate([V, pad[:, None]], axis=1).astype(np.float32)


def _assign(X: np.ndarray, centroids: np.ndarray, top: int = 1,
            chunk: int = 16384, device=None) -> np.ndarray:
    """Per row, the ``top`` nearest centroids by Euclidean distance
    (argmax ``x·c − ‖c‖²/2``), chunked matmul + top-k on ``device``.
    Returns ``[n]`` for ``top=1``, else ``[n, top]`` best-first."""
    dev = resolve_device(device)
    half = torch.from_numpy(
        0.5 * np.sum(centroids * centroids, axis=1)).to(dev)
    C_dev = torch.from_numpy(np.ascontiguousarray(centroids.T)).to(dev)
    top = min(top, len(centroids))
    out = np.empty((len(X), top), np.int32)
    with ieee_f32():
        for c0 in range(0, len(X), chunk):
            sl = torch.from_numpy(np.ascontiguousarray(
                X[c0:c0 + chunk])).to(dev)
            _, idx = lax_top_k(sl @ C_dev - half[None, :], top)
            out[c0:c0 + len(idx)] = idx.cpu().numpy()
    return out[:, 0] if top == 1 else out


def _capacity_assign(choices: np.ndarray, cap: int, n_clusters: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Greedy capacity-capped assignment: every row tries its ranked
    cluster choices in order; a cluster accepts rows up to ``cap``. Rows
    exhausting their choices land in the overflow set (scored on every
    probe downstream)."""
    n, n_choices = choices.shape
    assign = np.full(n, -1, np.int32)
    used = np.zeros(n_clusters, np.int64)
    remaining = np.arange(n)
    for level in range(n_choices):
        if not len(remaining):
            break
        c = choices[remaining, level]
        order = np.argsort(c, kind="stable")
        cs = c[order]
        starts = np.searchsorted(cs, np.arange(n_clusters))
        rank = np.arange(len(cs)) - starts[cs]
        ok = rank < (cap - used[cs])
        accepted = order[ok]
        assign[remaining[accepted]] = cs[ok]
        used += np.bincount(cs[ok], minlength=n_clusters)
        remaining = remaining[order[~ok]]
    return assign, remaining


def kmeans_fit(V: np.ndarray, n_clusters: int, iters: int = 5,
               sample: int = 65536, seed: int = 0, cap: int | None = None,
               spill_choices: int = 4, device=None
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fit centroids on a subsample (Lloyd iterations, in MIPS-augmented
    space), then capacity-capped-assign every row. Returns ``(assignment
    int32 [n] (−1 = overflow), overflow rows, routing centroids f32 [C,
    rank])``; routing centroids are the mean raw member vectors. The
    numpy draws are the JAX package's; the assignments run on ``device``
    (``None``: the card)."""
    n, r = V.shape
    rng = np.random.default_rng(seed)
    aug = _augment(np.asarray(V, np.float32))
    fit_idx = (rng.choice(n, size=sample, replace=False)
               if n > sample else np.arange(n))
    X = aug[fit_idx]
    centroids = X[rng.choice(len(X), size=n_clusters, replace=False)]
    for _ in range(max(1, iters)):
        a = _assign(X, centroids, device=device)
        counts = np.bincount(a, minlength=n_clusters)
        sums = np.zeros_like(centroids)
        np.add.at(sums, a, X)
        nonempty = counts > 0
        centroids[nonempty] = (sums[nonempty]
                               / counts[nonempty][:, None])
        # dead centroids: reseed from random points so every slab can fill
        n_dead = int((~nonempty).sum())
        if n_dead:
            centroids[~nonempty] = X[rng.choice(len(X), size=n_dead)]
    if cap is None:
        cap = n  # uncapped: single-choice argmax, no overflow
    choices = _assign(aug, centroids, top=max(1, spill_choices),
                      device=device)
    if choices.ndim == 1:
        choices = choices[:, None]
    assignment, overflow = _capacity_assign(choices, cap, n_clusters)
    route = np.zeros((n_clusters, r), np.float32)
    placed = assignment >= 0
    counts = np.bincount(assignment[placed], minlength=n_clusters)
    np.add.at(route, assignment[placed], np.asarray(V, np.float32)[placed])
    route[counts > 0] /= counts[counts > 0][:, None]
    return assignment, overflow, route


# --------------------------------------------------------------------------
# Quantized catalog (flat or clustered slabs) + delta re-quantization
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuantizedCatalog:
    """The stage-1 scoring structure on one device: int8 codes with per-row
    scales, either flat (``q``/``scale``) or grouped into clustered slabs
    (``slab_q [C, m, r]`` etc.; ``pos_of_row`` maps a row to its flat slab
    position, ``c·m + slot`` or ``C·m + j`` in the overflow block). Slab
    pads hold ``-inf`` weight and row id ``n_rows``. ``version`` is the
    ``catalog_version`` token of the source table."""

    n_rows: int
    rank: int
    version: int
    item_w: torch.Tensor  # [n] 0 real / DEAD_SLOT_OFFSET masked
    q: torch.Tensor | None = None  # int8 [n, r]
    scale: torch.Tensor | None = None  # f32 [n]
    centroids: torch.Tensor | None = None  # f32 [C, r] (routing)
    slab_q: torch.Tensor | None = None  # int8 [C, m, r]
    slab_scale: torch.Tensor | None = None  # f32 [C, m]
    slab_w: torch.Tensor | None = None  # f32 [C, m] (item_w; -inf pads)
    slab_rows: torch.Tensor | None = None  # int64 [C, m] (n_rows pads)
    ovf_q: torch.Tensor | None = None  # int8 [O, r]
    ovf_scale: torch.Tensor | None = None  # f32 [O]
    ovf_w: torch.Tensor | None = None  # f32 [O] (-inf pads)
    ovf_rows: torch.Tensor | None = None  # int64 [O] (n_rows pads)
    pos_of_row: np.ndarray | None = None  # int64 [n]
    stats: dict = dataclasses.field(default_factory=dict)
    # rank-sharded (model_parallel > 1): the code tables hold this rank's
    # column slice
    partitioner: object = None

    _ARRAY_FIELDS = ("q", "scale", "centroids", "slab_q", "slab_scale",
                     "slab_w", "slab_rows", "ovf_q", "ovf_scale", "ovf_w",
                     "ovf_rows", "item_w")

    @property
    def clustered(self) -> bool:
        return self.slab_q is not None

    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in (getattr(self, f) for f in self._ARRAY_FIELDS)
                       if t is not None))

    def nbytes_per_device(self) -> int:
        """Catalog bytes resident on this rank's device. Each rank is its
        own process holding its own column slice of a rank-sharded build,
        so this is ``nbytes()`` (the JAX package sums a global array's
        addressable shards per device to the same number)."""
        return self.nbytes()

    def apply_delta(self, rows, values, version: int) -> "QuantizedCatalog":
        """Re-quantize ONLY the given rows (new f32 ``values``) into a new
        layout, out of place. Per-row quantization is deterministic, so the
        flat result is bit-equal to a full rebuild from the patched table.
        Clustered mode keeps each row's cluster slot (re-clustering is a
        full-rebuild concern)."""
        rows = np.asarray(rows)
        if len(rows) == 0:
            return dataclasses.replace(self, version=version)
        dev = self.item_w.device
        q_new, s_new = quantize_rows(torch.as_tensor(
            values, dtype=torch.float32, device=dev))
        q_new = _cols(q_new, self.partitioner)  # codes of full rows
        def put(t, idx, vals):
            return t.index_copy(0, torch.as_tensor(idx, dtype=torch.int64,
                                                   device=dev), vals)

        patch: dict = {"version": version}
        if self.q is not None:
            patch["q"] = put(self.q, rows, q_new)
            patch["scale"] = put(self.scale, rows, s_new)
        if self.clustered:
            C, m, r = self.slab_q.shape
            pos = self.pos_of_row[rows]
            in_slab = pos < C * m
            if in_slab.any():
                sel = torch.from_numpy(in_slab).to(dev)
                patch["slab_q"] = put(self.slab_q.reshape(C * m, r),
                                      pos[in_slab], q_new[sel]
                                      ).reshape(C, m, r)
                patch["slab_scale"] = put(self.slab_scale.reshape(C * m),
                                          pos[in_slab], s_new[sel]
                                          ).reshape(C, m)
            if (~in_slab).any():
                sel = torch.from_numpy(~in_slab).to(dev)
                patch["ovf_q"] = put(self.ovf_q, pos[~in_slab] - C * m,
                                     q_new[sel])
                patch["ovf_scale"] = put(self.ovf_scale,
                                         pos[~in_slab] - C * m, s_new[sel])
        return dataclasses.replace(self, **patch)


def _clustered_layout(q_host, s_host, item_w, assignment, overflow, C, m):
    """The slab fill, numpy: placed rows sorted by cluster, each row's slot
    its rank within the cluster (< m by the capacity cap); overflow rows
    after the C·m slab positions, padded to a pow2 (≥ 8) block. Returns
    the flat position of every row and the flat arrays (codes, scales,
    weights, rows) of C·m + O positions."""
    n, r = q_host.shape
    placed = assignment >= 0
    counts = np.bincount(assignment[placed], minlength=C)
    placed_rows = np.nonzero(placed)[0]
    order = placed_rows[np.argsort(assignment[placed_rows], kind="stable")]
    starts = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = (np.arange(len(order), dtype=np.int64)
            - starts[assignment[order]])
    pos_of_row = np.empty(n, np.int64)
    pos_of_row[order] = assignment[order].astype(np.int64) * m + slot
    O = pow2_pad(max(len(overflow), 1), 8)
    pos_of_row[overflow] = C * m + np.arange(len(overflow))
    slab_q = np.zeros((C * m + O, r), np.int8)
    slab_scale = np.zeros(C * m + O, np.float32)
    slab_w = np.full(C * m + O, -np.inf, np.float32)  # pads: -inf
    slab_rows = np.full(C * m + O, n, np.int64)  # pads: clamped later
    slab_q[pos_of_row] = q_host
    slab_scale[pos_of_row] = s_host
    slab_w[pos_of_row] = item_w
    slab_rows[pos_of_row] = np.arange(n, dtype=np.int64)
    return pos_of_row, counts, (slab_q, slab_scale, slab_w, slab_rows)


def build_quantized_catalog(V, item_mask=None,
                            config: RetrievalConfig | None = None,
                            version: int | None = None,
                            partitioner=None) -> QuantizedCatalog:
    """Quantize ``V`` (a tensor: the catalog lives on its device) and,
    with ``config.n_clusters``, build the clustered MIPS layout.
    ``item_mask`` (True = real item) gives masked rows
    ``DEAD_SLOT_OFFSET`` additively. ``partitioner`` with
    ``model_parallel > 1`` keeps this rank's column slice of the code
    tables (quantized on full rows first)."""
    part = _rank_sharded(partitioner)
    if part is not None:
        part.require_rank_divisible(int(V.shape[1]),
                                    "build_quantized_catalog")
        cat = build_quantized_catalog(V, item_mask, config, version)
        return _shard_quantized(cat, part)
    cfg = config or RetrievalConfig()
    t0 = time.perf_counter()
    version = catalog_version(V) if version is None else version
    V = _table(V).float()
    dev = V.device
    n, r = V.shape
    item_w = item_weights(n, item_mask)
    q_dev, s_dev = quantize_rows(V)
    stats = {"n_rows": n, "rank": r, "mode": "flat"}
    if cfg.n_clusters is None:
        cat = QuantizedCatalog(
            n_rows=n, rank=r, version=version,
            item_w=torch.from_numpy(item_w).to(dev), q=q_dev, scale=s_dev,
            stats=stats)
        stats["build_s"] = round(time.perf_counter() - t0, 3)
        stats["bytes"] = cat.nbytes()
        return cat

    C = min(cfg.n_clusters, n)
    # capacity-capped slabs: m = pow2(slack · mean cluster) bounds the
    # probed volume at n_probe·m rows whatever the k-means imbalance
    m = pow2_pad(max(1, int(np.ceil(cfg.slab_slack * n / C))))
    assignment, overflow, route = kmeans_fit(
        V.cpu().numpy(), C, iters=cfg.kmeans_iters, sample=cfg.kmeans_sample,
        seed=cfg.seed, cap=m, spill_choices=cfg.spill_choices, device=dev)
    pos_of_row, counts, flat = _clustered_layout(
        q_dev.cpu().numpy(), s_dev.cpu().numpy(), item_w, assignment,
        overflow, C, m)
    slab_q, slab_scale, slab_w, slab_rows = (
        torch.from_numpy(a).to(dev) for a in flat)
    stats.update(mode="clustered", n_clusters=int(C), slab_size=int(m),
                 capacity_cap=int(m), overflow_rows=int(len(overflow)),
                 max_cluster=int(counts.max()),
                 mean_cluster=float(counts.mean()),
                 empty_clusters=int((counts == 0).sum()),
                 n_probe=int(min(cfg.n_probe, C)))
    Cm = C * m
    cat = QuantizedCatalog(
        n_rows=n, rank=r, version=version,
        item_w=torch.from_numpy(item_w).to(dev),
        centroids=torch.from_numpy(route).to(dev),
        slab_q=slab_q[:Cm].reshape(C, m, r),
        slab_scale=slab_scale[:Cm].reshape(C, m),
        slab_w=slab_w[:Cm].reshape(C, m),
        slab_rows=slab_rows[:Cm].reshape(C, m),
        ovf_q=slab_q[Cm:], ovf_scale=slab_scale[Cm:], ovf_w=slab_w[Cm:],
        ovf_rows=slab_rows[Cm:], pos_of_row=pos_of_row, stats=stats)
    stats["build_s"] = round(time.perf_counter() - t0, 3)
    stats["bytes"] = cat.nbytes()
    return cat


def _shard_quantized(cat: QuantizedCatalog, part) -> QuantizedCatalog:
    """A built catalog's code tables cut to this rank's columns (the O(n)
    scales, weights, centroids and row maps stay whole)."""
    patch: dict = {"partitioner": part}
    for name, axes in (("q", (None, "rank")),
                       ("slab_q", (None, None, "rank")),
                       ("ovf_q", (None, "rank"))):
        t = getattr(cat, name)
        if t is not None:
            patch[name] = part.place(t, *axes)
    out = dataclasses.replace(cat, **patch)
    out.stats.update(rank_sharded=part.model_parallel,
                     bytes_per_device=out.nbytes())
    return out


# --------------------------------------------------------------------------
# Stages
# --------------------------------------------------------------------------


def _stage1_flat(qU, u_scale, Q, scale, item_w, excl_rows, excl_cols,
                 excl_w, *, kc, part=None):
    """Flat int8 stage 1: the exact int8 product over the whole catalog,
    dequantized by the outer product of scales, ``+ item_w``, the
    exclusions scatter-min'ed, top-``kc`` candidates out. On one device
    that is ``ops.stage1_select.stage1_select`` (the fused kernels on the
    card, their plain version on the CPU), which never holds the score
    matrix. Rank-sharded, the slices' partial products are summed over the
    model group (exact) before any selection, so that route keeps the
    ``[b, N]`` score matrix."""
    if part is None:
        return stage1_select(qU, u_scale, Q, scale, item_w, excl_rows,
                             excl_cols, excl_w, kc=kc)
    scores = _sum(int8_scores(_cols(qU, part), Q), part)
    scores *= u_scale[:, None] * scale[None, :]
    scores += item_w[None, :]
    apply_exclusions(scores, excl_rows, excl_cols, excl_w)
    return lax_top_k(scores, kc)


def _route(U_chunk, centroids, n_probe):
    """Each query's top-``n_probe`` clusters by centroid inner product."""
    with ieee_f32():
        return lax_top_k(U_chunk @ centroids.T, n_probe)[1]


def _score_probe(U_chunk, c, slab_q, slab_scale, slab_w, part=None):
    """One probe: each query against the slab of its cluster ``c[query]``
    (one ``[b, m, r]`` gather, upcast to f32; queries stay f32; ``U_chunk``
    holds the slab's columns)."""
    with ieee_f32():
        sc = torch.bmm(slab_q[c].float(), U_chunk[:, :, None])[..., 0]
    return _sum(sc, part) * slab_scale[c] + slab_w[c]


def _score_overflow(U_chunk, ovf_q, ovf_scale, ovf_w, part=None):
    """The overflow block every query scores: a plain ``[b, O]`` product."""
    with ieee_f32():
        ov = U_chunk @ ovf_q.float().T
    return _sum(ov, part) * ovf_scale[None, :] + ovf_w[None, :]


def _stage1_clustered(U_chunk, centroids, slab_q, slab_scale, slab_w,
                      slab_rows, ovf_q, ovf_scale, ovf_w, ovf_rows, *, kc,
                      n_probe, part=None):
    """Clustered stage 1: route each query to its top-``n_probe`` clusters,
    score ONLY those slabs, one probe at a time (peak memory one ``[b, m,
    r]`` gather), plus the overflow block; top-``kc`` candidates out, in
    probe-major position order per query (JAX's layout). Exclusions are
    left to stage 2's membership test."""
    b, m = U_chunk.shape[0], slab_q.shape[1]
    cid = _route(U_chunk, centroids, n_probe)  # [b, p], full rows
    U_c = _cols(U_chunk, part)
    width = n_probe * m + ovf_q.shape[0]
    scores = torch.empty((b, width), dtype=torch.float32,
                         device=U_chunk.device)
    rows = torch.empty((b, width), dtype=torch.int64, device=U_chunk.device)
    for pi in range(n_probe):
        c = cid[:, pi]
        sl = slice(pi * m, (pi + 1) * m)
        scores[:, sl] = _score_probe(U_c, c, slab_q, slab_scale, slab_w,
                                     part)
        rows[:, sl] = slab_rows[c]
    scores[:, n_probe * m:] = _score_overflow(U_c, ovf_q, ovf_scale,
                                              ovf_w, part)
    rows[:, n_probe * m:] = ovf_rows[None, :]
    v, pos = lax_top_k(scores, kc)
    return v, rows.gather(1, pos)


def _stage2(U_chunk, V, item_w, cand_v, cand_rows, excl_rows, excl_cols,
            excl_w, *, k, exact, part=None):
    """Candidate finalization: ``exact=True`` rescores the candidates' f32
    rows (every surfaced score is the true score of its item; rank-sharded:
    ``V`` is the column slice and the partial scores are summed over the
    model group), ``exact=False`` passes stage 1's scores through. Either
    way the train-seen exclusions apply exactly by a sorted-key membership
    test, excluded candidates dropping to ``DEAD_SLOT_OFFSET``."""
    n = V.shape[0]
    safe_rows = cand_rows.clamp(max=n - 1)  # slab pads carry n
    if exact:
        with ieee_f32():
            sc = torch.bmm(V[safe_rows], _cols(U_chunk, part)[:, :, None]
                           )[..., 0]
        sc = _sum(sc, part) + item_w[safe_rows]
        # pads (row == n) stay dead even though row n-1 is real
        sc = torch.where(cand_rows >= n, float("-inf"), sc)
    else:
        sc = cand_v
    stride = n + 1
    real = excl_w < 0
    keys = torch.where(real, excl_rows.long() * stride + excl_cols.long(),
                       torch.iinfo(torch.int64).max)
    keys = keys.sort().values
    b = cand_rows.shape[0]
    cand_keys = (torch.arange(b, device=cand_rows.device)[:, None] * stride
                 + cand_rows)
    pos = torch.searchsorted(keys, cand_keys).clamp_(0, keys.shape[0] - 1)
    hit = keys[pos] == cand_keys
    sc = torch.where(hit, DEAD_SLOT_OFFSET, sc)
    v, p = lax_top_k(sc, k)
    return v, cand_rows.gather(1, p)


# --------------------------------------------------------------------------
# Retriever: the engine-facing surface
# --------------------------------------------------------------------------


class TwoStageRetriever:
    """One catalog build's fast path: the quantized stage-1 structure and
    the f32 rescore table (its own copy), with per-chunk ``topk``. Rebuilt
    by ``ServingEngine._refresh`` on a full swap; patched by
    ``apply_delta`` on a delta swap (new tensors, out of place).
    ``partitioner`` with ``model_parallel > 1``: this rank's column slices
    of the codes and of the rescore table (the module docstring)."""

    def __init__(self, V, item_mask=None,
                 config: RetrievalConfig | None = None,
                 version: int | None = None, partitioner=None):
        self.config = config or RetrievalConfig()
        self.partitioner = _rank_sharded(partitioner)
        V_full = _table(V).to(torch.float32, copy=True)
        self.catalog = build_quantized_catalog(
            V_full, item_mask=item_mask, config=self.config,
            version=catalog_version(V) if version is None else version,
            partitioner=self.partitioner)
        self.V = (V_full if self.partitioner is None
                  else self.partitioner.place(V_full, None, "rank"))
        self.buckets_seen: set[tuple] = set()  # dispatched shapes

    def nbytes_per_device(self) -> int:
        """Stage-1 catalog plus stage-2 rescore table bytes on this rank's
        device (the per-device serving footprint)."""
        return (self.catalog.nbytes_per_device()
                + self.V.numel() * self.V.element_size())

    @property
    def version(self) -> int:
        return self.catalog.version

    @property
    def n_rows(self) -> int:
        return self.catalog.n_rows

    def candidate_count(self, k: int) -> int:
        """Stage-1 budget for ``k`` results: ``k · overfetch``, floored at
        ``k`` and clamped to what the layout can supply (catalog height
        flat; probed slab capacity clustered)."""
        cat = self.catalog
        if cat.clustered:
            C, m, _ = cat.slab_q.shape
            hard = (min(self.config.n_probe, C) * m
                    + int(cat.ovf_q.shape[0]))
        else:
            hard = cat.n_rows
        return min(max(k, min(k * self.config.overfetch, cat.n_rows)),
                   hard)

    def topk(self, U_chunk, excl, k: int, stage1_only: bool = False,
             mark=None, rows: int | None = None):
        """Top-``k`` of one padded f32 query chunk (on the catalog's
        device) under the exclusion triple ``excl`` (tensors there):
        ``(values f32 [b, k'], rows int64 [b, k'])``, ``k' = min(k, kc)``;
        rows ≥ ``n_rows`` only for slab pads (callers clamp). ``mark`` (the
        request plane's ``FlushLedger.mark``, None when off) splits the
        host's dispatch wall at the stage-1 / stage-2 seam, under
        ``stage1_only`` too. ``rows`` is the chunk's real query rows
        (default: all ``b``), a counter of span ``serving/stage1``.

        The stages are the spans ``serving/stage1`` (counters ``rows``,
        ``padded`` = ``b``, ``items``, the catalog rows each query scores,
        and ``fused``, the real rows that went through ``stage1_select``:
        the flat catalog on one device) and ``serving/stage2``
        (``candidates``, the ``b · kc`` slots it finalizes), with device
        time on the card."""
        cat = self.catalog
        kc = self.candidate_count(k)
        b = U_chunk.shape[0]
        if b * (cat.n_rows + 1) >= 2**32:
            # the JAX package packs (query, item) into one uint32 key
            raise ValueError(
                f"bucket {b} × catalog {cat.n_rows} "
                f"exceeds the uint32 membership-key capacity — lower "
                f"RetrievalConfig.max_bucket")
        excl_rows, excl_cols, excl_w = (
            torch.as_tensor(e, device=U_chunk.device) for e in excl)
        on_card = U_chunk.is_cuda
        if cat.clustered:
            n_probe = min(self.config.n_probe, cat.slab_q.shape[0])
            items = n_probe * cat.slab_q.shape[1] + int(cat.ovf_q.shape[0])
        else:
            items = cat.n_rows
        real = b if rows is None else int(rows)
        fused = not cat.clustered and self.partitioner is None
        with span("serving/stage1", device=on_card, rows=real, padded=b,
                  items=items, fused=real if fused else 0):
            if cat.clustered:
                self.buckets_seen.add(("clustered", b, kc))
                cand_v, cand_rows = _stage1_clustered(
                    U_chunk, cat.centroids, cat.slab_q, cat.slab_scale,
                    cat.slab_w, cat.slab_rows, cat.ovf_q, cat.ovf_scale,
                    cat.ovf_w, cat.ovf_rows, kc=kc, n_probe=n_probe,
                    part=self.partitioner)
            else:
                qU, u_scale = quantize_rows(U_chunk)  # full query rows
                self.buckets_seen.add(("flat", b, kc))
                cand_v, cand_rows = _stage1_flat(
                    qU, u_scale, cat.q, cat.scale, cat.item_w, excl_rows,
                    excl_cols, excl_w, kc=kc, part=self.partitioner)
        if mark is not None:
            mark("score_stage1")
        with span("serving/stage2", device=on_card, candidates=b * kc):
            out = _stage2(U_chunk, self.V, cat.item_w, cand_v, cand_rows,
                          excl_rows, excl_cols, excl_w, k=min(k, kc),
                          exact=not stage1_only, part=self.partitioner)
        if mark is not None:
            mark("score_stage2")
        return out

    def apply_delta(self, rows, values, version: int) -> None:
        """Install only the touched rows: a patched copy of the f32
        rescore table and the dirty rows of the int8 catalog
        re-quantized."""
        rows = np.asarray(rows)
        if len(rows):
            dev = self.V.device
            vals = torch.as_tensor(values).to(dev).float()
            self.V = self.V.index_copy(
                0, torch.as_tensor(rows, dtype=torch.int64, device=dev),
                _cols(vals, self.partitioner).contiguous())
            self.catalog = self.catalog.apply_delta(rows, vals, version)
        else:
            self.catalog = dataclasses.replace(self.catalog,
                                               version=version)


# --------------------------------------------------------------------------
# Recall measurement
# --------------------------------------------------------------------------


def recall_at_k(approx_ids, exact_ids) -> float:
    """Mean per-query overlap fraction between an approximate top-k id
    list and the exact one. Dead slots (id −1) are dropped from BOTH
    sides; a query whose exact list is empty contributes 1.0."""
    approx_ids = np.asarray(approx_ids)
    exact_ids = np.asarray(exact_ids)
    if approx_ids.ndim == 1:
        approx_ids = approx_ids[None]
        exact_ids = exact_ids[None]
    total = 0.0
    for a_row, e_row in zip(approx_ids, exact_ids):
        e = set(int(x) for x in e_row if x >= 0)
        if not e:
            total += 1.0
            continue
        a = set(int(x) for x in a_row if x >= 0)
        total += len(a & e) / len(e)
    return total / len(approx_ids)
