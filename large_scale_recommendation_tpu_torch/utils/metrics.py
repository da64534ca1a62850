"""Full-catalog ranking: top-K serving and HR@K / NDCG@K (counterpart of the
ranking part of ``large_scale_recommendation_tpu.utils.metrics``), the
sampled-negatives HR/NDCG and catalog coverage of
``large_scale_recommendation_tpu.obs.quality``, ``ThroughputMeter``, the
streams' ``IngestStats`` with ``publish_fields``, and the timing shims over
``obs``: ``block``, ``StepTimer``, ``MetricsLog`` and ``profile`` (each
keeps the JAX package's surface and mirrors into the process registry when
``obs.enable()`` has installed one; under the null registry the mirroring
is a no-op).

The JAX package leaves this to XLA, so the port uses ordinary torch ops on
the tables' device: per chunk of users one ``[chunk, n_items]`` matmul,
the phantom-row mask ``item_w``, train-seen exclusion as a scatter-min,
then ``torch.topk`` (serving) or compare-and-count (the rank of a held-out
positive).

- bf16 tables score as the JAX package's compiled kernel scores them: the
  rows are upcast and the product accumulates in f32. The jitted
  ``U_rows @ V.T + item_w`` is typed bf16 before the add, but XLA drops
  that f32→bf16→f32 pair (excess precision is allowed), so the scores
  are never rounded to bf16; neither are the port's.
- f32 products run in IEEE f32: TF32 is off for the duration of a call,
  whatever the process set.
- Ties: ``lax.top_k`` puts the lower index first; ``torch.topk`` makes no
  promise, so each returned list is re-sorted by (score descending, row
  ascending). Which of several tied rows enters at the k-th place may still
  differ from the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Iterator

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.utils.shapes import pow2_pad

# The top-K dead-slot sentinel contract shared by every scoring surface:
# excluded/masked catalog slots get DEAD_SLOT_OFFSET (scatter-min for
# exclusions, added for masked rows), so a surfaced dead slot scores near
# the offset; consumers classify by ``score > DEAD_SLOT_THRESHOLD``.
DEAD_SLOT_OFFSET = -1e30
DEAD_SLOT_THRESHOLD = -1e29


@contextlib.contextmanager
def _ieee_f32():
    """f32 matmuls in IEEE f32 (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


logger = logging.getLogger("large_scale_recommendation_tpu_torch")


def block(x: Any) -> Any:
    """Wait for the device work producing ``x`` (a tensor, or tuples,
    lists and dicts of them) on its stream (``obs.trace._block``);
    returns ``x``."""
    from large_scale_recommendation_tpu_torch.obs.trace import _block

    _block(x)
    return x


@dataclasses.dataclass
class StepTimer:
    """Accumulating wall-clock timer for repeated steps; each step also
    lands in the process ``step_timer_s{name=}`` histogram."""

    name: str = "step"
    total_s: float = 0.0
    count: int = 0
    last_s: float = 0.0

    def __post_init__(self):
        from large_scale_recommendation_tpu_torch.obs.registry import (
            get_registry,
        )

        self._hist = get_registry().histogram("step_timer_s", name=self.name)

    @contextlib.contextmanager
    def time(self, result_holder: list | None = None) -> Iterator[None]:
        """Time one step. If ``result_holder`` ends up holding device
        tensors, they are waited for before the clock stops."""
        t0 = time.perf_counter()
        yield
        if result_holder is not None:
            block(result_holder)
        self.last_s = time.perf_counter() - t0
        self.total_s += self.last_s
        self.count += 1
        self._hist.observe(self.last_s)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


class MetricsLog:
    """Append-only structured metric records; each logged event also bumps
    ``metrics_log_events_total{event=}``."""

    def __init__(self, log_to: logging.Logger | None = logger,
                 level: int = logging.DEBUG):
        from large_scale_recommendation_tpu_torch.obs.registry import (
            get_registry,
        )

        self.records: list[dict] = []
        self._logger = log_to
        self._level = level
        self._registry = get_registry()

    def log(self, event: str, **fields) -> None:
        rec = {"event": event, "t": time.time(), **fields}
        self.records.append(rec)
        self._registry.counter("metrics_log_events_total",
                               event=event).inc()
        if self._logger is not None:
            self._logger.log(self._level, "%s %s", event, fields)

    def of(self, event: str) -> list[dict]:
        return [r for r in self.records if r["event"] == event]


@contextlib.contextmanager
def profile(log_dir: str | None) -> Iterator[None]:
    """DEPRECATED shim (as in the JAX package): profile the block into
    ``log_dir`` through ``obs.introspect.profile_trace``, the one capture
    layer; a no-op when ``log_dir`` is None, so call sites can leave the
    hook wired."""
    if log_dir is None:
        yield
        return
    import warnings

    warnings.warn(
        "utils.metrics.profile is deprecated: use "
        "obs.introspect.profile_trace — this shim routes there",
        DeprecationWarning, stacklevel=3)
    from large_scale_recommendation_tpu_torch.obs.introspect import (
        profile_trace,
    )

    with profile_trace(log_dir):
        yield


@dataclasses.dataclass
class ThroughputMeter:
    """Elements/second over the lifetime. Recorded elements and seconds
    also feed the ``meter_elements_total`` / ``meter_seconds_total``
    registry counters (labeled by ``name``; null singletons when obs is
    off, bound at construction)."""

    total_elements: int = 0
    total_s: float = 0.0
    name: str = "throughput"

    def __post_init__(self):
        from large_scale_recommendation_tpu_torch.obs.registry import (
            get_registry,
        )

        reg = get_registry()
        self._c_elems = reg.counter("meter_elements_total", name=self.name)
        self._c_secs = reg.counter("meter_seconds_total", name=self.name)

    def record(self, elements: int, seconds: float) -> None:
        self.total_elements += elements
        self.total_s += seconds
        self._c_elems.inc(elements)
        self._c_secs.inc(seconds)

    @property
    def rate(self) -> float:
        return self.total_elements / self.total_s if self.total_s else 0.0


@dataclasses.dataclass
class IngestStats:
    """Ingest-side counters of the streaming runtime (``streams/``): queue
    depth and high-water mark, block/drop/dead-letter outcomes and poison
    quarantines. Mutated under the owning queue's lock; ``snapshot()``
    returns a plain dict with the JAX package's keys."""

    enqueued_batches: int = 0
    enqueued_records: int = 0
    dequeued_batches: int = 0
    dequeued_records: int = 0
    dropped_batches: int = 0
    dropped_records: int = 0
    dead_letter_batches: int = 0
    dead_letter_records: int = 0
    poison_records: int = 0
    blocked_puts: int = 0
    depth: int = 0
    depth_high_water: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)

    def publish(self, registry=None, prefix: str = "ingest",
                **labels) -> None:
        """Every field as a ``{prefix}_{field}`` gauge of ``registry``."""
        publish_fields(dataclasses.asdict(self), registry=registry,
                       prefix=prefix, **labels)


def publish_fields(fields: dict, registry=None, prefix: str = "ingest",
                   **labels) -> None:
    """Mirror ``{field: number}`` into ``registry`` (default: the process
    one) as ``{prefix}_{field}`` gauges with ``labels``; a no-op under the
    null registry."""
    if registry is None:
        from large_scale_recommendation_tpu_torch.obs.registry import (
            get_registry,
        )

        registry = get_registry()
    if not registry.enabled:
        return
    for field, value in fields.items():
        registry.gauge(f"{prefix}_{field}", **labels).set(value)


def _exclusion_builder(train_u, train_i, num_users: int):
    """Per-chunk train-seen exclusion lists, pow2-padded.

    Returns ``build(cu, c) -> (excl_rows, excl_cols, excl_w)`` (int32,
    int32, float32 numpy, one length, a power of two ≥ 8) for a padded
    chunk ``cu`` of user rows whose first ``c`` are real: entry j excludes
    item row ``excl_cols[j]`` for chunk position ``excl_rows[j]`` with
    weight ``DEAD_SLOT_OFFSET``; pads are ``(0, 0, +inf)``, no-ops under a
    scatter-min, and are told apart from real entries by ``excl_w < 0``.
    Shared by evaluation and serving so the exclusion semantics cannot
    drift between them."""
    if train_u is None:
        ep = pow2_pad(1)  # the same padded shape as an empty train slice

        def build_empty(cu, c):
            z = np.zeros(ep, np.int32)
            return z, z, np.full(ep, np.inf, np.float32)

        return build_empty

    train_u = np.asarray(train_u, dtype=np.int64)
    order = np.argsort(train_u, kind="stable")
    tu = train_u[order]
    ti = np.asarray(train_i, dtype=np.int32)[order]
    starts = np.searchsorted(tu, np.arange(num_users + 1))

    def build(cu, c):
        cu = np.asarray(cu, dtype=np.int64)
        counts = (starts[cu + 1] - starts[cu])[:c]
        e = int(counts.sum())
        rows = np.repeat(np.arange(c, dtype=np.int32), counts)
        # absolute positions of each user's train slice, vectorized
        offs = np.repeat(
            starts[cu[:c]] - np.concatenate([[0], np.cumsum(counts)[:-1]]),
            counts)
        cols = ti[np.arange(e) + offs] if e else np.zeros(0, np.int32)
        ep = pow2_pad(max(e, 1))
        excl_rows = np.zeros(ep, np.int32)
        excl_cols = np.zeros(ep, np.int32)
        excl_w = np.full(ep, np.inf, np.float32)  # pads: min() no-ops
        excl_rows[:e], excl_cols[:e], excl_w[:e] = (
            rows, cols, DEAD_SLOT_OFFSET)
        return excl_rows, excl_cols, excl_w

    return build


def apply_exclusions(scores: torch.Tensor, excl_rows, excl_cols,
                     excl_w) -> torch.Tensor:
    """Scatter-min the exclusion triple (tensors on ``scores``' device)
    onto ``scores`` [b, n] in place: idempotent under duplicate train
    pairs, where an add would stack."""
    n = scores.shape[1]
    flat = excl_rows.long() * n + excl_cols.long()
    scores.view(-1).scatter_reduce_(0, flat, excl_w, "amin")
    return scores


def lax_top_k(scores: torch.Tensor, k: int):
    """``torch.topk`` along the last axis, re-sorted to ``lax.top_k``'s
    order: score descending, lower index first among equal scores. Which of
    several tied indices enters at the k-th place is ``torch.topk``'s
    choice."""
    top, idx = torch.topk(scores, k, dim=-1)
    idx, by_idx = idx.sort(dim=-1)
    top = top.gather(-1, by_idx)
    top, by_score = top.sort(dim=-1, descending=True, stable=True)
    return top, idx.gather(-1, by_score)


class _Scorer:
    """The score surface shared by serving and evaluation: ``U[rows] @ V.T``
    in f32 + ``item_w``, then the chunk's exclusions scatter-min'ed to
    ``DEAD_SLOT_OFFSET``."""

    def __init__(self, U, V, train_u, train_i, item_mask):
        self.U, self.device = U, U.device
        self.Vt = V.float().T
        self.n_items = int(V.shape[0])
        w = np.zeros(self.n_items, np.float32)
        if item_mask is not None:
            w[~np.asarray(item_mask, dtype=bool)] = DEAD_SLOT_OFFSET
        self.item_w = torch.from_numpy(w).to(self.device)
        self.exclusions = _exclusion_builder(train_u, train_i,
                                             int(U.shape[0]))

    def __call__(self, cu: np.ndarray) -> torch.Tensor:
        rows = torch.as_tensor(cu, dtype=torch.int64, device=self.device)
        scores = self.U[rows].float() @ self.Vt
        scores += self.item_w
        excl = self.exclusions(cu, len(cu))
        return apply_exclusions(scores, *(torch.from_numpy(a).to(
            self.device) for a in excl))


def ranking_metrics(U, V, eval_u, eval_i, k: int = 10,
                    train_u=None, train_i=None, chunk: int = 2048,
                    item_mask=None) -> dict:
    """HR@K and NDCG@K by full-catalog ranking of held-out positives.

    Each ``(eval_u, eval_i)`` pair is one positive; the user's scores
    against every item are ranked with the items the user had in training
    (``train_u``/``train_i``) excluded, and the positive's rank r scores
    HR = 1[r < K], NDCG = 1/log2(r+2). Returns ``{"hr", "ndcg", "n"}``
    (means over pairs). Eval/train ids are ROW indices into ``U``/``V``
    (torch tables on one device); ``item_mask`` ([n_item_rows] bool, True =
    real item) keeps padding rows out of the ranked list."""
    eval_u = np.asarray(eval_u, dtype=np.int64)
    eval_i = np.asarray(eval_i, dtype=np.int64)
    n = len(eval_u)
    if n == 0:
        return {"hr": float("nan"), "ndcg": float("nan"), "n": 0}
    score = _Scorer(U, V, train_u, train_i, item_mask)
    hits = ndcg = 0.0
    with _ieee_f32():
        for c0 in range(0, n, chunk):
            scores = score(eval_u[c0:c0 + chunk])
            pos = torch.as_tensor(eval_i[c0:c0 + chunk], device=U.device)
            st = scores.gather(1, pos[:, None])
            rank = (scores > st).sum(dim=1)
            hit = rank < k
            nd = torch.where(hit, 1.0 / torch.log2(rank.float() + 2.0),
                             torch.zeros((), device=U.device))
            hits += float(hit.sum())
            ndcg += float(nd.double().sum())
    return {"hr": hits / n, "ndcg": ndcg / n, "n": n}


def top_k_recommend(U, V, user_rows, k: int = 10,
                    train_u=None, train_i=None, chunk: int = 2048,
                    item_mask=None):
    """Top-K item rows per user by full-catalog score, the serving twin of
    ``ranking_metrics`` (same score surface).

    Inputs are ROW indices into ``U``/``V``; returns ``(top_rows int32
    [n, k], top_scores float32 [n, k])`` as numpy, sorted by descending
    score (ties: lower row first). Excluded or masked slots that still
    surface score below ``DEAD_SLOT_THRESHOLD``; with ``k`` above the
    catalog size the slots past it carry row 0 and score ``-inf``."""
    user_rows = np.asarray(user_rows, dtype=np.int64)
    n = len(user_rows)
    out_rows = np.zeros((n, k), np.int32)
    out_scores = np.full((n, k), -np.inf, np.float32)
    if n == 0:
        return out_rows, out_scores
    score = _Scorer(U, V, train_u, train_i, item_mask)
    kk = min(k, score.n_items)
    with _ieee_f32():
        for c0 in range(0, n, chunk):
            top, idx = lax_top_k(score(user_rows[c0:c0 + chunk]), kk)
            c = idx.shape[0]
            out_rows[c0:c0 + c, :kk] = idx.cpu().numpy()
            out_scores[c0:c0 + c, :kk] = top.cpu().numpy()
    return out_rows, out_scores


def sampled_ranking_metrics(U, V, eval_u, eval_i, k: int = 10,
                            num_negatives: int = 100,
                            train_u=None, train_i=None, item_mask=None,
                            seed: int = 0, chunk: int = 1024) -> dict:
    """HR@K / NDCG@K of held-out positives against sampled negatives.

    Each ``(eval_u, eval_i)`` pair (ROW indices into the torch tables
    ``U``/``V``) is one positive; ``num_negatives`` item rows are drawn
    uniformly from the real catalog (``item_mask`` True rows); negatives
    equal to the positive or train-seen by that user (``train_u``/
    ``train_i``) are masked out of the comparison, and the positive's rank
    r among the rest scores HR = 1[r < K], NDCG = 1/log2(r+2). A random
    model scores HR ≈ k/(n+1).

    The negatives come from ``np.random.default_rng(seed)`` in chunks of
    the JAX package's padded size, so both packages rank against the same
    draws. Returns ``{"hr", "ndcg", "n", "num_negatives",
    "valid_negatives"}`` (means over pairs; ``valid_negatives`` is the
    mean surviving pool size)."""
    eval_u = np.asarray(eval_u)
    eval_i = np.asarray(eval_i, dtype=np.int64)
    n = len(eval_u)
    empty = {"hr": float("nan"), "ndcg": float("nan"), "n": 0,
             "num_negatives": int(num_negatives),
             "valid_negatives": float("nan")}
    if n == 0:
        return empty
    n_rows = int(V.shape[0])
    if item_mask is not None:
        pool = np.nonzero(np.asarray(item_mask))[0].astype(np.int64)
    else:
        pool = np.arange(n_rows, dtype=np.int64)
    if len(pool) == 0:
        return empty

    # train-seen membership via one sorted (user, item) key array
    train_keys = None
    if train_u is not None and len(np.asarray(train_u)):
        tu = np.asarray(train_u, dtype=np.int64)
        ti = np.asarray(train_i, dtype=np.int64)
        train_keys = np.sort(tu * n_rows + ti)

    rng = np.random.default_rng(seed)
    dev = U.device
    hits = ndcg = valid_total = 0.0
    # the JAX package's fixed chunk shape (the draws depend on it)
    chunk = min(chunk, pow2_pad(max(1, n)))
    with _ieee_f32():
        for c0 in range(0, n, chunk):
            cu = eval_u[c0:c0 + chunk]
            ci = eval_i[c0:c0 + chunk]
            c = len(cu)
            if c < chunk:  # pad the tail chunk to the fixed shape
                cu = np.concatenate([cu, np.zeros(chunk - c, cu.dtype)])
                ci = np.concatenate([ci, np.zeros(chunk - c, ci.dtype)])
            neg = pool[rng.integers(0, len(pool), (chunk, num_negatives))]
            valid = neg != ci[:, None]
            if train_keys is not None:
                keys = (cu[:, None].astype(np.int64) * n_rows + neg).ravel()
                pos = np.searchsorted(train_keys, keys)
                pos_c = np.minimum(pos, len(train_keys) - 1)
                seen = (train_keys[pos_c] == keys).reshape(chunk,
                                                           num_negatives)
                valid &= ~seen
            valid_total += float(valid[:c].sum())
            u_rows = U[torch.as_tensor(cu[:c], device=dev)].float()
            v_pos = V[torch.as_tensor(ci[:c], device=dev)].float()
            v_neg = V[torch.as_tensor(neg[:c], device=dev)].float()
            p = (u_rows * v_pos).sum(dim=1)
            sn = torch.bmm(v_neg, u_rows[:, :, None])[..., 0]
            ok = torch.as_tensor(valid[:c], device=dev)
            rank = ((sn > p[:, None]) & ok).sum(dim=1)
            hit = rank < k
            nd = torch.where(hit, 1.0 / torch.log2(rank.float() + 2.0),
                             torch.zeros((), device=dev))
            hits += float(hit.sum())
            ndcg += float(nd.double().sum())
    return {"hr": hits / n, "ndcg": ndcg / n, "n": n,
            "num_negatives": int(num_negatives),
            "valid_negatives": valid_total / n}


def catalog_coverage(U, V, user_rows, k: int = 10, train_u=None,
                     train_i=None, item_mask=None,
                     chunk: int = 2048) -> float:
    """Fraction of the real catalog surfaced across the top-k lists of
    ``user_rows`` (``top_k_recommend``, so coverage measures what users
    would be shown)."""
    user_rows = np.asarray(user_rows)
    if item_mask is not None:
        n_items = int(np.asarray(item_mask).sum())
    else:
        n_items = int(V.shape[0])
    if len(user_rows) == 0 or n_items == 0:
        return float("nan")
    rows, scores = top_k_recommend(U, V, user_rows, k=k, train_u=train_u,
                                   train_i=train_i, chunk=chunk,
                                   item_mask=item_mask)
    real = scores > DEAD_SLOT_THRESHOLD  # dead/below-catalog slots out
    return float(len(np.unique(rows[real])) / n_items)
