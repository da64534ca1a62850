"""Continuous model-quality evaluation (counterpart of
``large_scale_recommendation_tpu.obs.quality``).

- ``sampled_ranking_metrics`` / ``catalog_coverage`` — the shared
  ranking-metric functions, re-exported from ``utils.metrics`` (one copy,
  so the evaluator and every other caller can never drift). Their
  negatives come from ``np.random.default_rng(seed)`` in the JAX
  package's chunk shapes, so both packages rank against the same draws.
- ``OnlineEvaluator`` — a reservoir-sampled holdout drawn from the ingest
  stream and never trained on (``split_batch`` zeroes the holdout rows'
  weights before ``partial_fit`` sees the batch), shadow-scored against
  the live model on a cadence, publishing ``eval_rmse`` /
  ``eval_ndcg_at_k`` / ``eval_hr_at_k`` / ``eval_coverage``; and the
  ``DSGD``/``ALS`` segment-boundary hook ``on_segment``, which scores an
  armed row-space holdout (``ops.sgd.sse_rows`` on the tables' device)
  against each segment's tables.

It keeps the JAX evaluator's two numpy generators (``seed`` for the
split, ``seed + 1`` for the evaluation draws), so its splits and samples
equal the JAX package's draw for draw.

Zero-cost when unused: everything here is opt-in
(``StreamingDriver(evaluator=...)``, ``solver.evaluator = ...``) and every
hook in the hot paths is one ``is not None`` test.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.obs.registry import get_registry
from large_scale_recommendation_tpu_torch.utils.metrics import (
    catalog_coverage,
    sampled_ranking_metrics,
)

__all__ = ["OnlineEvaluator", "catalog_coverage", "sampled_ranking_metrics"]


class OnlineEvaluator:
    """Reservoir-holdout continuous evaluation of a live model.

    ``model`` is an ``OnlineMF`` (the streaming driver passes its
    online model; an ``AdaptiveMF`` caller passes ``.online``) — or
    None for pure offline use (the segment hook). ``split_batch``
    routes a ``holdout_fraction`` of each arriving micro-batch into a
    bounded reservoir (classic reservoir sampling: memory is capped at
    ``reservoir_size`` rows FOREVER, and the sample stays uniform over
    everything ever held out) and zeroes those rows' weights in the
    returned batch — weight-0 is the package-wide padding contract, so
    every training kernel already skips them: the holdout is excluded
    before ``partial_fit`` sees the batch, not merely ignored after.

    ``evaluate()`` shadow-scores the reservoir against the live model
    and publishes ``eval_rmse``, ``eval_ndcg_at_k``, ``eval_hr_at_k``,
    ``eval_coverage`` (+ ``eval_holdout_rows``, ``eval_runs_total``)
    labeled ``source=<source>``. ``start(interval_s)`` runs it on the
    shared ``PeriodicTask`` cadence (``ensure_periodic``).

    Offline form: ``set_offline_holdout(u_rows, i_rows, values)`` arms
    a ROW-SPACE holdout; ``on_segment(U, V)`` — the hook
    ``DSGD``/``ALS`` call at segment boundaries when an evaluator is
    attached (``solver.evaluator = ev``) — scores it against the
    segment's tables, publishing into the same gauges (labeled by the
    segment ``label``), so a batch retrain's quality trajectory lands
    in the same gauges as the online path's.

    Thread-safety: the reservoir lock covers split vs the cadence
    thread's evaluate; evaluation itself runs outside the lock on a
    snapshot (a slow eval must never stall ingest). The model read
    rides the package's documented ``.array`` snapshot-consistency
    point (tables swap atomically between ``partial_fit`` calls) — a
    cadence evaluation concurrent with a capacity-growth rehash may
    drop a pair as unseen for one tick, never corrupt anything.
    """

    def __init__(self, model=None, holdout_fraction: float = 0.1,
                 reservoir_size: int = 4096, k: int = 10,
                 num_negatives: int = 100, eval_sample: int = 1024,
                 min_eval_rows: int = 32, seed: int = 0,
                 source: str = "online", registry=None):
        if not 0.0 < holdout_fraction < 1.0:
            raise ValueError(f"holdout_fraction must be in (0, 1), "
                             f"got {holdout_fraction}")
        if reservoir_size < 1:
            raise ValueError(f"reservoir_size must be >= 1, "
                             f"got {reservoir_size}")
        self.model = model
        self.holdout_fraction = float(holdout_fraction)
        self.reservoir_size = int(reservoir_size)
        self.k = int(k)
        self.num_negatives = int(num_negatives)
        self.eval_sample = int(eval_sample)
        self.min_eval_rows = int(min_eval_rows)
        self.source = source
        # TWO generators, one per thread role: numpy Generators are not
        # thread-safe, and the documented wiring has the ingest thread
        # in split_batch while the cadence thread runs evaluate —
        # sharing one BitGenerator would silently corrupt the very
        # sampling this module exists to make trustworthy. Evaluation
        # draws additionally serialize under the reservoir lock (a
        # manual evaluate() may race the cadence thread's).
        self._split_rng = np.random.default_rng(seed)
        self._eval_rng = np.random.default_rng(seed + 1)
        self._res_u = np.zeros(self.reservoir_size, np.int64)
        self._res_i = np.zeros(self.reservoir_size, np.int64)
        self._res_v = np.zeros(self.reservoir_size, np.float32)
        self._res_n = 0          # filled rows
        self._held_out = 0       # lifetime rows routed to the holdout
        self._seen = 0           # lifetime rows offered to split_batch
        self._lock = threading.Lock()
        self._task = None
        self.evaluations = 0
        self.last_metrics: dict = {}
        # offline (row-space) holdout for the segment hook
        self._off_rows = None
        self._obs = registry or get_registry()

    # -- holdout intake ------------------------------------------------------

    @property
    def holdout_rows(self) -> int:
        with self._lock:
            return self._res_n

    @property
    def held_out_total(self) -> int:
        with self._lock:
            return self._held_out

    def split_batch(self, ratings):
        """Return ``ratings`` with the holdout rows' weights zeroed (a
        same-shape ``Ratings`` — offset stamps, padding layout and batch
        geometry all unchanged), after absorbing those rows into the
        reservoir. Rows already weight-0 (padding, quarantined) are
        never selected. The caller trains on the RETURNED batch."""
        from large_scale_recommendation_tpu_torch.core.types import Ratings

        ru, ri, rv, rw = ratings.to_numpy()
        real = rw > 0
        with self._lock:
            pick = real & (self._split_rng.random(len(rw))
                           < self.holdout_fraction)
            n_pick = int(pick.sum())
            self._seen += int(real.sum())
            if n_pick:
                self._absorb_locked(ru[pick], ri[pick], rv[pick])
        if not n_pick:
            return ratings
        rw = rw.copy()
        rw[pick] = 0.0
        return Ratings.from_arrays(ru, ri, rv, rw)

    def _absorb_locked(self, u, i, v) -> None:
        """Reservoir sampling (Algorithm R, vectorized per batch): while
        filling, rows append; after, each new row replaces a uniformly
        random slot with probability size/held_out — uniform over the
        whole held-out stream, memory capped forever."""
        n = len(u)
        for j in range(n):  # micro-batches hold out tens of rows — the
            self._held_out += 1  # scalar loop is noise next to the update
            if self._res_n < self.reservoir_size:
                slot = self._res_n
                self._res_n += 1
            else:
                slot = int(self._split_rng.integers(0, self._held_out))
                if slot >= self.reservoir_size:
                    continue
            self._res_u[slot] = u[j]
            self._res_i[slot] = i[j]
            self._res_v[slot] = v[j]

    # -- online evaluation ---------------------------------------------------

    def evaluate(self) -> dict | None:
        """Shadow-score the reservoir against the live model and publish
        the ``eval_*`` gauges. Returns the metrics dict, or None when
        the reservoir is still below ``min_eval_rows`` (a baseline
        learned from a handful of pairs is noise — the same warming
        discipline as ``AnomalyCheck``)."""
        model = self.model
        if model is None:
            return None
        with self._lock:
            n = self._res_n
            if n < self.min_eval_rows:
                return None
            u = self._res_u[:n].copy()
            i = self._res_i[:n].copy()
            v = self._res_v[:n].copy()
        from large_scale_recommendation_tpu_torch.core.types import Ratings

        rmse = model.rmse(Ratings.from_arrays(u, i, v))
        # ranking in row space against the live tables: pairs whose user
        # or item the model has never seen drop (the package-wide
        # inner-join contract); phantom capacity rows mask out of the
        # negative pool and the coverage denominator
        u_rows, u_mask = model.users.rows_for(u)
        i_rows, i_mask = model.items.rows_for(i)
        keep = (u_mask * i_mask) > 0
        u_rows, i_rows = u_rows[keep], i_rows[keep]
        metrics = {"rmse": float(rmse), "n": int(n),
                   "ranked": int(keep.sum()), "time": time.time()}
        if len(u_rows):
            if len(u_rows) > self.eval_sample:
                with self._lock:
                    sel = self._eval_rng.choice(
                        len(u_rows), self.eval_sample, replace=False)
                u_rows, i_rows = u_rows[sel], i_rows[sel]
            V = model.items.array
            item_mask = np.asarray(model.items.id_array()) >= 0
            if len(item_mask) < int(V.shape[0]):  # capacity > ids filled
                item_mask = np.concatenate([
                    item_mask,
                    np.zeros(int(V.shape[0]) - len(item_mask), bool)])
            with self._lock:
                rank_seed = int(self._eval_rng.integers(1 << 31))
            rq = sampled_ranking_metrics(
                model.users.array, V, u_rows, i_rows, k=self.k,
                num_negatives=self.num_negatives, item_mask=item_mask,
                seed=rank_seed)
            cov_users = np.unique(u_rows)
            if len(cov_users) > 256:
                with self._lock:
                    cov_users = self._eval_rng.choice(cov_users, 256,
                                                      replace=False)
            cov = catalog_coverage(model.users.array, V, cov_users,
                                   k=self.k, item_mask=item_mask)
            metrics.update(ndcg=rq["ndcg"], hr=rq["hr"], coverage=cov,
                           valid_negatives=rq["valid_negatives"])
        self._publish(metrics, self.source)
        self.evaluations += 1
        self.last_metrics = metrics
        return metrics

    def _publish(self, metrics: dict, source: str) -> None:
        """EVERY instrument resolves per publish source — the segment
        hook publishes under its segment label, and one evaluator may
        serve both a streaming driver and a batch solver; pre-bound
        instruments would stomp the online reservoir gauge with the
        offline holdout size (registry lookups are cached dict gets)."""
        obs = self._obs
        if math.isfinite(metrics.get("rmse", float("nan"))):
            obs.gauge("eval_rmse", source=source).set(metrics["rmse"])
        for key, gauge in (("ndcg", "eval_ndcg_at_k"),
                           ("hr", "eval_hr_at_k"),
                           ("coverage", "eval_coverage")):
            val = metrics.get(key)
            if val is not None and math.isfinite(val):
                obs.gauge(gauge, source=source, k=self.k).set(val)
        obs.gauge("eval_holdout_rows", source=source).set(
            metrics.get("n", 0))
        obs.counter("eval_runs_total", source=source).inc()

    # -- cadence (shared PeriodicTask machinery) -----------------------------

    def start(self, interval_s: float = 5.0) -> "OnlineEvaluator":
        """Run ``evaluate()`` every ``interval_s`` on a daemon thread
        (``ensure_periodic``)."""
        from large_scale_recommendation_tpu_torch.obs.health import (
            ensure_periodic,
        )

        self._task = ensure_periodic(self._task, self.evaluate, interval_s,
                                     name=f"online-eval:{self.source}")
        return self

    def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.stop()

    @property
    def running(self) -> bool:
        return self._task is not None and self._task.running

    # -- offline (segment-boundary) form -------------------------------------

    def set_offline_holdout(self, u_rows, i_rows, values,
                            item_mask=None) -> None:
        """Arm a ROW-SPACE holdout for the segment hook: ``u_rows`` /
        ``i_rows`` index the solver's factor tables directly (offline
        blocking is deterministic given ratings+seed, so a caller can
        map a held-out split to rows before or after ``fit``)."""
        self._off_rows = (np.asarray(u_rows), np.asarray(i_rows),
                          np.asarray(values, np.float32),
                          None if item_mask is None
                          else np.asarray(item_mask))

    def on_segment(self, U, V, label: str = "segment",
                   step: int | None = None) -> dict | None:
        """The ``DSGD``/``ALS`` segment-boundary hook: score the armed
        offline holdout against the segment's row-space tables and
        publish into the same ``eval_*`` gauges (labeled
        ``source=label``). A no-op without ``set_offline_holdout`` —
        attaching an online evaluator to a batch solver costs one
        pointer test per segment."""
        if self._off_rows is None:
            return None
        from large_scale_recommendation_tpu_torch.ops import sgd as sgd_ops

        u_rows, i_rows, vals, item_mask = self._off_rows
        n = len(u_rows)
        if n == 0:
            return None
        Uf, Vf = U.float(), V.float()
        dev = Uf.device
        sse = sgd_ops.sse_rows(
            Uf, Vf, torch.as_tensor(u_rows, device=dev).long(),
            torch.as_tensor(i_rows, device=dev).long(),
            torch.as_tensor(vals, device=dev),
            torch.ones(n, dtype=torch.float32, device=dev))
        rmse = float(np.sqrt(float(sse) / n))
        sel = np.arange(n)
        with self._lock:
            if n > self.eval_sample:
                sel = self._eval_rng.choice(n, self.eval_sample,
                                            replace=False)
            rank_seed = int(self._eval_rng.integers(1 << 31))
        rq = sampled_ranking_metrics(
            Uf, Vf, u_rows[sel], i_rows[sel], k=self.k,
            num_negatives=self.num_negatives, item_mask=item_mask,
            seed=rank_seed)
        metrics = {"rmse": rmse, "n": int(n), "ndcg": rq["ndcg"],
                   "hr": rq["hr"], "step": step, "time": time.time()}
        self._publish(metrics, label)
        self.evaluations += 1
        self.last_metrics = metrics
        return metrics

    def snapshot(self) -> dict:
        """JSON-safe state for bundles / reports."""
        with self._lock:
            res_n, held, seen = self._res_n, self._held_out, self._seen
        return {"source": self.source,
                "holdout_fraction": self.holdout_fraction,
                "reservoir_size": self.reservoir_size,
                "holdout_rows": res_n,
                "held_out_total": held,
                "rows_seen": seen,
                "evaluations": self.evaluations,
                "last_metrics": dict(self.last_metrics)}
