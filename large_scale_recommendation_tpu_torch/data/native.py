"""Host-side blocking primitives (counterpart of the numpy routes of
``large_scale_recommendation_tpu.data.native``).

Only the numpy implementations are ported here; the JAX package's native
``csrc/fastblock.cpp`` library computes the same results faster and is
rebuilt for the port in a later slice. The layout callers build from these
primitives is identical either way (``build_id_index`` re-sorts by id).
"""

from __future__ import annotations

import numpy as np


def compact_ids(
    ids: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense compaction of an id list, sorted by id.

    Returns (unique_ids, inverse_indices, counts) — counts are the omegas
    (per-id occurrence counts)."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    uniq, idx, counts = np.unique(ids, return_inverse=True,
                                  return_counts=True)
    return uniq, idx, counts


def stable_bucket(keys: np.ndarray, perm: np.ndarray,
                  num_keys: int) -> np.ndarray:
    """Order indices: ``perm`` stably grouped by ``keys[perm]``."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    if len(keys) and (keys.min() < 0 or keys.max() >= num_keys):
        raise ValueError(
            f"stable_bucket keys outside [0, {num_keys}): "
            f"min={keys.min()} max={keys.max()}"
        )
    return perm[np.argsort(keys[perm], kind="stable")]


def minibatch_inv_counts_flat(rows: np.ndarray, weights: np.ndarray,
                              minibatch: int) -> np.ndarray:
    """Per-entry 1/(occurrences of rows[j] in its minibatch chunk); weight-0
    entries get 1.0 and don't count."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    flat = rows.astype(np.int64)
    chunk = np.arange(flat.size, dtype=np.int64) // minibatch
    w = weights > 0
    key = chunk * (int(flat.max(initial=0)) + 2) + flat
    key = np.where(w, key, -1)
    _, inverse, counts = np.unique(key, return_inverse=True,
                                   return_counts=True)
    inv = (1.0 / counts[inverse]).astype(np.float32)
    return np.where(w, inv, 1.0).astype(np.float32)
