"""Growable factor tables: a dynamic vocabulary on fixed-shape device
tensors (counterpart of the ``GrowableFactorTable`` of
``large_scale_recommendation_tpu.data.tables``).

- a dense ``float32[capacity, rank]`` tensor on the table's device,
- a host-side id buffer in row order and a sorted id index (vectorized
  binary search, no per-id Python),
- power-of-two capacity growth,
- new rows initialized from the pluggable initializer BY ID, in padded
  installs of the JAX package's sizes.

Snapshot semantics are the JAX package's: ``table.array`` is never written
in place. Installs, growth, restores and trained tables each bind a new
tensor, so a reference a caller took between micro-batches keeps its
values (``ops.sgd.online_train`` trains copies).
"""

from __future__ import annotations

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.core.types import FactorVector
from large_scale_recommendation_tpu_torch.utils.device import resolve_device
from large_scale_recommendation_tpu_torch.utils.shapes import (
    next_pow2 as _next_pow2,
    pow2_pad as _pow2_pad,
)


class GrowableFactorTable:
    """A factor matrix with ``getOrElseUpdate`` semantics on a device: row
    assignment is first-seen order, as a sequential getOrElseUpdate would
    give. ``device=None`` is the card."""

    def __init__(self, initializer, capacity: int = 1024, device=None):
        self.initializer = initializer
        self.rank = initializer.rank
        self.device = resolve_device(device)
        self._sorted_cache: tuple[np.ndarray, np.ndarray] | None = None
        self.capacity = max(_next_pow2(capacity), 8)
        # registered ids in row order; row of _ids_buf[j] is j
        self._ids_buf = np.empty(self.capacity, np.int64)
        self._n = 0
        self.array = self._make_array()

    def _make_array(self):
        """Initial storage (a subclass hook: ``HostFactorTable`` keeps
        numpy, a tiered store its slot pool)."""
        return torch.zeros((self.capacity, self.rank), dtype=torch.float32,
                           device=self.device)

    # -- vocabulary --------------------------------------------------------

    @property
    def num_rows(self) -> int:
        return self._n

    def __contains__(self, ident: int) -> bool:
        _, found = self.rows_for(np.asarray([ident]))
        return bool(found[0])

    def ensure(self, ids: np.ndarray) -> np.ndarray:
        """Register any unseen ids (initializing their rows) and return the
        row of every input id, vectorized (bulk binary search +
        ``np.unique``)."""
        ids = np.asarray(ids).astype(np.int64)
        rows, found_f = self.rows_for(ids)
        known = found_f > 0
        if known.all():
            return rows
        new_mask = ~known
        # dense rows for the unseen ids, in first-seen order
        stream = ids[new_mask]
        uniq, first_idx, inv = np.unique(stream, return_index=True,
                                         return_inverse=True)
        order = np.argsort(first_idx, kind="stable")
        rank_of = np.empty(len(uniq), dtype=np.int64)
        rank_of[order] = np.arange(len(uniq))
        base = self._n
        rows[new_mask] = base + rank_of[inv]

        m = len(uniq)
        # the install is pow2-padded with a capacity-scaled floor taken
        # from the post-growth capacity (the JAX package's install shapes);
        # pad rows land in unregistered capacity
        floor = min(65536, max(8, self.capacity >> 3))
        pad = _pow2_pad(m, floor)
        if base + pad > self.capacity:
            if base + m == self.capacity:
                pad = m  # exact fill: no growth for padding headroom alone
            else:
                # a partial boundary install grows rather than clamps (at
                # most two rounds: the floor is capped, the pad converges)
                while base + pad > self.capacity:
                    self._grow(base + pad)
                    floor = min(65536, max(8, self.capacity >> 3))
                    pad = _pow2_pad(m, floor)
        self._ids_buf[base:base + m] = uniq[order]
        self._n = base + m
        if self._sorted_cache is not None:
            # merge the m new (value-sorted) ids into the sorted index:
            # O(n + m), not a full re-sort per micro-batch
            s_ids, s_rows = self._sorted_cache
            pos = np.searchsorted(s_ids, uniq)
            self._sorted_cache = (
                np.insert(s_ids, pos, uniq),
                np.insert(s_rows, pos, base + rank_of),
            )
        # pad with a REPEATED REAL id: a domain-sensitive initializer only
        # ever sees ids the caller registered
        ids_pad = np.full(pad, self._ids_buf[base + m - 1], np.int64)
        ids_pad[:m] = self._ids_buf[base:base + m]
        fresh = self.initializer(torch.as_tensor(ids_pad, device=self.device))
        self._install(fresh.to(device=self.device, dtype=torch.float32),
                      base)
        return rows

    def _install(self, fresh: torch.Tensor, base: int) -> None:
        """Rows [base, base + len(fresh)) ← ``fresh``, into a NEW tensor."""
        table = self.array.clone()
        table[base:base + fresh.shape[0]] = fresh
        self.array = table

    def rows_for(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Look up rows WITHOUT registering; unknown ids → row 0, mask 0."""
        ids = np.asarray(ids).astype(np.int64)
        sorted_ids, sorted_rows = self._sorted_index()
        if sorted_ids.size == 0:
            return np.zeros(len(ids), np.int64), np.zeros(len(ids), np.float32)
        pos = np.searchsorted(sorted_ids, ids)
        pos = np.clip(pos, 0, sorted_ids.size - 1)
        found = sorted_ids[pos] == ids
        rows = np.where(found, sorted_rows[pos], 0)
        return rows, found.astype(np.float32)

    def _sorted_index(self) -> tuple[np.ndarray, np.ndarray]:
        if self._sorted_cache is None or self._sorted_cache[0].size != self._n:
            all_ids = self._ids_buf[:self._n]
            order = np.argsort(all_ids).astype(np.int64)
            self._sorted_cache = (all_ids[order], order)
        return self._sorted_cache

    def id_array(self) -> np.ndarray:
        """Registered ids in row order (int64 copy)."""
        return self._ids_buf[:self._n].copy()

    def sorted_index(self) -> tuple[np.ndarray, np.ndarray]:
        """The (sorted_ids, sorted_rows) pair of the maintained index."""
        return self._sorted_index()

    def _grow(self, need: int) -> None:
        new_cap = _next_pow2(need)
        pad = torch.zeros((new_cap - self.capacity, self.rank),
                          dtype=torch.float32, device=self.device)
        self.array = torch.cat([self.array, pad])
        ids_buf = np.empty(new_cap, np.int64)
        ids_buf[:self._n] = self._ids_buf[:self._n]
        self._ids_buf = ids_buf
        self.capacity = new_cap

    # -- access ------------------------------------------------------------

    def _host_rows(self, rows: np.ndarray) -> np.ndarray:
        return self.array[torch.as_tensor(rows, device=self.device)].cpu() \
            .numpy()

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """Factor vectors for ids (must be registered)."""
        rows, found = self.rows_for(ids)
        if not np.all(found > 0):
            missing = np.asarray(ids)[found == 0]
            raise KeyError(f"unregistered ids: {missing[:10].tolist()}")
        return self._host_rows(rows)

    def factor_vectors(self, ids=None):
        """Iterate ``FactorVector``s for ``ids`` (default: all); only the
        requested rows leave the device."""
        if ids is None:
            ids = self._ids_buf[:self._n]
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size == 0:
            return
        rows, found = self.rows_for(ids)
        if not np.all(found > 0):
            missing = ids[found == 0]
            raise KeyError(f"unregistered ids: {missing[:10].tolist()}")
        host = self._host_rows(rows)
        for j, ident in enumerate(ids.tolist()):
            yield FactorVector(ident, host[j])

    def as_dict(self) -> dict[int, np.ndarray]:
        """Full model export as id → vector (host)."""
        host = self.array.cpu().numpy()
        return {int(i): host[r]
                for r, i in enumerate(self._ids_buf[:self._n].tolist())}

    def ids(self) -> list[int]:
        return self._ids_buf[:self._n].tolist()

    # -- the seams a tiered store overrides (plain behaviour here) ---------

    def acquire_rows(self, ids: np.ndarray) -> np.ndarray:
        """Register ``ids`` and return the rows training should index."""
        return self.ensure(ids)

    def release_rows(self, rows: np.ndarray) -> None:
        """Drop what ``acquire_rows`` pinned (nothing, on a plain table)."""

    def gather_rows(self, rows: np.ndarray) -> torch.Tensor:
        """float32 values of ``rows``, gathered on the table's device (a
        copy: later commits do not reach it)."""
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        return self.array.index_select(0, idx)

    def commit_rows(self, updated: torch.Tensor, idx) -> None:
        """``updated``'s rows at ``idx`` into a new live table (``idx``
        pow2-padded with repeated own rows)."""
        idx = torch.as_tensor(idx, device=self.device)
        table = self.array.clone()
        table[idx] = updated[idx]
        self.array = table

    def install_trained(self, updated: torch.Tensor, rows: np.ndarray) -> None:
        """Serial-path install: ``updated`` IS the new table."""
        self.array = updated

    def snapshot_rows(self, n: int) -> torch.Tensor:
        """The first ``n`` rows for a checkpoint (a view: the table is never
        written in place, so it cannot tear)."""
        return self.array[:n]

    def load_rows(self, rows: np.ndarray, values) -> None:
        """Factor rows (host values or a tensor on any device) into a new
        table: a checkpoint restore, a retrain's install."""
        if not isinstance(values, torch.Tensor):
            values = np.asarray(values)
        table = self.array.clone()
        table[torch.as_tensor(rows, device=self.device)] = torch.as_tensor(
            values, device=self.device, dtype=torch.float32)
        self.array = table

    def full_table(self) -> torch.Tensor:
        """The whole table (offline/eval consumers)."""
        return self.array


class HostFactorTable(GrowableFactorTable):
    """Host-resident twin of ``GrowableFactorTable``: numpy storage, the
    same getOrElseUpdate semantics and id machinery.

    For bookkeeping-only consumers: the PS server shards gather rows on
    pull and add deltas on push, and no product ever touches their table,
    so it stays on the host (a device table would cost two transfers per
    request). Initializers run on the CPU. ``as_dict`` hands out copies:
    pushes write the live numpy table in place."""

    def __init__(self, initializer, capacity: int = 1024):
        super().__init__(initializer, capacity=capacity, device="cpu")

    def _make_array(self):
        return np.zeros((self.capacity, self.rank), np.float32)

    def as_dict(self) -> dict[int, np.ndarray]:
        host = self.array
        return {int(i): host[r].copy()
                for r, i in enumerate(self._ids_buf[:self._n].tolist())}

    def _install(self, fresh, base: int) -> None:
        f = np.asarray(fresh, dtype=np.float32)
        self.array[base:base + len(f)] = f

    def _grow(self, need: int) -> None:
        new_cap = _next_pow2(need)
        arr = np.zeros((new_cap, self.rank), np.float32)
        arr[:self.capacity] = self.array
        self.array = arr
        ids_buf = np.empty(new_cap, np.int64)
        ids_buf[:self._n] = self._ids_buf[:self._n]
        self._ids_buf = ids_buf
        self.capacity = new_cap

    def _host_rows(self, rows: np.ndarray) -> np.ndarray:
        return self.array[np.asarray(rows, np.int64)].copy()

    def gather_rows(self, rows: np.ndarray) -> np.ndarray:
        return np.asarray(self.array[np.asarray(rows, np.int64)],
                          np.float32)

    def commit_rows(self, updated, idx) -> None:
        idx = np.asarray(idx, np.int64)
        self.array[idx] = np.asarray(updated, np.float32)[idx]

    def load_rows(self, rows: np.ndarray, values) -> None:
        if isinstance(values, torch.Tensor):
            values = values.cpu().numpy()
        self.array[np.asarray(rows, np.int64)] = np.asarray(values,
                                                            np.float32)
