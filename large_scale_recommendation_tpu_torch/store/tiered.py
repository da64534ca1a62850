"""``TieredFactorStore``: the user table beyond device memory (counterpart
of ``large_scale_recommendation_tpu.store.tiered``).

Layout:

- **cold tier** — the whole table as host ``float32[capacity, rank]``,
  in pinned memory when the store's device is a card (re-pinned when
  growth doubles it); ``mmap_dir`` swaps it for an ``np.memmap`` file per
  capacity level. Rows are the first-seen-order rows a plain
  ``GrowableFactorTable`` assigns (the id machinery IS the base class's),
  so checkpoints, ``rows_for`` and serving row maps are unchanged.
- **hot tier** — a fixed device pool ``float32[slot_capacity, rank]``
  (``.array``). It never grows.
- **maps** — ``_row_slot`` (cold row → slot, −1 cold) and ``_slot_row``
  (slot → cold row, −1 free), per-slot dirty bits, pin refcounts and LRU
  ticks (ordered by a tick, stable among equal ticks).

Training indexes SLOTS: ``acquire_rows(ids)`` registers the ids, faults
their rows hot (write-back LRU eviction of unpinned slots), pins them and
returns slot indices; ``install_trained`` / ``commit_rows`` scatter
trained values into the live pool; ``release_rows`` unpins.

Copies on a card. Slot loads (demand faults, prefetch, warm-ups) gather
the cold rows into a pinned staging buffer (the bounce buffer of an
``mmap_dir`` tier too) and copy it host → card with ``non_blocking=True``
on a side CUDA stream, recording an event after the copy; the staging
buffer is refilled only after that event has fired. The new pool is
built on the caller's stream after it waits on the event, and the copied
tensors are ``record_stream``-ed to it, so the caching allocator never
reuses them early. A dirty write-back (eviction, snapshots, reads of hot
rows) copies card → host through a pinned buffer on the caller's stream
and waits for its event before the cold row is written or the slot
reloaded. The store's consumers run on the default stream.

Pool visibility: the pool is never written in place. Every load, commit
or restore binds a new tensor (a copy of the pool with the rows
replaced), so a reader holding the old binding (a concurrent apply's
snapshot, a serving gather) never sees a partial write.

Exactness. The id → slot map is injective within a batch, so
``online_train`` sees the same collision structure as on a plain table;
slot values are exact f32 copies of cold rows; pad entries of a caller's
padded index repeat a real owned slot; concurrent commits scatter only
their own pinned slots. On the CPU (sequential ``index_add_``) tiered and
untiered runs are therefore bit-equal at any pool size. On the card
``online_train``'s ``index_add_`` adds duplicates with atomics in any
order, so two untiered runs already differ in the last places: there the
tiered run is held to the online card bar, not to bit equality.

Two rules keep the row layout equal to an untiered run: prefetch never
registers vocabulary (unknown ids are dropped), and hit accounting
excludes installs (a first-seen row counts as an install, not a miss).

Every crossing notes the transfer ledger (``obs.transfers``) when one is
installed, in logical bytes that reconcile with ``StoreStats``:
``store.demand_fault`` / ``store.prefetch`` (h2d slot loads),
``store.writeback`` (d2h) and ``store.serve_cold`` (h2d serve misses). The
store's lock is the contention plane's ``store.tiered``.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.data.tables import (
    GrowableFactorTable,
)
from large_scale_recommendation_tpu_torch.obs.contention import named_rlock
from large_scale_recommendation_tpu_torch.obs.registry import get_registry
from large_scale_recommendation_tpu_torch.obs.store import set_store
from large_scale_recommendation_tpu_torch.obs.transfers import get_transfers
from large_scale_recommendation_tpu_torch.utils.shapes import (
    next_pow2 as _next_pow2,
)


@dataclasses.dataclass
class StoreStats:
    """Always-on host counters. ``hits`` / ``misses`` count the training
    acquire path only, and only revisited rows: first-seen registrations
    count as ``installs`` (vocabulary growth an untiered run pays
    identically). Serving traffic has its own pair."""

    hits: int = 0
    misses: int = 0
    installs: int = 0
    prefetched: int = 0
    evictions: int = 0
    writebacks: int = 0
    demand_fault_s: float = 0.0
    serve_hits: int = 0
    serve_misses: int = 0
    host_bytes: int = 0

    @property
    def hit_rate(self) -> float:
        seen = self.hits + self.misses
        return self.hits / seen if seen else 1.0

    def snapshot(self) -> dict:
        out = dataclasses.asdict(self)
        out["hit_rate"] = self.hit_rate
        return out


class TieredFactorStore(GrowableFactorTable):
    """Drop-in ``GrowableFactorTable`` whose device array is a fixed slot
    pool over a host cold tier.

    ``slot_capacity`` is the device budget in rows (rounded up to a power
    of two, at least 8); every concurrently pinned working set must fit
    it, or ``acquire_rows`` raises with the accounting. ``device=None`` is
    the card. ``mmap_dir`` backs the cold tier with ``np.memmap`` files.

    ``stats`` holds the counters. With obs enabled at construction the
    store also publishes the JAX package's registry instruments
    (``tier_hit_rate``, ``tier_prefetch_wait_s``, ``tier_evictions_total``,
    ``tier_host_bytes``), and construction installs the store as the
    process's STORE plane (``obs.store``, ``/storez``: latest wins).
    """

    def __init__(self, initializer, capacity: int = 1024,
                 slot_capacity: int = 256, device=None,
                 mmap_dir: str | None = None):
        self.slot_capacity = max(_next_pow2(int(slot_capacity)), 8)
        self._mmap_dir = mmap_dir
        S = self.slot_capacity
        self._slot_row = np.full(S, -1, np.int64)
        self._slot_dirty = np.zeros(S, bool)
        self._slot_pin = np.zeros(S, np.int64)
        self._slot_tick = np.zeros(S, np.int64)
        self._tick = 0
        self.stats = StoreStats()
        # one reentrant lock over every map / tier mutation; with a model:
        # apply_lock → store lock (acquire / commit / snapshot run under
        # the model's apply_lock in concurrent mode), while the serving and
        # prefetch threads take the store lock alone. Raw unless the
        # contention plane is armed (lock_*{lock="store.tiered"}).
        self._lock = named_rlock("store.tiered")
        obs = get_registry()
        self._obs_on = obs.enabled
        self._m_hit_rate = obs.gauge("tier_hit_rate")
        self._m_wait = obs.counter("tier_prefetch_wait_s")
        self._m_evictions = obs.counter("tier_evictions_total")
        self._m_host_bytes = obs.gauge("tier_host_bytes")
        super().__init__(initializer, capacity=capacity, device=device)
        self._publish_host_bytes()
        set_store(self)

    # -- storage hooks (base-class seams) ------------------------------------

    def _alloc_cold(self, cap: int) -> np.ndarray:
        if self._mmap_dir is not None:
            os.makedirs(self._mmap_dir, exist_ok=True)
            # one file per capacity level: growth maps a fresh file and
            # copies (O(log n) times in all)
            path = os.path.join(self._mmap_dir,
                                f"cold_{cap}x{self.rank}.f32")
            return np.memmap(path, dtype=np.float32, mode="w+",
                             shape=(cap, self.rank))
        # pinned on a card (an allocation failure raises); the numpy view
        # keeps the tensor's memory alive
        return torch.zeros((cap, self.rank), dtype=torch.float32,
                           pin_memory=self._cuda).numpy()

    def _make_array(self) -> torch.Tensor:
        self._cuda = self.device.type == "cuda"
        # the side stream of the host → card slot loads, and the pinned
        # staging (loads) / write-back (card → host) buffers with the
        # event of the last copy out of the staging buffer
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)
        self._stage = self._stage_idx = self._wb = None
        self._stage_ev = None
        self.cold = self._alloc_cold(self.capacity)
        self._row_slot = np.full(self.capacity, -1, np.int64)
        return torch.zeros((self.slot_capacity, self.rank),
                           dtype=torch.float32, device=self.device)

    @property
    def array(self) -> torch.Tensor:
        """The device SLOT POOL (fixed shape): what training kernels index
        after ``acquire_rows`` translated rows to slots."""
        return self._pool

    @array.setter
    def array(self, value) -> None:
        self._pool = value

    def _install(self, fresh, base: int) -> None:
        # initializer output for newly registered (+pad) rows lands in the
        # cold tier; rows fault hot on first acquire (store lock held)
        f = fresh.cpu().numpy() if isinstance(fresh, torch.Tensor) \
            else np.asarray(fresh, np.float32)
        self.cold[base:base + len(f)] = f

    def _grow(self, need: int) -> None:
        new_cap = _next_pow2(need)
        cold = self._alloc_cold(new_cap)
        cold[:self.capacity] = self.cold[:self.capacity]
        self.cold = cold
        row_slot = np.full(new_cap, -1, np.int64)
        row_slot[:self.capacity] = self._row_slot
        self._row_slot = row_slot
        ids_buf = np.empty(new_cap, np.int64)
        ids_buf[:self._n] = self._ids_buf[:self._n]
        self._ids_buf = ids_buf
        self.capacity = new_cap
        self._publish_host_bytes()

    def ensure(self, ids: np.ndarray) -> np.ndarray:
        # the prefetch and serving threads read the id machinery
        # concurrently with the apply path: every entry takes the lock
        with self._lock:
            return super().ensure(ids)

    def rows_for(self, ids: np.ndarray):
        with self._lock:  # the id lookup mutates under a concurrent ensure
            return super().rows_for(ids)

    def _publish_host_bytes(self) -> None:
        n = int(self.cold.nbytes + self._ids_buf.nbytes
                + self._row_slot.nbytes)
        self.stats.host_bytes = n
        if self._obs_on:
            self._m_host_bytes.set(n)

    # -- copies (store lock held) --------------------------------------------

    def _pinned(self, name: str, rows: int, cols: int, dtype) -> torch.Tensor:
        """A pinned host buffer of at least ``rows`` rows, kept and grown
        to the next power of two."""
        buf = getattr(self, name)
        if buf is None or buf.shape[0] < rows:
            shape = (_next_pow2(rows),) + ((cols,) if cols else ())
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            setattr(self, name, buf)
        return buf[:rows]

    def _to_device(self, rows: np.ndarray, idx: np.ndarray
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Cold ``rows`` and the int64 ``idx`` as tensors on the store's
        device, ready on the caller's stream. On a card: staged through the
        pinned buffers and copied on the side stream."""
        n = len(rows)
        if not self._cuda:
            vals = torch.from_numpy(np.take(self.cold, rows, axis=0))
            return vals, torch.from_numpy(np.asarray(idx, np.int64))
        if self._stage_ev is not None:
            # the last copy out of the staging buffers must have landed
            # before they are refilled
            self._stage_ev.synchronize()
        stage = self._pinned("_stage", n, self.rank, torch.float32)
        stage_idx = self._pinned("_stage_idx", n, 0, torch.int64)
        np.take(self.cold, rows, axis=0, out=stage.numpy())
        stage_idx.numpy()[:] = idx
        cur = torch.cuda.current_stream(self.device)
        side = self._copy_stream
        with torch.cuda.stream(side):
            vals = stage.to(self.device, non_blocking=True)
            didx = stage_idx.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(side)
        self._stage_ev = ev
        cur.wait_event(ev)
        # made on the side stream, read on the caller's
        vals.record_stream(cur)
        didx.record_stream(cur)
        return vals, didx

    def _gather_pool(self, slots: np.ndarray) -> np.ndarray:
        """Host copy of pool ``slots`` (write-backs, merged reads): on a
        card through the pinned write-back buffer, landed before return."""
        idx = torch.from_numpy(np.asarray(slots, np.int64)).to(self.device)
        vals = self._pool.index_select(0, idx)
        if not self._cuda:
            return vals.numpy()
        out = self._pinned("_wb", len(slots), self.rank, torch.float32)
        out.copy_(vals, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        ev.synchronize()
        return out.numpy().copy()

    def _write_pool(self, slots: np.ndarray, rows: np.ndarray) -> None:
        """A new pool binding whose ``slots`` hold the cold ``rows``."""
        vals, idx = self._to_device(rows, slots)
        self._pool = self._pool.clone().index_copy_(0, idx, vals)

    # -- fault / eviction core (store lock held) ------------------------------

    def _evict(self, victims: np.ndarray) -> None:
        dirty = self._slot_dirty[victims]
        if dirty.any():
            dv = victims[dirty]
            ledger = get_transfers()
            t0 = time.perf_counter() if ledger is not None else 0.0
            # the write-back lands in the cold tier before the slot is
            # reused
            self.cold[self._slot_row[dv]] = self._gather_pool(dv)
            if ledger is not None:  # logical bytes: len(dv) == writebacks
                ledger.note_transfer("store.writeback", "d2h",
                                     len(dv) * self.rank * 4,
                                     time.perf_counter() - t0)
            self.stats.writebacks += int(dirty.sum())
        self._row_slot[self._slot_row[victims]] = -1
        self._slot_row[victims] = -1
        self._slot_dirty[victims] = False
        self.stats.evictions += len(victims)
        if self._obs_on:
            self._m_evictions.inc(len(victims))

    def _load_slots(self, slots: np.ndarray, rows: np.ndarray) -> None:
        self._write_pool(slots, rows)
        self._slot_row[slots] = rows
        self._row_slot[rows] = slots
        self._slot_tick[slots] = self._tick
        self._tick += 1

    def _fault_in(self, uniq_rows: np.ndarray, pin: bool, dirty: bool,
                  best_effort: bool = False, demand: bool = True,
                  fresh: int = 0) -> int:
        """Make ``uniq_rows`` (unique cold rows) resident; returns the rows
        faulted. ``best_effort`` (prefetch, warm-ups) loads what fits
        instead of raising when pinned demand exceeds the pool. ``fresh``
        of the rows were first registered by this call: they fault, but
        count as installs, not misses."""
        slots = self._row_slot[uniq_rows]
        hot = slots >= 0
        hs = slots[hot]
        if hs.size:
            self._slot_tick[hs] = self._tick
            self._tick += 1
            if pin:
                self._slot_pin[hs] += 1
            if dirty:
                self._slot_dirty[hs] = True
        miss_rows = uniq_rows[~hot]
        if demand:
            self.stats.hits += int(hs.size)
            self.stats.misses += int(miss_rows.size) - fresh
            self.stats.installs += fresh
            if self._obs_on:
                self._m_hit_rate.set(self.stats.hit_rate)
        if miss_rows.size == 0:
            return 0
        free = np.nonzero(self._slot_row < 0)[0]
        need = len(miss_rows)
        if len(free) < need:
            shortfall = need - len(free)
            cand = np.nonzero((self._slot_row >= 0)
                              & (self._slot_pin == 0))[0]
            if len(cand) < shortfall:
                if best_effort:
                    take_n = len(free) + len(cand)
                    if take_n == 0:
                        return 0
                    miss_rows = miss_rows[:take_n]
                    need = take_n
                    shortfall = need - len(free)
                else:
                    if pin and hs.size:  # a raising acquire leaks no pin
                        self._slot_pin[hs] -= 1
                    pinned = int((self._slot_pin > 0).sum())
                    raise RuntimeError(
                        f"tiered store overcommitted: need {need} slots "
                        f"for one working set but only {len(free)} free "
                        f"+ {len(cand)} evictable of {self.slot_capacity} "
                        f"({pinned} pinned) — raise slot_capacity or "
                        "shrink the micro-batch")
            if shortfall > 0:
                # least recently used first, stable among equal ticks
                order = np.argsort(self._slot_tick[cand], kind="stable")
                self._evict(cand[order[:shortfall]])
                free = np.nonzero(self._slot_row < 0)[0]
        take = free[:need]
        ledger = get_transfers()
        t0 = time.perf_counter() if ledger is not None else 0.0
        self._load_slots(take, miss_rows)
        if ledger is not None:
            # logical bytes (need == misses + installs on the demand path,
            # == prefetched on the lookahead path); the copy is async from
            # pinned memory, so the wall is the host's enqueue
            ledger.note_transfer(
                "store.demand_fault" if demand else "store.prefetch",
                "h2d", need * self.rank * 4, time.perf_counter() - t0)
        if pin:
            self._slot_pin[take] += 1
        self._slot_dirty[take] = dirty
        if not demand:
            self.stats.prefetched += need
        return need

    # -- training seams -------------------------------------------------------

    def acquire_rows(self, ids: np.ndarray) -> np.ndarray:
        """Register ``ids``, fault their rows hot, pin them, mark them dirty
        (training will write them) and return the SLOT of every input id.
        The demand-fault host wall (what prefetch exists to hide) accrues
        to ``stats.demand_fault_s``."""
        ids = np.asarray(ids)
        with self._lock:
            n_before = self._n
            rows = super().ensure(ids)
            uniq = np.unique(rows)
            fresh = int((uniq >= n_before).sum())
            t0 = time.perf_counter()
            if self._fault_in(uniq, pin=True, dirty=True, fresh=fresh):
                wait = time.perf_counter() - t0
                self.stats.demand_fault_s += wait
                if self._obs_on:
                    self._m_wait.inc(wait)
            return self._row_slot[rows]

    def release_rows(self, rows: np.ndarray) -> None:
        """Unpin the slots ``acquire_rows`` returned (one unpin per unique
        slot, as one pin was taken per unique row)."""
        with self._lock:
            slots = np.unique(np.asarray(rows, np.int64))
            slots = slots[(slots >= 0) & (slots < self.slot_capacity)]
            self._slot_pin[slots] = np.maximum(self._slot_pin[slots] - 1, 0)

    def commit_rows(self, updated: torch.Tensor, idx) -> None:
        """``updated``'s slots at ``idx`` into a new binding of the CURRENT
        pool, under the store lock: rebinding a stale whole pool would
        erase slots the prefetch thread loaded since the trainer's
        snapshot."""
        with self._lock:
            idx = torch.as_tensor(idx, device=self.device)
            pool = self._pool.clone()
            pool[idx] = updated[idx]
            self._pool = pool

    def install_trained(self, updated: torch.Tensor, rows: np.ndarray) -> None:
        """Serial-path install: only the acquired slots ``rows`` of the
        trained pool go in."""
        rows = np.unique(np.asarray(rows, np.int64))
        if rows.size:
            self.commit_rows(updated, torch.from_numpy(rows))

    # -- prefetch -------------------------------------------------------------

    def prefetch(self, ids: np.ndarray) -> int:
        """Stage upcoming rows hot without pinning or dirtying them (the
        lookahead path ``StorePrefetcher`` feeds); best-effort, returns
        the rows faulted. Unregistered ids are DROPPED, never registered:
        id → row assignment is first-seen order and belongs to training
        alone (a fresh id has no cold value to stage anyway)."""
        ids = np.asarray(ids)
        if ids.size == 0:
            return 0
        with self._lock:
            rows, found = super().rows_for(ids)
            rows = rows[found > 0]
            if rows.size == 0:
                return 0
            return self._fault_in(np.unique(rows), pin=False, dirty=False,
                                  best_effort=True, demand=False)

    def warm_rows(self, rows: np.ndarray) -> int:
        """Re-warm registered rows (a checkpoint restore hands back the
        snapshot's resident set)."""
        rows = np.asarray(rows, np.int64)
        rows = rows[(rows >= 0) & (rows < self._n)]
        if rows.size == 0:
            return 0
        with self._lock:
            return self._fault_in(np.unique(rows), pin=False, dirty=False,
                                  best_effort=True, demand=False)

    def resident_rows(self) -> np.ndarray:
        """Cold rows currently hot, in slot order (the checkpoint's half of
        the slot map)."""
        with self._lock:
            return self._slot_row[self._slot_row >= 0].copy()

    def dirty_rows(self) -> np.ndarray:
        with self._lock:
            sel = (self._slot_row >= 0) & self._slot_dirty
            return self._slot_row[sel].copy()

    # -- serving --------------------------------------------------------------

    def serve_rows(self, rows: np.ndarray) -> torch.Tensor:
        """``float32[len(rows), rank]`` on the store's device for the
        serving gather: hot rows from the pool, cold rows straight from the
        host tier (counted as serve misses). Read-only: serving never
        admits rows to the pool, so it cannot thrash training's set."""
        rows = np.asarray(rows, np.int64)
        if len(rows) == 0:
            return torch.zeros((0, self.rank), dtype=torch.float32,
                               device=self.device)
        with self._lock:
            slots = self._row_slot[rows]
            miss = slots < 0
            self.stats.serve_hits += int((~miss).sum())
            self.stats.serve_misses += int(miss.sum())
            idx = torch.from_numpy(np.where(miss, 0, slots)).to(self.device)
            out = self._pool.index_select(0, idx)
            if miss.any():
                ledger = get_transfers()
                t0 = time.perf_counter() if ledger is not None else 0.0
                vals, midx = self._to_device(rows[miss], np.nonzero(miss)[0])
                out.index_copy_(0, midx, vals)
                if ledger is not None:  # logical bytes: serve misses
                    ledger.note_transfer("store.serve_cold", "h2d",
                                         int(miss.sum()) * self.rank * 4,
                                         time.perf_counter() - t0)
        return out

    # -- whole-table views (offline / eval + checkpoint) ----------------------

    def _merged_host(self, n: int) -> np.ndarray:
        """Cold[:n] with the DIRTY resident slots overlaid (clean residents
        equal their cold rows): a copy."""
        out = np.array(self.cold[:n], np.float32, copy=True)
        sel = np.nonzero((self._slot_row >= 0) & self._slot_dirty)[0]
        if sel.size:
            rows = self._slot_row[sel]
            keep = rows < n
            if keep.any():
                out[rows[keep]] = self._gather_pool(sel[keep])
        return out

    def snapshot_rows(self, n: int) -> np.ndarray:
        with self._lock:
            return self._merged_host(n)

    def load_rows(self, rows: np.ndarray, values) -> None:
        rows = np.asarray(rows, np.int64)
        if isinstance(values, torch.Tensor):
            values = values.cpu().numpy()
        with self._lock:
            self.cold[rows] = np.asarray(values, np.float32)
            slots = self._row_slot[rows]
            hot = slots >= 0
            if hot.any():
                self._write_pool(slots[hot], rows[hot])
                # restored slots equal their cold rows again
                self._slot_dirty[slots[hot]] = False

    def full_table(self) -> torch.Tensor:
        with self._lock:
            return torch.from_numpy(self._merged_host(self.capacity)).to(
                self.device)

    def _host_rows(self, rows: np.ndarray) -> np.ndarray:
        """Host values of ``rows``: pool values win for hot rows (dirty
        slots are ahead of their cold copies)."""
        rows = np.asarray(rows, np.int64)
        with self._lock:
            slots = self._row_slot[rows]
            out = np.array(self.cold[rows], np.float32)
            hot = np.nonzero(slots >= 0)[0]
            if hot.size:
                out[hot] = self._gather_pool(slots[hot])
            return out

    def gather_rows(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(self._host_rows(rows)).to(self.device)

    def as_dict(self) -> dict[int, np.ndarray]:
        with self._lock:
            host = self._merged_host(self._n)
            return {int(i): host[r]
                    for r, i in enumerate(self._ids_buf[:self._n].tolist())}

    # -- accounting -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Tiers and counters (the JAX package's ``/storez`` body)."""
        with self._lock:
            return {
                "hot": {
                    "slot_capacity": int(self.slot_capacity),
                    "resident": int((self._slot_row >= 0).sum()),
                    "pinned": int((self._slot_pin > 0).sum()),
                    "dirty": int(self._slot_dirty.sum()),
                },
                "cold": {
                    "capacity": int(self.capacity),
                    "rows": int(self._n),
                    "host_bytes": int(self.stats.host_bytes),
                    "mmap": self._mmap_dir is not None,
                },
                "rank": int(self.rank),
                "stats": self.stats.snapshot(),
            }
