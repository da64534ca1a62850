"""``StorePrefetcher``: asynchronous WAL-lookahead staging for the hot tier
(counterpart of ``large_scale_recommendation_tpu.store.prefetch``; host
code).

``QueuedSource``'s feeder thread enqueues batches ahead of the consumer,
and each ``StreamBatch`` names its user ids before ``partial_fit`` needs
them. The driver wires the feeder's ``on_enqueue`` to ``submit_batch``;
this thread drains the announced id sets into
``TieredFactorStore.prefetch`` (unpinned, clean, best-effort faults; on a
card the copies run on the store's side stream), so by the time the
consumer's ``acquire_rows`` runs, the batch's rows are resident.

Bounded and lossy by design: a full announce queue drops the oldest
pending set (a prefetcher that falls behind degrades to demand faulting,
never to backpressure on the feeder), and a dropped set costs only
latency: correctness always comes from the demand path.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np


class StorePrefetcher:
    """One daemon thread staging announced id sets into a store."""

    def __init__(self, store, capacity: int = 32):
        self.store = store
        self.capacity = int(capacity)
        self._q: queue.Queue = queue.Queue(maxsize=self.capacity)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.submitted = 0
        self.dropped = 0
        self.prefetched_rows = 0

    # -- producer side (the feeder's on_enqueue callback) --------------------

    def submit(self, ids) -> None:
        """Announce upcoming ids (copied here: the feeder's arrays must not
        be aliased into a thread that reads them later). Never blocks: a
        full queue drops its OLDEST entry."""
        ids = np.array(ids, np.int64, copy=True)
        self.submitted += 1
        while True:
            try:
                self._q.put_nowait(ids)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self.dropped += 1
                except queue.Empty:
                    pass

    def submit_batch(self, batch) -> None:
        """``on_enqueue`` form: announce a ``StreamBatch``'s real (weight
        > 0) user ids. It runs on the feeder thread, so its own faults are
        counted as drops, never raised."""
        try:
            ru, _, _, rw = batch.ratings.to_numpy()
            real = rw > 0
            if real.any():
                self.submit(np.unique(ru[real]))
        except Exception:
            self.dropped += 1

    # -- worker side ---------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                ids = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                self.prefetched_rows += self.store.prefetch(ids)
            except Exception:
                # best effort: the demand path covers the rows regardless
                pass

    def start(self) -> "StorePrefetcher":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run,
                                            name="store-prefetch",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout)

    def drain(self, timeout: float = 5.0) -> None:
        """Wait (at most ``timeout`` s) until the announce queue is
        empty."""
        deadline = time.monotonic() + timeout
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.005)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def snapshot(self) -> dict:
        return {"submitted": self.submitted, "dropped": self.dropped,
                "pending": self._q.qsize(),
                "prefetched_rows": self.prefetched_rows,
                "running": self.running}
