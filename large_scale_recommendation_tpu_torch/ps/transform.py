"""ps_transform: wire workers and PS shards into a running asynchronous
topology (counterpart of ``large_scale_recommendation_tpu_torch.ps.transform``;
host threads and queues, the same rules).

- one thread per worker, consuming its input and a queue of pull answers;
- one thread per PS shard, consuming pull / push / control requests routed
  by ``abs(id) % P``; answers go back to the issuing worker's queue;
- worker and PS outputs are collected apart.

Rules kept: a bounded in-flight pull window per worker (``pull_limit``;
``pull()`` never blocks, requests park in a pending deque a pump drains as
answers arrive); a pull spanning several shards counts as one in-flight
unit and is reassembled by ``request_id`` in the original id order;
control messages travel the shard queue, so they are ordered after the
worker's earlier traffic; a worker or shard that raises fails the run
promptly (every blocked thread is woken); and ``iteration_wait_time`` is
an idle window: the run raises ``TimeoutError`` only after that long with
no pull, push or answer traffic.

Worker threads that drive the card (``ps.mf``, the ``ps.adaptive`` batch
replay) enqueue on the default CUDA stream; each worker owns its tables.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Iterable, Sequence

import numpy as np

from large_scale_recommendation_tpu_torch.ps.core import (
    ControlMessage,
    PullAnswer,
    PullRequest,
    PushRequest,
    WorkerLogic,
)
from large_scale_recommendation_tpu_torch.ps.server import (
    ShardedParameterStore,
)


class _WorkerClient:
    """The ``ParameterServerClient`` handed to worker logic
    (≙ MessagingPSClient, FlinkPS.scala:40-57).

    One logical ``pull(ids)`` counts as ONE in-flight unit regardless of how
    many PS shards the ids span: sub-requests are tagged with a request id
    and the partial answers reassembled (in original id order) before the
    worker logic sees them.
    """

    def __init__(self, worker_id: int, topology: "PSTopology",
                 pull_limit: int | None):
        self._id = worker_id
        self._topo = topology
        self._pull_limit = pull_limit
        self._pending: collections.deque[np.ndarray] = collections.deque()
        self._in_flight = 0
        self._next_req = 0
        # request_id -> [original ids, parts remaining, id -> value row]
        self._assembling: dict[int, list] = {}
        self.outputs: list[Any] = []

    # -- ParameterServerClient ----------------------------------------------

    def pull(self, ids: np.ndarray) -> None:
        """Non-blocking: parks the request; the pump sends it when the
        in-flight window (≙ pullLimit, PSOfflineMF.scala:217-230) allows.
        Ids within one pull must be unique (chunks are)."""
        self._pending.append(np.asarray(ids, dtype=np.int64))
        self._pump()

    def push(self, ids: np.ndarray, deltas: np.ndarray) -> None:
        self._topo._route_push(
            PushRequest(self._id, np.asarray(ids, np.int64),
                        np.asarray(deltas, np.float32))
        )

    def control(self, shard_id: int, payload: Any) -> None:
        """≙ the −psId control pushes routed straight to shard psId
        (PSOfflineOnlineMF.scala:89-92,361-368) — same shard queue as data
        traffic, so it stays ordered after this worker's earlier messages."""
        self._topo._route_control(shard_id, ControlMessage(self._id, payload))

    def output(self, value: Any) -> None:
        self.outputs.append(value)

    # -- window pump + reassembly -------------------------------------------

    def _pump(self) -> None:
        while self._pending and (
            self._pull_limit is None or self._in_flight < self._pull_limit
        ):
            ids = self._pending.popleft()
            req = self._next_req
            self._next_req += 1
            self._in_flight += 1
            n_parts = self._topo._route_pull(
                PullRequest(self._id, ids, request_id=req)
            )
            self._assembling[req] = [ids, n_parts, []]

    def _on_answer_part(self, part) -> "PullAnswer | None":
        """Collect a shard's partial answer; return the complete answer
        once all parts arrived, else None. The final reassembly is a
        vectorized concatenate + searchsorted reorder (ids within one
        pull are unique by contract) — the per-id dict merge it replaces
        cost a Python loop per answer on the PS hot path."""
        slot = self._assembling[part.request_id]
        ids, _, parts = slot
        parts.append(part)
        slot[1] -= 1
        if slot[1] > 0:
            return None
        del self._assembling[part.request_id]
        all_ids = np.concatenate([p.ids for p in parts])
        all_vals = np.concatenate([p.values for p in parts])
        if len(all_ids) == 0 and len(ids) > 0:
            # every shard answered empty for a non-empty request; without
            # this guard the clamp below would index into an empty array
            raise KeyError(
                f"pull answer is missing ids {np.asarray(ids)[:5].tolist()}"
                " — shard routing bug (all parts empty)")
        order = np.argsort(all_ids)
        pos = np.searchsorted(all_ids[order], ids)
        pos = np.minimum(pos, len(all_ids) - 1)
        if not (all_ids[order[pos]] == ids).all():
            # a dropped/mis-routed id would otherwise hand the worker a
            # NEIGHBORING id's factor row — fail loudly like the dict
            # merge this replaced did
            missing = np.asarray(ids)[all_ids[order[pos]] != ids]
            raise KeyError(
                f"pull answer is missing ids {missing[:5].tolist()} — "
                "shard routing bug")
        values = all_vals[order[pos]]  # one composed gather, no sorted copy
        return PullAnswer(ids, values, request_id=part.request_id)

    def _answer_processed(self) -> None:
        self._in_flight -= 1
        self._pump()

    @property
    def drained(self) -> bool:
        return not self._pending and self._in_flight == 0


_EOF = object()
_STOP = object()


class _TopologyFailed(Exception):
    """Secondary unwind signal: another component already recorded the root
    cause; threads raising this just exit quietly."""


class PSTopology:
    """A running PS topology. Prefer the ``ps_transform`` entry point."""

    def __init__(
        self,
        worker_logics: Sequence[WorkerLogic],
        store: ShardedParameterStore,
        pull_limit: int | None = None,
    ):
        self.workers = list(worker_logics)
        self.store = store
        self.pull_limit = pull_limit
        self._worker_queues: list[queue.Queue] = [
            queue.Queue() for _ in self.workers
        ]
        self._shard_queues: list[queue.Queue] = [
            queue.Queue() for _ in store.shards
        ]
        self._clients = [
            _WorkerClient(w, self, pull_limit)
            for w in range(len(self.workers))
        ]
        self.ps_outputs: list[Any] = []
        self._ps_lock = threading.Lock()
        self._errors: list[BaseException] = []
        self._failed = threading.Event()
        self._last_activity = time.monotonic()

    def _fail(self, e: BaseException) -> None:
        """Record the root cause and wake every blocked thread so the
        topology unwinds instead of deadlocking."""
        self._errors.append(e)
        self._failed.set()
        for q in self._worker_queues:
            q.put(("failed", None))
        for q in self._shard_queues:
            q.put(_STOP)

    # -- routing (≙ partitionCustom by id, FlinkPS.scala:185-189) -----------

    def _route_pull(self, req: PullRequest) -> int:
        """Split one logical pull by shard; returns the number of parts (the
        client tracks them for reassembly)."""
        shards = self.store.shard_of(req.ids)
        uniq = np.unique(shards)
        for s in uniq:
            m = shards == s
            self._shard_queues[s].put(
                PullRequest(req.worker_id, req.ids[m],
                            request_id=req.request_id)
            )
        return len(uniq)

    def _route_push(self, req: PushRequest) -> None:
        shards = self.store.shard_of(req.ids)
        for s in np.unique(shards):
            m = shards == s
            self._shard_queues[s].put(
                PushRequest(req.worker_id, req.ids[m], req.deltas[m])
            )

    def _route_control(self, shard_id: int, msg: ControlMessage) -> None:
        self._shard_queues[shard_id].put(msg)

    # -- threads -------------------------------------------------------------

    def _worker_main(self, w: int, inputs: Iterable[Any]) -> None:
        logic, client, q = self.workers[w], self._clients[w], \
            self._worker_queues[w]
        try:
            for x in inputs:
                if self._failed.is_set():
                    return
                logic.on_recv(x, client)
                # nothing to drain unless a pull is in flight (no queue
                # touch per input record); a "failed" message parked in
                # the queue is still seen: _fail() sets the event this
                # loop checks first
                if not client.drained:
                    self._drain_answers(w)
            hook = getattr(logic, "on_input_end", None)
            if hook is not None:
                hook(client)  # ≙ the all-EOFs-received trigger
                # (PSOfflineMF.scala:99-134)
            while not client.drained:
                tag, payload = q.get()
                if tag == "failed":
                    return
                self._handle_answer(w, payload)
            logic.close(client)
        except _TopologyFailed:
            pass  # root cause already recorded by the failing component
        except BaseException as e:  # surface worker crashes to run()
            self._fail(e)

    def _handle_answer(self, w: int, part) -> None:
        self._last_activity = time.monotonic()
        client, logic = self._clients[w], self.workers[w]
        answer = client._on_answer_part(part)
        if answer is not None:
            logic.on_pull_answer(answer, client)
            client._answer_processed()

    def _drain_answers(self, w: int) -> None:
        # the worker thread is this queue's ONLY consumer, so qsize() > 0
        # guarantees the get succeeds — no exception-driven empty probe
        q = self._worker_queues[w]
        while q.qsize():
            tag, payload = q.get()
            if tag == "failed":
                raise _TopologyFailed
            self._handle_answer(w, payload)

    def _shard_main(self, s: int) -> None:
        logic, q = self.store.shards[s], self._shard_queues[s]
        try:
            while True:
                req = q.get()
                if req is _STOP:
                    return
                self._last_activity = time.monotonic()
                if isinstance(req, PullRequest):
                    values = logic.on_pull(req.ids)
                    self._worker_queues[req.worker_id].put(
                        ("answer", PullAnswer(req.ids, values,
                                              request_id=req.request_id))
                    )
                elif isinstance(req, ControlMessage):
                    out = []
                    logic.on_control(req.worker_id, req.payload, out)
                    if out:
                        with self._ps_lock:
                            self.ps_outputs.extend(out)
                else:
                    out = []
                    logic.on_push(req.ids, req.deltas, out,
                                  worker_id=req.worker_id)
                    if out:
                        with self._ps_lock:
                            self.ps_outputs.extend(out)
        except BaseException as e:
            self._fail(e)

    # -- run ------------------------------------------------------------------

    def run(
        self,
        worker_inputs: Sequence[Iterable[Any]],
        timeout: float | None = None,
    ) -> tuple[list[list[Any]], list[Any]]:
        """Execute to completion. Returns (per-worker outputs, PS outputs)
        — the two sides of the reference's Either split
        (FlinkPS.scala:227-236)."""
        assert len(worker_inputs) == len(self.workers)
        if timeout is None:
            # Finite default IDLE timeout: a wedged topology must eventually
            # raise, not hang the process. Like the reference's
            # iterationWaitTime (FlinkPS.scala:123,242) this is a SILENCE
            # window — it only fires after no pull/push/answer traffic for
            # this long, so healthy long runs are never cut short.
            timeout = 600.0
        shard_threads = [
            threading.Thread(target=self._shard_main, args=(s,), daemon=True)
            for s in range(len(self.store.shards))
        ]
        worker_threads = [
            threading.Thread(target=self._worker_main, args=(w, inp),
                             daemon=True)
            for w, inp in enumerate(worker_inputs)
        ]
        for t in shard_threads + worker_threads:
            t.start()
        self._last_activity = time.monotonic()
        for t in worker_threads:
            while True:
                t.join(min(1.0, timeout))
                if not t.is_alive() or self._errors:
                    break
                if time.monotonic() - self._last_activity > timeout:
                    raise TimeoutError(
                        "PS topology idle: no pull/push/answer traffic for "
                        f"{timeout}s (iteration_wait_time)"
                    )
        for q in self._shard_queues:
            q.put(_STOP)
        for t in shard_threads:
            t.join(timeout)
        if self._errors:
            raise self._errors[0]
        return [c.outputs for c in self._clients], self.ps_outputs


def ps_transform(
    worker_inputs: Sequence[Iterable[Any]],
    worker_logics: Sequence[WorkerLogic],
    store: ShardedParameterStore,
    pull_limit: int | None = None,
    iteration_wait_time: float | None = None,
) -> tuple[list[list[Any]], list[Any]]:
    """One-shot topology build + run.

    ≙ ``FlinkPS.psTransform(xs, workerLogic, psLogic, ..., workerParallelism,
    psParallelism, iterationWaitTime)`` (FlinkPS.scala:112-131):
    ``len(worker_logics)`` = workerParallelism, ``store.ps_parallelism`` =
    psParallelism.
    """
    topo = PSTopology(worker_logics, store, pull_limit)
    return topo.run(worker_inputs, timeout=iteration_wait_time)
