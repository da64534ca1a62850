"""PS trait family: the pluggable client / worker / server seam
(counterpart of ``large_scale_recommendation_tpu.ps.core``; host code, the
same classes).

- ``ParameterServerClient`` {pull, push, control, output}
- ``WorkerLogic``          {on_recv, on_pull_answer, close}
- ``ParameterServerLogic`` {on_pull, on_push, on_control}

Every method is batched over id arrays, so a worker's device update
amortizes one gather/scatter per chunk; the reference's per-element form
is the length-1 array. In-process queues need no wire format: the
messages are the plain dataclasses below.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import numpy as np


# -- wire entities (≙ ps/entities/Messages.scala:3-4, C9) -------------------


@dataclasses.dataclass
class PullRequest:
    """Worker → PS: request parameter rows.
    ≙ ``WorkerOut(partitionId, Left(pullId))``.

    ``request_id`` ties shard-level sub-requests back to the worker's one
    logical pull so partial answers can be reassembled (a logical pull may
    span several PS shards; the reference never batches ids so its pulls are
    trivially single-shard)."""

    worker_id: int
    ids: np.ndarray  # int64[n] parameter ids
    request_id: int = -1


@dataclasses.dataclass
class PushRequest:
    """Worker → PS: additive deltas for parameter rows.
    ≙ ``WorkerOut(partitionId, Right((pushId, P)))``."""

    worker_id: int
    ids: np.ndarray
    deltas: np.ndarray  # float32[n, rank]


@dataclasses.dataclass
class ControlMessage:
    """Worker → one specific PS shard: a control-plane event, delivered
    through the SAME queue as that worker's pulls/pushes (so it is ordered
    after everything the worker already sent — the property the reference's
    in-band encoding exists to provide).

    ≙ the magic pushes ``(−psId, Array())`` = batch start and
    ``(−psId, Array(−1.0))`` = batch end (PSOfflineOnlineMF.scala:89-92,
    223-227) together with the partitioner special-case that routes them to
    shard ``−psIndex`` (:361-368). Flink's homogeneous wire format forces
    that encoding; an in-process runtime can say what it means — a typed
    envelope with a ``payload`` string — while keeping the identical in-band
    ordering semantics."""

    worker_id: int
    payload: Any


@dataclasses.dataclass
class PullAnswer:
    """PS → worker: the requested rows.
    ≙ ``WorkerIn(id, workerPartitionIndex, P)``.

    Worker logic always receives a COMPLETE answer whose ids equal the
    original pull's ids in order; shard-level parts are reassembled by the
    client before delivery."""

    ids: np.ndarray
    values: np.ndarray  # float32[n, rank]
    request_id: int = -1


# -- traits -----------------------------------------------------------------


@runtime_checkable
class ParameterServerClient(Protocol):
    """What a worker logic sees. ≙ ``ParameterServerClient[P]``
    (FlinkPS.scala:12-19)."""

    def pull(self, ids: np.ndarray) -> None: ...

    def push(self, ids: np.ndarray, deltas: np.ndarray) -> None: ...

    def control(self, shard_id: int, payload: Any) -> None:
        """Send a control event to one shard, ordered after this worker's
        earlier traffic (≙ the −psId control pushes,
        PSOfflineOnlineMF.scala:89-92)."""
        ...

    def output(self, value: Any) -> None: ...


class WorkerLogic(Protocol):
    """Worker-side behavior. ≙ ``WorkerLogic[T, P, WOut]``
    (FlinkPS.scala:31-38)."""

    def on_recv(self, data: Any, ps: ParameterServerClient) -> None:
        """A data element arrived from the input stream."""
        ...

    def on_pull_answer(self, answer: PullAnswer,
                       ps: ParameterServerClient) -> None:
        """≙ ``onPullRecv(paramId, paramValue, ps)``."""
        ...

    def close(self, ps: ParameterServerClient) -> None:
        """Input exhausted and all in-flight answers drained.
        ≙ ``close()`` (FlinkPS.scala:37; PSOfflineMF.scala:270-275)."""
        ...


class ParameterServerLogic(Protocol):
    """Server-side behavior. ≙ ``ParameterServerLogic[P, PSOut]``
    (FlinkPS.scala:67-72)."""

    def on_pull(self, ids: np.ndarray) -> np.ndarray:
        """Return values for ids (initializing unseen ones).
        ≙ ``onPullRecv`` answering through ``ps.answerPull``."""
        ...

    def on_push(self, ids: np.ndarray, deltas: np.ndarray,
                outputs: list, worker_id: int = -1) -> None:
        """Apply deltas; append any (id, new_value) emissions to outputs.
        ≙ ``onPushRecv(id, delta, workerPartitionIndex, ps)`` emitting via
        ``ps.output`` — ``worker_id`` is the workerPartitionIndex, which
        state-machine servers use for per-worker admission
        (PSOfflineOnlineMF.scala:298-356)."""
        ...

    def on_control(self, worker_id: int, payload: Any,
                   outputs: list) -> None:
        """Handle an in-band control event. Optional — only state-machine
        servers implement it; sending control to a shard whose logic lacks
        it fails the topology fast (AttributeError), matching the
        reference's throw-on-protocol-violation style."""
        ...
