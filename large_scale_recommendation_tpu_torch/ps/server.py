"""PS server logics: host-table parameter shards (counterpart of
``large_scale_recommendation_tpu.ps.server``).

The default server logic is an in-memory map: pull → getOrElseUpdate(init),
push → add the delta and emit ``(id, new value)``. A shard's storage is a
``HostFactorTable``: no product ever touches the server table (the
workers' compute tables live on the card), so a device shard would only
add two transfers per request.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from large_scale_recommendation_tpu_torch.data.tables import HostFactorTable


class SimplePSLogic:
    """Default parameter shard: pull-initializes, push adds deltas.

    ``update(old, delta)`` replaces the additive merge when given;
    ``emit_updates`` controls whether pushes emit ``(id, new_value)``
    outputs (the offline driver reads the final snapshot instead).
    ``device`` is accepted as the JAX package accepts it, and ignored: the
    shard is host-resident."""

    def __init__(
        self,
        initializer,
        update: Callable | None = None,
        emit_updates: bool = True,
        device=None,
    ):
        del device
        self.table = HostFactorTable(initializer)
        self._update = update  # None → add (vec + delta)
        self.emit_updates = emit_updates

    def on_pull(self, ids: np.ndarray) -> np.ndarray:
        rows = self.table.ensure(ids)
        return self.table.array[rows]

    def on_push(self, ids: np.ndarray, deltas: np.ndarray,
                outputs: list, worker_id: int = -1) -> None:
        """Merge the deltas (an id never pulled is initialized first) and
        optionally emit the new values."""
        rows = self.table.ensure(ids)
        deltas = np.asarray(deltas, dtype=np.float32)
        if self._update is None:
            # np.add.at: duplicate ids accumulate
            np.add.at(self.table.array, rows, deltas)
        else:
            old = self.table.array[rows]
            self.table.array[rows] = np.asarray(self._update(old, deltas))
        if self.emit_updates:
            new = self.table.array[rows]
            outputs.extend(
                (int(i), new[j].copy()) for j, i in enumerate(ids.tolist())
            )

    def snapshot(self) -> dict[int, np.ndarray]:
        return self.table.as_dict()


class ShardedParameterStore:
    """Routes ids to ``ps_parallelism`` shards by ``abs(id) % P``;
    ``make_logic(p)`` builds shard p's logic."""

    def __init__(self, make_logic: Callable[[int], SimplePSLogic],
                 ps_parallelism: int):
        self.shards = [make_logic(p) for p in range(ps_parallelism)]
        self.ps_parallelism = ps_parallelism

    def shard_of(self, ids: np.ndarray) -> np.ndarray:
        return np.abs(ids) % self.ps_parallelism

    def snapshot(self) -> dict[int, np.ndarray]:
        out: dict[int, np.ndarray] = {}
        for s in self.shards:
            out.update(s.snapshot())
        return out
