"""The 1D block ring (counterpart of
``large_scale_recommendation_tpu.parallel.mesh``).

The JAX package's legacy ``('blocks',)`` mesh is, in the port, the rank
grid with ``model_parallel = 1``: ``make_block_mesh`` returns that
``Partitioner``, and ``block_sharding`` / ``replicated`` return its
dim-0 and empty specs. ``shard_map`` has no counterpart: each rank runs
its part of the program as its own process, and the mesh solvers call the
collectives (``parallel.collectives``) where JAX's ``shard_map`` bodies
call ``jax.lax``.
"""

from __future__ import annotations

from large_scale_recommendation_tpu_torch.parallel.partitioner import (
    Partitioner,
    select_devices,
)

__all__ = [
    "BLOCK_AXIS", "select_devices", "make_block_mesh", "block_sharding",
    "replicated", "ring_backward",
]

BLOCK_AXIS = "blocks"


def make_block_mesh(num_devices: int | None = None,
                    device=None) -> Partitioner:
    """The DSGD stratum ring over every rank of the process group: k =
    its size (``num_devices`` must equal it)."""
    return Partitioner(num_devices=num_devices, device=device)


def block_sharding(part: Partitioner) -> tuple:
    """Dim 0 over the ring (factor tables, device-major strata)."""
    return part.spec("ratings")


def replicated(part: Partitioner) -> tuple:
    """The whole array on every rank."""
    return part.spec()


def ring_backward(k: int) -> list[tuple[int, int]]:
    """The ring rotation as (from, to) positions: shard j moves to j − 1
    (mod k). ≙ ``nextRatingBlock`` (DSGDforMF.scala:611-619): after step s
    position p holds item block (p + s) mod k, and the block it needs next
    is at p + 1."""
    return [(j, (j - 1) % k) for j in range(k)]
