"""Multi-device machinery (counterpart of
``large_scale_recommendation_tpu.parallel``): one logical-axis
``Partitioner`` over a ``(data, model)`` grid of ``torch.distributed``
ranks, and the mesh solvers, checkpoints and serving on top of it.

Public surface (import from HERE):

- ``Partitioner`` / ``as_partitioner`` / ``DEFAULT_RULES`` /
  ``DATA_AXIS`` / ``MODEL_AXIS`` / ``make_data_model_mesh`` /
  ``LocalShard`` — the sharding layer (``partitioner``);
- ``ring_shift`` / ``group_sum`` / ``gather`` / ``exchange`` / ``Axis`` —
  the collectives (``collectives``);
- ``DistributedConfig`` / ``initialize_distributed`` /
  ``host_rating_shard`` / ``make_global_array`` /
  ``global_device_blocked`` / ``GlobalBlockedArrays`` — process-group
  bring-up and per-process ingest (``distributed``);
- ``make_block_mesh`` / ``block_sharding`` / ``replicated`` /
  ``ring_backward`` / ``select_devices`` / ``BLOCK_AXIS`` — the 1D ring
  (``mesh``);
- ``MeshDSGD`` / ``MeshDSGDConfig`` / ``build_mesh_dsgd_step`` /
  ``device_major_local_strata``, ``MeshALS`` / ``build_mesh_als_step`` —
  the mesh solvers;
- ``ShardedCatalog`` / ``shard_catalog`` / ``mesh_top_k_recommend`` /
  ``catalog_version`` / ``mesh_supports_donation`` — serving.

``shard_map`` has no counterpart (each rank is its own process). Names
resolve lazily (PEP 562): importing the package imports no submodule.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "Partitioner": "partitioner",
    "as_partitioner": "partitioner",
    "make_data_model_mesh": "partitioner",
    "DEFAULT_RULES": "partitioner",
    "DATA_AXIS": "partitioner",
    "MODEL_AXIS": "partitioner",
    "LocalShard": "partitioner",
    "Axis": "collectives",
    "ring_shift": "collectives",
    "group_sum": "collectives",
    "gather": "collectives",
    "DistributedConfig": "distributed",
    "initialize_distributed": "distributed",
    "host_rating_shard": "distributed",
    "make_global_array": "distributed",
    "global_device_blocked": "distributed",
    "GlobalBlockedArrays": "distributed",
    "exchange": "collectives",
    "BLOCK_AXIS": "mesh",
    "select_devices": "mesh",
    "make_block_mesh": "mesh",
    "block_sharding": "mesh",
    "replicated": "mesh",
    "ring_backward": "mesh",
    "MeshDSGD": "dsgd_mesh",
    "MeshDSGDConfig": "dsgd_mesh",
    "build_mesh_dsgd_step": "dsgd_mesh",
    "device_major_local_strata": "dsgd_mesh",
    "MeshALS": "als_mesh",
    "build_mesh_als_step": "als_mesh",
    "ShardedCatalog": "serving",
    "shard_catalog": "serving",
    "mesh_top_k_recommend": "serving",
    "catalog_version": "serving",
    "mesh_supports_donation": "serving",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value  # the next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
