"""Carry weights, layouts, online, adaptive and PS state and tiered stores
from the JAX package into the port.

All take plain numpy arrays (``np.asarray`` of the JAX arrays) and duck-typed
``IdIndex``-like objects, so nothing here imports JAX. bf16 tables may come
as ``bfloat16`` numpy arrays (ml_dtypes) or as their ``uint16``/``int16``
bit views; they stay bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.core.initializers import (
    PseudoRandomFactorInitializer,
)
from large_scale_recommendation_tpu_torch.data.blocking import IdIndex
from large_scale_recommendation_tpu_torch.data.device_blocking import (
    DeviceBlockedProblem,
)
from large_scale_recommendation_tpu_torch.models.adaptive import (
    AdaptiveMF,
    AdaptiveMFConfig,
)
from large_scale_recommendation_tpu_torch.models.mf import MFModel
from large_scale_recommendation_tpu_torch.models.online import (
    OnlineMF,
    OnlineMFConfig,
)
from large_scale_recommendation_tpu_torch.ps.mf import (
    PSOfflineMF,
    PSOfflineMFConfig,
)
from large_scale_recommendation_tpu_torch.serving.retrieval import (
    RANK_SHARDED_NOT_PORTED,
    QuantizedCatalog,
)
from large_scale_recommendation_tpu_torch.store.tiered import (
    StoreStats,
    TieredFactorStore,
)
from large_scale_recommendation_tpu_torch.utils.device import resolve_device


def _table(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: the port trains its tables in place
    if a.dtype == np.float32:
        t = torch.from_numpy(a)
    elif a.dtype.name == "bfloat16" or a.dtype in (np.uint16, np.int16):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        raise ValueError(f"factor table dtype {a.dtype} unsupported; "
                         "float32 or bfloat16 (or its 16-bit view)")
    return t.to(device)


def factors_from_jax(U, V, device=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX-package factor tables (numpy) → torch tables on ``device``
    (``None``: the card; raises without one)."""
    device = resolve_device(device)
    return _table(U, device), _table(V, device)


def shards_from_jax(U, V, partitioner) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX-package whole factor tables (numpy, f32 or bf16) → this rank's
    shards under ``partitioner`` (``('users', 'rank')`` and ``('items',
    'rank')``), on its device: what a ``MeshDSGD`` / ``MeshALS`` rank holds
    after a fit."""
    return (partitioner.place(_table(U, "cpu"), "users", "rank"),
            partitioner.place(_table(V, "cpu"), "items", "rank"))


def sharded_model_from_jax(U, V, users, items, partitioner):
    """A ``ShardedMFModel`` (this rank's shards) from a JAX model's whole
    tables and its two ``IdIndex`` objects."""
    from large_scale_recommendation_tpu_torch.models.mf import ShardedMFModel

    U_l, V_l = shards_from_jax(U, V, partitioner)
    return ShardedMFModel(U=U_l, V=V_l, users=_index(users),
                          items=_index(items), partitioner=partitioner)


def _index(ix) -> IdIndex:
    return IdIndex(
        ids=np.asarray(ix.ids, np.int64),
        num_blocks=int(ix.num_blocks),
        rows_per_block=int(ix.rows_per_block),
        omega=np.asarray(ix.omega, np.float32),
        sorted_ids=np.asarray(ix.sorted_ids, np.int64),
        sorted_rows=np.asarray(ix.sorted_rows, np.int64),
    )


def model_from_jax(U, V, users, items, device=None) -> MFModel:
    """The port's ``MFModel`` from a JAX model's tables and its two
    ``IdIndex`` objects (any objects with the same fields), on ``device``
    (``None``: the card; raises without one)."""
    U, V = factors_from_jax(U, V, device)
    return MFModel(U=U, V=V, users=_index(users), items=_index(items))


_PROBLEM_ARRAYS = ("su", "si", "sv", "sw", "icu", "icv", "omega_u", "omega_v",
                   "row_of_user", "row_of_item", "id_of_user_row",
                   "id_of_item_row")


def device_problem_from_jax(p, device=None) -> DeviceBlockedProblem:
    """A JAX ``DeviceBlockedProblem`` (any object with its fields; arrays
    are read through ``np.asarray``) → the port's, its arrays on
    ``device`` (``None``: the card; raises without one) in the same
    dtypes."""
    device = resolve_device(device)
    arrays = {f: torch.from_numpy(np.array(getattr(p, f))).to(device)
              for f in _PROBLEM_ARRAYS}
    return DeviceBlockedProblem(
        **arrays, num_blocks=int(p.num_blocks),
        rows_per_block_u=int(p.rows_per_block_u),
        rows_per_block_v=int(p.rows_per_block_v), nnz=int(p.nnz),
        max_pad_ratio=float(p.max_pad_ratio), minibatch=int(p.minibatch))


def _adopt_table(table, jt, device) -> None:
    """A JAX ``GrowableFactorTable``'s state (capacity, ids in row order,
    the whole array, unregistered rows included) into a port table."""
    ids = np.asarray(jt.id_array(), np.int64)
    table.capacity = int(jt.capacity)
    table._ids_buf = np.empty(table.capacity, np.int64)
    table._ids_buf[:len(ids)] = ids
    table._n = len(ids)
    table._sorted_cache = None
    table.array = torch.from_numpy(
        np.array(jt.array, dtype=np.float32)).to(device)


def online_from_jax(jax_online, device=None, user_initializer=None,
                    item_initializer=None) -> OnlineMF:
    """A port ``OnlineMF`` carrying a JAX ``OnlineMF``'s state: its config,
    both tables (ids in row order, capacities, arrays), step and consumed
    offsets, on ``device`` (``None``: the card; raises without one). Ids
    registered later are initialized by the port's initializers (``None``:
    the port's keyed defaults)."""
    device = resolve_device(device)  # before reading the JAX model
    jc = jax_online.config
    cfg = OnlineMFConfig(**{f: getattr(jc, f) for f in
                            OnlineMFConfig.__dataclass_fields__})
    online = OnlineMF(cfg, user_initializer=user_initializer,
                      item_initializer=item_initializer, device=device)
    _adopt_table(online.users, jax_online.users, online.device)
    _adopt_table(online.items, jax_online.items, online.device)
    online.step = int(jax_online.step)
    online.consumed_offsets = {int(k): int(v) for k, v in
                               jax_online.consumed_offsets.items()}
    return online


def adaptive_from_jax(jax_adaptive, device=None) -> AdaptiveMF:
    """A port ``AdaptiveMF`` carrying a JAX ``AdaptiveMF``'s state: its
    config, the online model (``online_from_jax``: tables, step, consumed
    offsets), the retrain history (rows in order) and the retrain counters,
    on ``device`` (``None``: the card; raises without one). A model with a
    retrain in flight (state ``Batch``) is refused: ``flush()`` it first."""
    device = resolve_device(device)
    if jax_adaptive.state != "Online":
        raise ValueError("the JAX model has a retrain in flight; flush() "
                         "it before converting")
    jc = jax_adaptive.config
    cfg = AdaptiveMFConfig(**{f: getattr(jc, f) for f in
                              AdaptiveMFConfig.__dataclass_fields__})
    model = AdaptiveMF(cfg, device=device)
    model.online = online_from_jax(jax_adaptive.online, device=device)
    model._history = [tuple(np.array(a) for a in h)
                      for h in jax_adaptive._history]
    model._history_rows = int(jax_adaptive._history_rows)
    model._batches_since_retrain = int(jax_adaptive._batches_since_retrain)
    model.retrain_count = int(jax_adaptive.retrain_count)
    return model


def quantized_catalog_from_jax(cat, device=None) -> QuantizedCatalog:
    """A JAX ``QuantizedCatalog`` (flat or clustered; arrays read through
    ``np.asarray``) → the port's, on ``device`` (``None``: the card):
    codes, scales, weights and layout as they are, row ids as int64. The
    port's stages then run on the JAX package's own layout."""
    if getattr(cat, "partitioner", None) is not None:
        raise NotImplementedError(RANK_SHARDED_NOT_PORTED)
    device = resolve_device(device)
    arrays = {}
    for f in QuantizedCatalog._ARRAY_FIELDS:
        a = getattr(cat, f)
        if a is not None:
            a = np.array(a)
            if f.endswith("_rows"):
                a = a.astype(np.int64)
            arrays[f] = torch.from_numpy(a).to(device)
    pos = cat.pos_of_row
    return QuantizedCatalog(
        n_rows=int(cat.n_rows), rank=int(cat.rank), version=int(cat.version),
        pos_of_row=None if pos is None else np.asarray(pos, np.int64),
        stats=dict(cat.stats), **arrays)


def ps_offline_from_jax(jax_ps, device=None) -> PSOfflineMF:
    """A port ``PSOfflineMF`` carrying a JAX ``PSOfflineMF``'s config and
    its trained factor dicts (copies), on ``device`` (``None``: the card;
    raises without one)."""
    device = resolve_device(device)
    jc = jax_ps.config
    cfg = PSOfflineMFConfig(**{f: getattr(jc, f) for f in
                               PSOfflineMFConfig.__dataclass_fields__})
    ps = PSOfflineMF(cfg, device=device)
    ps.user_factors = {int(k): np.array(v, np.float32)
                       for k, v in jax_ps.user_factors.items()}
    ps.item_factors = {int(k): np.array(v, np.float32)
                       for k, v in jax_ps.item_factors.items()}
    return ps


def tiered_store_from_jax(jax_store, device=None,
                          initializer=None) -> TieredFactorStore:
    """A port ``TieredFactorStore`` that continues exactly where a JAX
    ``TieredFactorStore`` stopped: its capacities, the cold tier, the id
    machinery (ids in row order), the slot maps, the pin / dirty / tick
    arrays, the counters and the pool's values, on ``device`` (``None``:
    the card; raises without one). Ids registered later are initialized by
    ``initializer`` (``None``: the port's keyed rows at the JAX
    initializer's scale)."""
    device = resolve_device(device)
    if initializer is None:
        initializer = PseudoRandomFactorInitializer(
            int(jax_store.rank),
            scale=float(getattr(jax_store.initializer, "scale", 1.0)))
    store = TieredFactorStore(initializer, capacity=int(jax_store.capacity),
                              slot_capacity=int(jax_store.slot_capacity),
                              device=device)
    with store._lock:
        store.cold[:] = np.asarray(jax_store.cold, np.float32)
        ids = np.asarray(jax_store.id_array(), np.int64)
        store._ids_buf[:len(ids)] = ids
        store._n = len(ids)
        store._sorted_cache = None
        store._row_slot[:] = np.asarray(jax_store._row_slot, np.int64)
        for f in ("_slot_row", "_slot_dirty", "_slot_pin", "_slot_tick"):
            getattr(store, f)[:] = np.asarray(getattr(jax_store, f))
        store._tick = int(jax_store._tick)
        store.stats = StoreStats(**{
            f: getattr(jax_store.stats, f)
            for f in StoreStats.__dataclass_fields__})
        store._pool = torch.from_numpy(
            np.array(jax_store.array, dtype=np.float32)).to(device)
        store._publish_host_bytes()
    return store
