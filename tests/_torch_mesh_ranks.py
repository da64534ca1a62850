"""Rank bodies of the port's multi-rank mesh tests, and the spawner that
runs them.

``run_world(world, jobs)`` starts ``world`` processes
(``torch.multiprocessing``, spawn), brings up a gloo process group over
localhost in each and runs every job in order on every rank; a job is a
dict whose ``"op"`` names a function below, called as ``op(part, job)``
with a ``Partitioner`` of ``job["m"]`` (default 1) on the CPU. Each rank's
list of results comes back through a file. The processes are joined under
one deadline: a hung collective fails the test instead of stalling the
suite, and a rank that raises fails it with that rank's traceback.

This module imports no jax (each rank starts in about a second); the
test files hand it numpy inputs and hold its results against the JAX
package.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.data.blocking import IdIndex
from large_scale_recommendation_tpu_torch.models.als import ALSConfig
from large_scale_recommendation_tpu_torch.models.mf import MFModel
from large_scale_recommendation_tpu_torch.parallel import collectives
from large_scale_recommendation_tpu_torch.parallel.als_mesh import MeshALS
from large_scale_recommendation_tpu_torch.parallel.distributed import (
    DistributedConfig,
    initialize_distributed,
)
from large_scale_recommendation_tpu_torch.parallel.dsgd_mesh import (
    MeshDSGD,
    MeshDSGDConfig,
)
from large_scale_recommendation_tpu_torch.parallel.partitioner import (
    Partitioner,
)
from large_scale_recommendation_tpu_torch.parallel import serving as psrv
from large_scale_recommendation_tpu_torch.utils.checkpoint import (
    ShardedCheckpointManager,
    restore_segment_state_sharded,
)

JOIN_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, jobs, out_dir):
    torch.set_num_threads(1)
    initialize_distributed(
        DistributedConfig(f"tcp://127.0.0.1:{port}", world, rank),
        device="cpu", timeout=datetime.timedelta(seconds=120))
    try:
        parts: dict[int, Partitioner] = {}
        results = []
        for job in jobs:
            m = job.get("m", 1)
            if m not in parts:  # collective: every rank, in job order
                parts[m] = Partitioner(num_devices=world, model_parallel=m,
                                       device="cpu")
            results.append(globals()[job["op"]](parts[m], job))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def run_world(world: int, jobs: list[dict],
              timeout: float = JOIN_TIMEOUT_S) -> list[list]:
    """Every rank's results (``[rank][job]``); raises on a rank's error
    or when the ranks have not all finished within ``timeout`` seconds."""
    with tempfile.TemporaryDirectory(prefix="mesh_ranks_") as out_dir:
        ctx = tmp.start_processes(
            _entry, args=(world, _free_port(), jobs, out_dir), nprocs=world,
            join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world} ranks did not finish within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        out = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# -- helpers ------------------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _ratings(job) -> Ratings:
    return Ratings.from_arrays(*job["ratings"])


def _index(d: dict) -> IdIndex:
    return IdIndex(**d)


def _whole(part, model) -> dict:
    """The fitted shards, and the whole tables gathered (a test-side
    collective)."""
    full = model.gather()
    return {"U_l": _np(model.U), "V_l": _np(model.V), "U": _np(full.U),
            "V": _np(full.V), "dtype": str(model.U.dtype).split(".")[-1]}


# -- ops ----------------------------------------------------------------------


def partitioner(part: Partitioner, job) -> dict:
    """The grid, the axes, placement and the collectives on this rank."""
    X = torch.as_tensor(job["X"])
    me = part.rank
    shift = part.ring_shift(torch.full((3,), float(me)),
                            torch.full((2, 2), me, dtype=torch.bfloat16))
    placed = part.place(X, "users", "rank")
    return {
        "grid": part.grid, "k": part.num_blocks, "m": part.model_parallel,
        "data": (part.data.ranks, part.data.index),
        "model": (part.model.ranks, part.model.index),
        "spec": part.spec("users", "rank"),
        "users_rank": placed.numpy(),
        "ratings": part.place(X, "ratings").numpy(),
        "queries": part.place(X, "queries").numpy(),
        "offset": part.local_shard(placed, "users", "rank").offset,
        "gather": part.gather(placed, "users", "rank").numpy(),
        "shift": (float(shift[0][0]), float(shift[1][0, 0])),
        "model_sum": float(collectives.group_sum(
            part.model, torch.tensor([float(me)]))[0]),
        "world_gather": collectives.gather(
            part.world, torch.tensor([me], dtype=torch.bfloat16)).float()
        .numpy(),
    }


def dsgd(part: Partitioner, job) -> dict:
    """``MeshDSGD.fit`` (``fit_device`` with ``job["device_path"]``),
    JAX's initial tables carried across when given, checkpointed when
    ``job["ckpt"]`` names a directory."""
    solver = MeshDSGD(MeshDSGDConfig(**job["cfg"]), partitioner=part)
    if job.get("init") is not None:
        U0, V0 = (torch.as_tensor(a) for a in job["init"])
        solver._init_factors = lambda _p: (U0, V0)
        solver._init_factors_device = lambda _p: (U0, V0)
    ckpt = (ShardedCheckpointManager(job["ckpt"], keep=job.get("keep", 10))
            if job.get("ckpt") else None)
    kw = dict(checkpoint_manager=ckpt,
              checkpoint_every=job.get("checkpoint_every"),
              resume=job.get("resume", False))
    if job.get("device_path"):
        u, i, r = job["ratings"]
        model = solver.fit_device(u, i, r, job["num_users"],
                                  job["num_items"], **kw)
    else:
        model = solver.fit(_ratings(job), **kw)
    out = _whole(part, model)
    out["user_ids"] = model.users.ids
    out["item_ids"] = model.items.ids
    if job.get("recommend") is not None:  # the shards serve, twice
        out["recs"] = model.recommend(job["recommend"], k=5)
        cache = dict(model._serving_cache)
        again = model.recommend(job["recommend"], k=5)
        out["recs_again_equal"] = all(
            np.array_equal(a, b) for a, b in zip(out["recs"], again))
        out["cache_kept"] = all(model._serving_cache[key] is v
                                for key, v in cache.items())
    return out


def als(part: Partitioner, job) -> dict:
    solver = MeshALS(ALSConfig(**job["cfg"]), partitioner=part)
    if job.get("init") is not None:
        U0, V0 = (torch.as_tensor(a) for a in job["init"])
        solver._init_factors = lambda users, items: (U0, V0)
    return _whole(part, solver.fit(_ratings(job)))


def serve(part: Partitioner, job) -> dict:
    """``mesh_top_k_recommend`` over ``shard_catalog`` of the whole V; with
    ``job["delta"]`` also the catalog patched by ``apply_delta`` against
    one rebuilt from the patched table."""
    U, V = (torch.as_tensor(a) for a in (job["U"], job["V"]))
    cat = psrv.shard_catalog(V, part, item_mask=job.get("item_mask"),
                             dtype=job.get("dtype"))
    kw = dict(k=job["k"], train_u=job.get("train_u"),
              train_i=job.get("train_i"), chunk=job.get("chunk", 2048))
    rows, scores = psrv.mesh_top_k_recommend(U, None, job["rows"],
                                             catalog=cat, **kw)
    out = {"rows": rows, "scores": scores, "rows_per_shard":
           cat.rows_per_shard, "local_shape": tuple(cat.V_sh.shape)}
    if job.get("delta") is not None:
        drows, dvals = job["delta"]
        patched = V.clone()
        patched[torch.as_tensor(drows)] = torch.as_tensor(dvals)
        a = psrv.mesh_top_k_recommend(
            U, None, job["rows"], catalog=cat.apply_delta(drows, dvals), **kw)
        b = psrv.mesh_top_k_recommend(U, patched, job["rows"], mesh=part,
                                      item_mask=job.get("item_mask"), **kw)
        out["delta_equal"] = bool(np.array_equal(a[0], b[0])
                                  and np.array_equal(a[1], b[1]))
    return out


def recommend(part: Partitioner, job) -> dict:
    """``MFModel.recommend(mesh=)`` against the plain ``recommend`` of the
    same model on this rank."""
    model = MFModel(U=torch.as_tensor(job["U"]), V=torch.as_tensor(job["V"]),
                    users=_index(job["users"]), items=_index(job["items"]))
    kw = dict(k=job["k"], train=job.get("train"))
    mesh = model.recommend(job["user_ids"], mesh=part, **kw)
    again = model.recommend(job["user_ids"], mesh=part, **kw)  # cached
    plain = model.recommend(job["user_ids"], **kw)
    return {"mesh": mesh, "again": again, "plain": plain}


def checkpoint_reshard(part: Partitioner, job) -> dict:
    """Save whole tables ``U``/``V`` from this grid, then restore onto
    grids of every model size in ``job["load_m"]`` (re-sharding) from that
    directory or from ``job["restore_from"]``; returns the restored
    slices' gather per model size."""
    U, V = (torch.as_tensor(a) for a in (job["U"], job["V"]))
    mgr = ShardedCheckpointManager(job["ckpt"])
    mgr.save(job["step"], {"U": part.local_shard(
        part.place(U, "users", "rank"), "users", "rank"),
        "V": part.local_shard(part.place(V, "items", "rank"), "items",
                              "rank")}, {"kind": "mesh"})
    out = {}
    src = ShardedCheckpointManager(job.get("restore_from") or job["ckpt"])
    for m in job["load_m"]:
        loader = Partitioner(num_devices=part.world_size, model_parallel=m,
                             device="cpu")
        U2, V2, done = restore_segment_state_sharded(
            src, "mesh", torch.zeros_like(U), torch.zeros_like(V), loader)
        out[m] = (done, _np(loader.gather(U2, "users", "rank")),
                  _np(loader.gather(V2, "items", "rank")),
                  tuple(U2.shape), str(U2.dtype))
    return out


def refusals(part: Partitioner, job) -> dict:
    """The mesh's refusals on a rank-sharded grid, as messages."""
    out = {}
    cfg = MeshDSGDConfig(**job["cfg"])
    for name, fn in (
            ("cuda_kernel", lambda: MeshDSGD(cfg, partitioner=part).fit(
                _ratings(job))),
            ("rank_divisible", lambda: MeshDSGD(
                MeshDSGDConfig(**{**job["cfg"], "num_factors": 7,
                                  "kernel": "torch"}),
                partitioner=part).fit(_ratings(job))),
            ("als_divisible", lambda: MeshALS(
                ALSConfig(num_factors=7), partitioner=part).fit(
                _ratings(job)))):
        try:
            fn()
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def drop_step(part: Partitioner, job) -> None:
    """Rank 0 deletes one step's files of a sharded checkpoint (a save that
    never happened); every rank waits for it."""
    if part.rank == 0:
        for name in os.listdir(job["ckpt"]):
            if name.startswith(f"ckpt_{job['step']}."):
                os.unlink(os.path.join(job["ckpt"], name))
    dist.barrier()


def engine(part: Partitioner, job) -> dict:
    """``ServingEngine(mesh=)`` against the engine without a mesh on this
    rank: served lists, and the lists after ``apply_delta`` of item rows
    against an engine built on the patched model."""
    from large_scale_recommendation_tpu_torch.serving import (
        RetrievalConfig,
        ServingEngine,
    )

    model = MFModel(U=torch.as_tensor(job["U"]), V=torch.as_tensor(job["V"]),
                    users=_index(job["users"]), items=_index(job["items"]))
    kw = dict(k=job["k"], train=job.get("train"), max_batch=32)
    if job.get("two_stage"):
        kw["retrieval"] = RetrievalConfig()
    mesh = ServingEngine(model, mesh=part, **kw)
    plain = ServingEngine(model, **kw)
    out = {"mesh": mesh.serve(job["requests"]),
           "plain": plain.serve(job["requests"])}
    if job.get("delta") is not None:
        rows, vals = job["delta"]
        mesh.apply_delta(item_rows=rows, V_rows=vals)
        patched = model.V.clone()
        patched[torch.as_tensor(rows)] = torch.as_tensor(vals)
        fresh = ServingEngine(MFModel(U=model.U, V=patched,
                                      users=model.users, items=model.items),
                              mesh=part, **kw)
        out["delta"] = mesh.serve(job["requests"])
        out["fresh"] = fresh.serve(job["requests"])
    return {key: [(np.asarray(r[0]), np.asarray(r[1])) for r in res]
            for key, res in out.items()}


def retriever(part: Partitioner, job) -> dict:
    """``TwoStageRetriever(partitioner=)`` (rank-sharded at m > 1) against
    the one-device retriever on this rank: stage-2 and stage-1-only top-k
    of the queries, and both after ``apply_delta``; the local shapes."""
    from large_scale_recommendation_tpu_torch.serving import retrieval as rt
    from large_scale_recommendation_tpu_torch.utils.metrics import (
        _exclusion_builder,
    )

    cfg = rt.RetrievalConfig(n_clusters=job.get("n_clusters"),
                             kmeans_iters=2)
    V, Q = (torch.as_tensor(a) for a in (job["V"], job["Q"]))
    shd = rt.TwoStageRetriever(V, config=cfg, partitioner=part)
    base = rt.TwoStageRetriever(V, config=cfg)
    tu, ti = job.get("train", (None, None))
    excl = tuple(torch.from_numpy(a) for a in _exclusion_builder(
        tu, ti, len(Q))(np.arange(len(Q)), len(Q)))
    out = {}
    for name, r in (("sharded", shd), ("base", base)):
        out[name] = [tuple(t.numpy() for t in r.topk(Q, excl, k=10,
                                                     stage1_only=s1))
                     for s1 in (False, True)]
        rows, vals = job["delta"]
        r.apply_delta(rows, torch.as_tensor(vals), version=7)
        out[name].append(tuple(t.numpy() for t in r.topk(Q, excl, k=10)))
    cat = shd.catalog
    out["shapes"] = {n: tuple(getattr(cat, n).shape)
                     for n in ("q", "slab_q", "ovf_q")
                     if getattr(cat, n) is not None}
    out["V_shape"] = tuple(shd.V.shape)
    return out


def jax_catalog(part: Partitioner, job) -> dict:
    """``convert.quantized_catalog_from_jax(partitioner=)`` of a JAX
    rank-sharded catalog (its global arrays, ``job["cat"]``) against the
    same catalog converted whole: top-k through a rank-sharded retriever
    and a one-device one, and this rank's code columns."""
    import types

    from large_scale_recommendation_tpu_torch import convert
    from large_scale_recommendation_tpu_torch.serving import retrieval as rt
    from large_scale_recommendation_tpu_torch.utils.metrics import (
        _exclusion_builder,
    )

    ns = types.SimpleNamespace(**job["cat"])
    cfg = rt.RetrievalConfig(n_clusters=job["n_clusters"], kmeans_iters=2)
    V, Q = (torch.as_tensor(a) for a in (job["V"], job["Q"]))
    shd = rt.TwoStageRetriever(V, config=cfg, partitioner=part)
    shd.catalog = convert.quantized_catalog_from_jax(ns, device="cpu",
                                                     partitioner=part)
    base = rt.TwoStageRetriever(V, config=cfg)
    base.catalog = convert.quantized_catalog_from_jax(ns, device="cpu")
    excl = tuple(torch.from_numpy(a) for a in _exclusion_builder(
        None, None, len(Q))(np.arange(len(Q)), len(Q)))
    out = {name: tuple(t.numpy() for t in r.topk(Q, excl, k=10))
           for name, r in (("sharded", shd), ("base", base))}
    cat = shd.catalog
    out["cols"] = part.local_range((cat.rank,), "rank")[0]
    out["codes"] = {n: getattr(cat, n).numpy()
                    for n in ("q", "slab_q", "ovf_q")
                    if getattr(cat, n) is not None}
    out["rank_sharded"] = cat.stats["rank_sharded"]
    return out


def global_blocking(part: Partitioner, job) -> dict:
    """``global_device_blocked`` from this rank's part of the ratings (rows
    ``[rank·n, (rank+1)·n)`` of the job's arrays), then ``sweeps`` of the
    mesh step on its output (the ``"torch"`` route); the local layout and
    the gathered tables."""
    from large_scale_recommendation_tpu_torch.core.updaters import (
        RegularizedSGDUpdater,
        schedule_from_name,
    )
    from large_scale_recommendation_tpu_torch.parallel.distributed import (
        global_device_blocked,
    )
    from large_scale_recommendation_tpu_torch.parallel.dsgd_mesh import (
        build_mesh_dsgd_step,
    )

    n = len(job["u"]) // part.world_size
    last = part.rank == part.world_size - 1
    sl = slice(part.rank * n, (part.rank + 1) * n - int(
        bool(job.get("ragged")) and last))
    try:
        gba = global_device_blocked(
            job["u"][sl], job["i"][sl], job["r"][sl], job["w"][sl],
            job["num_users"], job["num_items"], part,
            minibatch_multiple=job["mb"], seed=0, rank=job["rank"],
            init_scale=0.3)
    except ValueError as e:
        return {"error": str(e)}
    out = {f: _np(getattr(gba, f)) for f in (
        "U", "V", "ru", "ri", "rv", "rw", "icu", "icv", "omega_u",
        "omega_v")}
    out.update(row_of_user=gba.row_of_user, row_of_item=gba.row_of_item)
    upd = RegularizedSGDUpdater(learning_rate=0.05, lambda_=0.01,
                                schedule=schedule_from_name("constant"))
    step = build_mesh_dsgd_step(part, upd, job["mb"], gba.num_blocks,
                                with_inv=True, kernel="torch")
    U, V = step(gba.U.clone(), gba.V.clone(), gba.omega_u, gba.omega_v,
                gba.strata, iterations=job["sweeps"])
    out["U_trained"] = _np(part.gather(U, "users", "rank"))
    out["V_trained"] = _np(part.gather(V, "items", "rank"))
    return out
