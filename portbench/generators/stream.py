"""The online-stream generator: a consumer catching up on a backlog, in a
closed loop.

Set-up makes the configuration's whole stream on the card from the seed
(``reference/generator.py``: ``data.ratings`` ratings in generation
order), keeps it on the host in micro-batches of ``batch`` ratings, and
warms a throwaway ``OnlineMF`` on the first batch. The window feeds the
batches in arrival order to a fresh ``OnlineMF.partial_fit`` (ingest mode,
``emit_updates=False``), each timed from the call to its tables being
ready on the card. A window that reaches the stream's end starts it again
on another fresh model, so every pass is the same work: new ids arrive
throughout, and no batch finds every id already known however fast the
run (``passes`` counts them).

``stream_ratings_per_s``: ratings applied over the window's wall;
``stream_batch_p95_ms``: the 95th percentile of every batch's wall.

The check replays every batch the last model took (the window's and the
traced tail's, from the start of its pass) with the plain online SGD
(``reference/online.py``) from the keyed init, and compares the tables of
every id the model registered.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import percentile
from portbench.reference import generator
from portbench.reference.compare import table_gap
from portbench.reference.online import OnlineSGD


def _model(ctx):
    from large_scale_recommendation_tpu_torch.models.online import (
        OnlineMF, OnlineMFConfig)

    return OnlineMF(OnlineMFConfig(**ctx.config["online"]),
                    device=ctx.device)


def setup(ctx):
    from large_scale_recommendation_tpu_torch.core.types import Ratings

    data = ctx.config["data"]
    Ut, Vt = generator.planted_factors(ctx.seed, data["num_users"],
                                       data["num_items"],
                                       data["planted_rank"], ctx.device)
    u, i, r = generator.planted_ratings(ctx.seed, 1, Ut, Vt,
                                        int(data["ratings"]),
                                        float(data["noise"]),
                                        float(data["skew"]))
    del Ut, Vt
    ctx.sync()
    ctx.mark("generated")
    bs = int(ctx.mix["batch"])
    n = (u.shape[0] // bs) * bs
    host = (u[:n].to(torch.int32).cpu().numpy(),
            i[:n].to(torch.int32).cpu().numpy(),
            r[:n].cpu().numpy())
    del u, i, r
    ctx.mark("to_host")
    ones = np.ones(bs, np.float32)
    batches = [Ratings(host[0][a:a + bs], host[1][a:a + bs],
                       host[2][a:a + bs], ones) for a in range(0, n, bs)]
    ctx.mark("batches")
    warm = _model(ctx)
    warm.partial_fit(batches[0], emit_updates=False)
    ctx.sync()
    ctx.mark("warm")
    del warm
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return {"host": host, "batches": batches, "model": _model(ctx),
            "applied": 0, "pass_start": 0}


def _batch(ctx, state):
    j = state["applied"] % len(state["batches"])
    if j == 0 and state["applied"]:  # a new pass, on a fresh model
        del state["model"]
        state["model"] = _model(ctx)
        state["pass_start"] = state["applied"]
    b = state["batches"][j]
    t0 = time.perf_counter()
    with torch.profiler.record_function("bench/partial_fit"):
        state["model"].partial_fit(b, emit_updates=False)
        ctx.sync()
    t1 = time.perf_counter()
    ctx.spans.add("batch", t0, t1)
    state["applied"] += 1
    return t1


def window(ctx, state):
    t0 = time.perf_counter()
    while True:
        t_end = _batch(ctx, state)
        if t_end >= ctx.deadline:
            break
    walls = ctx.spans.walls("batch")
    n = state["applied"]
    bs = int(ctx.mix["batch"])
    ctx.facts.update(batches=n, passes=n / len(state["batches"]),
                     window_batch_walls=walls)
    ctx.facts["attempted"] = n
    return {"stream_ratings_per_s": n * bs / (t_end - t0),
            "stream_batch_p95_ms": 1e3 * percentile(walls, 95)}


def traced(ctx, state):
    n = int(ctx.mix["trace_batches"])
    before = len(ctx.spans.spans)
    for _ in range(n):
        _batch(ctx, state)
    ctx.facts["traced_batches"] = n
    ctx.facts["traced_batch_walls"] = [
        b - a for _, a, b in ctx.spans.spans[before:]]


def check(ctx, state):
    model = state.pop("model")
    got = {}
    for side in ("users", "items"):
        table = getattr(model, side)
        ids = torch.as_tensor(table.id_array(), device=ctx.device)
        got[side] = (ids, table.array[:ids.shape[0]].float().clone())
    del model
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    cfg, data = ctx.config["online"], ctx.config["data"]
    control = ctx.config.get("control") == "reference_bf16"
    ref = OnlineSGD(data["num_users"], data["num_items"], cfg["num_factors"],
                    lr=cfg["learning_rate"], minibatch=cfg["minibatch_size"],
                    init_scale=cfg["init_scale"], device=ctx.device)
    twin = (OnlineSGD(data["num_users"], data["num_items"],
                      cfg["num_factors"], lr=cfg["learning_rate"],
                      minibatch=cfg["minibatch_size"],
                      init_scale=cfg["init_scale"], device=ctx.device,
                      dtype=torch.bfloat16) if control else None)
    bs = int(ctx.mix["batch"])
    hu, hi, hr = (torch.from_numpy(a).to(ctx.device) for a in state["host"])
    hu, hi = hu.to(torch.int64), hi.to(torch.int64)
    n_b = len(state["batches"])
    seen = {"users": torch.zeros(data["num_users"], dtype=torch.bool,
                                 device=ctx.device),
            "items": torch.zeros(data["num_items"], dtype=torch.bool,
                                 device=ctx.device)}
    for j in range(state["pass_start"], state["applied"]):
        a = (j % n_b) * bs
        sl = slice(a, a + bs)
        seen["users"][hu[sl]] = True
        seen["items"][hi[sl]] = True
        ref.batch(hu[sl], hi[sl], hr[sl])
        if twin is not None:
            twin.batch(hu[sl], hi[sl], hr[sl])
    if twin is not None:  # the control stands in the program's place
        got = {"users": (got["users"][0], twin.U[got["users"][0]].float()),
               "items": (got["items"][0], twin.V[got["items"][0]].float())}
    out = []
    for side, label, table in (("users", "U_gap", ref.U),
                               ("items", "V_gap", ref.V)):
        ids, rows = got[side]
        want_ids = torch.nonzero(seen[side]).reshape(-1)
        gap = (table_gap(rows, table[ids].float())
               if torch.equal(torch.sort(ids).values, want_ids)
               else float("inf"))
        out.append((label, gap, ctx.cell.limit(label)))
    return out
