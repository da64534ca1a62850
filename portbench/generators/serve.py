"""The serving generator: top-K requests of independent users under an
open-loop load above what the engine sustains, answered by
``ServingEngine.serve``.

Set-up makes the configuration's training ratings on the card from the
seed (``reference/generator.py``) and hands them to the engine on the host
as its exclusion set (no user is served an item it rated), draws the
factor tables on the card from the seed (``reference/topk.factors``),
builds an ``MFModel`` over every user and item and a ``ServingEngine``
from the configuration's ``serve`` block (``k``, ``max_batch``, the
catalog's ``dtype``; ``torch_threads``, the serving process's intra-op
threads, a setting of the deployment), and draws the requests: Poisson
arrivals at ``rate_rps``, each for a number of users uniform in
``[users_min, users_max]``, the users drawn with the ratings' skew. It
serves one request of every bucket of the engine's shape family.

The window is an open loop: requests fall due at their arrival times,
counted from the window's start, and each ``serve`` call takes the due
requests, oldest first and whole, up to ``max_batch`` users. The rate lies
above what the engine sustains, so the queue grows through the window and
every call after the first few is full. ``serve_users_per_s``: users
answered over the wall from the window's start to the end of the call that
crosses the deadline.

The check compares the answers to a sample of the requests, about one in
``SAMPLE_EVERY`` drawn from the seed, with the plain exact top-K of
``reference/topk.py`` over the same factors and training pairs.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench.reference import generator
from portbench.reference.topk import factors, sample_mask, topk_gaps

HORIZON_S = 30.0  # arrivals drawn past the window, for the traced tail
SAMPLE_EVERY = 32  # ~160K answered users compared, under a second's work


def _serve_cfg(ctx):
    return ctx.config["serve"]


def setup(ctx):
    from large_scale_recommendation_tpu_torch.data.blocking import (
        flat_index)
    from large_scale_recommendation_tpu_torch.models.mf import MFModel
    from large_scale_recommendation_tpu_torch.serving.engine import (
        ServingEngine)

    data, cfg, mix = ctx.config["data"], _serve_cfg(ctx), ctx.mix
    torch.set_num_threads(int(cfg["torch_threads"]))
    nu, ni = int(data["num_users"]), int(data["num_items"])
    u, i, _ = generator.dataset(data, ctx.seed, ctx.device)
    train = (u.cpu().numpy(), i.cpu().numpy())
    del u, i
    U, V = factors(ctx.seed, nu, ni, int(cfg["num_factors"]), ctx.device)
    model = MFModel(U=U, V=V, users=flat_index(np.arange(nu)),
                    items=flat_index(np.arange(ni)))
    engine = ServingEngine(model, k=int(cfg["k"]), train=train,
                           dtype=cfg["dtype"],
                           max_batch=int(cfg["max_batch"]))
    # the requests: arrivals, sizes, users (with the ratings' skew)
    rate = float(mix["rate_rps"])
    n = int(rate * (ctx.seconds + HORIZON_S)) + 1
    rng = np.random.default_rng([int(ctx.seed) % (1 << 63), 11])
    arrival = np.cumsum(rng.exponential(1.0 / rate, n))
    sizes = rng.integers(int(mix["users_min"]), int(mix["users_max"]) + 1,
                         n)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    users = generator.skewed_ids(
        generator.generator(ctx.seed, 9, ctx.device), float(data["skew"]),
        nu, int(offsets[-1])).cpu().numpy()
    for b in engine.bucket_family:  # every shape the window can use
        engine.serve([users[:b]])
    ctx.sync()
    return {"engine": engine, "model": model, "train": train,
            "arrival": arrival, "offsets": offsets, "users": users,
            "sample": sample_mask(ctx.seed, n, SAMPLE_EVERY),
            "next": 0, "answers": [], "t0": None}


def _call(ctx, state):
    """One ``serve`` call on the due requests; returns its end."""
    arrival, offs = state["arrival"], state["offsets"]
    j0 = state["next"]
    if j0 >= arrival.shape[0]:
        raise RuntimeError("the drawn requests ran out")
    while time.perf_counter() - state["t0"] < arrival[j0]:
        pass  # nothing due: the next request's arrival
    now = time.perf_counter() - state["t0"]
    due = int(np.searchsorted(arrival, now, side="right"))
    cap = int(np.searchsorted(offs, offs[j0] + int(_serve_cfg(ctx)[
        "max_batch"]), side="right")) - 1
    j1 = max(min(due, cap), j0 + 1)
    users = state["users"]
    reqs = [users[offs[j]:offs[j + 1]] for j in range(j0, j1)]
    t0 = time.perf_counter()
    with torch.profiler.record_function("bench/serve"):
        out = state["engine"].serve(reqs)
    t1 = time.perf_counter()
    ctx.spans.add("serve", t0, t1)
    sample = state["sample"]
    for j in range(j0, j1):
        if sample[j]:
            state["answers"].append((j, out[j - j0][0], out[j - j0][1]))
    state["next"] = j1
    ctx.spans.count("users", int(offs[j1] - offs[j0]))
    ctx.spans.count("requests", j1 - j0)
    return t1


def window(ctx, state):
    stats = state["engine"].stats
    rows0, flushes0 = stats["rows"], stats["flushes"]
    state["t0"] = t0 = time.perf_counter()
    while True:
        t_end = _call(ctx, state)
        if t_end >= ctx.deadline:
            break
    wall = t_end - t0
    users = ctx.spans.counters["users"]
    backlog = int(np.searchsorted(state["arrival"], wall, side="right")
                  - state["next"])
    ctx.facts.update(window_call_walls=ctx.spans.walls("serve"),
                     window_rows=stats["rows"] - rows0,
                     window_flushes=stats["flushes"] - flushes0,
                     backlog_requests=backlog)
    ctx.facts["attempted"] = int(ctx.spans.counters["requests"])
    print(f"serve window: {len(ctx.spans.walls('serve'))} calls, {users} "
          f"users, {backlog} requests due and not yet served at its end",
          file=sys.stderr)
    return {"serve_users_per_s": users / wall}


def traced(ctx, state):
    n = int(ctx.mix["trace_calls"])
    for _ in range(n):
        _call(ctx, state)
    ctx.facts["traced_calls"] = n


def check(ctx, state):
    cfg, data = _serve_cfg(ctx), ctx.config["data"]
    del state["engine"], state["model"]
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    k = int(cfg["k"])
    answers = state.pop("answers")
    offs, users = state["offsets"], state["users"]
    if answers:
        rows_u = np.concatenate([users[offs[j]:offs[j + 1]]
                                 for j, _, _ in answers])
        ids = np.concatenate([a for _, a, _ in answers])
        scores = np.concatenate([s for _, _, s in answers])
    else:
        rows_u = np.zeros(0, np.int64)
        ids, scores = np.zeros((0, k), np.int64), np.zeros((0, k))
    dev = ctx.device
    U, V = factors(ctx.seed, int(data["num_users"]), int(data["num_items"]),
                   int(cfg["num_factors"]), dev)
    tu, ti = (torch.from_numpy(a).to(dev) for a in state.pop("train"))
    bad, rank, score = topk_gaps(
        U, V, tu, ti, torch.from_numpy(rows_u.astype(np.int64)).to(dev),
        torch.from_numpy(ids.astype(np.int64)).to(dev),
        torch.from_numpy(scores).to(dev), k)
    if not answers:  # nothing compared is no evidence of correctness
        rank = float("inf")
    ctx.facts["compared_users"] = int(rows_u.shape[0])
    return [("excluded_or_missing", float(bad),
             ctx.cell.limit("excluded_or_missing")),
            ("rank_gap", rank, ctx.cell.limit("rank_gap")),
            ("score_gap", score, ctx.cell.limit("score_gap"))]
