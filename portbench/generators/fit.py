"""The training-job generator: whole fits of one batch solver, back to back.

The mix names the solver (``dsgd``: ``DSGD.fit_device``; ``als``:
``ALS.fit_device``). Set-up makes the configuration's training ratings on
the card from the seed (``reference/generator.py``), builds the solver from
the configuration's block of that name and runs one warm fit. The window
runs fits until the deadline; the fit that crosses it is finished and
counted. ``train_ratings_per_s`` is training ratings × sweeps (rounds) of
every fit over the wall from the window's start to the last fit's end.

The check takes the last fit's tables by id, frees the program, works the
same fit out again with the plain reference (``reference/dsgd.py``,
``reference/als.py``) and compares the tables (``table_gap``).
"""

from __future__ import annotations

import time

import torch

from portbench.reference import als as ref_als
from portbench.reference import dsgd as ref_dsgd
from portbench.reference import generator
from portbench.reference.compare import table_gap
from portbench.reference.counts import als_round_flops, dsgd_step_bounds


def _solver(ctx):
    name = ctx.mix["solver"]
    block = dict(ctx.config[name])
    if name == "dsgd":
        from large_scale_recommendation_tpu_torch.models.dsgd import (
            DSGD, DSGDConfig)

        block.pop("num_blocks")
        block.setdefault("seed", ctx.seed)
        return DSGD(DSGDConfig(**block), device=ctx.device)
    from large_scale_recommendation_tpu_torch.models.als import (
        ALS, ALSConfig)

    return ALS(ALSConfig(**block), device=ctx.device)


def _fit(ctx, state):
    data = ctx.config["data"]
    u, i, r = state["data"]
    solver = state["solver"]
    if ctx.mix["solver"] == "dsgd":
        return solver.fit_device(u, i, r, data["num_users"],
                                 data["num_items"],
                                 num_blocks=ctx.config["dsgd"]["num_blocks"])
    return solver.fit_device(u, i, r, data["num_users"], data["num_items"])


def _timed_fit(ctx, state):
    t0 = time.perf_counter()
    with torch.profiler.record_function("bench/fit"):
        state["model"] = _fit(ctx, state)
        ctx.sync()
    t1 = time.perf_counter()
    ctx.spans.add("fit", t0, t1)
    solver = state["solver"]
    if ctx.mix["solver"] == "dsgd":
        ctx.spans.count("device_ms_in_segments", sum(solver.segment_ms))
    else:
        ctx.spans.count("round_ms_sum", sum(solver.round_ms))
        ctx.spans.count("rounds", len(solver.round_ms))
    return t1


def setup(ctx):
    state = {"data": generator.dataset(ctx.config["data"], ctx.seed,
                                       ctx.device),
             "solver": _solver(ctx), "model": None}
    state["model"] = _fit(ctx, state)  # the warm fit
    return state


def _sweeps(ctx) -> int:
    return int(ctx.config[ctx.mix["solver"]]["iterations"])


def window(ctx, state):
    t0 = time.perf_counter()
    fits = 0
    while True:
        t_end = _timed_fit(ctx, state)
        fits += 1
        if t_end >= ctx.deadline:
            break
    nnz = int(state["data"][0].shape[0])
    wall = t_end - t0
    ctx.facts.update(fits=fits, fit_wall_s=wall, nnz=nnz,
                     sweeps=_sweeps(ctx),
                     window_fit_walls=ctx.spans.walls("fit"),
                     window_counters=dict(ctx.spans.counters))
    ctx.facts["attempted"] = fits
    return {"train_ratings_per_s": nnz * _sweeps(ctx) * fits / wall}


def traced(ctx, state):
    n = int(ctx.mix["trace_fits"])
    for _ in range(n):
        _timed_fit(ctx, state)
    ctx.facts["traced_fits"] = n


def _by_id(model, side: str):
    """The rows of ids seen in training, in id order, and the ids."""
    index = getattr(model, side)
    table = model.U if side == "users" else model.V
    ids = torch.as_tensor(index.sorted_ids, device=table.device)
    rows = torch.as_tensor(index.sorted_rows, device=table.device)
    order = torch.argsort(ids)
    return ids[order], table[rows[order]].float().clone()


def check(ctx, state):
    model = state.pop("model")
    got = {side: _by_id(model, side) for side in ("users", "items")}
    del model
    state.pop("solver")
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    u, i, r = state["data"]
    data = ctx.config["data"]
    nu, ni = data["num_users"], data["num_items"]
    name = ctx.mix["solver"]
    block = ctx.config[name]
    if name == "dsgd":
        lay = ref_dsgd.layout(u, i, r, nu, ni, block["num_blocks"],
                              block["minibatch_size"],
                              block.get("seed", ctx.seed),
                              sort=block.get("minibatch_sort"))
        ctx.facts["step_bounds_s"] = dsgd_step_bounds(
            *ref_dsgd.step_counts(lay), rank=block["num_factors"])
        U, V = ref_dsgd.train(lay, block["num_factors"],
                              lr=block["learning_rate"],
                              lam=block["lambda_"],
                              sweeps=block["iterations"],
                              init_scale=block["init_scale"])
        want = {"users": (lay.row_of_user, U), "items": (lay.row_of_item, V)}
        seen = {"users": lay.omega_u[lay.row_of_user] > 0,
                "items": lay.omega_v[lay.row_of_item] > 0}
    else:
        U, V, om_u, om_v = ref_als.fit(u, i, r, nu, ni, block["num_factors"],
                                       lam=block["lambda_"],
                                       rounds=block["iterations"],
                                       init_scale=block["init_scale"])
        ctx.facts["round_flops"] = als_round_flops(
            int(u.shape[0]), int((om_u > 0).sum()), int((om_v > 0).sum()),
            block["num_factors"])
        ar = {"users": torch.arange(nu, device=U.device),
              "items": torch.arange(ni, device=U.device)}
        want = {"users": (ar["users"], U), "items": (ar["items"], V)}
        seen = {"users": om_u > 0, "items": om_v > 0}
    out = []
    for side, label in (("users", "U_gap"), ("items", "V_gap")):
        ids, rows = got[side]
        row_of, table = want[side]
        ref_ids = torch.nonzero(seen[side]).reshape(-1)
        if not torch.equal(ids.to(ref_ids.device), ref_ids):
            out.append((label, float("inf"), ctx.cell.limit(label)))
            continue
        out.append((label, table_gap(rows, table[row_of[ref_ids]]),
                    ctx.cell.limit(label)))
    return out
