"""The adaptive generator: a stream with a synchronous full retrain every
few batches, caught up in a closed loop.

Set-up makes the stream with ``stream.py``'s ``setup`` (the
configuration's ratings on the card from the seed, kept on the host in
micro-batches of ``batch``; a throwaway online model warmed), builds an
``AdaptiveMF`` from the configuration's ``online``, ``retrain`` and
``dsgd`` blocks, preloads its history with every batch of the stream in
arrival order (its ring keeps the newest ``history_limit`` ratings; the
tables register every id) and runs one retrain and install. The window
feeds the batches to ``AdaptiveMF.process`` (ingest mode) in arrival
order, wrapping at the stream's end: the ring slides on, and holds no
rating twice while ``history_limit`` is below the stream's length. Every
``offline_every``-th call retrains and swaps. Each call is timed from
``process``'s call to its tables being ready on the card.

``stream_ratings_per_s``: ratings absorbed over the window's wall,
retrains included; ``stream_batch_p95_ms``: the 95th percentile of every
call's wall (one call in ``offline_every`` carries a retrain: the stall the
stream sees).

The check (``reference/adaptive.py``), after the window and the traced
tail, of the last swap:

- ``retrain_U_gap`` / ``retrain_V_gap``: the retrain's tables against the
  plain DSGD over that retrain's window, on the window's rows;
- ``install_gap``: the tables right after the swap against the retrained
  rows on the window's rows and the tables right before it elsewhere (a
  copy: limit 0);
- ``U_gap`` / ``V_gap``: the final tables against the plain online SGD
  replayed from the tables right after the swap over the batches since,
  and the tables right before the swap against it replayed from those
  right after the swap before it (so that at least ``offline_every``
  online steps are held to it, wherever the run ends).

Every gap reads infinite unless the program numbered its rows in the order
the stream first showed the ids (the preload feeds the whole stream, so
every id has its row before the first swap). The swap gate (the online
model's ``watchdog``) hands over the retrain's tables and the tables
before the install; the tables after it are those the swap's call left.
All three are references kept (a table is never written in place), not
copies.
"""

from __future__ import annotations

import time

import torch

from portbench.generators import stream
from portbench.harness import BenchError, percentile
from portbench.reference import adaptive as ref_adaptive
from portbench.reference.compare import table_gap

# the online block's settings that AdaptiveMF takes from OnlineMFConfig's
# defaults (init_capacity only sizes the tables' growth)
_ONLINE_DEFAULTS = ("init_scale", "iterations_per_batch", "collision_mode")


def _config(ctx):
    from large_scale_recommendation_tpu_torch.models.adaptive import (
        DeviceAdaptiveMFConfig)
    from large_scale_recommendation_tpu_torch.models.dsgd import DSGDConfig

    o, rt = ctx.config["online"], ctx.config["retrain"]
    dsgd = dict(ctx.config["dsgd"])
    dsgd.setdefault("seed", ctx.seed)
    return DeviceAdaptiveMFConfig(
        num_factors=o["num_factors"], learning_rate=o["learning_rate"],
        minibatch_size=o["minibatch_size"],
        offline_every=rt["offline_every"],
        history_limit=rt["history_limit"], background=rt["background"],
        retrain=DSGDConfig(**dsgd))


class _SwapGate:
    """The online model's watchdog: lets every batch and swap through, and
    keeps, at each swap, the retrain's tables and the live tables before
    the install."""

    def __init__(self, model):
        self.model = model
        self.retrained = None
        self.before = None

    def after_batch(self, online, U, V, u_rows, i_rows) -> None:
        pass

    def check_swap(self, U, V) -> None:
        self.retrained = (U, V)
        self.before = (self.model.online.users.array,
                       self.model.online.items.array)


def _note_swap(state) -> None:
    """Keep the last two swaps: the batches fed by then, and the tables."""
    model, gate = state["model"], state["gate"]
    state["swaps"] = state.get("swaps", [])[-1:] + [{
        "fed": state["fed"], "retrained": gate.retrained,
        "before": gate.before,
        "after": (model.online.users.array, model.online.items.array)}]


def setup(ctx):
    from large_scale_recommendation_tpu_torch.models.adaptive import (
        AdaptiveMF)

    cfg = _config(ctx)  # before the stream: a program without it fails now
    state = stream.setup(ctx)
    del state["model"]
    model = AdaptiveMF(cfg, device=ctx.device)
    for key in _ONLINE_DEFAULTS:
        if getattr(model.online.config, key) != ctx.config["online"][key]:
            raise BenchError(f"AdaptiveMF's online {key} is not the "
                             "configuration's")
    gate = _SwapGate(model)
    model.watchdog = gate
    for b in state["batches"]:
        model.preload_history(b)
    ctx.sync()
    ctx.mark("preload")
    model.trigger_batch_training()  # the warm retrain and install
    ctx.sync()
    ctx.mark("warm_retrain")
    state.update(model=model, gate=gate, fed=len(state["batches"]))
    _note_swap(state)
    return state


def _call(ctx, state):
    model = state["model"]
    b = state["batches"][state["fed"] % len(state["batches"])]
    retrains = model.retrain_count
    t0 = time.perf_counter()
    with torch.profiler.record_function("bench/process"):
        model.process(b, emit_updates=False)
        ctx.sync()
    t1 = time.perf_counter()
    ctx.spans.add("call", t0, t1)
    state["fed"] += 1
    if model.retrain_count != retrains:
        _note_swap(state)
    return t1


def window(ctx, state):
    retrains = state["model"].retrain_count
    calls = 0
    t0 = time.perf_counter()
    while True:
        t_end = _call(ctx, state)
        calls += 1
        if t_end >= ctx.deadline:
            break
    walls = ctx.spans.walls("call")
    bs = int(ctx.mix["batch"])
    ctx.facts.update(calls=calls,
                     retrains=state["model"].retrain_count - retrains,
                     window_call_walls=walls)
    ctx.facts["attempted"] = calls
    return {"stream_ratings_per_s": calls * bs / (t_end - t0),
            "stream_batch_p95_ms": 1e3 * percentile(walls, 95)}


def traced(ctx, state):
    n = int(ctx.mix["trace_calls"])
    retrains = state["model"].retrain_count
    for _ in range(n):
        _call(ctx, state)
    bs = int(ctx.mix["batch"])
    ctx.facts.update(
        traced_calls=n,
        traced_retrains=state["model"].retrain_count - retrains,
        window_ratings=min(int(ctx.config["retrain"]["history_limit"]),
                           state["fed"] * bs))


def check(ctx, state):
    model = state.pop("model")
    final = [(t.id_array(), t.array[:t.num_rows])
             for t in (model.online.users, model.online.items)]
    del model, state["gate"]
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    data, dsgd = ctx.config["data"], ctx.config["dsgd"]
    online = ctx.config["online"]
    bs, n_b = int(ctx.mix["batch"]), len(state["batches"])
    n = n_b * bs
    hu, hi, hr = (torch.from_numpy(a).to(ctx.device) for a in state["host"])
    hu, hi = hu.to(torch.int64), hi.to(torch.int64)
    maps = [ref_adaptive.first_seen_rows(hu, data["num_users"]),
            ref_adaptive.first_seen_rows(hi, data["num_items"])]
    names = ("retrain_U_gap", "retrain_V_gap", "install_gap", "U_gap",
             "V_gap")
    if not all(torch.equal(torch.as_tensor(ids, device=ctx.device), id_of)
               for (ids, _), (_, id_of) in zip(final, maps)):
        return [(name, float("inf"), ctx.cell.limit(name)) for name in names]
    (row_u, id_u), (row_i, id_i) = maps
    nu, ni = id_u.shape[0], id_i.shape[0]

    # the last swap's window: the newest history_limit ratings fed by then
    swap = state["swaps"][-1]
    end = swap["fed"] * bs
    pos = torch.arange(max(0, end - int(ctx.config["retrain"]
                                          ["history_limit"])), end,
                       device=ctx.device) % n
    lay, U, V = ref_adaptive.retrain(
        row_u[hu[pos]], row_i[hi[pos]], hr[pos], nu, ni, dsgd,
        dsgd.get("seed", ctx.seed))
    del pos
    out = []
    installed = []
    for side, label, T, got, before, after in (
            ("users", "retrain_U_gap", U, swap["retrained"][0],
             swap["before"][0][:nu], swap["after"][0][:nu]),
            ("items", "retrain_V_gap", V, swap["retrained"][1],
             swap["before"][1][:ni], swap["after"][1][:ni])):
        ids = ref_adaptive.window_rows(lay, side)
        rows = (lay.row_of_user if side == "users" else lay.row_of_item)[ids]
        gap = (table_gap(got[rows].float(), T[rows])
               if got.shape == T.shape else float("inf"))
        out.append((label, gap, ctx.cell.limit(label)))
        installed.append(
            table_gap(after, ref_adaptive.install(before, ids, rows, got))
            if got.shape == T.shape else float("inf"))
    out.append(("install_gap", max(installed),
                ctx.cell.limit("install_gap")))
    del lay, U, V

    def replay(tables, start, stop):
        ref = ref_adaptive.online_from(tables[0][:nu], tables[1][:ni],
                                       lr=online["learning_rate"],
                                       minibatch=online["minibatch_size"])
        for j in range(start, stop):
            sl = slice((j % n_b) * bs, (j % n_b + 1) * bs)
            ref.batch(row_u[hu[sl]], row_i[hi[sl]], hr[sl])
        return ref.U, ref.V

    pairs = [((final[0][1], final[1][1]),
              replay(swap["after"], swap["fed"], state["fed"]))]
    if len(state["swaps"]) == 2:
        prev = state["swaps"][0]
        pairs.append(((swap["before"][0][:nu], swap["before"][1][:ni]),
                      replay(prev["after"], prev["fed"], swap["fed"])))
    for side, label in ((0, "U_gap"), (1, "V_gap")):
        gap = max(table_gap(got[side], want[side]) for got, want in pairs)
        out.append((label, gap, ctx.cell.limit(label)))
    return out
