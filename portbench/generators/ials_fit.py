"""The implicit-feedback training job: whole iALS fits (``ALS.fit_device``
with the configuration's ``implicit_alpha``) back to back.

Set-up draws the configuration's pairs on the card from the seed
(``reference/generator.py``; only the ids are used, the planted ratings
are not), coalesces them to one entry a (user, item) pair whose strength r
is the pair's multiplicity (one ``torch.unique`` over u·N + i, as a user's
job would before its fit), builds ``ALS`` from the ``als`` block and runs
one warm fit. The window and the traced tail are ``fit.py``'s:
``train_ratings_per_s`` is coalesced pairs × rounds × fits over the wall
from the window's start to the end of the fit crossing the deadline.

The check takes the last fit's tables by id, frees the program, works the
same fit out again with the plain float64 iALS (``reference/ials.py``) and
compares the tables over the ids seen (``table_gap``: ``U_gap``,
``V_gap``).
"""

from __future__ import annotations

import torch

from portbench.generators import fit
from portbench.generators.fit import traced, window  # noqa: F401
from portbench.reference import generator
from portbench.reference import ials as ref_ials
from portbench.reference.compare import table_gap


def coalesce(u: torch.Tensor, i: torch.Tensor, num_items: int):
    """One entry a distinct (u, i) pair, in (u, i) order, with its
    multiplicity as an f32 strength: ``(u, i, r)``, ids int32."""
    key, count = torch.unique(u.long() * num_items + i.long(),
                              return_counts=True)
    return ((key // num_items).to(torch.int32),
            (key % num_items).to(torch.int32), count.to(torch.float32))


def setup(ctx):
    data = ctx.config["data"]
    u, i = generator.dataset(data, ctx.seed, ctx.device)[:2]
    ctx.mark("data")
    pairs = coalesce(u, i, int(data["num_items"]))
    del u, i
    ctx.mark("coalesce")
    state = {"data": pairs, "solver": fit._solver(ctx), "model": None}
    state["model"] = fit._fit(ctx, state)  # the warm fit
    return state


def check(ctx, state):
    model = state.pop("model")
    got = {side: fit._by_id(model, side) for side in ("users", "items")}
    del model
    state.pop("solver")
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    u, i, r = state["data"]
    data = ctx.config["data"]
    block = ctx.config["als"]
    U, V, om_u, om_v = ref_ials.fit(
        u, i, r, int(data["num_users"]), int(data["num_items"]),
        block["num_factors"], lam=block["lambda_"],
        alpha=block["implicit_alpha"], rounds=block["iterations"],
        init_scale=block["init_scale"])
    out = []
    for (ids, rows), table, seen, label in (
            (got["users"], U, om_u > 0, "U_gap"),
            (got["items"], V, om_v > 0, "V_gap")):
        ref_ids = torch.nonzero(seen).reshape(-1)
        if not torch.equal(ids.to(ref_ids.device), ref_ids):
            gap = float("inf")
        else:
            gap = table_gap(rows, table[ref_ids])
        out.append((label, gap, ctx.cell.limit(label)))
    return out
