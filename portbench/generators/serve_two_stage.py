"""The two-stage serving generator: top-K candidate generation over a large
catalog, answered by ``ServingEngine(retrieval=RetrievalConfig(...))``
under the open loop of ``serve.py``.

Set-up makes the configuration's pairs on the card from the seed
(``reference/generator.py``), sorted by user (a playlist's tracks
together, as a playlist file holds them), and hands them to the engine on
the host as its exclusion set (no user is served an item it holds); draws
the factor tables on the card from the seed (``reference/topk.factors``);
builds an ``MFModel`` over every user and item and a ``ServingEngine``
from the configuration's ``serve`` block (``k``, ``max_batch``,
``torch_threads``, and ``retrieval``: ``n_clusters``, ``overfetch``,
``max_bucket`` of a ``RetrievalConfig``); and draws the requests as
``serve.py`` does: Poisson arrivals at ``rate_rps``, each of a number of
users uniform in ``[users_min, users_max]`` drawn with the pairs' skew.
It serves one request of every bucket of the engine's shape family.

The window and the traced tail are ``serve.py``'s open loop (imported):
``serve_users_per_s`` is users answered over the wall from the window's
start to the end of the call that crosses the deadline.

The check compares a fixed sample of about ``SAMPLE`` answered requests,
drawn from the seed among the answers kept (one request in ``every``,
sized to keep about twice ``SAMPLE`` at the rate), with
``reference/topk.py``'s exact float64 top-K and the plain two-stage
answer of ``reference/two_stage.py``, on the card in blocks:

- ``excluded_or_missing``: answer slots missing, excluded or repeated;
- ``score_gap``: the widest gap between a served score and the float64
  score of that item, over the sample's largest best score;
- ``recall_miss``: 1 − recall@K against the exact answer;
- ``recall_gap``: how far the program's recall lies from the plain
  two-stage reference's, either way, on the same sample.

Two switches of the ``serve`` block, absent from the configuration, make
the controls of ``limits/<cell>.json``: ``rescore_dtype`` ``"bfloat16"``
rounds the retriever's f32 rescore table to bf16 values, and
``stage1_only`` serves stage 1's scores for every call (the admission
ladder's degraded point).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.generators import serve
from portbench.reference import generator, two_stage
from portbench.reference.topk import factors, sample_mask, topk_gaps

SAMPLE = 4096  # answered requests compared
BLOCK = 128  # users a block of the check's float64 scores


def _serve_cfg(ctx):
    return ctx.config["serve"]


def _stage1_only(retriever):
    """Every call of ``retriever.topk`` with ``stage1_only=True``."""
    topk = retriever.topk

    def degraded(*args, **kwargs):
        return topk(*args, **{**kwargs, "stage1_only": True})

    retriever.topk = degraded


def setup(ctx):
    from large_scale_recommendation_tpu_torch.data.blocking import (
        flat_index)
    from large_scale_recommendation_tpu_torch.models.mf import MFModel
    from large_scale_recommendation_tpu_torch.serving.engine import (
        ServingEngine)
    from large_scale_recommendation_tpu_torch.serving.retrieval import (
        RetrievalConfig)

    data, cfg, mix = ctx.config["data"], _serve_cfg(ctx), ctx.mix
    torch.set_num_threads(int(cfg["torch_threads"]))
    nu, ni = int(data["num_users"]), int(data["num_items"])
    u, i, _ = generator.dataset(data, ctx.seed, ctx.device)
    u, order = torch.sort(u, stable=True)
    train = (u.cpu().numpy(), i[order].cpu().numpy())
    del u, i, order
    ctx.mark("pairs")
    U, V = factors(ctx.seed, nu, ni, int(cfg["num_factors"]), ctx.device)
    model = MFModel(U=U, V=V, users=flat_index(np.arange(nu)),
                    items=flat_index(np.arange(ni)))
    ret = cfg["retrieval"]
    engine = ServingEngine(
        model, k=int(cfg["k"]), train=train,
        max_batch=int(cfg["max_batch"]),
        retrieval=RetrievalConfig(n_clusters=ret["n_clusters"],
                                  overfetch=int(ret["overfetch"]),
                                  max_bucket=int(ret["max_bucket"])))
    if cfg.get("rescore_dtype", "float32") == "bfloat16":
        engine.retriever.V = engine.retriever.V.bfloat16().float()
    if cfg.get("stage1_only", False):
        _stage1_only(engine.retriever)
    ctx.mark("engine")
    rate = float(mix["rate_rps"])
    n = int(rate * (ctx.seconds + serve.HORIZON_S)) + 1
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
    every = max(1, int(rate * ctx.seconds / (4 * SAMPLE)))
    return {"engine": engine, "model": model, "train": train,
            "arrival": arrival, "offsets": offsets, "users": users,
            "sample": sample_mask(ctx.seed, n, every),
            "next": 0, "answers": [], "t0": None}


window = serve.window
traced = serve.traced


def check(ctx, state):
    cfg, data = _serve_cfg(ctx), ctx.config["data"]
    del state["engine"], state["model"]
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    k = int(cfg["k"])
    answers = state.pop("answers")
    if len(answers) > SAMPLE:
        rng = np.random.default_rng([int(ctx.seed) % (1 << 63), 23])
        pick = np.sort(rng.choice(len(answers), SAMPLE, replace=False))
        answers = [answers[j] for j in pick]
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
    users_t = torch.from_numpy(rows_u.astype(np.int64)).to(dev)
    ids_t = torch.from_numpy(ids.astype(np.int64)).to(dev)
    bad, _, score = topk_gaps(U, V, tu, ti, users_t, ids_t,
                              torch.from_numpy(scores).to(dev), k,
                              block=BLOCK)
    got, ref = two_stage.recalls(U, V, tu, ti, users_t, ids_t, k,
                                 int(cfg["retrieval"]["overfetch"]),
                                 block=BLOCK)
    if not answers:  # nothing compared is no evidence of correctness
        score = got = ref = float("nan")
    ctx.facts["compared_users"] = int(rows_u.shape[0])
    return [("excluded_or_missing", float(bad),
             ctx.cell.limit("excluded_or_missing")),
            ("score_gap", score, ctx.cell.limit("score_gap")),
            ("recall_miss", 1.0 - got, ctx.cell.limit("recall_miss")),
            ("recall_gap", abs(got - ref), ctx.cell.limit("recall_gap"))]
