"""The port's REQUEST plane (``obs.requests``) against the JAX package's,
from the same seeded inputs: ``FlushLedger`` marks fed explicit clock
values give equal ``stages`` dicts that ``math.fsum`` to the flush total
exactly; ``RequestTelemetry`` fed the same flushes and sheds gives equal
``/slowz`` snapshots (wall-clock ``time`` fields dropped), stage quantiles,
``RequestStageCheck`` verdicts and Prometheus text, all compared for
equality (host arithmetic in one order). Then the plane on the port's
``ServingEngine`` over a 2,000 × 500 rank-16 model on the CPU: every
flush's stages reconcile with its measured wall and each request's with its
SLO-recorded latency, ``/slowz`` keeps every violating and shed request,
the two-stage path splits ``score_stage1`` / ``score_stage2``, the mesh
path notes one request per call, and the answers are ``torch.equal`` with
the plane off."""

import math

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu import obs as jobs
from large_scale_recommendation_tpu.obs import registry as jreg
from large_scale_recommendation_tpu.obs import requests as jrq
from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.data.blocking import flat_index
from large_scale_recommendation_tpu_torch.models.mf import MFModel
from large_scale_recommendation_tpu_torch.obs import health as ph
from large_scale_recommendation_tpu_torch.obs import requests as prq
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry
from large_scale_recommendation_tpu_torch.serving import (
    AdmissionConfig,
    AdmissionController,
    AdmissionRejectedError,
    RetrievalConfig,
    ServingEngine,
)

NU, NI, RANK = 2000, 500, 16


# -- shared helpers (imported by the other plane test files) ----------------


def cpu_model(num_users=NU, num_items=NI, rank=RANK, seed=0) -> MFModel:
    """A port ``MFModel`` on the CPU from seeded numpy tables (ids = rows)."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(num_users, rank)).astype(np.float32)
    V = rng.normal(size=(num_items, rank)).astype(np.float32)
    return MFModel(U=torch.from_numpy(U), V=torch.from_numpy(V),
                   users=flat_index(np.arange(num_users, dtype=np.int64)),
                   items=flat_index(np.arange(num_items, dtype=np.int64)))


def request_stream(n=40, seed=1, max_users=32, num_users=NU):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, num_users, int(rng.integers(1, max_users + 1)))
            for _ in range(n)]


@pytest.fixture
def planes():
    """Both packages' module-default planes restored after the test (the
    port's are reset by ``obs.disable``)."""
    prev = (obs.get_registry(), obs.get_tracer(), obs.get_events(),
            obs.get_store())
    jprev = (jobs.get_registry(), jobs.get_tracer(), jobs.get_events(),
             jobs.get_store())
    yield
    obs.disable()
    obs.set_registry(prev[0])
    obs.set_tracer(prev[1])
    obs.set_events(prev[2])
    obs.set_store(prev[3])
    jobs.disable()
    jobs.set_registry(jprev[0])
    jobs.set_tracer(jprev[1])
    jobs.set_events(jprev[2])
    jobs.set_store(jprev[3])


def drop_time(doc):
    """``doc`` without its wall-clock ``time`` / ``first_t`` / ``last_t``
    keys, recursively (the only fields two packages cannot share)."""
    if isinstance(doc, dict):
        return {k: drop_time(v) for k, v in doc.items()
                if k not in ("time", "first_t", "last_t", "span_id")}
    if isinstance(doc, list):
        return [drop_time(v) for v in doc]
    return doc


# -- FlushLedger -----------------------------------------------------------


def _marks(seed, n_chunks):
    """A flush's mark sequence with explicit clock values: per chunk
    batch_form, gather, score_stage1[, score_stage2], topk_merge."""
    rng = np.random.default_rng(seed)
    t = float(rng.uniform(100.0, 200.0))
    t0 = t
    marks = []
    for _ in range(n_chunks):
        for stage in ("batch_form", "gather", "score_stage1",
                      "score_stage2", "topk_merge"):
            if stage == "score_stage2" and rng.random() < 0.3:
                continue
            t += float(rng.exponential(1e-3))
            marks.append((stage, t))
    end = t + float(rng.exponential(5e-4))
    return t0, marks, end


@pytest.mark.parametrize("seed", range(6))
def test_flush_ledger_equal_jax_and_fsums_to_total(seed):
    t0, marks, end = _marks(seed, n_chunks=1 + seed % 4)
    led = [prq.FlushLedger(t0), jrq.FlushLedger(t0)]
    for stage, t in marks:
        assert led[0].mark(stage, t) == led[1].mark(stage, t) == t
    totals = [x.finish(end) for x in led]
    assert totals[0] == totals[1] == end - t0
    assert led[0].stages == led[1].stages
    assert math.fsum(led[0].stages.values()) == end - t0


# -- RequestTelemetry ------------------------------------------------------


def _drive(mod, registry, seed):
    """Feed a seeded sequence of flushes and sheds into ``mod``'s plane."""
    tel = mod.RequestTelemetry(0.004, objective=0.9, window=64,
                               max_exemplars=8, slow_keep=4,
                               registry=registry)
    rng = np.random.default_rng(seed)
    version = 7
    for f in range(30):
        if rng.random() < 0.1:
            tel.note_shed(version=version, level="shed",
                          burn=float(rng.uniform(4, 8)),
                          queue_depth=int(rng.integers(0, 5)))
            continue
        t0, marks, end = _marks(seed * 100 + f, int(rng.integers(1, 4)))
        led = tel.ledger(t0)
        for stage, t in marks:
            led.mark(stage, t)
        n_req = int(rng.integers(1, 6))
        stamps = sorted(t0 - rng.exponential(2e-3, n_req))
        rows = rng.integers(1, 33, n_req).tolist()
        if f == 20:
            version = 8  # a swap mid-stream
        tel.note_flush(led, end, stamps, version=version,
                       degraded=bool(rng.random() < 0.15), rows=rows,
                       admission_level=str(rng.choice(["normal", "widen"])))
    return tel


@pytest.mark.parametrize("seed", range(4))
def test_telemetry_snapshot_equal_jax(seed):
    preg, jreg_ = MetricsRegistry(), jreg.MetricsRegistry()
    p = _drive(prq, preg, seed)
    j = _drive(jrq, jreg_, seed)
    assert drop_time(p.snapshot()) == drop_time(j.snapshot())
    assert drop_time(p.snapshot(limit=3)) == drop_time(j.snapshot(limit=3))
    assert p.stage_quantiles() == j.stage_quantiles()
    assert preg.to_prometheus() == jreg_.to_prometheus()
    for bar in (0.2, 0.5, 0.9):
        pr = prq.RequestStageCheck(p, frac_bar=bar)()
        jr = jrq.RequestStageCheck(j, frac_bar=bar)()
        assert (pr.status, pr.detail) == (jr.status, jr.detail)


def test_every_request_reconciles_with_its_wall():
    tel = _drive(prq, MetricsRegistry(), seed=3)
    snap = tel.snapshot()
    assert snap["shed"] > 0 and snap["kept_evicted"] > 0
    for ex in snap["exemplars"]:
        if ex["kind"] == "shed":
            assert ex["stages"] == {}
            continue
        assert math.fsum(ex["stages"].values()) == ex["wall_s"]
    total = math.fsum(snap["stage_totals_s"].values())
    assert abs(total - sum(w for w, _, _ in tel._win)) <= 1e-12 * total


def test_plane_off_docs_and_scope_equal_jax(planes):
    obs.set_requests(None)
    jobs.set_requests(None)
    assert prq.slowz() == jrq.slowz()
    assert prq.request_scope() is prq._NULL_CONTEXT
    tel = obs.enable_requests(1.0)
    with prq.request_scope(version=3) as s:
        s.mark("gather")
    assert tel.count == 1
    ex = tel.exemplars()[0]
    assert ex["catalog_version"] == 3
    assert math.fsum(ex["stages"].values()) == ex["wall_s"]


def test_validation_as_jax():
    for kw in ({"objective": 1.0}, {"window": 0}, {"max_exemplars": 0},
               {"slow_keep": 0}):
        for mod in (prq, jrq):
            with pytest.raises(ValueError):
                mod.RequestTelemetry(0.1, **kw)
    for mod in (prq, jrq):
        with pytest.raises(ValueError):
            mod.RequestStageCheck(mod.RequestTelemetry(0.1), frac_bar=0.0)


# -- the plane on the engine -----------------------------------------------


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, Exception):
            assert isinstance(y, Exception)
            continue
        for u, v in zip(x, y):
            assert torch.equal(torch.as_tensor(u), torch.as_tensor(v))


@pytest.mark.parametrize("retrieval", [None, RetrievalConfig()])
def test_engine_stages_reconcile_and_answers_unchanged(planes, retrieval):
    reqs = request_stream(60)
    off = ServingEngine(cpu_model(), k=10, max_batch=128,
                        retrieval=retrieval)
    want = off.serve(reqs)
    obs.enable()
    tel = obs.enable_requests(1e-9, objective=0.9, window=4096,
                              max_exemplars=4096)
    slo = ph.SLOTracker(1e-9, objective=0.9, window=4096)
    flushes = []
    real_note = tel.note_flush

    def note(ledger, end, stamps, **kw):
        real_note(ledger, end, stamps, **kw)
        flushes.append((dict(ledger.stages), end - ledger.t0))

    tel.note_flush = note
    on = ServingEngine(cpu_model(), k=10, max_batch=128, slo=slo,
                       retrieval=retrieval)
    got = on.serve(reqs)
    _assert_same(got, want)
    assert flushes and len(flushes) == on.stats["flushes"]
    for stages, wall in flushes:
        assert math.fsum(stages.values()) == wall
        assert stages["topk_merge"] >= 0.0
        if retrieval is None:
            assert "score_stage2" not in stages
        else:
            assert "score_stage2" in stages
    snap = tel.snapshot()
    # every request violates the 1 ns target: all are kept
    assert snap["count"] == snap["violations"] == len(reqs)
    assert snap["kept"]["violating"] == len(reqs)
    for ex in snap["exemplars"]:
        assert ex["catalog_version"] == on.version
        assert math.fsum(ex["stages"].values()) == ex["wall_s"]
        assert ex["bucket"] >= ex["rows"]


def test_engine_shed_requests_are_always_kept(planes):
    obs.enable()
    tel = obs.enable_requests(10.0, max_exemplars=1024, slow_keep=2)
    slo = ph.SLOTracker(1e-9, objective=0.9, window=16)
    adm = AdmissionController(slo, AdmissionConfig(min_samples=2))
    engine = ServingEngine(cpu_model(), k=10, max_batch=8, admission=adm)
    out = engine.serve(request_stream(80, max_users=4))
    shed = [r for r in out if isinstance(r, AdmissionRejectedError)]
    assert shed
    snap = tel.snapshot()
    assert snap["shed"] == snap["kept"]["shed"] == len(shed)
    kinds = [e["kind"] for e in snap["exemplars"]]
    assert kinds.count("shed") == len(shed)
    assert all(e["admission_level"] == "shed"
               for e in snap["exemplars"] if e["kind"] == "shed")


def test_mesh_path_notes_one_request_per_call(planes):
    from large_scale_recommendation_tpu_torch.parallel import serving as tps
    from large_scale_recommendation_tpu_torch.parallel.partitioner import (
        Partitioner,
    )

    m = cpu_model(200, 64)
    part = Partitioner(device="cpu")
    cat = tps.shard_catalog(m.V, part)
    want = tps.mesh_top_k_recommend(m.U, m.V, np.arange(50), k=5,
                                    catalog=cat)
    obs.enable()
    tel = obs.enable_requests(10.0)
    budget = obs.enable_budget(10.0)
    got = tps.mesh_top_k_recommend(m.U, m.V, np.arange(50), k=5,
                                   catalog=cat, chunk=16)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    snap = tel.snapshot()
    assert snap["count"] == 1
    ex = snap["exemplars"][0]
    assert ex["catalog_version"] == cat.version and ex["rows"] == 50
    assert math.fsum(ex["stages"].values()) == ex["wall_s"]
    assert budget.cohort(cat.version)["served"] == 1


def test_snapshot_is_host_json(planes):
    """The plane keeps host floats only: a snapshot of an engine's plane
    serializes as JSON with no tensor anywhere in it."""
    import json

    obs.enable()
    tel = obs.enable_requests(1e-9)
    ServingEngine(cpu_model(), k=10).serve(request_stream(5))

    def walk(x):
        assert not isinstance(x, torch.Tensor)
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    snap = tel.snapshot()
    walk(snap)
    assert json.loads(json.dumps(snap))["count"] == 5


def test_engine_and_admission_publish_the_jax_instruments(planes):
    """The same requests through the JAX engine (one-device mesh) and the
    port's, both with obs on, an admission ladder and a delta swap: the
    same instrument names and labels, equal counts (requests, rows,
    micro-batches per bucket, swaps, ladder transitions), and the same
    journal event kinds in order."""
    from large_scale_recommendation_tpu.parallel.mesh import make_block_mesh
    from large_scale_recommendation_tpu.serving import (
        AdmissionConfig as JAdmissionConfig,
        AdmissionController as JAdmissionController,
    )
    from large_scale_recommendation_tpu.obs import health as jh
    from large_scale_recommendation_tpu.serving.engine import (
        ServingEngine as JEngine,
    )
    from test_torch_serving_engine import models

    jm, pm = models(num_users=120, num_items=256, rank=8, padded=False)
    reqs = [jm.users.ids[i:i + n] for i, n in
            zip(range(0, 110, 11), (3, 9, 1, 11, 7, 2, 5, 8, 4, 6))]
    out = []
    for mod, eng_cls, adm, slo_cls in (
            (jobs, lambda m, **kw: JEngine(m, mesh=make_block_mesh(1), **kw),
             (JAdmissionController, JAdmissionConfig), jh.SLOTracker),
            (obs, ServingEngine, (AdmissionController, AdmissionConfig),
             ph.SLOTracker)):
        reg, _ = mod.enable()
        journal = mod.EventJournal()
        mod.set_events(journal)
        slo = slo_cls(1e-9, objective=0.9, window=8)
        ctl = adm[0](slo, adm[1](min_samples=2, shed_burn=1e9))
        engine = eng_cls(jm if mod is jobs else pm, k=5, max_batch=16,
                         admission=ctl)
        engine.serve(reqs)
        rows = np.arange(0, 256, 9)
        engine.apply_delta(item_rows=rows, V_rows=np.ones(
            (len(rows), 8), np.float32))
        engine.serve(reqs)
        snap = reg.snapshot()["metrics"]
        keys = sorted((m["name"], tuple(sorted(m["labels"].items())))
                      for m in snap
                      if m["name"].startswith(("serving_", "meter_")))
        counts = {(m["name"], tuple(sorted(m["labels"].items()))):
                  m.get("value", m.get("count"))
                  for m in snap
                  if m["name"] in ("serving_requests_total",
                                   "serving_rows_total",
                                   "serving_microbatches_total",
                                   "serving_catalog_delta_total",
                                   "serving_admission_transitions_total",
                                   "serving_admission_level",
                                   "serving_flush_s",
                                   "meter_elements_total")}
        kinds = [e["kind"] for e in journal.events()]
        out.append((keys, counts, kinds))
        mod.disable()
    (jk, jc, je), (pk, pc, pe) = out
    assert [k for k in pk if "version" not in dict(k[1])] == \
        [k for k in jk if "version" not in dict(k[1])]
    assert pc == jc
    assert pe == je
    assert "serving.admission_transition" in pe
    assert pe.count("serving.catalog_delta") == 1
