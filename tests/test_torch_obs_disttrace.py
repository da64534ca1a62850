"""The port's causal plane (``obs.disttrace``) against the JAX package's:
``record_trace_id`` equal; ``assemble_pod_trace`` merges one Chrome export
from each package into one timeline both validators accept;
``resolve_record_trace`` finds the same chain from either package's
function; ``CriticalPathAnalyzer`` fed the same marks with explicit clock
values gives equal samples, stage summaries and Prometheus text (equality:
host arithmetic). Then the stream and serve path end to end on the CPU in
BOTH packages, with all six planes on (lineage, disttrace, budget,
requests, contention, a data-quality inspector): a ``StreamingDriver`` with
``AdaptiveMF`` and a serving engine, compared for the lineage records'
sources and WAL watermarks, the critical-path stage names and their
reconciliation with the freshness histogram, ``/slowz`` keeping every
violating request, the ``/budgetz`` cohorts per version, and a record's
complete assembled trace; the port's served rows and scores are
``torch.equal`` with the planes on and off."""

import importlib
import math

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu.obs import disttrace as jdt
from large_scale_recommendation_tpu.obs import registry as jreg
from large_scale_recommendation_tpu.obs import trace as jtr
from large_scale_recommendation_tpu_torch.obs import disttrace as pdt
from large_scale_recommendation_tpu_torch.obs import trace as ptr
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry
from test_torch_obs_requests import drop_time

PKGS = {"port": "large_scale_recommendation_tpu_torch",
        "jax": "large_scale_recommendation_tpu"}


@pytest.mark.parametrize("p, off", [(0, 0), (3, 12345), (1, 2**40)])
def test_record_trace_id_equal_jax(p, off):
    assert pdt.record_trace_id(p, off) == jdt.record_trace_id(p, off)


def _marks(an, seed):
    """Seeded appends / dequeues / applied / swaps / serves on two
    partitions, every clock explicit; returns what each call returned."""
    rng = np.random.default_rng(seed)
    t = 1000.0
    end = {0: 0, 1: 0}
    out = []
    for v in range(1, 9):
        for p in (0, 1):
            n = int(rng.integers(100, 400))
            t += float(rng.exponential(0.01))
            an.note_append(end[p] + n, partition=p, t=t)
            t += float(rng.exponential(0.02))
            an.note_dequeue(end[p] + n, partition=p, t=t)
            t += float(rng.exponential(0.05))
            an.note_applied(end[p] + n, partition=p, t=t)
            end[p] += n
        t += float(rng.exponential(0.1))
        for p in (0, 1):
            if rng.random() < 0.8:
                out.append(an.note_swap(v, partition=p,
                                        watermark=end[p] - int(
                                            rng.integers(0, 2)) * 50,
                                        t=t))
        out.append(an.note_swap(v, partition=0, watermark=None))
        if rng.random() < 0.7:
            t += float(rng.exponential(0.01))
            an.note_serve(v, t=t)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_critical_path_equal_jax(seed):
    preg, jreg_ = MetricsRegistry(), jreg.MetricsRegistry()
    p = pdt.CriticalPathAnalyzer(capacity=6, marks=12, registry=preg)
    j = jdt.CriticalPathAnalyzer(capacity=6, marks=12, registry=jreg_)
    assert _marks(p, seed) == _marks(j, seed)
    assert p.samples() == j.samples() and len(p) == len(j)
    assert p.stage_summary() == j.stage_summary()
    assert drop_time(p.snapshot(limit=3)) == drop_time(j.snapshot(limit=3))
    assert preg.to_prometheus() == jreg_.to_prometheus()
    for s in p.samples():
        parts = [s[f"{k}_s"] for k in ("queue_wait", "train_apply",
                                       "swap_lag") if s[f"{k}_s"] is not None]
        assert abs(math.fsum(parts) - s["total_s"]) <= 1e-12 * s["total_s"]


def test_validation_as_jax():
    for mod in (pdt, jdt):
        with pytest.raises(ValueError):
            mod.CriticalPathAnalyzer(capacity=0)


def _trace_doc(mod_trace, pid_label):
    """A small Chrome export from one package's tracer: an append span
    for records [0, 100), an ingest span over them with a partial_fit span
    inside, a swap instant and a flush span serving version 9."""
    tr = mod_trace.Tracer()
    with tr.span("wal/append", partition=0) as sp:
        sp.args.update(start_offset=0, end_offset=100,
                       trace_id=f"wal-p0-o0-{pid_label}")
    with tr.span("stream/ingest_batch", partition=0, start_offset=0,
                 end_offset=100):
        with tr.span("online/partial_fit", records=100):
            pass
    tr.instant("lineage/swap_watermark", version=9, partition=0,
               watermark=100, source="stream_refresh")
    with tr.span("serving/flush", catalog_version=9, rows=4):
        pass
    return tr.chrome_trace()


def test_pod_trace_merges_both_packages_exports():
    sources = [("port", _trace_doc(ptr, "p")), ("jax", _trace_doc(jtr, "j"))]
    merged = pdt.assemble_pod_trace(sources)
    assert merged == jdt.assemble_pod_trace(sources)
    ptr.validate_chrome_trace(merged)
    jtr.validate_chrome_trace(merged)
    assert merged["podSources"] == ["port", "jax"]
    assert {e["pid"] for e in merged["traceEvents"]} == {0, 1}
    for off in (0, 50, 99):
        pc = pdt.resolve_record_trace(merged, 0, off)
        jc = jdt.resolve_record_trace(merged, 0, off)
        assert pc == jc
        assert pc["complete"], pc
        assert pc["processes"] == [0]  # the first (port) process's chain
    # each export alone resolves the same chain, from either function
    for doc in (sources[0][1], sources[1][1]):
        one = pdt.assemble_pod_trace([("only", doc)])
        assert (pdt.resolve_record_trace(one, 0, 7)
                == jdt.resolve_record_trace(one, 0, 7))
        assert pdt.resolve_record_trace(one, 0, 7)["complete"]
    assert not pdt.resolve_record_trace(merged, 0, 100)["complete"]


# -- the stream and serve path end to end, in both packages ----------------


def _fill(log, n_batches=4, n=1000, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        log.append_arrays(0, rng.integers(0, 300, n), rng.integers(0, 120, n),
                          rng.uniform(1, 5, n).astype(np.float32))


def _reqs(n=12, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 300, int(rng.integers(1, 9))) for _ in range(n)]


def run_stream(which, tmp_path, planes_on=True):
    """One driver run with every plane on (``planes_on``): ``which`` is
    ``"port"`` or ``"jax"``. Returns the planes' documents and the served
    answers."""
    root = PKGS[which]
    obs = importlib.import_module(root + ".obs")
    dq = importlib.import_module(root + ".obs.dataquality")
    adaptive = importlib.import_module(root + ".models.adaptive")
    streams = importlib.import_module(root + ".streams")
    dev = {"device": "cpu"} if which == "port" else {}
    if planes_on:
        reg, tracer = obs.enable()
        lineage = obs.enable_lineage()
        analyzer = obs.enable_disttrace()
        budget = obs.enable_budget(1e-9, objective=0.9, min_samples=4)
        tel = obs.enable_requests(1e-9, objective=0.9, max_exemplars=512)
        tracker = obs.enable_contention(start=False)
    log = streams.EventLog(str(tmp_path / which / "log"), fsync=False)
    _fill(log)
    inspector = (dq.DataQualityInspector(rating_range=(1.0, 5.0),
                                         max_user_id=299, max_item_id=119)
                 if planes_on else None)
    model = adaptive.AdaptiveMF(adaptive.AdaptiveMFConfig(
        num_factors=8, minibatch_size=256, offline_every=2,
        offline_iterations=2), **dev)
    drv = streams.StreamingDriver(
        model, log, str(tmp_path / which / "ck"), inspector=inspector,
        config=streams.StreamingDriverConfig(batch_records=1000))
    engine = drv.serving_engine(k=5, max_batch=16)
    drv.run()
    drv.refresh_serving()
    served = engine.serve(_reqs())
    # one more batch, below the retrain cadence: its records first become
    # servable through the stream refresh, whose build the second stream
    # serves (a complete record trace)
    _fill(log, n_batches=1, seed=1)
    drv.run()
    drv.refresh_serving()
    served += engine.serve(_reqs(seed=6))
    out = {"served": served, "version": engine.version,
           "versions": list(drv.catalog_versions)}
    if planes_on:
        out.update(
            lineage=lineage.snapshot(), critical=analyzer.snapshot(),
            slowz=tel.snapshot(), budgetz=budget.snapshot(),
            hist=[m for m in reg.snapshot()["metrics"]
                  if m["name"] == "lineage_ingest_to_servable_s"],
            trace=tracer.chrome_trace(), locks=tracker.lock_names(),
            dq=inspector.snapshot(), consumed=drv.consumed_offset)
        obs.disable()
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e")
    from large_scale_recommendation_tpu import obs as jobs
    from large_scale_recommendation_tpu_torch import obs as pobs

    prev = [(m.get_registry(), m.get_tracer(), m.get_events(), m.get_store())
            for m in (pobs, jobs)]
    try:
        yield {w: run_stream(w, tmp) for w in ("jax", "port")}
    finally:
        for m, p in zip((pobs, jobs), prev):
            m.disable()
            m.set_registry(p[0])
            m.set_tracer(p[1])
            m.set_events(p[2])
            m.set_store(p[3])


def _records(doc):
    return [(r["source"], r["watermarks"], r["retrain_id"],
             r["train_step"]) for r in doc["records"]]


def test_e2e_lineage_records_and_watermarks_as_jax(both):
    p, j = both["port"], both["jax"]
    assert _records(p["lineage"]) == _records(j["lineage"])
    assert len(p["versions"]) == len(j["versions"])
    assert p["lineage"]["swaps"] == j["lineage"]["swaps"]
    assert p["consumed"] == j["consumed"] == 5000
    assert p["lineage"]["freshness"]["servable_watermark"] == 5000
    assert p["lineage"]["records"][-1]["catalog_version"] == p["version"]


def test_e2e_critical_path_reconciles_as_jax(both):
    for w in ("port", "jax"):
        crit, hist = both[w]["critical"], both[w]["hist"]
        samples = crit["samples"]
        assert samples and hist and hist[0]["count"] == len(samples)
        lags = [s["swap_lag_s"] for s in samples]
        assert abs(float(np.mean(lags)) - hist[0]["mean"]) <= 1e-12 + \
            1e-9 * hist[0]["mean"]
        for s in samples:
            parts = [v for v in (s["queue_wait_s"], s["train_apply_s"],
                                 s["swap_lag_s"]) if v is not None]
            assert abs(math.fsum(parts) - s["total_s"]) <= 1e-9
    p, j = both["port"]["critical"], both["jax"]["critical"]
    assert set(p["stages"]) == set(j["stages"]) == {
        "queue_wait", "train_apply", "swap_lag", "flush_wait", "total"}
    assert len(p["samples"]) == len(j["samples"])
    assert ([s["end_offset"] for s in p["samples"]]
            == [s["end_offset"] for s in j["samples"]])
    assert p["marks"] == j["marks"]


def test_e2e_slowz_keeps_every_violating_request(both):
    for w in ("port", "jax"):
        s = both[w]["slowz"]
        assert s["count"] == s["violations"] == 2 * len(_reqs())
        assert s["kept"]["violating"] == 2 * len(_reqs())
    assert (set(both["port"]["slowz"]["stage_totals_s"])
            == set(both["jax"]["slowz"]["stage_totals_s"]))


def test_e2e_budget_cohorts_per_version_as_jax(both):
    p, j = both["port"]["budgetz"], both["jax"]["budgetz"]
    assert len(p["cohorts"]) == len(j["cohorts"]) == 2
    assert ([c["served"] for c in p["cohorts"].values()]
            == [c["served"] for c in j["cohorts"].values()] == [12, 12])
    assert list(p["cohorts"])[-1] == str(both["port"]["version"])


def test_e2e_record_resolves_to_a_complete_trace(both):
    for w in ("port", "jax"):
        doc = pdt.assemble_pod_trace([(w, both[w]["trace"])])
        ptr.validate_chrome_trace(doc)
        chain = pdt.resolve_record_trace(doc, 0, both[w]["consumed"] - 1)
        assert chain["complete"], (w, chain)
        assert chain == jdt.resolve_record_trace(doc, 0,
                                                 both[w]["consumed"] - 1)
        assert set(chain["stages"]) == set(pdt.STAGES)


def test_e2e_locks_and_data_quality_as_jax(both):
    p, j = both["port"], both["jax"]
    assert set(p["locks"]) == set(j["locks"])
    assert {"online.apply_lock", "adaptive.apply_lock", "serving.engine",
            "streams.wal_partition",
            "streams.ingest_queue"} <= set(p["locks"])
    assert drop_time(p["dq"]) == drop_time(j["dq"])
    # random pairs repeat within a batch: the duplicate class only
    assert p["dq"]["batches"] == 5
    assert p["dq"]["offending"] == ["duplicate_key"]


def test_e2e_answers_equal_with_planes_off(both, tmp_path):
    from large_scale_recommendation_tpu_torch import obs as pobs

    off = run_stream("port", tmp_path, planes_on=False)
    pobs.disable()
    assert off["versions"] and len(off["served"]) == len(both["port"]["served"])
    for a, b in zip(off["served"], both["port"]["served"]):
        for x, y in zip(a, b):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
