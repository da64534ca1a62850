"""The port's live spans: free when nothing listens, a host profiler range
that is no user annotation and a row of ``span_totals()`` when the
profiler records or the tracer is on, and the program's layer spans where
the benchmark reads them."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.obs import trace as ptr


@pytest.fixture(autouse=True)
def clean_table():
    prev = obs.get_tracer()
    obs.set_tracer(ptr.NULL_TRACER)
    ptr.reset_span_totals()
    yield
    obs.set_tracer(prev)
    ptr.reset_span_totals()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.profiler.kineto_results.events()


def _nested():
    with ptr.span("outer", n=2) as sp:
        time.sleep(0.002)
        with ptr.span("inner", n=1):
            time.sleep(0.003)
        with ptr.span("inner", n=1):
            pass
        sp.note(m=5, label="not a counter")


# -- off ----------------------------------------------------------------------


class NoClock:
    def perf_counter(self):
        raise AssertionError("a span read the clock with nothing listening")


def _refuse(*args, **kwargs):
    raise AssertionError("a span touched the profiler, table or card")


@pytest.mark.parametrize("device", [False, True])
def test_off_span_is_the_shared_noop_and_touches_nothing(monkeypatch, device):
    monkeypatch.setattr(ptr, "time", NoClock())
    monkeypatch.setattr(ptr._TABLE, "add", _refuse)
    monkeypatch.setattr(ptr, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    assert obs.get_tracer() is ptr.NULL_TRACER
    assert ptr.span("online/ensure", device=device, ids=3) is ptr.NULL_SPAN
    assert ptr.NULL_TRACER.span("serving/lookup", device=device) \
        is ptr.NULL_SPAN
    with ptr.span("dsgd/blocking", device=device, ratings=9) as sp:
        sp.note(new=1)
        sp.out = torch.ones(1)
    assert sp is ptr.NULL_SPAN and sp.args == {}
    monkeypatch.undo()
    assert ptr.span_totals() == {}


def test_off_program_paths_leave_the_table_empty():
    from large_scale_recommendation_tpu_torch.core.types import Ratings
    from large_scale_recommendation_tpu_torch.models.online import (
        OnlineMF, OnlineMFConfig)

    m = OnlineMF(OnlineMFConfig(num_factors=4, minibatch_size=64,
                                init_capacity=8), device="cpu")
    rng = np.random.default_rng(0)
    n = 300
    m.partial_fit(Ratings(rng.integers(0, 50, n).astype(np.int32),
                          rng.integers(0, 30, n).astype(np.int32),
                          rng.random(n).astype(np.float32),
                          np.ones(n, np.float32)), emit_updates=False)
    assert ptr.span_totals() == {}


# -- under the profiler -------------------------------------------------------


def test_profiled_spans_are_host_ops_not_user_annotations():
    events = _profiled(_nested)
    mine = [e for e in events if e.name() in ("outer", "inner")]
    assert sorted(e.name() for e in mine) == ["inner", "inner", "outer"]
    for e in mine:
        assert "CPU" in str(e.device_type())
        assert e.is_user_annotation() is False
    # the harness's own annotation is one, for contrast
    events = _profiled(lambda: torch.profiler.record_function(
        "bench/x").__enter__().__exit__(None, None, None))
    assert any(e.name() == "bench/x" and e.is_user_annotation()
               for e in events)


def test_profiled_table_counts_walls_self_time_and_counters():
    _profiled(_nested)
    tot = ptr.span_totals()
    assert set(tot) == {"outer", "inner"}
    outer, inner = tot["outer"], tot["inner"]
    assert (outer["count"], inner["count"]) == (1, 2)
    assert inner["wall_ms"] >= 3.0 and outer["wall_ms"] >= 5.0
    assert outer["self_ms"] == pytest.approx(
        outer["wall_ms"] - inner["wall_ms"], abs=1e-9)
    assert inner["self_ms"] == pytest.approx(inner["wall_ms"], abs=1e-12)
    assert outer["args"] == {"n": 2, "m": 5}
    assert inner["args"] == {"n": 2}
    assert "device_ms" not in outer
    ptr.reset_span_totals()
    assert ptr.span_totals() == {}


def test_self_time_counts_children_on_the_same_thread_only():
    def work():
        with ptr.span("parent"):
            t = threading.Thread(target=lambda: _sleep_span("other", 0.004))
            t.start()
            t.join()
            _sleep_span("child", 0.001)

    _profiled(work)
    tot = ptr.span_totals()
    assert tot["parent"]["self_ms"] == pytest.approx(
        tot["parent"]["wall_ms"] - tot["child"]["wall_ms"], abs=1e-9)
    assert tot["other"]["count"] == 1


def _sleep_span(name, s):
    with ptr.span(name):
        time.sleep(s)


def test_no_span_outlives_the_profiler():
    _profiled(lambda: _sleep_span("during", 0.0))
    _sleep_span("after", 0.0)
    assert set(ptr.span_totals()) == {"during"}


class FakeEvent:
    """A CUDA event stand-in: elapsed time is the gap of record order."""

    clock = 0
    waits = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        FakeEvent.clock += 1
        self.t = FakeEvent.clock

    def query(self):
        return True

    def synchronize(self):
        FakeEvent.waits += 1

    def elapsed_time(self, other):
        return float(other.t - self.t)


def test_device_spans_record_an_event_pair_resolved_when_read(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    FakeEvent.waits = 0

    def work():
        with ptr.span("als/gather", device=True):
            with ptr.span("als/gram", device=True):
                pass
        with ptr.span("serving/lookup"):
            pass

    _profiled(work)
    assert FakeEvent.waits == 0  # nothing waits on the hot path
    tot = ptr.span_totals()
    assert FakeEvent.waits == 2  # each pair's end, when read
    # records: gather start 1, gram start 2, gram end 3, gather end 4
    assert tot["als/gram"]["device_ms"] == 1.0
    assert tot["als/gather"]["device_ms"] == 3.0
    assert "device_ms" not in tot["serving/lookup"]


def test_pending_pairs_past_the_cap_fold_or_count(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(ptr._TABLE, "max_pending", 4)

    def work():
        for _ in range(10):
            with ptr.span("dsgd/plan", device=True):
                pass

    _profiled(work)
    tot = ptr.span_totals()
    assert tot["dsgd/plan"]["count"] == 10
    assert tot["dsgd/plan"]["device_ms"] == 10.0
    assert ptr._TABLE.device_dropped == 0

    monkeypatch.setattr(FakeEvent, "query", lambda self: False)
    ptr.reset_span_totals()
    _profiled(work)
    assert ptr._TABLE.device_dropped == 6
    assert ptr.span_totals()["dsgd/plan"]["device_ms"] == 4.0


# -- with the tracer enabled --------------------------------------------------


def _tracer_program(tracer):
    for j in range(3):
        with tracer.span("fit", key=("fit", 4), iterations=2):
            with tracer.span("step", rows=j):
                pass
            tracer.instant("mark")


def test_enabled_tracer_keeps_its_buffer_and_key_walls_and_fills_the_table():
    tracer = ptr.Tracer()
    _tracer_program(tracer)
    evs = tracer.events()
    assert [(e["name"], e["cat"], e["ph"]) for e in evs] == [
        ("step", "span", "X"), ("mark", "instant", "i"),
        ("fit", "compile", "X"),
        ("step", "span", "X"), ("mark", "instant", "i"),
        ("fit", "execute", "X"),
        ("step", "span", "X"), ("mark", "instant", "i"),
        ("fit", "execute", "X")]
    ptr.validate_chrome_trace(tracer.chrome_trace())
    walls = tracer.key_walls()[("fit", 4)]
    assert (walls["compile_count"], walls["execute_count"],
            walls["iterations"]) == (1, 2, 4)
    tot = ptr.span_totals()
    assert tot["fit"]["count"] == 3 and tot["step"]["count"] == 3
    assert tot["fit"]["args"] == {"iterations": 6}
    assert tot["step"]["args"] == {"rows": 3}
    assert tot["fit"]["self_ms"] == pytest.approx(
        tot["fit"]["wall_ms"] - tot["step"]["wall_ms"], abs=1e-9)


def test_enabled_tracer_span_is_a_profiler_range():
    tracer = ptr.Tracer()
    events = _profiled(lambda: _tracer_program(tracer))
    names = [e.name() for e in events if not e.is_user_annotation()]
    assert names.count("fit") == 3 and names.count("step") == 3


def test_module_span_follows_the_installed_tracer():
    tracer = ptr.Tracer()
    obs.set_tracer(tracer)
    with ptr.span("online/stage", padded=7):
        pass
    assert [e["name"] for e in tracer.events()] == ["online/stage"]
    assert ptr.span_totals()["online/stage"]["args"] == {"padded": 7}


# -- the program's layer spans ------------------------------------------------


def _ratings(n, nu, ni, seed=0):
    from large_scale_recommendation_tpu_torch.core.types import Ratings

    rng = np.random.default_rng(seed)
    return Ratings(rng.integers(0, nu, n).astype(np.int32),
                   rng.integers(0, ni, n).astype(np.int32),
                   rng.random(n).astype(np.float32), np.ones(n, np.float32))


ENSURE_STEPS = ("online/ensure.lookup", "online/ensure.unique",
                "online/ensure.merge", "online/ensure.install")


@pytest.mark.parametrize("concurrent", [False, True])
def test_online_batch_spans(concurrent):
    from large_scale_recommendation_tpu_torch.models.online import (
        OnlineMF, OnlineMFConfig)

    m = OnlineMF(OnlineMFConfig(num_factors=4, minibatch_size=64,
                                init_capacity=8), device="cpu")
    m.enable_concurrent_applies(concurrent)
    batch = _ratings(300, 50, 30)
    _profiled(lambda: [m.partial_fit(batch, emit_updates=False)
                       for _ in range(2)])
    tot = ptr.span_totals()
    ensure = tot["online/ensure"]
    assert ensure["count"] == 4  # both tables, both batches
    assert ensure["args"]["ids"] == 4 * 300
    assert ensure["args"]["new"] == m.users.num_rows + m.items.num_rows
    assert tot["online/ensure.lookup"]["count"] == 4
    for step in ENSURE_STEPS[1:]:
        assert tot[step]["count"] == 2  # the second batch knows every id
    assert tot["online/ensure.install"]["args"]["pad"] >= ensure["args"][
        "new"]
    parts = sum(tot[s]["wall_ms"] for s in ENSURE_STEPS)
    assert ensure["self_ms"] == pytest.approx(ensure["wall_ms"] - parts,
                                              abs=1e-9)
    assert tot["online/stage"]["count"] == 2
    assert tot["online/stage"]["args"]["padded"] % 64 == 0
    assert tot["online/partial_fit"]["args"]["records"] == 600


def test_serving_flush_spans():
    from large_scale_recommendation_tpu_torch.data.blocking import (
        flat_index)
    from large_scale_recommendation_tpu_torch.models.mf import MFModel
    from large_scale_recommendation_tpu_torch.serving.engine import (
        ServingEngine)

    nu, ni = 40, 70
    g = torch.Generator().manual_seed(0)
    model = MFModel(U=torch.randn(nu, 8, generator=g),
                    V=torch.randn(ni, 8, generator=g),
                    users=flat_index(np.arange(nu)),
                    items=flat_index(np.arange(ni)))
    r = _ratings(400, nu, ni)
    engine = ServingEngine(model, k=5, train=(r.users, r.items),
                           max_batch=16)
    reqs = [np.arange(j, j + 6) for j in range(0, 30, 6)]
    want = engine.serve(reqs)
    got = []
    _profiled(lambda: got.extend(engine.serve(reqs)))
    for a, b in zip(want, got):
        assert np.array_equal(a[0], b[0])
    tot = ptr.span_totals()
    flushes = tot["serving/flush"]["count"]
    assert flushes >= 2  # 30 users through flushes of 16
    for name in ("serving/lookup", "serving/assemble"):
        assert tot[name]["count"] == flushes
    assert tot["serving/lookup"]["args"]["users"] == 30
    chunks = tot["serving/score"]["count"]
    assert chunks >= flushes
    for name in ("serving/exclusions", "serving/gather", "serving/drain"):
        assert tot[name]["count"] == chunks
    assert tot["serving/exclusions"]["args"]["pairs"] >= 8 * chunks
    inner = sum(tot[n]["wall_ms"] for n in (
        "serving/exclusions", "serving/gather", "serving/score",
        "serving/drain"))
    assert tot["serving/flush"]["self_ms"] == pytest.approx(
        tot["serving/flush"]["wall_ms"] - inner, abs=1e-9)


def test_als_fit_device_spans_and_plan_s():
    from large_scale_recommendation_tpu_torch.models.als import (
        ALS, ALSConfig)

    r = _ratings(2000, 60, 40)
    solver = ALS(ALSConfig(num_factors=4, iterations=2), device="cpu")
    _profiled(lambda: solver.fit_device(r.users, r.items, r.ratings, 60, 40))
    assert solver.plan_s > 0
    tot = ptr.span_totals()
    assert tot["als/plan"]["count"] == 1
    chunks = tot["als/solve"]["count"]
    assert chunks >= 2 * 2  # a chunk a side at least, two rounds
    assert tot["als/gather"]["count"] == tot["als/gram"]["count"] == chunks
    # every solved row once a half-step, pad rows included
    assert tot["als/solve"]["args"]["rows"] >= 2 * (60 + 40) - 2 * 2
    assert "device_ms" not in tot["als/solve"]  # no card here


def test_dsgd_fit_device_spans():
    from large_scale_recommendation_tpu_torch.models.dsgd import (
        DSGD, DSGDConfig)

    r = _ratings(3000, 80, 50)
    solver = DSGD(DSGDConfig(num_factors=4, iterations=2, minibatch_size=64,
                             learning_rate=0.01, lambda_=0.1),
                  device="cpu")
    _profiled(lambda: solver.fit_device(r.users, r.items, r.ratings, 80, 50,
                                        num_blocks=2))
    tot = ptr.span_totals()
    assert tot["dsgd/blocking"]["args"] == {"ratings": 3000}
    for name in ("dsgd/blocking", "dsgd/init", "dsgd/id_maps"):
        assert tot[name]["count"] == 1
    assert "dsgd/plan" not in tot  # the step plan is the card's route
    assert solver.plan_s is None
