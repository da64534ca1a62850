"""The port's tracer and event journal against the JAX package's: the same
span program gives the same names, categories, nesting, compile/execute
split and key-wall counts; the same documents pass or fail
``validate_chrome_trace``; the journal records the same events. Exact
equality (host code on both sides); walls are not compared."""

import json
import threading

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu.obs import events as jev
from large_scale_recommendation_tpu.obs import trace as jtr
from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.obs import events as pev
from large_scale_recommendation_tpu_torch.obs import trace as ptr
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry
from large_scale_recommendation_tpu_torch.ops import _build


@pytest.fixture
def port_defaults():
    prev = (obs.get_registry(), obs.get_tracer(), obs.get_events())
    yield
    obs.disable()
    obs.set_registry(prev[0])
    obs.set_tracer(prev[1])
    obs.set_events(prev[2])


def _program(tracer, seed):
    """A seeded tree of spans (some keyed), instants and completes."""
    rng = np.random.default_rng(seed)

    def node(depth):
        key = None
        if rng.random() < 0.5:
            key = ("seg", int(rng.integers(0, 3)),
                   (4, int(rng.integers(1, 3))))
        with tracer.span(f"s{depth}_{rng.integers(0, 3)}", key=key,
                         iterations=int(rng.integers(1, 4))) as sp:
            sp.out = {"a": [torch.ones(2)], "b": (np.ones(1), 3)}
            if rng.random() < 0.3:
                tracer.instant("mark", n=int(rng.integers(0, 9)))
            for _ in range(int(rng.integers(0, 3)) if depth < 3 else 0):
                node(depth + 1)

    for _ in range(6):
        node(0)


def _shape(tracer):
    """Each event's name, category, phase and its parent's name (by id)."""
    evs = tracer.events()
    by_id = {e["args"].get("span_id"): e for e in evs if e["ph"] == "X"}
    out = []
    for e in sorted(evs, key=lambda e: ptr.span_seq(e["args"]["span_id"])
                    if e["args"].get("span_id") else -1):
        parent = by_id.get(e["args"].get("parent_span_id"))
        out.append((e["name"], e["cat"], e["ph"],
                    None if parent is None else parent["name"],
                    e["args"].get("iterations"), e["args"].get("n")))
    return out


def _walls_counts(tracer):
    return {jtr_key: {k: v for k, v in w.items()
                      if k in ("compile_count", "execute_count",
                               "iterations")}
            for jtr_key, w in tracer.key_walls().items()}


@pytest.mark.parametrize("seed", range(4))
def test_span_program_equal_jax(seed):
    j, p = jtr.Tracer(), ptr.Tracer()
    _program(j, seed)
    _program(p, seed)
    # instants carry no span_id order of their own: compare X events by
    # creation order, instants by their enclosing span
    assert sorted(_shape(p), key=repr) == sorted(_shape(j), key=repr)
    assert [(e["name"], e["cat"]) for e in p.events()] == \
        [(e["name"], e["cat"]) for e in j.events()]
    assert _walls_counts(p) == _walls_counts(j)
    ptr.validate_chrome_trace(p.chrome_trace())
    jtr.validate_chrome_trace(p.chrome_trace())


def test_context_activation_and_trees_equal_jax():
    out = []
    for mod in (jtr, ptr):
        t = mod.Tracer()
        with t.span("batch") as sp:
            ctx = t.capture_context()
        seen = []

        def worker():
            with t.activate(mod.TraceContext("trace-1", ctx.parent_span_id)):
                with t.span("retrain"):
                    seen.append(t.current_span_id())

        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        t.complete_tree("req", 0.0, 0.01, [("a", 0.004), ("b", 0.0),
                                           ("c", 0.01)], tid=7)
        evs = {e["name"]: e for e in t.events()}
        assert evs["retrain"]["args"]["parent_span_id"] == sp.id
        assert evs["retrain"]["args"]["trace_id"] == "trace-1"
        mod.validate_chrome_trace(t.chrome_trace())
        out.append(sorted((e["name"], e["cat"], e["tid"] == 7)
                          for e in t.events()))
    assert out[0] == out[1]


BAD_DOCS = [
    {},
    {"traceEvents": {}},
    {"traceEvents": [{"name": 1, "ph": "X"}]},
    {"traceEvents": [{"name": "a", "ph": "B", "pid": 1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0,
                      "dur": -1, "args": {}}]},
    {"traceEvents": [
        {"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 10,
         "args": {}},
        {"name": "b", "ph": "X", "pid": 1, "tid": 1, "ts": 5, "dur": 10,
         "args": {}}]},
    {"traceEvents": [{"name": "p", "ph": "M", "pid": 2}]},
    {"traceEvents": [
        {"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 10,
         "args": {}},
        {"name": "b", "ph": "X", "pid": 2, "tid": 1, "ts": 5, "dur": 10,
         "args": {}}]},
]


@pytest.mark.parametrize("doc", BAD_DOCS, ids=range(len(BAD_DOCS)))
def test_validate_chrome_trace_agrees_with_jax(doc):
    def verdict(fn):
        try:
            return len(fn(doc))
        except ValueError:
            return "invalid"

    assert verdict(ptr.validate_chrome_trace) == \
        verdict(jtr.validate_chrome_trace)


def test_block_walks_nested_tensors_and_passes_cpu_through():
    ptr._block(None)
    ptr._block({"a": [torch.ones(1), (torch.zeros(2), "x")], "b": 3})
    assert list(ptr._tensors({"a": [torch.ones(1), (torch.zeros(2),)],
                              "c": "s"})) != []


def test_null_tracer_is_shared_and_inert():
    null = ptr.NULL_TRACER
    with null.span("x", key=("k",)) as sp:
        sp.out = torch.ones(3)
        assert sp is ptr.NULL_SPAN and sp.out is None
    assert null.events() == [] and null.key_walls() == {}
    assert null.capture_context() is None
    assert null.install_build_hook() is False


def test_build_hook_publishes_library_loads(port_defaults):
    """A library load after the hook is armed lands in
    ``kernel_build_s{library=}`` and the trace; loads before it are
    published when it is armed."""
    reg, tracer = obs.enable()
    _build.load_library("fastblock")
    before = len(_build.loads["fastblock"])
    assert tracer.install_build_hook(reg)
    h = reg.histogram("kernel_build_s", library="fastblock")
    assert h.count == before
    lib = _build._loaded.pop("fastblock")
    try:
        _build.load_library("fastblock")
    finally:
        _build._loaded["fastblock"] = lib
    assert h.count == before + 1
    marks = [e for e in tracer.events() if e["name"] == "kernel_build"]
    assert marks and marks[-1]["args"]["library"] == "fastblock"
    obs.disable()
    assert _build._build_hook is None


def test_event_journal_equal_jax(tmp_path):
    out = []
    for ev_mod, tr_mod, reg in ((jev, jtr, None),
                                (pev, ptr, MetricsRegistry())):
        t = tr_mod.Tracer()
        j = ev_mod.EventJournal(capacity=4, tracer=t, registry=reg,
                                jsonl_path=str(tmp_path / f"{id(t)}.jsonl"))
        with t.span("outer"):
            j.emit("train.segment", model="dsgd", loss=float("nan"),
                   nested={"x": [1.0, float("inf")]})
        for n in range(5):
            j.emit("tick", severity="debug", n=n)
        with pytest.raises(ValueError):
            j.emit("bad", severity="warn")
        out.append(([(e["kind"], e["severity"], e["detail"], e["seq"])
                     for e in j.events()], j.dropped, j.total,
                    [(e["kind"], e["detail"]) for e in j.events(
                        kind="tick", min_severity="debug", limit=2)]))
        lines = [json.loads(x) for x in open(j.jsonl_path)]
        assert lines[0]["detail"]["loss"] == "nan"
    assert out[0] == out[1]


def test_json_safe_reads_a_0d_tensor():
    assert pev._json_safe({"loss": torch.tensor(float("nan"))}) == \
        {"loss": "nan"}
    assert pev._json_safe([torch.tensor(2.5), torch.ones(2).sum()]) == \
        [2.5, 2.0]
    assert pev._json_safe((1.0, float("-inf"))) == \
        jev._json_safe((1.0, float("-inf")))
