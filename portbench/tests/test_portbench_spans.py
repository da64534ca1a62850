"""The readers of the program's spans: nothing, and no crash, where the
program keeps no span table (an older program) or the span never ran; a
number for every host span in a tiny traced run on the CPU."""

import io
import os
import sys
import types

import pytest

from portbench import harness
from portbench.tests.tiny import TINY

SEED = 3_000_000_019
SPAN_METRICS = {
    "netflix_r128.online_stream": ("online.ensure_ms", "online.stage_ms"),
    "ml25m_r128.serve_topk_over": ("serve.lookup_ms", "serve.exclusion_ms",
                                   "serve.assemble_ms"),
    "ml25m_r128.dsgd_fit": ("dsgd.blocking_ms", "dsgd.plan_ms"),
    "ml25m_r128.als_fit": ("als.gather_ms", "als.gram_ms", "als.solve_ms"),
}
HOST = ("netflix_r128.online_stream", "ml25m_r128.serve_topk_over")
ALL = [(cell, m) for cell, ms in SPAN_METRICS.items() for m in ms]
TRACE_MODULE = "large_scale_recommendation_tpu_torch.obs.trace"


def _reader(name):
    return harness.load_module(
        os.path.join(harness.BENCH_DIR, "metrics", name + ".py"),
        harness.safe("metric_" + name))


def _ctx():
    facts = {"traced_batches": 30, "traced_calls": 40, "traced_fits": 2,
             "sweeps": 10}
    return types.SimpleNamespace(facts=facts, profile=None)


def test_every_span_metric_is_declared_for_its_cell():
    spec = {m["name"]: m for m in harness.load_json(
        os.path.join(harness.ROOT, "BENCHMARK.json"))["per_layer"]}
    for cell, name in ALL:
        assert spec[name]["workloads"] == [cell]
        assert spec[name]["source"] == "program_span"
        assert spec[name]["unit"] == "ms"


@pytest.mark.parametrize("cell,name", ALL)
def test_reader_without_a_span_table_reads_nothing(monkeypatch, cell, name):
    import large_scale_recommendation_tpu_torch.obs.trace as ptr

    reader = _reader(name)
    monkeypatch.delattr(ptr, "span_totals")
    assert reader.read(_ctx()) is None
    monkeypatch.setitem(sys.modules, TRACE_MODULE, None)  # ImportError
    assert reader.read(_ctx()) is None


@pytest.mark.parametrize("cell,name", ALL)
def test_reader_of_a_span_that_never_ran_reads_nothing(cell, name):
    import large_scale_recommendation_tpu_torch.obs.trace as ptr

    ptr.reset_span_totals()
    assert _reader(name).read(_ctx()) is None


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_tiny_traced_run(cell):
    import large_scale_recommendation_tpu_torch.obs.trace as ptr

    ptr.reset_span_totals()
    res = harness.run_cell(cell, SEED, 0.3, True, device="cpu",
                           log=io.StringIO(), **TINY[cell])
    assert res["correct"], res["compared"]
    for name in SPAN_METRICS[cell]:
        if cell in HOST:
            value = res["metrics"][name]["value"]
            assert value > 0 and res["metrics"][name]["unit"] == "ms"
        else:  # device time: CUDA events, on the card only
            assert name not in res["metrics"]
