"""The two-stage serving cell: whole runs at a tiny size on the CPU, once
sound, once with each fault of ``retrieval_faults.py`` planted in the
retriever underneath, and once as each of its controls; the sound run
comes out correct and every other one does not. Its readers read nothing,
and raise nothing, where the program has no stage spans or no device
time, and stage 1's least time is the hand-worked one."""

import copy
import io
import os
import types

import pytest

from portbench import harness, retrieval_faults
from portbench.reference import retrieval_counts
from portbench.reference.peaks import HBM_BYTES_PER_S

CELL = "mpd_r64.serve_two_stage"
SEED = 3_000_000_019  # past 32 signed bits, as a check's seeds can be
TINY = {
    "config_override": {
        "data": {"num_users": 300, "num_items": 2000, "ratings": 8000,
                 "planted_rank": 4, "noise": 0.1, "skew": 2.0},
        "serve": {"num_factors": 16, "k": 20, "max_batch": 64,
                  "dtype": "float32", "torch_threads": 1,
                  "retrieval": {"n_clusters": None, "overfetch": 4,
                                "max_bucket": 16}}},
    "mix_override": {"rate_rps": 20000},
}
CONFIG = {"data": {"num_items": 2262292}, "serve": {"num_factors": 64}}
METRICS = ("retrieval.stage1_ms", "retrieval.stage2_ms",
           "retrieval.stage1_roofline")


def _run(trace=False, **kw):
    return harness.run_cell(CELL, SEED, 0.3, trace, device="cpu",
                            log=io.StringIO(), **{**TINY, **kw})


def _control(key):
    ctl = harness.load_json(os.path.join(
        harness.BENCH_DIR, "limits", CELL + ".json"))[key]
    tiny = copy.deepcopy(TINY)
    tiny["config_override"]["serve"].update(ctl["serve"])
    return tiny


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["compared"]
    assert set(res["compared"]) == {"excluded_or_missing", "score_gap",
                                    "recall_miss", "recall_gap"}
    assert res["attempted"] > 0 and list(res)[-1] == "compared"


@pytest.mark.parametrize("key", ["control", "control_stage1_only"])
def test_control_is_not_correct(key):
    res = harness.run_cell(CELL, SEED, 0.3, False, device="cpu",
                           log=io.StringIO(), **_control(key))
    assert not res["correct"], res["compared"]
    assert (res["compared"]["score_gap"]["value"]
            > res["compared"]["score_gap"]["limit"])


@pytest.mark.parametrize("fault", retrieval_faults.FAULTS)
def test_fault_is_caught(monkeypatch, fault):
    retrieval_faults.plant(monkeypatch, fault)
    res = _run()
    assert not res["correct"], res["compared"]


def test_fault_names_are_checked():
    with pytest.raises(ValueError):
        retrieval_faults.plant(None, "unchanged")


def test_tiny_traced_run_reads_no_device_time_on_the_cpu():
    import large_scale_recommendation_tpu_torch.obs.trace as ptr

    ptr.reset_span_totals()
    res = _run(trace=True)
    assert res["correct"], res["compared"]
    tot = ptr.span_totals()
    assert tot["serving/stage1"]["count"] == tot["serving/stage2"]["count"]
    assert tot["serving/stage1"]["args"]["items"] == (
        tot["serving/stage1"]["count"] * 2000)
    for name in METRICS:  # device time: CUDA events, on the card only
        assert name not in res["metrics"]


def _reader(name):
    return harness.load_module(
        os.path.join(harness.BENCH_DIR, "metrics", name + ".py"),
        harness.safe("metric_" + name))


@pytest.mark.parametrize("name", METRICS)
def test_reader_without_stage_spans_reads_nothing(monkeypatch, name):
    import large_scale_recommendation_tpu_torch.obs.trace as ptr

    ctx = types.SimpleNamespace(facts={"traced_calls": 40}, profile=None,
                                config=CONFIG)
    ptr.reset_span_totals()  # an older program: no stage span ran
    assert _reader(name).read(ctx) is None
    monkeypatch.delattr(ptr, "span_totals")
    assert _reader(name).read(ctx) is None


def test_roofline_reader_over_stage1_device_time(monkeypatch):
    import large_scale_recommendation_tpu_torch.obs.trace as ptr

    monkeypatch.setattr(ptr, "span_totals", lambda: {
        "serving/stage1": {"count": 160, "device_ms": 800.0,
                           "args": {"rows": 40 * 1024, "padded": 40 * 1024,
                                    "items": 160 * 2262292}}})
    ctx = types.SimpleNamespace(facts={"traced_calls": 40}, profile=None,
                                config=CONFIG)
    assert _reader("retrieval.stage1_ms").read(ctx) == 20.0
    # 40 full calls' 5.993 ms least over the 800 ms spent
    assert _reader("retrieval.stage1_roofline").read(ctx) == (
        pytest.approx(100 * 40 * 296523137024 / 1979e12 / 0.8, rel=1e-12))
    assert _reader("retrieval.stage1_roofline").read(ctx) == (
        pytest.approx(0.749, rel=1e-3))


def test_stage1_least_time_of_a_full_call():
    """1,024 users against 2,262,292 tracks at rank 64: 2·1024·2262292·64
    = 296,523,137,024 int8 operations, 1.4984e-4 s at 1,979 TOP/s, above
    the 162,885,024 catalog bytes' 4.862e-5 s: bound by the operations."""
    least = retrieval_counts.stage1_least_seconds(1024, 2262292, 64)
    assert least == pytest.approx(296523137024 / 1979e12, rel=1e-12)
    assert least == pytest.approx(1.49835e-4, rel=1e-5)


def test_stage1_least_time_of_one_user_is_the_catalog_read():
    least = retrieval_counts.stage1_least_seconds(1, 2262292, 64)
    assert least == pytest.approx(162885024 / HBM_BYTES_PER_S, rel=1e-12)
    assert least == pytest.approx(4.8622e-5, rel=1e-4)


def test_stage1_least_time_of_full_calls_adds_call_by_call():
    least = retrieval_counts.stage1_least_seconds(40 * 1024, 2262292, 64,
                                                  calls=40)
    assert least == pytest.approx(
        40 * retrieval_counts.stage1_least_seconds(1024, 2262292, 64),
        rel=1e-12)


def test_stage1_least_time_of_one_user_calls_reads_the_catalog_each_call():
    least = retrieval_counts.stage1_least_seconds(4, 2262292, 64, calls=4)
    assert least == pytest.approx(4 * 162885024 / HBM_BYTES_PER_S,
                                  rel=1e-12)
