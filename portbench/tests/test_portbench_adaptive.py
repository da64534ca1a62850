"""The adaptive cell at a tiny size on the CPU: whole runs through the
harness (the look for a card skipped), once sound, once as its control
(the retrain's bf16 tables) and once with each fault planted underneath —
the retrain's (``faults.py``'s ``dsgd``), the online step's (``online``)
and the skipped install (``adaptive_faults.py``); the sound run comes out
correct and no other does. Then a traced run, whose span readers read a
number, and the readers where the program keeps no span table.

The history window (5,500 ratings, 5.5 batches) is shorter than the
stream and slides, so a retrain's window leaves some registered ids out
(they keep their online rows at the swap) and cuts a batch in two."""

import io
import os
import sys
import types

import pytest

from portbench import adaptive_faults, faults, harness

CELL = "netflix_adaptive_r128.retrain_cycle"
SEED = 3_000_000_019  # past 32 signed bits, as a check's seeds can be
TINY = {
    "config_override": {
        # 1,500 users: the online tables' middle row (the "altered"
        # fault's) is a registered one at AdaptiveMF's capacity of 1,024+
        "data": {"num_users": 1500, "num_items": 100, "ratings": 20000,
                 "planted_rank": 4, "noise": 0.1, "skew": 2.0},
        "online": {"num_factors": 8, "learning_rate": 0.05,
                   "minibatch_size": 256, "init_capacity": 64,
                   "init_scale": 0.1, "iterations_per_batch": 1,
                   "collision_mode": "mean"},
        "retrain": {"offline_every": 3, "history_limit": 5500,
                    "background": False},
        # learning rate as tiny.py's DSGD cells, for the same reason
        "dsgd": {"num_factors": 8, "lambda_": 0.1, "iterations": 3,
                 "learning_rate": 0.05, "lr_schedule": "warm_boost",
                 "minibatch_size": 64, "init_scale": 0.08,
                 "collision_mode": "mean", "minibatch_sort": "item",
                 "factor_dtype": "float32", "num_blocks": 4},
    },
    "mix_override": {"batch": 1000, "trace_calls": 6},
}
SPAN_METRICS = ("adaptive.retrain_ms", "adaptive.history_ms",
                "adaptive.install_ms", "adaptive.retrain_mfu")


def _run(trace=False, config=None, seconds=0.3):
    over = dict(TINY["config_override"])
    for key, val in (config or {}).items():
        over[key] = {**over[key], **val}
    return harness.run_cell(CELL, SEED, seconds, trace, device="cpu",
                            log=io.StringIO(), config_override=over,
                            mix_override=TINY["mix_override"])


def test_sound_run_is_correct_over_several_swaps():
    res = _run(seconds=2.0)
    assert res["attempted"] >= 4  # a swap in the window, after set-up's
    assert res["correct"], res["compared"]
    assert res["compared"]["install_gap"]["limit"] == 0


def test_control_is_not_correct():
    ctl = harness.load_json(os.path.join(
        harness.BENCH_DIR, "limits", CELL + ".json"))["control"]
    res = _run(config=ctl)
    assert not res["correct"], res["compared"]
    # the retrain's precision alone: the copy and the online step hold
    for name in ("install_gap", "U_gap", "V_gap"):
        c = res["compared"][name]
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("solver,fault", [
    *(("dsgd", f) for f in faults.FAULTS),
    *(("online", f) for f in faults.FAULTS),
    ("adaptive", "install_skipped")])
def test_fault_is_caught(monkeypatch, solver, fault):
    if solver == "adaptive":
        adaptive_faults.plant(monkeypatch, fault)
    else:
        faults.plant(monkeypatch, solver, fault)
    res = _run()
    assert not res["correct"], res["compared"]


def test_traced_run_reads_the_spans():
    import large_scale_recommendation_tpu_torch.obs.trace as ptr

    ptr.reset_span_totals()
    res = _run(trace=True)
    assert res["correct"], res["compared"]
    for name in SPAN_METRICS:
        assert res["metrics"][name]["value"] > 0, name
    rows = ptr.span_totals()["adaptive/install"]["args"]
    assert rows["rows_u"] > 0 and rows["rows_v"] > 0 and rows["kept"] > 0
    assert ptr.span_totals()["adaptive/retrain"]["args"]["sweeps"] == (
        3 * ptr.span_totals()["adaptive/retrain"]["count"])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_without_a_span_table_reads_nothing(monkeypatch, name):
    import large_scale_recommendation_tpu_torch.obs.trace as ptr

    reader = harness.load_module(
        os.path.join(harness.BENCH_DIR, "metrics", name + ".py"),
        harness.safe("metric_" + name))
    ctx = types.SimpleNamespace(
        facts={"traced_retrains": 2, "window_ratings": 5500},
        config=TINY["config_override"], profile=None)
    ptr.reset_span_totals()
    assert reader.read(ctx) is None  # the span never ran
    monkeypatch.delattr(ptr, "span_totals")
    assert reader.read(ctx) is None
    monkeypatch.setitem(sys.modules, ptr.__name__, None)  # ImportError
    assert reader.read(ctx) is None
