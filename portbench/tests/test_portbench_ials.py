"""The implicit ALS cell (``mpd_ials_r64.ials_fit``) at a tiny size on the
CPU: its counts against a brute-force count, whole runs through the
harness (the look for a card skipped) — once sound, once as its control
(the program's bf16 grams) and once with each fault planted underneath
(``faults.py``'s for ``als``, ``ials_faults.py``'s) — where the sound run
comes out correct and no other does; and its readers, which read nothing
without their span table and the share its counts give with one."""

import io
import json
import os
import sys
import types

import pytest
import torch

from portbench import faults, harness, ials_faults
from portbench.reference import ials_counts
from portbench.reference.peaks import least_seconds

CELL = "mpd_ials_r64.ials_fit"
SEED = 3_000_000_019  # past 32 signed bits, as a check's seeds can be
TINY = {
    "data": {"num_users": 300, "num_items": 200, "ratings": 6000,
             "planted_rank": 4, "noise": 0.1, "skew": 2.0},
    "als": {"num_factors": 8, "lambda_": 0.1, "iterations": 10,
            "reg_mode": "direct", "init_scale": 0.1, "gram_dtype": None,
            "implicit_alpha": 40.0},
}
# the cell's per-layer metrics: two of its own, two shared with als_fit
READERS = ("als.round_ms", "ials.solve_roofline", "ials.full_gram_ms",
           "device_idle.train")


def _run(trace=False, als=None):
    over = {**TINY, "als": {**TINY["als"], **(als or {})}}
    return harness.run_cell(CELL, SEED, 0.3, trace, device="cpu",
                            log=io.StringIO(), config_override=over)


def _reader(name):
    return harness.load_module(
        os.path.join(harness.BENCH_DIR, "metrics", name + ".py"),
        harness.safe("metric_" + name))


# -- the counts ---------------------------------------------------------------


class _Ops:
    """Scalar arithmetic that counts its FLOPs (an FMA 2, the rest 1)."""

    def __init__(self):
        self.flops = 0

    def fma(self, a, b, c):
        self.flops += 2
        return a * b + c

    def one(self, x):
        self.flops += 1
        return x


def _half_step_by_hand(F, plans, G, lam, ops):
    """The half-step of ``ials_counts``' docstring, scalar by scalar: for
    each row its weighted gram's lower triangle and b, G and the ridge
    added, a right-looking Cholesky, the two solves."""
    k = F.shape[1]
    xs = []
    for cols, strengths, weights in plans:
        A = [[0.0] * k for _ in range(k)]
        b = [0.0] * k
        for c, a, w in zip(cols, strengths, weights):
            y = F[c].tolist()
            for p in range(k):
                for q in range(p + 1):
                    A[p][q] = ops.fma(w * y[p], y[q], A[p][q])
                b[p] = ops.fma(a, y[p], b[p])
        for p in range(k):
            for q in range(p + 1):
                A[p][q] = ops.one(A[p][q] + G[p][q])
            A[p][p] = ops.one(A[p][p] + lam)
        inv = [0.0] * k
        for c in range(k):
            inv[c] = ops.one(A[c][c] ** -0.5)
            A[c][c] = ops.one(A[c][c] * inv[c])
            for p in range(c + 1, k):
                A[p][c] = ops.one(A[p][c] * inv[c])
            for p in range(c + 1, k):
                for q in range(c + 1, p + 1):
                    A[p][q] = ops.fma(-A[p][c], A[q][c], A[p][q])
        y = list(b)
        for p in range(k):
            for q in range(p):
                y[p] = ops.fma(-A[p][q], y[q], y[p])
            y[p] = ops.one(y[p] / A[p][p])
        for p in reversed(range(k)):
            for q in range(p + 1, k):
                y[p] = ops.fma(-A[q][p], y[q], y[p])
            y[p] = ops.one(y[p] / A[p][p])
        xs.append(y)
    return torch.tensor(xs, dtype=torch.float64)


def test_half_step_counts_match_a_count_by_hand():
    g = torch.Generator().manual_seed(0)
    k, n_other = 5, 9
    F = torch.randn((n_other, k), generator=g, dtype=torch.float64)
    G = (F.T @ F).tolist()
    plans = [([0, 3, 4], [41.0, 81.0, 41.0], [40.0, 80.0, 40.0]),
             ([2], [41.0], [40.0]),
             ([1, 5, 6, 7, 8], [41.0] * 5, [40.0] * 5)]
    ops = _Ops()
    x = _half_step_by_hand(F, plans, G, 0.1, ops)
    rows, entries = len(plans), sum(len(p[0]) for p in plans)
    assert ials_counts.half_step_flops(rows, entries, k) == ops.flops
    for (cols, a, w), xr in zip(plans, x):  # the count is of a real solve
        Y = F[cols]
        A = (torch.tensor(G, dtype=torch.float64)
             + Y.T @ (torch.tensor(w, dtype=torch.float64)[:, None] * Y)
             + 0.1 * torch.eye(k, dtype=torch.float64))
        want = torch.linalg.solve(A, Y.T @ torch.tensor(a,
                                                         dtype=torch.float64))
        torch.testing.assert_close(xr, want)
    # bytes: each entry's partner row, column, value and weight; each
    # solved row's output row
    per_entry = F[0].float().nbytes + 3 * 4
    assert ials_counts.half_step_bytes(rows, entries, k) == (
        entries * per_entry + rows * F[0].float().nbytes)
    assert ials_counts.half_step_least_seconds(rows, entries, k) == (
        least_seconds(ials_counts.half_step_bytes(rows, entries, k),
                      ials_counts.half_step_flops(rows, entries, k))[0])
    assert ials_counts.full_gram_flops(n_other, k) == 2 * n_other * k * k
    assert ials_counts.full_gram_bytes(n_other, k) == F.float().nbytes


def test_the_cells_half_steps_are_bound_by_flops():
    """At the configuration's size (1M playlists, 2,262,180 tracks with
    pairs, 66.3M pairs, rank 64) both half-steps' least times are their
    FLOPs', so the share over their sum reads no high."""
    for rows in (1_000_000, 2_262_180):
        nbytes = ials_counts.half_step_bytes(rows, 66_344_819, 64)
        flops = ials_counts.half_step_flops(rows, 66_344_819, 64)
        assert least_seconds(nbytes, flops)[1] == "flops"


# -- whole runs -----------------------------------------------------------------


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1
    assert set(res["compared"]) == {"U_gap", "V_gap"}


def test_control_is_not_correct():
    ctl = harness.load_json(os.path.join(
        harness.BENCH_DIR, "limits", CELL + ".json"))["control"]
    res = _run(als=ctl["als"])
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_caught(monkeypatch, fault):
    faults.plant(monkeypatch, "als", fault)
    res = _run()
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("fault", ials_faults.FAULTS)
def test_implicit_fault_is_caught_on_the_fused_plan(monkeypatch, fault):
    """On the CPU the fused route's plan runs through the kernel's plain
    version when ``fused_route`` says so, as it does on a card."""
    from large_scale_recommendation_tpu_torch.ops import als

    monkeypatch.setattr(als, "fused_route",
                        lambda device, k, gram_dtype=None: True)
    assert _run()["correct"]
    ials_faults.plant(monkeypatch, fault)
    res = _run()
    assert not res["correct"], res["compared"]


def test_traced_run_reads_nothing_of_the_card_here():
    """On the CPU the rounds keep no CUDA events and the spans no device
    time: every reader of the cell reads nothing, and the run holds."""
    res = _run(trace=True)
    assert res["correct"], res["compared"]
    assert not set(READERS) & set(res["metrics"])


# -- the readers ----------------------------------------------------------------


def _ctx(facts=None):
    return types.SimpleNamespace(
        facts={"traced_fits": 1, "sweeps": 10, **(facts or {})},
        config={"als": {"num_factors": 64}}, profile=None)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_a_span_table_reads_nothing(monkeypatch, name):
    import large_scale_recommendation_tpu_torch.obs.trace as ptr

    reader = _reader(name)
    ptr.reset_span_totals()
    assert reader.read(_ctx()) is None  # no span ran, no window
    monkeypatch.delattr(ptr, "span_totals")
    assert reader.read(_ctx()) is None
    monkeypatch.setitem(sys.modules, ptr.__name__, None)  # ImportError
    assert reader.read(_ctx()) is None


def test_readers_read_the_spans_of_the_weighted_build(monkeypatch):
    import large_scale_recommendation_tpu_torch.obs.trace as ptr

    rows, entries = 20 * 1_631_090, 20 * 66_344_819
    solve = {"device_ms": 1600.0,
             "args": {"rows": rows, "fused": rows, "weighted": rows,
                      "entries": entries}}
    table = {"als/solve": solve,
             "als/full_gram": {"device_ms": 7.5, "args": {"rows": 1}}}
    monkeypatch.setattr(ptr, "span_totals", lambda: table)
    least = ials_counts.half_step_least_seconds(rows, entries, 64)
    share = _reader("ials.solve_roofline").read(_ctx())
    assert share == pytest.approx(100 * least / 1.6)
    assert 0 < share < 100
    assert _reader("ials.full_gram_ms").read(_ctx()) == pytest.approx(0.75)
    # another route (no weighted build on every row, no entry count)
    for change in ({"weighted": 0}, {"fused": 0}, {"entries": None}):
        solve["args"] = {"rows": rows, "fused": rows, "weighted": rows,
                         "entries": entries, **change}
        assert _reader("ials.solve_roofline").read(_ctx()) is None
    ctx = _ctx({"window_counters": {"round_ms_sum": 1740.0, "rounds": 10}})
    assert _reader("als.round_ms").read(ctx) == pytest.approx(174.0)


@pytest.mark.parametrize("name", READERS)
def test_the_cells_readers_list_it(name):
    """Each of the cell's metrics names it among its cells and moves the
    rate its cell reports."""
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    metric = {m["name"]: m for m in spec["per_layer"]}[name]
    assert CELL in metric["workloads"]
    assert metric["moves"] == "train_ratings_per_s"
