"""The port's introspector against the JAX package's: ``roofline_rows`` is
equal for the same records, walls, hand models and explicit peaks, and so
is a whole ``roofline()`` driven through ``note_compiled`` /
``register_model_cost`` and the tracer's key walls (exact: host
arithmetic). On the CPU: no device-memory stats (the graceful-absent
path), peaks only by card or by argument, the profiler capture layer and
its accounting, the step pair's launcher record on the mesh route."""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu.obs import introspect as jin
from large_scale_recommendation_tpu.obs import trace as jtr
from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.obs import introspect as pin
from large_scale_recommendation_tpu_torch.obs import trace as ptr
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry
from large_scale_recommendation_tpu_torch.ops import cuda_sgd
from large_scale_recommendation_tpu_torch.utils import metrics

PEAKS = dict(hbm_peak_gbs=3350.0, fp32_peak_tflops=67.0)


@pytest.fixture
def port_defaults():
    prev = (obs.get_registry(), obs.get_tracer(), obs.get_introspector())
    yield
    obs.disable()
    obs.set_registry(prev[0])
    obs.set_tracer(prev[1])
    obs.set_introspector(prev[2])


def _tables(seed):
    rng = np.random.default_rng(seed)
    keys = [f"k{j}" for j in range(4)]
    records = [{"key": keys[rng.integers(0, 4)], "module": f"m{j}",
                "compiles": int(rng.integers(1, 4)),
                "compile_wall_s": float(rng.random()),
                "flops": float(rng.integers(0, 1 << 40)),
                "bytes_accessed": float(rng.integers(0, 1 << 36)),
                "memory": None} for j in range(10)]
    walls = {k: {"execute_count": int(rng.integers(0, 4)),
                 "execute_total_s": float(rng.random()),
                 "iterations": int(rng.integers(1, 9))}
             for k in keys[:3]}
    costs = {k: {"bytes_per_iteration": float(rng.integers(1, 1 << 30)),
                 "collective_bytes_per_iteration":
                     float(rng.integers(0, 1 << 20))} for k in keys[1:]}
    return records, walls, costs


@pytest.mark.parametrize("seed", range(5))
def test_roofline_rows_equal_jax(seed):
    records, walls, costs = _tables(seed)
    assert pin.roofline_rows(records, walls, costs, **PEAKS) == \
        jin.roofline_rows(records, walls, costs, **PEAKS)


@pytest.mark.parametrize("key", ["s", ("train_segment", "dsgd", (3, 4)),
                                 7, ("a", 1.5, None)])
def test_render_key_equal_jax(key):
    assert pin.render_key(key) == jin.render_key(key)


def test_roofline_from_notes_and_spans_equal_jax():
    rows = []
    for trace_mod, mod in ((jtr, jin), (ptr, pin)):
        tracer = trace_mod.Tracer()
        ins = mod.Introspector(tracer=tracer) if mod is jin else \
            mod.Introspector(registry=MetricsRegistry(), tracer=tracer)
        key = ("train_segment", "dsgd_segment", (64, 8))
        for n in range(3):
            with tracer.span("train/dsgd", key=key, iterations=2):
                ins.note_compiled(pin.render_key(key), "dsgd_sweep",
                                  flops=1e9, bytes_accessed=4e8)
        ins.register_model_cost(key, bytes_per_iteration=1e8,
                                flops_per_iteration=5e8)
        ins.note_compiled("other", "helper", flops=1.0, bytes_accessed=2.0)
        walls = {pin.render_key(k): dict(v, execute_total_s=0.25 *
                                         v["execute_count"])
                 for k, v in tracer.key_walls().items()}
        tab = mod.roofline_rows(ins.records(), walls, ins.model_costs(),
                                **PEAKS)
        rows.append([{k: v for k, v in r.items() if k != "compile_wall_s"}
                     for r in tab])
        assert ins.compile_count == 4
    assert rows[0] == rows[1]
    row = rows[1][1]
    assert row["pct_of_hbm_peak"] == pytest.approx(100 * 1.6 / 3350.0)
    assert row["xla_vs_model_bytes"] == pytest.approx(2.0)


def test_peaks_come_from_the_card_or_the_caller():
    assert pin.DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]["hbm_gbs"] == 3350.0
    with pytest.raises(ValueError, match="no published peaks"):
        pin.device_peaks("Some Other Card")
    ins = pin.Introspector(registry=MetricsRegistry(), tracer=ptr.Tracer())
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            ins.roofline()
    out = ins.roofline(**PEAKS)
    assert out["rows"] == [] and out["hbm_peak_gbs"] == 3350.0
    assert pin.Introspector(registry=MetricsRegistry(),
                            **PEAKS).peaks() == (3350.0, 67.0)


def test_device_memory_absent_on_the_cpu():
    """The graceful-absent path the JAX introspector pins on the CPU:
    ``supported`` False, ``stats: null``, no byte gauges."""
    if torch.cuda.is_available():
        pytest.skip("the CPU's absent path")
    reg = MetricsRegistry()
    sample = pin.Introspector(registry=reg).sample_device_memory()
    assert sample["supported"] is False
    assert sample["devices"] == [{"device": "cpu:0", "stats": None}]
    assert sample["live_arrays"]["count"] == 0  # no CUDA tensor here
    assert not any(n.startswith("device_") for n in reg.names())
    assert pin.Introspector(registry=reg).sample_device_memory(
        live_tensors=False)["live_arrays"] is None


def test_profile_trace_writes_a_chrome_trace_and_counts(tmp_path,
                                                        port_defaults):
    reg, _ = obs.enable()
    before = pin.CAPTURE_COUNT
    with pin.profile_trace(str(tmp_path / "a")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
        with pytest.raises(RuntimeError, match="in progress"):
            with pin.profile_trace(str(tmp_path / "b")):
                pass
    assert any("aten::mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "a" / pin.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    out = obs.capture_profile(str(tmp_path / "c"), seconds=0.05)
    assert pin.TRACE_FILE in out["files"]
    assert pin.CAPTURE_COUNT == before + 2
    assert reg.counter("profiler_captures_total").value == 2


def test_metrics_profile_shim_routes_through_the_capture_layer(tmp_path):
    before = pin.CAPTURE_COUNT
    with metrics.profile(None):
        pass
    assert pin.CAPTURE_COUNT == before
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with metrics.profile(str(tmp_path)):
            torch.ones(4).sum()
    assert pin.CAPTURE_COUNT == before + 1
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert os.path.exists(tmp_path / pin.TRACE_FILE)


def test_step_pair_record_on_the_mesh_route(port_defaults, monkeypatch):
    """The mesh's per-visit route (``block_sweep`` through the step pair's
    plain versions on the CPU) notes one record per segment against the
    timer's key: the plan's bound bytes × sweeps, 12·rank per entry."""
    from large_scale_recommendation_tpu_torch.core.generators import (
        SyntheticMFGenerator,
    )
    from large_scale_recommendation_tpu_torch.parallel import (
        MeshDSGD,
        MeshDSGDConfig,
        Partitioner,
    )

    noted = []
    note = cuda_sgd.note_launches

    def spy(plan, rank, sweeps, **kw):
        noted.append((plan, rank, sweeps))
        note(plan, rank, sweeps, **kw)

    monkeypatch.setattr(cuda_sgd, "note_launches", spy)
    reg, tracer = obs.enable()
    ins = obs.enable_introspection(start=False, **PEAKS)
    ratings = SyntheticMFGenerator(num_users=60, num_items=40, rank=4,
                                   seed=1).generate(1500)
    cfg = MeshDSGDConfig(num_factors=8, iterations=2, learning_rate=0.05,
                         lambda_=0.05, minibatch_size=128, init_scale=0.3)
    MeshDSGD(cfg, partitioner=Partitioner(device="cpu")).fit(
        ratings, checkpoint_every=1)
    (row,) = ins.roofline()["rows"]
    assert row["module"] == "dsgd_sweep"
    assert row["key"].startswith("train_segment/mesh_dsgd_segment")
    assert row["compiles"] == 2 and row["execute_count"] == 1
    plan, rank, sweeps = noted[-1]
    assert (rank, sweeps) == (8, 1)
    assert row["xla_bytes_accessed"] == plan.bound_bytes(8)
    entries = plan.entry_base[-1] - plan.entry_base[0]
    assert row["xla_flops"] == entries * 12 * 8
    assert row["xla_vs_model_bytes"] is not None
    assert reg.counter("train_segments_total",
                       model="mesh_dsgd").value == 2
