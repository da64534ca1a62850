"""Kernel introspection: per-kernel cost records joined with measured walls
into a live roofline, device-memory telemetry, and profiler capture
(counterpart of ``large_scale_recommendation_tpu.obs.introspect``).

The JAX introspector patches XLA's compile funnel and reads each
executable's ``cost_analysis()``. The port compiles no XLA program: its
kernels are hand-written and built once per process, so there is no funnel
to patch. The kernel's own record comes from its launcher instead:
``ops.cuda_sgd.note_launches`` (called by ``dsgd_train_cuda`` and by the
mesh's per-visit route once per segment) calls ``note_compiled(key,
module="dsgd_sweep", flops=…, bytes_accessed=…)`` against the enclosing
span's compile key (``Tracer.current_compile_key()``). Its bytes are the
step plan's distinct-row count — each distinct row of a step read and
written once with its ω, 24 B of streams per entry: the bound of the
step pair's function (``StepPlan.bound_bytes``) — and its flops 12·rank
per entry. The gauge names stay the JAX package's (``xla_flops``,
``xla_bytes_accessed``, ``xla_vs_model_bytes``, ``xla_pct_of_hbm_peak``)
so readers of either package see one catalog; in the port "xla" names
the launcher's record.

- ``roofline()`` joins the records with the tracer's measured execute
  walls (``Tracer.key_walls()``) and the hand model each trainer
  registers (``register_model_cost``: ``ops.sgd.dsgd_bytes_per_sweep``
  with ``kernel="cuda"``) into one row per compile key: achieved GB/s,
  ``pct_of_hbm_peak`` / ``pct_of_fp32_peak`` and ``xla_vs_model_bytes``.
- Peaks come from the card: ``device_peaks()`` looks them up by
  ``torch.cuda.get_device_name()`` in ``DEVICE_PEAKS`` (NVIDIA's data
  sheet) and raises for a card it does not know, unless the caller
  passes the peaks.
- ``sample_device_memory()`` reads ``torch.cuda.memory_stats`` (bytes
  allocated now and at peak) and ``torch.cuda.mem_get_info`` (the
  limit) per card, plus a dtype breakdown of the CUDA tensors the
  garbage collector can see — a walk over every object ``gc`` tracks,
  so a cold-path read that only an explicit call makes (the periodic
  sampler does not; ``chip_smoke.py`` prints one sample's wall).
  Without a card it reports ``supported: False`` and ``stats: null``.
- ``profile_trace(log_dir)`` / ``capture_profile(dir, seconds)`` — the
  one ``torch.profiler`` capture layer (CPU and, with a card, CUDA
  activity; a process lock, ``profiler_captures_total``), writing a
  Chrome trace (``TRACE_FILE``) into the directory: every thread's host
  ops and the card's kernels, as ``jax.profiler`` records the whole
  process (``/profilez`` captures on a handler thread).

Zero-cost when unused: the module default is ``None``
(``get_introspector()``) and every producer hook is one ``is not None``
test. ``obs.enable_introspection()`` is the one-call form;
``obs.disable()`` stops and removes it.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import sys
import threading
import time
from typing import Any

import torch

from large_scale_recommendation_tpu_torch.obs.registry import get_registry
from large_scale_recommendation_tpu_torch.obs.trace import get_tracer

# Published peaks by CUDA device name (NVIDIA's H100 data sheet, SXM part,
# dense rates): HBM GB/s, f32 TFLOP/s outside the tensor cores, bf16
# TFLOP/s on them. A card set below its 700 W limit runs slower.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbs": 3350.0, "fp32_tflops": 67.0,
                              "bf16_tflops": 989.0},
}

DEFAULT_MAX_RECORDS = 1024
TRACE_FILE = "trace.json"  # the Chrome trace profile_trace writes

# torch.profiler is one per process: ONE lock for every capture path, so a
# second trigger gets a clean "capture in progress"
_PROFILE_LOCK = threading.Lock()
# captures completed through profile_trace since import
CAPTURE_COUNT = 0
# whether torch's profiler library (Kineto) has been initialized by a
# capture in this process (see warm_profiler)
_PROFILER_READY = False


def device_peaks(name: str | None = None) -> dict:
    """The peaks of card ``name`` (default: CUDA device 0's name);
    ``ValueError`` for a card ``DEVICE_PEAKS`` does not hold."""
    if name is None:
        if not torch.cuda.is_available():
            raise ValueError("no CUDA device: pass the peaks explicitly")
        name = torch.cuda.get_device_name(0)
    if name not in DEVICE_PEAKS:
        raise ValueError(f"no published peaks for {name!r}; pass "
                         "hbm_peak_gbs and fp32_peak_tflops")
    return dict(DEVICE_PEAKS[name])


def render_key(key: Any) -> str:
    """Canonical string form of a tracer compile key: top-level tuple
    parts joined by ``/``, strings kept verbatim, everything else
    ``repr``'d — stable across runs of the same geometry, so it can label
    metrics and join tables."""
    if isinstance(key, str):
        return key
    if isinstance(key, tuple):
        return "/".join(p if isinstance(p, str) else repr(p) for p in key)
    return repr(key)


class Introspector:
    """Kernel records keyed by the enclosing tracer compile key, joined
    into a roofline.

    ``note_compiled`` records one kernel's cost per execution (the
    launchers call it; a test drives known numbers through it).
    ``max_records`` caps the table (distinct (key, module) pairs past it
    are counted in ``dropped``). ``hbm_peak_gbs`` / ``fp32_peak_tflops``
    default to the card's (``device_peaks``)."""

    def __init__(self, registry=None, tracer=None,
                 max_records: int = DEFAULT_MAX_RECORDS,
                 hbm_peak_gbs: float | None = None,
                 fp32_peak_tflops: float | None = None):
        self._obs = registry if registry is not None else get_registry()
        self._tracer = tracer if tracer is not None else get_tracer()
        self.max_records = int(max_records)
        self.hbm_peak_gbs = hbm_peak_gbs
        self.fp32_peak_tflops = fp32_peak_tflops
        self.compile_count = 0
        self.compile_wall_s = 0.0
        self.errors = 0
        self.dropped = 0
        self._records: dict[tuple[str, str], dict] = {}
        self._model_costs: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._task = None

    # -- kernel records ------------------------------------------------------

    def current_key(self, module: str) -> str:
        """The rendered compile key of the innermost open keyed span on
        the calling thread, else ``module`` (a launch outside any keyed
        span, as a JAX compile outside one falls back to its module
        name)."""
        raw = self._tracer.current_compile_key()
        return render_key(raw) if raw is not None else module

    def note_compiled(self, key: str, module: str, *, flops: float,
                      bytes_accessed: float, wall_s: float = 0.0,
                      memory: dict | None = None) -> None:
        """Record one kernel's cost per execution of span family ``key``
        (the JAX package's ``_on_compile`` capture: a later note of the
        same (key, module) replaces the numbers and counts once more)."""
        now = time.time()
        with self._lock:
            self.compile_count += 1
            self.compile_wall_s += wall_s
            rec = self._records.get((key, module))
            if rec is None:
                if len(self._records) >= self.max_records:
                    self.dropped += 1
                    return
                rec = self._records[(key, module)] = {
                    "key": key, "module": module, "compiles": 0,
                    "compile_wall_s": 0.0, "flops": 0.0,
                    "bytes_accessed": 0.0, "memory": None,
                    "first_time": now, "last_time": now,
                }
            rec["compiles"] += 1
            rec["compile_wall_s"] += wall_s
            rec["flops"] = float(flops)
            rec["bytes_accessed"] = float(bytes_accessed)
            if memory is not None:
                rec["memory"] = dict(memory)
            rec["last_time"] = now
        obs = self._obs
        obs.counter("compile_count", key=key).inc()
        obs.counter("compile_wall_s", key=key).inc(wall_s)
        obs.gauge("xla_flops", key=key).set(float(flops))
        obs.gauge("xla_bytes_accessed", key=key).set(float(bytes_accessed))
        if memory is not None:
            obs.gauge("xla_temp_bytes", key=key).set(
                memory.get("temp_size_in_bytes", 0))

    def records(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._records.values()]

    def register_model_cost(self, key: Any,
                            bytes_per_iteration: float | None = None,
                            flops_per_iteration: float | None = None,
                            collective_bytes_per_iteration: float | None
                            = None,
                            ) -> None:
        """Attach the HAND cost model for one compile key (bytes/flops one
        iteration — one sweep — moves): ``TrainSegmentTimer.finish``
        calls this with ``ops.sgd.dsgd_bytes_per_sweep`` /
        ``dsgd_flops_per_sweep``. ``collective_bytes_per_iteration`` is
        the rank-sharded route's interconnect term, kept apart."""
        rendered = render_key(key)
        with self._lock:
            mc = self._model_costs.setdefault(rendered, {})
            if bytes_per_iteration:
                mc["bytes_per_iteration"] = float(bytes_per_iteration)
            if flops_per_iteration:
                mc["flops_per_iteration"] = float(flops_per_iteration)
            if collective_bytes_per_iteration:
                mc["collective_bytes_per_iteration"] = float(
                    collective_bytes_per_iteration)

    def model_costs(self) -> dict:
        with self._lock:
            return {k: dict(v) for k, v in self._model_costs.items()}

    # -- roofline join -------------------------------------------------------

    def peaks(self) -> tuple[float, float]:
        """(HBM GB/s, f32 TFLOP/s): the ones given, else the card's."""
        hbm, fp32 = self.hbm_peak_gbs, self.fp32_peak_tflops
        if hbm is None or fp32 is None:
            card = device_peaks()
            hbm = card["hbm_gbs"] if hbm is None else hbm
            fp32 = card["fp32_tflops"] if fp32 is None else fp32
        return float(hbm), float(fp32)

    def roofline(self, hbm_peak_gbs: float | None = None,
                 fp32_peak_tflops: float | None = None) -> dict:
        """The live per-kernel roofline table: one row per compile key
        joining the kernel records with the tracer's measured execute
        walls and the registered hand models."""
        if hbm_peak_gbs is None or fp32_peak_tflops is None:
            hbm, fp32 = self.peaks()
            hbm_peak_gbs = hbm if hbm_peak_gbs is None else hbm_peak_gbs
            fp32_peak_tflops = (fp32 if fp32_peak_tflops is None
                                else fp32_peak_tflops)
        walls = {render_key(k): v
                 for k, v in self._tracer.key_walls().items()}
        rows = roofline_rows(self.records(), walls, self.model_costs(),
                             hbm_peak_gbs=hbm_peak_gbs,
                             fp32_peak_tflops=fp32_peak_tflops)
        return {
            "time": time.time(),
            "hbm_peak_gbs": hbm_peak_gbs,
            "fp32_peak_tflops": fp32_peak_tflops,
            "compile_count": self.compile_count,
            "compile_wall_s": round(self.compile_wall_s, 4),
            "records": len(self._records),
            "dropped_records": self.dropped,
            "errors": self.errors,
            "rows": rows,
        }

    def publish_roofline(self) -> int:
        """Refresh the joined roofline as registry gauges
        (``xla_pct_of_hbm_peak{key=}`` / ``xla_pct_of_fp32_peak{key=}``
        / ``xla_achieved_gbs{key=}``). Returns rows published."""
        if not self._obs.enabled:
            return 0
        published = 0
        for row in self.roofline()["rows"]:
            if row["pct_of_hbm_peak"] is None:
                continue
            key = row["key"]
            self._obs.gauge("xla_pct_of_hbm_peak", key=key).set(
                row["pct_of_hbm_peak"])
            self._obs.gauge("xla_pct_of_fp32_peak", key=key).set(
                row["pct_of_fp32_peak"])
            self._obs.gauge("xla_achieved_gbs", key=key).set(
                row["achieved_gbs"])
            published += 1
        return published

    # -- device-memory telemetry --------------------------------------------

    def sample_device_memory(self, publish: bool = True,
                             live_tensors: bool = True) -> dict:
        """One sample of per-card memory state and, with
        ``live_tensors``, a dtype breakdown of the live CUDA tensors.

        Per card: ``bytes_in_use`` / ``peak_bytes_in_use`` (the caching
        allocator's ``allocated_bytes.all.current`` / ``.peak``),
        ``bytes_reserved`` (``reserved_bytes.all.current``) and
        ``bytes_limit`` (``mem_get_info``'s total). Without a card the
        one CPU entry reports ``stats: null`` and ``supported`` is False
        (no byte gauges). The live-tensor walk (``_live_cuda_tensors``)
        goes over every object ``gc`` tracks: a cold-path read for an
        explicit call, never the sampler's (``live_arrays`` is None
        without it)."""
        obs = self._obs if publish else None
        devices = []
        supported = False
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                ms = torch.cuda.memory_stats(i)
                _, total = torch.cuda.mem_get_info(i)
                stats = {
                    "bytes_in_use": int(ms.get("allocated_bytes.all.current",
                                               0)),
                    "peak_bytes_in_use": int(ms.get(
                        "allocated_bytes.all.peak", 0)),
                    "bytes_reserved": int(ms.get("reserved_bytes.all.current",
                                                 0)),
                    "bytes_limit": int(total),
                }
                supported = True
                label = f"cuda:{i}"
                devices.append({"device": label, "stats": stats})
                if obs is not None and obs.enabled:
                    for field in ("bytes_in_use", "peak_bytes_in_use",
                                  "bytes_limit"):
                        obs.gauge(f"device_{field}",
                                  device=label).set(stats[field])
        else:
            devices.append({"device": "cpu:0", "stats": None})
        live = _live_cuda_tensors() if live_tensors else None
        if live is not None and obs is not None and obs.enabled:
            obs.gauge("live_arrays_count").set(live["count"])
            obs.gauge("live_arrays_bytes").set(live["bytes"])
            for dt, agg in live["by_dtype"].items():
                obs.gauge("live_array_bytes", dtype=dt).set(agg["bytes"])
        return {
            "time": time.time(),
            "supported": supported,
            "devices": devices,
            "live_arrays": live,
        }

    # -- cadence -------------------------------------------------------------

    def _tick(self) -> None:
        self.sample_device_memory(live_tensors=False)
        self.publish_roofline()

    def start(self, interval_s: float = 1.0) -> "Introspector":
        """Run the device-memory sample and the roofline-gauge refresh
        every ``interval_s`` on a ``PeriodicTask``."""
        from large_scale_recommendation_tpu_torch.obs.health import (
            ensure_periodic,
        )

        self._task = ensure_periodic(self._task, self._tick,
                                     float(interval_s),
                                     name="obs-introspect")
        return self

    def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.stop()

    @property
    def running(self) -> bool:
        return self._task is not None and self._task.running

    def close(self) -> None:
        self.stop()


def _live_cuda_tensors() -> dict:
    """``{count, bytes, by_dtype}`` of the CUDA storages the live tensors
    hold (each storage once: views share it), by walking
    ``gc.get_objects()``. The walk holds a reference to every tracked
    object, and a tuple another thread is still building must not gain
    one (CPython resizes it in place only while it has one reference),
    so the switch interval is raised for the walk and the list is gone
    before it is lowered: other Python threads wait out the walk."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e3)
    try:
        by_dtype: dict[str, dict] = {}
        seen: set = set()
        objs = gc.get_objects()
        for obj in objs:
            # type(), not isinstance(): a proxy's __class__ may warn
            if not issubclass(type(obj), torch.Tensor) or not obj.is_cuda:
                continue
            storage = obj.untyped_storage()
            ident = (obj.device.index, storage.data_ptr())
            if ident in seen:
                continue
            seen.add(ident)
            agg = by_dtype.setdefault(str(obj.dtype).replace("torch.", ""),
                                      {"count": 0, "bytes": 0})
            agg["count"] += 1
            agg["bytes"] += int(storage.nbytes())
        objs = obj = None
    finally:
        sys.setswitchinterval(prev)
    return {"count": sum(a["count"] for a in by_dtype.values()),
            "bytes": sum(a["bytes"] for a in by_dtype.values()),
            "by_dtype": by_dtype}


def roofline_rows(records: list[dict], walls: dict, model_costs: dict,
                  *, hbm_peak_gbs: float,
                  fp32_peak_tflops: float) -> list[dict]:
    """The PURE join (the JAX package's, row for row): per compile key,
    pick the dominant record (max bytes), sum compile count/wall over
    the family, and price the per-execution wall:

    - ``wall_per_exec``   = execute_total_s / execute_count
    - ``achieved_gbs``    = bytes_accessed / wall_per_exec / 1e9
    - ``pct_of_hbm_peak`` = 100 · achieved_gbs / hbm_peak_gbs
    - ``achieved_tflops`` / ``pct_of_fp32_peak`` likewise from flops
    - ``xla_vs_model_bytes`` = bytes_accessed / (model bytes ×
      iterations-per-execution) — the hand-model cross-check
    - ``model_collective_bytes_per_exec`` = registered collective bytes ×
      iterations-per-execution (None for replicated kernels)
    """
    by_key: dict[str, list[dict]] = {}
    for rec in records:
        by_key.setdefault(rec["key"], []).append(rec)
    rows = []
    for key, recs in sorted(by_key.items()):
        dom = max(recs, key=lambda r: (r["bytes_accessed"], r["flops"]))
        compiles = sum(r["compiles"] for r in recs)
        compile_wall = sum(r["compile_wall_s"] for r in recs)
        w = walls.get(key) or {}
        n_exec = int(w.get("execute_count", 0))
        row: dict = {
            "key": key,
            "module": dom["module"],
            "modules": len(recs),
            "compiles": compiles,
            "compile_wall_s": round(compile_wall, 4),
            "xla_flops": dom["flops"],
            "xla_bytes_accessed": dom["bytes_accessed"],
            "memory": dom.get("memory"),
            "execute_count": n_exec,
            "wall_per_exec_s": None,
            "achieved_gbs": None,
            "achieved_tflops": None,
            "pct_of_hbm_peak": None,
            "pct_of_fp32_peak": None,
            "model_bytes_per_exec": None,
            "xla_vs_model_bytes": None,
            "model_collective_bytes_per_exec": None,
        }
        if n_exec > 0:
            wall = w["execute_total_s"] / n_exec
            if wall > 0 and math.isfinite(wall):
                row["wall_per_exec_s"] = wall
                row["achieved_gbs"] = dom["bytes_accessed"] / wall / 1e9
                row["achieved_tflops"] = dom["flops"] / wall / 1e12
                row["pct_of_hbm_peak"] = (
                    100.0 * row["achieved_gbs"] / hbm_peak_gbs)
                row["pct_of_fp32_peak"] = (
                    100.0 * row["achieved_tflops"] / fp32_peak_tflops)
            iters_per_exec = w.get("iterations", n_exec) / n_exec
            mc = model_costs.get(key)
            if mc and mc.get("bytes_per_iteration"):
                model_bytes = mc["bytes_per_iteration"] * iters_per_exec
                row["model_bytes_per_exec"] = model_bytes
                if model_bytes > 0:
                    row["xla_vs_model_bytes"] = (
                        dom["bytes_accessed"] / model_bytes)
            if mc and mc.get("collective_bytes_per_iteration"):
                row["model_collective_bytes_per_exec"] = (
                    mc["collective_bytes_per_iteration"] * iters_per_exec)
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# Profiler capture layer (the ONE torch.profiler entry point)
# --------------------------------------------------------------------------


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the process during the block with ``torch.profiler`` (the
    host ops of every thread — ``profile_all_threads`` — and, with a card,
    the CUDA kernels and copies, whatever thread launched them) and write
    its Chrome trace to ``log_dir/TRACE_FILE`` (Perfetto or
    ``chrome://tracing`` opens it). Yields the profiler
    (``key_averages()``, ``events()``). THE one capture layer:
    ``capture_profile`` and ``utils.metrics.profile`` run through this
    lock and accounting. Raises ``RuntimeError`` when a capture is
    already in flight."""
    global CAPTURE_COUNT, _PROFILER_READY
    if not _PROFILE_LOCK.acquire(blocking=False):
        raise RuntimeError("a torch profiler capture is already in progress")
    try:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        config = _ExperimentalConfig(profile_all_threads=True)
        with profile(activities=activities,
                     experimental_config=config) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
        CAPTURE_COUNT += 1
        _PROFILER_READY = True
        get_registry().counter("profiler_captures_total").inc()
    finally:
        _PROFILE_LOCK.release()


def warm_profiler() -> bool:
    """Initialize torch's profiler library (Kineto) on the main thread when
    no capture has run in this process yet; returns whether it did.
    Kineto initializes its client on the first capture and only on the
    thread that registered it (the main thread): a first capture on
    another thread (a ``/profilez`` handler, a trip on a scrape thread)
    records no host ops. ``ObsServer.start()`` and a recorder that
    profiles its trips call this; the first call pays the library's
    one-time start (about 1–2 s on a CPU host)."""
    global _PROFILER_READY
    if (_PROFILER_READY
            or threading.current_thread() is not threading.main_thread()):
        return False
    if not _PROFILE_LOCK.acquire(blocking=False):
        return False  # a capture in flight has initialized the library
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]):
            pass
        _PROFILER_READY = True
    finally:
        _PROFILE_LOCK.release()
    return True


def capture_profile(out_dir: str, seconds: float = 1.0) -> dict:
    """Record ``seconds`` of whatever the process is doing (the card's
    kernels and the host ops of every thread) into ``out_dir`` — the
    on-demand form behind ``/profilez`` and the watchdog-trip capture.
    Returns ``{dir, seconds, files}``."""
    seconds = max(0.0, float(seconds))
    with profile_trace(out_dir):
        time.sleep(seconds)
    files = sorted(
        os.path.relpath(os.path.join(root, name), out_dir)
        for root, _, names in os.walk(out_dir) for name in names)
    return {"dir": out_dir, "seconds": seconds, "files": files}


# --------------------------------------------------------------------------
# Module-level default: None (zero-cost), installed by obs.enable_introspection
# --------------------------------------------------------------------------

_INTROSPECTOR: Introspector | None = None


def get_introspector() -> Introspector | None:
    """The installed introspector or ``None`` — producer hooks resolve
    this, one ``is not None`` test."""
    return _INTROSPECTOR


def set_introspector(introspector: Introspector | None) -> None:
    global _INTROSPECTOR
    _INTROSPECTOR = introspector
