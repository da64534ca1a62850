"""The benchmark's machinery, shared by every cell: the cell's files found
by name, the device checks, the measured window's bookkeeping, the result
line and the guard that the JAX package was never loaded.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its configuration
is ``portbench/configs/<config>.json``; its traffic mix is the data file
``portbench/traffic/<traffic>.json``, whose ``generator`` key names the
general generator ``portbench/generators/<name>.py`` that reads it; each
of its per-layer metrics is a reader ``portbench/metrics/<metric>.py``.
Nothing here names a cell, a mix or a metric: a new one is a new file and
a new entry.

The generator module has these functions:

- ``setup(ctx)`` builds the inputs from ``ctx.seed`` and the system under
  test, warms every shape the window uses, and returns the generator's state;
- ``window(ctx, state)`` runs the measured window until ``ctx.deadline``
  and returns the end-to-end metrics (a dict of name → value);
- ``check(ctx, state)`` runs once the window has closed and the device
  memory peak was read: it frees the program's state, runs the plain
  reference and returns a list of ``(name, value, limit)``, each a number
  that must not exceed its limit.

With ``--trace 1`` its ``traced(ctx, state)`` runs a short tail of
the same work under the profiler (``portbench/trace.py``) after the window.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "portbench")
# module top-level names that may never be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "large_scale_recommendation_tpu")
# caches of the program's build tools, inside the checkout at fixed paths
CACHE_DIR = os.path.join(ROOT, ".portbench_cache")


class BenchError(RuntimeError):
    """A run that cannot produce a result (no card, a missing file)."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the file at ``path`` as a fresh module called ``name``."""
    if not os.path.exists(path):
        raise BenchError(f"no file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def safe(name: str) -> str:
    return "portbench_" + "".join(c if c.isalnum() else "_" for c in name)


@dataclasses.dataclass
class Cell:
    """One workload with everything found for it by name."""

    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list
    spec: dict
    limits: dict

    def limit(self, name: str) -> float:
        """The limit of a compared number (``portbench/limits/<cell>.json``,
        set from the readings that ``PERF.md`` gives)."""
        if name not in self.limits:
            raise BenchError(f"no limit for {name!r} of {self.name}")
        return float(self.limits[name])

    def generator(self):
        name = self.mix["generator"]
        return load_module(
            os.path.join(BENCH_DIR, "generators", name + ".py"),
            safe("generator_" + name))


def _reports(metric: dict, cell: str, cell_e2e: set | None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if cell_e2e is not None and metric.get("moves") is not None:
        return metric["moves"] in cell_e2e
    return True


def resolve(workload: str, spec: dict | None = None) -> Cell:
    """The cell named ``workload`` of ``BENCHMARK.json`` with its files."""
    spec = spec or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json; "
                         f"have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(os.path.join(ROOT, cfg_entry["file"]))
    mix = load_json(os.path.join(BENCH_DIR, "traffic",
                                 w["traffic"] + ".json"))
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, workload, names)]
    limits = load_json(os.path.join(BENCH_DIR, "limits", workload + ".json"))
    limits = limits["limits"]
    return Cell(name=workload, config=config, mix=mix, chips=int(w["chips"]),
                end_to_end=e2e, per_layer=per_layer, spec=w, limits=limits)


def check_devices(chips: int):
    """The card(s) the cell asks for, or ``BenchError``: there is no
    fallback to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: this benchmark measures the card "
                         "and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} CUDA devices, found "
                         f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that the run may not load,
    compared whole (the port's own name only begins with the JAX
    package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def pin_caches(env=os.environ) -> None:
    """Keep every kernel cache a library might write inside the checkout,
    at fixed paths (the program's own nvcc builds already live in its
    package's ``build/``), and Python's bytecode cache with them: where
    the installed packages carry no bytecode of their own, or may not
    write it, every process would compile torch's ~700 modules again.
    Call before anything imports torch."""
    for key, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        env[key] = os.path.join(CACHE_DIR, sub)
    sys.pycache_prefix = os.path.join(CACHE_DIR, "pyc")
    sys.dont_write_bytecode = False


class Spans:
    """The harness's own spans around its calls into the program: name,
    host start and end (``time.perf_counter``), and per-name counters."""

    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []
        self.counters: dict[str, float] = {}

    def add(self, name: str, t0: float, t1: float) -> None:
        self.spans.append((name, t0, t1))

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def walls(self, name: str) -> list[float]:
        return [b - a for n, a, b in self.spans if n == name]


@dataclasses.dataclass
class Context:
    """What a generator and a metric reader are handed."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    spans: Spans = dataclasses.field(default_factory=Spans)
    deadline: float = math.inf
    t_start: float = 0.0  # the process's start, as ``setup_s`` counts it
    # set-up's phases: name → seconds from ``t_start`` at its end
    phases: dict = dataclasses.field(default_factory=dict)
    # filled by the generators for the readers: counts from the reference,
    # the window's tallies, the traced tail's profile
    facts: dict = dataclasses.field(default_factory=dict)
    profile: object = None  # trace.Profile of the traced tail

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix

    def mark(self, phase: str) -> None:
        """Note the end of a phase of set-up (printed before the result)."""
        self.phases[phase] = time.perf_counter() - self.t_start

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0–100) by linear interpolation, as
    ``numpy.percentile``'s default."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def device_info(device, trace_profile=None) -> dict:
    import torch

    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(
                    torch.cuda.max_memory_allocated(device))}
    if trace_profile is not None:
        info["busy_s"] = trace_profile.busy_s
        info["window_s"] = trace_profile.window_s
    return info


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, spec: dict | None = None,
             t_start: float | None = None,
             config_override: dict | None = None,
             mix_override: dict | None = None, log=sys.stderr) -> dict:
    """One run of one cell: set-up, the window, (the traced tail), the
    memory peak, the check; returns the result object of the last line.
    ``device`` replaces the look for a card (the CPU tests drive a run at
    a tiny ``config_override`` and ``mix_override`` this way, and the
    readings of ``portbench/readings.py`` their controls)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = resolve(workload, spec)
    if config_override is not None:
        cell.config = {**cell.config, **config_override}
    if mix_override is not None:
        cell.mix = {**cell.mix, **mix_override}
    if device is None:
        device = check_devices(cell.chips)
    else:
        import torch

        device = torch.device(device)
    gen = cell.generator()
    ctx = Context(cell=cell, seed=int(seed), seconds=float(seconds),
                  trace=bool(trace), device=device, t_start=t_start)
    ctx.mark("devices")
    state = gen.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    ctx.mark("setup")
    print("setup phases: " + json.dumps(
        {k: round(v, 4) for k, v in ctx.phases.items()}), file=log,
        flush=True)
    ctx.deadline = time.perf_counter() + ctx.seconds
    e2e = gen.window(ctx, state)
    ctx.sync()
    e2e["setup_s"] = setup_s
    if trace:
        from portbench import trace as trace_mod

        ctx.profile = trace_mod.capture(ctx, lambda: gen.traced(ctx, state))
        print(json.dumps({"profiler": ctx.profile.edges}), flush=True)
    info = device_info(device, ctx.profile)
    compared = gen.check(ctx, state)
    del state
    attempted = int(ctx.facts.get("attempted", 0))
    failed = int(ctx.facts.get("failed", 0))
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in compared)
    correct = correct and failed == 0
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            reader = load_module(
                os.path.join(BENCH_DIR, "metrics", m["name"] + ".py"),
                safe("metric_" + m["name"]))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": units[m["name"]]}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": info}
    if trace and ctx.profile is not None:
        result["breakdown"] = ctx.profile.breakdown
    result["compared"] = {name: {"value": float(v), "limit": float(lim)}
                          for name, v, lim in compared}
    for name, v, lim in compared:
        print(f"compared {name} = {v!r} (limit {lim!r})", file=log)
    return result
