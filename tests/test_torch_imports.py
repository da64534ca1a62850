"""The PyTorch port stands alone: it imports neither JAX, nor ``ml_dtypes``
(a JAX dependency), nor the JAX package, and its entry points run on the
card unless asked for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "large_scale_recommendation_tpu_torch")


def _port_modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for m in ("core.types", "core.updaters", "core.initializers",
              "core.generators", "utils.shapes", "data.native",
              "data.blocking", "data.device_blocking", "data.movielens",
              "ops.sgd", "ops.cuda_sgd", "ops._build", "models.mf",
              "models.dsgd", "utils.device", "convert", "utils.metrics",
              "utils.checkpoint", "utils.config", "core.limiter",
              "ops.als", "models.als", "data.tables", "models.online",
              "obs.health", "parallel.serving", "serving",
              "serving.retrieval", "serving.admission", "serving.engine",
              "streams", "streams.log", "streams.sources", "streams.driver",
              "streams.parallel", "models.adaptive", "ps", "ps.core",
              "ps.server", "ps.transform", "ps.mf", "ps.adaptive",
              "models.pipeline", "store", "store.tiered",
              "store.prefetch", "parallel", "parallel.collectives",
              "parallel.distributed", "parallel.partitioner",
              "parallel.mesh", "parallel.dsgd_mesh", "parallel.als_mesh",
              "obs", "obs.registry", "obs.trace", "obs.events",
              "obs.instrument", "obs.transfers", "obs.introspect",
              "obs.quality", "obs.store", "obs.recorder", "obs.anomaly",
              "obs.server", "obs.fleet"):
        assert f"large_scale_recommendation_tpu_torch.{m}" in mods, m
    for src in ("dsgd_sweep.cu", "fastblock.cpp"):
        assert os.path.exists(os.path.join(PKG, "csrc", src))


def test_every_module_imports_with_jax_blocked():
    """In a fresh interpreter where ``import jax`` and ``import ml_dtypes``
    fail, every port module and chip_smoke import, and neither JAX nor the
    JAX package is loaded."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'large_scale_recommendation_tpu'"
        " or m.startswith('large_scale_recommendation_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", ["package", "chip_smoke.py"])
def test_ast_finds_no_jax_import(path):
    files = ([os.path.join(REPO, "chip_smoke.py")] if path != "package" else
             [os.path.join(r, f) for r, _, fs in os.walk(PKG) for f in fs
              if f.endswith(".py")])
    forbidden = ("jax", "jaxlib", "ml_dtypes",
                 "large_scale_recommendation_tpu")
    for f in files:
        tree = ast.parse(open(f).read(), f)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in forbidden, (f, n)


def test_parallel_exports_resolve_lazily():
    """The package imports no submodule until a name is touched (the JAX
    package's PEP 562 surface), and every exported name resolves."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import large_scale_recommendation_tpu_torch.parallel as par\n"
        "pre = 'large_scale_recommendation_tpu_torch.parallel.'\n"
        "assert not [m for m in sys.modules if m.startswith(pre)]\n"
        "for name in par.__all__:\n"
        "    getattr(par, name)\n"
        "assert set(par.__all__) <= set(dir(par))\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    import large_scale_recommendation_tpu.parallel as jpar
    import large_scale_recommendation_tpu_torch.parallel as par

    # the one JAX name without a counterpart: each rank is its own process
    assert set(jpar.__all__) - set(par.__all__) == {"shard_map"}


# the planes of the next slice (ROADMAP queue A, "Obs 6c") and the names the
# JAX obs package exports for them from elsewhere
SIX_C_MODULES = ("lineage", "disttrace", "requests", "budget", "contention",
                 "dataquality")
SIX_C_NAMES = {"DataQualityCheck", "enable_lineage", "enable_disttrace",
               "enable_requests", "enable_budget", "enable_contention"}


def _jax_packages():
    import large_scale_recommendation_tpu as jpkg

    root = os.path.dirname(jpkg.__file__)
    return sorted(
        "large_scale_recommendation_tpu" + (
            "." + os.path.relpath(r, root).replace(os.sep, ".")
            if r != root else "")
        for r, _, fs in os.walk(root) if "__init__.py" in fs)


def _exported(mod):
    """A package's exported names: its ``__all__``, else the public
    classes and functions its ``__init__`` binds from its own modules."""
    import types

    names = getattr(mod, "__all__", None)
    if names is not None:
        return list(names)
    pkg = mod.__name__.split(".")[0]
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and str(getattr(v, "__module__", "")).startswith(pkg)]


@pytest.mark.parametrize("jname", _jax_packages())
def test_package_exports_cover_the_jax_packages(jname):
    """Each package ``__init__`` of the port exports every name the JAX
    package's exports (obs: but for the next slice's planes)."""
    import importlib

    jmod = importlib.import_module(jname)
    pmod = importlib.import_module(
        jname.replace("large_scale_recommendation_tpu",
                      "large_scale_recommendation_tpu_torch", 1))
    missing = []
    for n in _exported(jmod):
        src = str(getattr(getattr(jmod, n), "__module__", ""))
        if (jname.endswith(".obs") and (
                n in SIX_C_NAMES
                or src.rsplit(".", 1)[-1] in SIX_C_MODULES)):
            continue
        if n == "shard_map":  # each rank is its own process (test above)
            continue
        if not hasattr(pmod, n):
            missing.append(n)
    assert not missing, missing
    port_all = getattr(pmod, "__all__", None)
    if port_all is not None:
        assert all(hasattr(pmod, n) for n in port_all)


def test_package_import_builds_nothing_and_touches_no_card():
    """Importing the package and its core exports builds no kernel
    library and initializes no CUDA context."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import torch\n"
        "import large_scale_recommendation_tpu_torch as p\n"
        "import large_scale_recommendation_tpu_torch.core as c\n"
        "from large_scale_recommendation_tpu_torch.ops import _build\n"
        "assert not _build._loaded, _build._loaded\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert p.RegularizedSGDUpdater is c.RegularizedSGDUpdater\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


def test_protocols_describe_the_ports_initializers_and_updaters():
    import typing

    from large_scale_recommendation_tpu_torch import core

    assert typing.get_type_hints(core.FactorInitializer)["rank"] is int
    for cls in (core.SGDUpdater, core.RegularizedSGDUpdater,
                core.MockFactorUpdater):
        for m in ("next_factors", "delta"):
            assert callable(getattr(cls, m)), (cls, m)
    init = core.PseudoRandomFactorInitializer(4)
    assert tuple(init(np.arange(3)).shape) == (3, init.rank)
    u = torch.ones(2, 4)
    nu, nv = core.MockFactorUpdater().next_factors(torch.ones(2), u, u)
    assert nu is u and nv is u


def test_default_device_is_the_card(monkeypatch):
    from large_scale_recommendation_tpu_torch import convert
    from large_scale_recommendation_tpu_torch.core.initializers import (
        PseudoRandomFactorInitializer,
    )
    from large_scale_recommendation_tpu_torch.models.adaptive import (
        AdaptiveMF,
    )
    from large_scale_recommendation_tpu_torch.models.als import ALS
    from large_scale_recommendation_tpu_torch.models.dsgd import (
        DSGD,
        DSGDConfig,
        resolve_device,
    )
    from large_scale_recommendation_tpu_torch.models.online import OnlineMF
    from large_scale_recommendation_tpu_torch.ops import als as als_ops
    from large_scale_recommendation_tpu_torch.parallel import (
        MeshALS,
        MeshDSGD,
        Partitioner,
    )
    from large_scale_recommendation_tpu_torch.ps.adaptive import (
        PSOnlineBatchMF,
    )
    from large_scale_recommendation_tpu_torch.ps.mf import PSOfflineMF
    from large_scale_recommendation_tpu_torch.serving import retrieval
    from large_scale_recommendation_tpu_torch.store import TieredFactorStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (lambda: DSGD(DSGDConfig()), ALS, OnlineMF,
                  lambda: als_ops.device_prepare_side([0], [0], [1.0], 1),
                  lambda: convert.online_from_jax(None),
                  AdaptiveMF, lambda: convert.adaptive_from_jax(None),
                  lambda: convert.quantized_catalog_from_jax(None),
                  lambda: retrieval.TwoStageRetriever(np.zeros((4, 2))),
                  lambda: retrieval.kmeans_fit(np.ones((4, 2), np.float32),
                                               2),
                  lambda: convert.factors_from_jax(np.zeros((2, 2),
                                                            np.float32),
                                                   np.zeros((2, 2),
                                                            np.float32)),
                  lambda: convert.model_from_jax(None, None, None, None),
                  lambda: convert.device_problem_from_jax(None),
                  PSOfflineMF, PSOnlineBatchMF,
                  lambda: TieredFactorStore(PseudoRandomFactorInitializer(2)),
                  lambda: convert.ps_offline_from_jax(None),
                  lambda: convert.tiered_store_from_jax(None),
                  Partitioner, MeshDSGD, MeshALS):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    with pytest.raises(RuntimeError):
        DSGD(DSGDConfig(), device="cuda")
    assert DSGD(DSGDConfig(), device="cpu").device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_refuse_mixed_devices():
    """A wrapper takes its plain version only when every tensor is on the
    CPU; a tensor elsewhere is an error, never a silent CPU route."""
    from large_scale_recommendation_tpu_torch.ops import cuda_sgd

    cpu = torch.zeros(2)
    meta = torch.zeros(2, device="meta")
    assert cuda_sgd._on_cuda(cpu, cpu) is False
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_sgd._on_cuda(cpu, meta)
