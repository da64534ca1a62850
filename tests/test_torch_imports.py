"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked for the CPU."""

import ast
import os
import subprocess
import sys

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
              "data.blocking", "data.movielens", "ops.sgd", "ops.cuda_sgd",
              "ops._build", "models.mf", "models.dsgd", "convert"):
        assert f"large_scale_recommendation_tpu_torch.{m}" in mods, m
    assert os.path.exists(os.path.join(PKG, "csrc", "dsgd_sweep.cu"))


def test_every_module_imports_with_jax_blocked():
    """In a fresh interpreter where ``import jax`` fails, every port module
    and chip_smoke import, and neither JAX nor the JAX package is loaded."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
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
    forbidden = ("jax", "jaxlib", "large_scale_recommendation_tpu")
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


def test_default_device_is_the_card(monkeypatch):
    from large_scale_recommendation_tpu_torch.models.dsgd import (
        DSGD,
        DSGDConfig,
        resolve_device,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DSGD(DSGDConfig())
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
