"""What a run may not do: fall back to the CPU, load JAX or the JAX
package, or (in the reference) use anything of the program."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.BENCH_DIR
PORT = "large_scale_recommendation_tpu_torch"


def _sources(top):
    for base, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _imported(path):
    """Top-level names of every module a file imports."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".", 1)[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        found = set(_imported(path)) & set(harness.FORBIDDEN_MODULES)
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(BENCH, "reference")):
        assert PORT not in set(_imported(path)), path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + "_fake_probe", sys)
    assert "large_scale_recommendation_tpu" not in harness.loaded_forbidden()


def _run(cwd, env=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})}
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "ml25m_r128.dsgd_fit", "--seed", "4294967301", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    if not lines:
        return True
    try:
        json.loads(lines[-1])
    except ValueError:
        return True
    return False


def test_run_without_a_card_fails_and_prints_no_result():
    proc = _run(harness.ROOT)
    assert proc.returncode != 0
    assert _no_result(proc)
    assert "no CUDA device" in proc.stderr


def test_run_in_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(str(tmp_path))
    assert proc.returncode != 0
    assert _no_result(proc)


def test_run_loads_no_forbidden_module():
    """A whole run's imports, at a tiny size on the CPU, in a fresh
    process: nothing of JAX or the JAX package."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "from portbench.tests.tiny import TINY\n"
        "harness.run_cell('ml25m_r128.dsgd_fit', 7, 0.2, False, "
        "device='cpu', **TINY['ml25m_r128.dsgd_fit'])\n"
        "print(harness.loaded_forbidden())\n" % harness.ROOT)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_run_on_the_card_prints_a_result(tmp_path):
    """On a machine with a card: one short run of the first cell prints a
    result line with its compared numbers."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "ml25m_r128.dsgd_fit", "--seed", "4294967302", "--seconds", "2",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "compared"
