"""Build and load the port's CUDA source (``csrc/<name>.cu``) as a plain-C
shared library bound with ctypes.

The source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a
-shared -Xcompiler -fPIC`` into ``<package>/build/`` (listed in
``.gitignore``) at first use, and again whenever the source is newer than
its library. There is no fallback: a missing ``nvcc`` or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
nvcc_output = ""  # the last build's nvcc output (ptxas register use)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build from csrc/ at first use and "
        "need the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing or stale, and
    load it."""
    global nvcc_output
    if name in _loaded:
        return _loaded[name]
    src = os.path.join(CSRC, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    if not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src):
        os.makedirs(BUILD_DIR, exist_ok=True)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", lib, src],
                              capture_output=True, text=True, check=False)
        nvcc_output = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu (exit "
                               f"{proc.returncode}):\n{nvcc_output[-4000:]}")
    _loaded[name] = ctypes.CDLL(lib)
    return _loaded[name]
