"""Build and load the port's native sources (``csrc/<name>.cu`` or
``csrc/<name>.cpp``) as plain-C shared libraries bound with ctypes.

A ``.cu`` source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a
-shared -Xcompiler -fPIC``, a ``.cpp`` source with ``g++ -O3 -shared -fPIC
-std=c++17``, into ``<package>/build/`` (listed in ``.gitignore``) at first
use, and again whenever the source is newer than its library. The library is
written under a temporary name and renamed into place, so processes that
build it at the same time never load a half-written file. There is no
fallback: a missing compiler or a failed build raises with the compiler's
last lines.
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
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # each build's compiler output, by name


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


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the host library builds from csrc/ "
                       "at first use and needs a C++17 compiler on PATH")


def library_path(name: str) -> str:
    """Where ``load_library(name)`` builds and loads its library."""
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cpp`` (g++) if its
    library is missing or stale, and load it."""
    if name in _loaded:
        return _loaded[name]
    cu, cpp = (os.path.join(CSRC, f"{name}{ext}") for ext in (".cu", ".cpp"))
    src = cu if os.path.exists(cu) else cpp
    if not os.path.exists(src):
        raise FileNotFoundError(f"no {cu} or {cpp}")
    lib = library_path(name)
    if not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = ([_nvcc(), *NVCC_FLAGS] if src == cu else [_gxx(), *GXX_FLAGS])
        try:
            proc = subprocess.run([*cmd, "-o", tmp, src], capture_output=True,
                                  text=True, check=False)
            build_log[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{os.path.basename(cmd[0])} failed for "
                    f"{os.path.basename(src)} (exit {proc.returncode}):\n"
                    f"{build_log[name][-4000:]}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    _loaded[name] = ctypes.CDLL(lib)
    return _loaded[name]
