"""Build and load the port's native sources (``csrc/<name>.cu`` or
``csrc/<name>.cpp``) as plain-C shared libraries bound with ctypes.

A ``.cu`` source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a
-shared -Xcompiler -fPIC``, a ``.cpp`` source with ``g++ -O3 -shared -fPIC
-std=c++17``, into ``<package>/build/`` (listed in ``.gitignore``) at first
use, and again whenever the source is newer than its library. The library is
written under a temporary name (process and thread id) and renamed into
place, so processes that build it at the same time never load a
half-written file. Within a process, a lock per library (``lock(name)``)
serializes its whole check → build → load sequence, so threads that make
first use of a library at once get one build and one ``CDLL``, while two
libraries still build side by side. There is no fallback: a missing
compiler or a failed build raises with the compiler's last lines.

Each build or load is recorded in ``loads`` (per library: its wall and
whether it compiled; two clock reads per library and process) and, when
``obs.Tracer.install_build_hook`` has set a hook, reported to it;
``LibraryWatch`` exposes a library's count to the transfer ledger's
retrace watch (a rebuild or reload after warmup is the port's counterpart
of a retrace).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCKS_GUARD = threading.Lock()
_locks: dict[str, threading.RLock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # each build's compiler output, by name
# per library, (seconds, built) of each build or load in this process
loads: dict[str, list[tuple[float, bool]]] = {}
# hook(library, seconds, built) called after each build or load (set by
# obs.Tracer.install_build_hook)
_build_hook = None


def set_build_hook(hook) -> None:
    """Install ``hook(library, seconds, built)`` (``None`` removes it)."""
    global _build_hook
    _build_hook = hook


class LibraryWatch:
    """A library's build and load count as ``_cache_size()``, the protocol
    ``obs.transfers.TransferLedger.watch`` polls."""

    def __init__(self, name: str):
        self.name = name

    def _cache_size(self) -> int:
        return len(loads.get(self.name, ()))


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


def lock(name: str) -> threading.RLock:
    """The lock held around library ``name``'s check → build → load
    (re-entrant: the bound-library caches of ``ops.cuda_sgd`` and
    ``data.native`` hold it around their signature setup too)."""
    with _LOCKS_GUARD:
        return _locks.setdefault(name, threading.RLock())


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cpp`` (g++) if its
    library is missing or stale, and load it. Safe to call from several
    threads and processes at once."""
    with lock(name):
        if name not in _loaded:
            t0 = time.perf_counter()
            path, built = _build(name)
            _loaded[name] = ctypes.CDLL(path)
            wall = time.perf_counter() - t0
            with _LOCKS_GUARD:  # atomic with set_build_hook's replay
                loads.setdefault(name, []).append((wall, built))
                hook = _build_hook
            if hook is not None:
                hook(name, wall, built)
        return _loaded[name]


def _build(name: str) -> tuple[str, bool]:
    """The library's path, built first if it is missing or stale, and
    whether it was built."""
    cu, cpp = (os.path.join(CSRC, f"{name}{ext}") for ext in (".cu", ".cpp"))
    src = cu if os.path.exists(cu) else cpp
    if not os.path.exists(src):
        raise FileNotFoundError(f"no {cu} or {cpp}")
    lib = library_path(name)
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib, False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
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
    return lib, True
