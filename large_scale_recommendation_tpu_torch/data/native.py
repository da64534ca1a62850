"""Host-side ingest and blocking primitives (counterpart of
``large_scale_recommendation_tpu.data.native``).

Each entry point runs the port's own native library, ``csrc/fastblock.cpp``,
which g++ builds into the package's ``build/`` at first use
(``ops._build.load_library``). There is no silent fallback: a failed build
or load raises with the compiler's last lines. The numpy versions are the
plain versions the native routes are held to, reachable as
``<name>_reference``; both give the same arrays bit for bit:

- ``parse_ratings_file``: (user, item, rating[, ...]) text → COO arrays;
- ``compact_ids``: unique ids in first-seen order, inverse indices and
  occurrence counts (the omegas);
- ``stable_bucket``: a permutation stably grouped by a small key;
- ``minibatch_inv_counts_flat``: the "mean" collision scales.

``native_available()`` / ``native_build_error()`` report the build's state
(as the JAX package's do) without changing it into a fallback: they try
the build and say whether it loaded, or why not, and every entry point
still raises on a failed build.
"""

from __future__ import annotations

import ctypes
import os
import warnings

import numpy as np

from large_scale_recommendation_tpu_torch.ops import _build

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


_LIB = "fastblock"
_bound: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The built library with every entry point's signature declared (the
    first call from any thread builds it, under the library's build
    lock)."""
    global _bound
    if _bound is not None:
        return _bound
    with _build.lock(_LIB):
        if _bound is None:
            lib = _build.load_library(_LIB)
            lib.fb_parse_ratings.restype = ctypes.c_int64
            lib.fb_parse_ratings.argtypes = [
                ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
                ctypes.POINTER(_I64P), ctypes.POINTER(_I64P),
                ctypes.POINTER(_F32P)]
            lib.fb_compact_ids.restype = ctypes.c_int64
            lib.fb_compact_ids.argtypes = [_I64P, ctypes.c_int64, _I64P,
                                           ctypes.POINTER(_I64P),
                                           ctypes.POINTER(_I64P)]
            lib.fb_stable_bucket.restype = None
            lib.fb_stable_bucket.argtypes = [_I64P, _I64P, ctypes.c_int64,
                                             ctypes.c_int64, _I64P]
            lib.fb_minibatch_inv_counts.restype = None
            lib.fb_minibatch_inv_counts.argtypes = [
                _I32P, _F32P, ctypes.c_int64, ctypes.c_int64, _F32P]
            lib.fb_free.restype = None
            lib.fb_free.argtypes = [ctypes.c_void_p]
            _bound = lib
    return _bound


def native_build_error() -> str | None:
    """The error of building or loading the library (building it now if
    no call has), or ``None`` when it loads. A report only: the entry
    points raise that error themselves."""
    try:
        _lib()
    except (RuntimeError, OSError) as e:  # FileNotFoundError is an OSError
        return f"{type(e).__name__}: {e}"
    return None


def native_available() -> bool:
    """Whether the native library builds and loads."""
    return native_build_error() is None


def _take(lib, ptr, n: int, dtype) -> np.ndarray:
    """Copy a malloc'd C buffer of ``n`` elements into numpy and free it."""
    try:
        if n == 0:
            return np.empty(0, dtype=dtype)
        return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)
    finally:
        lib.fb_free(ptr)


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


# -- parse_ratings_file -------------------------------------------------------


def _check_parse_args(path: str, delimiter: str) -> None:
    if len(delimiter.encode()) != 1:
        raise ValueError(f"delimiter must be one byte, got {delimiter!r}")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)


def parse_ratings_file(path: str, delimiter: str = ",", skip_header: int = 0
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse (user, item, rating[, ...]) text into COO arrays (int64 ids,
    float32 ratings) in one native pass. Lines with fewer than three fields
    are skipped; ``skip_header`` leading lines are dropped."""
    _check_parse_args(path, delimiter)
    lib = _lib()
    up, ip, vp = _I64P(), _I64P(), _F32P()
    n = lib.fb_parse_ratings(os.fsencode(path), delimiter.encode(),
                             int(skip_header), ctypes.byref(up),
                             ctypes.byref(ip), ctypes.byref(vp))
    if n < 0:
        raise FileNotFoundError(path)
    return (_take(lib, up, n, np.int64), _take(lib, ip, n, np.int64),
            _take(lib, vp, n, np.float32))


def parse_ratings_file_reference(path: str, delimiter: str = ",",
                                 skip_header: int = 0
                                 ) -> tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """The plain version of ``parse_ratings_file`` (numpy's text reader)."""
    _check_parse_args(path, delimiter)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # an empty file
        data = np.loadtxt(path, delimiter=delimiter, skiprows=skip_header,
                          usecols=(0, 1, 2), ndmin=2, dtype=np.float64)
    return (data[:, 0].astype(np.int64), data[:, 1].astype(np.int64),
            data[:, 2].astype(np.float32))


# -- compact_ids --------------------------------------------------------------


def compact_ids(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense first-seen-order compaction in one native hash pass.

    Returns (unique_ids, inverse_indices, counts), all int64: ``counts`` are
    the per-id occurrence counts (the omegas)."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    lib = _lib()
    idx = np.empty(len(ids), dtype=np.int64)
    up, cp = _I64P(), _I64P()
    m = lib.fb_compact_ids(_ptr(ids, _I64P), len(ids), _ptr(idx, _I64P),
                           ctypes.byref(up), ctypes.byref(cp))
    return _take(lib, up, m, np.int64), idx, _take(lib, cp, m, np.int64)


def compact_ids_reference(ids: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The plain version of ``compact_ids``: ``np.unique`` (sorted order),
    remapped to first-seen order so both routes give the same dense ids."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    uniq, first, inverse, counts = np.unique(
        ids, return_index=True, return_inverse=True, return_counts=True)
    order = np.argsort(first, kind="stable")
    dense = np.empty(len(order), dtype=np.int64)
    dense[order] = np.arange(len(order), dtype=np.int64)
    return (uniq[order], dense[inverse.reshape(-1)],
            counts[order].astype(np.int64))


# -- stable_bucket ------------------------------------------------------------


def _bucket_args(keys, perm, num_keys):
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    if len(keys) and (keys.min() < 0 or keys.max() >= num_keys):
        # the native pass indexes a counter array by key
        raise ValueError(
            f"stable_bucket keys outside [0, {num_keys}): "
            f"min={keys.min()} max={keys.max()}")
    if len(perm) and (perm.min() < 0 or perm.max() >= len(keys)):
        raise ValueError(f"stable_bucket perm outside [0, {len(keys)})")
    return keys, perm


def stable_bucket(keys: np.ndarray, perm: np.ndarray,
                  num_keys: int) -> np.ndarray:
    """Order indices: ``perm`` stably grouped by ``keys[perm]`` (a native
    two-pass counting sort; keys are block ids, so ``num_keys`` is small)."""
    keys, perm = _bucket_args(keys, perm, num_keys)
    out = np.empty(len(perm), dtype=np.int64)
    _lib().fb_stable_bucket(_ptr(keys, _I64P), _ptr(perm, _I64P), len(perm),
                            int(num_keys), _ptr(out, _I64P))
    return out


def stable_bucket_reference(keys: np.ndarray, perm: np.ndarray,
                            num_keys: int) -> np.ndarray:
    """The plain version of ``stable_bucket``."""
    keys, perm = _bucket_args(keys, perm, num_keys)
    return perm[np.argsort(keys[perm], kind="stable")]


# -- minibatch_inv_counts_flat ------------------------------------------------


def _inv_counts_args(rows, weights, minibatch):
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    if rows.shape != weights.shape or rows.ndim != 1:
        raise ValueError(f"rows {rows.shape} and weights {weights.shape} "
                         "must be 1-D of one length")
    if minibatch < 1:
        raise ValueError(f"minibatch must be ≥ 1, got {minibatch}")
    return rows, weights


def minibatch_inv_counts_flat(rows: np.ndarray, weights: np.ndarray,
                              minibatch: int) -> np.ndarray:
    """Per-entry 1/(occurrences of rows[j] in its minibatch chunk); weight-0
    entries get 1.0 and don't count. One native pass."""
    rows, weights = _inv_counts_args(rows, weights, minibatch)
    out = np.empty(len(rows), dtype=np.float32)
    _lib().fb_minibatch_inv_counts(_ptr(rows, _I32P), _ptr(weights, _F32P),
                                   len(rows), int(minibatch),
                                   _ptr(out, _F32P))
    return out


def minibatch_inv_counts_flat_reference(rows: np.ndarray, weights: np.ndarray,
                                        minibatch: int) -> np.ndarray:
    """The plain version of ``minibatch_inv_counts_flat`` (an
    O(n log n) ``np.unique``)."""
    rows, weights = _inv_counts_args(rows, weights, minibatch)
    flat = rows.astype(np.int64)
    chunk = np.arange(flat.size, dtype=np.int64) // minibatch
    w = weights > 0
    key = chunk * (int(flat.max(initial=0)) + 2) + flat
    key = np.where(w, key, -1)
    _, inverse, counts = np.unique(key, return_inverse=True,
                                   return_counts=True)
    inv = (1.0 / counts[inverse.reshape(-1)]).astype(np.float32)
    return np.where(w, inv, 1.0).astype(np.float32)
