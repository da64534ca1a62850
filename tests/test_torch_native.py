"""The port's native host library (``data/native.py`` over its own
``csrc/fastblock.cpp``): each native route is bit-equal to its numpy plain
version and to the JAX package's ``data.native`` (whose library loads here),
on edge cases too; the library is the port's own, built under its
``build/``; a failed build raises with the compiler's output."""

import os

import numpy as np
import pytest

from large_scale_recommendation_tpu.core.types import Ratings as JRatings
from large_scale_recommendation_tpu.data import blocking as jblk
from large_scale_recommendation_tpu.data import native as jnative
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.data import blocking
from large_scale_recommendation_tpu_torch.data import native
from large_scale_recommendation_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_library_is_the_ports_own():
    native.compact_ids(np.array([1, 2]))
    path = _build.library_path("fastblock")
    assert path == os.path.join(REPO, "large_scale_recommendation_tpu_torch",
                                "build", "libfastblock.so")
    assert os.path.exists(path)
    assert jnative.native_available()  # the JAX reference side is native too
    assert os.path.realpath(path) != os.path.realpath(jnative._SO)


_IDS = {
    "empty": np.zeros(0, np.int64),
    "one": np.array([7]),
    "first_seen": np.array([5, 3, 5, 9]),
    "negative_and_big": np.array([-4, 2**40, -4, 0, 2**40 + 1, 0]),
    "skewed": np.random.default_rng(0).zipf(1.5, 5000) % 997 * 13 + 1,
}


@pytest.mark.parametrize("name", sorted(_IDS))
def test_compact_ids(name):
    ids = _IDS[name]
    got = native.compact_ids(ids)
    _same(got, native.compact_ids_reference(ids))
    _same(got, jnative.compact_ids(ids))
    uniq, inv, counts = got
    np.testing.assert_array_equal(uniq[inv], ids)
    assert counts.sum() == len(ids)
    if name == "first_seen":
        assert uniq.tolist() == [5, 3, 9]


@pytest.mark.parametrize("n,num_keys", [(0, 4), (1, 1), (5000, 16),
                                        (777, 64)])
def test_stable_bucket(n, num_keys):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, num_keys, n)
    perm = rng.permutation(n)
    got = native.stable_bucket(keys, perm, num_keys)
    _same([got], [native.stable_bucket_reference(keys, perm, num_keys)])
    _same([got], [jnative.stable_bucket(keys, perm, num_keys)])


@pytest.mark.parametrize("n,mb,pad", [(0, 8, 0.0), (1, 1, 0.0),
                                      (20_000, 64, 0.1), (3001, 512, 0.5)])
def test_minibatch_inv_counts_flat(n, mb, pad):
    rng = np.random.default_rng(n + mb)
    rows = rng.integers(0, max(n // 20, 1), n).astype(np.int32)
    w = (rng.random(n) >= pad).astype(np.float32)
    got = native.minibatch_inv_counts_flat(rows, w, mb)
    _same([got], [native.minibatch_inv_counts_flat_reference(rows, w, mb)])
    _same([got], [jnative.minibatch_inv_counts_flat(rows, w, mb)])
    assert (got[w == 0] == 1.0).all()


_FILES = {
    "tsv": ("1\t10\t4.5\t881250949\n2\t20\t3.0\t881250950\n1\t20\t1\t0\n",
            "\t", 0),
    "csv_header": ("userId,movieId,rating,timestamp\n1,296,5.0,1147880044\n"
                   "1,306,3.5,1147868817\n3,296,0.5,1\n", ",", 1),
    "no_trailing_newline": ("4,5,2.5,9\n6,7,3.5,9", ",", 0),
    "three_fields": ("9\t8\t1.5\n10\t8\t2.0\n", "\t", 0),
    "empty": ("", ",", 0),
    "header_only": ("userId,movieId,rating,timestamp\n", ",", 1),
}


@pytest.mark.parametrize("name", sorted(_FILES))
def test_parse_ratings_file(tmp_path, name):
    text, delim, skip = _FILES[name]
    path = tmp_path / "ratings.txt"
    path.write_text(text)
    got = native.parse_ratings_file(str(path), delim, skip)
    _same(got, native.parse_ratings_file_reference(str(path), delim, skip))
    _same(got, jnative.parse_ratings_file(str(path), delim, skip))
    assert got[0].dtype == np.int64 and got[2].dtype == np.float32
    if name == "no_trailing_newline":
        assert got[0].tolist() == [4, 6] and got[2].tolist() == [2.5, 3.5]


@pytest.mark.parametrize("fn", [native.parse_ratings_file,
                                native.parse_ratings_file_reference])
def test_missing_file_raises(tmp_path, fn):
    with pytest.raises(FileNotFoundError):
        fn(str(tmp_path / "absent.csv"))
    with pytest.raises(ValueError, match="one byte"):
        fn(str(tmp_path / "absent.csv"), delimiter="::")


def test_operands_are_checked_before_the_native_call():
    for fn in (native.stable_bucket, native.stable_bucket_reference):
        with pytest.raises(ValueError, match="keys outside"):
            fn(np.array([0, 4]), np.array([0, 1]), 4)
        with pytest.raises(ValueError, match="perm outside"):
            fn(np.array([0, 1]), np.array([0, 2]), 4)
    for fn in (native.minibatch_inv_counts_flat,
               native.minibatch_inv_counts_flat_reference):
        with pytest.raises(ValueError, match="minibatch"):
            fn(np.zeros(4, np.int32), np.ones(4, np.float32), 0)
        with pytest.raises(ValueError, match="one length"):
            fn(np.zeros(4, np.int32), np.ones(3, np.float32), 2)


@pytest.mark.parametrize("k,mb,sort", [(1, 64, None), (3, 32, "user"),
                                       (4, 128, "item")])
def test_block_problem_native_equals_numpy_and_jax(k, mb, sort):
    rng = np.random.default_rng(k)
    n = 4000
    ru = rng.zipf(1.6, n) % 300 * 3 + 11
    ri = rng.zipf(1.4, n) % 200 * 7 + 5
    rv = rng.normal(3, 1, n).astype(np.float32)
    tr = Ratings.from_arrays(ru, ri, rv).pad_to(n + 17)
    kw = dict(num_blocks=k, seed=2, minibatch_multiple=mb,
              minibatch_sort=sort)
    pn = blocking.block_problem(tr, **kw)
    pp = blocking.block_problem(tr, **kw, native=False)
    pj = jblk.block_problem(JRatings.from_arrays(ru, ri, rv).pad_to(n + 17),
                            **kw)
    for p in (pp, pj):
        for side in ("users", "items"):
            for f in ("ids", "omega", "sorted_ids", "sorted_rows"):
                _same([getattr(getattr(pn, side), f)],
                      [getattr(getattr(p, side), f)])
        for f in ("u_rows", "i_rows", "values", "weights"):
            _same([getattr(pn.ratings, f)], [getattr(p.ratings, f)])
    _same(blocking.minibatch_inv_counts(pn.ratings, mb),
          blocking.minibatch_inv_counts(pn.ratings, mb, native=False))


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken_unit.cpp").write_text(
        'extern "C" int f() { return undeclared_name; }\n')
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="undeclared_name"):
        _build.load_library("broken_unit")
    assert not os.path.exists(tmp_path / "build" / "libbroken_unit.so")
    with pytest.raises(FileNotFoundError):
        _build.load_library("no_such_source")


def test_a_stale_library_is_rebuilt(tmp_path, monkeypatch):
    src = tmp_path / "two_ints.cpp"
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    lib = tmp_path / "build" / "libtwo_ints.so"
    src.write_text('extern "C" int f() { return 1; }\n')
    assert _build.load_library("two_ints").f() == 1
    _build._loaded.pop("two_ints")
    src.write_text('extern "C" int f() { return 2; }\n')
    os.utime(lib, (1, 1))  # the library is now older than its source
    _build.load_library("two_ints")  # (dlopen keeps the old code mapped)
    assert os.path.getmtime(lib) > 1
    _build._loaded.pop("two_ints")


def test_threads_making_first_use_get_one_build_and_one_load(tmp_path,
                                                              monkeypatch):
    """Eight threads make first use of ``fastblock`` at once (a consumer
    thread and a background retrain can): one compiler run, one ``CDLL``,
    and every thread gets that library, without an exception."""
    import ctypes
    import threading

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(native, "_bound", None)
    builds, loads = [], []
    real_run, real_cdll = _build.subprocess.run, ctypes.CDLL

    def counted_run(cmd, **kw):
        builds.append(cmd[-1])
        return real_run(cmd, **kw)

    def counted_cdll(path, *a, **kw):
        loads.append(path)
        return real_cdll(path, *a, **kw)

    monkeypatch.setattr(_build.subprocess, "run", counted_run)
    monkeypatch.setattr(_build.ctypes, "CDLL", counted_cdll)
    start = threading.Barrier(8)
    got, errors = [None] * 8, []

    def first_use(j):
        try:
            start.wait(timeout=30)
            got[j] = native._lib()
            uniq, _, _ = native.compact_ids(np.array([3, 1, 3]))
            assert uniq.tolist() == [3, 1]
        except BaseException as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=first_use, args=(j,))
               for j in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a thread hung"
    assert not errors, errors
    assert len(builds) == 1 and builds[0].endswith("fastblock.cpp")
    assert loads == [_build.library_path("fastblock")]
    assert all(g is got[0] for g in got)
    assert sorted(os.listdir(tmp_path / "build")) == ["libfastblock.so"]
