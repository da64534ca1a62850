"""The port's host data path matches the JAX package bit for bit: the
synthetic generator, ``synthetic_like`` and the blocked layout."""

import numpy as np
import pytest

from large_scale_recommendation_tpu.core import generators as jgen
from large_scale_recommendation_tpu.core.types import Ratings as JRatings
from large_scale_recommendation_tpu.data import blocking as jblk
from large_scale_recommendation_tpu.data import movielens as jml
from large_scale_recommendation_tpu.utils import shapes as jshapes
from large_scale_recommendation_tpu_torch.core import generators as tgen
from large_scale_recommendation_tpu_torch.core.types import Ratings as TRatings
from large_scale_recommendation_tpu_torch.data import blocking as tblk
from large_scale_recommendation_tpu_torch.data import movielens as tml
from large_scale_recommendation_tpu_torch.utils import shapes as tshapes


def _same_ratings(a, b):
    for x, y in zip(a.to_numpy(), b.to_numpy()):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("skew", [None, 1.5])
def test_generator_bit_equal(skew):
    kw = dict(num_users=300, num_items=200, rank=6, noise=0.2, seed=7,
              skew_lam=skew)
    gj, gt = jgen.SyntheticMFGenerator(**kw), tgen.SyntheticMFGenerator(**kw)
    np.testing.assert_array_equal(gj.true_u, gt.true_u)
    np.testing.assert_array_equal(gj.true_v, gt.true_v)
    for n in (1000, 37):
        _same_ratings(gj.generate(n), gt.generate(n))


def test_next_exp_discrete_bit_equal():
    a = jgen._next_exp_discrete(np.random.default_rng(3), 2.0, 50, 4000)
    b = tgen._next_exp_discrete(np.random.default_rng(3), 2.0, 50, 4000)
    np.testing.assert_array_equal(a, b)
    assert b.min() >= 0 and b.max() < 50


@pytest.mark.parametrize("name", ["ml-100k", "ml-25m"])
def test_synthetic_like_bit_equal(name):
    kw = dict(nnz=5000, rank=8, noise=0.1, seed=2, skew_lam=2.0,
              num_users=400, num_items=300)
    (jt, jh), (tt, th) = jml.synthetic_like(name, **kw), \
        tml.synthetic_like(name, **kw)
    _same_ratings(jt, tt)
    _same_ratings(jh, th)
    assert tt.n == int(5000 * 0.95) and th.n == 5000 - tt.n
    assert tml._SHAPES == jml._SHAPES


def test_synthetic_like_unknown_name():
    with pytest.raises(KeyError):
        tml.synthetic_like("ml-7b")


def test_ratings_pad_and_shapes():
    r = TRatings.from_arrays([1, 2], [3, 4], [0.5, 1.5])
    p = r.pad_to(5)
    assert p.n == 5 and p.weights.tolist() == [1, 1, 0, 0, 0]
    assert r.pad_to(2) is r
    with pytest.raises(ValueError):
        p.pad_to(3)
    _same_ratings(p, JRatings.from_arrays([1, 2], [3, 4], [0.5, 1.5]).pad_to(5))
    for n in (0, 1, 7, 8, 9, 1000, 1025):
        assert tshapes.pow2_pad(n) == jshapes.pow2_pad(n)
        assert tshapes.pow2_pad(n, 1) == jshapes.pow2_pad(n, 1)


def _skewed(seed, n=4000, pad=0):
    gen = jgen.SyntheticMFGenerator(num_users=500, num_items=350, rank=4,
                                    noise=0.1, seed=seed, skew_lam=2.5)
    r = gen.generate(n)
    ru, ri, rv, rw = r.to_numpy()
    # sparse, non-contiguous external ids
    ru, ri = ru * 3 + 11, ri * 7 + 5
    if pad:
        return (JRatings.from_arrays(ru, ri, rv).pad_to(n + pad),
                TRatings.from_arrays(ru, ri, rv).pad_to(n + pad))
    return JRatings.from_arrays(ru, ri, rv), TRatings.from_arrays(ru, ri, rv)


def _same_index(a, b):
    for f in ("ids", "omega", "sorted_ids", "sorted_rows"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.num_blocks == b.num_blocks
    assert a.rows_per_block == b.rows_per_block


@pytest.mark.parametrize("k,mb,sort,seed,pad", [
    (1, 64, None, 0, 0),
    (2, 128, "item", 0, 37),
    (3, 32, "user", 5, 0),
    (4, 256, None, 11, 100),
    (8, 16, "item", 3, 3),
])
def test_block_problem_bit_equal(k, mb, sort, seed, pad):
    jr, tr = _skewed(seed, pad=pad)
    pj = jblk.block_problem(jr, num_blocks=k, seed=seed,
                            minibatch_multiple=mb, minibatch_sort=sort)
    pt = tblk.block_problem(tr, num_blocks=k, seed=seed,
                            minibatch_multiple=mb, minibatch_sort=sort)
    _same_index(pj.users, pt.users)
    _same_index(pj.items, pt.items)
    for f in ("u_rows", "i_rows", "values", "weights"):
        x, y = getattr(pj.ratings, f), getattr(pt.ratings, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert pt.ratings.nnz == pj.ratings.nnz == 4000
    assert pt.ratings.max_pad_ratio == pj.ratings.max_pad_ratio
    if pad:  # weight-0 padding trained nothing and counted nowhere
        assert pt.users.omega.sum() == 4000
    for m in (mb, max(mb // 4, 1)):
        ju, ji = jblk.minibatch_inv_counts(pj.ratings, m)
        tu, ti = tblk.minibatch_inv_counts(pt.ratings, m)
        np.testing.assert_array_equal(ju, tu)
        np.testing.assert_array_equal(ji, ti)


def test_rows_for_and_unknown_ids():
    jr, tr = _skewed(1)
    pj = jblk.block_problem(jr, num_blocks=2, seed=0)
    pt = tblk.block_problem(tr, num_blocks=2, seed=0)
    q = np.array([11, 14, 12, -1, 10**9, 5, 12])
    for a, b in zip(pj.users.rows_for(q), pt.users.rows_for(q)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="absent"):
        tblk.block_ratings((np.array([10**9]), np.array([5]),
                            np.array([1.0], np.float32)),
                           pt.users, pt.items)
    with pytest.raises(ValueError, match="minibatch_sort"):
        tblk.block_problem(tr, num_blocks=2, minibatch_sort="rating")


# -- loaders, compaction, split, flat_index (native host library) -----------


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


_U_DATA = "196\t242\t3\t881250949\n186\t302\t3\t891717742\n22\t377\t1\t1\n"
_RATINGS_CSV = ("userId,movieId,rating,timestamp\n1,296,5.0,1147880044\n"
                "1,306,3.5,1147868817\n7,296,0.5,3")


@pytest.mark.parametrize("loader,name,text", [
    ("load_ml100k", "u.data", _U_DATA),
    ("load_ml25m", "ratings.csv", _RATINGS_CSV),
    ("load_ratings_file", "u.data", _U_DATA),
    ("load_ratings_file", "ratings.csv", _RATINGS_CSV),
    ("load_ratings_file", "plain.csv", "1,2,3.5\n4,5,1.0\n"),
])
def test_loaders_bit_equal(tmp_path, loader, name, text):
    path = _write(tmp_path, name, text)
    for arg in (path, str(tmp_path)) if name != "plain.csv" else (path,):
        got = getattr(tml, loader)(arg)
        _same_ratings(got, getattr(jml, loader)(arg))
        assert got.n == text.strip().count("\n") + 1 - ("userId" in text)


def test_loaders_missing_files(tmp_path):
    for loader in ("load_ml100k", "load_ml25m", "load_ratings_file"):
        with pytest.raises(FileNotFoundError):
            getattr(tml, loader)(str(tmp_path / "absent"))
        with pytest.raises(FileNotFoundError):
            getattr(tml, loader)(str(tmp_path))  # a directory without one


@pytest.mark.parametrize("pad", [0, 9])
def test_compact_ratings_bit_equal(pad):
    jr, tr = _skewed(4, pad=pad)
    got = tml.compact_ratings(tr)
    want = jml.compact_ratings(jr)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    u, i, _, nu, ni = got
    assert u.min() == 0 and u.max() == nu - 1 and i.max() == ni - 1
    # first-seen order: the first rating's ids become dense 0
    assert u[0] == 0 and i[0] == 0


@pytest.mark.parametrize("frac,seed,pad", [(0.1, 0, 0), (0.25, 3, 11),
                                           (0.0, 1, 0)])
def test_train_test_split_bit_equal(frac, seed, pad):
    jr, tr = _skewed(seed, n=3000, pad=pad)
    for a, b in zip(tml.train_test_split(tr, frac, seed),
                    jml.train_test_split(jr, frac, seed)):
        _same_ratings(a, b)


def test_vocab_overrides_from_env(monkeypatch):
    monkeypatch.delenv("BENCH_USERS", raising=False)
    monkeypatch.delenv("BENCH_ITEMS", raising=False)
    assert tml.vocab_overrides_from_env() == (None, None)
    monkeypatch.setenv("BENCH_USERS", "2000")
    monkeypatch.setenv("BENCH_ITEMS", "800")
    assert tml.vocab_overrides_from_env() == jml.vocab_overrides_from_env() \
        == (2000, 800)


@pytest.mark.parametrize("case", ["ids", "omega", "sorted_pair", "empty",
                                  "empty_unpadded"])
def test_flat_index_bit_equal(case):
    ids = np.array([40, 7, 19, 3], np.int64)
    kw = {"ids": dict(ids=ids),
          "omega": dict(ids=ids, omega=[1, 5, 2, 0]),
          "sorted_pair": dict(ids=ids, sorted_pair=(np.sort(ids),
                                                    np.argsort(ids))),
          "empty": dict(ids=[]),
          "empty_unpadded": dict(ids=[], pad_empty=False)}[case]
    a, b = tblk.flat_index(**kw), jblk.flat_index(**kw)
    _same_index(a, b)
    if case.startswith("empty"):
        assert a.num_rows == (case == "empty")
        assert a.rows_for(np.array([3]))[1].tolist() == [0.0]
    else:
        np.testing.assert_array_equal(a.rows_for(ids)[0], np.arange(4))


def test_num_real_matches_jax():
    kw = dict(users=[1, 2, 3, 4], items=[5, 6, 7, 8],
              ratings=[1.0, 2.0, 3.0, 4.0], weights=[1.0, 0.0, 1.0, 1.0])
    j, t = JRatings.from_arrays(**kw), TRatings.from_arrays(**kw)
    assert float(t.num_real) == float(j.num_real) == 3.0
    assert float(t.pad_to(9).num_real) == float(j.pad_to(9).num_real) == 3.0
    assert float(TRatings.from_arrays([], [], []).num_real) == 0.0


def test_row_of_matches_jax():
    gen = jgen.SyntheticMFGenerator(num_users=40, num_items=30, rank=3,
                                    seed=5)
    train = gen.generate(500)
    jp = jblk.block_problem(train, num_blocks=3, seed=1)
    tp = tblk.block_problem(TRatings.from_arrays(*train.to_numpy()),
                            num_blocks=3, seed=1)
    for side in ("users", "items"):
        jidx, tidx = getattr(jp, side), getattr(tp, side)
        assert tidx.row_of == jidx.row_of
        assert tidx.row_of is tidx.row_of  # built once
        for ident, row in tidx.row_of.items():
            assert tidx.ids[row] == ident
