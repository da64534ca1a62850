"""The port's on-device data pipeline (``data.device_blocking``) against
the JAX package's, on the CPU.

Fed the JAX package's ids and its permutations
(``jax.random.permutation(fold_in(PRNGKey(seed), 10 | 11 | 12), n)``), the
layout is bit-equal: stable sorts keep ties in the same order and counts
are integers. On its own draws (torch generators) the port's layout cannot
equal JAX's, so it is held to the structural invariants instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from large_scale_recommendation_tpu.core import initializers as jinit
from large_scale_recommendation_tpu.data import device_blocking as jdb
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch.core.initializers import (
    PseudoRandomFactorInitializer,
    keyed_uniform_rows,
)
from large_scale_recommendation_tpu_torch.data import device_blocking as tdb

ARRAYS = ("su", "si", "sv", "sw", "icu", "icv", "omega_u", "omega_v",
          "row_of_user", "row_of_item", "id_of_user_row", "id_of_item_row")


def _coo(seed, n=1500, nu=70, ni=50, pad=False):
    """Skewed dense ids (duplicate rows in every minibatch); with ``pad``,
    ~10% weight-0 entries."""
    rng = np.random.default_rng(seed)
    u = np.minimum(rng.exponential(nu / 4, n), nu - 1).astype(np.int32)
    i = np.minimum(rng.exponential(ni / 4, n), ni - 1).astype(np.int32)
    r = rng.normal(0, 1, n).astype(np.float32)
    w = None
    if pad:
        w = np.ones(n, np.float32)
        w[rng.random(n) < 0.1] = 0.0
    return u, i, r, w, nu, ni


def _jax_perms(seed, nu, ni, n):
    base = jax.random.PRNGKey(seed)
    return tuple(np.asarray(jax.random.permutation(
        jax.random.fold_in(base, salt), m))
        for salt, m in ((10, nu), (11, ni), (12, n)))


def _both(k, sort, pad, seed=0, mb=16):
    u, i, r, w, nu, ni = _coo(seed + k, pad=pad)
    jp = jdb.device_block_problem(
        jnp.asarray(u), jnp.asarray(i), jnp.asarray(r), nu, ni, num_blocks=k,
        minibatch_multiple=mb, seed=seed, minibatch_sort=sort,
        weights=None if w is None else jnp.asarray(w))
    tp = tdb.device_block_problem(
        u, i, r, nu, ni, num_blocks=k, minibatch_multiple=mb, seed=seed,
        minibatch_sort=sort, weights=w, device="cpu",
        perms=_jax_perms(seed, nu, ni, len(u)))
    return jp, tp, (u, i, r, w, nu, ni)


def _bit_equal(t, j):
    t = t.numpy()
    j = np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_array_equal(t, j.astype(t.dtype))
    if t.dtype.kind == "f":  # the same bits, not only the same values
        np.testing.assert_array_equal(t.view(np.int32),
                                      j.astype(np.float32).view(np.int32))


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("sort", [None, "user", "item"])
@pytest.mark.parametrize("k", [2, 4])
def test_layout_bit_equal_given_jax_permutations(k, sort, pad):
    jp, tp, _ = _both(k, sort, pad)
    for name in ARRAYS:
        _bit_equal(getattr(tp, name), getattr(jp, name))
    assert tp.su.dtype == torch.int32 and tp.sv.dtype == torch.float32
    for f in ("num_blocks", "rows_per_block_u", "rows_per_block_v", "nnz",
              "minibatch"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.max_pad_ratio == pytest.approx(jp.max_pad_ratio, rel=1e-12)


@pytest.mark.parametrize("k,sort", [(2, None), (4, "item")])
def test_recompute_inv_counts_bit_equal(k, sort):
    jp, tp, _ = _both(k, sort, pad=True)
    for mb in (8, 4):
        for a, b in zip(tdb.recompute_inv_counts(tp, mb),
                        jdb.recompute_inv_counts(jp, mb)):
            _bit_equal(a, b)
    with pytest.raises(ValueError, match="divide"):
        tdb.recompute_inv_counts(tp, 2 * tp.su.shape[-1])


@pytest.mark.parametrize("pad", [False, True])
def test_holdout_rows_and_id_indices_bit_equal(pad):
    jp, tp, (u, i, r, w, nu, ni) = _both(4, None, pad)
    rng = np.random.default_rng(9)
    hu = rng.integers(0, nu, 300).astype(np.int32)
    hi = rng.integers(0, ni, 300).astype(np.int32)
    for a, b in zip(tp.holdout_rows(torch.from_numpy(hu),
                                    torch.from_numpy(hi)),
                    jp.holdout_rows(jnp.asarray(hu), jnp.asarray(hi))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tp.to_id_indices(), jp.to_id_indices()):
        for f in ("ids", "omega", "sorted_ids", "sorted_rows"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.num_blocks, a.rows_per_block) == (b.num_blocks,
                                                    b.rows_per_block)


def test_converted_jax_problem_equals_the_ports():
    jp, tp, _ = _both(2, "user", pad=True)
    cp = convert.device_problem_from_jax(jp, device="cpu")
    for name in ARRAYS:
        assert torch.equal(getattr(cp, name), getattr(tp, name)), name
    assert (cp.nnz, cp.minibatch) == (tp.nnz, tp.minibatch)


@pytest.mark.parametrize("k,sort,pad", [(2, None, False), (4, "item", True),
                                        (3, "user", True)])
def test_structural_invariants_on_own_draws(k, sort, pad):
    u, i, r, w, nu, ni = _coo(7, n=2000, pad=pad)
    mb = 16
    p = tdb.device_block_problem(u, i, r, nu, ni, num_blocks=k,
                                 minibatch_multiple=mb, seed=3,
                                 minibatch_sort=sort, weights=w, device="cpu")
    real = p.sw > 0
    n_real = int(real.sum())
    assert n_real == p.nnz == (len(u) if w is None else int((w > 0).sum()))
    bmax = p.su.shape[-1]
    assert bmax % mb == 0
    assert p.max_pad_ratio == pytest.approx(k * k * bmax / p.nnz)
    # stratum s, visit p holds only U block p and V block (p+s) mod k, so
    # the k visits of a stratum are row-disjoint in both tables
    blk_u = p.su.long() // p.rows_per_block_u
    blk_v = p.si.long() // p.rows_per_block_v
    s_idx = torch.arange(k)[:, None, None]
    p_idx = torch.arange(k)[None, :, None]
    assert bool((blk_u == p_idx)[real].all())
    assert bool((blk_v == (p_idx + s_idx) % k)[real].all())
    # the real entries are exactly the input's, each once
    ww = np.ones(len(u), np.float32) if w is None else w
    keep = ww > 0
    want = np.sort(np.asarray(p.row_of_user)[u[keep]].astype(np.int64)
                   * 10**6 + np.asarray(p.row_of_item)[i[keep]])
    have = np.sort(p.su[real].long().numpy() * 10**6
                   + p.si[real].long().numpy())
    np.testing.assert_array_equal(have, want)
    # omegas are the per-row counts of real entries
    cu = np.bincount(u[keep], minlength=nu).astype(np.float32)
    np.testing.assert_array_equal(
        p.omega_u.numpy()[p.row_of_user.long().numpy()], cu)
    # row maps are inverse bijections
    np.testing.assert_array_equal(
        p.id_of_user_row.numpy()[p.row_of_user.long().numpy()],
        np.arange(nu))
    # deterministic per seed, and the seed matters
    again = tdb.device_block_problem(u, i, r, nu, ni, num_blocks=k,
                                     minibatch_multiple=mb, seed=3,
                                     minibatch_sort=sort, weights=w,
                                     device="cpu")
    for name in ARRAYS:
        assert torch.equal(getattr(p, name), getattr(again, name)), name
    other = tdb.device_block_problem(u, i, r, nu, ni, num_blocks=k,
                                     minibatch_multiple=mb, seed=4,
                                     minibatch_sort=sort, weights=w,
                                     device="cpu")
    assert not torch.equal(p.row_of_user, other.row_of_user)


def test_inv_counts_presorted_path_is_bit_equal():
    rng = np.random.default_rng(2)
    rows = torch.from_numpy(np.sort(rng.integers(0, 9, (6, 32)), axis=1))
    w = torch.from_numpy((rng.random((6, 32)) > 0.2).astype(np.float32))
    a = tdb._inv_counts_2d(rows, w)
    b = tdb._inv_counts_2d(rows, w, presorted=True)
    assert torch.equal(a, b)
    _bit_equal(a, jdb._inv_counts_2d(jnp.asarray(rows.numpy()),
                                     jnp.asarray(w.numpy())))


def test_validate_dense_ids_checks_before_the_int32_cast():
    u = np.array([0, 1, 2**32 + 1], np.int64)  # wraps to 1 as int32
    i = np.array([0, 1, 2], np.int64)
    for uu, ii in ((u, i), (torch.from_numpy(u), torch.from_numpy(i)),
                   (torch.from_numpy(u), i)):
        with pytest.raises(ValueError, match="dense ids"):
            tdb.validate_dense_ids(uu, ii, 10, 10, "ctx")
        with pytest.raises(ValueError, match="dense ids"):
            jdb.validate_dense_ids(np.asarray(uu), np.asarray(ii), 10, 10,
                                   "ctx")
    with pytest.raises(ValueError, match="dense ids"):
        tdb.validate_dense_ids(np.array([-1]), np.array([0]), 10, 10, "ctx")
    tdb.validate_dense_ids(u[:2], i, 2, 3, "ctx")
    with pytest.raises(ValueError, match="empty"):
        tdb.device_block_problem(np.array([], np.int32),
                                 np.array([], np.int32),
                                 np.array([], np.float32), 4, 4, 2,
                                 device="cpu")
    with pytest.raises(ValueError, match="minibatch_sort"):
        tdb.device_block_problem(u[:2], i[:2], np.ones(2, np.float32), 4, 4,
                                 2, minibatch_sort="rating", device="cpu")


def test_rows_per_block_matches_jax():
    for n, k, m in ((100, 3, 8), (162_541, 8, 8), (1, 4, 8), (59_047, 8, 1)):
        assert tdb.rows_per_block(n, k, m) == jdb.rows_per_block(n, k, m)


@pytest.mark.parametrize("lam", [2.0, 0.7])
def test_truncated_exp_ids_formula_matches_jax(lam):
    """Given the same uniforms the port's inverse CDF gives JAX's ids, up to
    a rare off-by-one where log1p differs by an ulp between the two
    libraries. Measured share of off-by-one ids over 2M draws: 5e-6 (λ 2)
    and 8.5e-6 (λ 0.7) at 1,000 ids; 6.0e-4 (λ 2) and 1.6e-3 (λ 0.7) at
    ML-25M's 162,541 users, where the id buckets are narrower."""
    key = jax.random.PRNGKey(5)
    n_ids, size = 1000, 200_000
    want = np.asarray(jdb.truncated_exp_ids(key, lam, n_ids, size))
    u = np.asarray(jax.random.uniform(key, (size,), dtype=jnp.float32))
    got = tdb.exp_ids_from_uniform(torch.from_numpy(u.copy()), lam,
                                   n_ids).numpy()
    diff = got.astype(np.int64) - want
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() < 1e-4
    assert got.min() >= 0 and got.max() <= n_ids - 1


def test_synthetic_like_device_stats():
    (u, i, r), (hu, hi, hr), (nu, ni) = tdb.synthetic_like_device(
        "ml-100k", nnz=20_000, rank=8, noise=0.1, seed=1, device="cpu")
    assert (nu, ni) == (943, 1682)
    assert u.shape[0] == 19_000 and hu.shape[0] == 1000
    assert u.dtype == torch.int64 and r.dtype == torch.float32
    for a, n in ((u, nu), (i, ni), (hu, nu), (hi, ni)):
        assert int(a.min()) >= 0 and int(a.max()) < n
    # skewed: low ids are hot
    assert float((u < nu // 10).float().mean()) > 0.15
    # planted rank-8 scores at unit scale plus 0.1 noise
    assert 0.3 < float(r.std()) < 3.0 and torch.isfinite(r).all()
    again = tdb.synthetic_like_device("ml-100k", nnz=20_000, rank=8,
                                      noise=0.1, seed=1, device="cpu")
    assert torch.equal(again[0][2], r) and torch.equal(again[1][0], hu)
    uniform = tdb.synthetic_like_device("ml-100k", nnz=5000, skew_lam=None,
                                        seed=1, device="cpu")
    assert float((uniform[0][0] < nu // 10).float().mean()) < 0.15
    with pytest.raises(KeyError):
        tdb.synthetic_like_device("ml-1b", device="cpu")


def test_keyed_init_is_a_function_of_the_id():
    ids = torch.tensor([0, 5, 2**40 + 3, 7, 5, 123456789])
    a = keyed_uniform_rows(ids, 16, 0.5)
    assert a.dtype == torch.float32 and a.shape == (6, 16)
    assert float(a.min()) >= 0.0 and float(a.max()) < 0.5
    np.testing.assert_array_equal(a[1].numpy(), a[4].numpy())
    # the same id gives the same row at another batch position and size
    b = keyed_uniform_rows(ids[[3, 1]], 16, 0.5)
    np.testing.assert_array_equal(b.numpy(), a[[3, 1]].numpy())
    # rows and columns differ; the mean is near 1/2·scale
    assert len({tuple(r) for r in a.numpy().tolist()}) == 5
    assert len(set(a[0].tolist())) == 16
    big = keyed_uniform_rows(torch.arange(4000), 32, 1.0)
    assert abs(float(big.mean()) - 0.5) < 0.01
    # the initializer: numpy ids give the same table as tensor ids
    init = PseudoRandomFactorInitializer(16, scale=0.5)
    np.testing.assert_array_equal(init(ids.numpy()).numpy(), a.numpy())


def _scalar_keyed_uniform(ident, col, scale):
    """The keyed hash on Python integers: the reference of the int64
    vectorization (no product may overflow or lose its high bits)."""
    m32 = 0xFFFFFFFF

    def mix(x):
        x ^= x >> 16
        x = (x * 0x85EBCA6B) & m32
        x ^= x >> 13
        x = (x * 0xC2B2AE35) & m32
        return x ^ (x >> 16)

    key = mix((ident & m32) ^ mix(((ident >> 32) & m32) ^ 0x5BD1E995))
    h = mix(mix(key ^ (((col + 1) * 0x9E3779B9) & m32)))
    return np.float32((h >> 8) * 2.0 ** -24) * np.float32(scale)


def test_keyed_init_equals_its_scalar_hash():
    ids = [0, 1, 7, 65_535, 65_536, 162_540, 2**31 - 1, 2**32 + 5, 2**40 + 3]
    rank = 12
    got = keyed_uniform_rows(torch.tensor(ids), rank, 0.08).numpy()
    want = np.array([[_scalar_keyed_uniform(i, c, 0.08) for c in range(rank)]
                     for i in ids], np.float32)
    np.testing.assert_array_equal(got, want)


def test_init_factors_device_matches_host_initializer_row_for_row():
    """The device problem's init gives each id the row the host fit's
    per-id initializer gives it; padding rows carry id 0's row."""
    jp, tp, (u, i, r, w, nu, ni) = _both(4, None, pad=False)
    U, V = tdb.init_factors_device(tp, 8, scale=0.3)
    init = PseudoRandomFactorInitializer(8, scale=0.3)
    rows = tp.row_of_user.long()
    np.testing.assert_array_equal(U[rows].numpy(),
                                  init(np.arange(nu)).numpy())
    np.testing.assert_array_equal(V[tp.row_of_item.long()].numpy(),
                                  init(np.arange(ni)).numpy())
    pad_rows = torch.ones(U.shape[0], dtype=torch.bool)
    pad_rows[rows] = False
    assert bool((U[pad_rows] == init(np.array([0]))).all())
    # the JAX package's counterpart keeps the same contract with its own
    # draws: row = f(id) through id_of_*_row
    jU, _ = jdb.init_factors_device(jp, 8, scale=0.3)
    want = jinit._keyed_uniform_rows(jax.random.PRNGKey(0),
                                     np.arange(nu), 8, jnp.float32(0.3))
    np.testing.assert_array_equal(np.asarray(jU)[np.asarray(jp.row_of_user)],
                                  np.asarray(want))
