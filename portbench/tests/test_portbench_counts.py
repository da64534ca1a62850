"""The yardstick's counts on problems small enough to count by hand."""

import math

import pytest
import torch

from portbench.reference import counts, dsgd, peaks


def _tiny_layout():
    """k = 2 blocks, minibatches of 2, 4 slots a block: two steps a
    stratum. Stratum 0 block 0 has a padding slot; stratum 1 block 0 is
    all padding."""
    su = torch.tensor([[[0, 1, 0, 0], [5, 5, 6, 7]],
                       [[0, 0, 0, 0], [2, 2, 2, 2]]])
    si = torch.tensor([[[2, 2, 3, 3], [8, 9, 8, 8]],
                       [[0, 0, 0, 0], [4, 4, 4, 4]]])
    sw = torch.tensor([[[1, 1, 1, 0], [1, 1, 1, 1]],
                       [[0, 0, 0, 0], [1, 1, 1, 1]]], dtype=torch.float32)
    z = torch.zeros_like(sw)
    return dsgd.Layout(su=su, si=si, sv=z, sw=sw, cu=z, cv=z,
                       omega_u=torch.zeros(8), omega_v=torch.zeros(10),
                       row_of_user=None, row_of_item=None,
                       id_of_user_row=None, id_of_item_row=None, k=2,
                       minibatch=2)


def test_step_counts_by_hand():
    users, items, ratings = dsgd.step_counts(_tiny_layout())
    # step (0, 0): users {0, 1} + {5}, items {2} + {8, 9}, 4 ratings;
    # step (0, 1): users {0} + {6, 7}, items {3} + {8}, 3 (one padding);
    # steps (1, 0), (1, 1): user 2, item 4, 2 ratings each
    assert users.tolist() == [3, 3, 1, 1]
    assert items.tolist() == [3, 2, 1, 1]
    assert ratings.tolist() == [4, 3, 2, 2]


def test_step_bounds_by_hand():
    users, items, ratings = dsgd.step_counts(_tiny_layout())
    rank = 4
    # a row read and written with its omega: 2·4·4 + 4 = 36 B; 24 B a
    # rating: 6·36 + 4·24, 5·36 + 3·24, 2·36 + 2·24 twice
    nbytes = 312 + 252 + 120 + 120
    # every step is bound by its bytes (12·4 FLOPs a rating is far less)
    assert 12 * rank * 4 / peaks.F32_FLOP_PER_S < 120 / peaks.HBM_BYTES_PER_S
    got = counts.dsgd_step_bounds(users, items, ratings, rank=rank)
    assert got == pytest.approx(nbytes / peaks.HBM_BYTES_PER_S, rel=1e-12)


def test_flop_bound_step():
    """A step with one row a side and many ratings is bound by FLOPs."""
    one = torch.tensor([1])
    n = torch.tensor([10 ** 9])
    got = counts.dsgd_step_bounds(one, one, n, rank=128)
    want = max((2 * 1028 + 24 * 10 ** 9) / peaks.HBM_BYTES_PER_S,
               12 * 128 * 10 ** 9 / peaks.F32_FLOP_PER_S)
    assert got == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(12 * 128 * 10 ** 9 / 67e12, rel=1e-12)


def test_als_round_flops_by_hand():
    # 3 ratings, 2 user rows, 1 item row, rank 2: per side grams
    # 2·3·4 = 24 and right-hand sides 2·3·2 = 12; per row a Cholesky
    # 8/3 and two triangular solves 2·4 = 8
    got = counts.als_round_flops(3, 2, 1, 2)
    assert got == pytest.approx(2 * (24 + 12) + 3 * (8 / 3 + 8))


def test_sgd_flops_per_rating():
    assert counts.sgd_flops_per_rating(128) == 1536


def test_least_seconds_names_its_bound():
    assert peaks.least_seconds(3.35e12, 1.0) == (1.0, "bytes")
    t, by = peaks.least_seconds(1.0, 67e12)
    assert by == "flops" and math.isclose(t, 1.0)
