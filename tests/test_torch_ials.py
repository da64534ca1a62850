"""Implicit-feedback ALS (iALS: Hu, Koren & Volinsky, ICDM 2008) in the
port against the benchmark's plain float64 iALS
(``portbench/reference/ials.py``): ``ALS.fit_device`` with
``implicit_alpha`` on the CPU, through both of its plans — the bucketed
route the CPU takes, and the fused route's ``CsrPlan`` run by the kernel's
plain version (which ``tests/test_torch_cuda_card.py`` holds the card's
kernel to) — on seeded pairs whose repeats are coalesced to one entry a
pair with strength r = its multiplicity, as the ``mpd_ials_r64`` cell's
set-up does.

Tolerance ``TOL``, of the reference table's largest entry over the ids
seen: the port sums and solves in f32, the reference in float64, through
10 rounds. Measured ≤ 4.1e-5 over three seeds at these sizes (both plans,
ranks 8 and 64, skew 0 and 2); 3e-4 leaves ×7 of room and stays ×50 under
what the program's bf16 grams read (1.7e-2). The reference without YᵀY
misses the port's tables by more than 1 of that scale.
"""

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu_torch.models.als import ALS, ALSConfig
from large_scale_recommendation_tpu_torch.ops import als as als_ops
from portbench.generators.ials_fit import coalesce
from portbench.reference import generator, ials
from portbench.reference.compare import table_gap

NU, NI, DRAWS = 300, 200, 6000
ALPHA, LAM, ROUNDS = 40.0, 0.1, 10
TOL = 3e-4


def _pairs(skew: float, seed: int):
    """``DRAWS`` draws of (user, item), uniform (skew 0) or skewed as the
    benchmark's generator, coalesced: ``(u, i, r)``."""
    g = torch.Generator().manual_seed(seed)
    if skew:
        u = generator.skewed_ids(g, skew, NU, DRAWS)
        i = generator.skewed_ids(g, skew, NI, DRAWS)
    else:
        u = torch.randint(NU, (DRAWS,), generator=g)
        i = torch.randint(NI, (DRAWS,), generator=g)
    return coalesce(u, i, NI)


def _port(u, i, r, k, route, monkeypatch):
    if route == "csr":  # the card's plan, through the kernel's plain version
        monkeypatch.setattr(als_ops, "fused_route",
                            lambda device, k, gram_dtype=None: True)
    cfg = ALSConfig(num_factors=k, lambda_=LAM, iterations=ROUNDS,
                    implicit_alpha=ALPHA)
    return ALS(cfg, device="cpu").fit_device(u, i, r, NU, NI)


def _gaps(model, ref):
    U, V, om_u, om_v = ref
    su, sv = om_u > 0, om_v > 0
    return (table_gap(model.U[su], U[su]), table_gap(model.V[sv], V[sv]))


def test_coalesce_gives_one_entry_a_pair_with_its_multiplicity():
    g = torch.Generator().manual_seed(3)
    u = torch.randint(NU, (DRAWS,), generator=g)
    i = torch.randint(NI, (DRAWS,), generator=g)
    cu, ci, r = coalesce(u, i, NI)
    key = cu.long() * NI + ci.long()
    assert bool((key[1:] > key[:-1]).all())  # distinct, in (u, i) order
    assert int(r.sum()) == DRAWS and bool((r > 1).any())
    pairs = {}
    for a, b in zip(u.tolist(), i.tolist()):
        pairs[(a, b)] = pairs.get((a, b), 0) + 1
    got = dict(zip(zip(cu.tolist(), ci.tolist()), r.tolist()))
    assert got == pairs


@pytest.mark.parametrize("route", ["bucketed", "csr"])
@pytest.mark.parametrize("skew", [0.0, 2.0])
@pytest.mark.parametrize("k", [8, 64])
def test_implicit_fit_device_matches_the_float64_reference(monkeypatch, k,
                                                           skew, route):
    u, i, r = _pairs(skew, seed=11 + k)
    assert bool((r > 1).any())  # repeated pairs carry r > 1
    model = _port(u, i, r, k, route, monkeypatch)
    ref = ials.fit(u, i, r, NU, NI, k, lam=LAM, alpha=ALPHA, rounds=ROUNDS,
                   init_scale=0.1)
    gu, gv = _gaps(model, ref)
    assert gu <= TOL and gv <= TOL, (gu, gv)
    # ids without pairs stay unknown, as the reference's zero rows
    assert np.array_equal(model.users.sorted_ids,
                          torch.nonzero(ref[2] > 0).reshape(-1).numpy())


@pytest.mark.parametrize("k", [8, 64])
def test_reference_without_yty_misses_the_port(monkeypatch, k):
    """Leaving out the unobserved pairs' confidence-1 terms (YᵀY) is a
    different model: the check's tolerance must see it."""
    u, i, r = _pairs(2.0, seed=11 + k)
    model = _port(u, i, r, k, "csr", monkeypatch)
    ref = ials.fit(u, i, r, NU, NI, k, lam=LAM, alpha=ALPHA, rounds=ROUNDS,
                   init_scale=0.1, full_gram=False)
    assert min(_gaps(model, ref)) > 1.0 > TOL
