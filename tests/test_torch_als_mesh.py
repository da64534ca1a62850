"""The port's ``MeshALS`` on 2 and 4 gloo ranks against the JAX package's
``MeshALS`` on ``Partitioner(num_devices=2 | 4)`` (virtual CPU devices),
from JAX's initial tables: explicit (``direct`` and ``als_wr``), implicit
(α = 1 on |r|) and bf16 grams. Bars: the ALS fit bar of
tests/test_torch_als.py (rtol 2e-3 / atol 2e-4; both packages solve the
same systems, in other summation orders) and holdout RMSE within 1e-4;
bf16 grams two bf16 ulps of the largest |x| and RMSE within 1e-3 (see
``BF16_ULPS``). The
port's mesh at world k also equals its own single-device ALS on the same
blocking within that bar (the mesh's blocking has k blocks; a row's
system does not depend on where it is solved).
"""

import numpy as np
import pytest

from large_scale_recommendation_tpu.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu.core.types import Ratings as JRatings
from large_scale_recommendation_tpu.data import blocking as jblk
from large_scale_recommendation_tpu.models.als import ALS as JALS
from large_scale_recommendation_tpu.models.als import ALSConfig as JConfig
from large_scale_recommendation_tpu.ops import als as jals_ops
from large_scale_recommendation_tpu.parallel.als_mesh import (
    MeshALS as JMeshALS,
)
from large_scale_recommendation_tpu.parallel.partitioner import (
    Partitioner as JPartitioner,
)
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.models.als import ALSConfig
from large_scale_recommendation_tpu_torch.ops import als as als_ops
from large_scale_recommendation_tpu_torch.parallel.als_mesh import MeshALS
from large_scale_recommendation_tpu_torch.parallel.partitioner import (
    Partitioner,
)

import _torch_mesh_ranks as ranks

FIT = dict(rtol=2e-3, atol=2e-4)
# bf16 grams: a last-place difference in an f32 solve may round a row of
# the gathered bf16 table one ulp (2^-8 relative) apart, and the next
# half-steps carry it on (measured 5.6e-3 at world 4, none at world 2): two
# bf16 ulps of the table's largest |x|, RMSE within 1e-3
BF16_ULPS = 2.0 ** -7
BASE = dict(num_factors=8, lambda_=0.1, iterations=3, seed=0)
CASES = {"direct": dict(BASE),
         "als_wr": dict(BASE, reg_mode="als_wr", lambda_=0.05),
         "implicit": dict(BASE, implicit_alpha=1.0),
         "bf16_gram": dict(BASE, gram_dtype="bf16")}


def _data(implicit):
    gen = SyntheticMFGenerator(num_users=96, num_items=64, rank=4,
                               noise=0.1, seed=3)
    train, test = gen.generate(6000), gen.generate(600)
    if implicit:
        train, test = (JRatings.from_arrays(u, i, np.abs(v))
                       for u, i, v, _ in (r.to_numpy()
                                          for r in (train, test)))
    return train, test


def _init(train, cfg, k):
    ru, ri, _, rw = train.to_numpy()
    real = rw > 0
    users = jblk.build_id_index(ru[real], num_blocks=k, seed=0)
    items = jblk.build_id_index(ri[real], num_blocks=k, seed=1)
    return tuple(np.asarray(a) for a in JALS(JConfig(**cfg))
                 ._init_factors(users, items))


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request):
    k = request.param
    jobs, ref = [], {}
    for name, cfg in CASES.items():
        train, test = _data(name == "implicit")
        jobs.append(dict(op="als", cfg=cfg, ratings=tuple(
            np.asarray(a) for a in train.to_numpy()[:3]),
            init=_init(train, cfg, k)))
        ref[name] = (JMeshALS(JConfig(**cfg), partitioner=JPartitioner(
            num_devices=k)).fit(train), train, test)
    return k, ranks.run_world(k, jobs), ref


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_als_matches_jax(world, name):
    k, out, ref = world
    jm, train, test = ref[name]
    got = out[0][list(CASES).index(name)]
    assert np.isfinite(got["U"]).all() and np.isfinite(got["V"]).all()
    for a, b in ((got["U"], np.asarray(jm.U)), (got["V"], np.asarray(jm.V))):
        if name == "bf16_gram":
            assert np.abs(a - b).max() <= BF16_ULPS * np.abs(b).max()
        else:
            np.testing.assert_allclose(a, b, **FIT)
    pm = convert.model_from_jax(got["U"], got["V"], jm.users, jm.items,
                                device="cpu")
    assert abs(pm.rmse(Ratings.from_arrays(*test.to_numpy()))
               - jm.rmse(test)) < (1e-3 if name == "bf16_gram" else 1e-4)
    for r in range(k):  # every rank gathered the same tables
        np.testing.assert_array_equal(out[r][list(CASES).index(name)]["U"],
                                      got["U"])


def test_sharded_plans_equal_jax():
    rng = np.random.default_rng(0)
    n, S, rps = 3000, 4, 40
    out_local = rng.integers(0, rps, n)
    shard = rng.integers(0, S, n)
    other = rng.integers(0, 200, n)
    vals = rng.normal(size=n).astype(np.float32)
    for alpha in (None, 2.0):
        a = als_ops.build_sharded_plans(out_local, shard, other, vals, S,
                                        rps, 8, implicit_alpha=alpha)
        b = jals_ops.build_sharded_plans(out_local, shard, other, vals, S,
                                         rps, 8, implicit_alpha=alpha)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            for p, q in zip(x, y):
                assert p.dtype == q.dtype
                np.testing.assert_array_equal(p, q)


def test_world_one_equals_single_device_als():
    train, _ = _data(False)
    tr = Ratings.from_arrays(*train.to_numpy())
    from large_scale_recommendation_tpu_torch.models.als import ALS

    for name in ("direct", "implicit"):
        cfg = ALSConfig(**CASES[name])
        data = tr if name == "direct" else Ratings.from_arrays(
            *_data(True)[0].to_numpy())
        mesh = MeshALS(cfg, partitioner=Partitioner(device="cpu")).fit(data)
        single = ALS(cfg, device="cpu").fit(data)
        np.testing.assert_allclose(mesh.U.numpy(), single.U.numpy(), **FIT)
        np.testing.assert_allclose(mesh.V.numpy(), single.V.numpy(), **FIT)
    with pytest.raises(ValueError, match="gram_dtype"):
        MeshALS(ALSConfig(gram_dtype="f16"),
                partitioner=Partitioner(device="cpu")).fit(tr)
