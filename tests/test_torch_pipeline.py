"""The port's estimator pipeline (``models.pipeline``) against the JAX
package's, on the CPU, from the same seeded numpy inputs.

Bars: the fitted stages (vocabularies, dense ids, the weighted mean) are
numpy in both packages: equal. ``Pipeline(IdCompactor(), MeanCenterer(),
DSGD(cfg, device="cpu"))`` against the same stages composed by hand:
predictions bit-equal (the port's CPU DSGD is deterministic). Against the
JAX pipeline given the same initial tables (JAX's, recorded at its
``_init_factors`` and handed to the port's estimator): predictions within
the DSGD bar, rtol 2e-4 / atol 2e-5 (tests/test_torch_dsgd.py).
"""

import numpy as np
import pytest

from large_scale_recommendation_tpu.core.types import Ratings as JRatings
from large_scale_recommendation_tpu.models import pipeline as jpipe
from large_scale_recommendation_tpu.models.dsgd import DSGD as JDSGD
from large_scale_recommendation_tpu.models.dsgd import (
    DSGDConfig as JDSGDConfig,
)
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.core.updaters import SGDUpdater
from large_scale_recommendation_tpu_torch.models.als import ALS, ALSConfig
from large_scale_recommendation_tpu_torch.models.dsgd import DSGD, DSGDConfig
from large_scale_recommendation_tpu_torch.models.pipeline import (
    IdCompactor,
    MeanCenterer,
    Pipeline,
)

DSGD_TOL = dict(rtol=2e-4, atol=2e-5)
DSGD_KW = dict(num_factors=6, iterations=4, learning_rate=0.1,
               lr_schedule="constant", seed=0)


def sparse_id_workload(seed=0, n=12000, mean=3.5):
    """Planted structure with sparse raw ids and a large value offset."""
    gen = SyntheticMFGenerator(num_users=120, num_items=80, rank=5,
                               noise=0.05, seed=seed)
    train, test = gen.generate(n), gen.generate(n // 4)

    def sparsify(r):
        ru, ri, rv, rw = r.to_numpy()
        return Ratings.from_arrays(ru * 7 + 13, ri * 11 + 5, rv + mean, rw)

    return sparsify(train), sparsify(test)


def jratings(r):
    return JRatings.from_arrays(*r.to_numpy())


def test_id_compactor_matches_jax_and_maps_unseen():
    train, _ = sparse_id_workload()
    fc, jfc = IdCompactor().fit(train), jpipe.IdCompactor().fit(
        jratings(train))
    assert (fc.num_users, fc.num_items) == (jfc.num_users, jfc.num_items)
    ru, ri, _, _ = train.to_numpy()
    du, di = fc.map_ids(ru, ri)
    jdu, jdi = jfc.map_ids(ru, ri)
    np.testing.assert_array_equal(du, jdu)
    np.testing.assert_array_equal(di, jdi)
    assert du.min() == 0 and du.max() == fc.num_users - 1
    u_bad, i_bad = fc.map_ids([999_999], [999_999])
    assert u_bad[0] == -1 and i_bad[0] == -1
    out, jout = fc.transform(train), jfc.transform(jratings(train))
    for a, b in zip(out.to_numpy(), jout.to_numpy()):
        np.testing.assert_array_equal(a, b)
    assert out.n == train.n


def test_mean_centerer_matches_jax_and_inverts():
    train, _ = sparse_id_workload()
    fm, jfm = MeanCenterer().fit(train), jpipe.MeanCenterer().fit(
        jratings(train))
    assert fm.mean == jfm.mean
    _, _, cv, cw = fm.transform(train).to_numpy()
    np.testing.assert_array_equal(
        cv, jfm.transform(jratings(train)).to_numpy()[2])
    assert abs(float((cv * cw).sum() / cw.sum())) < 1e-4
    np.testing.assert_allclose(fm.adjust_scores(cv), train.to_numpy()[2],
                               rtol=1e-5)


@pytest.mark.parametrize("estimator", ["dsgd", "als"])
def test_chain_equals_manual_composition(estimator):
    """Bit-equal predictions, score un-centering included; and the ALS
    chain learns (well under the predict-the-mean floor, the JAX test's
    bar; 4 DSGD sweeps at these settings do not get below it in either
    package, see the JAX parity test below)."""
    train, test = sparse_id_workload()

    def make():
        if estimator == "dsgd":
            return DSGD(DSGDConfig(**DSGD_KW), device="cpu")
        return ALS(ALSConfig(num_factors=8, lambda_=0.05, iterations=6,
                             seed=0), device="cpu")

    pm = Pipeline(IdCompactor(), MeanCenterer(), make()).fit(train)
    fc = IdCompactor().fit(train)
    fm = MeanCenterer().fit(fc.transform(train))
    manual = make().fit(fm.transform(fc.transform(train)))
    ru, ri, rv, _ = test.to_numpy()
    du, di = fc.map_ids(ru, ri)
    want = np.asarray(manual.predict(du, di)) + np.float32(fm.mean)
    np.testing.assert_array_equal(pm.predict(ru, ri), want)
    if estimator == "als":
        assert pm.rmse(test) < 0.5 * float(np.std(rv))


def test_pipeline_matches_jax_given_the_same_initial_tables():
    train, test = sparse_id_workload()
    recorded = []
    jest = JDSGD(JDSGDConfig(**DSGD_KW))
    j_init = jest._init_factors

    def record(problem):
        tables = j_init(problem)
        recorded.append(tuple(np.asarray(t) for t in tables))
        return tables

    jest._init_factors = record
    jpm = jpipe.Pipeline(jpipe.IdCompactor(), jpipe.MeanCenterer(),
                         jest).fit(jratings(train))
    est = DSGD(DSGDConfig(**DSGD_KW), device="cpu")
    est._init_factors = lambda _problem: convert.factors_from_jax(
        *recorded[0], device="cpu")
    pm = Pipeline(IdCompactor(), MeanCenterer(), est).fit(train)
    ru, ri, _, _ = test.to_numpy()
    np.testing.assert_allclose(pm.predict(ru, ri),
                               np.asarray(jpm.predict(ru, ri)), **DSGD_TOL)
    assert abs(pm.rmse(test) - jpm.rmse(jratings(test))) < 1e-4


def test_unseen_pairs_predict_the_mean():
    train, _ = sparse_id_workload()
    pm = Pipeline(IdCompactor(), MeanCenterer(),
                  DSGD(DSGDConfig(**DSGD_KW), device="cpu")).fit(train)
    s = pm.predict([424242, 13], [777777, 424242])
    np.testing.assert_allclose(s, pm.fitted_stages[1].mean, rtol=1e-6)


def test_fit_time_overrides_merge_into_final_config():
    train, _ = sparse_id_workload()
    est = ALS(ALSConfig(num_factors=4, iterations=1, seed=0), device="cpu")
    pipe = Pipeline(IdCompactor(), MeanCenterer(), est)
    pm = pipe.fit(train, iterations=2, num_factors=8)
    assert est.config.iterations == 1  # the caller's instance unmodified
    assert pm.model.rank == 8
    assert pm.model.U.device == est.device  # the device survives
    with pytest.raises(ValueError):
        pipe.fit(train, not_a_field=3)


def test_rejects_stageless_and_fitless():
    with pytest.raises(ValueError):
        Pipeline()
    with pytest.raises(TypeError):
        Pipeline(IdCompactor(), object())


def test_compactor_threads_weights():
    tr, _ = sparse_id_workload()
    ru, ri, rv, _ = tr.to_numpy()
    w = np.full(tr.n, 2.0, np.float32)
    w[: tr.n // 2] = 0.5
    weighted = Ratings.from_arrays(ru, ri, rv, w)
    out = IdCompactor().fit(weighted).transform(weighted)
    np.testing.assert_array_equal(out.to_numpy()[3], w)
    fm = MeanCenterer().fit(out)
    assert abs(fm.mean - float((rv * w).sum() / w.sum())) < 1e-5


def test_injected_updater_survives_overrides(monkeypatch):
    """A rebuilt estimator keeps an injected updater (the same object)
    and re-derives a default one from the overridden config."""
    tr, _ = sparse_id_workload(n=4000)
    fitted = []
    fit = DSGD.fit

    def spy(self, data, *a, **kw):
        fitted.append(self)
        return fit(self, data, *a, **kw)

    monkeypatch.setattr(DSGD, "fit", spy)
    custom = SGDUpdater(learning_rate=0.05)
    est = DSGD(DSGDConfig(num_factors=4, iterations=1, seed=0),
               updater=custom, device="cpu")
    Pipeline(IdCompactor(), MeanCenterer(), est).fit(tr, iterations=2)
    assert fitted[-1] is not est and fitted[-1].updater is custom
    assert fitted[-1].config.iterations == 2
    default = DSGD(DSGDConfig(num_factors=4, iterations=1,
                              learning_rate=0.001, seed=0), device="cpu")
    pm2 = Pipeline(IdCompactor(), MeanCenterer(), default).fit(
        tr, learning_rate=0.3, lr_schedule="constant", iterations=4)
    assert fitted[-1].updater.learning_rate == 0.3
    pm3 = Pipeline(IdCompactor(), MeanCenterer(), DSGD(
        DSGDConfig(num_factors=4, iterations=1, learning_rate=0.001,
                   seed=0), device="cpu")).fit(tr, iterations=4)
    # the lr override changes training (0.3 learns, 0.001 crawls)
    assert pm2.rmse(tr) < pm3.rmse(tr) - 0.05


@pytest.mark.parametrize("est", ["mesh_dsgd", "mesh_als"])
def test_mesh_estimators_keep_their_partitioner(est):
    """The mesh estimators chain like the single-device ones; a rebuild for
    fit-time overrides keeps the estimator's partitioner, and at world 1
    the mesh chain predicts what the single-device chain does."""
    from large_scale_recommendation_tpu_torch.parallel import (
        MeshALS,
        MeshDSGD,
        MeshDSGDConfig,
        Partitioner,
    )

    train, test = sparse_id_workload(seed=4, n=6000)
    part = Partitioner(device="cpu")
    if est == "mesh_dsgd":
        kw = dict(num_factors=6, lambda_=0.02, iterations=2,
                  learning_rate=0.2, lr_schedule="constant",
                  minibatch_size=256, init_scale=0.2)
        mesh = MeshDSGD(MeshDSGDConfig(**kw, kernel="torch"),
                        partitioner=part)
        single = DSGD(DSGDConfig(**kw), device="cpu")
    else:
        mesh = MeshALS(ALSConfig(num_factors=6, iterations=2),
                       partitioner=part)
        single = ALS(ALSConfig(num_factors=6, iterations=2), device="cpu")
    pipe = Pipeline(IdCompactor(), MeanCenterer(), mesh)
    model = pipe.fit(train, iterations=3)
    assert model.model.partitioner is part
    ref = Pipeline(IdCompactor(), MeanCenterer(), single).fit(
        train, iterations=3)
    ru, ri, _, _ = test.to_numpy()
    np.testing.assert_allclose(model.predict(ru, ri), ref.predict(ru, ri),
                               rtol=1e-5, atol=1e-5)
