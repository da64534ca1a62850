"""The port's instrumented trainers against the JAX package's, and the
disabled path: with obs on, ``DSGD.fit`` (3 segments, a snapshot each)
publishes the JAX fit's metric names and labels, span taxonomy and
``train.segment`` / ``train.checkpoint`` event fields; ``ALS.fit`` /
``fit_device`` and ``MeshDSGD`` (a gloo group of one) publish their
timers' names as JAX's do; the online checkpoint notes the same
``checkpoint.snapshot`` / ``checkpoint.restore`` bytes. With obs off, the
fit binds the shared null instruments and reads no clock for obs, and
the ``utils.metrics`` shims record nothing. Names, labels, fields and
bytes are compared exactly; values that are walls are not compared."""

import socket
import threading

import numpy as np
import pytest
import torch

from large_scale_recommendation_tpu import obs as jobs
from large_scale_recommendation_tpu.core.generators import (
    SyntheticMFGenerator,
)
from large_scale_recommendation_tpu.models.als import (
    ALS as JALS,
    ALSConfig as JALSConfig,
)
from large_scale_recommendation_tpu.models.dsgd import (
    DSGD as JDSGD,
    DSGDConfig as JDSGDConfig,
)
from large_scale_recommendation_tpu.models.online import (
    OnlineMF as JOnlineMF,
    OnlineMFConfig as JOnlineMFConfig,
)
from large_scale_recommendation_tpu.obs import events as jev
from large_scale_recommendation_tpu.obs import transfers as jtx
from large_scale_recommendation_tpu.parallel import (
    MeshDSGD as JMeshDSGD,
    MeshDSGDConfig as JMeshDSGDConfig,
    Partitioner as JPartitioner,
)
from large_scale_recommendation_tpu.utils import checkpoint as jckpt
from large_scale_recommendation_tpu_torch import convert
from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.core.types import Ratings
from large_scale_recommendation_tpu_torch.models.als import ALS, ALSConfig
from large_scale_recommendation_tpu_torch.models.dsgd import DSGD, DSGDConfig
from large_scale_recommendation_tpu_torch.obs import instrument
from large_scale_recommendation_tpu_torch.obs import trace as ptr
from large_scale_recommendation_tpu_torch.obs.registry import NULL_INSTRUMENT
from large_scale_recommendation_tpu_torch.ops import _build
from large_scale_recommendation_tpu_torch.parallel import (
    MeshDSGD,
    MeshDSGDConfig,
    Partitioner,
)
from large_scale_recommendation_tpu_torch.parallel.distributed import (
    DistributedConfig,
    initialize_distributed,
)
from large_scale_recommendation_tpu_torch.utils import checkpoint as pckpt
from large_scale_recommendation_tpu_torch.utils import metrics


@pytest.fixture
def both_obs():
    """Live registries, tracers and journals in both packages; each
    package's defaults restored after."""
    jprev = (jobs.get_registry(), jobs.get_tracer(), jobs.get_events(),
             jtx.get_transfers())
    pprev = (obs.get_registry(), obs.get_tracer(), obs.get_events(),
             obs.get_transfers())
    jreg, jtr = jobs.enable()
    jev.set_events(jev.EventJournal(tracer=jtr, registry=jreg))
    preg, ptr_ = obs.enable()
    obs.set_events(obs.EventJournal())
    yield (jreg, jtr), (preg, ptr_)
    jobs.set_registry(jprev[0])
    jobs.set_tracer(jprev[1])
    jev.set_events(jprev[2])
    jtx.set_transfers(jprev[3])
    obs.disable()
    obs.set_registry(pprev[0])
    obs.set_tracer(pprev[1])
    obs.set_events(pprev[2])
    obs.set_transfers(pprev[3])


@pytest.fixture
def port_null():
    """The port's disabled layer for one test, the previous one after."""
    prev = (obs.get_registry(), obs.get_tracer(), obs.get_events(),
            obs.get_introspector(), obs.get_transfers(), obs.get_recorder(),
            obs.get_store())
    obs.disable()
    yield obs.get_registry()
    obs.set_registry(prev[0])
    obs.set_tracer(prev[1])
    obs.set_events(prev[2])
    obs.set_introspector(prev[3])
    obs.set_transfers(prev[4])
    obs.set_recorder(prev[5])
    obs.set_store(prev[6])


def _ratings(seed=3, n=4000, users=120, items=60):
    return SyntheticMFGenerator(num_users=users, num_items=items, rank=4,
                                seed=seed).generate(n)


def _port(r):
    return Ratings.from_arrays(*r.to_numpy())


def _names(reg):
    return {(m["name"], tuple(sorted(m["labels"].items())))
            for m in reg.snapshot()["metrics"]}


DSGD_KW = dict(num_factors=8, iterations=3, minibatch_size=512,
               num_blocks=2, learning_rate=0.05)


def test_dsgd_fit_publishes_the_jax_catalog(both_obs, tmp_path):
    (jreg, jtr), (preg, ptr_) = both_obs
    r = _ratings()
    JDSGD(JDSGDConfig(**DSGD_KW)).fit(
        r, checkpoint_every=1,
        checkpoint_manager=jckpt.CheckpointManager(str(tmp_path / "j")))
    DSGD(DSGDConfig(**DSGD_KW), device="cpu").fit(
        _port(r), checkpoint_every=1,
        checkpoint_manager=pckpt.CheckpointManager(str(tmp_path / "p")))
    assert _names(preg) == _names(jreg)
    assert preg.counter("train_segments_total", model="dsgd").value == 3

    def events(journal):
        return [(e["kind"], e["severity"], e["detail"])
                for e in journal.events()]

    assert events(obs.get_events()) == events(jev.get_events())
    assert [e["kind"] for e in obs.get_events().events()] == \
        ["train.segment", "train.checkpoint"] * 3

    def spans(tracer):
        return [(e["name"], e["cat"], e["args"].get("iterations"))
                for e in tracer.events()]

    assert spans(ptr_) == spans(jtr) == [
        ("train/dsgd", "compile", 1), ("train/dsgd", "execute", 1),
        ("train/dsgd", "execute", 1)]
    obs.validate_chrome_trace(ptr_.chrome_trace())
    # each event names the span it was emitted in: none (after the span)
    assert all(e["span_id"] is None for e in obs.get_events().events())


def test_dsgd_fit_device_spans_and_segments(both_obs):
    (_, _), (preg, ptr_) = both_obs
    rng = np.random.default_rng(0)
    n = 3000
    u, i = rng.integers(0, 100, n), rng.integers(0, 50, n)
    r = rng.normal(size=n).astype(np.float32)
    DSGD(DSGDConfig(**DSGD_KW), device="cpu").fit_device(
        u, i, r, 100, 50, num_blocks=2, checkpoint_every=1)
    keys = list(ptr_.key_walls())
    assert len(keys) == 1 and keys[0][:2] == ("train_segment",
                                              "dsgd_device_segment")
    assert preg.histogram("train_segment_s", model="dsgd").count == 3
    assert preg.gauge("train_throughput_ratings_per_s", model="dsgd",
                      phase="steady").value > 0


def test_als_fit_and_fit_device_publish_the_timer(both_obs):
    (jreg, _), (preg, _) = both_obs
    r = _ratings(seed=5, n=3000)
    kw = dict(num_factors=6, lambda_=0.05, iterations=2)
    JALS(JALSConfig(**kw)).fit(r)
    ALS(ALSConfig(**kw), device="cpu").fit(_port(r))
    assert _names(preg) == _names(jreg)
    rng = np.random.default_rng(1)
    u, i = rng.integers(0, 70, 2000), rng.integers(0, 30, 2000)
    v = rng.normal(size=2000).astype(np.float32)
    JALS(JALSConfig(**kw)).fit_device(u, i, v, 70, 30)
    ALS(ALSConfig(**kw), device="cpu").fit_device(u, i, v, 70, 30)
    assert _names(preg) == _names(jreg)
    assert preg.counter("train_segments_total", model="als").value == 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_mesh_dsgd_publishes_the_timer(both_obs):
    (jreg, _), (preg, _) = both_obs
    r = _ratings(seed=2, n=2000, users=50, items=40)
    kw = dict(num_factors=8, iterations=2, learning_rate=0.05,
              lambda_=0.05, minibatch_size=128, init_scale=0.3)
    JMeshDSGD(JMeshDSGDConfig(**kw),
              partitioner=JPartitioner(num_devices=1)).fit(
        r, checkpoint_every=1)
    initialize_distributed(DistributedConfig(
        f"tcp://127.0.0.1:{_free_port()}", 1, 0), device="cpu")
    try:
        assert torch.distributed.get_backend() == "gloo"
        MeshDSGD(MeshDSGDConfig(**kw),
                 partitioner=Partitioner(device="cpu")).fit(
            _port(r), checkpoint_every=1)
    finally:
        torch.distributed.destroy_process_group()
    jmesh = {k for k in _names(jreg) if dict(k[1]).get("model")
             == "mesh_dsgd"}
    pmesh = {k for k in _names(preg) if dict(k[1]).get("model")
             == "mesh_dsgd"}
    assert pmesh == jmesh and pmesh
    assert preg.counter("train_segments_total",
                        model="mesh_dsgd").value == 2


def test_online_checkpoint_notes_the_jax_bytes(tmp_path):
    """``save_online_state`` / ``restore_online_state`` with a ledger
    installed: the same sites, directions, counts and bytes as JAX's."""
    jprev, pprev = jtx.get_transfers(), obs.get_transfers()
    cfg = JOnlineMFConfig(num_factors=8, minibatch_size=128)
    jm = JOnlineMF(cfg)
    rng = np.random.default_rng(7)
    from large_scale_recommendation_tpu.core.types import Ratings as JR

    jm.partial_fit(JR.from_arrays(rng.integers(0, 90, 500),
                                  rng.integers(0, 40, 500),
                                  rng.normal(size=500).astype(np.float32)))
    pm = convert.online_from_jax(jm, device="cpu")
    out = []
    try:
        for tx, ck, model, fresh in (
                (jtx, jckpt, jm, lambda: JOnlineMF(cfg)),
                (obs.transfers, pckpt, pm,
                 lambda: convert.online_from_jax(JOnlineMF(cfg),
                                                 device="cpu"))):
            led = tx.TransferLedger()
            tx.set_transfers(led)
            mgr = ck.CheckpointManager(str(tmp_path / tx.__name__))
            ck.save_online_state(mgr, model, step=1)
            ck.restore_online_state(mgr, fresh())
            out.append({site: {k: v for k, v in s.items()
                               if k in ("h2d_bytes", "d2h_bytes",
                                        "h2d_count", "d2h_count")}
                        for site, s in led.snapshot()["sites"].items()})
    finally:
        jtx.set_transfers(jprev)
        obs.set_transfers(pprev)
    assert out[0] == out[1]
    assert set(out[1]) == {"checkpoint.snapshot", "checkpoint.restore"}
    assert out[1]["checkpoint.snapshot"]["d2h_bytes"] > 0


# -- the disabled path --------------------------------------------------------


class NoClock:
    """Stands in for ``time`` inside obs: a read is a failure."""

    def perf_counter(self):
        raise AssertionError("obs read the clock while disabled")

    time = perf_counter


def test_null_path_binds_singletons_and_reads_no_clock(port_null,
                                                       monkeypatch):
    timer = instrument.TrainSegmentTimer("dsgd", "k")
    assert timer._on is False
    assert timer._hist is NULL_INSTRUMENT
    assert timer._segments is NULL_INSTRUMENT
    assert not timer._trace.enabled and timer._trace is ptr.NULL_TRACER
    assert obs.get_introspector() is None and obs.get_transfers() is None
    assert obs.get_events() is None and _build._build_hook is None

    def no_block(x):
        raise AssertionError("obs waited on the card while disabled")

    monkeypatch.setattr(instrument, "time", NoClock())
    monkeypatch.setattr(ptr, "time", NoClock())
    monkeypatch.setattr(instrument, "_block", no_block)
    monkeypatch.setattr(ptr, "_block", no_block)
    solver = DSGD(DSGDConfig(**DSGD_KW), device="cpu")
    assert solver._events is None
    solver.fit(_port(_ratings()), checkpoint_every=1)
    ALS(ALSConfig(num_factors=4, iterations=1), device="cpu").fit(
        _port(_ratings(n=1000)))
    assert port_null.names() == set()
    assert port_null.snapshot()["metrics"] == []
    # the flight-recorder layer: no recorder, no sampler thread, and the
    # store and driver instruments are the null singletons
    from large_scale_recommendation_tpu_torch.core.initializers import (
        PseudoRandomFactorInitializer,
    )
    from large_scale_recommendation_tpu_torch.store import TieredFactorStore

    assert obs.get_recorder() is None
    assert not [t for t in threading.enumerate()
                if t.name in ("flight-recorder", "obs-introspect")]
    store = TieredFactorStore(PseudoRandomFactorInitializer(4),
                              slot_capacity=8, device="cpu")
    assert store._obs_on is False and store._m_evictions is NULL_INSTRUMENT
    store.acquire_rows(np.arange(20) % 8)
    assert port_null.names() == set()


def test_metrics_shims_record_nothing_when_disabled(port_null):
    t = metrics.StepTimer("x")
    with t.time([torch.ones(2)]):
        pass
    assert t.count == 1 and t._hist is NULL_INSTRUMENT
    log = metrics.MetricsLog(log_to=None)
    log.log("epoch", rmse=0.1)
    assert len(log.of("epoch")) == 1
    metrics.IngestStats(depth=3).publish()
    metrics.publish_fields({"a": 1.0})
    with metrics.profile(None):
        pass
    assert metrics.block({"a": [torch.ones(1)]})["a"][0].item() == 1.0
    assert port_null.names() == set()


def test_metrics_shims_mirror_into_a_live_registry(port_null):
    reg, _ = obs.enable()
    t = metrics.StepTimer("sweep")
    with t.time():
        pass
    assert reg.histogram("step_timer_s", name="sweep").count == 1
    log = metrics.MetricsLog(log_to=None)
    log.log("epoch")
    log.log("epoch")
    assert reg.counter("metrics_log_events_total", event="epoch").value == 2
    metrics.IngestStats(enqueued_records=42).publish(partition="1")
    assert reg.gauge("ingest_enqueued_records", partition="1").value == 42


def test_disable_restores_every_default(port_null, monkeypatch):
    from large_scale_recommendation_tpu_torch.obs import transfers

    modes = []
    monkeypatch.setattr(transfers, "_set_sync_debug_mode", modes.append)
    reg, tracer = obs.enable()
    tracer.install_build_hook(reg)
    obs.set_events(obs.EventJournal())
    ins = obs.enable_introspection(interval_s=60.0)
    assert ins.running
    obs.enable_transfers(guard="disallow")
    obs.disable()
    assert not ins.running
    assert not obs.enabled() and obs.get_tracer() is ptr.NULL_TRACER
    assert obs.get_introspector() is None and obs.get_transfers() is None
    assert obs.get_events() is None and _build._build_hook is None
    assert modes == [0]
