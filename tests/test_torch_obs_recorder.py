"""The port's flight recorder (``obs.recorder``) against the JAX package's:
the same (t, v) sequences through both ``SeriesRing``s give equal points,
downsampling tiers included; both recorders sampling registries built with
the same instruments and values give equal ``snapshot()`` series; a bundle
either package writes validates and loads under the other's
``validate_bundle`` / ``load_bundle``, and the port's files of the planes
not ported carry the JAX package's own "not installed" documents. Then the
port's own contracts: crash safety (a write interrupted before
``os.replace`` leaves only a ``.tmp-*`` orphan), the auto-named bundles,
the device-memory freeze off the main thread, the profiler note, and
``enable_flight_recorder`` / ``disable``. Exact equality throughout (host
arithmetic on the same floats); times are not compared."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from large_scale_recommendation_tpu import obs as jobs
from large_scale_recommendation_tpu.obs import events as jev
from large_scale_recommendation_tpu.obs import recorder as jrec
from large_scale_recommendation_tpu.obs import registry as jreg
from large_scale_recommendation_tpu.obs import trace as jtr
from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.obs import introspect
from large_scale_recommendation_tpu_torch.obs import recorder as prec
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIX_C_FILES = ("lineage.json", "contention.json", "budget.json",
               "requests.json")


@pytest.fixture
def port_flight():
    """A live port registry, tracer, journal and (unstarted) recorder; the
    previous planes restored and every thread stopped after."""
    prev = (obs.get_registry(), obs.get_tracer(), obs.get_events(),
            obs.get_recorder(), obs.get_introspector(), obs.get_transfers(),
            obs.get_store())
    obs.set_store(None)
    reg, tracer = obs.enable()
    rec, journal = obs.enable_flight_recorder(start=False)
    yield reg, tracer, rec, journal
    obs.disable()
    obs.set_registry(prev[0])
    obs.set_tracer(prev[1])
    obs.set_events(prev[2])
    obs.set_recorder(prev[3])
    obs.set_introspector(prev[4])
    obs.set_transfers(prev[5])
    obs.set_store(prev[6])


@pytest.fixture
def jax_flight():
    """The same in the JAX package."""
    from large_scale_recommendation_tpu.obs import store as jstore
    from large_scale_recommendation_tpu.obs import transfers as jtx

    prev = (jreg.get_registry(), jtr.get_tracer(), jev.get_events(),
            jrec.get_recorder(), jstore.get_store(), jtx.get_transfers())
    jstore.set_store(None)
    jtx.set_transfers(None)
    reg, tracer = jobs.enable()
    rec, journal = jobs.enable_flight_recorder(start=False)
    yield reg, tracer, rec, journal
    rec.stop()
    jreg.set_registry(prev[0])
    jtr.set_tracer(prev[1])
    jev.set_events(prev[2])
    jrec.set_recorder(prev[3])
    jstore.set_store(prev[4])
    jtx.set_transfers(prev[5])


# -- SeriesRing --------------------------------------------------------------


@pytest.mark.parametrize("geometry", [(4, 3, 2), (8, 0, 1), (5, 7, 3),
                                      (64, 32, 4), (1, 1, 1)])
def test_series_ring_points_equal_jax(geometry):
    rng = np.random.default_rng(sum(geometry))
    t = np.cumsum(rng.uniform(0.0, 1.0, 700))
    v = rng.normal(size=700)
    v[rng.integers(0, 700, 10)] = np.nan
    j, p = jrec.SeriesRing(*geometry), prec.SeriesRing(*geometry)
    for i, (a, b) in enumerate(zip(t, v)):
        j.append(a, b)
        p.append(a, b)
        if i % 97 == 0:
            assert len(p) == len(j)
    np.testing.assert_array_equal(np.array(p.points()),
                                  np.array(j.points()))
    for n in (None, 1, 5, 10_000):
        np.testing.assert_array_equal(p.values(n), j.values(n))
    assert len(p) <= geometry[0] + geometry[1]


def test_series_ring_refuses_bad_geometry_as_jax():
    for g in [(0, 1, 1), (1, -1, 1), (1, 1, 0)]:
        with pytest.raises(ValueError):
            jrec.SeriesRing(*g)
        with pytest.raises(ValueError):
            prec.SeriesRing(*g)


# -- sampling ----------------------------------------------------------------


def _fill(reg, rng_seed, step):
    """The same instruments with the same values in either registry."""
    rng = np.random.default_rng(rng_seed + step)
    reg.counter("streams_batches_total", partition="0").inc(
        float(rng.integers(1, 5)))
    reg.gauge("device_bytes_in_use", device="cuda:0").set(
        float(rng.integers(1, 1 << 30)))
    reg.gauge("eval_rmse", source="online").set(float(rng.uniform()))
    reg.gauge("quoted", check='lag{partition="0"}').set(step)
    h = reg.histogram("dsgd_segment_s", route="cuda")
    for x in rng.exponential(0.01, 20):
        h.observe(float(x))
    if step == 1:
        reg.gauge("late_arrival").set(float("nan"))


@pytest.mark.parametrize("fields", [("count", "p50", "p99"), ("p90",)])
def test_recorder_snapshot_series_equal_jax(fields):
    jr, pr = jreg.MetricsRegistry(), MetricsRegistry()
    j = jrec.FlightRecorder(registry=jr, histogram_fields=fields,
                            recent_points=3, decimated_points=2,
                            decimation=2)
    p = prec.FlightRecorder(registry=pr, histogram_fields=fields,
                            recent_points=3, decimated_points=2,
                            decimation=2)
    for step in range(6):
        _fill(jr, 11, step)
        _fill(pr, 11, step)
        assert p.sample() == j.sample()
    js, ps = j.snapshot(), p.snapshot()
    for k in ("interval_s", "samples", "series_count", "max_series",
              "dropped_series", "tiering"):
        assert ps[k] == js[k], k
    assert list(ps["series"]) == list(js["series"])
    for key, s in ps["series"].items():
        assert s["n"] == js["series"][key]["n"]
        assert ([v for _, v in s["points"]]
                == [v for _, v in js["series"][key]["points"]]), key
    assert p.series_names() == j.series_names()
    key = prec.series_key("dsgd_segment_s", {"route": "cuda"}, fields[0])
    assert key == jrec.series_key("dsgd_segment_s", {"route": "cuda"},
                                  fields[0])
    assert p.series_values(key, last_n=2) == j.series_values(key, last_n=2)


def test_series_cap_and_overflow_equal_jax():
    jr, pr = jreg.MetricsRegistry(), MetricsRegistry()
    j = jrec.FlightRecorder(registry=jr, max_series=3)
    p = prec.FlightRecorder(registry=pr, max_series=3)
    for step in range(3):
        for i in range(5 + step):
            jr.gauge("g", i=i).set(i)
            pr.gauge("g", i=i).set(i)
        assert p.sample() == j.sample()
    # 4 distinct keys refused, the refusal set saturating at max_series
    assert p.dropped_series == j.dropped_series == 3
    assert p.series_names() == j.series_names()


def test_sample_reads_floats_from_tensor_values(port_flight):
    """A 0-d tensor handed to an instrument is converted as it is taken,
    so a sample (on the recorder's thread) reads a Python float."""
    import torch

    reg, _, rec, _ = port_flight
    reg.gauge("loss").set(torch.tensor(0.5))
    reg.counter("rows").inc(torch.tensor(3))
    reg.gauge("depth").add(torch.tensor(2.0))
    assert all(type(m["value"]) is float for m in reg.snapshot()["metrics"])
    rec.sample()
    assert rec.series_values("rows") == [3.0]


def test_start_stop_and_restart_on_a_new_cadence(port_flight):
    _, _, rec, _ = port_flight
    rec.start(interval_s=0.02)
    task = rec._task
    assert rec.running and rec.start(interval_s=0.02)._task is task
    rec.start(interval_s=0.05)
    assert rec._task is not task and not task.running
    assert rec.interval_s == 0.05
    rec.stop()
    assert not rec.running


# -- bundles across packages --------------------------------------------------


def _lead_up(reg, rec, journal, tracer):
    for step in range(4):
        _fill(reg, 3, step)
        rec.sample()
    with tracer.span("train/dsgd", key="k"):
        journal.emit("train.segment", segment=1, loss=float("nan"))


def test_port_bundle_validates_under_jax(port_flight, tmp_path):
    reg, tracer, rec, journal = port_flight
    _lead_up(reg, rec, journal, tracer)
    path = rec.dump(trigger="manual", detail={"loss": float("inf")},
                    directory=str(tmp_path / "port_bundle"))
    manifest = jrec.validate_bundle(path)
    assert manifest == prec.validate_bundle(path)
    assert manifest["bundle_version"] == jrec.BUNDLE_VERSION == 8
    assert manifest["files"] == list(jrec.BUNDLE_FILES)
    assert manifest["detail"]["loss"] == "inf"
    loaded = jrec.load_bundle(path)
    assert loaded["events"][-1]["kind"] == "train.segment"
    assert loaded["health"]["status"] == "unknown"
    assert set(loaded["series"]["series"]) == set(rec.series_names())
    assert loaded["device_memory"]["note"] == "no introspector installed"
    assert loaded["store"]["note"] == "no tiered store installed"


def test_jax_bundle_validates_under_the_port(jax_flight, tmp_path):
    reg, tracer, rec, journal = jax_flight
    _lead_up(reg, rec, journal, tracer)
    path = rec.dump(trigger="watchdog_trip",
                    directory=str(tmp_path / "jax_bundle"))
    manifest = prec.validate_bundle(path)
    assert manifest["trigger"] == "watchdog_trip"
    loaded = prec.load_bundle(path)
    assert set(loaded) == set(jrec.load_bundle(path))
    assert loaded["events"][-1]["kind"] == "train.segment"


def test_unported_planes_carry_the_jax_notes(port_flight, jax_flight,
                                            tmp_path):
    """Neither process has the next slice's planes installed: the port's
    files for them equal the JAX package's, and ``lineage.json`` freezes
    the same ``eval_`` gauges."""
    for reg in (port_flight[0], jax_flight[0]):
        reg.gauge("eval_rmse", source="online").set(0.25)
        reg.gauge("eval_ndcg_at_k", source="online", k="10").set(0.5)
    p = port_flight[2].dump(directory=str(tmp_path / "p"))
    j = jax_flight[2].dump(directory=str(tmp_path / "j"))
    for name in SIX_C_FILES:
        with open(os.path.join(p, name)) as f, \
                open(os.path.join(j, name)) as g:
            assert json.load(f) == json.load(g), name
    with open(os.path.join(p, "transfers.json")) as f:
        assert json.load(f) == {"note": "transfer ledger not enabled",
                                "sites": {}}


def test_version_one_bundles_still_load(port_flight, tmp_path):
    """An archived bundle of an earlier schema version validates per the
    version it declares (the JAX loader's rule)."""
    path = port_flight[2].dump(directory=str(tmp_path / "b"))
    mpath = os.path.join(path, "manifest.json")
    manifest = json.load(open(mpath))
    manifest["bundle_version"] = 1
    manifest["files"] = list(prec.BUNDLE_FILES[:6])
    json.dump(manifest, open(mpath, "w"))
    for name in prec.BUNDLE_FILES[6:]:
        os.remove(os.path.join(path, name))
    for mod in (prec, jrec):
        loaded = mod.load_bundle(path)
        assert loaded["device_memory"]["devices"] == []
        assert loaded["requests"]["exemplars"] == []


def test_validate_rejects_missing_and_corrupt_files(port_flight, tmp_path):
    path = port_flight[2].dump(directory=str(tmp_path / "b"))
    os.remove(os.path.join(path, "store.json"))
    for mod in (prec, jrec):
        with pytest.raises(ValueError, match="store.json"):
            mod.validate_bundle(path)
    path = port_flight[2].dump(directory=str(tmp_path / "c"))
    with open(os.path.join(path, "series.json"), "w") as f:
        f.write("{not json")
    for mod in (prec, jrec):
        with pytest.raises(ValueError, match="series.json"):
            mod.validate_bundle(path)


# -- crash safety and naming --------------------------------------------------


def test_a_failed_write_leaves_nothing(port_flight, tmp_path, monkeypatch):
    def boom(*a):
        raise OSError("disk full")

    monkeypatch.setattr(prec.os, "replace", boom)
    with pytest.raises(OSError, match="disk full"):
        prec.write_bundle(str(tmp_path / "b"), trigger="manual")
    assert os.listdir(tmp_path) == []


def test_a_crash_before_replace_leaves_only_a_tmp_orphan(tmp_path):
    """The process dies where ``os.replace`` would publish: the final path
    never exists, only the ``.tmp-*`` directory does."""
    code = (
        "import os, sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from large_scale_recommendation_tpu_torch.obs import recorder\n"
        "recorder.os.replace = lambda a, b: os._exit(3)\n"
        f"recorder.write_bundle({str(tmp_path / 'b')!r}, trigger='crash')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 3, out.stderr[-2000:]
    left = os.listdir(tmp_path)
    assert len(left) == 1 and left[0].startswith("b.tmp-"), left
    assert "manifest.json" in os.listdir(tmp_path / left[0])


def test_auto_names_never_clobber_and_count_on(port_flight, tmp_path):
    _, _, rec, _ = port_flight
    rec.bundle_dir = str(tmp_path)
    os.makedirs(tmp_path / "bundle_watchdog_trip_000")
    a = rec.dump(trigger="watchdog_trip")
    b = rec.dump(trigger="watchdog_trip")
    assert [os.path.basename(x) for x in (a, b)] == [
        "bundle_watchdog_trip_001", "bundle_watchdog_trip_002"]
    assert rec.bundles_written == 2 and rec.last_bundle == b


def test_concurrent_dumps_write_whole_bundles(port_flight, tmp_path):
    _, _, rec, _ = port_flight
    rec.bundle_dir = str(tmp_path / "pm")
    errors = []

    def dump():
        try:
            rec.dump(trigger="race")
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=dump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    names = sorted(os.listdir(tmp_path / "pm"))
    assert len(names) == 4
    for n in names:
        prec.validate_bundle(str(tmp_path / "pm" / n))


def test_maybe_dump_keeps_the_error_and_answers_none(port_flight, tmp_path,
                                                     monkeypatch):
    _, _, rec, _ = port_flight
    assert rec.maybe_dump("watchdog_trip") is None  # no bundle_dir
    rec.bundle_dir = str(tmp_path)

    def boom(*a, **k):
        raise OSError("read-only file system")

    monkeypatch.setattr(prec, "write_bundle", boom)
    assert rec.maybe_dump("watchdog_trip") is None
    assert "read-only" in rec.last_dump_error


# -- the device-memory freeze and the profiler note ---------------------------


def test_live_tensor_walk_runs_on_the_main_thread_only(port_flight,
                                                       tmp_path):
    obs.enable_introspection(start=False, hbm_peak_gbs=3350.0,
                             fp32_peak_tflops=67.0)
    rec = port_flight[2]
    main = prec.load_bundle(rec.dump(directory=str(tmp_path / "main")))
    assert main["device_memory"]["live_arrays"] is not None
    assert "live_arrays_note" not in main["device_memory"]
    got = {}
    t = threading.Thread(target=lambda: got.setdefault(
        "path", rec.dump(directory=str(tmp_path / "side"))), name="scraper")
    t.start()
    t.join(timeout=60)
    side = prec.load_bundle(got["path"])["device_memory"]
    assert side["live_arrays"] is None
    assert "off the main thread (scraper)" in side["live_arrays_note"]
    assert side["devices"] == main["device_memory"]["devices"]


def test_trip_profile_answers_a_note_while_a_capture_runs(port_flight,
                                                          tmp_path):
    _, _, rec, _ = port_flight
    rec.bundle_dir = str(tmp_path)
    rec.profile_on_trip_s = 0.01
    assert introspect._PROFILE_LOCK.acquire(blocking=False)
    try:
        path = rec.dump(trigger="watchdog_trip")
    finally:
        introspect._PROFILE_LOCK.release()
    note = json.load(open(os.path.join(path, "profile", "note.json")))
    assert "already in progress" in note["note"]
    prec.validate_bundle(path)
    manual = rec.dump(trigger="manual")  # manual dumps never profile
    assert not os.path.exists(os.path.join(manual, "profile"))


def test_trip_profile_attaches_a_trace(port_flight, tmp_path):
    _, _, rec, _ = port_flight
    rec.bundle_dir = str(tmp_path)
    rec.profile_on_trip_s = 0.01
    path = rec.dump(trigger="health_critical")
    assert os.path.isfile(os.path.join(path, "profile",
                                       introspect.TRACE_FILE))
    prec.validate_bundle(path)


def test_config_freezes_the_cards_env_prefixes(port_flight, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    monkeypatch.setenv("NCCL_DEBUG", "WARN")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    path = port_flight[2].dump(directory=str(tmp_path / "b"))
    env = prec.load_bundle(path)["config"]["env"]
    assert env["PYTORCH_CUDA_ALLOC_CONF"] == "expandable_segments:True"
    assert env["NCCL_DEBUG"] == "WARN" and "JAX_PLATFORMS" not in env


# -- enable / disable ---------------------------------------------------------


def test_enable_flight_recorder_replaces_and_disable_clears(port_flight):
    _, _, first, _ = port_flight
    first.start(interval_s=60.0)
    second, journal = obs.enable_flight_recorder(interval_s=60.0)
    assert not first.running and second.running
    assert obs.get_recorder() is second and obs.get_events() is journal
    obs.disable()
    assert not second.running
    assert obs.get_recorder() is None and obs.get_events() is None
    assert not [t for t in threading.enumerate()
                if t.name == "flight-recorder" and t.is_alive()]
