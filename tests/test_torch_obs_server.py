"""The port's endpoint server (``obs.server.ObsServer``) against the JAX
package's, both serving over real sockets on loopback: over registries
holding the same instruments and values ``/metrics`` is byte-equal and
``/varz`` equal once its time field is dropped; ``/healthz`` answers the
same codes for OK, DEGRADED and CRITICAL monitors; both answer 400 on a bad
``?limit=`` and 404 on an unknown path. Then the port's own routes:
``/seriesz``, ``/eventz``, ``/tracez``, ``/rooflinez``, ``/storez``,
``/transferz``, ``/profilez`` (200 with a trace listed; 409 while another
capture runs), the routes of the planes not ported (404, unlisted) and the
server's lifecycle. Every server is stopped by its fixture."""

import json
import os

import numpy as np
import pytest

from large_scale_recommendation_tpu.obs import health as jh
from large_scale_recommendation_tpu.obs import registry as jreg
from large_scale_recommendation_tpu.obs.server import ObsServer as JServer
from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.obs import health as ph
from large_scale_recommendation_tpu_torch.obs import introspect
from large_scale_recommendation_tpu_torch.obs import server as psrv
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry
from large_scale_recommendation_tpu_torch.obs.trace import Tracer

TIMEOUT = 5.0


def get(url):
    return psrv.http_get(url, timeout=TIMEOUT)


@pytest.fixture
def servers():
    """Start servers through ``start(server)``; all are stopped after."""
    started = []

    def start(server):
        started.append(server.start())
        return server

    yield start
    for s in started:
        s.stop()
    assert not any(s.running for s in started)


@pytest.fixture
def port_planes():
    """The port's module-default planes restored after the test."""
    prev = (obs.get_registry(), obs.get_tracer(), obs.get_events(),
            obs.get_recorder(), obs.get_introspector(), obs.get_transfers(),
            obs.get_store())
    obs.set_store(None)
    yield
    obs.disable()
    obs.set_registry(prev[0])
    obs.set_tracer(prev[1])
    obs.set_events(prev[2])
    obs.set_recorder(prev[3])
    obs.set_introspector(prev[4])
    obs.set_transfers(prev[5])
    obs.set_store(prev[6])


def _fill(reg, seed=0):
    rng = np.random.default_rng(seed)
    reg.counter("streams_batches_total", partition="0").inc(7)
    reg.counter("transfer_bytes_total", site="ckpt", dir="d2h").inc(
        float(rng.integers(1, 1 << 20)))
    reg.gauge("device_bytes_in_use", device="cuda:0").set(
        float(rng.integers(1, 1 << 30)))
    reg.gauge("health_check_status", check='anomaly:lag{p="0"}').set(1)
    reg.gauge("poisoned").set(float("nan"))
    for x in rng.exponential(0.02, 50):
        reg.histogram("dsgd_segment_s", route="cuda").observe(float(x))
    reg.histogram("empty_s")


def _pair(servers, jmon=None, pmon=None):
    jr, pr = jreg.MetricsRegistry(), MetricsRegistry()
    _fill(jr)
    _fill(pr)
    j = servers(JServer(registry=jr, monitor=jmon))
    p = servers(psrv.ObsServer(registry=pr, tracer=Tracer(), monitor=pmon))
    return j, p


def test_metrics_byte_equal_and_varz_equal_jax(servers):
    j, p = _pair(servers)
    jc, jt = get(j.url + "/metrics")
    pc, pt = get(p.url + "/metrics")
    assert (pc, jc) == (200, 200) and pt == jt
    jc, jv = get(j.url + "/varz")
    pc, pv = get(p.url + "/varz")
    jv, pv = json.loads(jv), json.loads(pv)
    jv.pop("time")
    pv.pop("time")
    assert pv == jv


@pytest.mark.parametrize("status", ["ok", "degraded", "critical"])
def test_healthz_codes_equal_jax(servers, status):
    jm, pm = jh.HealthMonitor(), ph.HealthMonitor(registry=MetricsRegistry())
    jm.register("probe", lambda: jh.CheckResult(status, {"n": 1}))
    pm.register("probe", lambda: ph.CheckResult(status, {"n": 1}))
    j, p = _pair(servers, jm, pm)
    (jc, jb), (pc, pb) = get(j.url + "/healthz"), get(p.url + "/healthz")
    assert pc == jc == (503 if status == "critical" else 200)
    jb, pb = json.loads(jb), json.loads(pb)
    assert pb["status"] == jb["status"] == status
    assert pb["checks"] == jb["checks"]
    assert get(p.url + "/health")[0] == pc


def test_healthz_without_a_monitor_is_ok(servers):
    j, p = _pair(servers)
    assert get(p.url + "/healthz") == get(j.url + "/healthz")


@pytest.mark.parametrize("query", ["/tracez?limit=x", "/tracez?limit=-1",
                                   "/profilez?seconds=soon"])
def test_bad_queries_answer_400_as_jax(servers, query):
    j, p = _pair(servers)
    assert get(p.url + query)[0] == get(j.url + query)[0] == 400


def test_unknown_paths_answer_404_as_jax(servers):
    j, p = _pair(servers)
    assert get(p.url + "/nope")[0] == get(j.url + "/nope")[0] == 404


@pytest.mark.parametrize("route", ["/lineagez", "/criticalpathz",
                                   "/contentionz", "/budgetz", "/slowz"])
def test_unported_plane_routes_answer_404(servers, route):
    j, p = _pair(servers)
    assert get(j.url + route)[0] == 200
    assert get(p.url + route)[0] == 404
    routes = json.loads(get(p.url + "/")[1])["routes"]
    assert route not in routes
    assert set(routes) == set(psrv.ROUTES)
    assert set(routes) < set(json.loads(get(j.url + "/")[1])["routes"])


def test_tracez_limit_and_buffer(servers):
    tracer = Tracer()
    for i in range(5):
        with tracer.span(f"s{i}"):
            pass
    p = servers(psrv.ObsServer(registry=MetricsRegistry(), tracer=tracer,
                               tracez_limit=2))
    doc = json.loads(get(p.url + "/tracez")[1])
    assert [e["name"] for e in doc["recent"]] == ["s3", "s4"]
    assert doc["total_buffered"] == 5 and doc["dropped"] == 0
    assert len(json.loads(get(p.url + "/tracez?limit=0")[1])["recent"]) == 5
    assert len(json.loads(get(p.url + "/tracez?limit=3")[1])["recent"]) == 3


def test_planes_routes_follow_the_installed_planes(servers, port_planes):
    reg, _ = obs.enable()
    rec, journal = obs.enable_flight_recorder(start=False)
    obs.enable_introspection(start=False, hbm_peak_gbs=3350.0,
                             fp32_peak_tflops=67.0)
    reg.gauge("eval_rmse", source="online").set(0.5)
    rec.sample()
    journal.emit("train.segment", segment=1)
    p = servers(psrv.ObsServer())
    series = json.loads(get(p.url + "/seriesz")[1])
    assert 'eval_rmse{source="online"}' in series["series"]
    events = json.loads(get(p.url + "/eventz")[1])
    assert events["recent"][-1]["kind"] == "train.segment"
    roof = json.loads(get(p.url + "/rooflinez")[1])
    assert roof["rows"] == [] and "transfer_site_gbs" not in roof
    assert json.loads(get(p.url + "/storez")[1])["note"].startswith(
        "no tiered store")
    assert json.loads(get(p.url + "/transferz")[1])["note"]
    obs.enable_transfers(watch_hot=False)  # resolved per request
    roof = json.loads(get(p.url + "/rooflinez")[1])
    assert roof["transfer_site_gbs"] == {}
    assert "sites" in json.loads(get(p.url + "/transferz")[1])


def test_routes_without_planes_answer_notes(servers, port_planes):
    obs.disable()
    p = servers(psrv.ObsServer())
    for route in ("/seriesz", "/eventz", "/rooflinez"):
        code, body = get(p.url + route)
        assert code == 200 and "note" in json.loads(body), route


def test_profilez_captures_and_refuses_a_second_capture(servers, tmp_path):
    p = servers(psrv.ObsServer(registry=MetricsRegistry(), tracer=Tracer(),
                               profile_dir=str(tmp_path)))
    code, body = get(p.url + "/profilez?seconds=0.05")
    doc = json.loads(body)
    assert code == 200 and introspect.TRACE_FILE in doc["files"]
    assert os.path.dirname(doc["dir"]) == str(tmp_path)
    assert introspect._PROFILE_LOCK.acquire(blocking=False)
    try:
        code, body = get(p.url + "/profilez?seconds=0.05")
    finally:
        introspect._PROFILE_LOCK.release()
    assert code == 409 and "in progress" in json.loads(body)["error"]
    assert len(os.listdir(tmp_path)) == 1  # the refused capture left none


def test_profilez_caps_the_window(servers, tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(introspect, "capture_profile",
                        lambda d, s: seen.append(s) or {"dir": d})
    p = servers(psrv.ObsServer(registry=MetricsRegistry(), tracer=Tracer(),
                               profile_dir=str(tmp_path)))
    for q in ("", "?seconds=-3", "?seconds=1e9"):
        assert get(p.url + "/profilez" + q)[0] == 200
    assert seen == [psrv.DEFAULT_PROFILE_SECONDS, 0.0,
                    psrv.MAX_PROFILE_SECONDS]


def test_a_route_that_raises_answers_500(servers):
    mon = ph.HealthMonitor(registry=MetricsRegistry())
    mon.run = lambda: 1 / 0
    p = servers(psrv.ObsServer(registry=MetricsRegistry(), tracer=Tracer(),
                               monitor=mon))
    code, body = get(p.url + "/healthz")
    assert code == 500 and "ZeroDivisionError" in body
    assert get(p.url + "/metrics")[0] == 200  # the server lives on


def test_lifecycle_rebinds_and_refuses_a_taken_port(servers):
    p = servers(psrv.ObsServer(registry=MetricsRegistry(), tracer=Tracer()))
    first = p.port
    assert p.start() is p and p.port == first  # idempotent
    p.stop()
    assert not p.running and get(p.url + "/metrics")[0] == 599
    p.start()
    assert p.running and get(p.url + "/metrics")[0] == 200
    taken = psrv.ObsServer(registry=MetricsRegistry(), tracer=Tracer(),
                           port=p.port)
    with pytest.raises(OSError):
        taken.start()
    with psrv.ObsServer(registry=MetricsRegistry(),
                        tracer=Tracer()) as ctx:
        assert get(ctx.url + "/")[0] == 200
    assert not ctx.running


def test_parse_query_int_as_jax():
    from large_scale_recommendation_tpu.obs.server import (
        parse_query_int as j_parse,
    )

    for q in ("", "limit=5", "limit=0", "limit=x", "limit=-2", "other=1",
              "limit=3&limit=4"):
        assert psrv.parse_query_int(q, "limit") == j_parse(q, "limit")


def test_profilez_sees_every_threads_host_ops(servers, tmp_path):
    """The capture runs on a handler thread; the host ops the main thread
    issues meanwhile are in its trace (``capture_profile`` profiles every
    thread)."""
    import threading
    import time

    import torch

    p = servers(psrv.ObsServer(registry=MetricsRegistry(), tracer=Tracer(),
                               profile_dir=str(tmp_path)))
    got = {}
    t = threading.Thread(target=lambda: got.setdefault(
        "r", get(p.url + "/profilez?seconds=0.3")))
    t.start()
    x = torch.ones(64)
    end = time.perf_counter() + 0.4
    while time.perf_counter() < end:
        x = x * 1.0
    t.join(timeout=30)
    code, body = got["r"]
    assert code == 200, body
    doc = json.loads(body)
    with open(os.path.join(doc["dir"], introspect.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "cpu_op"}
    assert "aten::mul" in names


def test_the_first_capture_of_a_process_sees_host_ops(tmp_path):
    """In a fresh interpreter the server's first ``/profilez`` (a handler
    thread) still records the main thread's host ops: ``start()`` warmed
    the profiler on the main thread (without it, torch's profiler library
    initializes on the capture's thread and records none)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import json, os, sys, threading, time\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {repo!r})\n"
        "import torch\n"
        "from large_scale_recommendation_tpu_torch.obs import server\n"
        "from large_scale_recommendation_tpu_torch.obs.registry import "
        "MetricsRegistry\n"
        "from large_scale_recommendation_tpu_torch.obs.trace import Tracer\n"
        "s = server.ObsServer(registry=MetricsRegistry(), tracer=Tracer(),"
        f" profile_dir={str(tmp_path)!r}).start()\n"
        "got = {}\n"
        "t = threading.Thread(target=lambda: got.setdefault('r', "
        "server.http_get(s.url + '/profilez?seconds=0.3', timeout=5)))\n"
        "t.start()\n"
        "x = torch.ones(64)\n"
        "end = time.perf_counter() + 0.4\n"
        "while time.perf_counter() < end:\n"
        "    x = x * 1.0\n"
        "t.join(30)\n"
        "s.stop()\n"
        "doc = json.loads(got['r'][1])\n"
        "ev = json.load(open(os.path.join(doc['dir'], 'trace.json')))\n"
        "print(sum(1 for e in ev['traceEvents'] if e.get('name') == "
        "'aten::mul'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.strip().splitlines()[-1]) > 0
