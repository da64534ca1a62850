"""The port's fleet view (``obs.fleet``) against the JAX package's:
``parse_prometheus``, ``add_host_label`` and ``merge_prometheus`` give
equal outputs on the same texts (escaped label values, histograms, empty
bodies, malformed lines refused alike); the port's ``FleetAggregator``
scraping one JAX and one port ``ObsServer`` gives the JAX aggregator's
``/fleetz`` merge, worst-status-wins health and transfer view; an
unreachable member counts CRITICAL; the ``FleetServer`` routes. Then the
pod views of the serving and stream planes (``pod_trace`` / ``/podtracez``,
``contention``, ``budget``, ``requests``) against the JAX aggregator's over
the same two servers. Every server is stopped by its fixture; scrapes time
out at 5 s."""

import json

import numpy as np
import pytest

from large_scale_recommendation_tpu.obs import fleet as jfleet
from large_scale_recommendation_tpu.obs import health as jh
from large_scale_recommendation_tpu.obs import registry as jreg
from large_scale_recommendation_tpu.obs import transfers as jtx
from large_scale_recommendation_tpu.obs.server import ObsServer as JServer
from large_scale_recommendation_tpu_torch import obs
from large_scale_recommendation_tpu_torch.obs import fleet as pfleet
from large_scale_recommendation_tpu_torch.obs import health as ph
from large_scale_recommendation_tpu_torch.obs.registry import MetricsRegistry
from large_scale_recommendation_tpu_torch.obs.server import (
    ObsServer,
    http_get,
)
from large_scale_recommendation_tpu_torch.obs.trace import Tracer

TIMEOUT = 5.0


def _text(seed):
    reg = MetricsRegistry()
    rng = np.random.default_rng(seed)
    reg.counter("pod_requests_total", tier="serving").inc(
        float(rng.integers(1, 100)))
    reg.gauge("health_check_status", check='lag{partition="0"}').set(1)
    reg.gauge("odd", note='a\\b "c"\nd').set(2.5)
    reg.gauge("bare").set(float(rng.uniform()))
    for x in rng.exponential(0.1, 30):
        reg.histogram("serve_s", route="exact").observe(float(x))
    return reg.to_prometheus()


TEXTS = [_text(0), _text(1), "", "# TYPE lonely gauge\n"]


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_parse_and_host_label_equal_jax(i):
    text = TEXTS[i]
    assert pfleet.parse_prometheus(text) == jfleet.parse_prometheus(text)
    for host in ("127.0.0.1:8321", 'we"ird\\host'):
        out = pfleet.add_host_label(text, host)
        assert out == jfleet.add_host_label(text, host)
        assert pfleet.parse_prometheus(out) == jfleet.parse_prometheus(out)


def test_merge_equal_jax():
    bodies = [("a:1", TEXTS[0]), ("b:2", TEXTS[1]), ("c:3", TEXTS[2]),
              ("d:4", TEXTS[3])]
    merged = pfleet.merge_prometheus(bodies)
    assert merged == jfleet.merge_prometheus(bodies)
    hosts = {lb["host"] for _, lb, _ in pfleet.parse_prometheus(merged)}
    assert hosts == {"a:1", "b:2"}
    assert pfleet.merge_prometheus([]) == jfleet.merge_prometheus([]) == ""


@pytest.mark.parametrize("bad", ["metric{x=\"1\" 2", "metric 1 2 3",
                                 "metric{x=1} 2", "metric NaNx"])
def test_parse_refuses_as_jax(bad):
    for mod in (pfleet, jfleet):
        with pytest.raises(ValueError):
            mod.parse_prometheus(bad)


@pytest.fixture
def pod():
    """One JAX and one port ``ObsServer`` with their monitors and
    registries; both servers stopped and the JAX ledger restored after."""
    jr, pr = jreg.MetricsRegistry(), MetricsRegistry()
    jr.counter("pod_requests_total", tier="serving").inc(5)
    pr.counter("pod_requests_total", tier="serving").inc(7)
    jr.gauge("odd", note='x"y').set(1)
    pr.gauge("odd", note='x"y').set(2)
    jm, pm = jh.HealthMonitor(registry=jr), ph.HealthMonitor(registry=pr)
    state = {"j": "ok", "p": "ok"}
    jm.register("probe", lambda: jh.CheckResult(state["j"], {}))
    pm.register("probe", lambda: ph.CheckResult(state["p"], {}))
    js = JServer(registry=jr, monitor=jm).start()
    ps = ObsServer(registry=pr, tracer=Tracer(), monitor=pm).start()
    jprev = jtx.get_transfers()
    yield js, ps, state
    js.stop()
    ps.stop()
    jtx.set_transfers(jprev)


def _strip(view):
    """A scrape without its times (and with the targets' health reports
    reduced to their statuses)."""
    view = dict(view)
    view.pop("time")
    view["targets"] = [
        {k: (v["status"] if k == "report" else v) for k, v in t.items()}
        for t in view["targets"]]
    return view


def test_fleetz_merge_equal_jax(pod):
    js, ps, _ = pod
    targets = [js.url, ps.url]
    pv = pfleet.FleetAggregator(targets, timeout_s=TIMEOUT).scrape()
    jv = jfleet.FleetAggregator(targets, timeout_s=TIMEOUT).scrape()
    assert _strip(pv) == _strip(jv)
    samples = pfleet.parse_prometheus(pv["prometheus"])
    by_host = {lb["host"]: v for n, lb, v in samples
               if n == "pod_requests_total"}
    assert by_host == {f"127.0.0.1:{js.port}": 5.0,
                       f"127.0.0.1:{ps.port}": 7.0}


@pytest.mark.parametrize("j,p,want", [("ok", "ok", "ok"),
                                      ("degraded", "ok", "degraded"),
                                      ("ok", "critical", "critical")])
def test_worst_status_wins_as_jax(pod, j, p, want):
    js, ps, state = pod
    state.update(j=j, p=p)
    targets = [js.url, ps.url]
    pc, pr = pfleet.FleetAggregator(targets, timeout_s=TIMEOUT).healthz()
    jc, jr = jfleet.FleetAggregator(targets, timeout_s=TIMEOUT).healthz()
    assert (pc, pr["status"]) == (jc, jr["status"])
    assert pr["status"] == want and pc == (503 if want == "critical"
                                           else 200)
    assert pr["targets"] == jr["targets"]


def test_unreachable_member_is_critical(pod):
    js, ps, _ = pod
    dead = ps.url
    ps.stop()
    agg = pfleet.FleetAggregator([js.url, dead], timeout_s=TIMEOUT)
    view = agg.scrape()
    statuses = {t["url"]: t["status"] for t in view["targets"]}
    assert statuses[dead] == pfleet.FleetAggregator.UNREACHABLE
    assert view["status"] == ph.CRITICAL and view["reachable"] == 1
    code, report = agg.healthz()
    assert code == 503 and report["status"] == ph.CRITICAL


def test_transfers_view_equal_jax(pod):
    js, ps, _ = pod
    ledger = jtx.TransferLedger()
    ledger.note_transfer("checkpoint.snapshot", "d2h", 4096, 0.002)
    jtx.set_transfers(ledger)
    prev = obs.get_transfers()
    pl = obs.TransferLedger()
    pl.note_transfer("checkpoint.snapshot", "d2h", 1024, 0.001)
    pl.note_transfer("checkpoint.restore", "h2d", 512, 0.001)
    obs.set_transfers(pl)
    try:
        targets = [js.url, ps.url]
        pv = pfleet.FleetAggregator(targets, timeout_s=TIMEOUT).transfers()
        jv = jfleet.FleetAggregator(targets, timeout_s=TIMEOUT).transfers()
    finally:
        obs.set_transfers(prev)
    pv.pop("time")
    jv.pop("time")
    assert pv == jv
    snap = {r["site"]: r for r in pv["sites"]}
    assert snap["checkpoint.snapshot"]["d2h_bytes"] == 4096 + 1024
    assert snap["checkpoint.snapshot"]["hosts"] == 2


def test_fleet_server_routes(pod):
    js, ps, state = pod
    agg = pfleet.FleetAggregator([js.url, ps.url], timeout_s=TIMEOUT)
    with pfleet.FleetServer(agg) as fleet:
        code, text = http_get(fleet.url + "/metrics", timeout=TIMEOUT)
        assert code == 200
        assert len({lb["host"] for _, lb, _ in
                    pfleet.parse_prometheus(text)}) == 2
        code, body = http_get(fleet.url + "/fleetz", timeout=TIMEOUT)
        assert code == 200 and json.loads(body)["expected"] == 2
        assert http_get(fleet.url + "/transferz", timeout=TIMEOUT)[0] == 200
        routes = json.loads(http_get(fleet.url + "/", timeout=TIMEOUT)[1])
        assert routes["routes"] == ["/metrics", "/healthz", "/fleetz",
                                    "/podtracez", "/contentionz",
                                    "/transferz", "/budgetz", "/slowz"]
        for route in ("/podtracez", "/contentionz", "/budgetz", "/slowz"):
            assert http_get(fleet.url + route, timeout=TIMEOUT)[0] == 200
        for query in ("/podtracez?limit=x", "/slowz?limit=-1"):
            assert http_get(fleet.url + query, timeout=TIMEOUT)[0] == 400
        state["p"] = "critical"
        code, body = http_get(fleet.url + "/healthz", timeout=TIMEOUT)
        assert code == 503 and json.loads(body)["status"] == "critical"
    assert not fleet.running


def test_needs_targets():
    with pytest.raises(ValueError, match="at least one target"):
        pfleet.FleetAggregator([])
    with pytest.raises(ValueError):
        pfleet.FleetAggregator(["http://x"]).scrape(include_metrics=False,
                                                    include_health=False)


@pytest.fixture
def live_pod():
    """One JAX and one port ``ObsServer``, each over its own package's live
    serving and stream planes fed the same notes; every plane reset and
    both servers stopped after."""
    from large_scale_recommendation_tpu import obs as jobs

    prev = [(m.get_registry(), m.get_tracer(), m.get_events(), m.get_store())
            for m in (obs, jobs)]
    servers = []
    for m, server_cls, kw in ((jobs, JServer, {}),
                              (obs, ObsServer, {})):
        reg, tracer = m.enable()
        budget = m.enable_budget(0.01, objective=0.9, min_samples=4)
        tel = m.enable_requests(0.01, objective=0.9)
        tracker = m.enable_contention(start=False)
        lk = tracker.lock("shared.lock")
        for _ in range(3):
            with lk:
                pass
        for i, lat in enumerate(np.linspace(0.001, 0.02, 12)):
            budget.note_result(1 + i % 2, float(lat), t=100.0 + i)
        budget.note_shed(2, 2)
        led = tel.ledger(10.0)
        led.mark("batch_form", 10.001)
        led.mark("gather", 10.003)
        led.mark("topk_merge", 10.02)
        tel.note_flush(led, 10.021, (9.99, 10.0), version=2, rows=(3, 5))
        tel.note_shed(version=2, burn=5.0, queue_depth=1)
        with tracer.span("wal/append", partition=0) as sp:
            sp.args.update(start_offset=0, end_offset=10)
        servers.append(server_cls(registry=reg, tracer=tracer, **kw).start())
    yield servers
    for s in servers:
        s.stop()
    for m, p in zip((obs, jobs), prev):
        m.disable()
        m.set_registry(p[0])
        m.set_tracer(p[1])
        m.set_events(p[2])
        m.set_store(p[3])


def _no_time(doc):
    if isinstance(doc, dict):
        return {k: _no_time(v) for k, v in doc.items()
                if k not in ("time", "first_t", "last_t", "window_start",
                             "start", "wall_s", "capacity_s", "busy_s",
                             "blocked_s", "efficiency", "serial_fraction",
                             "hold_s", "wait_s", "ts", "dur", "span_id",
                             "parent_span_id", "threads")}
    if isinstance(doc, list):
        return [_no_time(v) for v in doc]
    return doc


@pytest.mark.parametrize("view", ["pod_trace", "contention", "budget",
                                  "requests"])
def test_plane_aggregations_equal_jax(live_pod, view):
    """The four pod views of the serving and stream planes: the port's
    aggregator over one JAX and one port server gives the JAX
    aggregator's document (clocks, CPU and lock-hold walls dropped)."""
    targets = [s.url for s in live_pod]
    pv = getattr(pfleet.FleetAggregator(targets, timeout_s=TIMEOUT), view)()
    jv = getattr(jfleet.FleetAggregator(targets, timeout_s=TIMEOUT), view)()
    assert _no_time(pv) == _no_time(jv)
    assert pv["unreachable"] == []
    if view == "budget":
        assert [c["served"] for c in pv["cohorts"]] == [12, 12]
        assert [c["shed"] for c in pv["cohorts"]] == [0, 4]
    if view == "requests":
        assert len(pv["exemplars"]) == 6
        assert {e["host"] for e in pv["exemplars"]} == {
            t.split("//")[1] for t in targets}
    if view == "contention":
        row = [r for r in pv["locks"] if r["lock"] == "shared.lock"][0]
        assert row["acquisitions"] == 6 and row["hosts"] == 2
    if view == "pod_trace":
        assert pv["podSources"] == [t.split("//")[1] for t in targets]
        names = [e["name"] for e in pv["traceEvents"]]
        assert names.count("wal/append") == 2


def test_podtracez_route_validates(live_pod):
    from large_scale_recommendation_tpu_torch.obs.trace import (
        validate_chrome_trace,
    )

    agg = pfleet.FleetAggregator([s.url for s in live_pod] + [
        "http://127.0.0.1:9"], timeout_s=TIMEOUT)
    with pfleet.FleetServer(agg) as fleet:
        code, body = http_get(fleet.url + "/podtracez?limit=0",
                              timeout=TIMEOUT)
    assert code == 200
    doc = json.loads(body)
    validate_chrome_trace(doc)
    assert doc["unreachable"] == ["127.0.0.1:9"]
