"""Zero-dependency HTTP endpoint server for the observability layer
(counterpart of ``large_scale_recommendation_tpu.obs.server``).

Stdlib ``http.server`` only — no Prometheus client, no web framework — so
any deployment of the package can expose its live state to a scraper or a
``curl``:

- ``/metrics``  — Prometheus text exposition
  (``MetricsRegistry.to_prometheus()``), the scrape surface.
- ``/healthz``  — the aggregated ``HealthMonitor`` report as JSON;
  **503 when any check is CRITICAL** (the contract load balancers and
  liveness probes key on). Without a monitor the route reports ``ok``.
- ``/varz``     — ``MetricsRegistry.snapshot()`` JSON.
- ``/tracez``   — the most recent spans (``?limit=N``; 0 = the whole
  buffer).
- ``/seriesz``  — the flight recorder's history (``FlightRecorder
  .snapshot()``).
- ``/eventz``   — the event journal's recent ring.
- ``/rooflinez`` — the live per-kernel roofline
  (``Introspector.roofline()``: the step pair's launcher records joined
  with the measured execute walls) plus the transfer ledger's per-site
  GB/s.
- ``/lineagez`` — the catalog provenance journal and its freshness
  summary (``obs.lineage.LineageJournal.snapshot()``).
- ``/criticalpathz`` — the ingest→servable stage attribution
  (``obs.disttrace.CriticalPathAnalyzer.snapshot()``).
- ``/contentionz`` — the saturation view (``obs.contention
  .SaturationAnalyzer``): Amdahl decomposition, top contended locks,
  per-partition blocked share.
- ``/storez``   — the tiered factor store (``obs.store.storez()``).
- ``/transferz`` — the host↔device transfer plane
  (``obs.transfers.transferz()``).
- ``/budgetz``  — the rollout plane (``obs.budget.budgetz()``).
- ``/slowz``    — the request plane (``obs.requests.slowz()``;
  ``?limit=N`` bounds the exemplar table, 400 on junk).
- ``/profilez`` — an on-demand ``torch.profiler`` capture:
  ``GET /profilez?seconds=N`` records N seconds (capped, default 1) of the
  whole process into a fresh directory (under ``profile_dir`` or the
  temp dir) and returns its path and files. The profiler is one per
  process: a capture already in flight through ``obs.introspect``'s one
  capture layer (a second ``/profilez``, a watchdog-trip capture, a
  ``profile_trace`` block) answers 409 and leaves the other trace alone.
  The capture holds the card's kernels and every thread's host ops;
  ``start()`` initializes the profiler on the main thread first
  (``introspect.warm_profiler``: a first capture on a handler thread
  would record no host ops).

Route bodies read Python state only (the registry's floats, the tracer's
and journal's buffers, the launcher records, the planes' host-side
records), so a scrape never waits on the card and never trips the
implicit-transfer guard of a hot path that runs beside it. No route takes a
lock the contention plane instruments: ``/contentionz`` reads the tracker's
own raw-locked tables.

Differences from the JAX package, by design: ``/profilez`` runs
``torch.profiler``.

Usage::

    from large_scale_recommendation_tpu_torch import obs
    from large_scale_recommendation_tpu_torch.obs.health import HealthMonitor
    from large_scale_recommendation_tpu_torch.obs.server import ObsServer

    reg, tracer = obs.enable()
    server = ObsServer(monitor=HealthMonitor()).start()  # port 0: ephemeral
    print(server.url)  # http://127.0.0.1:<port>
    ...
    server.stop()

Checks run per request (pull model): ``/healthz`` reflects the state at
scrape time, and an idle system pays nothing. Handler threads are daemons
(``ThreadingHTTPServer``); ``stop()`` (or the context-manager form)
releases the socket and joins the serving thread.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from large_scale_recommendation_tpu_torch.obs.contention import (
    get_contention,
)
from large_scale_recommendation_tpu_torch.obs.disttrace import get_disttrace
from large_scale_recommendation_tpu_torch.obs.events import get_events
from large_scale_recommendation_tpu_torch.obs.health import CRITICAL
from large_scale_recommendation_tpu_torch.obs.introspect import (
    get_introspector,
)
from large_scale_recommendation_tpu_torch.obs.lineage import get_lineage
from large_scale_recommendation_tpu_torch.obs.recorder import get_recorder
from large_scale_recommendation_tpu_torch.obs.registry import get_registry
from large_scale_recommendation_tpu_torch.obs.trace import get_tracer

DEFAULT_TRACEZ_LIMIT = 256
DEFAULT_EVENTZ_LIMIT = 256
# /profilez bounds: the default capture window and the cap a query cannot
# exceed (a request must not pin the profiler and a handler for minutes)
DEFAULT_PROFILE_SECONDS = 1.0
MAX_PROFILE_SECONDS = 60.0
POLL_INTERVAL_S = 0.05  # serve_forever's shutdown poll
ROUTES = ("/metrics", "/healthz", "/varz", "/tracez", "/seriesz", "/eventz",
          "/rooflinez", "/lineagez", "/criticalpathz", "/contentionz",
          "/storez", "/transferz", "/budgetz", "/slowz", "/profilez")

PROM_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


def http_get(url: str, timeout: float = 5.0) -> tuple[int, str]:
    """``(status, body)`` for one GET. HTTP errors return their real status
    and body; connection-level failures return a synthetic 599 with the
    error text, so callers always get a diagnosable pair."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:  # non-200 still carries a body
        return e.code, e.read().decode()
    except (urllib.error.URLError, OSError) as e:
        return 599, repr(e)


def parse_query_int(query: str, name: str):
    """``(value, error)`` for one ``?name=N`` integer query param — the one
    copy of the 400-on-junk contract. Absent → ``(None, None)``;
    non-integer or negative → ``(None, message)``."""
    raw = parse_qs(query).get(name, [None])[0]
    if raw is None:
        return None, None
    try:
        value = int(raw)
    except ValueError:
        return None, f"bad {name} param {raw!r}"
    if value < 0:
        return None, f"bad {name} param {raw!r} (must be >= 0)"
    return value, None


class _HandlerBase(BaseHTTPRequestHandler):
    """Shared GET plumbing for every endpoint server (this one and
    ``obs.fleet.FleetServer``): path/query split, route dispatch,
    Content-Length framing, the 500-on-exception wrapper, quiet logs.
    ``EndpointServerBase.start`` builds a per-instance subclass carrying
    the owning server as ``endpoint``."""

    endpoint: "EndpointServerBase"

    def do_GET(self):  # noqa: N802 (http.server API)
        raw_path, _, query = self.path.partition("?")
        path = raw_path.rstrip("/") or "/"
        try:
            result = self.endpoint.route(path, query)
            if result is None:
                self._send_json(404, {"error": f"no route {path!r}"})
            elif len(result) == 3:  # (code, text body, content type)
                code, body, ctype = result
                self._send(code, body, ctype)
            else:  # (code, json-able doc)
                code, doc = result
                self._send_json(code, doc)
        except Exception as e:  # surface, don't kill the thread
            try:
                self._send_json(500, {"error": repr(e)})
            except OSError:
                pass  # client went away mid-error

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code: int, doc: dict) -> None:
        self._send(code, json.dumps(doc),
                   "application/json; charset=utf-8")

    def log_message(self, fmt, *args):  # quiet: scrapes are not news
        pass


class EndpointServerBase:
    """Shared lifecycle for the endpoint servers: ephemeral-port bind
    (``port=0`` → read ``.port``/``.url`` after ``start()``), a daemon
    ``serve_forever`` thread, deterministic ``stop()`` (shutdown + close +
    join), context-manager form. Subclasses implement ``route(path,
    query)`` returning ``(code, doc)`` for JSON, ``(code, text,
    content_type)`` for raw bodies, or ``None`` for 404. A bind that fails
    raises from ``start()``."""

    thread_prefix = "obs-endpoint"

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = int(port)
        # the port ASKED for, apart from the bound one: a stop()/start()
        # cycle on port=0 binds a fresh ephemeral port
        self._requested_port = int(port)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def route(self, path: str, query: str):
        raise NotImplementedError

    def start(self):
        if self._httpd is not None:
            return self
        handler = type("Handler", (_HandlerBase,), {"endpoint": self})
        self._httpd = ThreadingHTTPServer((self.host, self._requested_port),
                                          handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        # a short poll: stop() waits for the loop to notice the shutdown
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, args=(POLL_INTERVAL_S,),
            name=f"{self.thread_prefix}:{self.port}", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        httpd, self._httpd = self._httpd, None
        thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def running(self) -> bool:
        return self._httpd is not None

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


class ObsServer(EndpointServerBase):
    """Background-thread HTTP server over one registry/tracer/monitor.

    ``registry``/``tracer`` default to the module-level ones AT
    CONSTRUCTION (build the server after ``obs.enable()``), as do the
    recorder, journal and introspector (``None`` stays ``None``: the
    route answers with a note); ``monitor`` is optional. ``host`` defaults
    to loopback."""

    thread_prefix = "obs-server"

    def __init__(self, registry=None, tracer=None, monitor=None,
                 recorder=None, events=None, introspector=None,
                 lineage=None, disttrace=None, contention=None,
                 host: str = "127.0.0.1", port: int = 0,
                 tracez_limit: int = DEFAULT_TRACEZ_LIMIT,
                 eventz_limit: int = DEFAULT_EVENTZ_LIMIT,
                 profile_dir: str | None = None):
        super().__init__(host=host, port=port)
        self.registry = registry or get_registry()
        self.tracer = tracer or get_tracer()
        self.monitor = monitor
        self.recorder = recorder if recorder is not None else get_recorder()
        self.events = events if events is not None else get_events()
        self.introspector = (introspector if introspector is not None
                             else get_introspector())
        self.lineage = lineage if lineage is not None else get_lineage()
        self.disttrace = (disttrace if disttrace is not None
                          else get_disttrace())
        self.contention = (contention if contention is not None
                           else get_contention())
        self.profile_dir = profile_dir
        self.eventz_limit = int(eventz_limit)
        self.tracez_limit = int(tracez_limit)

    def start(self):
        # /profilez captures on a handler thread: torch's profiler must
        # have been initialized on the main thread first
        from large_scale_recommendation_tpu_torch.obs.introspect import (
            warm_profiler,
        )

        warm_profiler()
        return super().start()

    # -- routing -------------------------------------------------------------

    def route(self, path: str, query: str):
        if path == "/metrics":
            return 200, self.registry.to_prometheus(), PROM_CTYPE
        if path in ("/healthz", "/health"):
            return self.healthz()
        if path == "/varz":
            return 200, self.registry.snapshot()
        if path == "/tracez":
            limit, err = parse_query_int(query, "limit")
            if err is not None:  # a client error, not a server failure
                return 400, {"error": err}
            return 200, self.tracez(limit)
        if path == "/seriesz":
            return 200, self.seriesz()
        if path == "/eventz":
            return 200, self.eventz()
        if path == "/rooflinez":
            return 200, self.rooflinez()
        if path == "/lineagez":
            return 200, self.lineagez()
        if path == "/criticalpathz":
            return 200, self.criticalpathz()
        if path == "/contentionz":
            return 200, self.contentionz()
        if path == "/storez":
            return 200, self.storez()
        if path == "/transferz":
            return 200, self.transferz()
        if path == "/budgetz":
            return 200, self.budgetz()
        if path == "/slowz":
            limit, err = parse_query_int(query, "limit")
            if err is not None:  # a client error, not a server failure
                return 400, {"error": err}
            return 200, self.slowz(limit)
        if path == "/profilez":
            raw = parse_qs(query).get("seconds", [None])[0]
            try:
                seconds = None if raw is None else float(raw)
            except ValueError:  # a client error, not a capture failure
                return 400, {"error": f"bad seconds param {raw!r}"}
            return self.profilez(seconds)
        if path == "/":
            return 200, {"routes": list(ROUTES)}
        return None

    # -- route bodies (shared with tests and in-process callers) -------------

    def healthz(self) -> tuple[int, dict]:
        """(http_status, report) for ``/healthz`` — 503 iff CRITICAL."""
        if self.monitor is None:
            report = {"status": "ok", "checks": {},
                      "note": "no health monitor attached"}
        else:
            report = self.monitor.run()
        code = 503 if report.get("status") == CRITICAL else 200
        return code, report

    def tracez(self, limit: int | None = None) -> dict:
        """``limit`` overrides the construction-time tail bound (0 = the
        whole buffer)."""
        events = self.tracer.events()
        n = self.tracez_limit if limit is None else max(0, int(limit))
        return {"recent": events[-n:] if n else list(events),
                "total_buffered": len(events),
                "dropped": self.tracer.dropped}

    def seriesz(self) -> dict:
        if self.recorder is None:
            return {"note": "no flight recorder attached", "series": {}}
        return self.recorder.snapshot()

    def eventz(self) -> dict:
        if self.events is None:
            return {"note": "no event journal attached", "recent": []}
        return self.events.snapshot(limit=self.eventz_limit)

    def rooflinez(self) -> dict:
        if self.introspector is None:
            doc = {"note": "no introspector installed "
                           "(obs.enable_introspection())", "rows": []}
        else:
            doc = self.introspector.roofline()
        # the transfer plane's measured per-site GB/s on the same page
        from large_scale_recommendation_tpu_torch.obs.transfers import (
            get_transfers,
        )

        ledger = get_transfers()
        if ledger is not None:
            doc["transfer_site_gbs"] = ledger.site_gbs()
        return doc

    def lineagez(self) -> dict:
        if self.lineage is None:
            return {"note": "no lineage journal installed "
                            "(obs.enable_lineage())", "records": []}
        return self.lineage.snapshot()

    def criticalpathz(self) -> dict:
        if self.disttrace is None:
            return {"note": "no critical-path analyzer installed "
                            "(obs.enable_disttrace())", "samples": [],
                    "stages": {}}
        return self.disttrace.snapshot()

    def contentionz(self) -> dict:
        if self.contention is None:
            return {"note": "no contention tracker installed "
                            "(obs.enable_contention())", "locks": [],
                    "top_contended": [], "partitions": {}}
        from large_scale_recommendation_tpu_torch.obs.contention import (
            SaturationAnalyzer,
        )

        return SaturationAnalyzer(self.contention,
                                  registry=self.registry).snapshot()

    def budgetz(self) -> dict:
        """The rollout plane, resolved per request so a budget enabled
        after the server is still visible."""
        from large_scale_recommendation_tpu_torch.obs.budget import budgetz

        return budgetz()

    def slowz(self, limit: int | None = None) -> dict:
        """The request plane, resolved per request so telemetry enabled
        after the server is still visible; ``limit`` bounds the exemplar
        table."""
        from large_scale_recommendation_tpu_torch.obs.requests import slowz

        return slowz(limit)

    def storez(self) -> dict:
        """The tiered factor store's live surface, resolved per request so
        a store built after the server is still visible."""
        from large_scale_recommendation_tpu_torch.obs.store import storez

        return storez()

    def transferz(self) -> dict:
        """The host↔device transfer plane, resolved per request so a
        ledger enabled after the server is still visible."""
        from large_scale_recommendation_tpu_torch.obs.transfers import (
            transferz,
        )

        return transferz()

    def profilez(self, seconds: float | None = None) -> tuple[int, dict]:
        """(http_status, body) for ``/profilez``: one N-second
        ``torch.profiler`` capture into a fresh directory, 409 while
        another capture is in flight."""
        from large_scale_recommendation_tpu_torch.obs.introspect import (
            capture_profile,
        )

        seconds = (DEFAULT_PROFILE_SECONDS if seconds is None
                   else min(max(0.0, float(seconds)), MAX_PROFILE_SECONDS))
        if self.profile_dir is not None:
            os.makedirs(self.profile_dir, exist_ok=True)
        out_dir = tempfile.mkdtemp(prefix="profilez-", dir=self.profile_dir)
        try:
            return 200, capture_profile(out_dir, seconds)
        except RuntimeError as e:
            shutil.rmtree(out_dir, ignore_errors=True)
            return 409, {"error": str(e)}
