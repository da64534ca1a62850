"""Pod-wide observability: scrape every process's obs endpoint into one
pane of glass (counterpart of ``large_scale_recommendation_tpu.obs.fleet``).

Each process of a multi-process run (``parallel.Partitioner.create()``,
one rank per card) serves its own ``/metrics`` and ``/healthz``. This
module is the aggregation layer:

- ``FleetAggregator`` — scrapes a fixed target list (each a process's
  ``ObsServer`` base URL) and merges: one Prometheus text body with a
  per-target ``host`` label injected into every sample (``# TYPE`` lines
  deduped, first writer wins), a pod health report with
  worst-status-wins aggregation where an unreachable target counts
  CRITICAL, and the pod transfer view (``transfers``: the sites of every
  ``/transferz`` merged by name).
- ``FleetServer`` — the pod endpoint: ``/metrics`` (merged text),
  ``/healthz`` (pod aggregate, 503 iff CRITICAL — the per-process
  contract), ``/fleetz`` (full per-target JSON), ``/transferz``.
  Scrapes run per request (pull model).
- ``parse_prometheus`` — a strict text-exposition parser.

The merge is host code with no framework in it, the JAX package's
function for function: a port aggregator scrapes JAX and port servers
alike. Not ported yet (they read the planes of the next slice):
``pod_trace`` / ``/podtracez`` (``disttrace.assemble_pod_trace``),
``contention`` / ``/contentionz``, ``budget`` / ``/budgetz`` and
``requests`` / ``/slowz``; those routes answer 404.
"""

from __future__ import annotations

import json
import re
import time
from urllib.parse import urlparse

from large_scale_recommendation_tpu_torch.obs.health import (
    CRITICAL,
    OK,
    SEVERITY,
)
from large_scale_recommendation_tpu_torch.obs.registry import _escape_label
from large_scale_recommendation_tpu_torch.obs.server import (
    PROM_CTYPE,
    EndpointServerBase,
    http_get,
)

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label(v: str) -> str:
    return (v.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def parse_prometheus(text: str) -> list[tuple[str, dict, float]]:
    """Parse a Prometheus text-exposition body into
    ``[(name, labels, value), ...]``. STRICT: a malformed sample line
    raises ``ValueError`` — this is the "the merged pod /metrics
    parses" contract, so silently skipping a bad line would defeat it.
    Comment (``#``) and blank lines are structural, not samples."""
    out = []
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"bad prometheus sample at line {i}: {line!r}")
        name, labels_str, value_str = m.groups()
        labels = {}
        if labels_str:
            body = labels_str[1:-1]
            for lm in _LABEL_RE.finditer(body):
                labels[lm.group(1)] = _unescape_label(lm.group(2))
            # everything between matches must be separators — otherwise
            # the line smuggled an unparseable label through
            rest = _LABEL_RE.sub("", body).replace(",", "").strip()
            if rest:
                raise ValueError(
                    f"bad labels at line {i}: {labels_str!r}")
        try:
            value = float(value_str)
        except ValueError as e:
            raise ValueError(
                f"bad value at line {i}: {value_str!r}") from e
        out.append((name, labels, value))
    return out


def add_host_label(text: str, host: str) -> str:
    """Rewrite every sample line of a Prometheus body with a
    ``host="..."`` label injected (``# TYPE``/comment lines pass
    through) — how per-process scrapes stay distinguishable in the
    merged pod view."""
    esc = _escape_label(host)
    lines = []
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            lines.append(line)
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            lines.append(line)  # merge must not corrupt; parse flags it
            continue
        name, labels_str, value_str = m.groups()
        if labels_str:
            inner = labels_str[1:-1]
            labeled = f'{name}{{{inner},host="{esc}"}} {value_str}'
        else:
            labeled = f'{name}{{host="{esc}"}} {value_str}'
        lines.append(labeled)
    return "\n".join(lines)


def merge_prometheus(bodies: list[tuple[str, str]]) -> str:
    """Merge per-host Prometheus bodies into one: each host's samples
    get its ``host`` label, ``# TYPE`` lines are deduped by metric name
    (first writer wins — the processes run the same code, so types
    agree)."""
    seen_types: set[str] = set()
    out: list[str] = []
    for host, text in bodies:
        for line in add_host_label(text, host).splitlines():
            if line.startswith("# TYPE "):
                name = line.split()[2] if len(line.split()) > 2 else line
                if name in seen_types:
                    continue
                seen_types.add(name)
            if line.strip():
                out.append(line)
    return "\n".join(out) + ("\n" if out else "")


def _host_of(url: str) -> str:
    netloc = urlparse(url).netloc
    return netloc or url


class FleetAggregator:
    """Scrapes a fixed list of per-process obs endpoints into one pod
    view. ``targets`` are base URLs (``http://127.0.0.1:8321``); the
    injected ``host`` label is each URL's netloc. ``timeout_s`` bounds
    each scrape — a hung process must not hang the pod endpoint."""

    UNREACHABLE = "unreachable"

    def __init__(self, targets: list[str], timeout_s: float = 5.0):
        if not targets:
            raise ValueError("fleet needs at least one target")
        self.targets = [t.rstrip("/") for t in targets]
        self.timeout_s = float(timeout_s)

    def scrape(self, include_metrics: bool = True,
               include_health: bool = True) -> dict:
        """One pod scrape: per-target ``/healthz`` and/or ``/metrics``,
        aggregated worst-status-wins. The two flags exist so each pod
        route pays ONLY the N requests it needs — ``/healthz`` probes
        skip the N full metrics bodies + text merge, Prometheus polls
        of ``/metrics`` skip the N healthz fetches (a wedged member
        costs one ``timeout_s``, not two). An unreachable target
        (connection failure, unparseable ``/healthz``, non-200
        ``/metrics`` when fetched) aggregates as CRITICAL — a 503
        ``/healthz`` is a REACHABLE target reporting critical, and its
        own status stands."""
        if not (include_metrics or include_health):
            raise ValueError("scrape needs at least one of "
                             "include_metrics/include_health")
        bodies: list[tuple[str, str]] = []
        target_reports = []
        worst = OK
        for url in self.targets:
            host = _host_of(url)
            entry = {"url": url, "host": host}
            status = OK
            if include_health:
                h_code, h_body = http_get(url + "/healthz",
                                          timeout=self.timeout_s)
                try:
                    report = json.loads(h_body)
                    status = report.get("status", self.UNREACHABLE)
                except (json.JSONDecodeError, TypeError):
                    # connection-level failures land here: http_get's
                    # synthetic 599 carries no JSON body
                    report = {"error": h_body[:200]}
                    status = self.UNREACHABLE
                entry["healthz_code"] = h_code
                entry["report"] = report
            if include_metrics:
                m_code, m_body = http_get(url + "/metrics",
                                          timeout=self.timeout_s)
                entry["metrics_code"] = m_code
                if m_code == 200:
                    bodies.append((host, m_body))
                else:
                    status = self.UNREACHABLE
            entry["status"] = status
            severity = SEVERITY.get(status, SEVERITY[CRITICAL])
            if severity > SEVERITY[worst]:
                worst = status if status in SEVERITY else CRITICAL
            target_reports.append(entry)
        out = {
            "time": time.time(),
            "status": worst,
            "targets": target_reports,
            "reachable": sum(1 for t in target_reports
                             if t["status"] != self.UNREACHABLE),
            "expected": len(self.targets),
        }
        if include_metrics:
            out["prometheus"] = merge_prometheus(bodies)
        return out

    def transfers(self) -> dict:
        """Scrape every target's ``/transferz`` into one pod transfer
        view: the site table merged BY SITE NAME (byte/count/wait
        totals summed — the processes run the same code, so a site
        names the same crossing fleet-wide; effective GB/s re-derived
        from the summed totals), pod-total implicit-transfer and
        retrace counters, and per-host summaries with each host's
        steady-state window. Targets with no ledger enabled report
        their note and contribute nothing; unreachable targets are
        listed — a partial pod view beats none."""
        per_target = []
        skipped: list[str] = []
        site_rows: dict[str, dict] = {}
        implicit_total = 0
        retrace_total = 0
        for url in self.targets:
            host = _host_of(url)
            code, body = http_get(url + "/transferz",
                                  timeout=self.timeout_s)
            if code != 200:
                skipped.append(host)
                continue
            try:
                doc = json.loads(body)
            except json.JSONDecodeError:
                skipped.append(host)
                continue
            retraces = doc.get("retraces") or {}
            per_target.append({
                "host": host, "url": url,
                "note": doc.get("note"),
                "guard_mode": doc.get("guard_mode"),
                "implicit_transfers_total":
                    doc.get("implicit_transfers_total"),
                "retrace_total": retraces.get("total"),
                "steady": doc.get("steady"),
            })
            implicit_total += doc.get("implicit_transfers_total") or 0
            retrace_total += retraces.get("total") or 0
            for site, row in (doc.get("sites") or {}).items():
                agg = site_rows.setdefault(
                    site, {"site": site,
                           "h2d_bytes": 0, "d2h_bytes": 0,
                           "h2d_count": 0, "d2h_count": 0,
                           "wait_s": 0.0, "hosts": 0})
                agg["h2d_bytes"] += row.get("h2d_bytes", 0)
                agg["d2h_bytes"] += row.get("d2h_bytes", 0)
                agg["h2d_count"] += row.get("h2d_count", 0)
                agg["d2h_count"] += row.get("d2h_count", 0)
                agg["wait_s"] += row.get("wait_s", 0.0)
                agg["hosts"] += 1
        for agg in site_rows.values():
            total = agg["h2d_bytes"] + agg["d2h_bytes"]
            agg["effective_gbs"] = (total / agg["wait_s"] / 1e9
                                    if agg["wait_s"] > 0 else None)
        merged = sorted(site_rows.values(),
                        key=lambda r: -(r["h2d_bytes"] + r["d2h_bytes"]))
        return {
            "time": time.time(),
            "targets": per_target,
            "unreachable": skipped,
            "sites": merged,
            "implicit_transfers_total": implicit_total,
            "retrace_total": retrace_total,
        }

    def healthz(self) -> tuple[int, dict]:
        """(http_status, pod report) — 503 iff the pod aggregate is
        CRITICAL (including any unreachable member), the same contract
        as the per-process route. Scrapes only each target's
        ``/healthz`` (the metrics bodies contribute nothing to the
        verdict)."""
        view = self.scrape(include_metrics=False)
        report = {
            "status": (CRITICAL if view["status"] == self.UNREACHABLE
                       else view["status"]),
            "time": view["time"],
            "reachable": view["reachable"],
            "expected": view["expected"],
            "targets": [{"url": t["url"], "status": t["status"]}
                        for t in view["targets"]],
        }
        code = 503 if report["status"] == CRITICAL else 200
        return code, report


class FleetServer(EndpointServerBase):
    """The pod endpoint over one ``FleetAggregator``: ``/metrics`` (merged
    Prometheus text, a metrics-only scrape), ``/healthz`` (pod aggregate
    JSON, 503 on CRITICAL, a healthz-only scrape), ``/fleetz`` (the full
    per-target view), ``/transferz`` (the pod transfer view). Rides
    ``obs.server.EndpointServerBase``: the same lifecycle and handler as
    the per-process ``ObsServer``."""

    thread_prefix = "fleet-server"

    def __init__(self, aggregator: FleetAggregator,
                 host: str = "127.0.0.1", port: int = 0):
        super().__init__(host=host, port=port)
        self.aggregator = aggregator

    def route(self, path: str, query: str):
        if path == "/metrics":
            view = self.aggregator.scrape(include_health=False)
            return 200, view["prometheus"], PROM_CTYPE
        if path in ("/healthz", "/health"):
            return self.aggregator.healthz()
        if path == "/fleetz":
            return 200, self.aggregator.scrape()
        if path == "/transferz":
            return 200, self.aggregator.transfers()
        if path == "/":
            return 200, {"routes": ["/metrics", "/healthz", "/fleetz",
                                    "/transferz"],
                         "targets": self.aggregator.targets}
        return None
