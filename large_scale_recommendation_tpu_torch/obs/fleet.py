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
  CRITICAL, the pod transfer view (``transfers``: the sites of every
  ``/transferz`` merged by name), the pod trace (``pod_trace``: every
  ``/tracez`` tail assembled by ``obs.disttrace.assemble_pod_trace`` into
  one Perfetto-loadable timeline), the pod saturation view
  (``contention``: locks merged by name, a capacity-weighted serial
  fraction), the pod rollout view (``budget``: cohorts merged by catalog
  version, pending ROLLBACKs) and the pod tail view (``requests``:
  exemplars merged worst-first, pod stage fractions).
- ``FleetServer`` — the pod endpoint: ``/metrics`` (merged text),
  ``/healthz`` (pod aggregate, 503 iff CRITICAL — the per-process
  contract), ``/fleetz`` (full per-target JSON), ``/podtracez``,
  ``/contentionz``, ``/transferz``, ``/budgetz``, ``/slowz``.
  Scrapes run per request (pull model).
- ``parse_prometheus`` — a strict text-exposition parser.

The merge is host code with no framework in it, the JAX package's
function for function: a port aggregator scrapes JAX and port servers
alike.
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
    parse_query_int,
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

    def pod_trace(self, limit: int = 8192) -> dict:
        """Scrape every target's ``/tracez`` tail (``limit`` events
        each; 0 = each process's whole buffer) and assemble ONE
        Perfetto-loadable pod timeline
        (``obs.disttrace.assemble_pod_trace``): per-target events are
        re-homed onto synthetic pids with a ``process_name`` metadata
        row carrying the host label, so colliding OS pids/tids across
        processes can never corrupt the merge, while the (host, pid)-
        namespaced span/event ids keep every args-level join intact.
        Unreachable or unparseable targets are skipped and listed under
        ``unreachable`` — a partial pod timeline beats none when one
        member is wedged."""
        from large_scale_recommendation_tpu_torch.obs.disttrace import (
            assemble_pod_trace,
        )

        sources: list[tuple[str, dict]] = []
        skipped: list[str] = []
        for url in self.targets:
            host = _host_of(url)
            code, body = http_get(f"{url}/tracez?limit={int(limit)}",
                                  timeout=self.timeout_s)
            if code != 200:
                skipped.append(host)
                continue
            try:
                doc = json.loads(body)
            except json.JSONDecodeError:
                skipped.append(host)
                continue
            sources.append((host, {"traceEvents": doc.get("recent", [])}))
        out = assemble_pod_trace(sources)
        out["unreachable"] = skipped
        return out

    def contention(self, top_k: int = 8) -> dict:
        """Scrape every target's ``/contentionz`` into one pod
        saturation view: per-host Amdahl summaries, the pod lock table
        merged BY LOCK NAME (wait/hold/acquisition totals summed — the
        processes run the same code, so a name prices the same lock
        class fleet-wide), and a capacity-weighted pod
        ``serial_fraction`` (each host's estimate weighted by its
        N·wall window capacity). Targets with no tracker installed
        report their note and contribute nothing; unreachable targets
        are listed — a partial pod view beats none."""
        per_target = []
        skipped: list[str] = []
        lock_rows: dict[str, dict] = {}
        cap_total = 0.0
        serial_weighted = 0.0
        for url in self.targets:
            host = _host_of(url)
            code, body = http_get(url + "/contentionz",
                                  timeout=self.timeout_s)
            if code != 200:
                skipped.append(host)
                continue
            try:
                doc = json.loads(body)
            except json.JSONDecodeError:
                skipped.append(host)
                continue
            per_target.append({
                "host": host, "url": url,
                "note": doc.get("note"),
                "consumers": doc.get("consumers"),
                "wall_s": (doc.get("window") or {}).get("wall_s"),
                "capacity_s": doc.get("capacity_s"),
                "efficiency": doc.get("efficiency"),
                "serial_fraction": doc.get("serial_fraction"),
                "lock_wait_s_total": doc.get("lock_wait_s_total"),
            })
            for row in doc.get("locks", []):
                agg = lock_rows.setdefault(
                    row["lock"], {"lock": row["lock"],
                                  "kind": row.get("kind"),
                                  "acquisitions": 0, "contended": 0,
                                  "wait_s": 0.0, "hold_s": 0.0,
                                  "hosts": 0})
                agg["acquisitions"] += row.get("acquisitions", 0)
                agg["contended"] += row.get("contended", 0)
                agg["wait_s"] += row.get("wait_s", 0.0)
                agg["hold_s"] += row.get("hold_s", 0.0)
                agg["hosts"] += 1
            s, cap = doc.get("serial_fraction"), doc.get("capacity_s")
            if s is not None and cap:
                serial_weighted += s * cap
                cap_total += cap
        merged = sorted(lock_rows.values(),
                        key=lambda r: (-r["wait_s"], -r["acquisitions"]))
        return {
            "time": time.time(),
            "targets": per_target,
            "unreachable": skipped,
            "locks": merged,
            "top_contended": merged[:top_k],
            "serial_fraction": (serial_weighted / cap_total
                                if cap_total > 0 else None),
            "capacity_s": cap_total,
            "lock_wait_s_total": sum(r["wait_s"] for r in merged),
        }

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

    def budget(self) -> dict:
        """Scrape every target's ``/budgetz`` into one pod rollout
        view: cohorts merged BY CATALOG VERSION (outcome totals summed
        — one deploy's cohort is one row however many replicas served
        it; attainment/burn re-derived from the summed totals, while
        the windowed fast burn and remaining budget keep the
        WORST-host reading so a one-replica canary regression cannot
        be averaged away by its healthy peers), plus every host's
        pending ROLLBACK verdicts keyed by version. Targets with no
        budget enabled report their note and contribute nothing;
        unreachable targets are listed."""
        per_target = []
        skipped: list[str] = []
        cohort_rows: dict[int, dict] = {}
        pending: dict[str, list] = {}
        objective = None
        for url in self.targets:
            host = _host_of(url)
            code, body = http_get(url + "/budgetz", timeout=self.timeout_s)
            if code != 200:
                skipped.append(host)
                continue
            try:
                doc = json.loads(body)
            except json.JSONDecodeError:
                skipped.append(host)
                continue
            verdicts = doc.get("verdicts") or {}
            host_pending = verdicts.get("pending_rollbacks") or {}
            per_target.append({
                "host": host, "url": url,
                "note": doc.get("note"),
                "name": doc.get("name"),
                "objective": doc.get("objective"),
                "evaluations": verdicts.get("evaluations"),
                "pending_rollbacks": sorted(host_pending),
            })
            if doc.get("objective") is not None and objective is None:
                objective = doc["objective"]
            for version, rec in host_pending.items():
                pending.setdefault(str(version), []).append(
                    {"host": host, "reason": rec.get("reason")})
            for version, row in (doc.get("cohorts") or {}).items():
                v = int(version)
                agg = cohort_rows.setdefault(
                    v, {"version": v, "served": 0, "shed": 0,
                        "violations": 0, "degraded": 0, "hosts": 0,
                        "burn_rate_fast_max": 0.0, "p99_ms_max": 0.0,
                        "error_budget_remaining_min": 1.0, "evals": {}})
                agg["served"] += row.get("served", 0)
                agg["shed"] += row.get("shed", 0)
                agg["violations"] += row.get("violations", 0)
                agg["degraded"] += row.get("degraded", 0)
                agg["hosts"] += 1
                agg["burn_rate_fast_max"] = max(
                    agg["burn_rate_fast_max"],
                    row.get("burn_rate_fast") or 0.0)
                agg["p99_ms_max"] = max(agg["p99_ms_max"],
                                        row.get("p99_ms") or 0.0)
                agg["error_budget_remaining_min"] = min(
                    agg["error_budget_remaining_min"],
                    row.get("error_budget_remaining", 1.0))
                agg["evals"].update(row.get("evals") or {})
        for agg in cohort_rows.values():
            offered = agg["served"] + agg["shed"]
            agg["shed_frac"] = (agg["shed"] / offered) if offered else 0.0
            frac = (agg["violations"] / agg["served"]
                    if agg["served"] else 0.0)
            agg["attainment"] = 1.0 - frac
            agg["burn_rate"] = (frac / (1.0 - objective)
                                if objective is not None else None)
        merged = sorted(cohort_rows.values(), key=lambda r: r["version"])
        return {
            "time": time.time(),
            "targets": per_target,
            "unreachable": skipped,
            "objective": objective,
            "cohorts": merged,
            "pending_rollbacks": pending,
        }

    def requests(self, limit: int = 50) -> dict:
        """Scrape every target's ``/slowz`` into one pod tail view:
        exemplars merged WORST-FIRST across hosts (wall descending,
        each tagged with its host, bounded by ``limit``), per-stage
        window totals summed into pod-level fractions + the pod's
        dominant stage, and a per-target summary row (burn rate, p99,
        dominant stage, kept counts). Targets with no request
        telemetry enabled report their note and contribute nothing;
        unreachable targets are listed."""
        per_target = []
        skipped: list[str] = []
        exemplars: list[dict] = []
        stage_totals: dict[str, float] = {}
        for url in self.targets:
            host = _host_of(url)
            code, body = http_get(url + "/slowz", timeout=self.timeout_s)
            if code != 200:
                skipped.append(host)
                continue
            try:
                doc = json.loads(body)
            except json.JSONDecodeError:
                skipped.append(host)
                continue
            per_target.append({
                "host": host, "url": url,
                "note": doc.get("note"),
                "name": doc.get("name"),
                "count": doc.get("count"),
                "violations": doc.get("violations"),
                "shed": doc.get("shed"),
                "burn_rate": doc.get("burn_rate"),
                "p99_ms": doc.get("p99_ms"),
                "dominant_stage": doc.get("dominant_stage"),
                "kept": doc.get("kept"),
            })
            for stage, total in (doc.get("stage_totals_s") or {}).items():
                stage_totals[stage] = (stage_totals.get(stage, 0.0)
                                       + (total or 0.0))
            for ex in doc.get("exemplars") or []:
                exemplars.append(dict(ex, host=host))
        exemplars.sort(key=lambda e: (e.get("wall_s") or 0.0),
                       reverse=True)
        sum_wall = sum(stage_totals.values())
        frac = ({} if sum_wall <= 0.0
                else {s: t / sum_wall for s, t in stage_totals.items()})
        return {
            "time": time.time(),
            "targets": per_target,
            "unreachable": skipped,
            "stage_totals_s": stage_totals,
            "stage_frac": frac,
            "dominant_stage": (max(frac, key=lambda s: frac[s])
                               if frac else None),
            "exemplars": exemplars[:limit] if limit else exemplars,
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
    per-target view), ``/podtracez`` (the assembled pod timeline;
    ``?limit=N`` events per process), ``/contentionz`` (the pod saturation
    view), ``/transferz`` (the pod transfer view), ``/budgetz`` (the pod
    rollout view) and ``/slowz`` (the pod tail view; ``?limit=N``). Rides
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
        if path == "/podtracez":
            limit, err = parse_query_int(query, "limit")
            if err is not None:
                return 400, {"error": err}
            return 200, self.aggregator.pod_trace(
                limit=8192 if limit is None else limit)
        if path == "/contentionz":
            return 200, self.aggregator.contention()
        if path == "/transferz":
            return 200, self.aggregator.transfers()
        if path == "/budgetz":
            return 200, self.aggregator.budget()
        if path == "/slowz":
            limit, err = parse_query_int(query, "limit")
            if err is not None:
                return 400, {"error": err}
            return 200, self.aggregator.requests(
                limit=50 if limit is None else limit)
        if path == "/":
            return 200, {"routes": ["/metrics", "/healthz", "/fleetz",
                                    "/podtracez", "/contentionz",
                                    "/transferz", "/budgetz", "/slowz"],
                         "targets": self.aggregator.targets}
        return None
