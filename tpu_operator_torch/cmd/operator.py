"""Operator main loop: the port's copy of ``tpu_operator/cmd/operator.py``.

Reference: ``cmd/gpu-operator/main.go:74-246`` — manager construction,
scheme registration, leader election, health probes, metrics endpoint, and
the reconcilers.  controller-runtime's watch-driven manager becomes a
level-triggered reconcile loop here: each reconciler returns its own requeue
interval, and a watch on the API (FakeClient callbacks or periodic re-list)
collapses to the same behaviour because every pass re-reads the world.

The operator process launches no kernel and imports no ``torch``.  Its
``/metrics`` serves the standard-library registries of the port
(``controllers/metrics.exposition``) and the process and interpreter
families ``prometheus_client``'s default registry serves in the reference
(``controllers/metrics.process_exposition``).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import http.server
import json
import logging
import os
import signal
import threading
import time
import urllib.parse
from typing import Dict, Optional

from .. import consts
from ..client import ApiError, Client, ConflictError
from ..controllers import (TPUDriverReconciler, TPUPolicyReconciler,
                           UpgradeReconciler)
from ..controllers import metrics as operator_metrics
from ..controllers.tpudriver_controller import DRIVER_STATE_PREFIX
from ..controllers import events
from ..client import metrics as client_metrics
from ..informer import (DEFAULT_INDEXERS, KeyedWorkQueue,
                        SharedInformerCache)
from ..informer import snapshot as informer_snapshot
from ..obs import aioprof as obs_aioprof
from ..obs import export as obs_export
from ..obs import journal as obs_journal
from ..obs import logging as obs_logging
from ..obs import profile as obs_profile
from ..obs import slo as obs_slo
from ..obs import trace as obs
from ..obs import tsdb as obs_tsdb
from ..remediation import RemediationReconciler
from ..state import delta as state_delta
from ..state.skel import _workload_ready
from ..utils import concurrency
from ..utils.queryparams import int_param
from ..workload.controller import TPUWorkloadReconciler

log = logging.getLogger(__name__)

LEASE_NAME = "tpu-operator-leader"
LEASE_DURATION_S = 15


def micro_time(epoch: float) -> str:
    """RFC3339 MicroTime — the only renewTime/acquireTime encoding the Lease
    schema accepts (k8s.io/apimachinery MicroTime; a float epoch 400s)."""
    from datetime import datetime, timezone
    return (datetime.fromtimestamp(epoch, tz=timezone.utc)
            .strftime("%Y-%m-%dT%H:%M:%S.%fZ"))


def parse_micro_time(val) -> float:
    """Defensive MicroTime parse → epoch seconds.  Accepts RFC3339 with or
    without fractional seconds (other conformant clients), plus legacy
    numeric epochs (a pre-upgrade operator's lease must not crash the new
    one).  Unparseable → 0.0, i.e. treated as long expired."""
    from datetime import datetime, timezone
    if isinstance(val, (int, float)):
        return float(val)
    if not isinstance(val, str) or not val:
        return 0.0
    for fmt in ("%Y-%m-%dT%H:%M:%S.%fZ", "%Y-%m-%dT%H:%M:%SZ"):
        try:
            return datetime.strptime(val, fmt).replace(
                tzinfo=timezone.utc).timestamp()
        except ValueError:
            continue
    return 0.0


class LeaderElector:
    """Lease-based leader election (coordination.k8s.io analogue of
    controller-runtime's leader election, main.go:150-160).  Writes the
    real Lease wire schema: RFC3339 MicroTime renew/acquire times and int32
    leaseDurationSeconds — a real apiserver 400s float shapes, and a
    blanket except would hide it."""

    def __init__(self, client: Client, namespace: str, identity: str):
        self.client = client
        self.namespace = namespace
        self.identity = identity
        self.is_leader = False
        # failover accounting, set on a fresh acquisition FROM another
        # holder: who we took over from and when they last renewed (the
        # leadership-lost moment the runner's `failover` journal entry
        # times convergence against)
        self.took_over_from: Optional[str] = None
        self.leadership_lost_at = 0.0

    def _spec(self, now: float, prev: Optional[dict] = None) -> dict:
        spec = {"holderIdentity": self.identity,
                "renewTime": micro_time(now),
                "leaseDurationSeconds": int(LEASE_DURATION_S)}
        if prev is None or prev.get("holderIdentity") != self.identity:
            # fresh acquisition (not a renewal): stamp acquireTime and count
            # the transition, like client-go's leaderelection package
            spec["acquireTime"] = micro_time(now)
            spec["leaseTransitions"] = int(
                (prev or {}).get("leaseTransitions") or 0) + 1
        else:
            spec["acquireTime"] = prev.get("acquireTime", micro_time(now))
            spec["leaseTransitions"] = int(prev.get("leaseTransitions") or 0)
        return spec

    def try_acquire(self) -> bool:
        # every handler below names the typed ApiError taxonomy, never a
        # blanket Exception: a non-apiserver failure here (a genuine bug)
        # must crash loudly, not read as "lost the lease" forever — the
        # blind spot that would hide a float-MicroTime 422
        now = time.time()
        try:
            lease = self.client.get_or_none("Lease", LEASE_NAME,
                                            self.namespace)
        except ApiError as e:  # apiserver unavailable
            log.warning("leader election: lease read failed: %s", e)
            return False
        if lease is None:
            try:
                self.client.create({
                    "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                    "metadata": {"name": LEASE_NAME,
                                 "namespace": self.namespace},
                    "spec": self._spec(now)})
                self.is_leader = True
                return True
            except ConflictError:
                self.is_leader = False
                return False  # lost the creation race: a peer holds it
            except ApiError as e:
                # anything else (schema rejection, RBAC, transport) must be
                # visible — a silent return False strands the operator in
                # standby forever with no diagnostic
                log.warning("leader election: lease create failed: %s", e)
                self.is_leader = False
                return False
        spec = lease.get("spec", {})
        holder = spec.get("holderIdentity", "")
        renewed = parse_micro_time(spec.get("renewTime"))
        # a gracefully RELEASED lease carries leaseDurationSeconds=0
        # (see release()): it expires the instant it is written, so a
        # standby promotes on its next tick instead of waiting out the
        # full LEASE_DURATION_S — the zero-dead-air failover path
        try:
            duration = int(spec.get("leaseDurationSeconds",
                                    LEASE_DURATION_S))
        except (TypeError, ValueError):
            duration = LEASE_DURATION_S
        expired = now - renewed > duration
        if holder != self.identity and not expired:
            self.is_leader = False
            return False
        lease["spec"] = self._spec(now, prev=spec)
        try:
            self.client.update(lease)
            if holder and holder != self.identity:
                # fresh acquisition from a dead/released peer: record
                # the failover facts the runner journals on convergence
                self.took_over_from = holder
                self.leadership_lost_at = renewed
            self.is_leader = True
            return True
        except ConflictError:
            self.is_leader = False
            return False  # a peer renewed between our read and write
        except ApiError as e:
            log.warning("leader election: lease update failed: %s", e)
            self.is_leader = False
            return False

    def release(self) -> bool:
        """Graceful handoff (the SIGTERM path): stamp the held lease
        with ``leaseDurationSeconds=0`` and a final renewTime, so a
        standby's very next :meth:`try_acquire` sees it expired instead
        of waiting out the full lease duration.  The final renewTime IS
        the leadership-lost moment the successor's failover timing
        starts from.  Best-effort: losing the race to a peer that
        already took the lease means the release achieved its goal."""
        self.is_leader = False
        try:
            lease = self.client.get_or_none("Lease", LEASE_NAME,
                                            self.namespace)
        except ApiError as e:
            log.warning("leader election: lease read for release "
                        "failed: %s", e)
            return False
        if lease is None \
                or lease.get("spec", {}).get("holderIdentity") \
                != self.identity:
            return False    # not ours to release
        lease["spec"]["renewTime"] = micro_time(time.time())
        lease["spec"]["leaseDurationSeconds"] = 0
        try:
            self.client.update(lease)
            return True
        except ConflictError:
            return False    # a peer already renewed past us: moot
        except ApiError as e:
            log.warning("leader election: lease release failed: %s", e)
            return False


class DegradedMode:
    """Explicit ServeStale survival state for sustained partitions.

    A network split that black-holes writes opens the resilience
    layer's circuit breaker; before this class the operator burned the
    outage hammering retries and its probes read as dead.  Now: once
    the breaker has been OPEN continuously past ``budget_s``, the
    operator flips DEGRADED — reads keep answering from the informer
    cache (the caches stay current: watches are reads and survive an
    asymmetric partition), reconcile dispatch PARKS with journaled
    holds instead of spending retry budget, and /readyz reports the
    truth: ``degraded: serving-stale``, alive but unable to act.

    Recovery needs no relist storm: parked keys stay DUE in the work
    queue (dispatch merely skips them), and because the breaker only
    half-opens LAZILY (on the next gated call), degraded mode releases
    one dispatch pass every ``budget_s`` — those reconciles ARE the
    half-open probe traffic.  A healed partition lets the probe writes
    land, the breaker closes, and the next poll drains everything
    parked; a persistent one fails the probes, the breaker stays open,
    and the work re-parks until the next re-probe window."""

    def __init__(self, client, namespace: str, budget_s: float = 30.0,
                 clock=time.monotonic, lease_client=None):
        self.client = client
        # the leader election's own fail-fast client: a leader cut off
        # from the apiserver makes no call but its Lease renewals (the
        # scheduler stands by on a failed renewal), so its breaker is
        # the one that opens under a full outage
        self.lease_client = lease_client
        self.namespace = namespace
        self.budget_s = max(0.0, float(budget_s))
        self.clock = clock
        self.active = False
        self.entered_at = 0.0
        self._open_since: Optional[float] = None
        self._last_probe = 0.0
        self._parked: set = set()

    def _breaker_open(self) -> bool:
        from ..client.resilience import BREAKER_OPEN
        return any(getattr(c, "breaker_state", None) == BREAKER_OPEN
                   for c in (self.client, self.lease_client))

    def poll(self) -> bool:
        """Advance the state machine (pure memory, called once per
        scheduler pass); returns whether THIS pass should park.  While
        degraded, one pass per ``budget_s`` is released as the
        half-open probe (the breaker cannot leave OPEN without a gated
        call, and a fully-parked operator would otherwise make none)."""
        if self._breaker_open():
            now = self.clock()
            if self._open_since is None:
                self._open_since = now
            if not self.active \
                    and now - self._open_since >= self.budget_s:
                self.active = True
                self.entered_at = now
                self._last_probe = now
                obs_journal.record(
                    "operator", self.namespace, "degraded",
                    category="degraded", verdict="serving-stale",
                    reason="circuit breaker open past budget: parking "
                           "reconcile dispatch, serving cached reads "
                           "flagged stale",
                    inputs={"budget_s": self.budget_s})
            if self.active and now - self._last_probe >= self.budget_s:
                self._last_probe = now
                return False   # this pass is the re-probe
        else:
            self._open_since = None
            if self.active:
                self.active = False
                self.entered_at = 0.0
                parked, self._parked = self._parked, set()
                obs_journal.record(
                    "operator", self.namespace, "degraded",
                    category="degraded", verdict="recovered",
                    reason="circuit breaker closed: draining parked "
                           "work from the live queue (no relist)",
                    inputs={"parked_keys": len(parked)})
        return self.active

    def park(self, key: str) -> None:
        """Hold ``key`` this pass, journaling once per key per degraded
        episode.  The key stays due in the queue, so recovery drains it
        without any relist."""
        if key in self._parked:
            return
        self._parked.add(key)
        obs_journal.record(
            "operator", self.namespace, "degraded",
            category="degraded", verdict="parked",
            reason=f"reconcile work parked while serving stale: {key}",
            inputs={"key": key})


def _counter_value(counter) -> int:
    try:
        return int(counter.labels().value)
    except (AttributeError, TypeError, ValueError):
        return 0


def convergence_counters() -> dict:
    """The steady-state cost-model counters, as one JSON-able block —
    served under ``/debug/vars`` and rendered by ``tpu-status --perf``.
    A quiescent operator pins renders/diffs/status-writes flat while the
    hit/skip counters keep climbing."""
    from ..render.metrics import (render_cache_hits_total,
                                  render_cache_misses_total)
    from ..state.metrics import (fingerprint_rearms_total,
                                 fingerprint_skips_total, spec_diffs_total)
    return {
        "render_cache_hits": _counter_value(render_cache_hits_total),
        "render_cache_misses": _counter_value(render_cache_misses_total),
        "fingerprint_skips": _counter_value(fingerprint_skips_total),
        "fingerprint_rearms": _counter_value(fingerprint_rearms_total),
        "spec_diffs": _counter_value(spec_diffs_total),
        "status_writes": _counter_value(
            operator_metrics.status_writes_total),
        "status_write_skips": _counter_value(
            operator_metrics.status_write_skips_total),
        "readiness_triggers_armed": _counter_value(
            operator_metrics.readiness_triggers_armed_total),
        "readiness_triggers_fired": _counter_value(
            operator_metrics.readiness_triggers_fired_total),
    }


def _hist_quantile(hist, q: float) -> Optional[float]:
    """Quantile estimate from a histogram family's cumulative buckets
    (linear interpolation inside the winning bucket; labeled families are
    summed fleet-wide first).  None until the histogram has
    observations.  This is the telemetry sweep's bridge from the
    exposition-grade distributions the operator already keeps to the
    scalar SLI series the tsdb stores — no second histogram is kept.
    The samples are ``exposition.Sample`` tuples ``(name, labels,
    value)``."""
    bounds: dict = {}
    total = 0.0
    for metric in hist.collect():
        for name, labels, value in metric.samples:
            if name.endswith("_bucket"):
                le = dict(labels).get("le", "")
                bound = float("inf") if le in ("+Inf", "inf") \
                    else float(le)
                bounds[bound] = bounds.get(bound, 0.0) + value
            elif name.endswith("_count"):
                total += value
    if total <= 0.0 or not bounds:
        return None
    rank = q * total
    prev_bound, prev_count = 0.0, 0.0
    for bound in sorted(bounds):
        count = bounds[bound]
        if count >= rank:
            if bound == float("inf") or count <= prev_count:
                # the tail bucket has no upper edge to interpolate
                # toward — report its lower edge (an underestimate,
                # stated in docs/OBSERVABILITY.md)
                return prev_bound
            frac = (rank - prev_count) / (count - prev_count)
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_count = bound, count
    return prev_bound


# the ?n= ceiling for /debug/traces: the store never holds more than a
# few hundred traces, so anything past this is a typo or a probe — 400,
# not a silent clamp
MAX_DEBUG_TRACES_N = 10_000

# /debug/explain defaults: entries served per object (?n= raises it up
# to the journal's own ring bound)
DEBUG_EXPLAIN_DEFAULT_N = 64
MAX_DEBUG_EXPLAIN_N = 10_000

# journal kind -> the Event involvedObject kind the backfill emitter
# publishes against ("slice" is a pseudo-object with no API resource;
# its story reaches kubectl describe through the per-node entries)
_JOURNAL_EVENT_KINDS = {
    "node": "Node", "tpuworkload": "TPUWorkload",
    "tpudriver": "TPUDriver", "tpupolicy": "TPUPolicy",
    "daemonset": "DaemonSet",
}


# how stale any watched kind's informer store may get before /readyz
# flips 503: two resync periods means the in-loop staleness backstop
# (SharedInformerCache.maybe_resync) had a full period to repair the
# stream and failed — the cache is genuinely blind, and a blind operator
# must not advertise itself ready
READY_STALENESS_BOUND_S = 2 * SharedInformerCache.RESYNC_PERIOD_S


class _DaemonThreadingHTTPServer(http.server.ThreadingHTTPServer):
    """ThreadingHTTPServer defaults ``daemon_threads = False``: one hung
    scrape client (half-open TCP, stalled reader) strands a non-daemon
    handler thread and delays interpreter shutdown indefinitely.  Handler
    threads serve read-only snapshots, so nothing is lost by not joining
    them at exit."""

    daemon_threads = True


class HealthServer:
    """/healthz + /readyz + /metrics + /debug endpoints
    (main.go:80,102-104; /debug is the pprof analogue).

    With an ``informer`` wired in, /readyz also gates on cache
    staleness: any watched kind whose last-sync age exceeds
    ``staleness_bound_s`` flips readiness to 503 with a body naming the
    stale kind, so a silently-dead watch stream surfaces in ``kubectl
    get pods`` instead of in an incident review."""

    def __init__(self, health_port: int, metrics_port: int,
                 debug: bool = False, informer=None,
                 staleness_bound_s: Optional[float] = None,
                 degraded=None):
        self.ready = threading.Event()
        self.debug = debug
        self.informer = informer
        # zero-arg callable -> truthy while the operator is in explicit
        # ServeStale degraded mode (sustained apiserver partition): the
        # probe answers 200 `degraded: serving-stale` INSTEAD of the
        # staleness 503s below — a partitioned operator serving stale
        # reads by design is degraded, not dead, and restarting it
        # would only add a rebuild to the outage
        self.degraded = degraded
        self.staleness_bound_s = (READY_STALENESS_BOUND_S
                                  if staleness_bound_s is None
                                  else staleness_bound_s)
        self._servers = []
        outer = self

        start_time = time.time()

        class HealthHandler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    self._ok(b"ok")
                elif self.path == "/readyz":
                    if not outer.ready.is_set():
                        self.send_error(503)
                        return
                    if outer.degraded is not None and outer.degraded():
                        self._ok(b"degraded: serving-stale\n")
                        return
                    stale = (outer.informer.stale_kinds(
                        outer.staleness_bound_s)
                        if outer.informer is not None else [])
                    # transport-level freshness rides the same gate: a
                    # watch STREAM that is open but silent past the
                    # bound (no event, bookmark, or reconnect) means
                    # the loop-side stream wedged in a way even the
                    # informer's last-sync may lag in seeing
                    stale_streams = client_metrics.stale_watch_kinds(
                        outer.staleness_bound_s)
                    if stale or stale_streams:
                        parts = []
                        if stale:
                            parts.append("informer cache stale: "
                                         + "; ".join(
                                             f"{kind} " + (
                                                 "never synced"
                                                 if age == float("inf")
                                                 else f"last synced "
                                                      f"{age:.0f}s ago")
                                             for kind, age in stale))
                        if stale_streams:
                            parts.append("watch stream silent: "
                                         + "; ".join(
                                             f"{kind} {age:.0f}s"
                                             for kind, age
                                             in stale_streams))
                        body = ("; ".join(parts) + "\n").encode()
                        self.send_response(503)
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self._ok(b"ok")
                # pprof-analogue debug surface (SURVEY.md §5: the reference
                # has none; observability is otherwise metrics+logs only).
                # Opt-in: stack traces are an information-disclosure
                # surface, so it stays 404 unless --debug-endpoints is set.
                elif self.path.startswith("/debug/") and not outer.debug:
                    self.send_error(404)
                elif self.path == "/debug/stacks":
                    self._ok(obs_profile.thread_stacks().encode())
                elif self.path == "/debug/vars":
                    self._ok(json.dumps({
                        "pid": os.getpid(),
                        "uptime_s": round(time.time() - start_time, 1),
                        "threads": threading.active_count(),
                        "ready": outer.ready.is_set(),
                        # steady-state cost-model counters (render cache,
                        # fingerprint short-circuit, status coalescing,
                        # readiness triggers) — tpu-status --perf renders
                        "convergence": convergence_counters(),
                    }).encode())
                elif urllib.parse.urlsplit(self.path).path \
                        == "/debug/traces":
                    # the flight recorder: N most recent + N slowest
                    # reconcile traces (obs/trace.py ring buffer), the
                    # payload tpu-status --traces renders.  ?n= runs
                    # through the shared validator (utils/queryparams):
                    # non-integer/negative/absurd values are client
                    # errors that say so, never a silent fallback
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlsplit(self.path).query)
                    n, err = int_param(q, "n", 20, 0, MAX_DEBUG_TRACES_N)
                    if err:
                        self.send_error(400, err)
                        return
                    self._ok(json.dumps(obs.snapshot(n)).encode())
                elif urllib.parse.urlsplit(self.path).path.startswith(
                        "/debug/explain/"):
                    # the decision journal: why is this object in the
                    # state it is in — entries + blocking objects'
                    # entries + the badput split (obs/journal.py;
                    # tpu-status explain renders it)
                    split = urllib.parse.urlsplit(self.path)
                    parts = split.path[len("/debug/explain/"):].split("/")
                    if len(parts) != 3 or not parts[0] or not parts[2]:
                        self.send_error(
                            400, "use /debug/explain/<kind>/<namespace>/"
                                 "<name> ('-' for cluster-scoped kinds)")
                        return
                    q = urllib.parse.parse_qs(split.query)
                    n, err = int_param(q, "n", DEBUG_EXPLAIN_DEFAULT_N,
                                       1, MAX_DEBUG_EXPLAIN_N)
                    if err:
                        self.send_error(400, err)
                        return
                    kind, ns, obj_name = parts
                    self._ok(json.dumps(obs_journal.explain(
                        kind, "" if ns == "-" else ns, obj_name,
                        n=n)).encode())
                elif self.path.startswith("/debug/trace/"):
                    # one stored trace as Chrome trace_event JSON —
                    # loads in chrome://tracing / ui.perfetto.dev.
                    # Suffix-match on the PATH component, like the
                    # sibling endpoints: a cache-buster query string
                    # must not 404 an existing trace
                    tail = urllib.parse.urlsplit(
                        self.path).path[len("/debug/trace/"):]
                    if not tail.endswith(".json"):
                        self.send_error(404)
                        return
                    trace = obs.get_trace(tail[:-len(".json")])
                    if trace is None:
                        self.send_error(404, "no such trace id (evicted "
                                             "from the ring buffer?)")
                        return
                    self._ok(json.dumps(obs_export.chrome_trace(
                        trace, obs_profile.sampler_snapshot())).encode())
                elif urllib.parse.urlsplit(self.path).path \
                        == "/debug/profile":
                    # the cost-attribution board + self-time
                    # decomposition + sampler folded stacks + histogram
                    # exemplars (obs/profile.py); ?format=chrome serves
                    # the sampler timeline as trace_event JSON instead
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlsplit(self.path).query)
                    if q.get("format", [""])[0] == "chrome":
                        payload = obs_export.chrome_sampler(
                            obs_profile.sampler_snapshot())
                    else:
                        payload = obs_profile.profile_snapshot()
                        # the event-loop/transport block (loop lag,
                        # pool lease waits) rides the same payload so
                        # `tpu-status --profile` renders loop rows
                        # alongside the span attribution table
                        payload["loop"] = \
                            client_metrics.loop_debug_snapshot()
                    self._ok(json.dumps(payload).encode())
                elif urllib.parse.urlsplit(self.path).path \
                        == "/debug/loop":
                    # event-loop observability: per-loop lag histogram
                    # + slow-callback count + task census, pool
                    # saturation/lease waits, watch-stream freshness,
                    # offload-executor budgets — tpu-status --loop
                    # renders it (docs/OBSERVABILITY.md)
                    self._ok(json.dumps(
                        client_metrics.loop_debug_snapshot()).encode())
                elif urllib.parse.urlsplit(self.path).path \
                        == "/debug/slo":
                    # the SLO board: every declared SLO's budget line,
                    # burn rates, open episodes and parked validation
                    # holds (obs/slo.py; tpu-status slo renders it)
                    self._ok(json.dumps(obs_slo.snapshot()).encode())
                elif urllib.parse.urlsplit(self.path).path \
                        == "/debug/tsdb":
                    # the telemetry substrate: full store snapshot, or
                    # one series family's points + trend primitives
                    # with ?series=<name>&window=<seconds>
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlsplit(self.path).query)
                    window, err = int_param(
                        q, "window", 0, 0, 7 * 24 * 3600)
                    if err:
                        self.send_error(400, err)
                        return
                    self._ok(json.dumps(obs_tsdb.debug_payload(
                        series_name=q.get("series", [""])[0],
                        window_s=float(window) if window else None,
                    )).encode())
                else:
                    self.send_error(404)

            def _ok(self, body: bytes):
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        class MetricsHandler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path != "/metrics":
                    self.send_error(404)
                    return
                # operator metrics (own registries, operator_metrics.go
                # analogue) + the process and interpreter families
                body = (operator_metrics.exposition()
                        + operator_metrics.process_exposition())
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        for port, handler in ((health_port, HealthHandler),
                              (metrics_port, MetricsHandler)):
            srv = _DaemonThreadingHTTPServer(("", port), handler)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            self._servers.append(srv)

    def ports(self):
        return [s.server_address[1] for s in self._servers]

    def shutdown(self):
        for s in self._servers:
            s.shutdown()


# per-CR driver keys: each TPUDriver CR schedules under its own
# ``driver/<name>`` key (client-go's per-object queue key), so dedup,
# generations and exponential backoff isolate per CR — a 500-ing CR
# backs off alone instead of delaying every healthy one.  The bare
# ``driver`` key remains as the discovery/backstop key: it reconciles
# the KEY SET against the CR set (create on first sight, retire on
# deletion) and carries the conservative wake for events whose owning
# CR is not yet known.
DRIVER_KEY_PREFIX = "driver/"

# per-node remediation keys: each node under active remediation
# schedules under its own ``remediate/<node>`` key (the same dynamic-key
# machinery as driver CRs), so one stuck repair backs off alone while
# the singleton ``remediation`` key keeps detecting/tracking the fleet
REMEDIATION_KEY_PREFIX = "remediate/"

# per-CR workload keys: each TPUWorkload schedules under its own
# ``workload/<namespace>/<name>`` key (TPUWorkloads are namespaced, so
# the key carries both coordinates), created on first sight via watch or
# discovery and retired on deletion — a crash-looping gang backs off
# alone while healthy gangs keep converging
WORKLOAD_KEY_PREFIX = "workload/"


def workload_key(namespace: str, name: str) -> str:
    return f"{WORKLOAD_KEY_PREFIX}{namespace}/{name}"


# readiness-triggered requeue: a pass that parks NotReady registers the
# concrete workloads it waits on (ReconcileResult.waits); the watch
# event that flips one ready wakes the key IMMEDIATELY, so the timed
# requeue stops being the convergence path and demotes to this backstop
# — long enough to stop the 5 s polling churn, short enough that a
# missed readiness event (dropped stream, filter bug) still converges
# within one backstop period (the chaos tier pins exactly that).
READINESS_BACKSTOP_S = 30.0


# which watched kinds wake which reconciler (reference SetupWithManager
# watch wiring: clusterpolicy_controller.go:356-424,
# nvidiadriver_controller.go:254-425)
_WAKE_KINDS = {
    "policy": {"TPUPolicy", "Node", "DaemonSet"},
    "driver": {"TPUDriver", "TPUPolicy", "Node", "DaemonSet"},
    "upgrade": {"TPUPolicy", "Node", "Pod"},
    # remediation detects on Node signals (ici-degraded annotation,
    # NotReady condition), re-checks on validator-pod readiness flips,
    # and re-reads its knobs on TPUPolicy changes
    "remediation": {"TPUPolicy", "Node", "Pod"},
    # gang workloads re-place on fleet changes (Node), track their
    # member pods (Pod, filtered to gang-labelled pods), and follow
    # their own CR lifecycle
    "workload": {"TPUWorkload", "Node", "Pod"},
}


def _state_label(obj: dict) -> str:
    return obj.get("metadata", {}).get("labels", {}).get(
        consts.STATE_LABEL, "")


def _wake_wanted(rec: str, kind: str, obj: dict) -> bool:
    """Per-state watch-source filtering (reference GetWatchSources — each
    state exports label-selector-scoped sources, internal/state/
    manager.go:31-34, driver.go:165-180).  Kind-wide wakes made every DS
    or pod event in the namespace wake all three reconcilers; the state
    label every managed object carries says which engine owns it."""
    if kind not in _WAKE_KINDS[rec]:
        return False
    if kind == "DaemonSet":
        state = _state_label(obj)
        if not state:
            return True   # foreign/unlabelled DS: conservative wake
        is_driver_cr = state.startswith(DRIVER_STATE_PREFIX)
        return is_driver_cr if rec == "driver" else not is_driver_cr
    if kind == "Pod" and rec in ("upgrade", "remediation"):
        labels = obj.get("metadata", {}).get("labels", {})
        # only driver/validator pods matter to the upgrade/remediation
        # machines within the operator namespace (workload pods live
        # outside it and are polled on the fast in-flight requeue
        # instead)
        return labels.get("app.kubernetes.io/component") == \
            consts.DRIVER_COMPONENT_LABEL_VALUE \
            or labels.get("app") == "tpu-operator-validator"
    if kind == "Pod" and rec == "workload":
        # only gang member pods wake the workload controller — operand
        # DS churn is none of its business
        return consts.WORKLOAD_NAME_LABEL in \
            obj.get("metadata", {}).get("labels", {})
    return True


def _outcome(res) -> str:
    """Histogram outcome label from a ReconcileResult."""
    if res is None:
        return "requeue"
    if res.error:
        return "error"
    return "ready" if res.ready else "requeue"


class _ReconcileObs:
    """Per-invocation observability envelope around one reconciler run:

    * opens the ``reconcile.<controller>`` root span, reusing the trace
      id allocated at watch delivery (so one id links the event, the
      queue wait, every phase, and the client writes);
    * records the retroactive ``queue.wait`` span from the originating
      event's monotonic stamp to the moment the reconcile started;
    * binds the controller name into the log context (structured logs
      emitted inside the pass carry ``controller=``);
    * captures the pass's status write (obs.write_capture) and observes
      the per-controller duration and end-to-end convergence-latency
      histograms on exit — both work with tracing disabled.
    """

    def __init__(self, controller: str, stamp: Optional[obs.WatchStamp],
                 key: Optional[str] = None):
        self.controller = controller
        # the work-queue key this pass runs under: the controller name
        # for the singleton reconcilers, ``driver/<cr>`` for a per-CR
        # driver pass — spans and logs carry it so a noisy CR is
        # attributable even though the metrics label stays bounded at
        # the controller name
        self.key = key or controller
        self.stamp = stamp
        self.outcome = "error"     # overwritten by done(); raises keep it
        self._stack = contextlib.ExitStack()
        self._writes = obs.write_capture()
        self._start = 0.0
        self._trace_id = ""

    def __enter__(self) -> "_ReconcileObs":
        self._start = time.monotonic()
        attrs = {"controller": self.controller, "key": self.key,
                 "trigger": "event" if self.stamp is not None
                 else "deadline"}
        worker = concurrency.current_worker_id()
        if worker is not None:
            # which pool worker ran the pass: with the queue.wait span,
            # this splits "queued behind a full pool" from "slow
            # reconcile" in /debug/traces
            attrs["worker"] = worker[1]
        if self.stamp is not None:
            attrs.update({"event.kind": self.stamp.kind,
                          "event.verb": self.stamp.verb,
                          "event.name": self.stamp.name})
        root = obs.root_span(
            f"reconcile.{self.controller}", attrs=attrs,
            trace_id=(self.stamp.trace_id or None)
            if self.stamp is not None else None)
        # kept for the histogram exemplars below: the bucket a slow pass
        # lands in remembers this trace id (empty when tracing is off)
        self._trace_id = getattr(root, "trace_id", "")
        self._stack.enter_context(self._writes)
        # logs carry both the controller and the (possibly per-CR) queue
        # key so pipelines can join on either vocabulary
        self._stack.enter_context(
            obs.log_context(controller=self.controller, key=self.key))
        self._stack.enter_context(root)
        if self.stamp is not None:
            obs.record_span(
                "queue.wait", start_mono=self.stamp.mono,
                end_mono=self._start, parent=root,
                attrs={"event.kind": self.stamp.kind,
                       "event.verb": self.stamp.verb,
                       "event.name": self.stamp.name})
        return self

    def done(self, res) -> None:
        self.outcome = _outcome(res)

    def __exit__(self, exc_type, exc, tb) -> None:
        self._stack.__exit__(exc_type, exc, tb)
        duration = time.monotonic() - self._start
        outcome = "error" if exc_type is not None else self.outcome
        operator_metrics.reconcile_duration_seconds.labels(
            controller=self.controller, outcome=outcome).observe(duration)
        # bucket exemplar: the slowest pass in each duration bucket keeps
        # its trace id, so a fat histogram tail links straight to its
        # flight record (/debug/trace/<id>.json).  No-op without a trace.
        obs_profile.note_exemplar(
            "reconcile_duration_seconds", self.controller, duration,
            self._trace_id, operator_metrics.RECONCILE_BUCKETS)
        if self.stamp is not None:
            # convergence end: the pass's status-subresource write (or,
            # lacking one, its last write of any kind) — only passes
            # that PUBLISHED something converged on anything
            wrote = self._writes.last.get("status_wall",
                                          self._writes.last.get("wall"))
            if wrote is not None:
                latency = max(0.0, wrote - self.stamp.wall)
                operator_metrics.convergence_latency_seconds.labels(
                    controller=self.controller).observe(latency)
                obs_profile.note_exemplar(
                    "convergence_latency_seconds", self.controller,
                    latency, self._trace_id,
                    operator_metrics.CONVERGENCE_BUCKETS)


class OperatorRunner:
    """Drives the reconcilers on their requeue cadence, woken immediately
    by watch events (controller-runtime's watch-triggered reconcile; the
    requeue deadlines remain as the level-triggered backstop).

    Reads go through a shared informer cache (informer/cache.py): one
    LIST per kind at startup, kept current by the watch stream, so a
    steady-state reconcile pass costs O(changes) apiserver reads instead
    of re-listing the world.  Scheduling state lives in a keyed work
    queue (informer/workqueue.py): watch events mark a reconciler due
    (deduplicated), successful passes commit their requeue deadline, and
    failing passes back off per-key exponentially.

    Execution is CONCURRENT (controller-runtime's
    ``MaxConcurrentReconciles``): due keys dispatch onto a bounded
    worker pool, so the policy/driver/upgrade controllers and N driver
    CRs overlap instead of queueing behind each other.  Two guarantees
    survive the handoff: a key NEVER runs concurrently with itself (the
    in-flight set below + ``step()``'s end-of-pass barrier), and the
    generation race-closure still decides whether a pass's deadline
    commit wins against a mid-flight event.  With
    ``max_concurrent_reconciles=1`` every key runs inline on the
    caller, in due order — byte-for-byte the serial scheduler."""

    WORK_KEYS = ("policy", "driver", "upgrade", "remediation", "workload",
                 "telemetry")

    def __init__(self, client: Client, namespace: str,
                 leader_election: bool = False, identity: str = "",
                 max_concurrent_reconciles: int = 4,
                 max_concurrent_remediations: int = 1,
                 snapshot_dir: str = "",
                 snapshot_interval_s: float = 30.0,
                 degraded_budget_s: float = 30.0,
                 slo_eval_interval_s: float = 15.0,
                 wake_debounce_s: float = 0.0,
                 wake_max_delay_s: float = 0.0):
        self.client = client
        self.namespace = namespace
        self.stop = threading.Event()
        self._wake = threading.Event()
        # the async-dispatch twin of _wake: an asyncio.Event on the
        # client's loop, created by _arun_loop and signalled (thread-
        # safely) by _wake_set.  None while the async scheduler is not
        # running.
        self._awake: Optional[asyncio.Event] = None
        # stop-interruptible async sleeps: request_stop sets this so the
        # standby/debounce waits end immediately (the stop.wait twin)
        self._astop: Optional[asyncio.Event] = None
        # the client's event-loop bridge when the async core is in play
        # (InClusterClient exposes it; RetryingClient proxies it; plain
        # fakes have none) — discovered once, drives run()'s choice of
        # scheduler and the controllers' write fan-out
        self.loop_bridge = getattr(client, "loop_bridge", None)
        # shared informer cache: operand pod/DS watches only matter in our
        # namespace; CRs and Nodes are cluster-scoped
        self.informer = SharedInformerCache(
            client, namespaces={"Pod": namespace, "DaemonSet": namespace})
        for kind, idx_name, fn in DEFAULT_INDEXERS:
            self.informer.add_index(kind, idx_name, fn)
        # every policy pass lists validator pods by app label (slice
        # readiness); serve that selector from an index bucket
        self.informer.add_label_index("Pod", "app")
        # crash-safety: restore the informer from the on-disk snapshot
        # BEFORE the watches start, so every restored kind's stream
        # resumes from its recorded resourceVersion — a cold boot after
        # a crash replays the delta instead of relisting the world
        # (zero seed LISTs for snapshot-covered kinds).  The periodic
        # saver thread starts with run(); no --snapshot-dir means the
        # shared no-op (informer/snapshot.py NOOP)
        self.snapshotter = informer_snapshot.manager_for(
            self.informer, snapshot_dir, interval_s=snapshot_interval_s)
        self.snapshotter.restore()
        self.informer.start(stop=self.stop)
        self.reader = self.informer.reader()
        # the awaitable read view the async scheduler's own reads use
        # (discovery listings, deleted-between-wake-and-run probes):
        # cache-covered reads stay in-memory; an unsynced store falls
        # through to the client's async core instead of the sync facade
        from ..client.aview import AsyncView
        self.areader = AsyncView(self.reader)
        self.policy_rec = TPUPolicyReconciler(client, namespace,
                                              reader=self.reader)
        self.driver_rec = TPUDriverReconciler(client, namespace,
                                              reader=self.reader)
        self.upgrade_rec = UpgradeReconciler(client, namespace,
                                             reader=self.reader)
        self.remediation_rec = RemediationReconciler(
            client, namespace, reader=self.reader,
            max_concurrent=max_concurrent_remediations)
        self.workload_rec = TPUWorkloadReconciler(client, namespace,
                                                  reader=self.reader)
        # gang-pod lookups: one bucket per workload (the per-CR pod
        # listing) and one for the component-wide busy-host scan
        self.informer.add_label_index("Pod", consts.WORKLOAD_NAME_LABEL)
        self.informer.add_label_index("Pod", "app.kubernetes.io/component")
        if self.loop_bridge is not None:
            # size the loop's offload pool to the worst concurrent
            # demand: every reconcile body may block on a full write
            # fan-out, and a pool smaller than bodies x (1 + writers)
            # is a hard deadlock (each worker holds a body waiting for
            # a thunk that needs a worker)
            writers = getattr(self.policy_rec, "_write_workers", 8)
            self.loop_bridge.ensure_offload_capacity(
                max(1, int(max_concurrent_reconciles)) * (1 + writers) + 8)
        # lease traffic gets its own FAIL-FAST retry scope: a renew that
        # blocks retrying past the lease cadence widens the dual-leader
        # window instead of narrowing it (client/resilience.py)
        from ..client.resilience import LEASE_RETRY_POLICY, RetryingClient
        lease_client = (client.scoped(LEASE_RETRY_POLICY, scope="lease")
                        if isinstance(client, RetryingClient) else client)
        self.elector = (LeaderElector(lease_client, namespace,
                                      identity or os.environ.get(
                                          "HOSTNAME", "tpu-operator"))
                        if leader_election else None)
        # degraded-mode survival: a breaker held open past the budget
        # flips the runner into explicit ServeStale instead of letting
        # the partition read as dead (DegradedMode docstring)
        self.degraded = DegradedMode(
            client, namespace, budget_s=degraded_budget_s,
            lease_client=lease_client if leader_election else None)
        # telemetry sweep cadence + badput-delta memory (the sweep
        # samples per-category rate as the delta of the journal's
        # accrual integrals between sweeps)
        self.slo_eval_interval_s = max(1.0, float(slo_eval_interval_s))
        self._badput_prev: dict = {}
        self._badput_prev_t: Optional[float] = None
        # failover accounting armed by _note_leadership on takeover and
        # journaled by _maybe_journal_failover at first quiesce
        self._failover: Optional[dict] = None
        # True only for request_stop()-initiated exits: run()'s handoff
        # (snapshot flush + early lease release) is the GRACEFUL path —
        # a crash or hard kill never executes it
        self._graceful = False
        # keyed work queue: deadlines + event generations + per-key
        # backoff.  The queue closes the mid-reconcile-event race: step()
        # only commits a new deadline if no event for that reconciler
        # arrived while it was reconciling (otherwise the event would be
        # silently swallowed).  wake_debounce_s > 0 turns on the delta
        # engine's wake-batching: event bursts coalesce into one pass
        # per key carrying the union of invalidations (--wake-debounce /
        # --wake-max-delay; 0 keeps the legacy event-wins-now behavior,
        # which simulated-time tests rely on)
        self.wake_debounce_s = max(0.0, float(wake_debounce_s))
        self.wake_max_delay_s = max(self.wake_debounce_s,
                                    float(wake_max_delay_s))
        self.queue = KeyedWorkQueue(self.WORK_KEYS,
                                    debounce_s=self.wake_debounce_s,
                                    max_delay_s=self.wake_max_delay_s)
        # speculative pre-render tasks, key -> asyncio.Task, owned by the
        # loop thread: spawned while a debounced wake waits its window,
        # awaited (or cancelled) by the pass before it touches the memos
        self._prerender_tasks: Dict[str, asyncio.Task] = {}
        # bounded reconcile worker pool; size 1 = inline serial dispatch
        self.max_concurrent_reconciles = max(1, int(max_concurrent_reconciles))
        self._pool = concurrency.BoundedExecutor(
            self.max_concurrent_reconciles, name="reconcile")
        # keys currently executing on a worker: the per-key serialization
        # guarantee — a due key already in flight is never dispatched
        # again until its run finishes (guarded by _sched_lock)
        self._inflight: set = set()
        # Node heartbeat filter state: node name -> last-seen signature;
        # _sched_lock orders watch-thread updates to it
        self._sched_lock = threading.Lock()
        self._node_sigs: dict = {}
        # DaemonSet rollout filter state: (ns, name) -> last-seen
        # signature.  Mid-rollout status bumps (numberReady 1→2→3…) used
        # to wake every interested reconciler per bump; only events that
        # change what a reconciler can act on — spec/metadata, the
        # readiness VERDICT, lifecycle — wake now, and the registered
        # readiness waits catch the final flip precisely
        self._ds_sigs: dict = {}
        # events reach the runner through the cache's fan-out, AFTER the
        # store is updated — a woken reconciler always reads a cache at
        # least as new as its wake event
        self.informer.subscribe(self._on_event)
        # a relist (410 recovery, staleness resync) may have absorbed
        # events the watch never delivered: every key re-checks from a
        # FULL pass — the delta engine's unattributable-change fallback.
        # (The boot seed relists fire before this subscription; keys are
        # born due with no hint, which is already a full pass.)
        self.informer.subscribe_relist(self._on_relist)
        # journal-entry -> Event backfill: fresh journal entries that
        # carry an emit reason (upgrade stage hops today) surface in
        # kubectl describe, so the journal and the Event stream tell one
        # story.  Only FRESH appends emit (a count bump is a story the
        # Event already tells), and the emitter itself rides the
        # window-coalescing recorder, so a steady state emits nothing.
        obs_journal.set_emitter(self._emit_journal_event)

    def _emit_journal_event(self, kind: str, ns: str, name: str,
                            reason: str, message: str,
                            etype: str) -> None:
        api_kind = _JOURNAL_EVENT_KINDS.get(kind.lower(), "")
        if not api_kind:
            return   # pseudo-kinds (slice) have no Event involvedObject
        # namespace resolution matches the direct emit sites: a
        # namespaced object's own namespace, cluster-scoped objects'
        # events in "default" (the kubelet's own convention for Nodes)
        events.emit(
            self.client,
            {"apiVersion": "", "kind": api_kind,
             "metadata": {"name": name, "namespace": ns}},
            reason, message, etype=etype, namespace=ns)

    # scheduling-state views (the queue is the source of truth; tests
    # force deadlines/generations through these exactly as they did when
    # the runner owned plain dicts — both are the queue's LIVE dicts)
    @property
    def _next(self):
        return self.queue.deadlines

    @_next.setter
    def _next(self, value):
        self.queue.set_deadlines(value)

    @property
    def _gen(self):
        return self.queue.generations

    @_gen.setter
    def _gen(self, value):
        self.queue.set_generations(value)

    def _wake_set(self) -> None:
        """Interrupt the scheduler's sleep: the threading event for the
        serial/pooled loop, plus (thread-safely) the asyncio event when
        the async dispatcher is running on the client's loop."""
        self._wake.set()
        if self.loop_bridge is not None:
            awake, astop = self._awake, self._astop
            if awake is not None:
                self.loop_bridge.call_soon(awake.set)
            if astop is not None and self.stop.is_set():
                self.loop_bridge.call_soon(astop.set)

    def _kick_prerender(self) -> None:
        """Speculative pre-render: a targeted DaemonSet wake is about to
        sit out a debounce window — spend that window warming the policy
        renderer's decorated cache on the loop, so the pass that fires at
        the deadline starts hot.  Only meaningful under wake-batching
        (without a debounce the pass dispatches next tick anyway) and only
        when the async dispatcher is live."""
        if self.wake_debounce_s <= 0.0 or self.loop_bridge is None \
                or self._awake is None:
            return
        try:
            self.loop_bridge.call_soon(self._spawn_prerender, "policy")
        except Exception:  # noqa: BLE001 - bridge tearing down
            log.debug("prerender kick dropped", exc_info=True)

    def _spawn_prerender(self, key: str) -> None:
        """Loop-thread half of the kick: spawn at most one speculative
        task per key, never while that key's real pass is in flight (the
        pass reads the same memo the speculation writes)."""
        if self.stop.is_set() or key in self._prerender_tasks:
            return
        with self._sched_lock:
            if key in self._inflight:
                return
        t = obs_aioprof.spawn(self._aprerender(key),
                              name=f"prerender-{key}", family="prerender")
        self._prerender_tasks[key] = t
        t.add_done_callback(
            lambda _t, k=key: self._prerender_tasks.pop(k, None)
            if self._prerender_tasks.get(k) is _t else None)

    async def _aprerender(self, key: str) -> None:
        """The speculation body: pure compute plus cache reads — it warms
        the SyncMemo's decorated cache and writes nothing to the cluster,
        so a wasted speculation (spec changed, fingerprint moved) costs
        only CPU the debounce window had to burn anyway."""
        try:
            if key == "policy":
                await self.policy_rec.aprerender()
        except Exception:  # noqa: BLE001 - speculation is best-effort
            log.debug("prerender failed (key=%s)", key, exc_info=True)

    def request_stop(self) -> None:
        """Stop the loop and interrupt its sleep immediately.  The worker
        pool begins draining (in-flight reconciles finish, queued ones
        still run, then every worker thread exits); ``run()``'s exit path
        joins them so shutdown leaks no worker threads.

        A stop requested through here is a GRACEFUL shutdown (SIGTERM,
        test teardown): ``run()``'s exit path flushes one final informer
        snapshot and releases the leadership lease early, so a standby
        promotes on its next tick with the freshest resume point.  A
        crash or hard kill never reaches this method — the handoff runs
        exactly on the graceful path."""
        self._graceful = True
        self.stop.set()
        self._wake_set()
        self._pool.shutdown(wait=False)

    @staticmethod
    def _node_sig(obj: dict) -> tuple:
        """The parts of a Node the reconcilers actually read: labels
        (deploy/slice/upgrade state), annotations (upgrade bookkeeping),
        spec (cordon), and extended-resource capacity (the device plugin
        registering/withdrawing nvidia.com/gpu must wake reconcilers —
        plugin validation and slice readiness key on it).
        Plus the NotReady VERDICT (remediation/machine.py): a killed
        kubelet flips Ready to False/Unknown and that flip must wake
        the remediation sweep — but heartbeat noise must not, so the
        signature carries only the boolean "is this node NotReady", not
        the condition payload: lastHeartbeatTime bumps AND the first
        appearance of a healthy Ready condition (None -> True, every
        node's bring-up) both signature identically.  The rest of
        status is excluded as heartbeat noise."""
        md = obj.get("metadata", {})
        status = obj.get("status", {})
        capacity = {k: v for k, v in
                    (status.get("capacity") or {}).items()
                    if "/" in k}  # extended resources only: cpu/mem drift
        not_ready = any(c.get("type") == "Ready"
                        and c.get("status") in ("False", "Unknown")
                        for c in status.get("conditions") or [])
        return (md.get("labels", {}), md.get("annotations", {}),
                obj.get("spec", {}), capacity, not_ready)

    @staticmethod
    def _ds_sig(obj: dict) -> tuple:
        """The parts of a DaemonSet event a reconciler can act on: spec
        and metadata (drift/stomp, ownership labels, applied-hash
        annotations) plus the binary readiness verdict.  Status counter
        bumps that do not flip the verdict are rollout heartbeats — the
        pass they would wake reads the same cache and decides the same
        thing, so they only burn renders/diffs."""
        md = obj.get("metadata", {})
        return (md.get("labels", {}), md.get("annotations", {}),
                obj.get("spec", {}), _workload_ready(obj))

    def _route_daemonset(self, verb: str, obj: dict) -> bool:
        """DaemonSet-specific pre-routing: fire readiness triggers the
        moment a waited-on DS flips ready, and drop verdict-neutral
        status heartbeats.  Returns True when the generic kind routing
        should still run for this event."""
        md = obj.get("metadata", {})
        target = ("DaemonSet", md.get("namespace", ""), md.get("name", ""))
        with self._sched_lock:
            if verb == "DELETED":
                self._ds_sigs.pop(target[1:], None)
                suppressed = False
            else:
                sig = self._ds_sig(obj)
                suppressed = self._ds_sigs.get(target[1:]) == sig
                self._ds_sigs[target[1:]] = sig
        woke = False
        if verb != "DELETED" and _workload_ready(obj):
            # the readiness flip some parked pass registered a wait for:
            # wake exactly the owning key(s), consuming their waits
            hint = state_delta.DeltaHint.targeted(
                {target}, reason="ds-readiness-flip")
            for key in self.queue.match_waits(target):
                if self.queue.mark_due(key, stamp=obs.watch_stamp(verb,
                                                                  obj),
                                       hint=hint):
                    operator_metrics.readiness_triggers_fired_total.inc()
                    woke = True
        if woke:
            self._wake_set()
        return not suppressed

    def _on_event(self, verb: str, obj: dict) -> None:
        """Cache fan-out callback: mark the reconcilers interested in this
        kind due, then interrupt the runner's sleep."""
        kind = obj.get("kind", "")
        # own-write echo suppression: a non-DELETE event that is the echo
        # of one of our writes re-arms nothing — the pass that wrote it
        # already reconciled against exactly that state, and bring-up's
        # write storm would otherwise slide every debounce window to its
        # aging cap.  Two detectors (state/delta.py): the rv ledger for
        # echoes arriving after the write response, the in-flight marker
        # for echoes that outrace it.  CR kinds are exempt: their echoes
        # drive key lifecycle and the workload fleet census.
        if verb != "DELETED" and kind not in ("TPUDriver", "TPUWorkload") \
                and (state_delta.is_own_write_echo(obj)
                     or state_delta.is_own_write_inflight(obj)):
            # the echo still IS the freshest view: record its signature
            # as last-seen, or the next genuine heartbeat would diff
            # against a pre-write signature and read as a real change
            name = obj.get("metadata", {}).get("name", "")
            seen = None
            with self._sched_lock:
                if kind == "Node":
                    seen = self._node_sigs.get(name)
                    self._node_sigs[name] = self._node_sig(obj)
                elif kind == "DaemonSet":
                    ns = obj.get("metadata", {}).get("namespace", "")
                    self._ds_sigs[(ns, name)] = self._ds_sig(obj)
            if seen is not None and seen[2].get("unschedulable") \
                    and not obj.get("spec", {}).get("unschedulable"):
                self._wake_gangs(verb, obj)
            return
        if kind == "DaemonSet" and not self._route_daemonset(verb, obj):
            return
        # the invalidation map: a DaemonSet event can only affect the one
        # desired object it names, so its wake carries a targeted hint
        # (DELETED included — the delta pass re-creates it from the memo's
        # decorated cache).  Every other kind reshapes the desired SET
        # itself (nodes change pools, CR spec changes re-render), so its
        # hint is None and the union degrades the pass to full.
        hint = None
        if kind == "DaemonSet":
            hint = state_delta.DeltaHint.targeted(
                {state_delta.daemonset_target(obj)},
                reason=f"ds-{verb.lower()}")
        woke = False
        with self._sched_lock:
            if kind == "Node":
                # filter heartbeats (reference predicate:
                # clusterpolicy_controller.go:284-342 wakes on label/spec
                # changes only) — without this, node-status updates keep
                # every deadline at zero and the operator reconciles
                # continuously at the tick-rate cap
                name = obj.get("metadata", {}).get("name", "")
                if verb == "DELETED":
                    self._node_sigs.pop(name, None)
                else:
                    sig = self._node_sig(obj)
                    if self._node_sigs.get(name) == sig:
                        return
                    self._node_sigs[name] = sig
        if kind == "TPUDriver":
            # per-CR key lifecycle rides the CR's own watch events:
            # created on first sight (born due), retired on deletion —
            # the discovery key is also woken on DELETE so stale operand
            # cleanup still happens under the coarse key's schedule
            key = DRIVER_KEY_PREFIX + obj.get("metadata", {}).get("name", "")
            if verb == "DELETED":
                with self._sched_lock:
                    busy = key in self._inflight
                if not busy:   # an in-flight key retires at discovery
                    self.queue.remove_key(key)
                    # the reconciler's cross-pass memos go with the key
                    self.driver_rec.forget(
                        obj.get("metadata", {}).get("name", ""))
                self.queue.mark_due("driver",
                                    stamp=obs.watch_stamp(verb, obj))
            else:
                self.queue.add_key(key)
                self.queue.mark_due(key, stamp=obs.watch_stamp(verb, obj))
            self._wake_set()
            return
        if kind == "TPUWorkload":
            # same per-CR key lifecycle as TPUDriver, with the namespace
            # folded into the key (TPUWorkloads are namespaced)
            md = obj.get("metadata", {})
            key = workload_key(md.get("namespace", ""), md.get("name", ""))
            if verb == "DELETED":
                with self._sched_lock:
                    busy = key in self._inflight
                if not busy:
                    self.queue.remove_key(key)
                    self.workload_rec.forget(md.get("name", ""),
                                             md.get("namespace", ""))
                self.queue.mark_due("workload",
                                    stamp=obs.watch_stamp(verb, obj))
            else:
                self.queue.add_key(key)
                self.queue.mark_due(key, stamp=obs.watch_stamp(verb, obj))
                # the discovery pass also owns the fleet phase census;
                # a phase flip (the CR's own status write echoing back)
                # must refresh it — pure cache arithmetic, still
                # event-driven, so the steady-state bounds hold
                self.queue.mark_due("workload",
                                    stamp=obs.watch_stamp(verb, obj))
            self._wake_set()
            return
        for rec in _WAKE_KINDS:
            if _wake_wanted(rec, kind, obj):
                # stamp the wake with its originating event: the stamp's
                # timestamps feed the queue-wait span and the convergence
                # histogram, and its trace id (allocated per woken
                # reconciler, only while tracing is on) becomes the
                # reconcile pass's trace
                if rec == "driver":
                    keys = self._driver_wake_keys(kind, obj)
                elif rec == "remediation":
                    keys = self._remediation_wake_keys(kind, obj)
                elif rec == "workload":
                    keys = self._workload_wake_keys(kind, obj)
                else:
                    keys = (rec,)
                for key in keys:
                    # mark_due no-ops (False) on a key retired since the
                    # keys() snapshot — a deleted CR must stay deleted
                    woke |= self.queue.mark_due(
                        key, stamp=obs.watch_stamp(verb, obj), hint=hint)
        if woke:
            if hint is not None and not hint.full:
                self._kick_prerender()
            self._wake_set()

    def _wake_gangs(self, verb: str, obj: dict) -> None:
        """The echo of our own uncordon (the remediation or upgrade key
        made a Node schedulable again) still wakes the workload keys: the
        key that wrote it reconciled against it, but a gang held off the
        node would otherwise wait out its hold requeue
        (``REQUEUE_HOLD_SECONDS``).  A cordon's echo wakes nothing, as
        every other own write's: the drain moves a bound gang."""
        woke = False
        for key in self._workload_wake_keys("Node", obj):
            woke |= self.queue.mark_due(key, stamp=obs.watch_stamp(verb, obj))
        if woke:
            self._wake_set()

    def _on_relist(self, kind: str) -> None:
        """A relist replaced the cache wholesale: changes may have landed
        that no watch event attributed to an object, so every key's next
        pass must be FULL — the delta engine's unattributable-change
        fallback.  mark_due with no hint unions any pending targeted
        invalidation up to a full pass."""
        q = getattr(self, "queue", None)
        if q is None:
            return   # boot-seed relist: queue not constructed yet
        woke = False
        for key in q.keys():
            woke |= q.mark_due(key)
        if woke:
            self._wake_set()

    def _driver_wake_keys(self, kind: str, obj: dict):
        """Which driver-family keys a non-TPUDriver event wakes: a
        DaemonSet owned by one CR (its state label names it) wakes that
        CR's key alone; kind-wide events (Node/TPUPolicy) wake every
        per-CR key; anything whose owning CR is unknown falls back to
        the discovery key, which will create the key and requeue."""
        if kind == "DaemonSet":
            state = _state_label(obj)
            if state.startswith(DRIVER_STATE_PREFIX):
                key = DRIVER_KEY_PREFIX + state[len(DRIVER_STATE_PREFIX):]
                if self.queue.has_key(key):
                    return (key,)
            return ("driver",)
        keys = [k for k in self.queue.keys()
                if k.startswith(DRIVER_KEY_PREFIX)]
        keys.append("driver")
        return keys

    def _remediation_wake_keys(self, kind: str, obj: dict):
        """Which remediation keys an event wakes: the singleton sweep
        always (it owns detection and key lifecycle), plus the event's
        OWN node's per-node key when one exists — a Node event names
        itself, a validator/driver Pod event names the node it runs on
        (its readiness flip is exactly what a Revalidating node waits
        for).  Keys are only CREATED by the sweep; mark_due on a key
        that does not exist is a no-op."""
        keys = ["remediation"]
        name = ""
        if kind == "Node":
            name = obj.get("metadata", {}).get("name", "")
        elif kind == "Pod":
            name = obj.get("spec", {}).get("nodeName", "")
        if name and self.queue.has_key(REMEDIATION_KEY_PREFIX + name):
            keys.append(REMEDIATION_KEY_PREFIX + name)
        return keys

    def _workload_wake_keys(self, kind: str, obj: dict):
        """Which workload keys an event wakes: a gang pod names its
        owner (the workload label), so its events wake exactly that key;
        Node events wake every workload key (a fleet change can unblock
        any held placement or doom any bound gang) plus the discovery
        key.  Keys are only created by the CR watch/discovery; mark_due
        on a missing key is a no-op."""
        if kind == "Pod":
            md = obj.get("metadata", {})
            owner = md.get("labels", {}).get(consts.WORKLOAD_NAME_LABEL, "")
            key = workload_key(md.get("namespace", ""), owner)
            if owner and self.queue.has_key(key):
                return (key,)
            return ("workload",)
        keys = [k for k in self.queue.keys()
                if k.startswith(WORKLOAD_KEY_PREFIX)]
        keys.append("workload")
        return keys

    def _finish(self, rec: str, gen: int, res, now: float,
                default_requeue: float,
                stamp: Optional[obs.WatchStamp] = None) -> None:
        """Record a reconcile outcome in the queue: success commits the
        requeue deadline (unless an event landed mid-reconcile) and
        resets the key's backoff; failure requeues with per-key
        exponential backoff so an erroring reconciler cannot hot-loop —
        keeping its event stamp, so the retry stays attributed.

        A pass that registered readiness waits gets its short NotReady
        requeue DEMOTED to the long backstop: the watch event that flips
        a waited-on workload ready wakes the key instantly, and the
        timer only exists to survive a missed event."""
        fo = self._failover
        if fo is not None:
            # convergence-after-takeover needs at least one reconcile to
            # have actually run under the new leader (GIL-atomic bump;
            # the journaler only needs >= 1)
            fo["passes"] = fo.get("passes", 0) + 1
        if res is not None and res.error:
            self.queue.set_waits(rec, ())
            self.queue.retry(rec, gen, now, stamp=stamp)
            return
        self.queue.forget(rec)
        requeue = (res.requeue_after if res is not None
                   and res.requeue_after else default_requeue)
        waits = getattr(res, "waits", None) if res is not None else None
        if waits:
            self.queue.set_waits(rec, waits)
            operator_metrics.readiness_triggers_armed_total.inc()
            requeue = max(requeue, READINESS_BACKSTOP_S)
        else:
            self.queue.set_waits(rec, ())
        self.queue.commit(rec, gen, now + requeue)

    def _park_if_partitioned(self) -> None:
        """A leader whose Lease renewal failed on the wire (it still holds
        the Lease: only a refused write or a peer's hold takes it away)
        stands by without acting, as a lost leader does; past the
        degraded budget it is in serve-stale degraded mode, and each due
        key is parked with its journaled hold, as the dispatch loop parks
        it when the main client's breaker is the one open."""
        if not self.elector.is_leader or not self.degraded.poll():
            return
        for key in self.queue.due(time.monotonic()):
            self.degraded.park(key)

    def _note_leadership(self) -> None:
        """Arm the failover journal: the elector just acquired the lease
        FROM another holder (crash takeover or graceful release).  One
        ``failover`` entry is journaled when the queue first quiesces
        after this (:meth:`_maybe_journal_failover`), carrying the
        leadership-lost→converged timing."""
        e = self.elector
        if e is None or e.took_over_from is None:
            return
        self._failover = {"from": e.took_over_from,
                          "lost_at": e.leadership_lost_at,
                          "acquired_at": time.time(),
                          "passes": 0}
        e.took_over_from = None
        e.leadership_lost_at = 0.0

    def _maybe_journal_failover(self, now: float) -> None:
        """After a takeover, journal exactly ONE ``failover`` entry the
        moment the queue quiesces — no due keys, nothing in flight, and
        at least one reconcile finished under the new leader.  The
        timing splits (lost→acquired, acquired→converged) are what the
        chaos tier and the bench failover leg pin."""
        fo = self._failover
        if fo is None or fo.get("passes", 0) < 1:
            return
        if self.queue.due(now):
            return
        with self._sched_lock:
            if self._inflight:
                return
        self._failover = None
        converged = time.time()
        lost = fo["lost_at"] or fo["acquired_at"]
        obs_journal.record(
            "operator", self.namespace, "leader",
            category="failover", verdict="converged",
            reason=f"took over leadership from {fo['from']} "
                   "and reconverged",
            inputs={
                "from": fo["from"],
                "lost_to_acquired_s": round(
                    max(0.0, fo["acquired_at"] - lost), 3),
                "acquired_to_converged_s": round(
                    max(0.0, converged - fo["acquired_at"]), 3),
                "lost_to_converged_s": round(
                    max(0.0, converged - lost), 3),
                "restored_kinds": sorted(self.snapshotter.restored_kinds),
            })

    def step(self, now: Optional[float] = None) -> None:
        """One scheduler pass (exposed for tests): dispatch every due key
        onto the worker pool and wait for all of them — by return, every
        reconcile this pass started has finished and recorded its requeue
        deadline (the barrier the synchronous-``step()`` tests rely on).

        Dispatch runs in WAVES because a driver discovery pass may
        CREATE per-CR keys mid-step (born due): the serial scheduler
        reconciled every CR in one pass, so newly-born keys run in this
        same step.  A key kept due by a mid-flight event still runs at
        most once per step (``ran``), exactly like the serial scheduler.
        With ``max_concurrent_reconciles=1`` keys run inline in due
        order and the first raise aborts the pass — the serial
        semantics, on the caller's own thread."""
        now = time.monotonic() if now is None else now
        self.queue.due(now)   # refresh the depth gauge
        degraded = self.degraded.poll()
        serial = self.max_concurrent_reconciles <= 1
        ran: set = set()
        for _ in range(8):    # defensive wave bound (2 suffice today)
            dispatched = []
            claimed = 0
            for key in [k for k in self.queue.due(now) if k not in ran]:
                if degraded:
                    # serving-stale: park with a journaled hold — the
                    # key stays due, so recovery drains it relist-free
                    self.degraded.park(key)
                    continue
                with self._sched_lock:
                    if key in self._inflight:
                        continue   # never overlap a key with itself
                    self._inflight.add(key)
                claimed += 1
                ran.add(key)
                if serial:
                    self._run_key(key, now)
                else:
                    dispatched.append(self._pool.submit(
                        lambda k=key: self._run_key(k, now)))
            errors = []
            for task in dispatched:
                try:
                    task.wait()
                except Exception as e:  # noqa: BLE001 - re-raised below
                    errors.append(e)
            if errors:
                # the pool pass surfaces its first failure exactly like
                # the serial pass did (run() logs it; the queue already
                # recorded per-key retry backoff for every failed key)
                raise errors[0]
            if not claimed:
                break
        self._maybe_journal_failover(now)

    def _run_key(self, key: str, now: float) -> None:
        """Execute one due key from SYNC code (``step()``'s serial and
        pooled dispatch): drives the one async body to completion —
        through the client's loop bridge when the transport lives on a
        loop, inline otherwise.  The in-flight reservation made at
        dispatch is released here no matter how the pass exits."""
        try:
            concurrency.run_coro(self._arun_key_body(key, now),
                                 bridge=self.loop_bridge)
        finally:
            with self._sched_lock:
                self._inflight.discard(key)

    async def _arun_key_body(self, key: str, now: float) -> None:
        """One due key as a coroutine — the single implementation both
        schedulers share.  Reconciler bodies are awaited NATIVELY on the
        loop (no ``to_thread`` hop, no offload-executor pressure): their
        client I/O suspends, their CPU runs on the loop with cooperative
        yields (state/skel.py), and the queue bookkeeping around them is
        pure memory."""
        task = self._prerender_tasks.pop(key, None)
        if task is not None:
            # per-key serialization: the speculative pre-render must land
            # (or fail) before the pass that would consume its warm cache
            try:
                await task
            except Exception:
                pass   # a failed speculation costs nothing — cold render
        if key == "policy":
            await self._arun_policy(now)
        elif key == "driver":
            await self._arun_driver_discovery(now)
        elif key == "upgrade":
            await self._arun_upgrade(now)
        elif key == "remediation":
            await self._arun_remediation_sweep(now)
        elif key == "workload":
            await self._arun_workload_discovery(now)
        elif key == "telemetry":
            await self._arun_telemetry(now)
        elif key.startswith(DRIVER_KEY_PREFIX):
            await self._arun_driver_cr(key, now)
        elif key.startswith(REMEDIATION_KEY_PREFIX):
            await self._arun_remediation_node(key, now)
        elif key.startswith(WORKLOAD_KEY_PREFIX):
            await self._arun_workload_cr(key, now)
        else:               # unknown dynamic key (test-injected)
            self.queue.pop(key)
            self.queue.remove_key(key)

    async def _abody(self, rec, sync_name: str, async_name: str, *args):
        """Invoke one reconciler body: the INSTANCE-patched sync method
        when a test stubbed one (``runner.policy_rec.reconcile = ...``
        — the long-standing instrumentation seam), else the native
        coroutine.  Real bodies always take the coroutine path.  A sync
        override running ON the loop is offloaded — it may wrap the
        real sync ``reconcile()``, whose bridge hop would self-deadlock
        from the loop thread."""
        override = rec.__dict__.get(sync_name)
        if override is not None:
            if self.loop_bridge is not None \
                    and self.loop_bridge.on_loop_thread():
                return await concurrency.offload(override, *args)
            return override(*args)
        return await getattr(rec, async_name)(*args)

    async def _arun_policy(self, now: float) -> None:
        g, stamp = self.queue.pop_stamped("policy")
        self.policy_rec.offer_delta(self.queue.pop_hint("policy"))
        with _ReconcileObs("policy", stamp) as o:
            try:
                res = await self._abody(self.policy_rec, "reconcile",
                                        "areconcile")
            except Exception:
                self.queue.retry("policy", g, now, stamp=stamp)
                raise
            o.done(res)
        self._note_delta("policy",
                         getattr(self.policy_rec.state_manager,
                                 "last_pass_delta", None))
        self._finish("policy", g, res, now, 30.0, stamp=stamp)

    @staticmethod
    def _note_delta(key: str, d) -> None:
        """Record the pass's invalidation summary (objects selected vs
        re-diffed vs written) for the CI failure-dump artifact."""
        if not d:
            return
        state_delta.note_pass(
            key, mode=d.get("mode", "full"),
            selected=d.get("selected", 0), rediffed=d.get("rediffed", 0),
            written=d.get("written", 0), full_set=d.get("full_set", 0))

    async def _arun_upgrade(self, now: float) -> None:
        g, stamp = self.queue.pop_stamped("upgrade")
        self.upgrade_rec.offer_delta(self.queue.pop_hint("upgrade"))
        with _ReconcileObs("upgrade", stamp) as o:
            try:
                res = await self._abody(self.upgrade_rec, "reconcile",
                                        "areconcile")
            except Exception:
                self.queue.retry("upgrade", g, now, stamp=stamp)
                raise
            o.done(res)
        self._finish("upgrade", g, res, now, 120.0, stamp=stamp)

    async def _arun_remediation_sweep(self, now: float) -> None:
        """The singleton ``remediation`` key: classify the fleet, accrue
        goodput, and reconcile the per-node KEY SET against the set of
        nodes needing remediation — keys are created on first sight of a
        degradation signal (born due, so this same step's next wave runs
        them) and retired once their node is healthy again (or gone).
        The per-node machines run under their own keys with their own
        backoff."""
        g, stamp = self.queue.pop_stamped("remediation")
        try:
            tracked = await self._abody(self.remediation_rec, "sweep",
                                        "asweep")
        except Exception:
            self.queue.retry("remediation", g, now, stamp=stamp)
            raise
        woke = False
        for key in self.queue.keys():
            if not key.startswith(REMEDIATION_KEY_PREFIX):
                continue
            if key[len(REMEDIATION_KEY_PREFIX):] not in tracked:
                with self._sched_lock:
                    busy = key in self._inflight
                if not busy:   # an in-flight key retires next sweep
                    self.queue.remove_key(key)
        for name in sorted(tracked):
            if self.queue.add_key(REMEDIATION_KEY_PREFIX + name):
                self.queue.mark_due(REMEDIATION_KEY_PREFIX + name,
                                    stamp=stamp)
                woke = True
        if woke:
            self._wake_set()
        self.queue.forget("remediation")
        # the sweep doubles as the goodput-accrual cadence; detection
        # itself is event-driven (Node watch events mark this key due)
        self.queue.commit("remediation", g, now + 30.0)

    async def _arun_remediation_node(self, key: str, now: float) -> None:
        """One node's remediation machine under its own queue key."""
        name = key[len(REMEDIATION_KEY_PREFIX):]
        g, stamp = self.queue.pop_stamped(key)
        with _ReconcileObs("remediation", stamp, key=key) as o:
            try:
                res = await self._abody(self.remediation_rec,
                                        "reconcile_node",
                                        "areconcile_node", name)
            except Exception:
                self.queue.retry(key, g, now, stamp=stamp)
                raise
            o.done(res)
        self._finish(key, g, res, now, 30.0, stamp=stamp)

    async def _arun_telemetry(self, now: float) -> None:
        """The singleton ``telemetry`` key: sample the fleet SLIs into
        the tsdb and evaluate the declared SLOs (obs/slo.py).  With the
        store disabled this body is ONE boolean check and a long
        requeue — zero samples, zero reads, zero threads, the shared
        no-op the scale tier pins.  Enabled, it reads ONLY the informer
        cache and in-memory metrics: a telemetry sweep never costs an
        apiserver op, so the zero-LIST/zero-write steady bounds hold
        with the engine on."""
        g, stamp = self.queue.pop_stamped("telemetry")
        if not obs_tsdb.is_enabled():
            self.queue.forget("telemetry")
            self.queue.commit(
                "telemetry", g, now + max(self.slo_eval_interval_s, 60.0))
            return
        try:
            self._sample_slis(now)
            obs_slo.evaluate(self._slo_specs(), now=now)
        except Exception:
            self.queue.retry("telemetry", g, now, stamp=stamp)
            raise
        self.queue.forget("telemetry")
        self.queue.commit("telemetry", g, now + self.slo_eval_interval_s)

    def _slo_specs(self) -> list:
        """``spec.slos`` of the cached TPUPolicy, as raw wire dicts —
        the engine's own parser owns validation (fail-closed holds)."""
        for pol in self.reader.list("TPUPolicy"):
            slos = (pol.get("spec") or {}).get("slos")
            if slos:
                return slos if isinstance(slos, list) else []
        return []

    def _sample_slis(self, now: float) -> None:
        """One sweep's SLI samples into the tsdb — informer cache and
        in-memory metrics ONLY.  The goodput ratio itself is fed at its
        source (remediation/goodput.py observes into the tsdb on every
        classification pass); everything here derives series the
        operator computes but never kept history for."""
        from ..workload import metrics as workload_metrics
        observe = obs_tsdb.observe
        # fleet badput: per-category per-second rates, the delta of the
        # journal's accrual integrals between sweeps
        totals = obs_journal.badput_totals()
        if self._badput_prev_t is not None:
            dt = now - self._badput_prev_t
            if dt > 0:
                for cat in set(totals) | set(self._badput_prev):
                    delta = (totals.get(cat, 0.0)
                             - self._badput_prev.get(cat, 0.0))
                    observe("badput_rate", max(0.0, delta / dt),
                            labels={"category": cat}, now=now)
        self._badput_prev, self._badput_prev_t = totals, now
        # latency distribution summaries from the histograms the
        # operator already exports
        p95 = _hist_quantile(
            workload_metrics.workload_submit_to_running_seconds, 0.95)
        if p95 is not None:
            observe("submit_to_running_p95", p95, now=now)
        p95 = _hist_quantile(
            operator_metrics.convergence_latency_seconds, 0.95)
        if p95 is not None:
            observe("convergence_p95", p95, now=now)
        # transport + event-loop health
        fresh = client_metrics.watch_freshness()
        if fresh:
            observe("watch_freshness_max", max(fresh.values()), now=now)
        lag = 0.0
        for info in obs_aioprof.snapshot()["loops"].values():
            lag = max(lag, float(info["lag"]["max_s"]))
        observe("loop_lag_max", lag, now=now)
        observe("breaker_open",
                1.0 if self.degraded._breaker_open() else 0.0, now=now)
        observe("degraded_mode",
                1.0 if self.degraded.active else 0.0, now=now)
        # per-node healthwatch/kubelet signals through the informer
        # cache: ici-degraded annotations + Ready heartbeat age
        ici_nodes = 0
        jitter = 0.0
        for node in self.reader.list("Node"):
            meta = node.get("metadata") or {}
            name = meta.get("name", "")
            ann = meta.get("annotations") or {}
            flag = 1.0 if ann.get(consts.ICI_DEGRADED_ANNOTATION) else 0.0
            ici_nodes += int(flag)
            observe("node_ici_degraded", flag,
                    labels={"node": name}, now=now)
            for cond in (node.get("status") or {}).get(
                    "conditions") or []:
                if cond.get("type") == "Ready":
                    hb = parse_micro_time(cond.get("lastHeartbeatTime"))
                    if hb > 0:
                        jitter = max(jitter, max(0.0, now - hb))
                    break
        observe("ici_degraded_nodes", float(ici_nodes), now=now)
        observe("heartbeat_jitter_max", jitter, now=now)

    async def _arun_driver_discovery(self, now: float) -> None:
        """The bare ``driver`` key: reconcile the KEY SET against the CR
        set — per-CR keys are created on first sight (born due, so the
        current step's next wave runs them) and retired once their CR is
        gone.  The actual per-CR reconciles run under their own keys
        with their own generations, stamps and backoff."""
        g, stamp = self.queue.pop_stamped("driver")
        try:
            names = {cr["metadata"]["name"]
                     for cr in await self.areader.list("TPUDriver")}
        except Exception:
            self.queue.retry("driver", g, now, stamp=stamp)
            raise
        for key in self.queue.keys():
            if not key.startswith(DRIVER_KEY_PREFIX):
                continue
            if key[len(DRIVER_KEY_PREFIX):] not in names:
                with self._sched_lock:
                    busy = key in self._inflight
                # a CR created between the list above and this sweep has
                # a key (the watch fan-out added it) but no entry in the
                # stale `names` snapshot — re-check the live cache so
                # the sweep can never retire a newborn key and swallow
                # its creation wake
                if not busy and await self.areader.get_or_none(
                        "TPUDriver", key[len(DRIVER_KEY_PREFIX):]) is None:
                    self.queue.remove_key(key)
                    self.driver_rec.forget(key[len(DRIVER_KEY_PREFIX):])
        woke = False
        for name in sorted(names):
            if self.queue.add_key(DRIVER_KEY_PREFIX + name):
                # first sight outside the watch path (booted into a
                # populated cluster): hand the key the discovery wake's
                # stamp so the pass it triggers keeps its attribution
                self.queue.mark_due(DRIVER_KEY_PREFIX + name, stamp=stamp)
                woke = True
        if woke:
            self._wake_set()
        self.queue.forget("driver")
        self.queue.commit("driver", g, now + 30.0)

    async def _arun_workload_discovery(self, now: float) -> None:
        """The bare ``workload`` key: reconcile the KEY SET against the
        TPUWorkload CR set (create on first sight, retire on deletion —
        the TPUDriver discovery pattern, namespaced) and refresh the
        fleet phase gauges.  The actual gang reconciles run under their
        own per-CR keys with their own backoff."""
        g, stamp = self.queue.pop_stamped("workload")
        try:
            crs = await self.areader.list("TPUWorkload")
        except Exception:
            self.queue.retry("workload", g, now, stamp=stamp)
            raise
        await self.workload_rec.aobserve_fleet(crs)
        coords = {(cr["metadata"].get("namespace", ""),
                   cr["metadata"]["name"]) for cr in crs}
        for key in self.queue.keys():
            if not key.startswith(WORKLOAD_KEY_PREFIX):
                continue
            ns, _, name = key[len(WORKLOAD_KEY_PREFIX):].partition("/")
            if (ns, name) in coords:
                continue
            with self._sched_lock:
                busy = key in self._inflight
            # re-check the live cache before retiring: a CR created
            # between the list above and this sweep must keep its key
            if not busy and await self.areader.get_or_none(
                    "TPUWorkload", name, ns) is None:
                self.queue.remove_key(key)
                self.workload_rec.forget(name, ns)
        woke = False
        for ns, name in sorted(coords):
            if self.queue.add_key(workload_key(ns, name)):
                self.queue.mark_due(workload_key(ns, name), stamp=stamp)
                woke = True
        if woke:
            self._wake_set()
        self.queue.forget("workload")
        self.queue.commit("workload", g, now + 60.0)

    async def _arun_workload_cr(self, key: str, now: float) -> None:
        """One TPUWorkload's gang reconcile under its own queue key."""
        ns, _, name = key[len(WORKLOAD_KEY_PREFIX):].partition("/")
        g, stamp = self.queue.pop_stamped(key)
        if await self.areader.get_or_none("TPUWorkload", name, ns) is None:
            # deleted between wake and run: retire the key quietly —
            # including the per-CR memos, or a recreated namesake would
            # inherit a stale StatusWriter memo and the workload_ready
            # gauge would export its last value forever (the discovery
            # sweep only forgets keys it can still see)
            self.queue.remove_key(key)
            self.workload_rec.forget(name, ns)
            return
        with _ReconcileObs("workload", stamp, key=key) as o:
            try:
                res = await self._abody(self.workload_rec, "reconcile",
                                        "areconcile", name, ns)
            except Exception:
                self.queue.retry(key, g, now, stamp=stamp)
                raise
            o.done(res)
        self._finish(key, g, res, now, 60.0, stamp=stamp)

    async def _arun_driver_cr(self, key: str, now: float) -> None:
        """One TPUDriver CR's reconcile under its own queue key
        (nvidiadriver_controller.go pattern, one pass per CR)."""
        name = key[len(DRIVER_KEY_PREFIX):]
        g, stamp = self.queue.pop_stamped(key)
        hint = self.queue.pop_hint(key)
        if await self.areader.get_or_none("TPUDriver", name) is None:
            # deleted between wake and run: retire the key quietly
            self.queue.remove_key(key)
            return
        with _ReconcileObs("driver", stamp, key=key) as o:
            try:
                # offered with no await before the body starts: the
                # reconciler instance is shared across per-CR keys, so an
                # interleaved offer from another key's coroutine would
                # cross-wire hints
                self.driver_rec.offer_delta(hint)
                res = await self._abody(self.driver_rec, "reconcile",
                                        "areconcile", name)
            except Exception:
                self.queue.retry(key, g, now, stamp=stamp)
                raise
            o.done(res)
        self._note_delta(key, getattr(self.driver_rec,
                                      "last_pass_delta", None))
        self._finish(key, g, res, now, 30.0, stamp=stamp)

    def run(self, tick_s: float = 1.0) -> None:
        """Drive the scheduler until :meth:`request_stop`.

        With an async-capable client (``loop_bridge`` present) and a
        concurrency bound above 1, scheduling moves ONTO the client's
        event loop (:meth:`_arun_loop`): due keys dispatch as asyncio
        tasks under a semaphore, watch delivery / dispatch / client I/O
        all multiplex on one loop, and there is no end-of-wave barrier —
        a key becoming due never waits for an unrelated slow key to
        finish.  ``max_concurrent_reconciles=1`` or a plain sync client
        keeps the original thread scheduler (byte-identical serial
        semantics, and the fakes need no loop)."""
        try:
            # periodic informer snapshots ride their own daemon thread
            # (a no-op without --snapshot-dir): never on the reconcile
            # hot path, stopped by the same stop event as everything
            self.snapshotter.start(self.stop)
            if self.loop_bridge is not None \
                    and self.max_concurrent_reconciles > 1:
                self.loop_bridge.run(self._arun_loop(tick_s))
            else:
                self._run_loop(tick_s)
        finally:
            if self._graceful:
                # graceful handoff (request_stop/SIGTERM only — a hard
                # kill never gets here): flush the freshest snapshot so
                # the successor restores today's caches with zero seed
                # LISTs, then release the lease so a standby promotes
                # NOW instead of waiting out the lease duration
                self.snapshotter.flush()
                if self.elector is not None and self.elector.is_leader:
                    self.elector.release()
            # drain the worker pools on every exit path: queued work
            # finishes, worker threads exit and are joined — request_stop()
            # leaves no leaked workers behind (the policy reconciler's
            # writer pool is lazy, so it may not exist)
            self._pool.shutdown(wait=True, timeout=5.0)
            writer = getattr(self.policy_rec, "_writer_pool", None)
            if writer is not None:
                writer.shutdown(wait=True, timeout=5.0)

    def _run_loop(self, tick_s: float) -> None:
        while not self.stop.is_set():
            if self.elector is not None and not self.elector.try_acquire():
                log.debug("not leader; standing by")
                self._park_if_partitioned()
                self.stop.wait(LEASE_DURATION_S / 3)
                continue
            self._note_leadership()
            # staleness backstop: a watch stream broken in a way the
            # client cannot see must not let the cache serve an
            # unbounded-staleness view — kinds quiet past the resync
            # period get one bounding relist (informer/cache.py)
            try:
                self.informer.maybe_resync()
            except Exception:  # noqa: BLE001 - resync is best-effort
                log.exception("informer resync failed")
            try:
                self.step()
            except Exception:  # noqa: BLE001 - the loop must survive
                log.exception("reconcile pass failed")
            # debounce floor first (stop-interruptible), THEN wait for a
            # watch event: continuous cluster churn (pod status
            # transitions, DS counter bumps) therefore caps reconciles at
            # 1/tick_s instead of running back-to-back — the reference's
            # workqueue rate limit is 100 ms–3 s
            # (clusterpolicy_controller.go:51-52)
            self.stop.wait(tick_s)
            self._wake.wait(tick_s)
            self._wake.clear()

    # ------------------------------------------------- async dispatch
    async def _arun_key(self, key: str, now: float,
                        sem: asyncio.Semaphore) -> None:
        """One due key as an asyncio task: bounded by the semaphore
        (``--max-concurrent-reconciles``), the reconciler body awaited
        NATIVELY on this loop — no ``to_thread`` hop, no
        offload-executor pressure (reconcile passes interleave at their
        awaits and cooperative yields instead of contending as threads).
        Per-key serialization was already reserved at dispatch via
        ``_inflight``; released on every exit."""
        async with sem:
            try:
                await self._arun_key_body(key, now)
            except Exception:  # noqa: BLE001 - the loop must survive
                log.exception("reconcile pass failed (key=%s)", key)
            finally:
                with self._sched_lock:
                    self._inflight.discard(key)
                if self.queue.debounce_s > 0.0 and self._awake is not None:
                    # wake-batching has no tick floor: a key kept due by
                    # a mid-pass gen bump (or just released from its
                    # in-flight hold) must re-enter the dispatch scan now
                    self._awake.set()

    async def _arun_loop(self, tick_s: float) -> None:
        """The event-loop scheduler: the thread scheduler's semantics —
        leader election, resync backstop, due-key dispatch, debounce
        floor, event wake — rebuilt as one coroutine on the client's
        loop.  Two deliberate differences from ``_run_loop``/``step()``:
        dispatch is CONTINUOUS (no end-of-pass barrier, so a slow
        reconcile never holds back an unrelated due key), and the
        blocking sleeps are ``asyncio`` waits so watch coroutines keep
        streaming between dispatches."""
        self._awake = asyncio.Event()
        astop = self._astop = asyncio.Event()
        sem = asyncio.Semaphore(self.max_concurrent_reconciles)
        tasks: set = set()
        started_mono = time.monotonic()

        async def _stoppable_sleep(seconds: float) -> None:
            # the async twin of `self.stop.wait(seconds)`: request_stop
            # sets `astop` through the bridge, so shutdown never waits
            # out a standby or debounce period
            try:
                await asyncio.wait_for(astop.wait(), timeout=seconds)
            except asyncio.TimeoutError:
                pass

        try:
            while not self.stop.is_set():
                if self.elector is not None \
                        and not await concurrency.offload(
                            self.elector.try_acquire):
                    # the elector's lease I/O rides the SYNC facade
                    # (shared with cmd tools): offload it through the
                    # sanctioned helper so it can never block the loop
                    log.debug("not leader; standing by")
                    self._park_if_partitioned()
                    await _stoppable_sleep(LEASE_DURATION_S / 3)
                    continue
                self._note_leadership()
                # staleness backstop: the CHECK is pure memory (zero
                # offloads on the steady path); only a genuinely stale
                # kind pays the offloaded relist.  Kinds that have NEVER
                # synced read as infinitely stale, but at boot their
                # watch coroutines are already seeding them (on_sync) —
                # relisting would duplicate the seed LIST per kind, so
                # never-synced kinds only trigger the backstop once a
                # full resync period has passed since startup (a watch
                # rejected forever still gets repaired).
                stale = self.informer.stale_kinds(
                    SharedInformerCache.RESYNC_PERIOD_S)
                grace_over = (time.monotonic() - started_mono
                              > SharedInformerCache.RESYNC_PERIOD_S)
                if any(age != float("inf") or grace_over
                       for _, age in stale):
                    try:
                        await concurrency.offload(
                            self.informer.maybe_resync)
                    except Exception:  # noqa: BLE001 - best-effort
                        log.exception("informer resync failed")
                now = time.monotonic()
                degraded = self.degraded.poll()
                for key in self.queue.due(now):
                    if degraded:
                        # serving-stale: park with a journaled hold —
                        # the key stays due, recovery drains relist-free
                        self.degraded.park(key)
                        continue
                    with self._sched_lock:
                        if key in self._inflight:
                            continue   # never overlap a key with itself
                        self._inflight.add(key)
                    # spawn through the sanctioned helper: the task is
                    # named for the census/sampler ("reconcile-<key>"),
                    # so a profiled cold pass attributes loop time to
                    # the keys that spent it
                    t = obs_aioprof.spawn(
                        self._arun_key(key, now, sem),
                        name=f"reconcile-{key}", family="reconcile")
                    tasks.add(t)
                    t.add_done_callback(tasks.discard)
                self._maybe_journal_failover(time.monotonic())
                if self.queue.debounce_s > 0.0:
                    # wake-batching mode: no fixed tick floor — sleep
                    # exactly until the earliest debounce deadline (or a
                    # fresh watch event re-arms one sooner).  Due-but-held
                    # keys (in-flight, degraded) don't count: next_delay
                    # only sees FUTURE deadlines, and a finishing pass
                    # sets _awake so a gen-kept-due key re-dispatches
                    # without waiting out tick_s.
                    delay = self.queue.next_delay(time.monotonic())
                    timeout = tick_s if delay is None \
                        else min(max(delay, 0.001), tick_s)
                    try:
                        await asyncio.wait_for(self._awake.wait(),
                                               timeout=timeout)
                    except asyncio.TimeoutError:
                        pass
                    self._awake.clear()
                    continue
                # debounce floor first, THEN wait for a watch event —
                # the same churn cap as the thread scheduler (at most
                # one dispatch scan per tick under continuous events)
                await _stoppable_sleep(tick_s)
                if self.stop.is_set():
                    break
                try:
                    await asyncio.wait_for(self._awake.wait(),
                                           timeout=tick_s)
                except asyncio.TimeoutError:
                    pass
                self._awake.clear()
        finally:
            self._awake = None
            self._astop = None
            if tasks:
                # drain in-flight reconciles so shutdown leaks no tasks
                await asyncio.gather(*tasks, return_exceptions=True)


def _env_int(name: str, default: int) -> int:
    """Env-backed int flag default: junk degrades to the default with a
    warning, like every other env-backed flag — never a raw traceback
    before argument parsing even starts."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        log.warning("%s=%r unparseable; using %d", name, raw, default)
        return default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        log.warning("%s=%r unparseable; using %g", name, raw, default)
        return default


def main(argv=None, client: Optional[Client] = None) -> int:
    p = argparse.ArgumentParser(prog="tpu-operator")
    p.add_argument("--metrics-port", type=int, default=8080)
    p.add_argument("--health-port", type=int, default=8081)
    p.add_argument("--log-level", default="info")
    p.add_argument("--log-format", choices=("text", "json"),
                   default=os.environ.get("OPERATOR_LOG_FORMAT", "text"),
                   help="json emits one object per line with trace_id/"
                        "span_id/controller correlation fields "
                        "(obs/logging.py)")
    p.add_argument("--trace-buffer", type=int,
                   default=_env_int("OPERATOR_TRACE_BUFFER", 256),
                   help="reconcile-trace ring-buffer capacity served at "
                        "/debug/traces; 0 disables tracing entirely "
                        "(every span becomes a shared no-op)")
    p.add_argument("--journal-buffer", type=int,
                   default=_env_int("OPERATOR_JOURNAL_BUFFER", 64),
                   help="decision-journal ring size per object (entries "
                        "kept per CR/node/slice), served at "
                        "/debug/explain/<kind>/<ns>/<name> and rendered "
                        "by tpu-status explain; also enables badput "
                        "attribution. 0 disables journaling entirely "
                        "(every record becomes a shared no-op)")
    p.add_argument("--profile-hz", type=int,
                   default=_env_int("OPERATOR_PROFILE_HZ", 0),
                   help="sampling flight-recorder rate in Hz (0 = off, "
                        "the default): a daemon sampler folds every "
                        "thread's stack into the flamegraph table served "
                        "at /debug/profile and rendered by tpu-status "
                        "--profile; bounded memory, ~free below 100 Hz "
                        "(docs/OBSERVABILITY.md)")
    p.add_argument("--tsdb-retention", type=float,
                   default=_env_float("OPERATOR_TSDB_RETENTION_S",
                                      6 * 3600.0),
                   help="in-memory telemetry retention in seconds "
                        "(obs/tsdb.py): the telemetry sweep samples "
                        "fleet SLIs into bounded per-series rings with "
                        "downsampling tiers, served at /debug/tsdb and "
                        "feeding the SLO engine. 0 disables the store "
                        "AND the SLO engine entirely (shared no-op: "
                        "zero samples, zero threads; default 6h)")
    p.add_argument("--slo-eval-interval", type=float,
                   default=_env_float("OPERATOR_SLO_EVAL_INTERVAL_S",
                                      15.0),
                   help="seconds between telemetry sweeps: each sweep "
                        "samples the SLI series and evaluates "
                        "TPUPolicy spec.slos into error-budget burn "
                        "(obs/slo.py, /debug/slo, tpu-status slo); "
                        "ignored while --tsdb-retention is 0 "
                        "(default 15)")
    p.add_argument("--loop-probe-interval", type=float,
                   default=_env_float("OPERATOR_LOOP_PROBE_INTERVAL",
                                      0.25),
                   help="event-loop lag probe cadence in seconds "
                        "(obs/aioprof.py): a self-scheduling probe per "
                        "client loop measures how late it wakes "
                        "(event_loop_lag_seconds) and feeds the task "
                        "census; 0 disables the probe entirely "
                        "(default 0.25)")
    p.add_argument("--loop-slow-callback-s", type=float,
                   default=_env_float("OPERATOR_LOOP_SLOW_CALLBACK_S",
                                      1.0),
                   help="loop stall threshold in seconds: a probe "
                        "heartbeat older than this means one callback "
                        "is blocking the loop — its stack is captured "
                        "and journaled once per stall "
                        "(tpu-status explain loop/<name>)")
    p.add_argument("--max-concurrent-reconciles", type=int,
                   default=_env_int("OPERATOR_MAX_CONCURRENT_RECONCILES", 4),
                   help="worker-pool size for reconcile execution "
                        "(controller-runtime MaxConcurrentReconciles): "
                        "due keys — policy/upgrade/driver discovery plus "
                        "one key per TPUDriver CR — run concurrently up "
                        "to this bound; a key never overlaps itself. "
                        "1 = the serial scheduler (default 4)")
    p.add_argument("--client-pool-size", type=int,
                   default=_env_int("OPERATOR_CLIENT_POOL_SIZE", 8),
                   help="bounded keep-alive apiserver connection pool on "
                        "the async client core (client/aio.py): writes "
                        "lease a connection exclusively, reads may "
                        "pipeline — size it at or above the write "
                        "fan-out concurrency (default 8)")
    p.add_argument("--max-concurrent-remediations", type=int,
                   default=_env_int("OPERATOR_MAX_CONCURRENT_REMEDIATIONS",
                                    1),
                   help="how many nodes of ONE slice the auto-remediation "
                        "machine may hold out of scheduling at once "
                        "(cordoned/draining/revalidating); further "
                        "degraded members wait their turn (default 1). "
                        "Remediation itself is enabled per-CR via "
                        "spec.remediation (docs/REMEDIATION.md)")
    p.add_argument("--wake-debounce", type=float,
                   default=_env_float("OPERATOR_WAKE_DEBOUNCE_S", 0.02),
                   help="wake-batching window in seconds: a watch event "
                        "arms a key's dispatch deadline this far out, and "
                        "every further event inside the window coalesces "
                        "into the SAME pass (its invalidation hints "
                        "unioned) instead of queueing one pass per event. "
                        "Requires the async scheduler; 0 restores the "
                        "event-wins-next-tick behaviour (default 0.02)")
    p.add_argument("--wake-max-delay", type=float,
                   default=_env_float("OPERATOR_WAKE_MAX_DELAY_S", 0.25),
                   help="starved-key aging bound for wake-batching: under "
                        "a continuous event storm the debounce window "
                        "keeps sliding, but a key always dispatches within "
                        "this many seconds of its FIRST pending event "
                        "(default 0.25; clamped to at least the debounce). "
                        "Own-write echoes never arm the window (the "
                        "delta engine suppresses them), so storms here "
                        "are external by construction")
    p.add_argument("--leader-election", action="store_true")
    p.add_argument("--snapshot-dir",
                   default=os.environ.get("OPERATOR_SNAPSHOT_DIR", ""),
                   help="directory for the crash-safe informer snapshot "
                        "(informer/snapshot.py): the cache + per-kind "
                        "resume resourceVersions are persisted atomically "
                        "every --snapshot-interval and restored on start, "
                        "so a restart resumes its watches with ZERO seed "
                        "LISTs instead of relisting the fleet. Empty "
                        "(the default) disables snapshotting entirely")
    p.add_argument("--snapshot-interval", type=float,
                   default=_env_float("OPERATOR_SNAPSHOT_INTERVAL_S", 30.0),
                   help="seconds between periodic informer snapshots "
                        "(daemon thread, never on the reconcile hot "
                        "path; default 30)")
    p.add_argument("--degraded-budget", type=float,
                   default=_env_float("OPERATOR_DEGRADED_BUDGET_S", 30.0),
                   help="how long the client circuit breaker may stay "
                        "open before the operator flips into explicit "
                        "serve-stale degraded mode: reads answer from "
                        "cache, reconcile dispatch parks with journaled "
                        "holds, and /readyz reports `degraded: "
                        "serving-stale` instead of dying (default 30)")
    p.add_argument("--debug-endpoints", action="store_true",
                   default=os.environ.get("OPERATOR_DEBUG_ENDPOINTS",
                                          "").lower() == "true",
                   help="expose /debug/stacks and /debug/vars on the "
                        "health port (off by default: discloses stacks)")
    p.add_argument("--namespace",
                   default=os.environ.get(consts.OPERATOR_NAMESPACE_ENV,
                                          consts.DEFAULT_NAMESPACE))
    p.add_argument("--api-server",
                   default=os.environ.get("TPU_OPERATOR_API_SERVER", ""),
                   help="out-of-cluster development mode (the reference's "
                        "`make run`): point at `kubectl proxy` "
                        "(http://127.0.0.1:8001) instead of the in-cluster "
                        "service-account config")
    args = p.parse_args(argv)
    # centralized log setup (obs/logging.py): same text shape as the old
    # basicConfig, or JSON with trace/controller correlation fields
    obs_logging.setup(args.log_level, args.log_format)
    # enabled=False when --trace-buffer 0: main() is embeddable, so the
    # flag must be able to turn the process-global tracer OFF too
    obs.configure(enabled=args.trace_buffer > 0,
                  capacity=max(args.trace_buffer, 1))
    # the decision journal is on by default in the entry point (like
    # tracing, off for libraries): explain-ability and badput
    # attribution are operational surfaces, not debug extras
    obs_journal.configure(enabled=args.journal_buffer > 0,
                          per_object=max(args.journal_buffer, 1))
    # the sampling flight recorder is opt-in (a sampler walking
    # sys._current_frames() at hz is cheap but not free); the cost
    # board + exemplars need no daemon and ride the tracer above
    if args.profile_hz > 0:
        obs_profile.configure_sampler(args.profile_hz)
    # event-loop lag probe + slow-callback watchdog: on by default in
    # the entry point (like the journal — a loop SLI is an operational
    # surface, not a debug extra), off for library embedders
    obs_aioprof.configure(
        enabled=args.loop_probe_interval > 0,
        interval_s=max(args.loop_probe_interval, 0.01),
        slow_callback_s=max(args.loop_slow_callback_s, 0.05))
    # the telemetry plane is on by default in the entry point (same
    # operational-surface argument as the journal); --tsdb-retention 0
    # turns the store AND the SLO engine into shared no-ops
    obs_tsdb.configure(enabled=args.tsdb_retention > 0,
                       retention_s=max(args.tsdb_retention, 60.0))

    if client is None:
        # shared resilience layer (client/resilience.py): retry/backoff/
        # deadline + breaker around every control-plane request the
        # reconcilers make — transient 429/5xx no longer surface as
        # failed reconcile passes
        from ..client.resilience import resilient_incluster_client
        client = (resilient_incluster_client(
            api_server=args.api_server,
            token=os.environ.get("TPU_OPERATOR_TOKEN", "dev"),
            pool_size=max(1, args.client_pool_size))
            if args.api_server else resilient_incluster_client(
                pool_size=max(1, args.client_pool_size)))

    runner = OperatorRunner(
        client, args.namespace, leader_election=args.leader_election,
        max_concurrent_reconciles=args.max_concurrent_reconciles,
        max_concurrent_remediations=args.max_concurrent_remediations,
        snapshot_dir=args.snapshot_dir,
        snapshot_interval_s=max(1.0, args.snapshot_interval),
        degraded_budget_s=max(0.0, args.degraded_budget),
        slo_eval_interval_s=max(1.0, args.slo_eval_interval),
        wake_debounce_s=max(0.0, args.wake_debounce),
        wake_max_delay_s=max(0.0, args.wake_max_delay))
    # readiness gates on informer staleness: a silently-dead watch
    # stream flips /readyz 503 naming the stale kind — unless the
    # operator is in EXPLICIT serve-stale degraded mode, which reports
    # 200 `degraded: serving-stale` (alive by design, not blind)
    health = HealthServer(args.health_port, args.metrics_port,
                          debug=args.debug_endpoints,
                          informer=runner.informer,
                          degraded=lambda: runner.degraded.active)

    def _stop(*_):
        runner.request_stop()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    health.ready.set()
    log.info("tpu-operator started (namespace=%s, leader-election=%s)",
             args.namespace, args.leader_election)
    runner.run()
    health.shutdown()
    return 0
