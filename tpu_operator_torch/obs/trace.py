"""Dependency-free in-process tracer (the port's copy of
``tpu_operator/obs/trace.py``).

The client opens an ``io.await.<verb>`` span per request and the
resilience layer a ``client.<verb>`` span per operation, with retries and
breaker flips as events; with tracing off (the default) both are the
shared no-op span.

* **Spans** carry a ``trace_id``/``span_id``/``parent_id``, monotonic
  start/end times, attributes, and timestamped events.  The ambient
  parent propagates through a :mod:`contextvars` variable, so a phase
  opened with ``with span("policy.state-sync"):`` automatically parents
  every client call made inside it.
* **One trace per reconcile pass.**  A root span per pass; a pass woken
  by a watch event reuses the trace id allocated at watch delivery
  (:func:`watch_stamp`), so one id links watch delivery → queue wait →
  every phase → the client write that published status.
* **Bounded ring-buffer store.**  Finished traces land in an in-process
  store keeping the N most recent and the N slowest.  Nothing is
  exported off-process — this is a flight recorder, not a pipeline.
* **Disabled = no-op.**  The tracer is OFF by default; every entry point
  returns the shared :data:`NOOP_SPAN` after one boolean check, so
  library consumers (node agents, CLIs) pay nothing.  :func:`configure`
  turns it on.
* **Exact clocks.**  A finished span keeps its monotonic start and end
  (``time.monotonic``: ``time.perf_counter``'s clock on Linux) and its
  wall-clock start and end in Unix nanoseconds (``time.time_ns``, the
  clock ``torch.profiler`` events carry), unrounded.

Always-on side channels (cheap, tracing-independent): :func:`watch_stamp`
timestamps event deliveries, and :class:`write_capture`/:func:`note_write`
let a caller learn when the pass's status write actually landed.

Every finished span also feeds the per-phase cost board of
``profile.py``.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

# ambient current span (None = no active trace on this thread/context)
_current: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("gpu_obs_current_span", default=None)
# fields injected into every log record (obs/logging.py): controller/key
_log_ctx: contextvars.ContextVar[Dict[str, str]] = \
    contextvars.ContextVar("gpu_obs_log_ctx", default={})
# per-pass write capture cell (see write_capture below)
_write_cell: contextvars.ContextVar[Optional[dict]] = \
    contextvars.ContextVar("gpu_obs_write_cell", default=None)

# per-span caps: a retry storm must cost bounded memory, not O(attempts)
MAX_EVENTS_PER_SPAN = 64
MAX_SPANS_PER_TRACE = 256

# which span is live on which OS thread right now — the sampling flight
# recorder (obs/profile.py) reads this from ITS thread to tag stack
# samples with the worker's active span/trace.  Plain dict keyed by
# thread ident: each entry is written only by its own thread (span
# enter/exit), so per-key access is GIL-atomic and the sampler's reads
# are at worst one sample stale.  Empty whenever tracing is off.
_ACTIVE_BY_THREAD: Dict[int, "Span"] = {}


def _new_trace_id() -> str:
    return os.urandom(8).hex()


def _new_span_id() -> str:
    return os.urandom(4).hex()


class NoopSpan:
    """The disabled-tracer span: every operation is a no-op.  A single
    shared instance (:data:`NOOP_SPAN`) is returned by every tracing
    entry point when tracing is off or no trace is active, so the cost
    of instrumented code without a tracer is one ``enabled`` check."""

    __slots__ = ()
    recording = False
    trace_id = ""
    span_id = ""
    parent_id = ""
    name = ""

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def add_event(self, name: str, **attrs: Any) -> None:
        pass

    def end(self) -> None:
        pass

    def __enter__(self) -> "NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP_SPAN = NoopSpan()


class Span:
    """A live span.  Mutated only by the thread that opened it (events
    appended from the same call stack); handed to the tracer exactly
    once, at :meth:`end`."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "attrs", "events", "start_wall", "start_wall_ns",
                 "end_wall_ns", "start_mono", "end_mono", "start_cpu",
                 "cpu_s", "thread", "_token", "_ended", "_prev_active")

    recording = True

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: str, attrs: Optional[dict] = None):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.name = name
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.events: List[Tuple[float, str, dict]] = []
        self.start_wall_ns = time.time_ns()
        self.start_wall = self.start_wall_ns / 1e9
        self.start_mono = time.monotonic()
        # per-thread CPU clock: end() attributes the span's wall time to
        # cpu vs wait (wall - cpu) — only valid because a span begins and
        # ends on the thread that opened it (the class contract above)
        self.start_cpu = time.thread_time()
        self.end_mono: Optional[float] = None
        self.end_wall_ns: Optional[int] = None
        self.cpu_s = 0.0
        # which OS thread executed the span: the self-time attribution
        # (obs/profile.py) only subtracts a child from its parent when
        # both ran on one thread — a write fan-out's concurrent client
        # spans must not erase the phase that dispatched them
        self.thread = threading.get_ident()
        self._token: Optional[contextvars.Token] = None
        self._ended = False
        self._prev_active: Optional["Span"] = None

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def add_event(self, name: str, **attrs: Any) -> None:
        if len(self.events) >= MAX_EVENTS_PER_SPAN:
            return
        self.events.append((time.monotonic(), name, attrs))

    def end(self) -> None:
        if self._ended:
            return
        self._ended = True
        self.end_mono = time.monotonic()
        self.end_wall_ns = time.time_ns()
        self.cpu_s = max(0.0, time.thread_time() - self.start_cpu)
        self.tracer._finish(self)

    # -- context manager: activates the span as the ambient parent
    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        ident = threading.get_ident()
        self._prev_active = _ACTIVE_BY_THREAD.get(ident)
        _ACTIVE_BY_THREAD[ident] = self
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        ident = threading.get_ident()
        if self._prev_active is not None:
            _ACTIVE_BY_THREAD[ident] = self._prev_active
            self._prev_active = None
        else:
            _ACTIVE_BY_THREAD.pop(ident, None)
        if exc_type is not None:
            self.add_event("exception", type=exc_type.__name__,
                           message=str(exc)[:200])
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()


@dataclass(frozen=True)
class WatchStamp:
    """The originating watch event a queue wake carries: what happened,
    when (wall for the convergence histogram, monotonic for the
    queue-wait span), and the trace id allocated for the reconcile pass
    it will trigger (empty when tracing is disabled)."""
    kind: str
    verb: str
    name: str
    namespace: str
    wall: float
    mono: float
    trace_id: str


class Tracer:
    """Span factory + bounded in-process trace store."""

    def __init__(self, capacity: int = 256, slow_capacity: int = 32,
                 enabled: bool = False):
        self.enabled = enabled
        self.capacity = capacity
        self.slow_capacity = slow_capacity
        self._lock = threading.Lock()
        # trace_id -> finished span dicts, awaiting their root's end
        self._live: Dict[str, List[dict]] = {}
        self._recent: deque = deque(maxlen=capacity)
        # (duration_s, trace) kept ascending; min evicted on overflow
        self._slowest: List[Tuple[float, dict]] = []

    # ------------------------------------------------------------- span API
    def root_span(self, name: str, attrs: Optional[dict] = None,
                  trace_id: Optional[str] = None):
        """Open a trace root (a new trace, or the one pre-allocated by a
        watch stamp).  The returned span must be used as a context
        manager so the ambient parent is restored on exit."""
        if not self.enabled:
            return NOOP_SPAN
        return Span(self, name, trace_id or _new_trace_id(), "", attrs)

    def span(self, name: str, attrs: Optional[dict] = None):
        """Open a child of the ambient span.  No ambient trace (or
        tracing disabled) → :data:`NOOP_SPAN`: libraries instrument
        unconditionally and only traced call paths pay."""
        if not self.enabled:
            return NOOP_SPAN
        parent = _current.get()
        if parent is None or not parent.recording:
            return NOOP_SPAN
        return Span(self, name, parent.trace_id, parent.span_id, attrs)

    def span_or_root(self, name: str, attrs: Optional[dict] = None):
        """A child of the ambient span, or the root of a new trace where
        none is open (a phase that runs both alone and inside another)."""
        if not self.enabled:
            return NOOP_SPAN
        parent = _current.get()
        if parent is None or not parent.recording:
            return Span(self, name, _new_trace_id(), "", attrs)
        return Span(self, name, parent.trace_id, parent.span_id, attrs)

    def record_span(self, name: str, start_mono: float, end_mono: float,
                    parent=None, attrs: Optional[dict] = None) -> None:
        """Record a span retroactively from explicit monotonic bounds —
        the queue-wait span, whose start (the watch delivery) predates
        the reconcile that knows about it."""
        if not self.enabled:
            return
        parent = parent if parent is not None else _current.get()
        if parent is None or not parent.recording:
            return
        self._store_finished({
            "span_id": _new_span_id(), "parent_id": parent.span_id,
            "name": name, "start_mono": start_mono, "end_mono": end_mono,
            "duration_ms": max(0.0, (end_mono - start_mono) * 1000.0),
            "cpu_ms": 0.0,   # a retroactive span is pure wait by definition
            "thread": threading.get_ident(),
            "attrs": dict(attrs or {}), "events": [],
        }, parent.trace_id, root=False)

    # ----------------------------------------------------------- store path
    def _finish(self, span: Span) -> None:
        rec = {
            "span_id": span.span_id, "parent_id": span.parent_id,
            "name": span.name, "start_mono": span.start_mono,
            "end_mono": span.end_mono, "start_wall": span.start_wall,
            "start_wall_ns": span.start_wall_ns,
            "end_wall_ns": span.end_wall_ns,
            "duration_ms": max(0.0, ((span.end_mono or span.start_mono)
                                     - span.start_mono) * 1000.0),
            "cpu_ms": span.cpu_s * 1000.0,
            "thread": span.thread,
            "attrs": span.attrs,
            "events": [{"mono": m, "name": n, "attrs": a}
                       for m, n, a in span.events],
        }
        self._store_finished(rec, span.trace_id, root=not span.parent_id)

    def _store_finished(self, rec: dict, trace_id: str, root: bool) -> None:
        # feed the per-phase cost-attribution board (obs/profile.py):
        # lazy import of an already-loaded sibling (obs/__init__ imports
        # both), kept out of module scope to avoid the import cycle —
        # profile.py reads this module's active-span registry
        from . import profile as _profile
        _profile.note_span(rec["name"], rec["duration_ms"] / 1000.0,
                           rec.get("cpu_ms", 0.0) / 1000.0)
        with self._lock:
            spans = self._live.setdefault(trace_id, [])
            if root or len(spans) < MAX_SPANS_PER_TRACE:
                spans.append(rec)
            if not root:
                # bound orphaned buffers (a root that never ends must not
                # leak): evict the oldest live trace past 4x capacity
                while len(self._live) > 4 * self.capacity:
                    self._live.pop(next(iter(self._live)))
                return
            spans = self._live.pop(trace_id)
            trace = self._finalize(trace_id, rec, spans)
            self._recent.append(trace)
            dur = trace["duration_ms"] / 1000.0
            if len(self._slowest) < self.slow_capacity:
                self._slowest.append((dur, trace))
                self._slowest.sort(key=lambda t: t[0])
            elif dur > self._slowest[0][0]:
                self._slowest[0] = (dur, trace)
                self._slowest.sort(key=lambda t: t[0])

    @staticmethod
    def _finalize(trace_id: str, root: dict, spans: List[dict]) -> dict:
        t0 = min(s["start_mono"] for s in spans)
        out_spans = []
        for s in sorted(spans, key=lambda s: s["start_mono"]):
            out_spans.append({
                "span_id": s["span_id"], "parent_id": s["parent_id"],
                "name": s["name"],
                "offset_ms": round((s["start_mono"] - t0) * 1000.0, 3),
                "duration_ms": round(s["duration_ms"], 3),
                "cpu_ms": round(s.get("cpu_ms", 0.0), 3),
                "thread": s.get("thread", 0),
                # the clocks unrounded: monotonic seconds, and wall-clock
                # Unix nanoseconds where the span was live (not retroactive)
                "start_mono": s["start_mono"], "end_mono": s["end_mono"],
                "start_wall_ns": s.get("start_wall_ns"),
                "end_wall_ns": s.get("end_wall_ns"),
                "attrs": s["attrs"],
                "events": [{"offset_ms": round((e["mono"] - t0) * 1000.0, 3),
                            "name": e["name"], "attrs": e["attrs"]}
                           for e in s.get("events", [])],
            })
        return {
            "trace_id": trace_id,
            "name": root["name"],
            # wall clock of the trace's earliest instant (the root knows
            # its own wall start; earlier retroactive spans offset it)
            "ts": root.get("start_wall", 0.0)
            - (root["start_mono"] - t0),
            # monotonic origin of the offset_ms timeline: the Chrome
            # export (obs/export.py) joins sampler samples — which are
            # monotonic-stamped — onto the trace with it
            "t0_mono": t0,
            "duration_ms": round((max(s["start_mono"]
                                      + s["duration_ms"] / 1000.0
                                      for s in spans) - t0) * 1000.0, 3),
            "spans": out_spans,
        }

    # ------------------------------------------------------------ read path
    def snapshot(self, n: int = 20) -> dict:
        """The ``/debug/traces`` payload: N most recent (newest first)
        and N slowest (slowest first) finished traces."""
        n = max(0, n)   # a negative ?n= must not invert the slice
        with self._lock:
            # [-n:] with n == 0 would be the WHOLE deque, not none of it
            recent = list(self._recent)[-n:][::-1] if n else []
            slowest = [t for _, t in sorted(self._slowest,
                                            key=lambda x: -x[0])][:n]
        return {"recent": recent, "slowest": slowest}

    def get_trace(self, trace_id: str) -> Optional[dict]:
        """One stored trace by id (newest recent first, then the slowest
        board) — the ``/debug/trace/<id>.json`` Chrome-export lookup."""
        with self._lock:
            for tr in reversed(self._recent):
                if tr.get("trace_id") == trace_id:
                    return tr
            for _, tr in self._slowest:
                if tr.get("trace_id") == trace_id:
                    return tr
        return None

    def reset(self) -> None:
        with self._lock:
            self._live.clear()
            self._recent.clear()
            self._slowest.clear()


# the process-global tracer; configure() swaps its settings in place
_TRACER = Tracer()


def configure(enabled: bool = True, capacity: int = 256,
              slow_capacity: int = 32) -> Tracer:
    """Turn the global tracer on/off and size its ring buffers (the
    operator entry point calls this from ``--trace-buffer``)."""
    _TRACER.enabled = enabled
    _TRACER.capacity = capacity
    _TRACER.slow_capacity = slow_capacity
    with _TRACER._lock:
        _TRACER._recent = deque(_TRACER._recent, maxlen=capacity)
    return _TRACER


def is_enabled() -> bool:
    return _TRACER.enabled


def reset() -> None:
    """Test helper: disable and drop every stored trace, plus the
    profiling layer riding on it (attribution board, sampler,
    exemplars), the journal and the loop observability — one call
    returns the whole obs surface to the disabled-by-default state."""
    _TRACER.enabled = False
    _TRACER.reset()
    from . import profile as _profile
    _profile.reset_all()
    from . import journal as _journal
    _journal.reset()
    from . import aioprof as _aioprof
    _aioprof.reset()


def clear() -> None:
    """Drop stored traces without changing enablement."""
    _TRACER.reset()


def root_span(name: str, attrs: Optional[dict] = None,
              trace_id: Optional[str] = None):
    return _TRACER.root_span(name, attrs, trace_id)


def span(name: str, attrs: Optional[dict] = None):
    return _TRACER.span(name, attrs)


def span_or_root(name: str, attrs: Optional[dict] = None):
    return _TRACER.span_or_root(name, attrs)


def record_span(name: str, start_mono: float, end_mono: float,
                parent=None, attrs: Optional[dict] = None) -> None:
    _TRACER.record_span(name, start_mono, end_mono, parent, attrs)


def current_span():
    return _current.get() or NOOP_SPAN


def add_event(name: str, **attrs: Any) -> None:
    """Attach an event to the ambient span, if any (the client resilience
    layer's breaker/retry annotations ride this)."""
    sp = _current.get()
    if sp is not None:
        sp.add_event(name, **attrs)


def snapshot(n: int = 20) -> dict:
    return _TRACER.snapshot(n)


def get_trace(trace_id: str) -> Optional[dict]:
    return _TRACER.get_trace(trace_id)


def active_span_for_thread(ident: int):
    """The span currently live on thread ``ident`` (None when that
    thread is outside any trace) — read by the sampling flight recorder
    to tag stack samples with the worker's active span."""
    return _ACTIVE_BY_THREAD.get(ident)


def watch_stamp(verb: str, obj: dict) -> WatchStamp:
    """Stamp a watch delivery: called once per (event, woken reconciler)
    on the delivery path.  Always returns a stamp — the wall/monotonic
    timestamps feed the queue-latency and convergence histograms with
    tracing off; the trace id is only allocated when tracing is on."""
    md = obj.get("metadata", {})
    return WatchStamp(
        kind=obj.get("kind", ""), verb=verb, name=md.get("name", ""),
        namespace=md.get("namespace", ""), wall=time.time(),
        mono=time.monotonic(),
        trace_id=_new_trace_id() if _TRACER.enabled else "")


# ------------------------------------------------------- log-field binding

class log_context:
    """Bind extra fields (controller, key) onto every log record emitted
    inside the block — obs/logging.py's filter reads them."""

    def __init__(self, **fields: str):
        self._fields = fields
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> "log_context":
        merged = dict(_log_ctx.get())
        merged.update(self._fields)
        self._token = _log_ctx.set(merged)
        return self

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _log_ctx.reset(self._token)


def current_log_context() -> Dict[str, str]:
    return _log_ctx.get()


# ------------------------------------------------------------ write capture

class write_capture:
    """Per-pass capture of the pass's last successful client write.

    The convergence-latency histogram measures watch-event timestamp →
    status write; the runner cannot see inside the resilience layer, so
    the layer notes each landed write into a contextvar cell the runner
    opened.  Always on (a dict write per mutation), tracing-independent.
    """

    def __init__(self) -> None:
        self.last: Dict[str, float] = {}
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> "write_capture":
        self._token = _write_cell.set(self.last)
        return self

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _write_cell.reset(self._token)


def note_write(verb: str) -> None:
    """Called by the client layer after a mutation lands.  ``wall`` is
    the last write of any verb; ``status_wall`` specifically the last
    status-subresource write (the convergence end point of choice)."""
    cell = _write_cell.get()
    if cell is None:
        return
    now = time.time()
    cell["wall"] = now
    if verb == "update_status":
        cell["status_wall"] = now
