"""The program's own spans of each pass, for the readers of per-layer
metrics whose ``source`` is ``program_span``.

The port's validator opens spans with counters as attributes
(``tpu_operator_torch/obs/trace.py``): ``validator.component`` or
``validator.full`` around a call, and inside it ``validator.escalation``,
``validator.chain``, ``validator.graphs.capture`` and
``validator.graphs.release``.  The tracer is off by default, where a span
costs the program one boolean check.

Importing this module switches the tracer on, for the rest of the process.
The import is the switch because readers of per-layer metrics are loaded
only for ``--trace 1`` runs (``manifest.metrics``), which import this
module through them; the ``--trace 0`` runs, which time ``validate_s`` and
``setup_s``, never import it and keep the tracer off.

A span belongs to the pass its monotonic start lies in: the program stamps
spans with ``time.monotonic`` and the harness its passes with
``time.perf_counter``, one clock (``CLOCK_MONOTONIC``) on Linux.  Only the
passes the profiler did not record are read (``obs.untraced()``), as the
``span.*`` readers do.  Where the program opens no span (a program from
before its validator had them), every reader finds nothing and returns
None.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from tpu_operator_torch.obs import trace

# finished traces kept: two a pass, ~25 passes a window, with room
CAPACITY = 4096

trace.configure(enabled=True, capacity=CAPACITY)


def per_pass(obs) -> Dict[int, List[dict]]:
    """Pass index -> the program's finished spans that started in it, for
    the passes the profiler did not record."""
    starts = [t0 for t0, _ in obs.passes]
    keep = obs.untraced()
    out: Dict[int, List[dict]] = {}
    for tr in trace.snapshot(CAPACITY)["recent"]:
        for span in tr.get("spans", []):
            mono = span.get("start_mono")
            if mono is None:
                continue
            i = bisect.bisect_right(starts, mono) - 1
            if i in keep and mono < obs.passes[i][1]:
                out.setdefault(i, []).append(span)
    return out


def seconds(span: dict) -> float:
    return span["end_mono"] - span["start_mono"]


def mean_seconds(obs, name: str) -> Optional[float]:
    """Host seconds a pass inside spans ``name``, the mean over the passes
    the profiler did not record; None where no pass has one."""
    spans = per_pass(obs)
    if not any(s["name"] == name for ss in spans.values() for s in ss):
        return None
    total = sum(seconds(s) for ss in spans.values() for s in ss
                if s["name"] == name)
    return total / len(obs.untraced())


def ancestors(span: dict, spans: List[dict]) -> List[dict]:
    """The spans of ``spans`` that ``span`` lies inside, innermost first."""
    by_id = {s["span_id"]: s for s in spans}
    out = []
    while span["parent_id"] in by_id:
        span = by_id[span["parent_id"]]
        out.append(span)
    return out
