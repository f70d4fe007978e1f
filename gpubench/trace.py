"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

The profiler records the first passes of the window (whole passes, until
they cover :data:`TRACED_SECONDS`), marked ``gpubench.window``; the taps'
spans are marked ``gpubench.<name>`` and the passes ``gpubench.pass``.
From the raw events this keeps what the metric readers and the result's
``breakdown`` need: the seconds in which some kernel, copy or set ran on
the card (``busy_s``), the traced window's length, the device seconds of
what was launched inside each kind of span, the device operations that
took most time, the idle gaps by what the host was doing, and the kernels
launched inside each chain call (``gpubench.chain.<kind>``), which
``compare.short_chains`` holds against the steps the taps counted.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# passes are traced until they cover this much of the window
TRACED_SECONDS = 4.0
# idle gaps shorter than this are summed under one name
SHORT_GAP_S = 20e-6
TOP = 10
# device operations that are no kernel: a chain's copies and sets
COPIES = ("Memcpy", "Memset")
# host events that launch device work: the CUDA runtime's and driver's calls
LAUNCHES = ("cu",)


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    device_s: Dict[str, float]          # span name -> device seconds
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    # chain kind -> kernels launched inside each of its calls, in order
    launches: Dict[str, List[int]] = dataclasses.field(default_factory=dict)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarize(prof) -> Optional[Trace]:
    """What the metrics read of a finished ``torch.profiler.profile``; None
    where it saw no window or no device work."""
    from torch.autograd import DeviceType

    device, host, marks, launched = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        s, t, name = e.start_ns(), e.end_ns(), e.name()
        # a span marked on the host is also drawn on the device's timeline
        # (``gpu_user_annotation``): it is no operation of the device
        annotation = name.startswith("gpubench.") or getattr(
            e, "is_user_annotation", lambda: False)()
        if e.device_type() == DeviceType.CUDA:
            if not annotation:
                device.append((s, t, name, e.correlation_id()))
        elif name.startswith("gpubench."):
            marks.append((s, t, name))
        else:
            host.append((s, t, name))
            if name.startswith(LAUNCHES) and e.correlation_id():
                # the launch (a kernel, a graph, a copy) on the host: a CUDA
                # runtime or driver call.  Other host events (torch's ops,
                # marks) number their correlation ids from 1 as well, so
                # their ids collide with the launches' and name nothing
                c = e.correlation_id()
                launched[c] = min(s, launched.get(c, s))
    window = [m for m in marks if m[2] == "gpubench.window"]
    if not window or not device:
        return None
    w0, w1 = window[0][0], window[0][1]
    device = sorted(d for d in device if w0 <= d[0] < w1)
    if not device:
        return None
    busy = _union([(s, min(t, w1)) for s, t, _, _ in device])

    # the card runs what the host queued later than the host queued it: a
    # device operation belongs to the span its launch was made in (the
    # launch found by the correlation id; its own start where none is)
    by_launch = sorted((launched.get(c, s), t - s) for s, t, _, c in device)
    starts = [b[0] for b in by_launch]
    cum = [0]
    for _, d in by_launch:
        cum.append(cum[-1] + d)
    kernels = sorted(launched.get(c, s) for s, _, name, c in device
                     if not name.startswith(COPIES))
    device_s: Dict[str, float] = defaultdict(float)
    launches: Dict[str, List[int]] = defaultdict(list)
    for s, t, name in sorted(marks):
        if name in ("gpubench.window", "gpubench.pass"):
            continue
        lo, hi = bisect.bisect_left(starts, s), bisect.bisect_left(starts, t)
        device_s[name[len("gpubench."):]] += (cum[hi] - cum[lo]) / 1e9
        if name.startswith("gpubench.chain."):
            launches[name[len("gpubench.chain."):]].append(
                bisect.bisect_left(kernels, t)
                - bisect.bisect_left(kernels, s))

    ops: Dict[str, float] = defaultdict(float)
    for s, t, name, _ in device:
        ops[name] += (t - s) / 1e9

    # idle gaps inside the window, each named by the innermost benchmark
    # span and the host operation open at its middle
    gaps: Dict[str, float] = defaultdict(float)
    edges = [(w0, w0)] + busy + [(w1, w1)]
    host.sort()
    host_starts = [h[0] for h in host]
    marks.sort()
    mark_starts = [m[0] for m in marks]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b <= a:
            continue
        if (b - a) / 1e9 < SHORT_GAP_S:
            gaps["between kernels (< 20 us)"] += (b - a) / 1e9
            continue
        mid = (a + b) // 2
        span = _open_at(marks, mark_starts, mid) or "outside spans"
        op = _open_at(host, host_starts, mid) or "Python, no torch op"
        gaps[f"{span} | {op}"] += (b - a) / 1e9
    top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                           key=lambda kv: -kv[1])[:TOP]
    return Trace(sum(t - s for s, t in busy) / 1e9, (w1 - w0) / 1e9,
                 dict(device_s), top(ops), top(gaps), dict(launches))


def _open_at(events, starts, at: int, look: int = 256) -> str:
    """The innermost (latest started) event open at ``at``."""
    i = bisect.bisect_right(starts, at)
    for j in range(i - 1, max(-1, i - 1 - look), -1):
        s, t, name = events[j]
        if t >= at:
            return name
    return ""
