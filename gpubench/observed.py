"""What one run observed, as the metric readers see it."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .taps import Answer, Span
from .trace import Trace


@dataclasses.dataclass
class Observed:
    setup_s: float
    passes: List[Tuple[float, float]]       # host clock, back to back
    answers: List[Answer]
    spans: List[Span]
    reports: List[Dict[str, Dict[str, str]]]   # per pass: report -> values
    kinds: Dict[str, object]                # kind -> ``kinds/<kind>.py``
    trace: Optional[Trace] = None
    traced: Set[int] = dataclasses.field(default_factory=set)

    @property
    def window_s(self) -> float:
        return self.passes[-1][1] - self.passes[0][0] if self.passes else 0.0

    def untraced(self) -> Set[int]:
        """Passes the profiler did not record: all of them where it
        recorded every one."""
        every = set(range(len(self.passes)))
        return (every - self.traced) or every

    def span_s(self, name: str, passes: Set[int]) -> float:
        return sum(s.t1 - s.t0 for s in self.spans
                   if s.name == name and s.pass_index in passes)

    def has_span(self, name: str) -> bool:
        return any(s.name == name for s in self.spans)

    def span_per_pass_s(self, name: str) -> Optional[float]:
        """Host seconds per pass inside the taps' span ``name`` (passes the
        profiler did not record); None where the passes have no such
        span."""
        if not self.has_span(name):
            return None
        passes = self.untraced()
        return self.span_s(name, passes) / len(passes)

    def roofline(self, kind: str) -> Optional[float]:
        """% of the roofline of the ``kind`` chains in the traced passes:
        the least time of the steps they ran over the device seconds
        launched inside those chain calls, whatever kernels ran."""
        if self.trace is None:
            return None
        device_s = self.trace.device_s.get(f"chain.{kind}", 0.0)
        least = self.least_s(kind, self.traced)
        if device_s <= 0 or least <= 0:
            return None
        return 100.0 * least / device_s

    def least_s(self, kind: str, passes: Set[int]) -> float:
        """Least seconds of the ``kind`` work the passes ran."""
        module = self.kinds.get(kind)
        if module is None:
            return 0.0
        return sum(module.least_s(a) for a in self.answers
                   if a.kind == kind and a.pass_index in passes)
