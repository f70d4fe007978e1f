"""The validator's spans on the profiler's timeline.

The validator opens the spans of the port's tracer (``obs/trace.py``)
through :func:`ranged`.  A span that records while a ``torch.profiler``
session records is also a ``record_function`` range of its name, so the
device trace shows which phase of the validator was open; outside a
session a span opens no range.  ``obs`` itself imports no torch.
"""

from __future__ import annotations

import contextlib


def ranged(span):
    """``span`` as a context manager, entered together with a
    ``record_function`` range of its name where it records and a profiler
    records; the span itself everywhere else (tracer off: the no-op)."""
    if not span.recording:
        return span
    import torch

    if not torch.autograd._profiler_enabled():
        return span
    return _with_range(span)


@contextlib.contextmanager
def _with_range(span):
    from torch.profiler import record_function

    with record_function(span.name), span:
        yield span
