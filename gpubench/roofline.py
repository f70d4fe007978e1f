"""Peaks of the card and the least time of each piece of work.

The least time of a piece of work is the larger of its operations over the
bf16 dense peak and its bytes over the memory peak (NVIDIA's H100 SXM data
sheet, rated at a 700 W power limit; the run prints the card's own limit
beside every number).  Bytes count each input read once and each output
written once, whatever a kernel reads again.

Steps are counted from the chains each pass ran, as the taps of
``kinds/`` see them:
every call of the burn-in chain (``workloads._burn_in_fn``, which the
``torch`` component's burn-in, ``run_full_validation``'s and the ``perf``
component's tensor-core probe all run) and of the two triad chains
(``workloads._triad_chain``, the memory stress; ``microbench._triad_chain``,
the ``perf`` component's triad) adds its length.  The program picks those
lengths by two rules:

* ``workloads._escalated_marginal`` (burn-in, stress): from ``lo`` (the
  ``iters`` argument) it tries ``hi = lo * 64, lo * 64**2, ...``; at each
  level ``_timed_min`` runs ``lo`` three times and ``hi`` three times (one
  untimed warm call and two timed), and it stops at the first level whose
  marginal wall time passes 50 ms or whose next ``hi`` would pass its cap.
  So a pass runs ``3 * sum(lo + hi_level)`` steps over its levels.
* ``microbench._two_point_rate`` (the probes): ``r1`` and ``r2 = r1 * 16``
  (mxu) or ``r1 * 4`` (triad), each once untimed and twice timed:
  ``3 * (r1 + r2)`` steps.

:func:`escalation_steps` and :func:`two_point_steps` restate these rules;
the counts themselves come from the calls, so a kernel that is fused or
replaced reads the same work.  Where a later change alters a rule, nothing
here needs to change unless it renames or removes one of the chain
functions a kind taps: then a kind has to follow it.
"""

from __future__ import annotations

from typing import Iterable

# NVIDIA H100 SXM5 data sheet, dense rates, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
PEAKS_AT = ("NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 dense, 3.35 TB/s, "
            "at 700 W")


def least_s(flops: float, nbytes: float) -> float:
    """Seconds the card needs at least for this work."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def burn_in_step_s(n: int) -> float:
    """One step of the burn-in chain at n x n: the bf16 product (2 n^3
    operations) reading the bf16 state and weight and writing the bf16
    state (6 n^2 bytes)."""
    return least_s(2.0 * n ** 3, 6.0 * n * n)


def stream_pass_s(elements: int) -> float:
    """One triad pass over f32 arrays of ``elements``: a multiply and an
    add per element, two arrays read and one written (12 bytes)."""
    return least_s(2.0 * elements, 12.0 * elements)


def fma_s(elements: int) -> float:
    """The FMA + ReLU check: three f32 arrays read, one written."""
    return least_s(2.0 * elements, 16.0 * elements)


def escalation_steps(lo: int, his: Iterable[int]) -> int:
    """Steps of one ``_escalated_marginal`` call that stopped after the
    levels ``his``."""
    return sum(3 * (lo + hi) for hi in his)


def two_point_steps(r1: int, r2: int) -> int:
    """Steps of one ``_two_point_rate`` call."""
    return 3 * (r1 + r2)
