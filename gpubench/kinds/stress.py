"""Answers of the memory stress, ``workloads._triad_chain`` (the ``torch``
component's ``hbm_stress`` and ``run_full_validation``'s): each chain
call's answer is the least and the largest element of the chain's whole
state, as ``graphs.chain`` returns it on the card (its replays call no
step) or the last step (``workloads._triad_step``) on the CPU, not only
the eight elements the program returns.  The size is the array's elements.

The number compared, ``stress_gap``: the largest gap between the
program's extrema and the reference's after the same passes, over the
reference's.  The reference's array holds one value in every element, so
the program's matches it only where every element does: a pass that leaves
part of the array out reads off, and the limit is 0.  The program's arrays
are constant and the recurrence reaches its fixed point after a dozen
passes, so the number of passes shows only in a traced run
(``compare.short_chains``).
"""

from gpubench import roofline
from gpubench.reference import validator as ref

STATED, CONTROL = "f32", "bf16"
CHAIN = True
PROGRAM = "tpu_operator_torch.validator.workloads"


def install(taps) -> None:
    taps.patch(f"{PROGRAM}:_triad_chain",
               taps.chain("stress", "b", "reps", size=lambda t: t.numel(),
                          whole=True))
    taps.patch(f"{PROGRAM}:_triad_step", taps.chain_state("stress"))
    taps.patch(f"{PROGRAM}:chain", taps.chain_state("stress"))


def numbers(sizes):
    return ["stress_gap"]


def reference(size, lengths, device, precision):
    return ref.stress_answers(size, lengths, device, precision)


def gaps(answer, want):
    if answer.value is None:
        return {"stress_gap": float("inf")}
    got = [float(v) for v in answer.value]
    return {"stress_gap": max(abs(g - w) for g, w in zip(got, want))
            / max(abs(w) for w in want)}


def control(want):
    return want


def least_s(answer) -> float:
    return answer.steps * roofline.stream_pass_s(answer.size)
