"""Answers of the ``perf`` component's triad probe,
``microbench._triad_chain`` on the port's triad kernel: each chain call's
answer is the least and the largest element of the chain's whole state,
as ``graphs.chain`` returns it on the card or the last step
(``ops.triad_``) on the CPU, not only the eight elements the program
sums.  The size is the array's elements.

The number compared, ``triad_gap``: as ``stress_gap`` (``kinds/stress.py``),
exact, limit 0.
"""

from gpubench import roofline
from gpubench.reference import validator as ref

STATED, CONTROL = "f32", "bf16"
CHAIN = True


def install(taps) -> None:
    taps.patch("tpu_operator_torch.validator.microbench:_triad_chain",
               taps.chain("triad", "a", "reps", size=lambda t: t.numel(),
                          whole=True))
    taps.patch("tpu_operator_torch.validator.ops:triad_",
               taps.chain_state("triad"))
    taps.patch("tpu_operator_torch.validator.microbench:chain",
               taps.chain_state("triad"))


def numbers(sizes):
    return ["triad_gap"]


def reference(size, lengths, device, precision):
    return ref.triad_answers(size, lengths, device, precision)


def gaps(answer, want):
    if answer.value is None:
        return {"triad_gap": float("inf")}
    got = [float(v) for v in answer.value]
    return {"triad_gap": max(abs(g - w) for g, w in zip(got, want))
            / max(abs(w) for w in want)}


def control(want):
    return want


def least_s(answer) -> float:
    return answer.steps * roofline.stream_pass_s(answer.size)
