"""Answers of the burn-in chain, ``_burn_in_fn``: the ``torch`` component's
burn-in and ``run_full_validation``'s (``workloads``), and the ``perf``
component's tensor-core probe (``microbench``).  Each chain call's answer is
the checksum the program returns (the f32 sum of the state after its
steps); the size is n of the n x n state.

The number compared, ``burn_in_gap.<n>``: the largest gap between the
program's checksum and the reference's after the same steps, over the
reference state's mass (the sum of its magnitudes).
"""

from gpubench import roofline
from gpubench.reference import validator as ref

STATED, CONTROL = "bf16", "fp8"
# one or more kernels a step: a traced call launches at least its steps
CHAIN = True


def install(taps) -> None:
    # microbench first: importing it binds its own name to workloads'
    # function, which must not be the workloads tap yet
    for module in ("microbench", "workloads"):
        taps.patch(f"tpu_operator_torch.validator.{module}:_burn_in_fn",
                   taps.chain("burn_in", "x", "iters",
                              size=lambda t: t.shape[0]))


def numbers(sizes):
    return [f"burn_in_gap.{s}" for s in sizes]


def reference(size, lengths, device, precision):
    return ref.burn_in_answers(size, lengths, device, precision)


def gaps(answer, want):
    checksum, mass = want
    return {f"burn_in_gap.{answer.size}":
            abs(float(answer.value) - checksum) / mass}


def control(want):
    return want[0]


def least_s(answer) -> float:
    return answer.steps * roofline.burn_in_step_s(answer.size)
