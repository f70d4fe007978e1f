"""Answers of ``run_full_validation``'s dp x tp train steps: the step
``workloads.sharded_train_step`` returns is wrapped, so every step's loss
and weights are copied to the host as it ends, beside the weights it
started from.  The size is the batch's rows; steps counts the steps.

The numbers compared: ``train_loss_gap``, the largest relative gap of a
step's loss; ``train_grad_gap``, of the worst weight, the gap between the
norms of its first update (the first gradient as the optimizer applies it)
over the larger of the reference's norm and the median weight's;
``train_update_gap``, the same of the change after the last step.
"""

import statistics
import time
from typing import Dict

import torch

from gpubench.reference import validator as ref
from gpubench.taps import host

STATED, CONTROL = "bf16", "fp8"
CHAIN = False


def install(taps) -> None:
    def make(original):
        def call(*args, **kwargs):
            step, params, batch = original(*args, **kwargs)
            t0 = time.perf_counter()
            answer = taps.record("train", batch[0].shape[0], 0,
                                 {"start": host(params), "steps": []}, t0, t0)

            def wrapped(params, x, y):
                loss, new = step(params, x, y)
                answer.value["steps"].append((host(loss), host(new)))
                answer.steps += 1
                answer.t1 = time.perf_counter()
                return loss, new
            return wrapped, params, batch
        return call
    taps.patch("tpu_operator_torch.validator.workloads:sharded_train_step",
               make)


def numbers(sizes):
    return ["train_loss_gap", "train_grad_gap", "train_update_gap"]


def reference(size, lengths, device, precision):
    return {n: ref.train_answers(n, precision, batch=size) for n in lengths}


def _norm_gap(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              prog0: Dict[str, torch.Tensor],
              want0: Dict[str, torch.Tensor]) -> float:
    """Of the worst weight: |‖p - p0‖ - ‖r - r0‖| over the larger of
    ‖r - r0‖ and the median weight's ‖r - r0‖."""
    ref_norms = {k: float((want[k] - want0[k]).norm()) for k in want}
    median = statistics.median(ref_norms.values())
    return max(abs(float((prog[k].float().cpu() - prog0[k].float().cpu())
                         .norm()) - ref_norms[k])
               / max(ref_norms[k], median) for k in want)


def gaps(answer, want):
    start, steps = want
    prog = answer.value["steps"]
    if len(prog) != len(steps):
        return dict.fromkeys(numbers(()), float("inf"))
    return {
        "train_loss_gap": max(abs(float(l) - lr) / abs(lr)
                              for (l, _), (lr, _) in zip(prog, steps)),
        "train_grad_gap": _norm_gap(prog[0][1], steps[0][1],
                                    answer.value["start"], start),
        "train_update_gap": _norm_gap(prog[-1][1], steps[-1][1],
                                      answer.value["start"], start),
    }


def control(want):
    start, steps = want
    return {"start": start, "steps": steps}


def least_s(answer) -> float:
    # the train steps' products are too small to weigh in a pass's least
    # time (d_in 128, batch 8): counted as nothing
    return 0.0
