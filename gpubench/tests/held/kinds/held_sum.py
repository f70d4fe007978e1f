"""Answers of the test-only all-reduce (``gpubench.tests.held``): rank 0's
sum, copied to the host as it returns.  The size is the vector's elements;
steps counts the ranks.

The number compared, ``held_sum_gap``: the largest gap of an element over
the largest element of the plain sum.
"""

import time

import torch
import torch.distributed as dist

from gpubench.tests import held

STATED, CONTROL = "f32", "bf16"
CHAIN = False


def install(taps) -> None:
    def make(original):
        def call(size, fault=None):
            t0 = time.perf_counter()
            out = original(size, fault)
            taps.record("held_sum", size, dist.get_world_size(),
                        out.detach().cpu(), t0, time.perf_counter())
            return out
        return call
    taps.patch(held.FUNCTION, make)


def numbers(sizes):
    return ["held_sum_gap"]


def reference(size, lengths, device, precision):
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    return {n: torch.stack([held.rank_input(size, r).to(dtype)
                            for r in range(n)]).sum(0).float()
            for n in lengths}


def gaps(answer, want):
    return {"held_sum_gap": float((answer.value - want).abs().max()
                                  / want.abs().max())}


def control(want):
    return want


def least_s(answer) -> float:
    return 0.0
