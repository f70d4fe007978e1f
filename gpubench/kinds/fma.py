"""Answers of the ``perf`` component's FMA + ReLU check, ``ops.fma_relu``
(``microbench.vpu_probe``): the output, copied to the host at once, as the
probe itself does next (a 1 MiB output kept on the card for every pass
would fill its memory and move its peak).  The size is its elements.

The number compared, ``fma_gap``: the largest gap of an output element
over the largest reference value.
"""

import math
import time

import numpy as np
import torch

from gpubench import roofline
from gpubench.reference import validator as ref

STATED, CONTROL = "f32", "bf16"
CHAIN = False


def install(taps) -> None:
    def make(original):
        def call(a, b, c):
            t0 = time.perf_counter()
            out = original(a, b, c)
            taps.record("fma", a.numel(), 1, out.detach().cpu(), t0,
                        time.perf_counter())
            return out
        return call
    taps.patch("tpu_operator_torch.validator.ops:fma_relu", make)


def numbers(sizes):
    return ["fma_gap"]


def reference(size, lengths, device, precision):
    side = math.isqrt(size)
    return {1: ref.fma_answer(side, size // side, precision)}


def gaps(answer, want):
    got = torch.as_tensor(answer.value).cpu().numpy().astype(np.float64)
    return {"fma_gap": float(np.max(np.abs(got - want))
                             / np.max(np.abs(want)))}


def control(want):
    return want


def least_s(answer) -> float:
    return roofline.fma_s(answer.size)
