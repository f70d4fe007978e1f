"""Reference answers of the validator's chains, probes and train steps.

``precision`` names how operands are rounded before each product or pass:
``"bf16"`` and ``"f32"`` are what the port's configuration states (bf16
operands with f32 products; f32 memory passes), ``"fp8"`` and ``"bf16"``
in the f32 functions are the control's (the nearest precision below).
Products are f32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np
import torch

ROUND_TO = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn,
            "f32": torch.float32}


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """f32 products in full precision for the block (TF32 off)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` rounded to ``precision``, held in f32."""
    return t.to(ROUND_TO[precision]).float()


class _Round(torch.autograd.Function):
    """Rounding to a precision whose gradient is rounded the same way (the
    transpose of a cast, as the program's ``t.bfloat16().float()`` is)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, precision: str) -> torch.Tensor:
        ctx.precision = precision
        return rounded(t, precision)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return rounded(g, ctx.precision), None


# --------------------------------------------------------------------------
# the burn-in chain: workloads.matmul_burn_in and microbench.mxu_probe
# --------------------------------------------------------------------------

def burn_in_inputs(size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain's start and weight as the program draws them: two bf16
    normal draws from a generator on the device seeded 0."""
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((size, size), generator=g, device=device,
                    dtype=torch.bfloat16)
    w = torch.randn((size, size), generator=g, device=device,
                    dtype=torch.bfloat16)
    return x, w


def burn_in_answers(size: int, lengths: Iterable[int], device,
                    precision: str = "bf16") -> Dict[int, Tuple[float, float]]:
    """For each chain length n: (checksum, mass) of the state after n steps
    of acc <- bf16(p / (max|p| + 1e-6)), p = acc . w in f32.  The checksum
    is the f32 sum of the state, the program's answer; the mass is the sum
    of its magnitudes, the scale a checksum gap is measured against."""
    want = sorted(set(int(n) for n in lengths))
    out: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    if not want:
        return {}
    x, w = burn_in_inputs(size, device)
    wf = rounded(w, precision)
    acc = x
    with full_f32():
        for k in range(want[-1] + 1):
            if k in want:
                s = acc.float()
                out[k] = (s.sum(), s.abs().sum())
            if k == want[-1]:
                break
            p = rounded(acc, precision) @ wf
            acc = (p / (p.abs().max() + 1e-6)).bfloat16()
    return {k: (float(c), float(m)) for k, (c, m) in out.items()}


# --------------------------------------------------------------------------
# the memory passes: workloads.hbm_stress and microbench.hbm_probe
# --------------------------------------------------------------------------

def _memory_chain(elements: int, first, lengths: Iterable[int], device,
                  precision: str) -> Dict[int, Tuple[float, float]]:
    """For each n: (least, largest) element of a whole array of
    ``elements`` after n passes acc <- acc * 0.25 + 2.0, from 1.5 after
    ``first`` (in place)."""
    want = sorted(set(int(n) for n in lengths))
    out: Dict[int, Tuple[float, float]] = {}
    if not want:
        return out
    acc = torch.full((elements,), 1.5, dtype=ROUND_TO[precision],
                     device=device)
    first(acc)
    for k in range(want[-1] + 1):
        if k in want:
            out[k] = tuple(float(v) for v in torch.aminmax(acc.float()))
        if k < want[-1]:
            acc.mul_(0.25).add_(2.0)
    return out


def stress_answers(elements: int, lengths: Iterable[int], device,
                   precision: str = "f32") -> Dict[int, Tuple[float, float]]:
    """The stress chain (``workloads.hbm_stress``): an array of 1.5 with the
    addend 2.0; the extrema of the whole state after n passes."""
    return _memory_chain(elements, lambda acc: acc, lengths, device,
                         precision)


def triad_answers(elements: int, lengths: Iterable[int], device,
                  precision: str = "f32") -> Dict[int, Tuple[float, float]]:
    """The probe's triad chain (``microbench.hbm_probe``): the array 1.5
    after the probe's first pass with scale 3.0 and addend 2.0 (6.5), then
    n passes; the extrema of the whole state."""
    return _memory_chain(elements, lambda acc: acc.mul_(3.0).add_(2.0),
                         lengths, device, precision)


# --------------------------------------------------------------------------
# the FMA + ReLU check: microbench.vpu_probe
# --------------------------------------------------------------------------

def fma_answer(rows: int, cols: int, precision: str = "f32") -> np.ndarray:
    """max(a * b + c, 0) of the probe's inputs (NumPy's generator seeded 0,
    three standard normal f32 draws), in f64 at the stated precision; the
    control rounds the inputs to bf16 and computes in f32."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal((rows, cols), dtype=np.float32)
               for _ in range(3))
    if precision == "f32":
        a, b, c = (v.astype(np.float64) for v in (a, b, c))
        return np.maximum(a * b + c, 0.0)
    a, b, c = (rounded(torch.from_numpy(v), precision) for v in (a, b, c))
    return torch.relu(a * b + c).numpy()


# --------------------------------------------------------------------------
# the dp x tp train step of run_full_validation's slice burn-in, world 1
# --------------------------------------------------------------------------

def train_inputs(d_in: int = 128, d_hidden: int = 256, batch: int = 8
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                            torch.Tensor]:
    """Weights and batch as the program draws them: CPU generators seeded 0
    (w1, w2, scaled 1/sqrt(d_in)) and 1 (x, y)."""
    g = torch.Generator().manual_seed(0)
    scale = 1.0 / math.sqrt(d_in)
    params = {"w1": torch.randn((d_in, d_hidden), generator=g) * scale,
              "w2": torch.randn((d_hidden, d_in), generator=g) * scale}
    g = torch.Generator().manual_seed(1)
    x, y = (torch.randn((batch, d_in), generator=g) for _ in range(2))
    return params, x, y


Weights = Dict[str, torch.Tensor]


def train_answers(steps: int, precision: str = "bf16", lr: float = 1e-2,
                  **sizes) -> Tuple[Weights, List[Tuple[float, Weights]]]:
    """(start weights, [(loss, weights after the step)] per step) of the
    MLP step: operands rounded to ``precision`` (their gradients too), f32
    products, tanh, mean squared error over the batch, ``p - lr *
    round(grad)``."""
    params, x, y = train_inputs(**sizes)
    start = {k: v.clone() for k, v in params.items()}
    out = []
    with full_f32():
        for _ in range(steps):
            leaves = {k: _Round.apply(p, precision).detach().requires_grad_()
                      for k, p in params.items()}
            h = torch.tanh(rounded(x, precision) @ leaves["w1"])
            o = _Round.apply(h, precision) @ leaves["w2"]
            loss = ((o - y) ** 2).sum() / (y.shape[0] * y.shape[1])
            loss.backward()
            params = {k: p - lr * rounded(leaves[k].grad, precision)
                      for k, p in params.items()}
            out.append((float(loss.detach()), {k: v.detach().clone()
                                      for k, v in params.items()}))
    return start, out
