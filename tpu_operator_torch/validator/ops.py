"""The validator's hand-written CUDA kernels: wrappers, plain versions, counts.

One wrapper per kernel of ``csrc/``; each replaces a Pallas kernel of
``tpu_operator/validator/microbench.py``:

=================  ==========================  ===========================
wrapper            TPU kernel                  source
=================  ==========================  ===========================
matmul_bf16_f32    _matmul_kernel (kt=0),      csrc/matmul_bf16.cu
                   _matmul_kernel_kblocked
triad_             _make_triad_kernel          csrc/triad.cu
fma_relu           _fma_kernel                 csrc/fma_relu.cu
=================  ==========================  ===========================

Dispatch rule: a tensor on the CPU goes to the plain PyTorch version beside
the wrapper; a tensor on any other device goes to the kernel, or the wrapper
raises.  Nothing falls back.  Every wrapper checks what its kernel assumes
(device, dtype, shape, divisibility, contiguity, 16-byte alignment) on every
device, so the CPU tests reject what the card would, allocates its outputs
with ``torch.empty`` and launches on the current stream without
synchronising.  ``LAUNCHES`` counts kernel launches (never plain-version
calls), so a run can show it went through the kernels.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch

from . import _build

# kernel launches per wrapper route; kt=0 and kt>0 are counted apart because
# they replace two different TPU kernels
LAUNCHES: Dict[str, int] = {
    "matmul_bf16_f32": 0,
    "matmul_bf16_f32_kblocked": 0,
    "triad_": 0,
    "fma_relu": 0,
}

# block tile (output rows = cols per block) and K-step the matmul kernel is
# instantiated for; kt=0 means the default K-step
MATMUL_BLOCKS = (64, 128)
MATMUL_KSTEPS = (32, 64)
DEFAULT_KSTEP = 32


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """Full-f32 products for references: TF32 off for the block.  (Products
    of bf16-valued inputs are exact in TF32 too; it is set anyway so a
    reference never depends on that.)"""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# The checks below build their messages only on failure: on the card a
# wrapper's Python cost is on the path of every launch.

def _check_operands(what: str, *tensors: torch.Tensor) -> None:
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{what}: operands on {device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operand is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: operand is not 16-byte aligned")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# --------------------------------------------------------------------------
# kernels 1 and 2: tiled bf16 matmul, f32 accumulate and output
# --------------------------------------------------------------------------

def matmul_bf16_f32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: the f32 product of the bf16 inputs (a bf16 ``a @ b``
    would round the output to bf16)."""
    with no_tf32():
        return a.float() @ b.float()


def matmul_bf16_f32(a: torch.Tensor, b: torch.Tensor, kt: int = 0,
                    block: int = 128) -> torch.Tensor:
    """C = A . B for bf16 A (m x k) and B (k x n) into a new f32 C.

    ``block`` is the output tile per thread block (64 or 128); ``kt`` the
    K-step (0 for the default 32, else 32 or 64).  m and n must be positive
    multiples of ``block`` and k a positive multiple of the K-step (the
    kernel's TMA descriptors describe no empty matrix)."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("matmul_bf16_f32: 2-D operands")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError(f"matmul_bf16_f32: bf16 operands, got {a.dtype}, "
                         f"{b.dtype}")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"matmul_bf16_f32: inner dims {k} != {k2}")
    if block not in MATMUL_BLOCKS:
        raise ValueError(f"matmul_bf16_f32: block {block} not in "
                         f"{MATMUL_BLOCKS}")
    if kt and kt not in MATMUL_KSTEPS:
        raise ValueError(f"matmul_bf16_f32: kt {kt} not 0 or in "
                         f"{MATMUL_KSTEPS}")
    kstep = kt or DEFAULT_KSTEP
    if not (m and n and k) or m % block or n % block or k % kstep:
        raise ValueError(f"matmul_bf16_f32: {m}x{k}x{n} does not tile by "
                         f"block {block}, K-step {kstep}")
    _check_operands("matmul_bf16_f32", a, b)
    if a.device.type == "cpu":
        return matmul_bf16_f32_plain(a, b)
    lib = _build.load(a.device)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.tot_matmul_bf16_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                      m, n, k, block, kstep, _stream(a.device))
    _build.check(lib, err, "matmul_bf16_f32")
    LAUNCHES["matmul_bf16_f32_kblocked" if kt else "matmul_bf16_f32"] += 1
    return out


# --------------------------------------------------------------------------
# kernel 3: in-place STREAM triad
# --------------------------------------------------------------------------

def triad_plain_(a: torch.Tensor, b: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """Plain version: a = a * scale + b in place (two roundings)."""
    return a.mul_(scale).add_(b)


# float4s of each array every thread of the triad kernel loads before it
# stores (csrc/triad.cu's VECTORS; its entry point refuses a grid planned
# with any other value)
TRIAD_VECTORS = 4


def _triad_plan(numel: int, threads: int) -> int:
    """Blocks of ``threads`` the triad kernel launches for ``numel`` f32 (a
    positive multiple of 4): block k moves the float4s from k * threads *
    TRIAD_VECTORS on, thread t of it the float4s t, t + threads, ... (one per
    vector); the last block stops at the end of the array."""
    if numel <= 0 or numel % 4:
        raise ValueError(f"triad plan: {numel} elements")
    return -(-(numel // 4) // (threads * TRIAD_VECTORS))


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two contiguous operands share memory (a meta tensor holds
    none)."""
    if a.is_meta or not a.numel():
        return False
    pa, pb = a.data_ptr(), b.data_ptr()
    nbytes = a.numel() * a.element_size()
    return pa < pb + nbytes and pb < pa + nbytes


def triad_(a: torch.Tensor, b: torch.Tensor, scale: float,
           threads: int = 256) -> torch.Tensor:
    """a = a * scale + b over f32, written IN PLACE into ``a``'s storage
    (returned); ``b`` must not share memory with ``a``.  ``threads`` per
    block: a multiple of 32 dividing 2048."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"triad_: f32 operands, got {a.dtype}, {b.dtype}")
    if a.shape != b.shape:
        raise ValueError(f"triad_: shapes {a.shape} != {b.shape}")
    if a.numel() % 4:
        raise ValueError(f"triad_: {a.numel()} elements, not a multiple of 4")
    if threads % 32 or not 0 < threads <= 1024 or 2048 % threads:
        raise ValueError(f"triad_: {threads} threads per block")
    _check_operands("triad_", a, b)
    if _overlap(a, b):
        # the kernel reads b through the read-only path while it writes a
        raise ValueError("triad_: b shares memory with a")
    if a.device.type == "cpu":
        return triad_plain_(a, b, scale)
    lib = _build.load(a.device)
    if a.numel() == 0:
        return a                        # nothing to launch
    with torch.cuda.device(a.device):
        err = lib.tot_triad_inplace(a.data_ptr(), b.data_ptr(), float(scale),
                                    a.numel(), _triad_plan(a.numel(), threads),
                                    threads, _stream(a.device))
    _build.check(lib, err, "triad_")
    LAUNCHES["triad_"] += 1
    return a


# --------------------------------------------------------------------------
# kernel 4: fused multiply-add + ReLU
# --------------------------------------------------------------------------

def fma_relu_plain(a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """Plain version: max(a * b + c, 0)."""
    return torch.relu(a * b + c)


def fma_relu(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """max(a * b + c, 0) over f32 into a new tensor."""
    if not a.dtype == b.dtype == c.dtype == torch.float32:
        raise ValueError("fma_relu: f32 operands")
    if not a.shape == b.shape == c.shape:
        raise ValueError(f"fma_relu: shapes {a.shape}, {b.shape}, {c.shape}")
    if a.numel() % 4:
        raise ValueError(f"fma_relu: {a.numel()} elements, not a multiple "
                         "of 4")
    _check_operands("fma_relu", a, b, c)
    if a.device.type == "cpu":
        return fma_relu_plain(a, b, c)
    lib = _build.load(a.device)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = lib.tot_fma_relu(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                               out.data_ptr(), a.numel(), _stream(a.device))
    _build.check(lib, err, "fma_relu")
    LAUNCHES["fma_relu"] += 1
    return out
