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

Products of any shape go through :func:`matmul_any` (zero-padded to the
kernel's tiles) and, with a gradient, :class:`MatmulBf16F32`: the
counterpart of JAX's ``jnp.dot(bf16, bf16, preferred_element_type=f32)``
and its transpose, forward and backward on the matmul kernel.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

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


# the H100 SXM's SM count: what the block rule assumes for a tensor on the
# CPU, so that the CPU pads a product as the card would
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def _cuda_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """SMs of a CUDA ``device``; :data:`H100_SMS` for the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return H100_SMS
    return _cuda_sms(torch.cuda.current_device() if device.index is None
                     else device.index)


def matmul_block(m: int, n: int, sms: int) -> int:
    """The block tile for an m x n product on a card of ``sms`` SMs: 128
    where 128-tiles alone give every SM a block, else 64 (four times the
    blocks).  Set from the H100 (132 SMs, K = m = n): block 64 took 3.19,
    4.41 and 9.71 µs at 256^2, 512^2 and 1024^2 where 128 took 5.04, 6.84
    and 10.52; at 2048^2 block 128 took 35.37 µs and 64 took 65.62
    (PERF.md §6)."""
    tiles = -(-m // 128) * -(-n // 128)
    return 128 if tiles >= sms else 64


def _round_up(x: int, to: int) -> int:
    return -(-x // to) * to


def _buffer(rows: int, cols: int, device: torch.device) -> torch.Tensor:
    """An uninitialised bf16 kernel operand (the padding is written
    explicitly)."""
    return torch.empty((rows, cols), dtype=torch.bfloat16, device=device)


def _operand(blocks: Sequence[torch.Tensor], along: int, rows: int,
             cols: int) -> torch.Tensor:
    """A contiguous bf16 ``rows`` x ``cols`` operand of the kernel:
    ``blocks`` (2-D, bf16-valued, of any float dtype and strides) laid end
    to end along dim ``along`` from the top-left corner, zeros everywhere
    else."""
    first = blocks[0]
    out = _buffer(rows, cols, first.device)
    at = 0
    for blk in blocks:
        if along == 0:
            out[at:at + blk.shape[0], :blk.shape[1]].copy_(blk)
            at += blk.shape[0]
        else:
            out[:blk.shape[0], at:at + blk.shape[1]].copy_(blk)
            at += blk.shape[1]
    r, c = (at, first.shape[1]) if along == 0 else (first.shape[0], at)
    out[r:].zero_()
    out[:r, c:].zero_()
    return out


def matmul_blocks(a_blocks: Sequence[torch.Tensor],
                  b_blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum_i A_i . B_i in f32 by ONE launch of the matmul kernel: the
    bf16-valued A_i (m x k_i) laid end to end along K against the B_i
    (k_i x n), zero-padded to the tiles — m and n to the block
    :func:`matmul_block` picks, K to the K-step (zeros add nothing, so the
    padding is exact) — and the m x n result cut out of the padded one."""
    if len(a_blocks) != len(b_blocks) or not a_blocks:
        raise ValueError("matmul_blocks: one B block per A block")
    m, n = a_blocks[0].shape[0], b_blocks[0].shape[1]
    for a, b in zip(a_blocks, b_blocks):
        if (a.dim() != 2 or b.dim() != 2 or a.shape[0] != m
                or b.shape[1] != n or a.shape[1] != b.shape[0]):
            raise ValueError(f"matmul_blocks: {tuple(a.shape)} x "
                             f"{tuple(b.shape)} in an {m} x {n} product")
    k = sum(a.shape[1] for a in a_blocks)
    if not (m and n and k):
        raise ValueError(f"matmul_blocks: empty product {m}x{k}x{n}")
    block = matmul_block(m, n, sm_count(a_blocks[0].device))
    mp, np_, kp = (_round_up(m, block), _round_up(n, block),
                   _round_up(k, DEFAULT_KSTEP))
    out = matmul_bf16_f32(_operand(a_blocks, 1, mp, kp),
                          _operand(b_blocks, 0, kp, np_), block=block)
    return out if (mp, np_) == (m, n) else out[:m, :n]


def matmul_any(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A . B in f32 for bf16-valued A (m x k) and B (k x n) of any
    positive shape, on the matmul kernel (:func:`matmul_blocks`)."""
    return matmul_blocks([a], [b])


def split_bf16x3(g: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 ``g`` as three bf16 terms with hi + mid + lo == g: each the bf16
    rounding of what the terms before it left.  Exact wherever the
    residuals stay in bf16's normal range (8 + 8 + 8 bits hold f32's 24)."""
    hi = g.bfloat16()
    rest = g - hi.float()
    mid = rest.bfloat16()
    return hi, mid, (rest - mid.float()).bfloat16()


class MatmulBf16F32(torch.autograd.Function):
    """``jnp.dot(a.astype(bf16), b.astype(bf16), preferred_element_type=
    f32)`` for bf16-valued ``a`` and ``b`` (its bf16 casts stay with the
    caller), with its gradient, every product on the matmul kernel.

    Forward: one launch.  Backward: ``g . B^T`` and ``A^T . g``, one launch
    each and only where asked.  JAX's transpose multiplies the f32
    cotangent ``g`` by the bf16 operand in f32; rounding ``g`` to bf16
    first would be another program, so ``g`` goes in as its three bf16
    terms (:func:`split_bf16x3`) laid along K against the operand stacked
    three times — bf16 x bf16 products are exact in f32, so the sum is the
    f32 x bf16 product to f32 accuracy.  The transposed operands are copied
    into the padded buffers."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return matmul_any(a, b)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        terms = split_bf16x3(g.float())
        da = (matmul_blocks(terms, [b.t()] * 3)
              if ctx.needs_input_grad[0] else None)
        db = (matmul_blocks([a.t()] * 3, terms)
              if ctx.needs_input_grad[1] else None)
        return da, db


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
