"""The triad kernel's launch plan (``ops._triad_plan``) and operand checks,
on the CPU.

The kernel (``tpu_operator_torch/csrc/triad.cu``) runs only on the card; what
surrounds it is this plan: a flat grid of blocks of ``threads``, each block
moving ``threads * ops.TRIAD_VECTORS`` float4s of each array.  A plan whose
blocks left a gap, overlapped, or moved a byte count that is not a multiple
of 16 would leave part of ``a`` unwritten or fault, so each is checked here
for every block size the wrapper accepts.  The kernel holds its loads in
registers, not in shared memory (no ring to fit): chip_smoke.py requires
ptxas to report no spills for it.
"""

import pytest
import torch

from tpu_operator_torch.validator import ops

# every threads value ops.triad_ accepts: a multiple of 32 dividing 2048
THREADS = [t for t in range(32, 1025, 32) if 2048 % t == 0]
SIZES = [4, 4096, 32768 * 2048, 32768 * 2048 + 4, 3 * 4099 * 4]


def test_threads_are_what_the_wrapper_accepts():
    assert THREADS == [32, 64, 128, 256, 512, 1024]


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("numel", SIZES)
def test_plan_tiles_the_array_in_16_byte_blocks(numel, threads):
    blocks = ops._triad_plan(numel, threads)
    assert ops.TRIAD_VECTORS >= 2                  # loads in flight per thread
    assert 0 < blocks < 2 ** 31                    # a grid's x dimension

    span = 4 * threads * ops.TRIAD_VECTORS         # elements per block
    covered = 0                                    # next element not yet covered
    for block in range(blocks):
        first = block * span
        count = min(span, numel - first)
        assert first == covered, block             # no gap, no overlap
        assert count > 0                           # no block is launched idle
        assert (4 * first) % 16 == 0 and (4 * count) % 16 == 0
        covered += count
    assert covered == numel


def test_plan_at_the_probe_size():
    """The probe's 32768 x 2048 at its default 256 threads: 16384 blocks of
    16 KiB of each array."""
    assert ops.TRIAD_VECTORS == 4
    assert ops._triad_plan(32768 * 2048, 256) == 16384
    # one element more takes one block more, for its last float4
    assert ops._triad_plan(32768 * 2048 + 4, 256) == 16385


@pytest.mark.parametrize("numel", [0, 6, -4])
def test_plan_refuses_what_the_kernel_cannot_take(numel):
    with pytest.raises(ValueError, match="triad plan"):
        ops._triad_plan(numel, 256)


def _views(kind):
    """(a, b) of 4096 f32 each, both 16-byte aligned, laid out as ``kind``."""
    base = torch.zeros(8192)
    return {"same": (base[:4096], base[:4096]),
            "b-ahead": (base[:4096], base[4:4100]),
            "b-behind": (base[4:4100], base[:4096]),
            "b-is-a": (base[:4096],) * 2}[kind]


@pytest.mark.parametrize("kind", ["same", "b-ahead", "b-behind", "b-is-a"])
def test_triad_refuses_b_sharing_memory_with_a(kind):
    """The kernel reads b through the read-only path while it writes a, so
    operands that share memory are refused on every device."""
    a, b = _views(kind)
    with pytest.raises(ValueError, match="shares memory"):
        ops.triad_(a, b, 1.0)


def test_triad_takes_adjacent_operands():
    base = torch.arange(8192, dtype=torch.float32)
    a, b = base[:4096], base[4096:]
    want = a * 3.0 + b
    out = ops.triad_(a, b, 3.0)
    assert out.data_ptr() == base.data_ptr()
    assert torch.equal(out, want)
    assert torch.equal(b, torch.arange(4096, 8192, dtype=torch.float32))
