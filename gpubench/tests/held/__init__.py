"""Test-only work for ranks held for the run (``gpubench.ranks``): a
seeded all-reduce, the functions the held ranks run, and the files of a
cell that drives it through the harness (``configs/``, ``mixes/``,
``entries/``, ``kinds/``, copied into a small root by the tests; none is
listed in ``BENCHMARK.json``).

Each rank sums a vector of its own, drawn from a fixed seed and its rank,
over the group; the kind ``held_sum`` compares rank 0's sum with a plain
``torch`` sum of the same vectors.  A fault, where one is asked for, is
planted on one rank under the all-reduce: an element altered (``error``),
an exception (``raise``), the process killed (``die``) or an empty module
named ``jax`` put in its ``sys.modules`` (``jax``), as a rank that loaded
JAX would hold.
"""

import os
import signal
import sys
import types

import torch
import torch.distributed as dist

SEED = 20260
FUNCTION = "gpubench.tests.held:allreduce_sum"


def rank_input(size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s vector, on the CPU."""
    g = torch.Generator().manual_seed(SEED * 1000 + rank)
    return torch.randn(size, generator=g)


def allreduce_sum(size: int, fault=None) -> torch.Tensor:
    """The sum of every rank's vector, on this rank's device.  ``fault``:
    None, or ``[kind, rank]`` to plant one on that rank."""
    rank = dist.get_rank()
    x = rank_input(size, rank)
    if fault == ["error", rank]:
        x[size // 2] += 1.0
    elif fault == ["raise", rank]:
        raise RuntimeError(f"a fault planted on rank {rank}")
    elif fault == ["die", rank]:
        os.kill(os.getpid(), signal.SIGKILL)
    elif fault == ["jax", rank]:
        sys.modules.setdefault("jax", types.ModuleType("jax"))
    if dist.get_backend() == "nccl":
        x = x.to(torch.device("cuda", torch.cuda.current_device()))
    dist.all_reduce(x)
    return x


def allocate(mib_per_rank: int) -> int:
    """(rank + 1) x ``mib_per_rank`` MiB held on this rank's card for the
    call, so that each card's peak differs; the bytes allocated."""
    rank = dist.get_rank()
    n = (rank + 1) * mib_per_rank * 1024 * 1024
    buf = torch.empty(n, dtype=torch.uint8,
                      device=torch.device("cuda", torch.cuda.current_device()))
    buf.fill_(1)
    torch.cuda.synchronize()
    del buf
    return n
