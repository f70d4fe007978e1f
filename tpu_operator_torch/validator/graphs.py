"""The validator's chains replayed as CUDA graphs — the counterpart of the
JAX package's one-dispatch chains (``lax.fori_loop`` under ``jax.jit``:
``_matmul_chain`` and ``_triad_chain`` in ``tpu_operator/validator/
microbench.py``, ``_burn_in_fn`` and the triad chains in its
``workloads.py``).

A chain is ``n`` applications of one ``step`` to a state tensor.  On the
card each step launches a few kernels, and launched one by one from Python
a chain measures the host.  :class:`ChainGraphs` captures a *unit* of
:data:`UNIT` steps once per key (the caller's key names the step and the
tensors it closes over; the state's shape, dtype and device are added) and
replays it:

* the unit works on a static state buffer owned by the instance: the chain
  copies its start value in, the captured steps read it, and the unit's
  last step is copied back into it, so every replay starts where the last
  one ended at the same addresses (the matmul's TMA tensor maps are
  captured by value);
* a chain of ``n`` steps replays the unit ``n // UNIT`` times, then runs
  the remaining ``n % UNIT`` steps eagerly from the static buffer, so the
  result for every ``n`` is the eager chain's bit for bit;
* the kernel wrappers count their launches in Python (``ops.LAUNCHES``):
  the counts a capture adds are taken back, since a capture launches
  nothing, and each replay adds them once.  Before its first capture a unit
  runs one step eagerly on its buffer to load the kernels it will record
  (the library and each kernel module are loaded on first launch); that
  step launches and is counted, and its result is overwritten by the
  chain's start value;
* :meth:`ChainGraphs.close` releases every graph, its private memory pool
  and the static buffers, so what comes after the probe or burn-in has
  the memory back.

There is no fallback: a failed capture or replay raises.  The chains'
callers route only CUDA tensors here; on the CPU they stay eager.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

from . import ops

# steps per captured unit
UNIT = 16

Step = Callable[[torch.Tensor], torch.Tensor]


def _record(graph: "torch.cuda.CUDAGraph", body: Callable[[], None]) -> None:
    """Capture the launches ``body`` makes on the current device into
    ``graph``; nothing runs.  Other threads' CUDA calls are not barred while
    it records (the operator process has threads of its own)."""
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        body()


@dataclasses.dataclass
class _Unit:
    state: torch.Tensor                     # the static buffer
    graph: Optional["torch.cuda.CUDAGraph"] = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


class ChainGraphs:
    """Captured units of chain steps, one per key, held until
    :meth:`close` (or the end of a ``with`` block)."""

    def __init__(self) -> None:
        self._units: Dict[Tuple, _Unit] = {}

    def __enter__(self) -> "ChainGraphs":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def plan(self, n: int) -> Tuple[int, int]:
        """(replays of the unit, eager steps after them) for ``n`` steps."""
        if n < 0:
            raise ValueError(f"chain of {n} steps")
        return divmod(n, UNIT)

    def run(self, key: Hashable, step: Step, init: torch.Tensor,
            n: int) -> torch.Tensor:
        """The state after ``n`` steps from ``init`` (left intact).  The
        result may be the unit's static buffer, which the next run of the
        same key overwrites: read it before then."""
        replays, rest = self.plan(n)
        full_key = (key, tuple(init.shape), init.dtype, init.device)
        unit = self._units.get(full_key)
        if unit is None:
            unit = self._units[full_key] = _Unit(torch.empty_like(init))
        if replays and unit.graph is None:
            self._capture(unit, step, init)
        unit.state.copy_(init)
        for _ in range(replays):
            unit.graph.replay()
            for name, count in unit.launches.items():
                ops.LAUNCHES[name] += count
        state = unit.state
        for _ in range(rest):
            state = step(state)
        return state

    def _capture(self, unit: _Unit, step: Step, init: torch.Tensor) -> None:
        unit.state.copy_(init)
        step(unit.state)                    # loads the kernels; counted

        def body() -> None:
            state = unit.state
            for _ in range(UNIT):
                state = step(state)
            if state is not unit.state:
                unit.state.copy_(state)

        graph = torch.cuda.CUDAGraph()
        before = dict(ops.LAUNCHES)
        try:
            _record(graph, body)
        finally:
            unit.launches = {name: ops.LAUNCHES[name] - before.get(name, 0)
                             for name in ops.LAUNCHES}
            ops.LAUNCHES.update(before)
        unit.graph = graph

    def close(self) -> None:
        """Release every graph, its memory pool and the static buffers."""
        captured = False
        for unit in self._units.values():
            if unit.graph is not None:
                unit.graph.reset()
                captured = True
        self._units.clear()
        if captured:
            # the pools' blocks go back to the device, not only to the
            # caching allocator
            torch.cuda.empty_cache()


def chain(graphs: Optional[ChainGraphs], key: Hashable, step: Step,
          init: torch.Tensor, n: int) -> torch.Tensor:
    """``graphs.run(...)``, or through a :class:`ChainGraphs` of its own,
    released before it returns, where the caller holds none."""
    if graphs is not None:
        return graphs.run(key, step, init, n)
    with ChainGraphs() as own:
        return own.run(key, step, init, n)
