"""What the benchmark reads of the program while its passes run.

The taps wrap functions of the port for the length of a run, from the
benchmark's side, and leave their behaviour as it is: each wrapper calls
the original with the same arguments and returns what it returned.  Which
functions are wrapped is not written here: each kind of answer
(``kinds/<kind>.py``) installs the taps that record its answers, and a
configuration's ``spans`` name the functions timed as spans.  This module
holds the wrappers they use:

* :meth:`Taps.chain`: a chain call (a state, a length); it records the
  chain's length, its size and the answer, and marks the call for
  ``torch.profiler`` as ``gpubench.chain.<kind>``;
* :meth:`Taps.chain_state`: a chain's step, or the function that runs its
  steps; it keeps the tensor returned last, the chain's whole state, so
  that the chain's answer can be the extrema of all of it and not only of
  what the program returns;
* :meth:`Taps.span`: host time inside a call, marked ``gpubench.<name>``;
* :meth:`Taps.record`: an answer a kind's own wrapper made.

A wrapper adds a clock read and a list append per call (a few per chain of
thousands of steps); a step wrapper an assignment per step.  Chains' answers
stay on the card as the program left them (a scalar, or the state's
extrema, one reduction launched after the chain's mark closes, with no
buffer of the state's size); :func:`hold_values` moves them to the host
once the window has closed.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import inspect
import time
from typing import Any, Callable, List, Optional

import torch
from torch.profiler import record_function


@dataclasses.dataclass
class Answer:
    """One answer a pass computed: ``kind`` of work, its ``size`` (the
    burn-in's n of n x n; elements of a memory chain or of the FMA; rows of
    the train step's batch), its ``steps`` (the chain's length; train
    steps), the program's ``value`` and the host span of the call."""
    kind: str
    size: int
    steps: int
    value: Any
    t0: float
    t1: float
    pass_index: int


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    pass_index: int


def whole_extrema(state: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[min, max] of a chain's whole state (None where none was seen)."""
    return None if state is None else torch.stack(torch.aminmax(state))


class Taps:
    """Wrappers on the program's functions, installed by :meth:`patch` and
    taken off by :meth:`remove`."""

    def __init__(self) -> None:
        self.answers: List[Answer] = []
        self.spans: List[Span] = []
        self.pass_index = -1
        self._undo: List[tuple] = []
        self._open_chain: Optional[str] = None
        self._state: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    def patch(self, target: str, make: Callable) -> None:
        """Wrap ``target`` (``package.module:function``) with
        ``make(original)`` until :meth:`remove`."""
        module_name, _, name = target.partition(":")
        module = importlib.import_module(module_name)
        original = getattr(module, name)
        if getattr(original, "gpubench_tap", False):
            # a name bound to another tap: each call would be seen twice
            raise RuntimeError(f"{target} is a tap already")
        wrapper = functools.wraps(original)(make(original))
        wrapper.gpubench_tap = True
        self._undo.append((module, name, original))
        setattr(module, name, wrapper)

    def remove(self) -> None:
        for module, name, original in reversed(self._undo):
            setattr(module, name, original)
        self._undo.clear()

    def clear(self) -> None:
        self.answers.clear()
        self.spans.clear()

    def record(self, kind: str, size: int, steps: int, value: Any,
               t0: float, t1: float) -> Answer:
        answer = Answer(kind, int(size), int(steps), value, t0, t1,
                        self.pass_index)
        self.answers.append(answer)
        return answer

    # ------------------------------------------------------------------
    def chain(self, kind: str, state: str, length: str,
              size: Callable[[torch.Tensor], int],
              whole: bool = False) -> Callable:
        """A chain call whose start is argument ``state`` and whose length
        is argument ``length``.  Its answer is what the call returned, or,
        with ``whole``, :func:`whole_extrema` of the state returned last
        inside it (the kind installs :meth:`chain_state`)."""
        def make(original):
            sig = inspect.signature(original)

            def call(*args, **kwargs):
                bound = sig.bind(*args, **kwargs)
                start, n = bound.arguments[state], bound.arguments[length]
                self._open_chain, self._state = kind, None
                t0 = time.perf_counter()
                try:
                    with record_function(f"gpubench.chain.{kind}"):
                        value = original(*args, **kwargs)
                finally:
                    self._open_chain = None
                t1 = time.perf_counter()
                # launched after the chain's mark, so the roofline's device
                # seconds leave it out
                answer = whole_extrema(self._state) if whole else value
                self._state = None
                self.record(kind, size(start), n, answer, t0, t1)
                return value
            return call
        return make

    def chain_state(self, kind: str) -> Callable:
        """A chain's step, or the function that runs a chain's steps
        (``graphs.chain``, which replays captured steps without calling
        them): while a ``kind`` chain is open, the tensor it returns is
        kept as that chain's state."""
        def make(original):
            def call(*args, **kwargs):
                out = original(*args, **kwargs)
                if self._open_chain == kind:
                    self._state = out
                return out
            return call
        return make

    def span(self, name: str) -> Callable:
        def make(original):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    with record_function(f"gpubench.{name}"):
                        return original(*args, **kwargs)
                finally:
                    self.spans.append(Span(name, t0, time.perf_counter(),
                                           self.pass_index))
            return call
        return make


def host(v):
    """``v`` with every tensor in it copied to the host."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu")
    if isinstance(v, dict):
        return {k: host(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(host(x) for x in v)
    return v


def hold_values(answers: List[Answer]) -> None:
    """Move every answer's value to the host (after the window: the program
    has finished with them), so that the program's tensors can go."""
    for a in answers:
        a.value = host(a.value)
