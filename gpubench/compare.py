"""The comparison that decides ``correct``.

Every answer the timed passes computed (``taps.Answer``) is compared with
the plain reference's answer for the same work (``reference/``), after
the window has closed.  Each kind of answer is a module
``kinds/<kind>.py``, found by name, that says how: ``install(taps)``
(the taps that record its answers), ``reference(size, lengths, device,
precision)``, ``gaps(answer, want)`` (the numbers compared),
``control(want)`` (the reference's answer in the program's place),
``least_s(answer)`` (its roofline), ``numbers(sizes)`` (the names it
compares), the precisions ``STATED`` and ``CONTROL``, and ``CHAIN``
(a traced chain call launches at least one kernel a step).

Besides the kinds' numbers, each against a limit of its own from the
configuration's ``limits``:

* ``failed_passes``: passes whose verdict was not the healthy one;
* ``answers_off_config``: answers of a kind or size the configuration does
  not name, and named ones some pass never gave;
* ``short_chain_calls`` (``--trace 1`` only): traced chain calls that
  launched fewer kernels on the card than their steps, or that the trace
  and the taps do not both see.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Set, Tuple

from .taps import Answer


def expected(config: dict, mix: dict, entries: Dict[str, object]
             ) -> Dict[str, Set[int]]:
    """kind -> the sizes the configuration says the mix's calls compute."""
    out: Dict[str, Set[int]] = {}
    for call in mix["calls"]:
        table = entries[call["entry"]].answers(config, call)
        for kind, sizes in table.items():
            out.setdefault(kind, set()).update(sizes)
    return out


def off_config(answers: List[Answer], want: Dict[str, Set[int]],
               passes: Iterable[int]) -> int:
    """Answers of a kind or size not named, and named ones a pass lacks."""
    given = {(a.pass_index, a.kind, a.size) for a in answers}
    stray = sum(1 for a in answers if a.size not in want.get(a.kind, ()))
    lacking = sum(1 for p in passes for kind, sizes in want.items()
                  for s in sizes if (p, kind, s) not in given)
    return stray + lacking


def reference_answers(answers: List[Answer], kinds: Dict[str, object],
                      device, control: bool = False) -> Dict[Tuple, object]:
    """The reference's answer for every (kind, size, steps) among
    ``answers``, at each kind's stated precision (its ``CONTROL`` one with
    ``control``)."""
    out: Dict[Tuple, object] = {}
    for kind, size in sorted({(a.kind, a.size) for a in answers}):
        module = kinds[kind]
        lengths = {a.steps for a in answers
                   if a.kind == kind and a.size == size}
        precision = module.CONTROL if control else module.STATED
        for n, v in module.reference(size, lengths, device,
                                     precision).items():
            out[(kind, size, n)] = v
    return out


def gaps(answers: List[Answer], want: Dict[Tuple, object],
         kinds: Dict[str, object]) -> Dict[str, float]:
    """Each number compared, the worst over the answers, from the
    program's answers and the reference's."""
    out: Dict[str, float] = {}
    for a in answers:
        for name, gap in kinds[a.kind].gaps(
                a, want[(a.kind, a.size, a.steps)]).items():
            out[name] = max(out.get(name, 0.0), gap)
    return {k: (v if math.isfinite(v) else float("inf"))
            for k, v in out.items()}


def control_answers(answers: List[Answer], want: Dict[Tuple, object],
                    kinds: Dict[str, object]) -> List[Answer]:
    """The control in the program's place: the same work's answers from the
    reference one precision below (``want`` computed with ``control``)."""
    return [Answer(a.kind, a.size, a.steps,
                   kinds[a.kind].control(want[(a.kind, a.size, a.steps)]),
                   a.t0, a.t1, a.pass_index) for a in answers]


def short_chains(answers: List[Answer], launches: Dict[str, List[int]],
                 traced: Set[int], kinds: Dict[str, object]
                 ) -> List[Tuple[str, int, object]]:
    """(kind, steps, kernels) of each traced chain call that launched fewer
    kernels than its steps, and of each call that the taps or the trace
    saw and the other did not (steps or kernels None).  ``launches``: kind
    -> kernels launched inside each traced call's mark, in the order the
    calls began."""
    short: List[Tuple[str, int, object]] = []
    for kind, module in kinds.items():
        if not module.CHAIN:
            continue
        calls = sorted((a for a in answers
                        if a.kind == kind and a.pass_index in traced),
                       key=lambda a: a.t0)
        seen = launches.get(kind, [])
        short += [(kind, a.steps, n) for a, n in zip(calls, seen)
                  if n < a.steps]
        short += [(kind, a.steps, None) for a in calls[len(seen):]]
        short += [(kind, None, n) for n in seen[len(calls):]]
    return short


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(correct, [(name, number, limit)]): every number within its limit;
    a number with no limit fails."""
    rows = [(name, value, float(limits.get(name, float("nan"))))
            for name, value in sorted(numbers.items())]
    ok = all(value <= limit for _, value, limit in rows)
    return ok, rows
