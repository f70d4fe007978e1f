"""A cell's system under test: the objects a configuration needs, and one
pass of its traffic mix.

A mix (``mixes/<name>.json``) is data: the calls one pass makes, in order,
as a node's init containers make them.  Each call names an ``entry``, a
module ``entries/<entry>.py`` found by name, with

* ``open(cell)``: the objects the entry needs for the run (made once,
  before the untimed pass), and ``close(cell, objects)``;
* ``run(cell, objects, call, result)``: the call, then its verdict: ""
  where it is the healthy one, else why not (the pass fails);
* ``answers(config, call)``: kind -> the sizes the configuration says the
  call computes (``compare.expected``);
* optionally ``peaks(cell, objects)``: the memory peak of each card the
  entry's objects hold ranks on, card 0 first (``ranks.Ranks.peaks``), for
  a cell over several cards.

This module is the one generator that reads every mix: a new mix is a new
data file, and a new kind of call a new entry file.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


def read_status(path: str) -> Optional[Dict[str, str]]:
    """A status file's key=value lines, or None where it is absent."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except FileNotFoundError:
        return None
    return dict(line.partition("=")[::2] for line in lines if "=" in line)


@dataclasses.dataclass
class PassResult:
    ok: bool
    detail: str = ""
    reports: Dict[str, Dict[str, str]] = dataclasses.field(
        default_factory=dict)


class Cell:
    """The objects one configuration and mix need, made by :meth:`open`
    and released by :meth:`close`."""

    def __init__(self, config: dict, mix: dict, device: str,
                 entries: Dict[str, object]) -> None:
        self.config, self.mix, self.device = config, mix, device
        self.calls: List[dict] = mix["calls"]
        self.entries = entries
        self.objects: Dict[str, object] = {}

    def open(self) -> "Cell":
        try:
            for call in self.calls:
                name = call["entry"]
                if name not in self.objects:
                    self.objects[name] = self.entries[name].open(self)
        except BaseException:
            # what the entries opened first (ranks held on other cards)
            self.close()
            raise
        return self

    def close(self) -> None:
        for name in reversed(list(self.objects)):
            self.entries[name].close(self, self.objects.pop(name))

    def peaks(self) -> List[int]:
        """Each card's memory peak, card 0 first, as the first entry that
        reports peaks reads them; [] where none does, as in a cell on one
        card."""
        for name, objects in self.objects.items():
            read = getattr(self.entries[name], "peaks", None)
            if read is not None:
                return list(read(self, objects))
        return []

    def run_pass(self) -> PassResult:
        result = PassResult(True)
        for call in self.calls:
            name = call["entry"]
            why = self.entries[name].run(self, self.objects[name], call,
                                         result)
            if why:
                result.ok = False
                result.detail += why + "; "
        return result
