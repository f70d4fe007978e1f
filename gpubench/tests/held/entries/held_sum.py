"""A test-only mix call ``{"entry": "held_sum"}``, with optionally
``"fault"``, ``"rank"`` and ``"from_call"``: the configuration's
``held.function`` run on ranks held for the run (``gpubench.ranks``), with
the fault planted on that rank from that call of the run on (the untimed
pass's is call 0).  A call whose ranks fail raises
:class:`gpubench.ranks.RanksError`, which ends the run.

The objects: the held ranks, opened once; where the configuration names a
``held.pid_file``, the process ids of the children, the forkserver and
the resource tracker are written there, so that a test can see them gone.
"""

import json
from multiprocessing import forkserver, resource_tracker
from pathlib import Path

from gpubench.ranks import Ranks


def open(cell):
    held = cell.config["held"]
    ranks = Ranks(held["ranks"], cell.device, [held["function"]]).open()
    if held.get("pid_file"):
        Path(held["pid_file"]).write_text(json.dumps({
            "children": ranks.pids,
            "servers": [forkserver._forkserver._forkserver_pid,
                        resource_tracker._resource_tracker._pid]}))
    return {"ranks": ranks, "calls": 0}


def close(cell, objects) -> None:
    objects["ranks"].close()


def answers(config, call):
    return config["held"]["answers"]


def peaks(cell, objects):
    return objects["ranks"].peaks()


def run(cell, objects, call, result) -> str:
    held = cell.config["held"]
    fault = None
    if "fault" in call and objects["calls"] >= call.get("from_call", 0):
        fault = [call["fault"], call["rank"]]
    objects["calls"] += 1
    objects["ranks"].run(held["function"], held["size"], fault)
    return ""
