"""A mix's call ``{"entry": "component", "component": <name>}``: the card
work of one init container of the validator chain,
``components.run_component(name, ctx)``.  Then the status files the
configuration names for that component (``status_files``) must be there
and, where it names a report, every ``*_ok`` in it ``true``.  A call that
raises the program's ``ValidationError`` fails its pass.

The objects, made once for the run: a status directory under ``TMPDIR``
and the ``Context`` the components write their verdicts through.
"""

import os
import shutil
import tempfile

from gpubench.cell import read_status


def open(cell):
    from tpu_operator_torch.validator import components

    status_dir = tempfile.mkdtemp(prefix="gpubench-status-")
    return {"components": components, "status_dir": status_dir,
            "ctx": components.Context(status_dir=status_dir,
                                      device=cell.device)}


def close(cell, objects) -> None:
    shutil.rmtree(objects["status_dir"], ignore_errors=True)


def answers(config, call):
    return config["components"][call["component"]]["answers"]


def run(cell, objects, call, result) -> str:
    name, components = call["component"], objects["components"]
    try:
        components.run_component(name, objects["ctx"])
    except components.ValidationError as e:
        return f"{name}: {e}"
    want = cell.config["components"][name]
    for ready in want["status_files"]:
        if read_status(os.path.join(objects["status_dir"], ready)) is None:
            return f"{name}: no {ready}"
    report_name = want.get("report")
    if report_name:
        report = read_status(os.path.join(objects["status_dir"],
                                          report_name))
        if report is None:
            return f"{name}: no {report_name}"
        result.reports[report_name] = report
        bad = [k for k, v in report.items()
               if k.endswith("_ok") and v != "true"]
        if bad or not any(k.endswith("_ok") for k in report):
            return f"{name}: {report_name} {report}"
    return ""
