"""``BENCHMARK.json`` and the files it names, found by name.

* a cell's configuration: the ``file`` its configuration entry names
  (``configs/<name>.json``);
* a cell's traffic mix: ``mixes/<traffic>.json``, data read by ``cell``;
* each entry a mix's calls name: ``entries/<entry>.py`` (``cell``);
* each kind of answer the configuration says the calls compute:
  ``kinds/<kind>.py`` (``compare``);
* a metric's reader: ``metrics/<name>.py``, a module with ``UNIT``,
  ``BETTER`` and ``read(obs)``, which returns the metric's value or None
  where the run has nothing for it to read.

Nothing here knows a cell, a mix, an entry, a kind or a metric by name: a
new one is new files and new entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, Iterable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class ManifestError(RuntimeError):
    pass


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise ManifestError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise ManifestError(f"no config {name!r} in BENCHMARK.json")


def mix(traffic: str, root: Path = ROOT) -> dict:
    path = root / "gpubench" / "mixes" / f"{traffic}.json"
    if not path.exists():
        raise ManifestError(f"no traffic mix {path}")
    with open(path) as f:
        return json.load(f)


def metrics(manifest: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    with ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    entries = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in entries
            if workload in m.get("workloads", [workload])]


def module(folder: str, name: str, root: Path = ROOT):
    """The module ``gpubench/<folder>/<name>.py``."""
    path = root / "gpubench" / folder / f"{name}.py"
    if not path.exists():
        raise ManifestError(f"no {folder[:-1]} {path}")
    spec = importlib.util.spec_from_file_location(
        f"gpubench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    loaded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loaded)
    return loaded


def reader(name: str, root: Path = ROOT):
    """The reader module of metric ``name``."""
    return module("metrics", name, root)


def readers(entries: List[dict], root: Path = ROOT) -> Dict[str, object]:
    return {m["name"]: reader(m["name"], root) for m in entries}


def entries(mix: dict, root: Path = ROOT) -> Dict[str, object]:
    """The entry module of every call of ``mix``."""
    return {name: module("entries", name, root)
            for name in dict.fromkeys(c["entry"] for c in mix["calls"])}


def kinds(names: Iterable[str], root: Path = ROOT) -> Dict[str, object]:
    """The module of every kind of answer in ``names``."""
    return {name: module("kinds", name, root) for name in sorted(names)}
