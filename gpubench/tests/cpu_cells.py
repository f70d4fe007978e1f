"""Cells of the benchmark at sizes the CPU holds, for the tests.

:func:`small_root` writes a checkout-shaped directory that holds only a
``BENCHMARK.json``, configurations of its own, and the real mixes,
entries, kinds of answer and metric readers, so a test adds cells from
files alone.  Each configuration's CPU copy follows one rule: where
``tests/cpu_configs/<configuration>.json`` exists, it gives the copy's
name and the answer tables at the sizes the CPU path computes, and the
copy takes the limits the test passes; a configuration without one is
copied as it is, under its own name, and its cells are left to tests of
their own.  :func:`shrink`
makes the program's burn-in and stress run at small sizes on the CPU (the
kernels' plain versions), as the card's sizes would take minutes there.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from gpubench.manifest import HERE

# the CPU path's sizes: burn-in 64^2 (torch) and 128^2 (full chain); the
# stress at 1 MiB; the probes at microbench's clamped CPU sizes
BURN_IN_TORCH, BURN_IN_FULL, STRESS_MIB = 64, 128, 1
STRESS_ELEMENTS = STRESS_MIB * 1024 * 1024 // 4
MXU_CPU, TRIAD_CPU, FMA = 256, 1024 * 1024 // 4, 512 * 512


def shrink(monkeypatch) -> None:
    from tpu_operator_torch.validator import workloads

    burn_in, stress = workloads.matmul_burn_in, workloads.hbm_stress

    def small_burn_in(size=1024, iters=8, seed=0, device="cuda"):
        small = BURN_IN_TORCH if size == 512 else BURN_IN_FULL
        return burn_in(size=small, iters=iters, seed=seed, device=device)

    def small_stress(mib=256, iters=4, device="cuda"):
        return stress(mib=STRESS_MIB, iters=iters, device=device)

    monkeypatch.setattr(workloads, "matmul_burn_in", small_burn_in)
    monkeypatch.setattr(workloads, "hbm_stress", small_stress)
    # one escalation level: the CPU's chains clear a short window at once
    monkeypatch.setattr(workloads, "_MIN_MARGINAL_WINDOW_S", 1e-4)


def _cpu_copy(config: dict, cpu: dict) -> dict:
    """``config`` with the CPU copy's ``name`` and each ``answers`` table of
    ``cpu`` in place of its own (a component's, or a top-level group's)."""
    config["name"] = cpu["name"]
    for key, table in cpu["answers"].items():
        target = (config["components"][key] if key in config["components"]
                  else config[key]) if "components" in config else config[key]
        target["answers"] = table
    return config


def small_root(tmp: Path, limits: dict, source: Path = HERE.parent) -> Path:
    """A checkout-shaped directory with the cells of ``source`` (a
    checkout) at CPU sizes."""
    root = tmp / "checkout"
    (root / "gpubench").mkdir(parents=True)
    for folder in ("metrics", "mixes", "entries", "kinds"):
        shutil.copytree(source / "gpubench" / folder,
                        root / "gpubench" / folder,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (root / "gpubench" / "configs").mkdir()
    with open(source / "BENCHMARK.json") as f:
        bench = json.load(f)
    names = {}
    for c in bench["configs"]:
        with open(source / c["file"]) as f:
            config = json.load(f)
        name = c["name"]
        cpu = source / "gpubench" / "tests" / "cpu_configs" / f"{name}.json"
        if cpu.exists():
            with open(cpu) as f:
                config = _cpu_copy(config, json.load(f))
            config["limits"] = dict(limits)
            name = config["name"]
        names[c["name"]] = c["name"] = name
        c["file"] = f"gpubench/configs/{name}.json"
        with open(root / c["file"], "w") as f:
            json.dump(config, f)
    for w in bench["workloads"]:
        w["config"] = names[w["config"]]
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return root
