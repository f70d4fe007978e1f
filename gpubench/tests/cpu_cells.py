"""Cells of the benchmark at sizes the CPU holds, for the tests.

:func:`small_root` writes a checkout-shaped directory that holds only a
``BENCHMARK.json``, configurations of its own, and the real mixes,
entries, kinds of answer and metric readers, so a test adds cells from
files alone.  :func:`shrink`
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


def _config(name: str, real: str, answers: dict) -> dict:
    with open(HERE / "configs" / f"{real}.json") as f:
        config = json.load(f)
    config["name"] = name
    for key, table in answers.items():
        target = (config["components"][key] if key in config["components"]
                  else config[key]) if "components" in config else config[key]
        target["answers"] = table
    return config


def small_root(tmp: Path, limits: dict) -> Path:
    """A checkout-shaped directory with the cells at CPU sizes."""
    root = tmp / "checkout"
    (root / "gpubench").mkdir(parents=True)
    for folder in ("metrics", "mixes", "entries", "kinds"):
        shutil.copytree(HERE / folder, root / "gpubench" / folder,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (root / "gpubench" / "configs").mkdir()
    with open(HERE.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    gate = _config("gate-cpu", "gate-h100", {
        "torch": {"burn_in": [BURN_IN_TORCH], "stress": [STRESS_ELEMENTS]},
        "perf": {"burn_in": [MXU_CPU], "triad": [TRIAD_CPU], "fma": [FMA]}})
    full = _config("fullchain-cpu", "fullchain-h100", {
        "full_validation": {"burn_in": [BURN_IN_FULL],
                            "stress": [STRESS_ELEMENTS], "train": [8]}})
    for config in (gate, full):
        config["limits"] = dict(limits)
        with open(root / "gpubench" / "configs" / f"{config['name']}.json",
                  "w") as f:
            json.dump(config, f)
    rename = {"gate-h100": "gate-cpu", "fullchain-h100": "fullchain-cpu"}
    for c in bench["configs"]:
        c["file"] = f"gpubench/configs/{rename[c['name']]}.json"
        c["name"] = rename[c["name"]]
    for w in bench["workloads"]:
        w["config"] = rename[w["config"]]
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return root
