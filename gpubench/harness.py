"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs here.  The run:

1. finds the cell, its configuration, its mix, the mix's entries, the
   kinds of answer the calls compute and its metrics' readers by name
   (``manifest``), sets the configuration's environment and keeps the
   port's kernel build in ``build/kernels/`` under the checkout;
2. fails, printing no result, where no card is visible or fewer than the
   cell asks for; it never falls back to the CPU;
3. installs each kind's taps and the configuration's spans (``taps``),
   makes the cell's objects (``cell``) and runs one untimed pass, which
   builds or loads every kernel and captures every graph the passes
   replay; the result says whether this run built kernels
   (``built_kernels``), so that a checkout's first set-up is told apart;
4. runs passes back to back, one client, until ``--seconds`` have passed;
   the window ends when its last pass ends, and every pass counts.  With
   ``--trace 1`` the profiler records the first passes (``trace``);
5. reads the memory peak of the fullest card (card 0's, or where an entry
   holds ranks on several cards the largest of theirs, each card's beside
   it), fails where JAX, jaxlib, flax or the JAX package was loaded (in
   this process, or in a rank held on another card, ``ranks``), frees the
   program's state, then compares every answer of the window with the
   reference (``compare``), and in a traced run each chain call's kernels
   with its steps, and prints the metrics, each number compared beside its
   limit last.

Ranks held on several cards that break (a child raised or died) end the
run with exit code 3 and no result, as does a function they should run
that the checkout lacks.

The program's entries take no seed: every pass computes the same answers
from the program's own fixed seeds, and ``--seed`` is recorded only.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import compare, manifest, roofline
from . import trace as tracing
from .manifest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_operator")
# the port's kernel build directory variable (consts.BUILD_DIR_ENV)
BUILD_DIR_ENV = "TPU_OPERATOR_TORCH_BUILD_DIR"
# settings of the validator a configuration may set; unset unless it does
PROGRAM_ENV = ("PERF_ENFORCE", "PERF_QUICK", "STATUS_DIR", BUILD_DIR_ENV)
_T_IMPORT = time.monotonic()


def process_age_s() -> float:
    """Seconds since this process started (from /proc), or since this
    module was imported where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rpartition(")")[2].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


def forbidden_modules() -> List[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
        return out.splitlines()[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def build_files(build: Path) -> Dict[str, float]:
    """Every file of the kernel build directory, with its change time."""
    return {str(p): p.stat().st_mtime for p in build.rglob("*")
            if p.is_file()} if build.is_dir() else {}


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also print the control's readings: the reference "
                         "one precision below in the program's place")
    return ap.parse_args(argv)


def _window(cell, taps, seconds: float, traced: bool, device: str):
    """The measured window: passes back to back, one client, until
    ``seconds`` have passed; the profiler on for the first passes where
    ``traced``.  Returns (passes, reports, failures, traced passes,
    profiler, setup seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if device == "cuda":
        torch.cuda.synchronize()
    prof = mark = None
    if traced:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        mark = record_function("gpubench.window")
        mark.__enter__()
    setup_s = process_age_s()
    t_start = time.perf_counter()
    passes, reports, failed, in_trace = [], [], [], set()
    while True:
        i = taps.pass_index = len(passes)
        t0 = time.perf_counter()
        if mark is not None:
            in_trace.add(i)
            with record_function("gpubench.pass"):
                result = cell.run_pass()
        else:
            result = cell.run_pass()
        t1 = time.perf_counter()
        passes.append((t0, t1))
        reports.append(result.reports)
        if not result.ok:
            failed.append(f"pass {i}: {result.detail}")
        if mark is not None and t1 - t_start >= min(tracing.TRACED_SECONDS,
                                                     seconds):
            mark.__exit__(None, None, None)
            if device == "cuda":
                torch.cuda.synchronize()
            prof.stop()
            mark = None
        if t1 - t_start >= seconds:
            return passes, reports, failed, in_trace, prof, setup_s


def main(argv: Optional[List[str]] = None, device: Optional[str] = None,
         root: Path = ROOT) -> int:
    """Run one cell once; 0 and a result line, or non-zero and none.
    ``device`` other than None (the tests' ``"cpu"``) skips the look for a
    card; ``root`` is the checkout whose ``BENCHMARK.json`` and files under
    ``gpubench/`` name the cell."""
    args = parse(argv)
    bench = manifest.load(root / "BENCHMARK.json")
    work = manifest.cell(bench, args.workload)
    config = manifest.config(bench, work["config"], root)
    mix = manifest.mix(work["traffic"], root)
    entries = manifest.entries(mix, root)
    want = compare.expected(config, mix, entries)
    kinds = manifest.kinds(want, root)
    listed = manifest.metrics(bench, work["name"], bool(args.trace))
    readers = manifest.readers(listed, root)

    for key in PROGRAM_ENV:
        os.environ.pop(key, None)
    os.environ[BUILD_DIR_ENV] = str(root / "build")
    os.environ.update(config.get("env", {}))
    build_before = build_files(root / "build")

    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("gpubench: no CUDA device; this benchmark runs on the card "
                  "only", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < work["chips"]:
            print(f"gpubench: {work['name']} needs {work['chips']} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        device = "cuda"
    card = torch.cuda.get_device_name(0) if device == "cuda" else device
    limit = power_limit() if device == "cuda" else "none"
    print(f"gpubench: {work['name']} on {card} ({limit}), seed {args.seed}",
          file=sys.stderr)

    from .cell import Cell
    from .observed import Observed
    from .ranks import RanksError
    from .taps import Taps, hold_values

    taps = Taps()
    for kind in kinds.values():
        kind.install(taps)
    for name, target in config.get("spans", {}).items():
        taps.patch(target, taps.span(name))
    try:
        cell = Cell(config, mix, device, entries).open()
        try:
            warm = cell.run_pass()
            if not warm.ok:
                print(f"gpubench: the untimed pass failed: {warm.detail}",
                      file=sys.stderr)
            taps.clear()
            built = build_files(root / "build") != build_before
            window = _window(cell, taps, args.seconds, bool(args.trace),
                             device)
            peak = (torch.cuda.max_memory_allocated(0) if device == "cuda"
                    else 0)
            by_card = cell.peaks()
        finally:
            taps.remove()
            cell.close()
    except RanksError as e:
        taps.remove()
        print(f"gpubench: {e}", file=sys.stderr)
        return 3
    passes, reports, failed, traced, prof, setup_s = window

    loaded = forbidden_modules()
    if loaded:
        print(f"gpubench: loaded in the measured process: {loaded}",
              file=sys.stderr)
        return 3

    answers = taps.answers
    hold_values(answers)
    del cell
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    trace = tracing.summarize(prof) if prof is not None else None
    del prof

    stated = compare.reference_answers(answers, kinds, device)
    numbers = compare.gaps(answers, stated, kinds)
    numbers["failed_passes"] = float(len(failed))
    numbers["answers_off_config"] = float(compare.off_config(
        answers, want, range(len(passes))))
    if trace is not None:
        short = compare.short_chains(answers, trace.launches, traced, kinds)
        numbers["short_chain_calls"] = float(len(short))
        for kind, steps, kernels in short[:10]:
            print(f"gpubench: a traced {kind} chain of {steps} steps "
                  f"launched {kernels} kernels", file=sys.stderr)
    correct, rows = compare.judge(numbers, config["limits"])
    for line in failed[:5]:
        print(f"gpubench: {line}", file=sys.stderr)
    print("gpubench: pass seconds "
          + " ".join(f"{t1 - t0:.4f}" for t0, t1 in passes[:200]),
          file=sys.stderr)

    obs = Observed(setup_s, passes, answers, taps.spans, reports, kinds,
                   trace, traced)
    metrics = {}
    for entry in listed:
        value = readers[entry["name"]].read(obs)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    if by_card:
        peak = max(by_card)
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": card,
           "count": work["chips"], "memory_peak_bytes": int(peak)}
    if by_card:
        dev["memory_peak_by_card"] = by_card
    line = {"correct": bool(correct), "attempted": len(passes),
            "failed": len(failed), "metrics": metrics, "device": dev}
    if args.trace and trace is not None:
        dev["busy_s"], dev["window_s"] = trace.busy_s, trace.window_s
        line["breakdown"] = {"device_ops": trace.device_ops,
                             "idle_gaps": trace.idle_gaps}
    line["card"] = {"power_limit": limit, "seed": args.seed,
                    "peaks": roofline.PEAKS_AT}
    line["built_kernels"] = built
    print(f"gpubench: set-up {setup_s:.2f} s, kernels "
          f"{'built' if built else 'loaded from the build directory'}",
          file=sys.stderr)
    if args.control:
        line["control"] = compare.gaps(compare.control_answers(
            answers, compare.reference_answers(answers, kinds, device,
                                               control=True), kinds),
            stated, kinds)
    line["checks"] = {name: {"value": value, "limit": lim}
                      for name, value, lim in rows}
    for name, value, lim in rows:
        print(f"check {name} {value!r} limit {lim!r} "
              f"{'ok' if value <= lim else 'FAIL'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
