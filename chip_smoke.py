#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``tpu_operator_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

1. Requires ``torch.cuda.is_available()``; prints the card's ``nvidia-smi``
   name and power limit.
2. Builds every kernel from ``tpu_operator_torch/csrc`` with nvcc (sm_90a)
   and prints the build seconds; reads the library's SASS with cuobjdump and
   requires every matmul instantiation to issue wgmma (``HGMMA``) and TMA
   loads (``UTMALDG``) and the triad kernel to issue its float4 loads and
   streaming float4 stores (``STG.E.EF.128``), printing the counts; prints
   ``-Xptxas -v``'s registers, shared memory and spills for the triad and
   requires no spill.
3. Holds each kernel against its plain PyTorch version on the card: the
   matmul at every (block, K-step) instantiation's smallest shape and a
   ragged one that wraps its ring, the triad at the probe's and the memory
   sweep's array sizes and ragged ones, at every block size the validator
   uses (with ``b`` left bit-equal and the result in ``a``'s storage),
   then every kernel at the shapes the validator path gives it (the matmul
   at 512^2 for the burn-in, both blocks, and at 2048^2 for the probe), and
   times kernel, plain version and the one PyTorch library call computing
   the same function: device time per call from torch.profiler, the median
   of five rounds that take the calls in turn (``ms``, ``plain_ms``,
   ``library_ms``), and the
   CUDA-event time of back-to-back calls (``*call_ms``, host launch cost
   included); prints one JSON line per kernel configuration.  Then splits
   an iteration of the perf probe's 2048^2 matmul chain into device time per
   kernel and host wall time.
4. Drives the main path through its entry points, leg by leg, with every
   launch count reset just before each leg and read just after: the
   validator CLI ``--component=torch`` and ``--component=perf`` (full size)
   with a temporary status directory, the bench's matmul sweep leg
   (``microbench --mxu-sweep``, the route of the k-blocked kernel), its
   memory sweep leg (``microbench --hbm-sweep``: the triad at 128-1024 MiB
   per array and 128/256/512 threads) and ``entry()``'s forward step.
   Checks the status files, the sweep points (every one measured, none
   failed or wrong) and the forward loss against the same step on the
   CPU.
5. Prints the ``kernels`` JSON line, then as the last line
   ``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

# published H100 SXM peaks (NVIDIA data sheet): the roofline bound of each
# kernel is the larger of bytes / memory rate and operations / compute rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12     # tensor cores, dense
PEAK_F32_FLOPS = 67e12       # CUDA cores


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _call_ms(torch, fn, reps: int, rounds: int = 5) -> float:
    """Median over rounds of the CUDA-event span of reps back-to-back calls,
    per call: what a caller waits, host launch cost included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _device_ms(torch, fn, reps: int):
    """Device time per call: the kernels' durations that torch.profiler
    records over reps calls, summed, over reps.  None if it saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


def _times(torch, fns, reps: int, rounds: int = 5):
    """(ms, call_ms, source of ms) for each of fns: ms is the median over
    rounds of the device time per call, the fns taken in turn within each
    round so that a drift of the card's clocks falls on all of them alike;
    the event-timed call where the profiler sees no kernels."""
    dev = [[] for _ in fns]
    for _ in range(rounds):
        for fn, times in zip(fns, dev):
            times.append(_device_ms(torch, fn, reps))
    out = []
    for fn, times in zip(fns, dev):
        call_ms = _call_ms(torch, fn, reps)
        if None in times:
            out.append((call_ms, call_ms, "cuda events"))
        else:
            out.append((statistics.median(times), call_ms,
                        f"torch.profiler device time, median of {rounds}"))
    return out


def _bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_sass(_build, lib) -> None:
    """Every instantiation of the matmul kernel in the built library must
    issue wgmma (HGMMA) and TMA loads (UTMALDG), and the triad kernel more
    than one 128-bit evict-first store (STG.E.EF.128, from st.global.cs)
    per thread and twice as many 128-bit loads; prints the counts."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    ops_counted = ("HGMMA", "UTMALDG", "UTMASTG")
    counts, triad, current = {}, {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            inst = re.search(r"matmul_bf16_f32_kernelILi(\d+)ELi(\d+)E", fn[1])
            current = (f"block{inst[1]}_kstep{inst[2]}" if inst else
                       "triad" if "triad_inplace_kernel" in fn[1] else None)
            if current and current != "triad":
                counts[current] = dict.fromkeys(ops_counted, 0)
        elif current == "triad":
            # every global load and store, by opcode with its qualifiers
            for op in re.findall(r"\b(?:LDG|STG)\.[\w.]+", line):
                triad[op] = triad.get(op, 0) + 1
        elif current:
            for op in ops_counted:
                counts[current][op] += op in line
    print(json.dumps({"matmul_sass": counts, "triad_sass": triad}), flush=True)
    _require(len(counts) == 4 and all(c["HGMMA"] and c["UTMALDG"]
                                      for c in counts.values()),
             f"matmul kernel SASS lacks wgmma or TMA: {counts}")
    # b's loads take the read-only path (LDG.E.128.CONSTANT), a's do not
    stores = triad.get("STG.E.EF.128", 0)
    loads = sum(n for op, n in triad.items()
                if op.startswith("LDG.E.128"))
    _require(stores >= 2 and loads >= 2 * stores,
             f"triad kernel SASS lacks its streaming float4 stores or its "
             f"float4 loads: {triad}")


def triad_resources(_build) -> None:
    """Registers, shared memory and spills of the triad kernel, as
    ``nvcc -Xptxas -v`` reports them for csrc/triad.cu alone."""
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(_build.CSRC / "triad.cu"), "-o", os.path.join(tmp, "triad.o")],
            capture_output=True, text=True, check=True)
    report = out.stdout + out.stderr
    lines = [ln.strip() for ln in report.splitlines()
             if ln.strip() and "Compiling entry" not in ln]
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill", report)]
    smem = [int(s) for s in re.findall(r"(\d+) bytes smem", report)]
    print(json.dumps({"triad_ptxas": {
        "registers": max(regs, default=None), "spill_bytes": sum(spills),
        "smem_bytes": max(smem, default=0), "lines": lines}}), flush=True)
    _require(bool(regs), f"no ptxas report for triad.cu: {report}")
    # the loads in flight live in registers: a spill would put them in memory
    _require(not any(spills), f"triad kernel spills: {report}")


def _matmul_err(torch, ops, a, b, kt, block) -> float:
    """Max |kernel - plain| of one matmul; fails past the probe's criterion
    |d| <= 1e-2 + 1e-2*|want| (microbench.py:253)."""
    want = ops.matmul_bf16_f32_plain(a, b)
    got = ops.matmul_bf16_f32(a, b, kt=kt, block=block)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    _require(bool(torch.all(diff <= 1e-2 + 1e-2 * want.abs())),
             f"matmul {tuple(a.shape)} x {tuple(b.shape)} kt {kt} block "
             f"{block} disagrees with its plain version")
    return float(diff.max())


def check_kernels(torch, ops, microbench) -> dict:
    """Kernel vs plain version at the path's shapes; returns name -> record
    for the kernels line."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    records = {}

    def bf16(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)

    def record(name, source, replaces, err, tol, kernel, plain, library,
               reps, nbytes, flops, peak_flops, keep=True, library_oop=None):
        bound_ms, bound_by = _bound(nbytes, flops, peak_flops)
        fns = [kernel, plain, library] + ([library_oop] if library_oop else [])
        times = _times(torch, fns, reps)
        (ms, call_ms, how), (plain_ms, plain_call_ms, plain_how), \
            (library_ms, library_call_ms, library_how) = times[:3]
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "max_abs_err": err, "tolerance": tol,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms,
               "ms_source": sorted({how, plain_how, library_how}),
               "call_ms": call_ms, "plain_call_ms": plain_call_ms,
               "library_call_ms": library_call_ms}
        if library_oop is not None:
            # the same function written into a new tensor, beside the
            # in-place call
            rec["library_oop_ms"], rec["library_oop_call_ms"], _ = times[3]
        print(json.dumps({"kernel_check": rec}), flush=True)
        if keep:
            records[name] = rec

    # kernels 1 and 2, one CUDA kernel: each (block, K-step) instantiation
    # at its smallest shape (m = n = block, k = two K-steps) and at a ragged
    # one whose K loop wraps the ring, where a wrong descriptor, swizzle or
    # barrier parity shows
    shapes = []
    for block in ops.MATMUL_BLOCKS:
        for kstep in ops.MATMUL_KSTEPS:
            for m, k, n in ((block, 2 * kstep, block),
                            (3 * block, 11 * kstep, 2 * block)):
                err = _matmul_err(torch, ops, bf16(m, k), bf16(k, n), kstep,
                                  block)
                shapes.append({"m": m, "k": k, "n": n, "block": block,
                               "kstep": kstep, "max_abs_err": err})
    print(json.dumps({"matmul_shapes": shapes}), flush=True)

    matmul_src = "tpu_operator_torch/csrc/matmul_bf16.cu"
    matmul_tol = "|d| <= 1e-2 + 1e-2*|want| (microbench.py:253)"
    # the burn-in's 512^2 (kt=0), both blocks: ~96% of kernel 1's launches
    n = 512
    a, b = bf16(n, n), bf16(n, n)
    for block in ops.MATMUL_BLOCKS:
        record(f"matmul_bf16_f32 512^2 block {block}", matmul_src,
               "tpu_operator/validator/microbench.py:130",
               _matmul_err(torch, ops, a, b, 0, block), matmul_tol,
               lambda: ops.matmul_bf16_f32(a, b, block=block),
               lambda: ops.matmul_bf16_f32_plain(a, b),
               lambda: torch.mm(a, b), 200,
               2 * n * n * 2 + n * n * 4, 2.0 * n ** 3, PEAK_BF16_FLOPS,
               keep=False)

    # the probe's 2048^2, K-step 32 (kt=0) and the port's k-blocked K-step 64
    n = 2048
    a, b = bf16(n, n), bf16(n, n)
    for name, kt, line in (("matmul_bf16_f32", 0, 130),
                           ("matmul_bf16_f32_kblocked", 64, 135)):
        record(name, matmul_src, f"tpu_operator/validator/microbench.py:{line}",
               _matmul_err(torch, ops, a, b, kt, 128), matmul_tol,
               lambda: ops.matmul_bf16_f32(a, b, kt=kt),
               lambda: ops.matmul_bf16_f32_plain(a, b),
               lambda: torch.mm(a, b), 20,
               2 * n * n * 2 + n * n * 4, 2.0 * n ** 3, PEAK_BF16_FLOPS)
    del a, b

    # kernel 3: the triad, in place, at the probe's 32768 x 2048, at the
    # memory sweep's arrays (128-1024 MiB, 2048 columns) and at ragged sizes
    # (4 elements; fewer float4s than one block moves; a short last block; a
    # last block with one float4), at every block size the validator
    # launches it with.  b must come out bit-equal and the result must be
    # a's own storage.
    probe = 32768 * 2048
    sweep = sorted({mib * 1024 * 1024 // 4 // 2048 * 2048
                    for mib in microbench.HBM_SWEEP_MIBS} - {probe})
    sizes = (probe, *sweep, 4, 4000, 3 * 4099 * 4, 600 * 4096 + 8, probe + 4)
    threads_all = sorted({microbench.HBM_TILING[""][1],
                          *microbench.HBM_SWEEP_THREADS})
    checked, err = [], 0.0
    for numel in sizes:
        a = torch.randn(numel, generator=g, device=dev)
        b = torch.randn(numel, generator=g, device=dev)
        b_before = b.clone()
        want = ops.triad_plain_(a.clone(), b, 3.0)
        for threads in threads_all:
            got = ops.triad_(a.clone(), b, 3.0, threads=threads)
            torch.cuda.synchronize()
            point_err = float((got - want).abs().max())
            checked.append({"numel": numel, "threads": threads,
                            "max_abs_err": point_err})
            _require(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
                     f"triad_ disagrees with its plain version at {numel} "
                     f"elements, {threads} threads")
            _require(torch.equal(b, b_before),
                     f"triad_ wrote into b at {numel} elements")
            if numel == probe:
                err = max(err, point_err)
            del got
        s = a.clone()
        _require(ops.triad_(s, b, 3.0).data_ptr() == s.data_ptr(),
                 "triad_ did not return a's own storage")
        del a, b, b_before, want, s
    torch.cuda.empty_cache()            # the timed arrays below start afresh
    print(json.dumps({"triad_shapes": checked}), flush=True)

    a = torch.randn((32768, 2048), generator=g, device=dev)
    b = torch.randn((32768, 2048), generator=g, device=dev)
    scratch = a.clone()
    record("triad_", "tpu_operator_torch/csrc/triad.cu",
           "tpu_operator/validator/microbench.py:318",
           err, "allclose rtol 1e-6 atol 1e-6",
           lambda: ops.triad_(scratch, b, 0.25),
           lambda: ops.triad_plain_(scratch, b, 0.25),
           lambda: torch.add(b, scratch, alpha=0.25, out=scratch), 20,
           3 * a.numel() * 4, 2.0 * a.numel(), PEAK_F32_FLOPS,
           library_oop=lambda: torch.add(b, a, alpha=0.25))
    del a, b, scratch

    # kernel 4: the VPU probe's 512 x 512 f32 fma + relu
    a, b, c = (torch.randn((512, 512), generator=g, device=dev)
               for _ in range(3))
    got = ops.fma_relu(a, b, c)
    want = ops.fma_relu_plain(a, b, c)
    torch.cuda.synchronize()
    _require(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
             "fma_relu disagrees with its plain version")
    record("fma_relu", "tpu_operator_torch/csrc/fma_relu.cu",
           "tpu_operator/validator/microbench.py:458",
           float((got - want).abs().max()),
           "allclose rtol 1e-5 atol 1e-6 (microbench.py:484)",
           lambda: ops.fma_relu(a, b, c),
           lambda: ops.fma_relu_plain(a, b, c),
           lambda: torch.addcmul(c, a, b).relu_(), 200,
           4 * a.numel() * 4, 3.0 * a.numel(), PEAK_F32_FLOPS)
    return records


def torch_component_rates(workloads) -> None:
    """The torch component's workloads at its sizes (burn-in 512^2 x 4
    iterations, memory stress 64 MiB x 2): their reported marginal rates
    (the matmul kernel's own time at 512^2 is a kernel_check line)."""
    burn = workloads.matmul_burn_in(size=512, iters=4)
    _require(burn.ok, f"burn-in failed: {burn.detail}")
    stress = workloads.hbm_stress(mib=64, iters=2)
    _require(stress.ok, f"memory stress failed: {stress.detail}")
    print(json.dumps({"torch_component": {
        "burn_in_tflops": burn.value, "burn_in_detail": burn.detail,
        "burn_in_s": burn.duration_s,
        "hbm_stress_gibs": stress.value, "hbm_stress_detail": stress.detail,
        "hbm_stress_s": stress.duration_s}}), flush=True)


def probe_chain_profile(torch, workloads) -> None:
    """Where an iteration of the perf probe's matmul chain goes (2048^2,
    block 128, kt=0: matmul, then abs, max, add, div and cast to bf16):
    device time per kernel from torch.profiler, beside the host's wall time
    per iteration of the same chain run without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(0)
    a, b = (torch.randn((2048, 2048), generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    iters = 16
    float(workloads._burn_in_fn(a, b, iters))
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        float(workloads._burn_in_fn(a, b, iters))
        wall.append((time.perf_counter() - t0) * 1e3 / iters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        float(workloads._burn_in_fn(a, b, iters))
    kernels = {e.key: e.self_device_time_total / iters / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0}
    device_ms = sum(kernels.values())
    print(json.dumps({"probe_chain_2048": {
        "iters": iters, "wall_ms_per_iter": min(wall),
        "device_ms_per_iter": device_ms,
        "device_idle_share": 1.0 - device_ms / min(wall),
        "kernel_ms_per_iter": kernels}}), flush=True)


def _sweep(microbench, flag: str) -> dict:
    """One sweep leg of the bench (``microbench --mxu-sweep`` or
    ``--hbm-sweep``, two reps a point) as the JSON it prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = microbench.main([flag, "--reps=2"])
    _require(rc == 0, f"microbench {flag} exited {rc}")
    return json.loads(out.getvalue())


def drive_main_path(torch, ops, microbench) -> dict:
    """The port's path through its entry points, leg by leg, each with the
    launch counts reset just before it and read just after; returns the
    counts per leg."""
    from tpu_operator_torch import statusfiles
    from tpu_operator_torch.entry import entry
    from tpu_operator_torch.validator.__main__ import main as validator_main

    legs = {}
    ops.reset_launches()
    with tempfile.TemporaryDirectory() as status_dir:
        for component in ("torch", "perf"):
            t0 = time.perf_counter()
            rc = validator_main([f"--component={component}",
                                 f"--status-dir={status_dir}"])
            _require(rc == 0, f"--component={component} exited {rc}")
            print(json.dumps({"component": component,
                              "seconds": time.perf_counter() - t0}), flush=True)
        ready = statusfiles.read_status("torch-ready", status_dir)
        _require(ready is not None and ready.get("devices") == "1",
                 f"torch-ready missing or wrong: {ready}")
        _require(statusfiles.read_status("perf-ready", status_dir) is not None,
                 "perf-ready was not written")
        report = statusfiles.read_status("perf-report", status_dir) or {}
        print(json.dumps({"perf_report": report}), flush=True)
        _require(all(report.get(f"{p}-probe_ok") == "true"
                     for p in ("vpu", "mxu", "hbm")), f"perf-report {report}")
    legs["components"] = dict(ops.LAUNCHES)

    ops.reset_launches()
    sweep = _sweep(microbench, "--mxu-sweep")
    legs["mxu_sweep"] = dict(ops.LAUNCHES)
    print(json.dumps({"mxu_sweep": sweep}), flush=True)
    _require(sweep["best"] is not None
             and all("tflops" in r for r in sweep["results"]),
             "mxu sweep had failed points")

    # the bench's memory sweep leg: the only run of every block size at
    # real array sizes (128-1024 MiB per array)
    ops.reset_launches()
    sweep = _sweep(microbench, "--hbm-sweep")
    legs["hbm_sweep"] = dict(ops.LAUNCHES)
    print(json.dumps({"hbm_sweep": sweep}), flush=True)
    grid = {(m, t) for m in microbench.HBM_SWEEP_MIBS
            for t in microbench.HBM_SWEEP_THREADS}
    measured = [(r["mib"], r["threads"]) for r in sweep["results"]
                if "gibs" in r]
    _require(sorted(measured) == sorted(grid) and "truncated" not in sweep,
             f"hbm sweep had failed or missing points: {sweep['results']}")

    ops.reset_launches()
    forward, args = entry()
    loss = float(forward(*args))
    legs["entry"] = dict(ops.LAUNCHES)
    params, x, y = args
    ref = float(forward({k: v.cpu() for k, v in params.items()},
                        x.cpu(), y.cpu()))
    print(json.dumps({"entry_loss": loss, "entry_loss_cpu": ref}), flush=True)
    _require(math.isfinite(loss) and math.isclose(loss, ref, rel_tol=1e-5),
             f"entry() loss {loss} vs CPU {ref}")
    print(json.dumps({"launches_by_leg": legs}), flush=True)
    return legs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the card")
    from tpu_operator_torch.validator import _build, microbench, ops, workloads

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)

    t0 = time.perf_counter()
    lib = _build.build(torch.cuda.current_device())
    print(json.dumps({"build_seconds": time.perf_counter() - t0,
                      "library": str(lib.relative_to(_build.BUILD_ROOT.parents[1]))}),
          flush=True)
    check_sass(_build, lib)
    triad_resources(_build)

    records = check_kernels(torch, ops, microbench)
    torch_component_rates(workloads)
    probe_chain_profile(torch, workloads)
    legs = drive_main_path(torch, ops, microbench)
    launches = {name: sum(leg[name] for leg in legs.values())
                for name in ops.LAUNCHES}
    for name, rec in records.items():
        rec["launches"] = launches[name]
        rec["launches_by_leg"] = {leg: counts[name]
                                  for leg, counts in legs.items()}
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    idle = [name for name, count in launches.items() if count == 0]
    _require(not idle, f"kernels never launched on the main path: {idle}")
    _require(legs["hbm_sweep"]["triad_"] > 0,
             "the hbm sweep leg never launched the triad kernel")

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
