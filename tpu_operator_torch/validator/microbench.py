"""CUDA card microbenchmarks — the per-card performance health gate.

Counterpart of ``tpu_operator/validator/microbench.py``.  Each Pallas kernel
there is a hand-written CUDA kernel here (``validator/ops.py`` over
``csrc/``), and the probes keep their names and report keys:

* :func:`mxu_probe` — tiled bf16 matmul on the tensor cores; TFLOP/s.
* :func:`hbm_probe` — in-place STREAM triad over device memory; GiB/s.
* :func:`vpu_probe` — fused multiply-add + ReLU on the CUDA cores, checked
  against numpy.

With ``device="cpu"`` the wrappers run their plain PyTorch versions at
clamped shapes: correctness is still asserted, the rates are the host's, and
sweeps carry ``"interpret": True`` — plain CPU version, not evidence about
any card.  On the card both rate chains replay as CUDA graphs
(``validator/graphs.py``), the counterpart of the reference's one-dispatch
``fori_loop`` chains, and every known part is gated on floors set by
``MXU_GATE_FRACTION`` and ``HBM_GATE_FRACTION`` of its peaks.

With the port's tracer on (``obs/trace.py``) each chain call of a probe's
rate is a ``validator.chain`` span (``steps``, ``role`` ``warm`` or
``timed``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..host import chip_type_from_name
from ..obs import trace
from . import ops
from .graphs import ChainGraphs, chain
from .spans import ranged
from .workloads import ValidationReport, _burn_in_fn

# Public per-part peaks: (bf16 dense TFLOP/s, device-memory GB/s), from
# NVIDIA's H100 data sheet.  Keys come from _chip_gen.
CHIP_PEAKS = {
    "h100-sxm": (989.0, 3350.0),
    "h100-pcie": (756.0, 2000.0),
}
# Floors are fractions of each part's peaks, calibrated as the reference's
# are (tpu_operator/validator/microbench.py:55-68): to the WORST recorded
# probe reading on an H100 80GB HBM3 at 700 W (PERF.md §2; 21 readings of
# each graph-replayed chain over four chip_smoke.py runs), such that a
# card at half its rate trips the floor and run-to-run spread does not.
# MXU: the probe's chain is a 2048^2 product (35 us) plus an f32
# renormalisation on the CUDA cores (36 us) per step, so a healthy card
# reads about a quarter of the bf16 peak: worst 228.95 TFLOP/s (23%),
# spread 228.95-237.7.  With the product at half speed the same chain
# reads 160.8-162.3.  0.20 of the peak is 197.8 TFLOP/s: 1.22x that
# half-rate reading, and 86% of the worst healthy one.
MXU_GATE_FRACTION = 0.20
# HBM: the triad chain is device-bound; the worst recorded reading is
# 2838.5 GiB/s (3047.8 GB/s, 91% of the 3350 GB/s peak; launched eagerly),
# the graph-replayed ones 2852.6-2876.5.  0.70 of the peak is 2184 GiB/s:
# 77% of that worst reading, and 1.54x the 1419 GiB/s a card at half its
# bandwidth would read.
HBM_GATE_FRACTION = 0.70

# Triad (array MiB, threads per block) per part, and the sweep grid.
HBM_TILING = {
    "": (256, 256),
}
HBM_SWEEP_MIBS = (128, 256, 512, 1024)
HBM_SWEEP_THREADS = (128, 256, 512)

# Matmul (size, block tile, K-step; 0 = the kernel's default K-step 32) per
# part, and the sweep grid, in the GPU kernel's tile sizes.
MXU_TILING = {
    "": (2048, 128, 0),
}
MXU_SWEEP_POINTS = (
    (2048, 128, 0), (2048, 64, 0), (2048, 128, 64),
    (4096, 128, 0), (4096, 128, 64), (4096, 64, 64),
)


def _chip_gen(name: Optional[str] = None) -> str:
    """Normalise a CUDA device name to a CHIP_PEAKS key ('' if unknown)."""
    return chip_type_from_name(torch.cuda.get_device_name() if name is None
                               else name)


def _interpret(device: str) -> bool:
    # the kernels' plain versions run wherever the tensors are on the CPU
    return torch.device(device).type == "cpu"


def chip_generation(device: str = "cuda") -> str:
    """CHIP_PEAKS key for the card behind ``device`` ('' on the CPU, with no
    usable CUDA, or for an unknown part)."""
    if _interpret(device) or not torch.cuda.is_available():
        return ""
    return _chip_gen(torch.cuda.get_device_name(torch.device(device)))


def _sync(device: str) -> None:
    if not _interpret(device):
        torch.cuda.synchronize(torch.device(device))


def _gate_note(gen: str, floor: float, share: float) -> str:
    if not gen:
        return ""
    return f", {100.0 * share:.0f}% of peak, floor {floor:.0f} [{gen}]"


# --------------------------------------------------------------------------
# tensor cores: tiled bf16 matmul
# --------------------------------------------------------------------------

def _two_point_rate(run, work_per_rep: float, r1: int, r2: int) -> float:
    """Measure work/second as the marginal rate between r1 and r2 reps,
    cancelling the fixed launch/synchronise/fetch overhead of a call.
    ``run(reps)`` must block until the device work is done.  Each point is
    best-of-2: jitter only adds time, so min filters it."""
    # warm-up: builds the kernels, fills the allocator's cache
    for r in (r1, r2):
        with ranged(trace.span("validator.chain",
                               {"steps": r, "role": "warm"})):
            run(r)

    def timed_min(r: int) -> float:
        best = float("inf")
        for _ in range(2):
            with ranged(trace.span("validator.chain",
                                   {"steps": r, "role": "timed"})):
                t0 = time.perf_counter()
                run(r)
                best = min(best, time.perf_counter() - t0)
        return best

    dt1 = timed_min(r1)
    dt2 = timed_min(r2)
    if dt2 - dt1 > 1e-5:
        return work_per_rep * (r2 - r1) / (dt2 - dt1)
    return work_per_rep * r2 / dt2 if dt2 > 0 else 0.0


def mxu_probe(size: Optional[int] = None, tile: Optional[int] = None,
              reps: int = 32, enforce: bool = False, kt: Optional[int] = None,
              device: str = "cuda") -> ValidationReport:
    """The tensor-core matmul kernel on one card; checks the result against
    the f32 product of the same bf16 inputs and (with ``enforce``, on a
    part of CHIP_PEAKS) gates on TFLOP/s.  Unset size/tile/kt resolve from
    MXU_TILING; ``tile`` is the kernel's block tile and ``kt`` its K-step
    (the k-blocked kernel's counterpart)."""
    gen = chip_generation(device)
    d_size, d_tile, d_kt = MXU_TILING.get(gen, MXU_TILING[""])
    size = d_size if size is None else size
    tile = d_tile if tile is None else tile
    kt = d_kt if kt is None else kt
    if _interpret(device):
        size, reps = 256, 1
    t0 = time.perf_counter()
    try:
        g = torch.Generator(device=device).manual_seed(0)
        # allocation inside the guard: an over-sized sweep point must
        # report, not propagate (see hbm_probe)
        a = torch.randn((size, size), generator=g, device=device,
                        dtype=torch.bfloat16)
        b = torch.randn((size, size), generator=g, device=device,
                        dtype=torch.bfloat16)
        out = ops.matmul_bf16_f32(a, b, kt=kt, block=tile)
        _sync(device)
    except Exception as e:  # noqa: BLE001 - build/launch/OOM failure is the signal
        return ValidationReport("mxu-probe", False, time.perf_counter() - t0,
                                f"matmul kernel failed: {e}")
    # the per-element allclose criterion |out-want| <= atol + rtol*|want|,
    # reduced on the device so one scalar crosses to the host
    want = ops.matmul_bf16_f32_plain(a, b)
    worst = float(torch.max((out - want).abs()
                            - (1e-2 + 1e-2 * want.abs())))
    correct = bool(np.isfinite(worst)) and worst <= 0.0
    del out, want

    t0 = time.perf_counter()
    # the chain renormalises between products and ends in a fetched scalar,
    # the completion barrier.  16x spread: the wide point's device time
    # keeps the marginal well above launch and synchronise jitter
    with ChainGraphs() as graphs:
        rate = _two_point_rate(
            lambda r: float(_burn_in_fn(a, b, r, block=tile, kt=kt,
                                        graphs=graphs)),
            2.0 * size ** 3, reps, reps * 16)
    dt = time.perf_counter() - t0
    tflops = rate / 1e12

    floor = CHIP_PEAKS[gen][0] * MXU_GATE_FRACTION if gen else 0.0
    fast_enough = (not enforce) or (not floor) or tflops >= floor
    ok = correct and fast_enough
    share = tflops / CHIP_PEAKS[gen][0] if gen else 0.0
    detail = (f"{tflops:.1f} TFLOP/s bf16 ({size}x{size}, block {tile}"
              + (f", kt {kt}" if kt else "") + ")"
              + _gate_note(gen, floor, share)
              + ("" if correct else ", WRONG RESULT"))
    return ValidationReport("mxu-probe", ok, dt, detail, value=tflops,
                            floor=floor or None)


def mxu_sweep(points: Sequence[Tuple[int, int, int]] = MXU_SWEEP_POINTS,
              reps: int = 8, deadline_s: Optional[float] = None,
              device: str = "cuda") -> dict:
    """Sweep matmul tilings — every point reported (failures included),
    winner under ``best``, deadline cuts marked ``truncated`` — so
    MXU_TILING can follow recorded evidence."""
    t_end = (time.monotonic() + deadline_s) if deadline_s else None
    default = MXU_TILING.get(chip_generation(device), MXU_TILING[""])
    order = [default] + [p for p in points if p != default]
    results = []
    truncated = False
    for size, tile, kt in order:
        if t_end is not None and time.monotonic() > t_end:
            truncated = True
            break
        rep = mxu_probe(size=size, tile=tile, kt=kt, reps=reps, device=device)
        point = {"size": size, "tile": tile, "kt": kt}
        if rep.ok and rep.value is not None and rep.value > 0:
            results.append({**point, "tflops": round(rep.value, 2)})
        else:
            results.append({**point, "error": rep.detail[:120]})
    scored = [r for r in results if "tflops" in r]
    best = max(scored, key=lambda r: r["tflops"]) if scored else None
    out = {"results": results, "best": best}
    if truncated:
        out["truncated"] = True
    if _interpret(device):
        # every point ran the plain CPU version at one clamped shape: the
        # labels are the requested shapes, the numbers are not evidence
        out["interpret"] = True
    return out


# --------------------------------------------------------------------------
# device memory: STREAM triad
# --------------------------------------------------------------------------

def _triad_chain(a: torch.Tensor, b: torch.Tensor, threads: int,
                 reps: int, graphs: Optional[ChainGraphs] = None
                 ) -> torch.Tensor:
    """reps dependent in-place triad passes acc = acc*0.25 + b from a (left
    intact), reduced to a cheap scalar barrier; scale 0.25 bounds the
    iteration (fixed point 8/3) without an extra memory pass.  On the card
    the chain replays through ``graphs`` (one of its own where None is
    given)."""
    def step(acc: torch.Tensor) -> torch.Tensor:
        return ops.triad_(acc, b, 0.25, threads=threads)

    if a.is_cuda:
        acc = chain(graphs, ("triad", b.data_ptr(), threads), step, a, reps)
    else:
        acc = a.clone()
        for _ in range(reps):
            acc = step(acc)
    return acc[0, :8].sum()


def hbm_probe(mib: Optional[int] = None, threads: Optional[int] = None,
              reps: int = 16, enforce: bool = False,
              device: str = "cuda") -> ValidationReport:
    """In-place triad kernel over two device-resident arrays of ``mib`` MiB.
    Reports achieved GiB/s (3 streams per element per pass); with
    ``enforce``, on a part of CHIP_PEAKS, gates on it.  ``mib``/``threads``
    default to the HBM_TILING entry."""
    default_mib, default_threads = HBM_TILING.get(chip_generation(device),
                                                  HBM_TILING[""])
    mib = default_mib if mib is None else mib
    threads = default_threads if threads is None else threads
    if _interpret(device):
        mib, reps = 1, 1
    cols = 2048
    rows = max(1, mib * 1024 * 1024 // 4 // cols)
    t0 = time.perf_counter()
    try:
        # allocation inside the guard: a sweep point that does not fit in
        # device memory must report, not propagate
        a = torch.full((rows, cols), 1.5, dtype=torch.float32, device=device)
        b = torch.full((rows, cols), 2.0, dtype=torch.float32, device=device)
        ops.triad_(a, b, 3.0, threads=threads)
        _sync(device)
    except Exception as e:  # noqa: BLE001
        return ValidationReport("hbm-probe", False, time.perf_counter() - t0,
                                f"triad kernel failed: {e}")
    # the kernel wrote in place: a now holds the result
    sample = a[:4, :4].cpu().numpy()
    correct = bool(np.allclose(sample, 1.5 * 3.0 + 2.0))

    t0 = time.perf_counter()
    # on the card the chain runs in its graphs' static copy of a, a third
    # array; its start value does not matter to the rate (fixed point 8/3)
    with ChainGraphs() as graphs:
        rate = _two_point_rate(
            lambda r: float(_triad_chain(a, b, threads, r, graphs)),
            3.0 * rows * cols * 4, reps, reps * 4)
    dt = time.perf_counter() - t0
    gibs = rate / (1024 ** 3)

    gen = chip_generation(device)
    floor = CHIP_PEAKS[gen][1] * HBM_GATE_FRACTION / 1.073741824 if gen \
        else 0.0  # GB/s peak -> GiB/s
    fast_enough = (not enforce) or (not floor) or gibs >= floor
    ok = correct and fast_enough
    share = gibs * 1.073741824 / CHIP_PEAKS[gen][1] if gen else 0.0
    detail = (f"{gibs:.1f} GiB/s triad ({rows}x{cols} f32, "
              f"{threads} threads/block)"
              + _gate_note(gen, floor, share)
              + ("" if correct else ", WRONG RESULT"))
    return ValidationReport("hbm-probe", ok, dt, detail, value=gibs,
                            floor=floor or None)


def hbm_sweep(mibs: Tuple[int, ...] = HBM_SWEEP_MIBS,
              threads: Tuple[int, ...] = HBM_SWEEP_THREADS,
              reps: int = 4, deadline_s: Optional[float] = None,
              device: str = "cuda") -> dict:
    """Grid-sweep triad array sizes and block sizes and return every point
    plus the winner: ``{"results": [{mib, threads, gibs}...], "best":
    {...}}``.  The default runs first, then larger arrays first, so a
    deadline cut leaves the most informative points measured."""
    t_end = (time.monotonic() + deadline_s) if deadline_s else None
    default = HBM_TILING.get(chip_generation(device), HBM_TILING[""])
    order = [default] + [
        (m, t) for m in sorted(mibs, reverse=True) for t in threads
        if (m, t) != default]
    results = []
    truncated = False
    for mib, thr in order:
        if t_end is not None and time.monotonic() > t_end:
            # not-run and failed are different evidence: mark the cut
            truncated = True
            break
        rep = hbm_probe(mib=mib, threads=thr, reps=reps, device=device)
        if rep.ok and rep.value is not None and rep.value > 0:
            results.append({"mib": mib, "threads": thr,
                            "gibs": round(rep.value, 2)})
        else:
            # e.g. out of memory on the biggest arrays, or a wrong result:
            # a failed point bounds the usable configuration
            results.append({"mib": mib, "threads": thr,
                            "error": rep.detail[:120]})
    scored = [r for r in results if "gibs" in r]
    best = max(scored, key=lambda r: r["gibs"]) if scored else None
    out = {"results": results, "best": best}
    if truncated:
        out["truncated"] = True
    if _interpret(device):
        out["interpret"] = True
    return out


# --------------------------------------------------------------------------
# CUDA cores: fused multiply-add correctness
# --------------------------------------------------------------------------

def vpu_probe(rows: int = 512, cols: int = 512,
              device: str = "cuda") -> ValidationReport:
    """Elementwise fused multiply-add + ReLU kernel, checked against numpy
    (allclose, atol 1e-6: the kernel rounds a*b+c once, numpy twice)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((rows, cols), dtype=np.float32)
    b = rng.standard_normal((rows, cols), dtype=np.float32)
    c = rng.standard_normal((rows, cols), dtype=np.float32)

    t0 = time.perf_counter()
    try:
        out = ops.fma_relu(*(torch.from_numpy(v).to(device) for v in (a, b, c)))
        _sync(device)
    except Exception as e:  # noqa: BLE001
        return ValidationReport("vpu-probe", False, time.perf_counter() - t0,
                                f"fma kernel failed: {e}")
    dt = time.perf_counter() - t0
    want = np.maximum(a * b + c, 0.0)
    ok = bool(np.allclose(out.cpu().numpy(), want, atol=1e-6))
    return ValidationReport(
        "vpu-probe", ok, dt,
        "fma+relu within atol 1e-6" if ok else "fma+relu MISMATCH", value=None)


# --------------------------------------------------------------------------
# suite
# --------------------------------------------------------------------------

def run_microbench(enforce: bool = False, quick: bool = False,
                   device: str = "cuda") -> Tuple[ValidationReport, ...]:
    """All three probes, cheapest first.  ``quick`` shrinks the shapes below
    what the two-point timing resolves, so quick mode is report-only."""
    if quick:
        return (vpu_probe(rows=128, cols=128, device=device),
                mxu_probe(size=512, tile=128, reps=2, enforce=False,
                          device=device),
                hbm_probe(mib=32, reps=2, enforce=False, device=device))
    return (vpu_probe(device=device), mxu_probe(enforce=enforce, device=device),
            hbm_probe(enforce=enforce, device=device))


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m tpu_operator_torch.validator.microbench [--mxu-sweep |
    --hbm-sweep]``: the sweeps as one JSON line, else each probe's JSON."""
    ap = argparse.ArgumentParser(
        description="CUDA card microbenchmarks (tensor cores / memory / FMA)")
    ap.add_argument("--hbm-sweep", action="store_true",
                    help="grid-sweep triad array and block sizes; print JSON")
    ap.add_argument("--mxu-sweep", action="store_true",
                    help="sweep matmul tilings and print JSON")
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--enforce", action="store_true")
    args = ap.parse_args(argv)
    # the report is the CLI's output on stdout: main() is the module's
    # `python -m` entry, where the JAX module prints under its main guard
    if args.hbm_sweep:
        report = [hbm_sweep(reps=args.reps, deadline_s=args.deadline_s)]
    elif args.mxu_sweep:
        report = [mxu_sweep(reps=args.reps, deadline_s=args.deadline_s)]
    else:
        report = [{"name": r.name, "ok": r.ok, "detail": r.detail,
                   "value": r.value}
                  for r in run_microbench(enforce=args.enforce)]
    for line in report:
        print(json.dumps(line))  # noqa: TPULNT120 - the CLI's report on stdout
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised on the card
    sys.exit(main())
