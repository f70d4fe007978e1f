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
   at both blocks at 256^2-2048^2, where ``ops.matmul_block``'s choice must
   time within 5% of the other block — the burn-in's 512^2 against
   ``torch.mm`` among them —, at 2048^2 for the probe, and the train step's
   and ``entry()``'s products through ``ops.MatmulBf16F32``, forward and
   each backward product, within 1e-4 relative of the f32 product), and
   times kernel, plain version and the one PyTorch library call computing
   the same function: device time per call from torch.profiler, the median
   of five rounds that take the calls in turn (``ms``, ``plain_ms``,
   ``library_ms``), and the
   CUDA-event time of back-to-back calls (``*call_ms``, host launch cost
   included); prints one JSON line per kernel configuration.  Then the
   torch component's rates with the length each escalation stopped at;
   the ``graph_chains`` phase (each chain the validator replays as CUDA
   graphs — the burn-in's at 2048^2, the perf probe's triad, the memory
   stress's — at 37 steps and at its probe's long chain must equal the
   same steps launched one by one bit for bit, with the same launch
   counts); the perf probe's 2048^2 matmul chain split into device time
   per kernel, wall time and idle share, replayed and launched step by
   step, with the rate a card at half its tensor-core speed would read;
   and the ``perf_gate`` phase: the perf component in this process must
   pass both floors, write them into ``perf-report`` with ``enforced:
   true`` and the tensor-core floor above that half-rate reading, and
   both probes must fail a floor raised above what the card read.
4. Drives the main path through its entry points, leg by leg, with every
   launch count reset just before each leg and read just after.  First the
   ``node_chain`` phase on the live host (``--host-root=/``): discovery
   through NVML and through the Python scanner (index, device node, PCI
   address, NUMA node and chip type must agree, NVML's UUIDs must be
   torch's cards, the part an H100), the driver agent (``install
   --one-shot``: the driver check, the barrier with the cards' device
   nodes), the toolkit agent (``--one-shot``: the CDI spec and the
   containerd drop-in + main config in temporary dirs, its containerd
   restart issued once to ``systemctl``/``nsenter`` stubs that record it),
   the device plugin (``grpc``/protobuf/``yaml``
   probed; served on a unix socket and registered with the port's fake
   kubelet, or its logic in-process where those libraries are missing:
   one Healthy device per card keyed by minor, the preferred and the
   whole allocation, and the last card alone on a machine with more than
   one), then the ``plugin_component`` phase over real HTTP to the port's
   stub apiserver: a kubelet played in a thread of this script writes the
   plugin's Healthy devices into the Node's ``nvidia.com/gpu`` capacity
   and runs each workload pod that appears on the plugin's preferred
   allocation (the pod's own command and args, ``--component=nccl
   --in-pod``, in a child with the pod's env, its ``kernel-cache`` volume
   mapped to the node's build dir holding this run's library, and the env
   the CDI spec and the allocation give, which must see exactly the
   allocated cards, load that library with no compile (its seconds
   printed) and launch the matmul five times per train step),
   ``--component=plugin`` (at its own 5 s wait intervals) must see the
   capacity, create the pod, see it succeed and write ``plugin-ready``,
   the pod must be gone afterwards, and feature discovery (``fd
   --one-shot``, twice) must label the Node with the card's chip and
   accelerator type, the card count, NVML's driver version and
   ``tpu.present``, the second run changing nothing; the client's metrics
   after it.  On a machine with more than one card the workload pod's
   command also runs on the last card's allocation alone.  Its seconds
   per step.  ``vfio-bind`` and ``uninstall`` never run on the live host.
   Then the ``health`` phase: the port's telemetry daemon
   (``tpu_operator_torch/native/metricsd``) built with g++ (its NVML
   declarations checked against the toolkit's ``nvml.h`` where there is
   one), ``--once`` against the card's NVML with ``--dev-root=/dev`` and the
   driver agent's metadata mirror (the card count = NVML's = torch's, every
   card up under its minor, HBM capacity within 5% above torch's, a
   temperature in (0, 100) and a power draw in (0, the power limit]; the
   series, the NVLinks with their states and the calls NVML refused
   printed), then serving on a free port behind the port's exporter
   (``node`` label set), scraped every 0.25 s through ~3 s of back-to-back
   2048^2 matmul kernels (utilisation above 50% in some scrape, power above
   the idle scrape's, ``tpu_exporter_metricsd_up 1`` and the node label on
   every sample), then the health watchdog stepped by hand over a daemon
   whose ``--dev-root`` holds symlinks to the cards' device nodes, with the
   Node annotation published over HTTP to the port's stub apiserver:
   healthy steps write nothing; with the symlinks removed the step after
   ``degrade_after`` bad scrapes writes ``gpu-degraded`` with
   ``chips_down`` = the card count, the node-status exporter reads
   ``gpu_operator_node_gpu_degraded 1`` and the Node carries the
   annotation; with them restored, after ``recover_after`` clean scrapes
   the file, the gauge and the annotation are gone.  A daemon without NVML
   (``--nvml-lib=/nonexistent``) must exit non-zero.  Then the
   ``node_operands`` phase, through an NVML that refuses every call that
   would change a card (none may be attempted): ``native/nvml_layout.c``
   built with gcc against the toolkit's ``nvml.h`` (the ctypes structures,
   constants and prototypes of MIG and confidential computing must match),
   the cards' MIG and CC state read, the partition plans of
   ``all-1g.10gb`` and ``all-balanced`` (with the route that answered the
   profile table) printed and never applied, the partition manager on the
   live host ending ``all-chips``/``success`` with its state file in a
   temporary dir (the device plugin's list with it = without it) and its
   CLI failing an unknown profile (rc 1, ``failed``), the cc manager's CLI
   over HTTP to the stub apiserver (``off``: rc 0, labels as NVML's state
   implies, ``cc-ready``; ``on``: rc 1 and the barrier cleared unless the
   card is in CC mode inside a confidential VM), the kata manager's CLI as
   a process on a temporary host root with a stub shim (the drop-in and
   one recorded containerd restart, ``kata-ready``; again: nothing
   changes; without the shim: rc 1, ``kata-ready`` cleared), and the
   cards' MIG mode, current and pending, the same after as before.  Then
   the ``operator`` phase: the policy reconciler through ``RetryingClient``
   → ``InClusterClient`` over HTTP to the port's stub apiserver, reading
   the watched kinds through one ``SharedInformerCache`` on its client and
   run when a ``KeyedWorkQueue`` has its key due — marked by the watch
   events as the JAX package's runner routes them, or by the pass's
   committed requeue — the stub seeded with the card's Node (labelled by
   fd's ``build_labels`` on the live host), a CPU-only Node and
   ``sample_policy()``.  Pass 1 must read
   ``notReady`` (``OperandNotReady``, requeue 5 s) with deploy labels on
   the card's node only and as many DaemonSets as the same reconciler
   creates for one GPU node on the CPU.  The plugin phase's kubelet thread
   serves the device plugin into the Node's capacity and runs the workload
   pod; from pass 2 on it also creates the pod of each DaemonSet that
   selects the card's node and runs the driver, toolkit and validator
   pods' own containers (command, args and env as the stub holds them) as
   children — host paths of the writable volumes mapped to temporary
   dirs (none of those host paths may change), containerd restarts to
   recording stubs, a failed init container restarted after a
   backoff — the validator pod Ready only when its init
   chain ``device → driver → toolkit → torch → perf → plugin`` exited 0 and
   its readiness probe passes; the other DaemonSets are marked rolled out
   and named (the health and node_operands phases run those operands).
   Passes, each when its key comes due, must reach ``ready`` with the
   card's slice ready (``slicesTotal`` = ``slicesReady`` = 1, the Node's
   ``tpu.slice.ready=true``) and no operator label on the CPU node.  The
   validator's chain runs only there, so what it left is read then, in
   this process: each init container's own command again with ``--wait``
   returning at once, the status files (the toolkit's injected cards are
   their NVML indices, the device count, torch's cards, every perf probe
   passed), ``--component=vfio`` failing (naming each visible card's PCI
   address with its ``nvidia`` driver), one scrape of the node-status
   exporter on that status dir (readiness, chip count, both perf probes).
   One more pass must write nothing at the stub and LIST no watched kind;
   then every watch stream is dropped (each must resume without a
   relist) and ``gpu-degraded`` in the validator's status dir must turn
   the slice not ready and its removal ready again, each pass woken by the
   resumed watch; the validator's children must have launched the matmul,
   triad and FMA kernels.  Its seconds, writes, reads (by verb and kind)
   and cache hits and misses per pass, the passes' cost board and one
   pass's Chrome trace, the containers' exit codes and seconds.  Then the
   ``upgrade`` phase on the same stub, kubelet thread and work queue: the
   driver controller takes the node's driver, a pinned version no card has
   parks the node ``upgrade-failed`` and NVML's own version takes it to
   ``upgrade-done``, every stage in order.  Then the ``remediation``
   phase on the same stub, kubelet thread, cache and work queue (the
   router also making and retiring ``remediate/<node>`` and
   ``workload/<ns>/<name>`` keys as the JAX runner does): a one-replica
   ``GPUWorkload`` whose member (``chip_smoke.py --gang-member``, run by
   the kubelet thread on the plugin's allocation with ``MASTER_ADDR``
   resolved to 127.0.0.1) forms an NCCL group through ``env://`` and runs
   the hand-written matmul until ``Running``; a pass with no write and no
   LIST of a watched kind; the health watchdog over the card's telemetry
   daemon, its device nodes behind removed symlinks, annotating the Node
   ``gpu-degraded``; the remediation controller stepping the node Suspect
   → Cordoned → Draining (the member evicted, the gang Degraded, torn
   down and held) → Revalidating (the validator pod deleted and its whole
   init chain rerun on the card with no member alive) → Rejoining →
   uncordoned once the symlinks are back, the annotation gone and the new
   validator pod Ready; the gang placed again only after the uncordon,
   ``Running``, then ``Succeeded`` with one reschedule.  Each state's and
   the gang's times, the seconds out of service, writes and reads per
   pass, the fleet goodput and the gang's badput split.  Then the
   operator's restart:
   the informer's snapshot saved, a second cache restored from it must
   open its watches with no LIST of a restored kind and come to hold what
   the first holds.  Last, the phase's ``names`` leg (:func:`names_leg`):
   every object the stub holds, every path under the node's mapped dirs
   and the contents of its files outside the build dir, every scraped
   page's series and every env the rendered containers that ran as
   children were given must carry no name of the JAX package (``tpu``,
   ``libtpu``, ``megascale``, ``jax``, ``ici``, case aside, but for the
   port's package path); one ``names`` line with the counts by category
   and the hits, which must be 0.  Then the ``packaging`` phase (no card
   needed, well under 10 s): the port's deploy trees
   (``tpu_operator_torch/deploy/``) through their drift gates and config validator in children started
   together — ``gen_crds --check`` on the chart's and the kustomize
   tree's CRDs, ``gen_csv --check``, ``gpuop_cfg validate`` on the CSV,
   the three samples and the chart's ``values.yaml`` policy block — each
   step's exit code and seconds; the modules ``manager.yaml`` and the
   chart's CRD and cleanup hooks run must be modules of the port that
   exist, and the chart's Deployment must run ``manager.yaml``'s command;
   ``helm`` and ``kubectl`` probed (``null`` here: the chart is never
   rendered without helm).  Then the ``lint`` leg (no card needed,
   seconds): the port's own tpulint gate, ``python -m
   tpu_operator_torch.analysis --format json`` over the port's package
   and this script, and its ``--inventory -``, two children of this
   interpreter started together — the files scanned, the parses, the
   findings by rule, the reconcile hot path's module count and blocking
   rows, and the seconds; any finding, a stale baseline entry, a blocking
   row on the hot path or an inventory drifted from
   ``tpu_operator_torch/ASYNC_INVENTORY.md`` fails the run.  Then the
   ``runner`` phase: the operator
   process as its packaged Deployment runs it — the command, args and env
   of ``deploy/config/manager/manager.yaml``'s container, plus only what
   a stub needs (``--api-server`` and its own token, a snapshot dir,
   ``--snapshot-interval=1``, ``--debug-endpoints``, free health and
   metrics ports) — against a stub apiserver that first gets the three
   CRDs from the chart's pre-upgrade hook (``python -m
   tpu_operator_torch.cmd.gen_crds --apply``, a child with
   ``--api-server``), then is seeded as the operator phase's, beside a
   kubelet thread that runs the rendered DaemonSets' containers (the
   validator's children load the kernel library this run built).
   The runner alone must take the policy to ``ready`` (slice 1/1,
   ``/readyz`` 200, the validator chain passing on the card); a steady
   window of 5 s with no write but its Lease renewals and no LIST of a
   watched kind; ``/metrics`` read by the port's parser with every
   runner family once and ``reconciliation_status`` 1; then three legs
   with the process the only reconciler, each printing one JSON line:
   ``runner_remediation`` (the ``remediation`` phase's gang on the card,
   the watchdog's fault, the node cordoned, drained, revalidated on the
   card and rejoined, the gang placed again and ``Succeeded`` with one
   reschedule: the seconds out of service, passes per key from
   ``/debug/traces``, the runner's writes and reads, the leg's kernel
   launches), ``runner_serve_stale`` (the stub refuses every request but
   watch streams past ``--degraded-budget``, shortened to 5 s: the
   process alive, ``/readyz`` 200 ``degraded: serving-stale``, the
   ``serving-stale`` and ``parked`` journal entries, no write landing;
   after it the ``recovered`` entry, a stripped present label repaired,
   the policy ``ready``, no restart) and ``runner_standby`` (a second
   process with its own identity and snapshot beside the leader: no
   write, no reconcile pass, ``/readyz`` 200 ``ok``); SIGTERM → exit 0
   within 15 s, the Lease released, the snapshot flushed, the standby
   taking the Lease within 15 s with no LIST of a watched kind and no
   validator rerun; the standby handed off in turn and a second
   process on its snapshot taking the Lease at once with no LIST of a
   restored kind, journaling one ``failover`` entry (read through
   ``/debug/explain``), keeping the policy ``ready`` without rerunning
   the chain and restoring a present label another client stripped; an
   admin's upgrade-state reset taken through the driver upgrade's stages
   with the runner's Events carrying the journal's entries (the Event
   backfill); ``gpu-status`` rendering ``ready`` and the slice 1/1, the
   chart's ``cleanup`` hook (its argv, as a child) deleting the CRs,
   SIGTERM → exit 0, and the phase's ``names`` leg over its stub, node
   dirs, the runner's ``/metrics`` and its children's envs.  Then
   the bench's matmul sweep leg
   (``microbench --mxu-sweep``, the route of the k-blocked kernel), its
   memory sweep leg (``microbench --hbm-sweep``: the triad at 128-1024 MiB
   per array and 128/256/512 threads) and ``entry()``'s forward step (its
   two products: two matmul launches).
   Checks the status files, the sweep points (every one measured, none
   failed or wrong) and the forward loss against the same step on the
   CPU.
5. The ``collectives`` phase: the multi-device validator over NCCL with one
   rank per visible card (a world of 1 on a one-card machine), leg by leg
   with the same launch counts: every collective check at its defaults
   (the multislice check only on an even world) with each one's time and
   value; ring and Ulysses attention on the cards against the same
   functions on a world-1 gloo group on the CPU, same inputs, max |d| <=
   1e-5; the sharded train step's losses on the cards against the CPU's
   (same world, gloo), rel 1e-4, each rank launching the matmul five
   times a step and nothing else; ``--component=nccl`` through the CLI
   (``nccl-ready`` with one device per card); ``run_full_validation`` at
   full size (every report ok, the JAX package's names in its order); and
   ``dryrun_multigpu``.  A failed NCCL start fails the run.
6. Prints the total seconds and the ``kernels`` JSON line (each kernel's
   launches summed over the legs, ``operator`` among them: the launches of
   the validator's children), then as the last line ``{"ok": true,
   "device": {...}}``.  Any failure raises and exits
   non-zero.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import math
import os
import queue
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

# the checkout's root: the pods' children run from it
HERE = os.path.dirname(os.path.abspath(__file__))

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


def _device_ms(torch, fn, reps: int, part: str = ""):
    """Device time per call: the durations of the kernels whose names hold
    ``part`` (every kernel by default) that torch.profiler records over
    reps calls, summed, over reps.  None if it saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and part in e.key)
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
               reps, nbytes, flops, peak_flops, keep=True, library_oop=None,
               extra=None):
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
        rec |= extra or {}
        print(json.dumps({"kernel_check": rec}), flush=True)
        if keep:
            records[name] = rec
        return rec

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
    block_rule(torch, ops, bf16, record, matmul_src, matmul_tol)
    train_step_products(torch, ops, g, record, matmul_src)

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


# the sizes the block rule was set from, and how much slower than the other
# block its choice may time at each before the run fails (the device
# times' run-to-run spread is about 1%)
BLOCK_RULE_SIZES = (256, 512, 1024, 2048)
BLOCK_RULE_SLACK = 1.05


def block_rule(torch, ops, bf16, record, source: str, tol: str) -> dict:
    """Both blocks of the matmul (kt=0) at each of
    :data:`BLOCK_RULE_SIZES` squared, beside ``torch.mm``: one
    ``kernel_check`` line each, then one ``block_rule`` line with the block
    ``ops.matmul_block`` picks on this card, which must time within
    :data:`BLOCK_RULE_SLACK` of the other — the burn-in's default block
    (the ``torch`` component's 512^2 among them) against ``torch.mm``."""
    sms = ops.sm_count(torch.device("cuda"))
    out = []
    for n in BLOCK_RULE_SIZES:
        a, b = bf16(n, n), bf16(n, n)
        ms = {}
        for block in ops.MATMUL_BLOCKS:
            rec = record(f"matmul_bf16_f32 {n}^2 block {block}", source,
                         "tpu_operator/validator/microbench.py:130",
                         _matmul_err(torch, ops, a, b, 0, block), tol,
                         lambda: ops.matmul_bf16_f32(a, b, block=block),
                         lambda: ops.matmul_bf16_f32_plain(a, b),
                         lambda: torch.mm(a, b), 200 if n <= 1024 else 20,
                         2 * n * n * 2 + n * n * 4, 2.0 * n ** 3,
                         PEAK_BF16_FLOPS, keep=False)
            ms[block] = rec["ms"]
            library = rec["library_ms"]
        chosen = ops.matmul_block(n, n, sms)
        other = min(b_ for b_ in ms if b_ != chosen)
        out.append({"size": n, "ms_by_block": ms, "chosen": chosen,
                    "chosen_over_other": ms[chosen] / ms[other],
                    "library_ms": library,
                    "chosen_over_library": ms[chosen] / library})
        del a, b
    print(json.dumps({"block_rule": {"sms": sms, "sizes": out}}), flush=True)
    _require(all(r["chosen_over_other"] <= BLOCK_RULE_SLACK for r in out),
             f"ops.matmul_block picks the slower block: {out}")
    return out


def _stacked(torch, blocks, along: int):
    """Blocks laid end to end along ``along`` as one bf16 operand."""
    return torch.cat([t.bfloat16() for t in blocks], dim=along)


def train_step_products(torch, ops, g, record, source: str) -> None:
    """The train step's products on the card as ``ops.MatmulBf16F32``
    launches them — forward, and each backward product through
    ``torch.autograd.grad`` with only its input needing a gradient — at
    the full-width step's shapes on this machine's mesh (``d_in`` 128,
    ``d_hidden`` 256 over the model axis, 8 rows per rank) and at
    ``entry()``'s 32 x 128 batch.  Each is held against the function it
    computes in plain f32 (TF32 off): relative error, max |d| over the
    largest |want|, within 1e-4; against the kernel's own arithmetic in
    plain PyTorch (the cotangent's three bf16 terms stacked along K) as
    ``max_abs_err``; and timed beside that plain version and ``torch.mm``
    on the same inputs (bf16 operands forward; the f32 product backward).
    One kernels-line record each, its launches counted as
    ``matmul_bf16_f32``'s."""
    from tpu_operator_torch.validator import workloads as wl

    dev = torch.device("cuda")
    model = wl.default_mesh_shape(torch.cuda.device_count())[1]
    d_in, d_h, rows = 128, 256 // model, 8

    def bf16_valued(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16().float()

    def f32(*shape):
        return torch.randn(shape, generator=g, device=dev) * 1e-2

    x, w1 = bf16_valued(rows, d_in), bf16_valued(d_in, d_h)
    h, w2 = bf16_valued(rows, d_h), bf16_valued(d_h, d_in)
    g_out, g_pre = f32(rows, d_in), f32(rows, d_h)
    ex, ew1 = bf16_valued(32, d_in), bf16_valued(d_in, 256)
    eh, ew2 = bf16_valued(32, 256), bf16_valued(256, d_in)
    # (name, A, B, the input whose gradient it is or None, cotangent)
    products = (("step forward x.W1", x, w1, None, None),
                ("step forward h.W2", h, w2, None, None),
                ("step backward dW2 = h^T.g", h, w2, 1, g_out),
                ("step backward dh = g.W2^T", h, w2, 0, g_out),
                ("step backward dW1 = x^T.g", x, w1, 1, g_pre),
                ("entry forward x.W1", ex, ew1, None, None),
                ("entry forward h.W2", eh, ew2, None, None))
    checked = []
    for name, a, b, wrt, cot in products:
        if wrt is None:
            def kernel(a=a, b=b):
                return ops.MatmulBf16F32.apply(a, b)
            a16, b16 = a.bfloat16(), b.bfloat16()
            plain = lambda a16=a16, b16=b16: ops.matmul_bf16_f32_plain(a16,
                                                                       b16)
            library = lambda a16=a16, b16=b16: torch.mm(a16, b16)
            want_fn = plain
            (m, k), n = a.shape, b.shape[1]
        else:
            ins = [a.clone().requires_grad_(wrt == 0),
                   b.clone().requires_grad_(wrt == 1)]
            out = ops.MatmulBf16F32.apply(*ins)

            def kernel(out=out, inp=ins[wrt], cot=cot):
                return torch.autograd.grad(out, inp, cot,
                                           retain_graph=True)[0]
            terms = ops.split_bf16x3(cot)
            if wrt == 0:              # g . B^T
                sa, sb = _stacked(torch, terms, 1), _stacked(
                    torch, [b.t()] * 3, 0)
                want_fn = lambda cot=cot, b=b: cot @ b.t()
                m, k, n = cot.shape[0], cot.shape[1], b.shape[0]
            else:                     # A^T . g
                sa, sb = _stacked(torch, [a.t()] * 3, 1), _stacked(
                    torch, terms, 0)
                want_fn = lambda cot=cot, a=a: a.t() @ cot
                m, k, n = a.shape[1], a.shape[0], cot.shape[1]
            plain = lambda sa=sa, sb=sb: ops.matmul_bf16_f32_plain(sa, sb)

            def library(want_fn=want_fn):
                with ops.no_tf32():
                    return want_fn()
        # f32 operands (bf16-valued, as the step hands them over), f32 out
        nbytes = (m * k + k * n) * 4 + m * n * 4
        with ops.no_tf32():
            want = want_fn()
        got = kernel()
        torch.cuda.synchronize()
        rel = float((got - want).abs().max() / want.abs().max())
        err = float((got - plain()).abs().max())
        checked.append({"product": name, "m": m, "k": k, "n": n,
                        "rel_err": rel, "max_abs_err": err})
        _require(got.shape == want.shape and rel <= 1e-4,
                 f"{name}: the Function on the card is {rel} off the f32 "
                 "product")
        record(f"matmul_bf16_f32 {name} {m}x{k}x{n}", source,
               "tpu_operator/validator/microbench.py:130", err,
               "max|d| <= 1e-4 * max|want| against the f32 product",
               kernel, plain, library, 100, nbytes, 2.0 * m * k * n,
               PEAK_BF16_FLOPS,
               # a shape of a kernel whose launches count under its route
               extra={"counted_as": "matmul_bf16_f32",
                      "rel_err_vs_f32": rel, "shape": [m, k, n],
                      "ms_includes": "padding copies, the cotangent's "
                                     "split, autograd's backward call",
                      "matmul_kernel_ms": _device_ms(
                          torch, kernel, 100, "matmul_bf16_f32_kernel")})
    print(json.dumps({"train_step_products": checked}), flush=True)


def torch_component_rates(workloads) -> None:
    """The torch component's workloads at its sizes (burn-in 512^2 x 4
    iterations, memory stress 64 MiB x 2): their reported marginal rates
    and the length ``hi`` of the long chain each one's escalation stopped
    at (the matmul kernel's own time at 512^2 is a kernel_check line)."""
    burn = workloads.matmul_burn_in(size=512, iters=4)
    _require(burn.ok, f"burn-in failed: {burn.detail}")
    stress = workloads.hbm_stress(mib=64, iters=2)
    _require(stress.ok, f"memory stress failed: {stress.detail}")
    hi = {name: int(re.search(r" x (\d+)$", rep.detail)[1])
          for name, rep in (("burn_in", burn), ("hbm_stress", stress))}
    print(json.dumps({"torch_component": {
        "burn_in_tflops": burn.value, "burn_in_detail": burn.detail,
        "burn_in_s": burn.duration_s, "burn_in_hi": hi["burn_in"],
        "hbm_stress_gibs": stress.value, "hbm_stress_detail": stress.detail,
        "hbm_stress_s": stress.duration_s,
        "hbm_stress_hi": hi["hbm_stress"]}}), flush=True)


def graph_chains(torch, ops, workloads) -> None:
    """Each chain the validator replays as CUDA graphs, held against the
    same steps launched one by one: the burn-in's at the probe's 2048^2
    (block 128, kt=0), the perf probe's triad at 32768 x 2048 (256
    threads) and the memory stress's at 128 MiB, each at 37 steps (two
    units and a remainder) and at its probe's long chain (512, 64, 128).
    The replayed state must equal the eager one bit for bit, at the run
    that captures and at one that only replays; the launch counts of the
    replaying run must equal the eager run's (the capturing run adds one
    counted warm-up step)."""
    from tpu_operator_torch.validator.graphs import ChainGraphs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x, w = (torch.randn((2048, 2048), generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    a, b = (torch.randn((32768, 2048), generator=g, device=dev)
            for _ in range(2))
    sb, sc = (torch.randn(128 * 1024 * 1024 // 4, generator=g, device=dev)
              for _ in range(2))
    chains = (
        ("burn_in", lambda acc: workloads._burn_in_step(acc, w, 128, 0), x,
         512),
        ("probe_triad", lambda acc: ops.triad_(acc, b, 0.25, threads=256), a,
         64),
        ("stress_triad", lambda acc: workloads._triad_step(acc, sc), sb, 128),
    )
    out = []
    for name, step, init, wide in chains:
        for n in (37, wide):
            ops.reset_launches()
            want = init.clone()
            for _ in range(n):
                want = step(want)
            torch.cuda.synchronize()
            eager = dict(ops.LAUNCHES)
            runs = []
            with ChainGraphs() as graphs:
                for _ in range(2):
                    ops.reset_launches()
                    got = graphs.run(name, step, init, n)
                    torch.cuda.synchronize()
                    runs.append((bool(torch.equal(got, want)),
                                 dict(ops.LAUNCHES)))
                    del got
                replays, rest = graphs.plan(n)
            del want
            rec = {"chain": name, "n": n, "replays": replays, "rest": rest,
                   "bit_equal": [eq for eq, _ in runs],
                   "launches_eager": eager,
                   "launches_capturing_run": runs[0][1],
                   "launches_replaying_run": runs[1][1]}
            out.append(rec)
            _require(all(rec["bit_equal"]),
                     f"replayed {name} x {n} differs from the eager chain")
            _require(runs[1][1] == eager,
                     f"replayed {name} x {n} counted {runs[1][1]}, the eager "
                     f"chain {eager}")
    del x, w, a, b, sb, sc
    torch.cuda.empty_cache()
    print(json.dumps({"graph_chains": out}), flush=True)


def _chain_split(torch, run, iters: int) -> dict:
    """For a chain ``run(n)`` of n steps ending in a fetched scalar: wall ms
    per step at ``iters`` steps and at 8x as many (best of five, after
    one untimed call each), the marginal wall ms per step between the two
    (what the probe's two-point rate reads: a call's fixed cost cancels),
    the device's kernel ms per step at ``iters`` from torch.profiler, the
    kernels by name, and the device's idle share of each wall time."""
    from torch.profiler import ProfilerActivity, profile

    def wall(n: int) -> float:
        float(run(n))
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            float(run(n))
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    short, long = wall(iters), wall(8 * iters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        float(run(iters))
    kernels = {e.key: e.self_device_time_total / iters / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0}
    device_ms = sum(kernels.values())
    marginal = (long - short) / (7 * iters)
    return {"wall_ms_per_iter": short / iters,
            "device_ms_per_iter": device_ms,
            "device_idle_share": 1.0 - device_ms * iters / short,
            "marginal_wall_ms_per_iter": marginal,
            "marginal_idle_share": 1.0 - device_ms / marginal,
            "kernel_ms_per_iter": kernels}


def probe_chain_profile(torch, workloads) -> float:
    """Where a step of the perf probe's matmul chain goes (2048^2, block
    128, kt=0: matmul, then abs, max, add, div and cast to bf16) at the
    probe's long chain (512 steps), replayed as CUDA graphs as the probe
    runs it and launched step by step: for each, wall ms per step, device
    ms per step from torch.profiler and the device's idle share, per call
    and between 512 and 4096 steps.  From the eager chain's kernels, the
    chain's device rate and the rate it would read with the matmul at
    half speed (the matmul's time doubled, the renormalisation's kept):
    the tensor-core floor must lie above the latter.  Returns that
    half-rate reading in TFLOP/s."""
    from tpu_operator_torch.validator.graphs import ChainGraphs

    g = torch.Generator(device="cuda").manual_seed(0)
    a, b = (torch.randn((2048, 2048), generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    iters = 512

    def eager(n: int):
        acc = a
        for _ in range(n):
            acc = workloads._burn_in_step(acc, b, 128, 0)
        return acc.float().sum()

    split = {"eager": _chain_split(torch, eager, iters)}
    with ChainGraphs() as graphs:
        split["replayed"] = _chain_split(
            torch, lambda n: workloads._burn_in_fn(a, b, n, block=128,
                                                   graphs=graphs), iters)
    kernels = split["eager"]["kernel_ms_per_iter"]
    matmul_ms = sum(ms for name, ms in kernels.items() if "matmul" in name)
    other_ms = sum(kernels.values()) - matmul_ms
    flop = 2.0 * 2048 ** 3
    rates = {"matmul_ms_per_iter": matmul_ms,
             "renormalise_ms_per_iter": other_ms,
             "device_rate_tflops": flop / (matmul_ms + other_ms) / 1e9,
             "half_rate_tflops": flop / (2 * matmul_ms + other_ms) / 1e9}
    print(json.dumps({"probe_chain_2048": {"iters": iters, **split,
                                           **rates}}), flush=True)
    _require(matmul_ms > 0 and other_ms > 0,
             f"the eager chain's kernels are not all seen: {kernels}")
    _require(split["replayed"]["device_ms_per_iter"] > 0,
             "the profiler saw no kernel of the replayed chain")
    return rates["half_rate_tflops"]


def perf_gate(torch, microbench, half_rate: float) -> None:
    """The perf component in this process, gate enforced, as the validator
    pod's init container runs it: both probes must pass their floors on
    the card, ``perf-report`` must carry the readings, both floors and
    ``enforced: true``, ``perf-ready`` must be written, and the
    tensor-core floor must lie above the half-rate reading.  Then both
    probes with their fractions raised above what the card read must
    report not ok, naming the floor."""
    from tpu_operator_torch import statusfiles
    from tpu_operator_torch.validator.components import Context, run_component

    gen = microbench.chip_generation()
    _require(gen in microbench.CHIP_PEAKS, f"no floors for this card: {gen!r}")
    with tempfile.TemporaryDirectory() as status:
        t0 = time.perf_counter()
        run_component("perf", Context(status_dir=status, device="cuda"))
        seconds = time.perf_counter() - t0
        report = statusfiles.read_status("perf-report", status) or {}
        ready = os.path.exists(os.path.join(status, "perf-ready"))
    print(json.dumps({"perf_report": {**report,
                                      "mxu_half_rate_tflops": half_rate,
                                      "seconds": seconds,
                                      "perf_ready": ready}}), flush=True)
    _require(ready and report.get("enforced") == "true"
             and all(report.get(f"{p}-probe_ok") == "true"
                     for p in ("vpu", "mxu", "hbm")),
             f"the perf gate failed a healthy card: {report}")
    floors = {k: float(report[f"{k}_floor"]) for k in ("mxu_tflops",
                                                       "hbm_gibs")}
    _require(floors["mxu_tflops"] > half_rate,
             f"the tensor-core floor {floors['mxu_tflops']} does not lie "
             f"above the half-rate reading {half_rate}")

    tflops, gbs = microbench.CHIP_PEAKS[gen]
    saved = microbench.MXU_GATE_FRACTION, microbench.HBM_GATE_FRACTION
    microbench.MXU_GATE_FRACTION = 1.5 * float(report["mxu_tflops"]) / tflops
    microbench.HBM_GATE_FRACTION = (1.5 * float(report["hbm_gibs"])
                                    * 1.073741824 / gbs)
    try:
        forced = [microbench.mxu_probe(enforce=True),
                  microbench.hbm_probe(enforce=True)]
    finally:
        microbench.MXU_GATE_FRACTION, microbench.HBM_GATE_FRACTION = saved
    print(json.dumps({"perf_gate_forced": [r.to_dict() for r in forced]}),
          flush=True)
    _require(all(not r.ok and r.floor and r.value < r.floor
                 and f"floor {r.floor:.0f} [{gen}]" in r.detail
                 for r in forced),
             f"a probe passed a floor above its reading: "
             f"{[r.detail for r in forced]}")


def _sweep(microbench, flag: str) -> dict:
    """One sweep leg of the bench (``microbench --mxu-sweep`` or
    ``--hbm-sweep``, two reps a point) as the JSON it prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = microbench.main([flag, "--reps=2"])
    _require(rc == 0, f"microbench {flag} exited {rc}")
    return json.loads(out.getvalue())


def _cli(validator_main, args) -> tuple:
    """One run of the validator CLI: (rc, seconds, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = validator_main(args)
    return rc, time.perf_counter() - t0, out.getvalue(), err.getvalue()


def _samples(text: str) -> dict:
    """A Prometheus text page as (name, labels) -> value."""
    samples = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            series, _, value = line.rpartition(" ")
            name, _, labels = series.partition("{")
            samples[(name, labels.rstrip("}"))] = float(value)
    return samples


def _get(port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as resp:
        return resp.read().decode()


# every exporter page this run scraped, for the names legs
SCRAPED_PAGES: list = []


def _scrape(port: int) -> dict:
    """One scrape of the exporter: (name, labels) -> value."""
    page = _get(port)
    SCRAPED_PAGES.append(page)
    return _samples(page)


# --------------------------------------------------------------------------
# the names legs: no name of the JAX package leaves the port
# --------------------------------------------------------------------------

#: a JAX package's name, case aside (``(?i)tpu|libtpu|megascale|jax|
#: \bici\b|ici[-_]``), but for a "tpu" inside a word of its own case
#: ("output", "OUTPUT"), which names nothing
NAMES_BANNED = re.compile(r"(?<![a-z])[tT]pu|(?<![A-Z])TPU|"
                          r"(?i:libtpu|megascale|jax|\bici\b|ici[-_])")
#: what may carry one of those words, and why
NAMES_ALLOWED_WHY = {
    r"tpu_operator_torch(?:[./][A-Za-z_]\w*)*":
        "the port's Python package: a module path in an argv "
        "(python -m ...), a module or file name; the package keeps the "
        "JAX package's name so a reader finds each module's counterpart",
    r"TPU_OPERATOR_TORCH_BUILD_DIR":
        "the kernels' build dir variable, named after the package",
}
NAMES_ALLOWED = re.compile("|".join(NAMES_ALLOWED_WHY))
# files of the node's dirs whose contents are read (the build dir's are
# the kernels' and the daemon's build outputs: their paths only)
NAMES_CONTENT_BYTES = 1 << 20


def names_banned(text: str) -> list:
    """The banned words in ``text`` outside an allowed span."""
    return NAMES_BANNED.findall(NAMES_ALLOWED.sub("", text))


def names_strings(obj, path: str = ""):
    """``(path, string)`` for every key and string value in ``obj``."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield f"{path}/{k}", str(k)
            yield from names_strings(v, f"{path}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from names_strings(v, f"{path}[{i}]")
    elif isinstance(obj, str):
        yield path, obj


def _object_key(o: dict) -> tuple:
    md = o.get("metadata", {})
    return (o.get("kind"), md.get("namespace", ""), md.get("name"))


def names_leg(where: str, objects: list, node_root: str, pages: list,
              envs: list, snapshot_dirs: list) -> dict:
    """What the port wrote in the phase, read for a JAX package's name
    (:func:`names_banned`): every object the stub apiserver held (every
    key and string), every path under the node's mapped dirs
    ``node_root`` and the contents of its files outside the build dir,
    every path under the informer's ``snapshot_dirs`` and each snapshot
    file's header line, every family and series of the scrape ``pages``,
    and every env name and value the rendered containers that ran as
    children were given.  Prints the ``names`` line (counts by category,
    the banned hits) and fails on any hit."""
    counts = {"objects": len(objects), "object_strings": 0, "paths": 0,
              "files_read": 0, "snapshot_paths": 0, "snapshot_headers": 0,
              "page_series": 0, "envs": len(envs), "env_vars": 0}
    hits = []

    def check(category, text, origin):
        for word in names_banned(text):
            hits.append({"in": category, "at": origin, "word": word,
                         "text": text[:160]})

    for o in objects:
        md = o.get("metadata", {})
        origin = f"{o.get('kind')}/{md.get('namespace', '')}/{md.get('name')}"
        for _, text in names_strings(o):
            counts["object_strings"] += 1
            check("objects", text, origin)
    build = os.path.join(node_root, "run", "gpu", "build")
    for dirpath, dirnames, filenames in os.walk(node_root):
        for name in dirnames + filenames:
            path = os.path.join(dirpath, name)
            rel = "/" + os.path.relpath(path, node_root)
            counts["paths"] += 1
            check("paths", rel, rel)
            if name in filenames and not path.startswith(build + os.sep) \
                    and os.path.getsize(path) <= NAMES_CONTENT_BYTES:
                with open(path, errors="replace") as f:
                    counts["files_read"] += 1
                    check("files", f.read(), rel)
    for top in snapshot_dirs:
        for dirpath, dirnames, filenames in os.walk(top):
            for name in dirnames + filenames:
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, os.path.dirname(top))
                counts["snapshot_paths"] += 1
                check("snapshot", rel, rel)
                if name in filenames:
                    with open(path, "rb") as f:
                        header = f.readline(64).decode(errors="replace")
                    counts["snapshot_headers"] += 1
                    check("snapshot", header, rel)
    for page in pages:
        for line in page.splitlines():
            if line and not line.startswith("# HELP"):
                counts["page_series"] += 1
                check("pages", line, line.split("{")[0].split()[-1])
    for env in envs:
        for k, v in env.items():
            counts["env_vars"] += 1
            check("envs", f"{k}={v}", k)
    _require(counts["snapshot_headers"] > 0,
             f"no informer snapshot to read in {snapshot_dirs}")
    out = {"where": where, "counts": counts, "banned": len(hits),
           "hits": hits[:20]}
    print(json.dumps({"names": out}), flush=True)
    _require(not hits, f"a JAX package's name left the port: {hits[:5]}")
    return out


def node_chain(torch, metadata_dir: str) -> dict:
    """The node's agents on the live host (``--host-root=/``), each step
    timed: discovery through NVML and through the Python scanner (they
    must agree, and NVML's UUIDs must be torch's cards); the driver
    DaemonSet's barrier; the CDI spec and the containerd drop-in + main
    config written with the port's toolkit into temporary dirs; the device
    plugin and the ``plugin`` component on that spec.  The driver agent
    mirrors the node's metadata into ``metadata_dir``.  The validator's
    chain itself runs once, as the rendered validator's children in the
    ``operator`` phase (:func:`validated_node`).  Returns the launch counts
    of the plugin component's pod."""
    from tpu_operator_torch import consts, nativelib, statusfiles
    from tpu_operator_torch.driver.__main__ import main as driver_main
    from tpu_operator_torch.host import host_for_root
    from tpu_operator_torch.toolkit.__main__ import main as toolkit_main

    seconds = {}
    t0 = time.perf_counter()
    host = host_for_root("/")
    _require(nativelib.load_nvml() is not None,
             "NVML (libnvidia-ml.so.1) did not load")
    raw = nativelib.enumerate_chips(host.dev_root, host.sys_root)
    native = host._discover_chips_native()
    scanned = host._discover_chips_py()
    inv = host.discover()
    n = torch.cuda.device_count()
    torch_uuids = sorted(str(torch.cuda.get_device_properties(i).uuid)
                         .removeprefix("GPU-") for i in range(n))
    torch_names = sorted(torch.cuda.get_device_name(i) for i in range(n))
    # the scanner's sources: where a host hides one (a sandbox), the
    # scanner reads that field as unknown
    sources = {
        "proc_driver_gpus": os.path.isdir(os.path.join(
            host.proc_root, "driver", "nvidia", "gpus")),
        "pci_tree": os.path.isdir(os.path.join(host.sys_root, "bus", "pci",
                                               "devices")),
        "module_version": bool(host.installed_driver_version())}
    print(json.dumps({"discovery": {
        "nvml": [vars(c) for c in native or []],
        "scanner": [vars(c) for c in scanned],
        "scanner_sources": sources,
        "scanner_only": sorted({c.index for c in scanned}
                               - {c.index for c in native or []}),
        "pci_device_ids": [c["pci_device_id"] for c in raw or []],
        "nvml_names": [c["name"] for c in raw or []],
        "nvml_driver_version": nativelib.driver_version(),
        "kernel_driver_version": host.installed_driver_version(),
        "inventory_driver_version": inv.driver_version,
        "torch_uuids": torch_uuids, "torch_names": torch_names}}),
        flush=True)
    _require(bool(native), "NVML enumerated no card")
    keys = ("index", "dev_path", "pci_address", "numa_node", "chip_type")
    if sources["proc_driver_gpus"] and sources["pci_tree"]:
        full = keys + ("nvml_index",)
        _require([{k: getattr(c, k) for k in full} for c in native]
                 == [{k: getattr(c, k) for k in full} for c in scanned],
                 "NVML and the Python scanner disagree")
    else:
        # every NVML card is a scanned device node, and each field the
        # scanner could read agrees
        by_index = {c.index: c for c in scanned}
        for c in native:
            s = by_index.get(c.index)
            _require(s is not None and s.dev_path == c.dev_path,
                     f"the scanner lists no {c.dev_path}")
            for k in keys[2:]:
                _require(getattr(s, k) in ("", -1, getattr(c, k)),
                         f"NVML and the scanner disagree on {k} of "
                         f"{c.dev_path}")
    nvml_uuids = sorted(c.uuid.removeprefix("GPU-") for c in native)
    if all(re.fullmatch(r"[0-9a-f]{8}(-[0-9a-f]{4}){3}-[0-9a-f]{12}", u)
           for u in nvml_uuids):
        _require(nvml_uuids == torch_uuids,
                 f"NVML's cards {nvml_uuids} are not torch's {torch_uuids}")
    else:
        # an NVML that hides the UUIDs: the same cards by count and name
        _require(sorted(c["name"] for c in raw) == torch_names,
                 f"NVML's cards {raw} are not torch's {torch_names}")
    _require(all(c.chip_type in ("h100-sxm", "h100-pcie") for c in native),
             f"chip types {[c.chip_type for c in native]}")
    seconds["discovery"] = time.perf_counter() - t0

    legs = {}
    with tempfile.TemporaryDirectory() as tmp:
        status_dir = os.path.join(tmp, "status")
        base = [f"--status-dir={status_dir}", "--host-root=/"]
        # the driver agent checks the node's driver and opens its barrier;
        # never vfio-bind or uninstall here: vfio-bind would unbind the card
        rc, seconds["driver_agent"], out, err = _cli(driver_main, [
            "install", "--one-shot", *base,
            f"--metadata-dir={metadata_dir}"])
        barrier = statusfiles.read_status(consts.DRIVER_CTR_READY, status_dir)
        print(json.dumps({"driver_agent": {
            "rc": rc, "seconds": seconds["driver_agent"],
            "stdout": out.strip(), "barrier": barrier}}), flush=True)
        _require(rc == 0, f"driver agent exited {rc}: {err.strip()}")
        _require(barrier["devices"] == ",".join(c.dev_path for c in native)
                 and barrier["device_mode"] == "accel"
                 and barrier["driver_version"] not in ("", "unknown"),
                 f"driver agent's barrier {barrier}")

        cdi_root = os.path.join(tmp, "cdi")
        conf_dir = os.path.join(tmp, "containerd", "conf.d")
        restarts = _toolkit_agent(toolkit_main, tmp, [
            "--one-shot", f"--cdi-root={cdi_root}",
            f"--containerd-conf-dir={conf_dir}", *base], seconds)
        endpoint = PluginEndpoint(host)
        try:
            devices, allocations = device_plugin(endpoint, native, seconds)
            legs["plugin_component"] = plugin_component(
                endpoint, devices, native, raw, cdi_root, seconds)
            # the last card alone, on a machine with more than one
            for alloc in allocations[1:]:
                in_pod(alloc, cdi_root, raw, seconds)
        finally:
            endpoint.close()
    print(json.dumps({"node_chain_seconds": seconds,
                      "containerd_restarts": restarts}), flush=True)
    return legs


def _recording_stubs(tmp: str) -> tuple:
    """``systemctl`` and ``nsenter`` stubs in ``<tmp>/bin`` that append
    their argv to ``<tmp>/restarts`` and exit 0; (bin dir, record)."""
    stubs, calls = os.path.join(tmp, "bin"), os.path.join(tmp, "restarts")
    os.makedirs(stubs)
    for name in ("systemctl", "nsenter"):
        with open(os.path.join(stubs, name), "w") as f:  # noqa: TPULNT306 - stubs, run's temp dir
            f.write(f'#!/bin/sh\necho "{name} $*" >> {calls}\n')
        os.chmod(os.path.join(stubs, name), 0o755)
    return stubs, calls


def _lines(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return f.read().splitlines()


def _toolkit_agent(toolkit_main, tmp: str, args: list, seconds: dict) -> list:
    """The toolkit agent, one shot, with ``systemctl`` and ``nsenter``
    stubs first on PATH that record their argv and exit 0: its restart of
    containerd is driven and checked without touching the host's service.
    Returns the recorded commands."""
    stubs, calls = _recording_stubs(tmp)
    path = os.environ["PATH"]
    os.environ["PATH"] = stubs + os.pathsep + path
    try:
        rc, seconds["toolkit_agent"], out, err = _cli(toolkit_main, args)
    finally:
        os.environ["PATH"] = path
    restarts = _lines(calls)
    print(json.dumps({"toolkit_agent": {
        "rc": rc, "seconds": seconds["toolkit_agent"], "stdout": out.strip(),
        "restarts": restarts}}), flush=True)
    _require(rc == 0, f"toolkit agent exited {rc}: {err.strip()}")
    _require(restarts == ["systemctl restart containerd"],
             f"containerd restarts issued: {restarts}")
    return restarts


def _version(module: str):
    """The module's version, or None where it does not import."""
    import importlib
    try:
        return getattr(importlib.import_module(module), "__version__", "?")
    except ImportError:
        return None


class PluginEndpoint:
    """The device plugin on the live host, seen from the kubelet's side:
    served over its unix socket and registered with the port's fake
    kubelet where ``grpc`` and protobuf import, else its logic in-process.
    Open from :meth:`start` until :meth:`close`, so the allocations of the
    plugin phase and of the workload pod come from one running plugin."""

    def __init__(self, host):
        self.host = host
        self.probe = {m: _version(m) for m in ("grpc", "google.protobuf",
                                                "yaml")}
        try:
            from tpu_operator_torch.deviceplugin import server  # noqa: F401
            from tpu_operator_torch.testing import grpc_kubelet  # noqa: F401
            self.transport = "grpc"
        except ImportError as e:
            self.transport = f"in-process ({e})"
        self.registered = None
        self._dir = self._server = self._registry = self._client = None

    def start(self) -> None:
        if self.transport != "grpc":
            return
        from tpu_operator_torch.deviceplugin.__main__ import load_config
        from tpu_operator_torch.deviceplugin.server import DevicePluginServer
        from tpu_operator_torch.testing.grpc_kubelet import (
            DevicePluginClient, FakeKubeletRegistry)

        self._dir = tempfile.mkdtemp(prefix="dp")
        self._registry = FakeKubeletRegistry(os.path.join(self._dir,
                                                          "kubelet.sock"))
        self._server = DevicePluginServer(self.host, plugin_dir=self._dir,
                                          config=load_config(""))
        self._server.start()
        self._server.register_with_kubelet(self._registry.socket_path)
        _require(self._registry.wait_for_registration(10),
                 "the plugin never registered")
        reg = self._registry.requests[0]
        self.registered = {"resource_name": reg.resource_name,
                           "endpoint": reg.endpoint, "version": reg.version}
        self._client = DevicePluginClient(self._server.socket_path)

    def devices(self) -> list:
        """One ListAndWatch: (ID, health, NUMA nodes) per device."""
        if self._client is not None:
            return [(x.ID, x.health, [n.ID for n in x.topology.nodes])
                    for x in self._client.list_and_watch_once(timeout=30)]
        from tpu_operator_torch.deviceplugin import plugin
        return [(x.ID, x.health, [x.numa] if x.numa >= 0 else [])
                for x in plugin.build_devices(self.host)]

    def preferred(self, ids: list, size: int) -> list:
        if self._client is not None:
            return list(self._client.preferred(ids, size))
        from tpu_operator_torch.deviceplugin import plugin
        return plugin.preferred_allocation(plugin.build_devices(self.host),
                                           ids, [], size)

    def allocate(self, ids: list) -> dict:
        """CDI names, env and device nodes of one Allocate."""
        if self._client is not None:
            resp = self._client.allocate(ids)
            return {"cdi_devices": [c.name for c in resp.cdi_devices],
                    "envs": dict(resp.envs),
                    "devices": [x.host_path for x in resp.devices]}
        from tpu_operator_torch.deviceplugin import plugin
        from tpu_operator_torch.deviceplugin.sharing import (
            DEFAULT_RESOURCE_NAME, parse_sharing)
        a = plugin.allocate(self.host.discover(), ids,
                            resource_name=DEFAULT_RESOURCE_NAME,
                            sharing=parse_sharing(None),
                            control_nodes=plugin.control_nodes(self.host,
                                                               "accel"))
        return {"cdi_devices": a.cdi_devices, "envs": a.envs,
                "devices": a.devices}

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
        if self._server is not None:
            self._server.stop()
        if self._registry is not None:
            self._registry.stop()
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)


def device_plugin(endpoint: PluginEndpoint, native, seconds: dict) -> list:
    """The device plugin on the live host: started and registered, then one
    ``ListAndWatch``, ``GetPreferredAllocation`` and ``Allocate`` for every
    card (and for the last card alone on a machine with more than one).
    Requires one Healthy device per NVML card, keyed by its minor, with its
    NUMA node where NVML gives one.  Returns the devices and the
    allocations (CDI names, env, device nodes)."""
    from tpu_operator_torch.deviceplugin import plugin

    print(json.dumps({"plugin_probe": endpoint.probe,
                      "transport": endpoint.transport}), flush=True)
    t0 = time.perf_counter()
    requests = [None]           # None: every card; then the last card alone
    if len(native) > 1:
        requests.append(str(native[-1].index))
    endpoint.start()
    devices = endpoint.devices()
    ids = [x[0] for x in devices]
    preferred = endpoint.preferred(ids, len(ids))
    allocations = [endpoint.allocate(preferred if req is None else [req])
                   for req in requests]
    seconds["plugin"] = time.perf_counter() - t0
    registered = endpoint.registered
    print(json.dumps({"device_plugin": {
        "transport": endpoint.transport, "registered": registered,
        "devices": devices, "preferred": preferred,
        "allocations": allocations, "seconds": seconds["plugin"]}}),
        flush=True)

    host = endpoint.host
    want = [(str(c.index), "Healthy",
             [c.numa_node] if c.numa_node >= 0 else []) for c in native]
    _require(devices == want, f"the plugin advertised {devices}, the host's "
                              f"cards are {want}")
    _require(sorted(preferred) == sorted(ids),
             f"preferred allocation {preferred} of {ids}")
    if registered is not None:
        _require(registered == {"resource_name": "nvidia.com/gpu",
                                "endpoint": "gpu-operator.sock",
                                "version": "v1beta1"},
                 f"registration {registered}")
    for req, alloc in zip(requests, allocations):
        cards = native if req is None else native[-1:]
        want_nodes = [c.dev_path for c in cards] + plugin.control_nodes(
            host, "accel")
        want_cdi = (["nvidia.com/gpu=all"] if req is None
                    else [f"nvidia.com/gpu={req}"])
        want_visible = ",".join(str(i) for i in sorted(c.nvml_index
                                                       for c in cards))
        _require(alloc["cdi_devices"] == want_cdi
                 and alloc["devices"] == want_nodes
                 and alloc["envs"]["NVIDIA_VISIBLE_DEVICES"] == want_visible,
                 f"allocation of {req or 'every card'}: {alloc}")
        alloc["cards"] = [c.nvml_index for c in cards]
    return devices, allocations


# the workload pod's command, as the plugin component writes it
POD_COMMAND = ["python", "-m", "tpu_operator_torch.validator"]
POD_ARGS = ["--component=nccl", "--in-pod"]


# a pod container's module's main on its args in a child process, then the
# names of the cards it saw (where it started CUDA) and the kernel launches
# it made (where it loaded the kernels' wrappers).  The one thing a
# container runtime would give it that this child cannot have is the
# in-cluster API server: where ``api`` is set, the module's client factory
# is pointed at that server instead.  Where ``stages`` is set (a component
# that launches kernels), the child takes the steps that component would
# take first, one at a time, and prints when each ended (perf_counter, the
# parent's clock too): ``import torch``, the CUDA context, the kernel
# library (built, or found in the build root), then the component.
_CHILD_CODE = """\
import time
ended = dict(start=time.perf_counter())
import importlib, json, sys
if {stages!r}:
    import torch
    ended["import_torch"] = time.perf_counter()
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    ended["cuda_context"] = time.perf_counter()
    from tpu_operator_torch.validator import _build
    dev = torch.cuda.current_device()
    built = (_build.build_root() / _build.fingerprint(
        torch.cuda.get_device_name(dev), torch.cuda.get_device_capability(dev))
        / _build.LIB_NAME).exists()
    _build.load(torch.device("cuda", dev))
    ended["kernel_library"] = time.perf_counter()
mod = importlib.import_module({module!r} + ".__main__")
if {api!r} and hasattr(mod, "_default_client_factory"):
    from tpu_operator_torch.client.resilience import \\
        resilient_incluster_client
    mod._default_client_factory = lambda: resilient_incluster_client(
        api_server={api!r}, token="pod")
try:
    rc = mod.main({args!r})
except SystemExit as e:
    rc = e.code if isinstance(e.code, int) else 1
torch = sys.modules.get("torch")
if torch is not None and torch.cuda.is_initialized():
    print("names=" + json.dumps([torch.cuda.get_device_name(i)
                                 for i in range(torch.cuda.device_count())]))
ops = sys.modules.get("tpu_operator_torch.validator.ops")
print("launches=" + json.dumps(dict(ops.LAUNCHES) if ops else {{}}),
      flush=True)
if {stages!r}:
    ended["component"] = time.perf_counter()
    print("stages=" + json.dumps(dict(ended=ended, cache_hit=built,
                                      build_root=str(_build.build_root()))),
          flush=True)
sys.exit(rc)
"""

# the components whose children take their steps one at a time (each
# launches kernels: the workload pod's nccl check its train steps')
STAGED = {"--component=torch", "--component=perf", "--component=nccl"}


def child_stages(stdout: str, seconds: float, t0: float):
    """A staged child's seconds, split: interpreter start, ``import
    torch``, CUDA context, kernel library, the component's own work and the
    exit; with whether the library was there already.  None for a child
    that was not staged.  ``t0`` is when it was spawned (perf_counter)."""
    m = re.search(r"^stages=(.*)$", stdout, re.M)
    if m is None:
        return None
    got = json.loads(m.group(1))
    ended = got["ended"]
    marks = [("interpreter", t0), ("import_torch", ended["start"]),
             ("cuda_context", ended["import_torch"]),
             ("kernel_library", ended["cuda_context"]),
             ("component", ended["kernel_library"])]
    split = {}
    for (name, since), until in zip(marks, [ended["start"],
                                           ended["import_torch"],
                                           ended["cuda_context"],
                                           ended["kernel_library"],
                                           ended["component"]]):
        split[name] = until - since
    split["exit"] = t0 + seconds - ended["component"]
    split["kernel_cache_hit"] = got["cache_hit"]
    split["build_root"] = got["build_root"]
    return split


def child_argv(command: list, args: list, api: str = "",
               stages: bool = False) -> list:
    """The argv of a pod container's child: :data:`_CHILD_CODE` running
    the module that ``command`` (``python -m <module>``) names on
    ``args``."""
    import importlib.util

    _require(command[:2] == ["python", "-m"] and len(command) == 3
             and importlib.util.find_spec(command[2]) is not None,
             f"the container's command {command} is no module of the "
             f"checkout")
    return [sys.executable, "-c", _CHILD_CODE.format(
        module=command[2], args=list(args), api=api, stages=stages)]


def allocation_env(alloc: dict, cdi_root: str, env: dict) -> dict:
    """``env`` with what a container runtime gives a container on the
    device plugin's allocation: the allocation's CDI devices resolved
    against the toolkit agent's spec, their env and the allocation's."""
    from tpu_operator_torch.toolkit import resolve

    specs = resolve.load_specs([cdi_root])
    for name in alloc["cdi_devices"]:
        env.update(resolve.simulate_container(
            resolve.resolve_device(specs, name)))
    env.update(alloc["envs"])
    # the NVIDIA runtime hook's job: show the container the cards that
    # NVIDIA_VISIBLE_DEVICES names, NVML indices, which are PCI bus order
    env["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"
    env["CUDA_VISIBLE_DEVICES"] = env["NVIDIA_VISIBLE_DEVICES"]
    return env


def script_argv(command: list, args: list) -> list:
    """The argv of a pod container that runs a script of the checkout
    (``python3 <script>``) on ``args``."""
    _require(len(command) == 2 and command[0] in ("python", "python3")
             and os.path.isfile(os.path.join(HERE, command[1])),
             f"the container's command {command} is no script of the "
             f"checkout")
    return [sys.executable, os.path.join(HERE, command[1]), *args]


def pod_child(alloc: dict, cdi_root: str, command: list, args: list,
              env: dict = None):
    """The workload pod's container without a container runtime: the
    command in :func:`child_argv`'s child with the container's own
    ``env`` (its paths already mapped) and :func:`allocation_env`.
    Returns (the finished child, its seconds, the names of the cards it
    saw, the launches, the split of its seconds where it was staged)."""
    argv = child_argv(command, args, stages=bool(STAGED & set(args)))
    env = allocation_env(alloc, cdi_root, dict(os.environ) | (env or {}))
    t0 = time.perf_counter()
    child = subprocess.run(argv, env=env, cwd=HERE, capture_output=True,
                           text=True, timeout=300)
    secs = time.perf_counter() - t0
    names = re.search(r"^names=(.*)$", child.stdout, re.M)
    launches = re.search(r"^launches=(.*)$", child.stdout, re.M)
    return (child, secs, names and json.loads(names.group(1)),
            launches and json.loads(launches.group(1)),
            child_stages(child.stdout, secs, t0))


def _check_pod_child(child, names, alloc: dict, raw: list) -> None:
    """The pod passed, seeing exactly the allocated cards by name."""
    seen = re.search(r"devices=(\d+)", child.stdout)
    by_nvml = {c["nvml_index"]: c["name"] for c in raw}
    want = [by_nvml[i] for i in alloc["cards"]]
    _require(child.returncode == 0 and seen is not None
             and int(seen.group(1)) == len(alloc["cards"]),
             f"in-pod nccl on cards {alloc['cards']}: rc "
             f"{child.returncode}, {child.stdout.strip()} "
             f"{child.stderr.strip()[-2000:]}")
    _require(names == want, f"the pod saw {names}, allocated {want}")


def _check_workload_child(pod: dict, node_dir: str) -> None:
    """The workload pod's child loaded the library from the node's build
    dir (``node_dir``'s mapping of the pod's ``kernel-cache`` volume) with
    no compile, and on one card its burn-in's two train steps launched the
    matmul five times each and no other kernel (on more cards the ranks
    are processes of their own)."""
    stages, launches = pod["stages"], pod["launches"] or {}
    _require(stages is not None and stages["kernel_cache_hit"]
             and stages["build_root"].startswith(node_dir + os.sep),
             f"the workload pod's child did not load the node's kernel "
             f"build: {stages}, mounts {pod['mounts']}")
    _require(len(pod["allocation"]["cards"]) > 1 or launches == dict(
        dict.fromkeys(launches, 0), matmul_bf16_f32=10),
        f"the in-pod nccl check launched {launches}, want 10 matmuls")


def in_pod(alloc: dict, cdi_root: str, raw: list, seconds: dict) -> None:
    """The plugin-workload pod's command on one allocation without a
    kubelet: ``--component=nccl --in-pod`` in a child with the env the CDI
    spec and the allocation give, which must pass seeing exactly the
    allocated cards, each by its name."""
    child, secs, names, launches, _ = pod_child(alloc, cdi_root,
                                                POD_COMMAND, POD_ARGS)
    leg = f"in_pod_{'-'.join(map(str, alloc['cards']))}"
    seconds[leg] = secs
    print(json.dumps({"in_pod": {
        "cards": alloc["cards"], "rc": child.returncode,
        "stdout": child.stdout.strip(), "stderr": child.stderr.strip()[-2000:],
        "launches": launches, "seconds": secs}}), flush=True)
    _check_pod_child(child, names, alloc, raw)


# --------------------------------------------------------------------------
# the gang member: what a user's training job does in a GPUWorkload's pod
# --------------------------------------------------------------------------

# the rendezvous contract the workload controller injects, which
# torch.distributed's env:// reads
GANG_CONTRACT = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
# printed once the process group formed and one round ran: the member is
# Ready
GANG_READY_LINE = "gang-member ready"
# a member no one tells to stop stops after this
GANG_MEMBER_SECONDS = 300.0


def gang_member(torch, device: str = "cuda", backend: str = "nccl",
                size: int = 512, iters: int = 4,
                seconds: float = GANG_MEMBER_SECONDS) -> dict:
    """A gang member's body: requires the rendezvous contract
    (:data:`GANG_CONTRACT`) and no ``JAX_*`` variable, forms the process
    group through ``init_process_group(backend, init_method="env://")``,
    then runs rounds of the ``torch`` validator component's burn-in
    (``matmul_burn_in`` at 512², 4 iterations: the hand-written matmul on
    the card) and one all-reduce of ``rank + 1``, which must sum to
    ``world·(world + 1)/2`` — until the file ``GANG_STOP_FILE`` names
    exists or ``seconds`` have passed.  Prints the group it formed,
    :data:`GANG_READY_LINE` after the first round and the kernel launches
    after each.  Returns what it did."""
    import torch.distributed as dist

    from tpu_operator_torch.validator import ops, workloads

    handed = sorted(k for k in os.environ if k.startswith("JAX_"))
    _require(not handed, f"the gang member was handed JAX variables: "
                         f"{handed}")
    missing = [k for k in GANG_CONTRACT if not os.environ.get(k)]
    _require(not missing, f"the gang member lacks {missing}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device == "cuda":
        torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group(backend, init_method="env://")
    try:
        print(json.dumps({"gang_member": {
            "rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": dist.get_backend(),
            "master": f"{os.environ['MASTER_ADDR']}:"
                      f"{os.environ['MASTER_PORT']}",
            "device": torch.cuda.get_device_name(0) if device == "cuda"
            else device,
            "formed_seconds": time.perf_counter() - t0}}), flush=True)
        stop = os.environ.get("GANG_STOP_FILE", "")
        rounds = 0
        while True:
            rep = workloads.matmul_burn_in(size=size, iters=iters,
                                           device=device)
            _require(rep.ok, f"the gang member's burn-in: {rep.detail}")
            t = torch.tensor([float(rank + 1)], device=device)
            dist.all_reduce(t)
            _require(t.item() == world * (world + 1) / 2,
                     f"the gang's all-reduce gave {t.item()}")
            rounds += 1
            print("launches=" + json.dumps(dict(ops.LAUNCHES)), flush=True)
            if rounds == 1:
                print(GANG_READY_LINE, flush=True)
            if (stop and os.path.exists(stop)) \
                    or time.perf_counter() - t0 > seconds:
                break
    finally:
        dist.destroy_process_group()
    return {"rank": rank, "world": world, "rounds": rounds,
            "seconds": time.perf_counter() - t0,
            "launches": dict(ops.LAUNCHES)}


def gang_member_main() -> int:
    """``chip_smoke.py --gang-member``: :func:`gang_member` on the card
    the pod was allocated, over NCCL."""
    import torch

    _require(torch.cuda.is_available(), "the gang member sees no card")
    out = gang_member(torch)
    print(json.dumps({"gang_member_done": out}), flush=True)
    return 0


class Kubelet(threading.Thread):
    """The node's kubelet, played in a thread of this script against the
    stub apiserver.  It writes the device plugin's Healthy devices into the
    Node's capacity, then runs each workload pod that appears — the
    plugin's preferred allocation and ``Allocate`` for the count the pod
    requests, the pod's own command and args in :func:`pod_child` on that
    allocation's env — and sets the pod's phase from the child's exit.

    Once ``daemonsets`` is set it also plays the node's part for the
    operator's DaemonSets (which needs ``tmp``, ``stubs`` and
    ``api_server``): for each DaemonSet whose node selector the node's
    labels meet it creates the pod; the pods of ``OPERATOR_RUN`` and of
    every driver DaemonSet (a ``GPUDriver``'s too) run their containers
    (:class:`_PodRun`), each from its ``command``, ``args`` and ``env`` as
    the stub holds them, the writable hostPath volumes mapped to temporary
    dirs under ``tmp``, the read-only ones bound to their host paths, and
    ``systemctl``/``nsenter`` first on PATH as the recording ``stubs``; the
    others are marked Running and Ready without running anything.  A pod
    that is deleted (or whose DaemonSet is) has its containers stopped; once
    it is gone, the DaemonSet's current template makes the next one — the
    ``OnDelete`` update the driver DaemonSets ask for.  Pod phase and
    readiness and each DaemonSet's status are written when they change
    (and logged in ``ready_log``).

    A gang member pod (``consts.WORKLOAD_NAME_LABEL``) runs in the
    background instead (:class:`_GangRun`), stopped when it is deleted;
    the kubelet plays cluster DNS for it (:meth:`resolve`)."""

    def __init__(self, client, endpoint: PluginEndpoint, devices: list,
                 node_name: str, namespace: str, resource: str,
                 cdi_root: str, api_server: str = "", tmp: str = "",
                 stubs: str = ""):
        super().__init__(name="kubelet", daemon=True)
        self.client, self.endpoint = client, endpoint
        self.devices, self.node_name = devices, node_name
        self.namespace, self.resource = namespace, resource
        self.cdi_root = cdi_root
        self.api_server, self.tmp, self.stubs = api_server, tmp, stubs
        self.logs = os.path.join(tmp, "logs")
        self.stop = threading.Event()
        self.advertised = threading.Event()   # the capacity is written
        self.pods = []           # one record per workload pod run
        self.error = None
        self.failed = threading.Event()       # set with ``error``
        self._events = queue.Queue()
        self.daemonsets = threading.Event()   # play the DaemonSets' pods
        self.runs = {}           # DS name -> _PodRun
        self.stopped = []        # the _PodRuns of deleted pods, in order
        self.created = 0         # DaemonSet pods created
        self.marked = []         # DS names marked rolled out, not run
        self.status = {}         # DS name -> last written status
        self.pod_state = {}      # pod name -> last written (phase, ready)
        self.ready_log = []      # (wall time, pod, phase, ready) written
        self.gangs = []          # one _GangRun per gang member pod, in order
        self._gang_by_uid = {}
        self.child_envs = []     # each child's declared env, as given

    def _on_sync(self, kind, items):
        for pod in items:
            self._events.put(("ADDED", pod))

    def run(self) -> None:
        try:
            healthy = [d[0] for d in self.devices if d[1] == "Healthy"]
            node = self.client.get("Node", self.node_name)
            node.setdefault("status", {}).setdefault("capacity", {})[
                self.resource] = str(len(healthy))
            self.client.update_status(node)  # noqa: TPULNT140 - plays the kubelet
            self.advertised.set()
            # every namespace: a user's job pod runs outside the
            # operator's
            self.client.watch(lambda verb, obj: self._events.put((verb, obj)),
                              kinds=["Pod"], stop=self.stop,
                              on_sync=self._on_sync)
            done = set()
            next_step = 0.0
            while not self.stop.is_set():
                if self.daemonsets.is_set() and \
                        time.monotonic() >= next_step:
                    self._step()
                    next_step = time.monotonic() + 0.1
                try:
                    verb, pod = self._events.get(timeout=0.05)
                except queue.Empty:
                    continue
                md = pod.get("metadata", {})
                if self._gang_event(verb, pod, healthy):
                    continue
                # a DaemonSet's pod is created with its phase set, a
                # workload pod without
                if (verb != "ADDED" or "deletionTimestamp" in md
                        or md.get("uid") in done
                        or pod.get("status", {}).get("phase")):
                    continue
                done.add(md.get("uid"))
                self._run_pod(pod, healthy)
        except Exception as e:  # noqa: BLE001 - the phase reports it
            self.error = e
            self.failed.set()

    def sleep(self, seconds: float) -> None:
        """The component's wait between polls, cut short by a kubelet
        failure: no pod would ever run, so the phase fails at once."""
        if self.failed.wait(seconds):
            raise RuntimeError(f"the kubelet failed: {self.error!r}")

    def close(self) -> list:
        """Stop the thread and every DaemonSet pod's children; the main
        containers' exit codes and seconds."""
        self.stop.set()
        self.join(timeout=30)
        exits = []
        for run in self.stopped + list(self.runs.values()):
            exits += run.close()
        for run in self.gangs:
            exits.append(run.close())
        return exits

    # ------------------------------------------------- gang member pods
    def _gang_event(self, verb: str, pod: dict, healthy: list) -> bool:
        """A gang member pod's event: its first sight starts it, its
        deletion stops it.  True for every event of a gang pod."""
        from tpu_operator_torch import consts

        md = pod.get("metadata", {})
        if consts.WORKLOAD_NAME_LABEL not in md.get("labels", {}):
            return False
        run = self._gang_by_uid.get(md.get("uid"))
        if run is None:
            if (verb != "DELETED" and "deletionTimestamp" not in md
                    and not pod.get("status", {}).get("phase")):
                run = _GangRun(self, pod, healthy)
                self._gang_by_uid[md.get("uid")] = run
                self.gangs.append(run)
                run.thread.start()
        elif verb == "DELETED" or "deletionTimestamp" in md:
            run.stop(gone=verb == "DELETED")
        return True

    def runs_containers_of(self, pod: dict) -> bool:
        """Whether this kubelet still runs ``pod``'s container (a gang
        member's child not yet reaped): the stub apiserver keeps such a pod
        Terminating (``StubApiServer.pod_containers_running``), as a real
        kubelet removes a deleted pod only once its containers stopped."""
        run = self._gang_by_uid.get(pod.get("metadata", {}).get("uid"))
        return run is not None and run.thread.is_alive()

    def resolve(self, host: str, pod: dict) -> str:
        """Cluster DNS for the gang pods this kubelet runs: the name
        ``<pod>.<service>.<namespace>`` of one of them, under its pod's
        own service and namespace, is 127.0.0.1; any other name is left
        as it is.  Each mapping made is printed."""
        names = {run.name for run in self.gangs}
        parts = host.split(".")
        if (len(parts) == 3 and parts[0] in names
                and parts[1] == pod["spec"].get("subdomain")
                and parts[2] == pod["metadata"]["namespace"]):
            print(json.dumps({"kubelet_dns": {host: "127.0.0.1"}}),
                  flush=True)
            return "127.0.0.1"
        return host

    def gang_env(self, pod: dict, ctr: dict, alloc: dict) -> dict:
        """A gang member's env: the node's own minus what a container's
        spec alone may set (``JAX_*`` and the rendezvous contract), the
        allocation's (:func:`allocation_env`), then the container's, with
        ``MASTER_ADDR`` resolved (:meth:`resolve`)."""
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("JAX_") and k not in GANG_CONTRACT}
        env = allocation_env(alloc, self.cdi_root, env)
        for e in ctr.get("env", []):
            env[e["name"]] = e["value"]
        if "MASTER_ADDR" in env:
            env["MASTER_ADDR"] = self.resolve(env["MASTER_ADDR"], pod)
        self.child_envs.append({e["name"]: env[e["name"]]
                                for e in ctr.get("env", [])})
        return env

    def set_pod_status(self, pod: dict, phase: str, ready: bool) -> None:
        """Write a workload pod's phase and readiness, unless it is being
        deleted or gone."""
        from tpu_operator_torch.client import NotFoundError

        md = pod["metadata"]
        try:
            live = self.client.get("Pod", md["name"], md["namespace"])
        except NotFoundError:
            return
        if "deletionTimestamp" in live["metadata"] \
                or live["metadata"].get("uid") != md.get("uid"):
            return
        live["status"] = {"phase": phase, "conditions": [
            {"type": "Ready", "status": "True" if ready else "False"}]}
        self.client.update_status(live)  # noqa: TPULNT140 - plays the kubelet publishing pod status
        self.ready_log.append((time.time(), md["name"], phase, ready))

    def _run_pod(self, pod: dict, healthy: list) -> None:
        t_seen = time.perf_counter()
        md = pod["metadata"]
        ctr = pod["spec"]["containers"][0]
        count = int(ctr["resources"]["limits"][self.resource])
        chosen = self.endpoint.preferred(healthy, count)
        alloc = self.endpoint.allocate(chosen)
        alloc["cards"] = sorted(int(i) for i in alloc["envs"][
            "NVIDIA_VISIBLE_DEVICES"].split(","))
        live = self.client.get("Pod", md["name"], md["namespace"])
        live["status"] = {"phase": "Running"}
        self.client.update_status(live)  # noqa: TPULNT140 - plays the kubelet publishing pod status
        # the container's env with the paths of its mapped volumes (the
        # kernel build dir) rewritten
        mounts = self.mounts_of(pod["spec"])
        env = {e["name"]: self.map_path(str(e["value"]), mounts)
               for e in ctr.get("env", [])}
        self.child_envs.append(dict(env))
        child, secs, names, launches, stages = pod_child(
            alloc, self.cdi_root, ctr["command"], ctr["args"], env)
        live = self.client.get("Pod", md["name"], md["namespace"])
        live["status"] = ({"phase": "Succeeded"} if child.returncode == 0
                          else {"phase": "Failed", "message":
                                child.stderr.strip()[-500:]})
        self.client.update_status(live)  # noqa: TPULNT140 - plays the kubelet publishing pod status
        self.pods.append({
            "name": md["name"], "command": ctr["command"],
            "args": ctr["args"], "requested": count, "preferred": chosen,
            "allocation": alloc, "child": child, "names": names,
            "launches": launches, "child_seconds": secs,
            "stages": stages, "mounts": mounts,
            "seen_to_done_seconds": time.perf_counter() - t_seen})

    # ------------------------------------------- the DaemonSets' pods
    def mounts_of(self, spec: dict) -> dict:
        """Container mount path → the path a child sees it at: a temporary
        dir for the writable hostPath volumes of a pod spec, the host path
        itself for a read-only one mounted elsewhere (a bind mount's
        view, e.g. the driver's libraries)."""
        dirs, hosts = {}, {}
        for v in spec.get("volumes", []):
            if v["name"] in OPERATOR_MAPPED_VOLUMES and "hostPath" in v:
                dirs[v["name"]] = os.path.join(self.tmp, "host",
                                               v["hostPath"]["path"]
                                               .strip("/"))
            elif "hostPath" in v:
                hosts[v["name"]] = v["hostPath"]["path"]
        out = {}
        for c in spec.get("initContainers", []) + spec["containers"]:
            for m in c.get("volumeMounts", []):
                path = m["mountPath"].rstrip("/")
                if m["name"] in dirs:
                    out[path] = dirs[m["name"]]
                elif (m["name"] in hosts and m.get("readOnly")
                      and path != hosts[m["name"]].rstrip("/")):
                    out[path] = hosts[m["name"]]
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        return out

    @staticmethod
    def map_path(value: str, mounts: dict) -> str:
        """``value`` with every path under a mapped mount rewritten."""
        for mount, tmp in sorted(mounts.items(), key=lambda m: -len(m[0])):
            value = re.sub(r"(?<![^\s=\"'])" + re.escape(mount)
                           + r"(?=/|$|\s|\"|')", tmp, value)
        return value

    def env_of(self, c: dict, pod: dict, mounts: dict) -> dict:
        env = dict(os.environ)
        env["PATH"] = self.stubs + os.pathsep + env.get("PATH", "")
        fields = {"spec.nodeName": self.node_name,
                  "metadata.namespace": pod["metadata"]["namespace"],
                  "metadata.name": pod["metadata"]["name"],
                  "status.hostIP": "127.0.0.1"}
        for e in c.get("env", []):
            if "value" in e:
                env[e["name"]] = self.map_path(str(e["value"]), mounts)
            else:
                env[e["name"]] = fields[e["valueFrom"]["fieldRef"]
                                        ["fieldPath"]]
        named = {e["name"] for e in c.get("env", [])}
        for var, default in OPERATOR_DEFAULT_PATHS:
            mapped = self.map_path(default, mounts)
            if var not in named and mapped != default:
                env[var] = mapped
                named.add(var)
        self.child_envs.append({k: env[k] for k in sorted(named)})
        return env

    def _step(self) -> None:
        labels = self.client.get("Node", self.node_name)["metadata"].get(
            "labels", {})
        daemonsets = self.client.list("DaemonSet", self.namespace)
        pods = {p["metadata"]["name"]: p
                for p in self.client.list("Pod", self.namespace)}
        names = {ds["metadata"]["name"] for ds in daemonsets}
        for name, run in list(self.runs.items()):
            pod = pods.get(run.pod["metadata"]["name"])
            if (name in names and pod is not None
                    and "deletionTimestamp" not in pod["metadata"]):
                continue
            # deleted, or its DaemonSet was: stop its containers
            del self.runs[name]
            self.stopped.append(run)
            run.close()
            self.pod_state.pop(run.pod["metadata"]["name"], None)
        for name in [n for n in self.marked if n not in names]:
            self.marked.remove(name)
        for name in [n for n in self.status if n not in names]:
            del self.status[name]
        for ds in daemonsets:
            name = ds["metadata"]["name"]
            sel = ds["spec"]["template"]["spec"].get("nodeSelector", {})
            matches = all(labels.get(k) == v for k, v in sel.items())
            if (matches and name not in self.runs and name not in self.marked
                    and f"{name}-{self.node_name}" not in pods):
                self._create_pod(ds)
            ready = (name in self.marked
                     or (name in self.runs and self.runs[name].ready()))
            if name in self.runs:
                run = self.runs[name]
                _require(run.failed is None,
                         f"{name}'s pod failed: {run.failed}")
                self._pod_status(run.pod, "Running" if run.started.is_set()
                                 else "Pending", ready)
            n = 1 if (matches or name in self.runs
                      or name in self.marked) else 0
            status = {"desiredNumberScheduled": n,
                      "currentNumberScheduled": n,
                      "numberAvailable": n if ready else 0,
                      "updatedNumberScheduled": n if ready else 0,
                      "numberReady": n if ready else 0}
            if self.status.get(name) != status:
                live = self.client.get("DaemonSet", name, self.namespace)
                live["status"] = status
                self.client.update_status(live)  # noqa: TPULNT140 - plays the DS controller
                self.status[name] = status

    def _create_pod(self, ds: dict) -> None:
        name = ds["metadata"]["name"]
        tmpl = ds["spec"]["template"]
        pod = {"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": f"{name}-{self.node_name}",
                            "namespace": self.namespace,
                            "labels": dict(tmpl["metadata"].get("labels",
                                                                {})),
                            "ownerReferences": [{
                                "kind": "DaemonSet", "name": name,
                                "uid": ds["metadata"].get("uid", "")}]},
               "spec": {"nodeName": self.node_name,
                        "containers": [{"name": c["name"],
                                        "image": c.get("image", "")}
                                       for c in tmpl["spec"]["containers"]]},
               "status": {"phase": "Pending"}}
        self.client.create(pod)
        self.created += 1
        driver = (ds["metadata"].get("labels", {}).get(
            "app.kubernetes.io/component") == DRIVER_COMPONENT)
        if name in OPERATOR_RUN or driver:
            os.makedirs(self.logs, exist_ok=True)
            run = self.runs[name] = _PodRun(self, ds, pod, self.created)
            run.thread.start()
        else:
            self.marked.append(name)
            self._pod_status(pod, "Running", True)

    def _pod_status(self, pod: dict, phase: str, ready: bool) -> None:
        key = pod["metadata"]["name"]
        if self.pod_state.get(key) == (phase, ready):
            return
        live = self.client.get("Pod", key, self.namespace)
        live["status"] = {"phase": phase, "conditions": [
            {"type": "Ready", "status": "True" if ready else "False"}]}
        self.client.update_status(live)  # noqa: TPULNT140 - plays the kubelet publishing pod status
        self.pod_state[key] = (phase, ready)
        self.ready_log.append((time.time(), key, phase, ready))


class _GangRun:
    """One gang member pod on the card's node, run as a kubelet with a
    device plugin runs it: the plugin's preferred allocation and
    ``Allocate`` for the cards its container requests, its command (a
    script of the checkout, :func:`script_argv`) and args in a child with
    :meth:`Kubelet.gang_env`; Running once started, Ready once the child
    prints :data:`GANG_READY_LINE`, stopped (SIGTERM) when the pod is
    deleted, else Succeeded or Failed by the child's exit.  The child's
    last ``launches=`` line is its kernel launches so far."""

    def __init__(self, kubelet: Kubelet, pod: dict, healthy: list):
        self.kubelet, self.pod, self.healthy = kubelet, pod, healthy
        self.name = pod["metadata"]["name"]
        self.proc = None
        self.launches = {}
        self.lines = []
        self.rc = None
        self.seen_at = time.time()
        self.ready_at = self.exited_at = self.deleted_at = None
        self.gone_at = None
        self._lock = threading.Lock()
        self._stopping = False
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"gang-{self.name}")

    def _run(self) -> None:
        k = self.kubelet
        try:
            ctr = self.pod["spec"]["containers"][0]
            count = int(ctr["resources"]["limits"][k.resource])
            alloc = k.endpoint.allocate(k.endpoint.preferred(self.healthy,
                                                             count))
            env = k.gang_env(self.pod, ctr, alloc)
            argv = script_argv(ctr.get("command", []), ctr.get("args", []))
            with self._lock:
                if self._stopping:
                    return
                self.proc = subprocess.Popen(
                    argv, env=env, cwd=HERE, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True,
                    start_new_session=True)
            k.set_pod_status(self.pod, "Running", False)
            for line in self.proc.stdout:
                line = line.rstrip()
                self.lines.append(line)
                if line.startswith("launches="):
                    self.launches = json.loads(line[len("launches="):])
                elif line == GANG_READY_LINE and self.ready_at is None:
                    self.ready_at = time.time()
                    k.set_pod_status(self.pod, "Running", True)
                elif line.startswith("{"):
                    print(line, flush=True)
            self.rc = self.proc.wait()
            self.exited_at = time.time()
            if not self._stopping:
                k.set_pod_status(self.pod, "Succeeded" if self.rc == 0
                                 else "Failed", False)
        except Exception as e:  # noqa: BLE001 - the phase reports it
            k.error = e
            k.failed.set()

    def stop(self, gone: bool) -> None:
        """The pod is being deleted (``gone``: it is gone): SIGTERM."""
        now = time.time()
        if gone and self.gone_at is None:
            self.gone_at = now
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
            self.deleted_at = now
            proc = self.proc
        if proc is not None and proc.poll() is None:
            proc.terminate()

    def close(self) -> dict:
        """Stop the child; its exit code and seconds."""
        with self._lock:
            self._stopping = True
            proc = self.proc
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(10)
        self.thread.join(timeout=30)
        return {"pod": self.name, "container": "gang-member",
                "rc": proc.returncode if proc is not None else 0,
                "alive_seconds": (self.exited_at or time.time())
                - self.seen_at}


class _Timed:
    """A client that stamps each verb's start and end (perf_counter), for
    the phase's waits and request counts; the call goes to the wrapped
    client."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def __getattr__(self, verb):
        fn = getattr(self.inner, verb)

        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            kind = (args[0]["kind"] if args and isinstance(args[0], dict)
                    else args[0] if args else "")
            phase = ((out or {}).get("status", {}).get("phase", "")
                     if isinstance(out, dict) else "")
            self.calls.append((verb, kind, t0, time.perf_counter(), phase))
            return out
        return call


def plugin_component(endpoint: PluginEndpoint, devices: list, native: list,
                     raw: list, cdi_root: str, seconds: dict) -> dict:
    """The validator's ``plugin`` component on the live host over real HTTP
    to the port's stub apiserver: a Node without the resource, the
    :class:`Kubelet` advertising the plugin's devices and running the
    workload pod on the plugin's allocation, ``run_component("plugin")``
    at its own wait intervals, then feature discovery labelling the Node
    twice (the second run must change nothing).  The node's kernel build
    dir holds the library this run built, as the validator's ``torch``
    container leaves it before ``plugin`` runs; the workload pod mounts
    it, and its child must load that build (no compile) and launch the
    matmul.  Returns the kernel launches of the workload pod's child."""
    import torch

    from tpu_operator_torch import consts, statusfiles
    from tpu_operator_torch.client import metrics as client_metrics
    from tpu_operator_torch.client.resilience import (
        resilient_incluster_client)
    from tpu_operator_torch.deviceplugin.sharing import DEFAULT_RESOURCE_NAME
    from tpu_operator_torch.fd.__main__ import main as fd_main
    from tpu_operator_torch.testing.stub_apiserver import StubApiServer
    from tpu_operator_torch.validator import _build, components

    node_name = "h100-node-0"
    namespace = consts.DEFAULT_NAMESPACE
    stub = StubApiServer([{"apiVersion": "v1", "kind": "Node",
                           "metadata": {"name": node_name, "labels": {}},
                           "spec": {}, "status": {"capacity": {}}}])
    clients = [resilient_incluster_client(api_server=stub.url, token=t)
               for t in ("validator", "kubelet", "fd")]
    component_client = _Timed(clients[0])
    node_dir = tempfile.mkdtemp(prefix="plugin-node")
    lib = _build.build(torch.cuda.current_device())
    shutil.copytree(lib.parent, os.path.join(
        node_dir, "host", consts.BUILD_DIR_ON_NODE.strip("/"), "kernels",
        lib.parent.name))
    kubelet = Kubelet(clients[1], endpoint, devices, node_name, namespace,
                      DEFAULT_RESOURCE_NAME, cdi_root, tmp=node_dir)
    status_dir = tempfile.mkdtemp(prefix="plugin-status")
    before = client_metrics.lease_wait_totals()
    try:
        kubelet.start()
        _require(kubelet.advertised.wait(30),
                 f"the kubelet never wrote the capacity: {kubelet.error!r}")
        t0 = time.perf_counter()
        values = components.run_component("plugin", components.Context(
            host=endpoint.host, status_dir=status_dir, node_name=node_name,
            namespace=namespace, client_factory=lambda: component_client,
            sleep=kubelet.sleep))
        seconds["plugin_component"] = time.perf_counter() - t0
        pod_name = f"gpu-validation-workload-{node_name}"
        t1 = time.perf_counter()
        while clients[0].get_or_none("Pod", pod_name, namespace) is not None:
            _require(time.perf_counter() - t1 < 30,
                     "the workload pod was never deleted")
            time.sleep(0.05)
        pod_gone_s = time.perf_counter() - t1
        ready = statusfiles.read_status(consts.STATUS_FILE_PLUGIN, status_dir)

        # feature discovery on the same Node, twice
        fd_log = _LogLines("tpu_operator_torch.fd.__main__")
        fd_seconds = []
        for _ in range(2):
            t2 = time.perf_counter()
            rc = fd_main(["--one-shot", f"--node-name={node_name}",
                          "--host-root=/"], client=clients[2])
            fd_seconds.append(time.perf_counter() - t2)
            _require(rc == 0, f"fd --one-shot exited {rc}")
        fd_log.close()
        labels = clients[2].get("Node", node_name)["metadata"]["labels"]
        node_puts = [r for r in stub.requests
                     if r == ("PUT", f"/api/v1/nodes/{node_name}")]
        after = client_metrics.lease_wait_totals()
        rendered = client_metrics.render()
    finally:
        kubelet.close()
        for c in clients:
            c.close()
        stub.shutdown()
        shutil.rmtree(status_dir, ignore_errors=True)
        shutil.rmtree(node_dir, ignore_errors=True)

    _require(kubelet.error is None, f"the kubelet failed: {kubelet.error!r}")
    _require(not kubelet.is_alive(), "the kubelet thread did not stop")
    _require(len(kubelet.pods) == 1,
             f"the kubelet ran {len(kubelet.pods)} workload pods, want 1")
    pod = kubelet.pods[0]
    child = pod["child"]
    calls = component_client.calls
    cap_read = max(c[3] for c in calls if c[:2] == ("get", "Node"))
    created = next(c[3] for c in calls if c[:2] == ("create", "Pod"))
    succeeded = next(c[3] for c in calls
                     if c[:2] == ("get", "Pod") and c[4] == "Succeeded")
    resource_wait = cap_read - calls[0][2]
    requests_by_verb = {}          # verb: [calls, seconds]
    for verb, _, start, end, _ in calls:
        row = requests_by_verb.setdefault(verb, [0, 0.0])
        row[0] += 1
        row[1] += end - start
    report = {
        "seconds": seconds["plugin_component"],
        "resource_wait_s": resource_wait,
        "pod_create_to_succeeded_s": succeeded - created,
        "child_s": pod["child_seconds"],
        "kubelet_seen_to_done_s": pod["seen_to_done_seconds"],
        "pod_gone_after_s": pod_gone_s,
        "capacity": values["capacity"], "plugin_ready": ready,
        "command": pod["command"], "args": pod["args"],
        "requested": pod["requested"], "preferred": pod["preferred"],
        "allocation": {k: pod["allocation"][k]
                       for k in ("cdi_devices", "envs", "cards")},
        "names": pod["names"], "child_launches": pod["launches"],
        "child_stages": pod["stages"], "child_mounts": pod["mounts"],
        "child_rc": child.returncode,
        "child_stdout": child.stdout.strip()[-1500:],
        "child_stderr": child.stderr.strip()[-1500:] if child.returncode
        else "",
        "component_calls": [(v, k, round(b - calls[0][2], 6), p)
                            for v, k, _, b, p in calls],
        "requests_by_verb": requests_by_verb,
        "wait_intervals_s": [components.RESOURCE_WAIT_SLEEP_S,
                             components.POD_WAIT_SLEEP_S]}
    print(json.dumps({"plugin_component": report}), flush=True)
    print(json.dumps({"fd": {"labels": labels, "seconds": fd_seconds,
                             "log": fd_log.lines,
                             "node_puts": len(node_puts)}}), flush=True)
    lease = {k: after[k] - before[k] for k in after}
    print(json.dumps({"client_metrics": {
        "lease_waits": lease,
        "rendered": [line for line in rendered.splitlines()
                     if line.startswith("gpu_operator_client_")
                     and "_bucket" not in line],
        "connects": client_metrics.sample(
            "gpu_operator_client_pool_connects_total"),
        "discards": client_metrics.sample(
            "gpu_operator_client_pool_discards_total"),
        "stale_retries": client_metrics.sample(
            "gpu_operator_client_stale_retries_total")}}), flush=True)

    n = len(native)
    _require(values == {"resource": "nvidia.com/gpu", "capacity": str(n)}
             and ready == values,
             f"plugin component {values}, plugin-ready {ready}, {n} cards")
    _require(pod["command"] == POD_COMMAND and pod["args"] == POD_ARGS,
             f"the workload pod runs {pod['command']} {pod['args']}")
    _require(pod["requested"] == n and sorted(pod["preferred"])
             == sorted(d[0] for d in devices),
             f"the pod requested {pod['requested']}, preferred "
             f"{pod['preferred']}")
    _check_pod_child(child, pod["names"], pod["allocation"], raw)
    _check_workload_child(pod, node_dir)
    inv = endpoint.host.discover()
    want = {consts.TFD_LABEL_CHIP: inv.chip_type,
            consts.TFD_LABEL_TYPE: inv.accelerator_type,
            consts.TFD_LABEL_CHIPS_PER_HOST: str(n),
            consts.TFD_LABEL_LIBTPU: _nvml_driver_version(),
            consts.TPU_PRESENT_LABEL: "true"}
    _require(all(want.values()) and all(labels.get(k) == v
                                        for k, v in want.items()),
             f"fd labels {labels}, want {want}")
    _require(fd_log.lines[-2:] == ["labels updated", "labels unchanged"]
             and len(node_puts) == 1,
             f"fd runs: {fd_log.lines}, {len(node_puts)} Node writes")
    return pod["launches"]


def _nvml_driver_version() -> str:
    from tpu_operator_torch import nativelib
    return nativelib.driver_version() or ""


class _LogLines(logging.Handler):
    """The messages one logger emits while attached."""

    def __init__(self, name: str):
        super().__init__(logging.INFO)
        self.lines = []
        self._logger = logging.getLogger(name)
        self._logger.addHandler(self)

    def emit(self, record) -> None:
        self.lines.append(record.getMessage())

    def close(self) -> None:
        self._logger.removeHandler(self)
        super().close()


# --------------------------------------------------------------------------
# the health phase: the telemetry daemon on the card's NVML, the exporter
# over it under a load, and the watchdog through to the Node annotation
# --------------------------------------------------------------------------

NVML_HEADER = "/usr/local/cuda/include/nvml.h"


class Metricsd:
    """The port's daemon serving on a port the kernel picks, its stderr in
    a file; ``close()`` stops it."""

    def __init__(self, binary: str, args: list, log: str):
        self.log = log
        with open(log, "w") as err:  # noqa: TPULNT306 - the daemon's stderr log in the run's temp dir
            self.proc = subprocess.Popen([binary, "--port=0", *args],
                                         stdout=subprocess.DEVNULL,
                                         stderr=err)
        deadline = time.perf_counter() + 30
        self.port = None
        try:
            while self.port is None:
                _require(self.proc.poll() is None,
                         f"metricsd exited {self.proc.returncode}: "
                         f"{self.stderr()}")
                _require(time.perf_counter() < deadline,
                         "metricsd never bound")
                found = re.search(r" serving :(\d+)", self.stderr())
                self.port = int(found[1]) if found else None
                time.sleep(0.02)
        except BaseException:
            self.close()    # whatever stopped the wait, the daemon goes
            raise

    def stderr(self) -> str:
        with open(self.log) as f:
            return f.read()

    def refused(self) -> list:
        return _refusals(self.stderr())

    def close(self) -> None:
        self.proc.terminate()
        self.proc.wait(timeout=30)


def _refusals(stderr: str) -> list:
    return re.findall(r"gpu-metricsd: refused (.*)", stderr)


def _nvml_count() -> int:
    """NVML's card count, read through the port's binding."""
    import ctypes

    from tpu_operator_torch import nativelib
    lib = nativelib.load_nvml()
    _require(lib is not None and lib.nvmlInit_v2() == 0,
             "NVML did not initialise")
    try:
        count = ctypes.c_uint()
        _require(lib.nvmlDeviceGetCount_v2(ctypes.byref(count)) == 0,
                 "nvmlDeviceGetCount_v2 failed")
        return count.value
    finally:
        lib.nvmlShutdown()


def _power_limit_w() -> float:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(smi.stdout.split()[0])


def _by_name(samples: dict, name: str) -> dict:
    """labels -> value of one series."""
    return {labels: v for (n, labels), v in samples.items() if n == name}


def _minor(labels: str) -> int:
    return int(re.search(r'chip="(\d+)"', labels)[1])


def health(torch, ops, run_dir: str) -> dict:
    """The node's health stack on the card: the port's telemetry daemon
    built from the checkout, ``--once`` against the card's NVML (the cards
    by minor, memory, temperature and power in range); the daemon serving
    and the port's exporter over it, scraped every 0.25 s through ~3 s of
    back-to-back 2048^2 matmul kernels (utilisation and power must rise);
    the watchdog stepped by hand over the live daemon with the Node
    annotation published to the port's stub apiserver, degrading when the
    cards' device nodes vanish and recovering when they return; and no
    NVML failing the daemon.  Returns the launch counts of the load."""
    from tpu_operator_torch import nativelib, statusfiles
    from tpu_operator_torch.client.resilience import (
        resilient_incluster_client)
    from tpu_operator_torch.exporter import MetricsdScraper, serve
    from tpu_operator_torch.host import host_for_root
    from tpu_operator_torch.native import METRICSD_SRC
    from tpu_operator_torch.testing.stub_apiserver import StubApiServer
    from tpu_operator_torch.validator import _build_metricsd, healthwatch
    from tpu_operator_torch.validator.metrics import serve as serve_status

    seconds = {}
    t_phase = t0 = time.perf_counter()
    binary = str(_build_metricsd.build())
    seconds["build"] = time.perf_counter() - t0
    print(json.dumps({"metricsd_build_seconds": seconds["build"],
                      "binary": os.path.relpath(binary)}), flush=True)
    # NVIDIA's own nvml.h, where the toolkit carries it, against the
    # declarations the daemon was built with
    abi = f"no {NVML_HEADER}"
    if os.path.exists(NVML_HEADER):
        check = subprocess.run(
            ["g++", "-std=c++17", "-fsyntax-only",
             f"-I{os.path.dirname(NVML_HEADER)}",
             str(METRICSD_SRC / "nvml_abi_check.cc")],
            capture_output=True, text=True)
        _require(check.returncode == 0,
                 f"nvml.h disagrees with the daemon's NVML declarations: "
                 f"{check.stderr}")
        abi = f"the daemon's NVML declarations match {NVML_HEADER}"

    raw = nativelib.enumerate_chips("/dev", "/sys") or []
    minors = sorted(c["index"] for c in raw)
    n = torch.cuda.device_count()
    total_memory = torch.cuda.get_device_properties(0).total_memory
    limit_w = _power_limit_w()
    args = ["--dev-root=/dev", f"--run-dir={run_dir}"]

    # --once against the card's NVML
    t0 = time.perf_counter()
    once = subprocess.run([binary, "--once", *args], capture_output=True,
                          text=True, timeout=120)
    seconds["once"] = time.perf_counter() - t0
    _require(once.returncode == 0,
             f"metricsd --once exited {once.returncode}: {once.stderr}")
    page = _samples(once.stdout)
    links = _by_name(page, "gpu_nvlink_up")
    refused = _refusals(once.stderr)
    print(json.dumps({"metricsd_once": {
        "seconds": seconds["once"], "abi": abi,
        "torch_total_memory": total_memory, "power_limit_w": limit_w,
        "series": sorted({name for name, _ in page}),
        "chips": {f"{name}{{{labels}}}": v
                  for (name, labels), v in page.items()
                  if labels and "link" not in labels},
        "links": links, "refused": refused}}), flush=True)
    count = _nvml_count()
    _require(page[("gpu_chips_total", "")] == count == n,
             f"gpu_chips_total {page[('gpu_chips_total', '')]}, NVML "
             f"{count}, torch {n}")
    up = _by_name(page, "gpu_chip_up")
    _require(sorted(_minor(k) for k, v in up.items() if v == 1) == minors
             and len(up) == n, f"gpu_chip_up {up}, the cards' minors {minors}")
    _require(all('chip_type="h100-sxm"' in k or 'chip_type="h100-pcie"' in k
                 for k in up), f"chip types {list(up)}")
    for name, ok in (
            ("gpu_hbm_total_bytes",
             lambda v: total_memory <= v <= 1.05 * total_memory),
            ("gpu_temperature_celsius", lambda v: 0 < v < 100),
            ("gpu_power_watts", lambda v: 0 < v <= limit_w)):
        values = _by_name(page, name)
        _require(len(values) == n and all(ok(v) for v in values.values()),
                 f"{name} {values} (torch total memory {total_memory}, "
                 f"power limit {limit_w} W)")

    # no NVML: the daemon fails rather than report zero cards
    nonvml = subprocess.run([binary, "--once", "--nvml-lib=/nonexistent",
                             *args], capture_output=True, text=True,
                            timeout=60)
    print(json.dumps({"metricsd_without_nvml": {
        "rc": nonvml.returncode, "stdout": nonvml.stdout,
        "stderr": nonvml.stderr.strip()}}), flush=True)
    _require(nonvml.returncode != 0 and nonvml.stdout == "",
             "metricsd without NVML did not fail")

    node_name = "h100-node-0"
    tmp = tempfile.mkdtemp(prefix="health")
    daemon = exporter = stub = client = None
    legs = {}
    try:
        # serving, with the exporter over it, idle and under a load
        daemon = Metricsd(binary, args, os.path.join(tmp, "metricsd.err"))
        scraper = MetricsdScraper(port=daemon.port, node_name=node_name)
        exporter = serve(0, scraper, background=True)
        eport = exporter.server_address[1]
        scrapes = []

        def scrape(phase: str) -> None:
            t1 = time.perf_counter()
            text = _get(eport)
            s = _samples(text)
            lines = [ln for ln in text.splitlines()
                     if ln and not ln.startswith("#")
                     and not ln.startswith("gpu_exporter_")]
            scrapes.append({
                "phase": phase, "t": t1 - t_load,
                "exporter_s": time.perf_counter() - t1,
                "metricsd_s": scraper.last_scrape_s,
                "up": s.get(("gpu_exporter_metricsd_up", "")),
                "duty": max(_by_name(s, "gpu_duty_cycle_percent").values(),
                            default=None),
                "power_w": max(_by_name(s, "gpu_power_watts").values(),
                               default=None),
                "node_labels": all(f'node="{node_name}"' in ln
                                   for ln in lines) and bool(lines)})

        t_load = time.perf_counter()
        scrape("idle")
        g = torch.Generator(device="cuda").manual_seed(8)
        a = torch.randn(2048, 2048, device="cuda", generator=g).bfloat16()
        b = torch.randn(2048, 2048, device="cuda", generator=g).bfloat16()
        stop = threading.Event()

        def scraper_thread() -> None:
            while not stop.wait(0.25):
                scrape("load")

        ops.reset_launches()
        t_load = time.perf_counter()
        thread = threading.Thread(target=scraper_thread, daemon=True)
        thread.start()
        calls = 0
        try:
            while time.perf_counter() - t_load < 3.0:
                for _ in range(100):
                    ops.matmul_bf16_f32(a, b)
                calls += 100
                torch.cuda.synchronize()
        finally:
            stop.set()
            thread.join(timeout=30)
        seconds["load"] = time.perf_counter() - t_load
        legs = dict(ops.LAUNCHES)
        idle, load = scrapes[0], scrapes[1:]
        print(json.dumps({"health_load": {
            "matmul_calls": calls, "seconds": seconds["load"],
            "scrapes": scrapes}}), flush=True)
        _require(not thread.is_alive() and len(load) >= 8,
                 f"{len(load)} scrapes under the load")
        _require(all(s["up"] == 1.0 and s["node_labels"] for s in scrapes),
                 "the exporter lost metricsd or a node label")
        _require(max(s["duty"] for s in load) > 50,
                 f"utilisation never passed 50% under the matmul: "
                 f"{[s['duty'] for s in load]}")
        _require(max(s["power_w"] for s in load) > idle["power_w"],
                 f"power under load {[s['power_w'] for s in load]}, idle "
                 f"{idle['power_w']}")
        exporter.shutdown()
        exporter.server_close()
        exporter = None
        daemon.close()
        daemon = None

        # the watchdog over the live daemon, device nodes through symlinks
        devs = os.path.join(tmp, "dev")
        os.makedirs(devs)

        def link_nodes() -> None:
            for m in minors:
                os.symlink(f"/dev/nvidia{m}", os.path.join(devs, f"nvidia{m}"))

        link_nodes()
        daemon = Metricsd(binary, [f"--dev-root={devs}", f"--run-dir={run_dir}"],
                          os.path.join(tmp, "watched.err"))
        stub = StubApiServer([{"apiVersion": "v1", "kind": "Node",
                               "metadata": {"name": node_name, "labels": {}},
                               "spec": {}, "status": {}}])
        client = resilient_incluster_client(api_server=stub.url,
                                            token="healthwatch")
        status_dir = os.path.join(tmp, "validations")
        watch = healthwatch.HealthWatch(
            f"http://127.0.0.1:{daemon.port}/metrics", status_dir,
            policy=healthwatch.HealthPolicy(degrade_after=2, recover_after=2),
            on_verdict=healthwatch.node_annotation_publisher(lambda: client,
                                                             node_name))
        status_server = serve_status(0, status_dir, host_for_root("/"))
        steps = []

        def step(phase: str) -> bool:
            t1 = time.perf_counter()
            verdict = watch.step()
            secs = time.perf_counter() - t1
            gauges = _scrape(status_server.server_address[1])
            annotation = (client.get("Node", node_name)["metadata"]
                          .get("annotations", {})
                          .get(healthwatch.ICI_DEGRADED_ANNOTATION))
            payload = statusfiles.read_status(healthwatch.ICI_DEGRADED_FILE,
                                              status_dir)
            steps.append({
                "phase": phase, "seconds": secs, "verdict": verdict,
                "file": payload,
                "gauge": gauges[("gpu_operator_node_gpu_degraded", "")],
                "chips_down_gauge": gauges[(
                    "gpu_operator_node_gpu_degraded_reasons",
                    'reason="chips_down"')],
                "annotation": annotation})
            print(json.dumps({"healthwatch_step": steps[-1]}), flush=True)
            return verdict

        try:
            for _ in range(3):
                _require(step("healthy") is False, "a healthy node degraded")
            _require(not any(s["file"] or s["annotation"] or s["gauge"]
                             for s in steps), f"healthy steps {steps}")
            for m in minors:
                os.remove(os.path.join(devs, f"nvidia{m}"))
            _require(step("nodes-gone") is False,
                     "degraded before degrade_after bad scrapes")
            _require(step("nodes-gone") is True,
                     "not degraded after degrade_after bad scrapes")
            last = steps[-1]
            payload = json.loads(last["annotation"] or "{}")
            _require(last["file"] is not None
                     and last["file"]["chips_down"] == str(n)
                     and last["gauge"] == 1.0
                     and last["chips_down_gauge"] == float(n)
                     and payload.get("chips_down") == str(n),
                     f"degraded step {last}")
            link_nodes()
            _require(step("nodes-back") is True,
                     "recovered before recover_after clean scrapes")
            _require(step("nodes-back") is False, "never recovered")
            last = steps[-1]
            _require(last["file"] is None and last["gauge"] == 0.0
                     and last["annotation"] is None, f"recovered step {last}")
        finally:
            status_server.shutdown()
            status_server.server_close()
        refused_served = daemon.refused()
    finally:
        if exporter is not None:
            exporter.shutdown()
            exporter.server_close()
        if daemon is not None:
            daemon.close()
        if client is not None:
            client.close()
        if stub is not None:
            stub.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    seconds["phase"] = time.perf_counter() - t_phase
    print(json.dumps({"health_seconds": seconds,
                      "healthwatch_seconds": [s["seconds"] for s in steps],
                      "refused_served": refused_served}), flush=True)
    return legs


# --------------------------------------------------------------------------
# the node_operands phase: the partition, confidential-computing and kata
# managers on the live host, the card's MIG and CC mode read, never changed
# --------------------------------------------------------------------------

class NvmlGuard:
    """The card's NVML with every entry point that changes a card refused
    (NVML_ERROR_NO_PERMISSION, the library never reached) and recorded:
    the phase may read MIG and CC state and must change neither."""

    CHANGING = re.compile(r"Set|Create|Destroy|Reset")

    def __init__(self, lib):
        self._lib, self.refused = lib, []

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not self.CHANGING.search(name):
            return fn

        def refuse(*args):
            self.refused.append(name)
            return 4                # NVML_ERROR_NO_PERMISSION
        return refuse


def nvml_layout(tmp: str) -> str:
    """Build ``native/nvml_layout.c`` with the host's C compiler against
    the toolkit's ``nvml.h`` and hold ``nativelib``'s ctypes structures,
    constants and the partition manager's profile indices against what it
    prints.  Returns what was checked."""
    import ctypes

    from tpu_operator_torch import nativelib
    from tpu_operator_torch.native import NVML_LAYOUT_SRC
    from tpu_operator_torch.partition import manager

    if not os.path.exists(NVML_HEADER):
        return f"no {NVML_HEADER}"
    binary = os.path.join(tmp, "nvml_layout")
    build = subprocess.run(
        ["gcc", "-std=gnu11", f"-I{os.path.dirname(NVML_HEADER)}", "-o",
         binary, str(NVML_LAYOUT_SRC)], capture_output=True, text=True)
    _require(build.returncode == 0, f"nvml_layout.c does not build against "
                                    f"{NVML_HEADER}: {build.stderr}")
    header = json.loads(subprocess.run([binary], capture_output=True,
                                       text=True, check=True).stdout)
    structs = {"nvmlGpuInstanceProfileInfo_t":
               nativelib.GpuInstanceProfileInfo,
               "nvmlGpuInstancePlacement_t": nativelib.GpuInstancePlacement,
               "nvmlGpuInstanceInfo_t": nativelib.GpuInstanceInfo,
               "nvmlComputeInstanceProfileInfo_t":
               nativelib.ComputeInstanceProfileInfo,
               "nvmlConfComputeSystemState_t":
               nativelib.ConfComputeSystemState,
               "nvmlConfComputeSystemCaps_t": nativelib.ConfComputeSystemCaps}
    ours = {name: {"sizeof": ctypes.sizeof(cls),
                   **{f: getattr(cls, f).offset for f, _ in cls._fields_}}
            for name, cls in structs.items()}
    gi = {"1g.10gb": "1_SLICE", "1g.10gb+me": "1_SLICE_REV1",
          "1g.20gb": "1_SLICE_REV2", "2g.20gb": "2_SLICE",
          "3g.40gb": "3_SLICE", "4g.40gb": "4_SLICE", "7g.80gb": "7_SLICE"}
    constants = {f"NVML_{k}": getattr(nativelib, f"NVML_{k}") for k in (
        "SUCCESS", "ERROR_NOT_SUPPORTED", "ERROR_NO_PERMISSION",
        "ERROR_NOT_FOUND", "ERROR_INSUFFICIENT_SIZE",
        "ERROR_FUNCTION_NOT_FOUND", "ERROR_RESET_REQUIRED", "ERROR_IN_USE",
        "ERROR_INSUFFICIENT_RESOURCES", "DEVICE_MIG_DISABLE",
        "DEVICE_MIG_ENABLE", "CC_SYSTEM_FEATURE_ENABLED",
        "CC_SYSTEM_GPUS_CC_CAPABLE")}
    constants |= {f"NVML_GPU_INSTANCE_PROFILE_{gi[name]}": p.index
                  for name, p in manager.H100_80GB_PROFILES.items()}
    constants |= {f"NVML_COMPUTE_INSTANCE_PROFILE_{n}_SLICE": v for n, v in
                  nativelib.COMPUTE_INSTANCE_PROFILE_BY_SLICES.items()}
    constants |= {
        "NVML_GPU_INSTANCE_PROFILE_COUNT":
        nativelib.GPU_INSTANCE_PROFILE_COUNT,
        "NVML_COMPUTE_INSTANCE_PROFILE_COUNT":
        nativelib.COMPUTE_INSTANCE_PROFILE_COUNT,
        "NVML_COMPUTE_INSTANCE_ENGINE_PROFILE_SHARED":
        nativelib.COMPUTE_INSTANCE_ENGINE_PROFILE_SHARED}
    _require(header["handle_size"] == ctypes.sizeof(ctypes.c_void_p)
             and header["structs"] == ours,
             f"nvml.h's layouts {header['structs']} are not nativelib's "
             f"{ours}")
    _require(header["constants"] == constants,
             f"nvml.h's constants {header['constants']} are not nativelib's "
             f"{constants}")
    return (f"{len(ours)} structures, {len(constants)} constants and 17 "
            f"prototypes match {NVML_HEADER}")


def node_operands(torch) -> dict:
    """The last node-side operands on the live host, each step timed and
    printed: NVML's MIG and confidential-computing state of the cards (read
    through :class:`NvmlGuard`, which refuses every changing call); the
    partition manager applying ``all-chips`` (``run_dir`` in a temporary
    dir) with no changing call, the device plugin's list unchanged by its
    state file, two geometries planned and never applied, and an unknown
    profile failing through the CLI; the cc manager's CLI over HTTP to the
    stub apiserver with ``off`` and then ``on`` requested; the kata
    manager's CLI as a process on a temporary host root (its containerd
    restart to recording stubs).  The cards' MIG mode must be the same
    after as before.  Returns the step seconds."""
    from tpu_operator_torch import consts, nativelib, statusfiles
    from tpu_operator_torch.cc import detect_cc
    from tpu_operator_torch.cc.__main__ import main as cc_main
    from tpu_operator_torch.client.resilience import (
        resilient_incluster_client)
    from tpu_operator_torch.deviceplugin import plugin
    from tpu_operator_torch.host import host_for_root
    from tpu_operator_torch.kata import manager as kata
    from tpu_operator_torch.partition import manager as partition
    from tpu_operator_torch.partition.__main__ import main as partition_main
    from tpu_operator_torch.testing.stub_apiserver import StubApiServer

    seconds = {}
    t_phase = time.perf_counter()
    real = nativelib.load_nvml()
    _require(real is not None, "NVML did not load")
    guard = NvmlGuard(real)
    saved = nativelib._lib
    nativelib._lib = guard
    stub = client = None
    tmp = tempfile.mkdtemp(prefix="operands")
    node_name = "h100-node-0"
    try:
        t0 = time.perf_counter()
        seconds["nvml_layout"] = nvml_layout(tmp)
        seconds["nvml_layout_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        mig = nativelib.mig_state()
        seconds["mig_state"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cc = nativelib.conf_compute_state()
        seconds["conf_compute_state"] = time.perf_counter() - t0
        modes = [(c["current"], c["pending"]) for c in mig]
        print(json.dumps({"node_operands_nvml": {
            "mig_state": mig, "conf_compute": cc,
            "layout": seconds["nvml_layout"]}}), flush=True)
        _require(len(mig) == torch.cuda.device_count(),
                 f"NVML's MIG state lists {len(mig)} cards, torch "
                 f"{torch.cuda.device_count()}")

        plans = {}
        for name in ("all-1g.10gb", "all-balanced"):
            t0 = time.perf_counter()
            card_plans = partition.plan(partition.geometry_of(
                name, partition.builtin_profiles()[name]))
            seconds[f"plan_{name}"] = time.perf_counter() - t0
            plans[name] = [{
                "minor": p.minor, "nvml_index": p.nvml_index,
                "mode": p.mode, "route": p.source,
                "slices": {n: p.table[n].slices * c
                           for n, c in p.geometry.items()},
                "table": {n: [t.index, t.id, t.slices, t.instances]
                          for n, t in p.table.items()}}
                for p in card_plans]
        print(json.dumps({"partition_plans": plans}), flush=True)
        _require(all(p["route"] in ("nvml", "builtin")
                     for ps in plans.values() for p in ps),
                 f"plans {plans}")

        stub = StubApiServer([{"apiVersion": "v1", "kind": "Node",
                               "metadata": {"name": node_name,
                                            "labels": {}},
                               "spec": {}, "status": {}}])
        client = resilient_incluster_client(api_server=stub.url,
                                            token="operands")

        def labels() -> dict:
            return client.get("Node", node_name)["metadata"].get(
                "labels", {})

        # the partition manager: all-chips, as a node without the label
        host = host_for_root("/")
        run_dir = os.path.join(tmp, "run")
        mgr = partition.PartitionManager(client, node_name, host,
                                         run_dir=run_dir)
        t0 = time.perf_counter()
        applied = mgr.sync()
        seconds["partition_sync"] = time.perf_counter() - t0
        with open(os.path.join(run_dir, partition.PARTITION_STATE_FILE)) as f:
            state = json.load(f)
        t0 = time.perf_counter()
        again = mgr.sync()
        seconds["partition_resync"] = time.perf_counter() - t0
        with_state = [vars(d) for d in plugin.build_devices(host, run_dir)]
        without = [vars(d) for d in plugin.build_devices(
            host, os.path.join(tmp, "no-partition"))]
        part_label = labels().get(partition.STATE_LABEL)
        t0 = time.perf_counter()
        rc = partition_main(["--one-shot", f"--node-name={node_name}",
                             "--host-root=/", "--default-profile=nope"],
                            client=client)
        seconds["partition_cli_unknown"] = time.perf_counter() - t0
        unknown_label = labels().get(partition.STATE_LABEL)
        print(json.dumps({"partition": {
            "applied": applied, "again": again, "label": part_label,
            "state": state, "devices": with_state,
            "cli_unknown": {"rc": rc, "label": unknown_label}}}),
            flush=True)
        _require(applied == again == "all-chips" and part_label == "success"
                 and state["mig"] == [] and state["devices_per_chip"] == 1
                 and state["chip_count"] == len(mig),
                 f"partition manager: {applied}, {part_label}, {state}")
        _require(with_state == without and len(without) >= len(mig),
                 f"the plugin's list with the partition state {with_state} "
                 f"is not its list without {without}")
        _require(rc == 1 and unknown_label == "failed",
                 f"the partition CLI with an unknown profile: rc {rc}, "
                 f"{unknown_label}")

        # the cc manager: off, then on requested
        platform, found = detect_cc("/")
        capable = found and cc["gpus_caps"] == 1
        card_on = cc["cc_feature"] == 1
        cc_status = os.path.join(tmp, "cc-status")
        cc_runs = []
        for request in (None, "on"):
            if request:
                node = client.get("Node", node_name)
                node["metadata"]["labels"][
                    consts.CC_MODE_REQUEST_LABEL] = request
                client.update(node)
            t0 = time.perf_counter()
            rc = cc_main(["--one-shot", f"--node-name={node_name}",
                          "--host-root=/", f"--status-dir={cc_status}"],
                         client=client)
            seconds[f"cc_{request or 'off'}"] = time.perf_counter() - t0
            cc_runs.append({
                "requested": request or "off", "rc": rc,
                "labels": {k: labels().get(k) for k in (
                    consts.CC_CAPABLE_LABEL, consts.CC_MODE_STATE_LABEL)},
                "cc_ready": statusfiles.read_status(consts.STATUS_FILE_CC,
                                                    cc_status)})
        print(json.dumps({"cc": {"platform": platform, "runs": cc_runs}}),
              flush=True)
        want_labels = {consts.CC_CAPABLE_LABEL: "true" if capable
                       else "false",
                       consts.CC_MODE_STATE_LABEL: "on" if card_on else "off"}
        off, on = cc_runs
        _require(off["rc"] == 0 and off["labels"] == want_labels
                 and off["cc_ready"] is not None,
                 f"cc with off requested: {off}, NVML {cc}")
        on_met = capable and card_on
        _require(on["rc"] == (0 if on_met else 1)
                 and (on["cc_ready"] is not None) == on_met
                 and on["labels"] == want_labels,
                 f"cc with on requested: {on}, NVML {cc}")

        # the kata manager: its CLI as a process, twice, then without shim
        stubs, restarts = _recording_stubs(tmp)
        kata_root = os.path.join(tmp, "kata-host")
        shim = os.path.join(kata_root, kata.SHIM_CANDIDATES[0])
        os.makedirs(os.path.dirname(shim))
        with open(shim, "w") as f:  # noqa: TPULNT306 - a stand-in kata shim in the run's temp host tree
            f.write("#!/bin/sh\n")
        conf_dir = os.path.join(tmp, "kata-conf")
        kata_status = os.path.join(tmp, "kata-status")
        env = dict(os.environ,
                   PATH=stubs + os.pathsep + os.environ["PATH"])
        kata_runs = []
        for root in (kata_root, kata_root, os.path.join(tmp, "no-shim")):
            os.makedirs(root, exist_ok=True)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "tpu_operator_torch.kata",
                 "--one-shot", f"--host-root={root}",
                 f"--containerd-conf-dir={conf_dir}",
                 f"--status-dir={kata_status}"],
                capture_output=True, text=True, env=env, timeout=120,
                cwd=HERE)
            dropin = os.path.join(conf_dir, kata.DROPIN_NAME)
            kata_runs.append({
                "seconds": time.perf_counter() - t0, "rc": proc.returncode,
                "restarts": _lines(restarts),
                "dropin_mtime_ns": (os.stat(dropin).st_mtime_ns
                                    if os.path.exists(dropin) else None),
                "kata_ready": statusfiles.read_status(
                    consts.STATUS_FILE_KATA, kata_status),
                "stderr": proc.stderr.strip().splitlines()[-2:]})
        print(json.dumps({"kata": kata_runs}), flush=True)
        first, second, bare = kata_runs
        seconds["kata"] = [r["seconds"] for r in kata_runs]
        with open(os.path.join(conf_dir, kata.DROPIN_NAME)) as f:
            _require(f.read() == kata.kata_dropin("kata-gpu",
                                                  "io.containerd.kata.v2"),
                     "the kata drop-in is not the manager's text")
        _require(first["rc"] == 0
                 and first["restarts"] == ["systemctl restart containerd"]
                 and first["kata_ready"] == {"runtimeClass": "kata-gpu",
                                             "shim": shim},
                 f"kata, first run: {first}")
        _require(second["rc"] == 0 and second["restarts"] == first["restarts"]
                 and second["dropin_mtime_ns"] == first["dropin_mtime_ns"]
                 and second["kata_ready"] == first["kata_ready"],
                 f"kata, second run changed something: {second}")
        _require(bare["rc"] == 1 and bare["kata_ready"] is None,
                 f"kata without its shim: {bare}")

        after = [(c["current"], c["pending"])
                 for c in nativelib.mig_state()]
        _require(after == modes,
                 f"the cards' MIG mode moved: {modes} -> {after}")
        _require(guard.refused == [],
                 f"changing NVML calls were attempted: {guard.refused}")
    finally:
        nativelib._lib = saved
        if client is not None:
            client.close()
        if stub is not None:
            stub.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    seconds["phase"] = time.perf_counter() - t_phase
    print(json.dumps({"node_operands_seconds": seconds,
                      "mig_mode_before_after": [modes, after],
                      "changing_calls": guard.refused}), flush=True)
    return seconds


# --------------------------------------------------------------------------
# the operator phase: the policy reconciler over HTTP to the stub apiserver,
# a kubelet thread running the rendered DaemonSets' own containers
# --------------------------------------------------------------------------

# the DaemonSets whose containers the phase runs: the barriers the
# validator chain waits on, and the chain itself
OPERATOR_RUN = ("gpu-driver-daemonset", "gpu-container-toolkit-daemonset",
                "gpu-operator-validator")
# the writable hostPath volumes, each mapped to a temporary dir: the status
# files, the CDI spec and the containerd configs
OPERATOR_MAPPED_VOLUMES = ("run-gpu", "cdi-root", "containerd-conf",
                           "kernel-cache")
# the component label of the driver DaemonSets, the policy's and each
# GPUDriver's (consts.DRIVER_COMPONENT_LABEL_VALUE)
DRIVER_COMPONENT = "gpu-driver"
# a path an agent computes itself, from its own variable, that lies under a
# mapped volume: without a bind mount the runtime passes the mapped path in
# that variable where the container's env does not set it
OPERATOR_DEFAULT_PATHS = (("CONTAINERD_CONF_DIR", "/etc/containerd/conf.d"),
                          ("METADATA_DIR", "/run/gpu/metadata"))
# a failed init container is restarted, as a kubelet does, after 1, 2, 4,
# ... s (a kubelet's backoff starts at 10 s)
INIT_RESTARTS = 6

class _PodRun:
    """One DaemonSet pod on the card's node: its init containers in order
    (a failed one restarted), then its main containers in the background,
    each a child process; Ready once every main container is alive, its
    startup probe's initial delay has passed and its startup and readiness
    probes pass."""

    def __init__(self, kubelet, ds: dict, pod: dict, serial: int):
        self.kubelet, self.ds, self.pod = kubelet, ds, pod
        self.serial = serial       # the kubelet's count of pods it created
        spec = ds["spec"]["template"]["spec"]
        self.mounts = kubelet.mounts_of(spec)
        self.init = spec.get("initContainers", [])
        self.main = spec["containers"]
        self.records = []          # one per init-container run
        self.procs = []            # (container, Popen, start) of the main ones
        self.started = threading.Event()
        self.failed = None
        self._lock = threading.Lock()
        self._closed = False
        self._running = []         # every child started, for close()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"pod-{ds['metadata']['name']}")

    def log_path(self, c: dict) -> str:
        return os.path.join(self.kubelet.logs,
                            f"{self.pod['metadata']['name']}-{c['name']}-"
                            f"{self.serial}.log")

    def _argv(self, c: dict) -> list:
        args = [self.kubelet.map_path(a, self.mounts)
                for a in c.get("args", [])]
        return child_argv(c.get("command", []), args,
                          api=self.kubelet.api_server,
                          stages=bool(STAGED & set(args)))

    def _spawn(self, c: dict, **kw) -> subprocess.Popen:
        """Start a container's child, unless the pod is being torn down."""
        with self._lock:
            if self._closed:
                raise RuntimeError("the pod was stopped")
            proc = subprocess.Popen(
                self._argv(c), env=self.kubelet.env_of(c, self.pod,
                                                       self.mounts),
                cwd=HERE, start_new_session=True, **kw)
            self._running.append(proc)
            return proc

    def _run(self) -> None:
        try:
            for c in self.init:
                self._run_init(c)
            for c in self.main:
                with open(self.log_path(c), "w") as log:  # noqa: TPULNT306 - temp dir
                    proc = self._spawn(c, stdout=log,
                                       stderr=subprocess.STDOUT)
                self.procs.append((c, proc, time.perf_counter()))
            self.started.set()
        except Exception as e:  # noqa: BLE001 - the phase reports it
            self.failed = e
            self.started.set()

    def _run_init(self, c: dict) -> None:
        for attempt in range(INIT_RESTARTS + 1):
            t0, started = time.perf_counter(), time.time()
            proc = self._spawn(c, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
            out, err = proc.communicate(timeout=300)
            secs = time.perf_counter() - t0
            launches = re.search(r"^launches=(.*)$", out, re.M)
            rec = {"pod": self.pod["metadata"]["name"],
                   "container": c["name"], "args": c.get("args", []),
                   "attempt": attempt, "rc": proc.returncode,
                   "started": started, "seconds": secs, "stages": child_stages(out, secs, t0),
                   "launches": json.loads(launches.group(1))
                   if launches else None,
                   "stdout": out.strip()[-400:],
                   "stderr": err.strip()[-1500:] if proc.returncode else ""}
            # the perf child's readings and floors, from its OK line
            rates = re.findall(r"\b((?:mxu_tflops|hbm_gibs)(?:_floor)?|"
                               r"enforced)=(\S+)", out)
            if rates:
                rec["perf"] = dict(rates)
            self.records.append(rec)
            print(json.dumps({"operator_container": rec}), flush=True)
            if proc.returncode == 0:
                return
            if self.kubelet.stop.wait(min(2.0 ** attempt, 16.0)):
                break
        raise RuntimeError(f"init container {c['name']} of "
                           f"{self.pod['metadata']['name']} failed "
                           f"{attempt + 1} times: {self.records[-1]['stderr']}")

    def ready(self) -> bool:
        if not self.started.is_set() or self.failed is not None:
            return False
        for c, proc, t0 in self.procs:
            if proc.poll() is not None:
                return False
            # no probe before the startup probe's initial delay: a new
            # driver pod's own check must run before its barrier is read
            delay = c.get("startupProbe", {}).get("initialDelaySeconds", 0)
            if time.perf_counter() - t0 < delay:
                return False
            for probe in ("startupProbe", "readinessProbe"):
                cmd = c.get(probe, {}).get("exec", {}).get("command")
                if cmd and subprocess.run(
                        [self.kubelet.map_path(a, self.mounts) for a in cmd],
                        capture_output=True).returncode != 0:
                    return False
        return True

    def close(self) -> list:
        """Stop every child; the main containers' exit codes and seconds."""
        with self._lock:
            self._closed = True
            for proc in self._running:
                if proc.poll() is None:
                    proc.terminate()
        for proc in self._running:
            try:
                proc.wait(10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(10)
        self.thread.join(timeout=30)
        return [{"pod": self.pod["metadata"]["name"], "container": c["name"],
                 "rc": proc.returncode,
                 "alive_seconds": time.perf_counter() - t0}
                for c, proc, t0 in self.procs]


def _one_gpu_node_daemonsets() -> int:
    """The DaemonSets the port's reconciler creates for one GPU node on the
    CPU, with the fake kubelet (the count ``test_torch_controllers``'s HTTP
    case holds)."""
    from tpu_operator_torch.client import FakeClient
    from tpu_operator_torch.controllers import TPUPolicyReconciler
    from tpu_operator_torch.testing import (FakeKubelet, make_cpu_node,
                                            make_gpu_node, sample_policy)
    client = FakeClient([make_gpu_node("n0"), make_cpu_node("c"),
                         sample_policy()])
    rec, kubelet = TPUPolicyReconciler(client), FakeKubelet(client)
    for _ in range(3):
        rec.reconcile()
        kubelet.step()
    return len(client.list("DaemonSet"))


def _request_target(path: str) -> tuple:
    """``(kind, name, subresource)`` of a stub request's path:
    ``/api/v1/...`` or ``/apis/<group>/<version>/...``, then
    ``[namespaces/<ns>/]<plural>[/<name>[/<subresource>]]``; the path
    itself as the kind and the name of any other (``/version``)."""
    from tpu_operator_torch.client.routes import KIND_ROUTES

    kinds = {plural: kind for kind, (_, plural, _) in KIND_ROUTES.items()}
    parts = path.split("?")[0].strip("/").split("/")
    if parts[0] not in ("api", "apis"):
        return path, path, ""
    parts = parts[2:] if parts[0] == "api" else parts[3:]
    if parts[0] == "namespaces" and len(parts) > 2:
        parts = parts[2:]
    return (kinds[parts[0]], parts[1] if len(parts) > 1 else "",
            parts[2] if len(parts) > 2 else "")


def _writes(requests: list) -> dict:
    """The operator's writes among the stub's ``requests``, by verb and
    kind: every write but those to Pods and to the status of Nodes and
    DaemonSets, which only the kubelet and the pods' containers make."""
    verbs = {"POST": "create", "PUT": "update", "PATCH": "patch",
             "DELETE": "delete"}
    out = {}
    for method, path in requests:
        if method not in verbs:
            continue
        kind, _, sub = _request_target(path)
        verb = "update_status" if sub == "status" else verbs[method]
        if kind == "Pod" or (verb == "update_status"
                             and kind in ("Node", "DaemonSet")):
            continue
        out.setdefault(verb, {}).setdefault(kind, 0)
        out[verb][kind] += 1
    return out


def _token_writes(log: list, token: str) -> dict:
    """The writes of the client that sent ``token`` among the stub's
    ``request_log``, by verb and kind (an eviction ``evict``, a status
    write ``update_status``)."""
    verbs = {"POST": "create", "PUT": "update", "PATCH": "patch",
             "DELETE": "delete"}
    out = {}
    for sender, method, path in log:
        if sender != token or method not in verbs:
            continue
        kind, _, sub = _request_target(path)
        verb = ("evict" if sub == "eviction" else "update_status"
                if sub == "status" else verbs[method])
        out.setdefault(verb, {}).setdefault(kind, 0)
        out[verb][kind] += 1
    return out


def _reads(log: list, token: str) -> dict:
    """The reads of the client that sent ``token`` among the stub's
    ``request_log``, by verb and kind: ``list`` (a collection GET), ``get``
    (a named one) and ``watch`` (a stream opened)."""
    out = {}
    for sender, method, path in log:
        if sender != token or method != "GET":
            continue
        kind, name, _ = _request_target(path)
        verb = ("watch" if path.endswith("?watch") else "get" if name
                else "list")
        out.setdefault(verb, {}).setdefault(kind, 0)
        out[verb][kind] += 1
    return out


def _cache_reads() -> dict:
    """The informer's cache hits and misses so far (``informer/metrics``)."""
    from tpu_operator_torch.informer import metrics

    out = {"hits": 0.0, "misses": 0.0}
    for metric in metrics.REGISTRY.collect():
        for name, _, value in metric.samples:
            if name == "gpu_operator_informer_cache_hits_total":
                out["hits"] += value
            elif name == "gpu_operator_informer_cache_misses_total":
                out["misses"] += value
    return out


# the operator's client, as the stub's request log names it
OPERATOR_TOKEN = "operator"
# the informer of the operator's phases: the JAX runner's kinds and scopes
INFORMER_KINDS = ("GPUPolicy", "GPUDriver", "Node", "DaemonSet", "Pod",
                  "GPUWorkload")
INFORMER_NAMESPACED = ("DaemonSet", "Pod")
# the stub's watch journal: the whole phase, so a watch dropped mid-phase
# resumes from its resourceVersion instead of relisting
INFORMER_WATCH_WINDOW = 1 << 20
# the requeue of a pass that names none, by work-queue key (the runner's)
DEFAULT_REQUEUE_S = {"policy": 30.0, "upgrade": 120.0, "driver": 30.0,
                     "remediation": 30.0, "remediate": 30.0,
                     "workload": 60.0}


def informer_cache(client, namespace: str, stop):
    """A started ``SharedInformerCache`` on ``client`` over
    :data:`INFORMER_KINDS`, its default indexers and the validator pods'
    ``app`` label index, as the JAX package's operator runner builds it;
    returns once every kind is synced."""
    from tpu_operator_torch.informer import (DEFAULT_INDEXERS,
                                             SharedInformerCache)

    cache = SharedInformerCache(
        client, kinds=INFORMER_KINDS,
        namespaces={k: namespace for k in INFORMER_NAMESPACED})
    for kind, name, fn in DEFAULT_INDEXERS:
        cache.add_index(kind, name, fn)
    cache.add_label_index("Pod", "app")
    cache.start(stop=stop)
    deadline = time.monotonic() + 30
    while not all(cache.synced(k) for k in INFORMER_KINDS):
        _require(time.monotonic() < deadline,
                 f"the informer never synced: {cache.relist_count}")
        time.sleep(0.02)
    return cache


class WatchRouter:
    """Watch events to work-queue keys, routed as the JAX package's operator
    runner routes them (``cmd/operator.py``: ``_WAKE_KINDS``,
    ``_wake_wanted``, ``_driver_wake_keys``, ``_remediation_wake_keys``,
    ``_workload_wake_keys``, the Node heartbeat and DaemonSet rollout
    filters): an event marks due the keys of the reconcilers that read its
    kind and sets ``wake``.  A ``GPUDriver``'s events make and mark its key
    ``driver/<name>``, a ``GPUWorkload``'s its key
    ``workload/<namespace>/<name>`` (and the discovery key ``workload``);
    a node's ``remediate/<node>`` key is made by the remediation sweep
    alone, and its Node's and its pods' events mark it.  A relist marks
    every key due.  ``marks`` counts, per key, the events that marked
    it."""

    WAKE_KINDS = {"policy": {"GPUPolicy", "Node", "DaemonSet"},
                  "driver": {"GPUDriver", "GPUPolicy", "Node", "DaemonSet"},
                  "upgrade": {"GPUPolicy", "Node", "Pod"},
                  "remediation": {"GPUPolicy", "Node", "Pod"},
                  "workload": {"GPUWorkload", "Node", "Pod"}}
    DRIVER_KEY_PREFIX = "driver/"
    REMEDIATION_KEY_PREFIX = "remediate/"
    WORKLOAD_KEY_PREFIX = "workload/"

    def __init__(self):
        from tpu_operator_torch.informer import KeyedWorkQueue

        self.queue = KeyedWorkQueue(tuple(self.WAKE_KINDS))
        self.wake = threading.Event()
        self.marks = {}
        self._lock = threading.Lock()
        self._node_sigs, self._ds_sigs = {}, {}

    @staticmethod
    def _node_sig(obj: dict) -> tuple:
        # what the reconcilers read of a Node: labels, annotations, spec,
        # extended-resource capacity and the NotReady verdict
        md, status = obj.get("metadata", {}), obj.get("status", {})
        capacity = {k: v for k, v in (status.get("capacity") or {}).items()
                    if "/" in k}
        not_ready = any(c.get("type") == "Ready"
                        and c.get("status") in ("False", "Unknown")
                        for c in status.get("conditions") or [])
        return (md.get("labels", {}), md.get("annotations", {}),
                obj.get("spec", {}), capacity, not_ready)

    @staticmethod
    def _ds_sig(obj: dict) -> tuple:
        # spec, metadata and the readiness verdict: rollout counter bumps
        # that keep the verdict are heartbeats
        from tpu_operator_torch.state.skel import _workload_ready

        md = obj.get("metadata", {})
        return (md.get("labels", {}), md.get("annotations", {}),
                obj.get("spec", {}), _workload_ready(obj))

    def _wanted(self, rec: str, kind: str, obj: dict) -> bool:
        from tpu_operator_torch import consts
        from tpu_operator_torch.controllers.tpudriver_controller import (
            DRIVER_STATE_PREFIX)

        if kind not in self.WAKE_KINDS[rec]:
            return False
        labels = obj.get("metadata", {}).get("labels", {})
        if kind == "DaemonSet":
            state = labels.get(consts.STATE_LABEL, "")
            if not state:
                return True
            driver_cr = state.startswith(DRIVER_STATE_PREFIX)
            return driver_cr if rec == "driver" else not driver_cr
        if kind == "Pod" and rec in ("upgrade", "remediation"):
            return (labels.get("app.kubernetes.io/component")
                    == consts.DRIVER_COMPONENT_LABEL_VALUE
                    or labels.get("app") == "gpu-operator-validator")
        if kind == "Pod" and rec == "workload":
            return consts.WORKLOAD_NAME_LABEL in labels
        return True

    def _driver_keys(self, kind: str, obj: dict) -> list:
        from tpu_operator_torch import consts
        from tpu_operator_torch.controllers.tpudriver_controller import (
            DRIVER_STATE_PREFIX)

        if kind == "DaemonSet":
            state = obj.get("metadata", {}).get("labels", {}).get(
                consts.STATE_LABEL, "")
            key = self.DRIVER_KEY_PREFIX + state[len(DRIVER_STATE_PREFIX):]
            if state.startswith(DRIVER_STATE_PREFIX) \
                    and self.queue.has_key(key):
                return [key]
            return ["driver"]
        return [k for k in self.queue.keys()
                if k.startswith(self.DRIVER_KEY_PREFIX)] + ["driver"]

    def _remediation_keys(self, kind: str, obj: dict) -> list:
        # the sweep always; the event's own node's key where one exists —
        # a Node names itself, a validator or driver pod its node
        keys = ["remediation"]
        name = (obj.get("metadata", {}).get("name", "") if kind == "Node"
                else obj.get("spec", {}).get("nodeName", "")
                if kind == "Pod" else "")
        if name and self.queue.has_key(self.REMEDIATION_KEY_PREFIX + name):
            keys.append(self.REMEDIATION_KEY_PREFIX + name)
        return keys

    def _workload_keys(self, kind: str, obj: dict) -> list:
        # a gang pod names its owner; a Node event wakes every gang
        from tpu_operator_torch import consts

        if kind == "Pod":
            md = obj.get("metadata", {})
            owner = md.get("labels", {}).get(consts.WORKLOAD_NAME_LABEL, "")
            key = f"{self.WORKLOAD_KEY_PREFIX}{md.get('namespace', '')}/" \
                  f"{owner}"
            return [key] if owner and self.queue.has_key(key) \
                else ["workload"]
        return [k for k in self.queue.keys()
                if k.startswith(self.WORKLOAD_KEY_PREFIX)] + ["workload"]

    def _mark(self, keys) -> None:
        for key in keys:
            if self.queue.mark_due(key):
                with self._lock:
                    self.marks[key] = self.marks.get(key, 0) + 1
        self.wake.set()

    def on_event(self, verb: str, obj: dict) -> None:
        kind = obj.get("kind", "")
        md = obj.get("metadata", {})
        with self._lock:
            sigs, sig = ((self._node_sigs, self._node_sig) if kind == "Node"
                         else (self._ds_sigs, self._ds_sig)
                         if kind == "DaemonSet" else (None, None))
            if sigs is not None:
                key = (md.get("namespace", ""), md.get("name", ""))
                if verb == "DELETED":
                    sigs.pop(key, None)
                else:
                    new = sig(obj)
                    if sigs.get(key) == new:
                        return          # a heartbeat: nothing to act on
                    sigs[key] = new
        if kind == "GPUDriver":
            key = self.DRIVER_KEY_PREFIX + md.get("name", "")
            if verb == "DELETED":
                self.queue.remove_key(key)
                self._mark(["driver"])
            else:
                self.queue.add_key(key)
                self._mark([key])
            return
        if kind == "GPUWorkload":
            key = (f"{self.WORKLOAD_KEY_PREFIX}{md.get('namespace', '')}/"
                   f"{md.get('name', '')}")
            if verb == "DELETED":
                self.queue.remove_key(key)
                self._mark(["workload"])
            else:
                self.queue.add_key(key)
                self._mark([key, "workload"])
            return
        keys = []
        for rec in self.WAKE_KINDS:
            if self._wanted(rec, kind, obj):
                keys += (self._driver_keys(kind, obj) if rec == "driver"
                         else self._remediation_keys(kind, obj)
                         if rec == "remediation"
                         else self._workload_keys(kind, obj)
                         if rec == "workload" else [rec])
        if keys:
            self._mark(keys)

    def on_relist(self, kind: str) -> None:
        self._mark(self.queue.keys())


class Passes:
    """Reconcile passes over the stub apiserver, taken when the work queue
    says: a pass runs once one of its ``keys`` is due — marked by a watch
    event through ``router`` or by its committed requeue — pops every key,
    is timed and traced (a ``reconcile.<tag>`` root span), commits each
    key's next run from ``requeues(result)`` (``{key: result}``; a result's
    ``requeue_after``, else the runner's default, or a backoff retry on an
    error), and gives the row ``row_of(result, requests)`` makes of what
    ``reconcile()`` returned and the requests it sent, with the operator
    client's reads and writes by verb and kind and the informer's cache
    hits and misses in the pass.  ``keys`` is a tuple, or a function
    giving the keys of the moment (keys the reconcilers make and retire);
    a key made during a pass is born due and runs in the next.  The row is kept, printed under ``tag`` and
    must carry no ``error``.  :meth:`drive` takes passes until one is
    done."""

    def __init__(self, stub, kubelet, tag: str, reconcile, row_of, router,
                 keys: tuple, requeues):
        self.stub, self.kubelet, self.tag = stub, kubelet, tag
        self.reconcile, self.row_of = reconcile, row_of
        self.router, self._keys, self.requeues = router, keys, requeues
        self.rows = []
        for key in self.keys:
            router.queue.add_key(key)

    @property
    def keys(self) -> tuple:
        return tuple(self._keys() if callable(self._keys) else self._keys)

    def wait_due(self, deadline: float) -> list:
        """The pass's keys that are due, once one is: woken by the router
        or by the earliest committed requeue."""
        queue = self.router.queue
        while True:
            self.router.wake.clear()
            now = time.monotonic()
            due = [k for k in queue.due(now) if k in self.keys]
            if due:
                return due
            _require(now < deadline, f"{self.tag}: no key of {self.keys} "
                                     f"came due: {queue.deadlines}")
            _require(self.kubelet.error is None,
                     f"the kubelet failed: {self.kubelet.error!r}")
            delay = queue.next_delay(now)
            self.router.wake.wait(min(1.0, deadline - now,
                                      delay if delay is not None else 1.0))

    def one(self, label: str, due=None) -> dict:
        from tpu_operator_torch.obs import trace

        queue = self.router.queue
        gens = {key: queue.pop(key) for key in self.keys}
        start, start_log = len(self.stub.requests), len(self.stub.request_log)
        cache0 = _cache_reads()
        started, t0 = time.monotonic(), time.perf_counter()
        with trace.root_span(f"reconcile.{self.tag}", {"label": label}):
            result = self.reconcile()
        secs = time.perf_counter() - t0
        sent = self.stub.requests[start:]
        log = self.stub.request_log[start_log:]
        cache1 = _cache_reads()
        now = time.monotonic()
        for key, res in self.requeues(result).items():
            if key not in gens:
                continue            # made in this pass: born due
            if res.error:
                queue.retry(key, gens[key], now)
                continue
            queue.forget(key)
            queue.commit(key, gens[key], now + (
                res.requeue_after or DEFAULT_REQUEUE_S[key.split("/")[0]]))
        row = {"pass": len(self.rows) + 1, "label": label, "seconds": secs,
               "started": started, "due": due, **self.row_of(result, sent),
               "reads": _reads(log, OPERATOR_TOKEN),
               "operator_writes": _token_writes(log, OPERATOR_TOKEN),
               "cache": {k: cache1[k] - cache0[k] for k in cache1}}
        self.rows.append(row)
        print(json.dumps({self.tag: {k: v for k, v in row.items()
                                     if k != "stub_writes"}}), flush=True)
        _require(row["error"] is None,
                 f"{self.tag} {row['pass']}: {row['error']}")
        return row

    def next(self, label: str, deadline_s: float) -> dict:
        """The next pass, once a key of it is due."""
        due = self.wait_due(time.monotonic() + deadline_s)
        return self.one(label, due)

    def drive(self, label: str, done, deadline_s: float, row=None) -> dict:
        """Passes (after ``row``, where given) until ``done(row)``, each
        when the work queue has a key of it due."""
        deadline = time.monotonic() + deadline_s
        row = row or self.next(label, deadline_s)
        while not done(row):
            _require(time.monotonic() < deadline,
                     f"{label}: not done within {deadline_s} s: {row}")
            row = self.one(label, self.wait_due(deadline))
        return row


def _tree(paths: list) -> dict:
    """Every dir and file under ``paths`` with its mtime (None where a path
    does not exist)."""
    out = {}
    for top in paths:
        out[top] = None
        for root, _, files in os.walk(top):
            for p in [root] + [os.path.join(root, f) for f in files]:
                with contextlib.suppress(OSError):
                    out[p] = os.stat(p).st_mtime_ns
    return out


def validated_node(torch, host, status_dir: str, init: list) -> dict:
    """What the validator's run left on the node, read as the cluster
    reads it: each of its init containers' own command again with
    ``--wait``, in this process (each must pass at once); the status
    files; ``vfio`` failing on cards the driver holds; one scrape of the
    validator's exporter.  ``init`` are the validator DaemonSet's init
    containers as the stub holds them, ``status_dir`` the dir they wrote.
    Returns the seconds of each step."""
    from tpu_operator_torch import statusfiles
    from tpu_operator_torch.validator.__main__ import main as validator_main
    from tpu_operator_torch.validator.metrics import serve

    base = [f"--status-dir={status_dir}", "--host-root=/"]
    chips = host.discover().chips
    seconds, waits = {}, {}
    for c in init:
        _require(c["command"] == ["python", "-m",
                                  "tpu_operator_torch.validator"],
                 f"{c['name']} runs {c['command']}")
        rc, waits[c["name"]], _, err = _cli(
            validator_main, [*c["args"], "--wait", *base])
        _require(rc == 0 and waits[c["name"]] < 1.0,
                 f"{c['args']} --wait: rc {rc}, {waits[c['name']]:.3f} s "
                 f"{err.strip()}")
    seconds["waits"] = waits

    chain = ("device", "driver", "toolkit", "torch", "perf")
    ready = {c: statusfiles.read_status(f"{c}-ready", status_dir)
             for c in chain}
    print(json.dumps({"status_files": ready}), flush=True)
    # NVIDIA_VISIBLE_DEVICES names NVML indices, whatever the minors
    indices = ",".join(str(i) for i in sorted(c.nvml_index for c in chips))
    _require(ready["toolkit"]["injected_chips"] == indices
             and {c.nvml_index for c in chips}
             <= set(range(torch.cuda.device_count())),
             f"toolkit-ready injected {ready['toolkit']['injected_chips']}"
             f", the cards' NVML indices are {indices}")
    _require(ready["device"]["chip_count"] == str(len(chips)),
             f"device-ready {ready['device']}")
    _require(ready["torch"].get("devices") == str(torch.cuda.device_count()),
             f"torch-ready missing or wrong: {ready['torch']}")
    report = statusfiles.read_status("perf-report", status_dir) or {}
    print(json.dumps({"perf_report_validator_pod": report}), flush=True)
    _require(all(report.get(f"{p}-probe_ok") == "true"
                 for p in ("vpu", "mxu", "hbm"))
             and report.get("enforced") == "true"
             and {"mxu_tflops_floor", "hbm_gibs_floor"} <= set(report),
             f"perf-report {report}")

    rc, seconds["vfio"], _, err = _cli(validator_main,
                                       ["--component=vfio", *base])
    visible = [c.pci_address for c in chips if os.path.isdir(
        os.path.join(host.sys_root, "bus", "pci", "devices", c.pci_address))]
    print(json.dumps({"vfio": {"rc": rc, "stderr": err.strip(),
                               "pci_visible": visible}}), flush=True)
    _require(rc == 1, f"--component=vfio exited {rc}, want 1")
    _require(all(f"{addr}(nvidia)" in err for addr in visible),
             f"vfio's message names not every card's driver: {err}")

    t0 = time.perf_counter()
    server = serve(0, status_dir, host)
    try:
        samples = _scrape(server.server_address[1])
    finally:
        server.shutdown()
        server.server_close()
    seconds["metrics"] = time.perf_counter() - t0
    prefix = "gpu_operator_node_"
    gauges = {name.removeprefix(prefix): value
              for (name, labels), value in samples.items() if not labels}
    cards = [v for (name, _), v in samples.items()
             if name == prefix + "gpu_chips"]
    probes = {labels for (name, labels), _ in samples.items()
              if name == prefix + "perf_achieved"}
    print(json.dumps({"metrics": {"ready": {k: v for k, v in gauges.items()
                                            if k.endswith("_ready")},
                                  "gpu_chips": cards,
                                  "perf_achieved": sorted(probes)}}),
          flush=True)
    _require(all(gauges.get(f"{c}_ready") == 1.0 for c in chain)
             and gauges.get("vfio_ready") == 0.0,
             f"exporter readiness {gauges}")
    _require(cards == [float(torch.cuda.device_count())],
             f"exporter gpu_chips {cards}")
    _require(all(any(f'probe="{p}"' in labels for labels in probes)
                 for p in ("mxu-probe", "hbm-probe")),
             f"exporter perf_achieved {probes}")
    return seconds


def operator(torch, ops) -> dict:
    """The operator's reconcile path on the card's node, over real HTTP to
    the port's stub apiserver: the card's Node labelled by the port's fd
    (``build_labels`` on the live host) and a CPU-only Node, then
    ``sample_policy()``; the policy reconciler through ``RetryingClient`` →
    ``InClusterClient``, reading through the informer's cache on its
    client (:func:`informer_cache`) and woken by the work queue the watch
    events mark (:class:`WatchRouter`); a :class:`Kubelet` thread serving
    the device plugin into the Node's capacity, running the plugin component's
    workload pod and, from pass 2 on, the rendered driver, toolkit and
    validator DaemonSets' own containers.  Pass 1 must read ``notReady``
    (``OperandNotReady``, 5 s) with deploy labels on the card's node only
    and the DaemonSets of one GPU node; later passes, each taken when a
    watch event or the requeue makes the policy's key due, must reach
    ``ready`` with the card's slice ready; one more pass writes nothing and
    LISTs no watched kind; with every watch stream dropped, an
    ``gpu-degraded`` file in the validator's status dir makes the slice not
    ready and its removal ready again, each woken by the resumed watch with
    no relist.  No container may write on the host outside the phase's
    temporary dir.  Then the upgrade and remediation phases, and a restart
    of the informer from its snapshot with no seed LIST.  Returns the
    launch counts of the validator's children, of the upgrade phase and
    of the remediation phase."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.client.resilience import (
        resilient_incluster_client)
    from tpu_operator_torch.controllers import TPUPolicyReconciler, metrics
    from tpu_operator_torch.fd import build_labels
    from tpu_operator_torch.host import host_for_root
    from tpu_operator_torch.obs import export, profile, trace
    from tpu_operator_torch.testing.fake_cluster import (make_cpu_node,
                                                         sample_policy)
    from tpu_operator_torch.testing.stub_apiserver import StubApiServer

    t_phase = time.perf_counter()
    ops.reset_launches()
    want_ds = _one_gpu_node_daemonsets()
    host = host_for_root("/")
    node_name, cpu_name = "h100-node-0", "cpu-node-0"
    namespace = consts.DEFAULT_NAMESPACE
    card_labels = {"kubernetes.io/hostname": node_name,
                   **build_labels(host)}
    stub = StubApiServer([
        {"apiVersion": "v1", "kind": "Node",
         "metadata": {"name": node_name, "labels": card_labels},
         "spec": {}, "status": {"capacity": {}, "nodeInfo": {
             "containerRuntimeVersion": "containerd://1.7.0"}}},
        make_cpu_node(cpu_name), sample_policy()],
        watch_event_window=INFORMER_WATCH_WINDOW)
    clients = [resilient_incluster_client(api_server=stub.url, token=t)
               for t in (OPERATOR_TOKEN, "kubelet", "reader")]
    tmp = tempfile.mkdtemp(prefix="operator")
    stubs, restarts_file = _recording_stubs(tmp)
    endpoint = PluginEndpoint(host)
    passes, exits = [], []
    host_paths, host_before, host_after = [], {}, {}
    kubelet = None
    stop = threading.Event()        # ends the informers' watch streams
    trace.configure(enabled=True)
    try:
        endpoint.start()
        kubelet = Kubelet(clients[1], endpoint, endpoint.devices(),
                          node_name, namespace, consts.DEFAULT_RESOURCE_NAME,
                          os.path.join(tmp, "host", "var", "run", "cdi"),
                          api_server=stub.url, tmp=tmp, stubs=stubs)
        kubelet.start()
        stub.pod_containers_running = kubelet.runs_containers_of
        _require(kubelet.advertised.wait(30),
                 f"the kubelet never wrote the capacity: {kubelet.error!r}")
        router = WatchRouter()
        cache = informer_cache(clients[0], namespace, stop)
        cache.subscribe(router.on_event)
        cache.subscribe_relist(router.on_relist)
        rec = TPUPolicyReconciler(clients[0], namespace=namespace,
                                  reader=cache.reader())
        reader = clients[2]

        def row_of(res, sent) -> dict:
            policy = reader.get("GPUPolicy", "gpu-policy")
            status = policy.get("status", {})
            labels = reader.get("Node", node_name)["metadata"]["labels"]
            return {"ready": res.ready, "requeue_after": res.requeue_after,
                    "error": res.error, "waits": len(res.waits),
                    "writes": _writes(sent),
                    "stub_writes": [r for r in sent if r[0] != "GET"],
                    "state": status.get("state"),
                    "reasons": [c["reason"] for c in
                                status.get("conditions", [])
                                if c.get("status") == "True"],
                    "slices": (status.get("slicesTotal"),
                               status.get("slicesReady")),
                    "slice_ready": labels.get(consts.SLICE_READY_LABEL)}

        run = Passes(stub, kubelet, "operator_pass", rec.reconcile, row_of,
                     router, ("policy",), lambda res: {"policy": res})
        passes = run.rows

        # pass 1: the node labelled, every operand created, nothing ready
        t_ready = time.perf_counter()
        row = run.next("first", 30)
        created = row["writes"].get("create", {})
        print(json.dumps({"operator_created": created}), flush=True)
        card = reader.get("Node", node_name)["metadata"]["labels"]
        cpu = reader.get("Node", cpu_name)["metadata"]["labels"]
        deploy = [k for k in consts.STATE_LABELS_CONTAINER
                  + consts.STATE_LABELS_COMMON]
        _require(not row["ready"] and row["requeue_after"] == 5
                 and row["state"] == "notReady"
                 and row["reasons"] == ["OperandNotReady"],
                 f"pass 1: {row}")
        _require(all(card.get(k) == "true" for k in deploy)
                 and card.get(consts.TPU_PRESENT_LABEL) == "true",
                 f"the card's node lacks deploy labels: {card}")
        _require(not [k for k in cpu if k.startswith(consts.DOMAIN + "/")],
                 f"the CPU node got operator labels: {cpu}")
        _require(created.get("DaemonSet") == want_ds,
                 f"pass 1 created {created.get('DaemonSet')} DaemonSets, "
                 f"the CPU run {want_ds}")
        # the host paths of the volumes the containers write, as rendered:
        # each is mapped to a temporary dir, so none may change
        host_paths = sorted({
            v["hostPath"]["path"]
            for ds in reader.list("DaemonSet", namespace)
            if ds["metadata"]["name"] in OPERATOR_RUN
            for v in ds["spec"]["template"]["spec"].get("volumes", [])
            if v["name"] in OPERATOR_MAPPED_VOLUMES and "hostPath" in v})
        host_before = _tree(host_paths)

        # the chain: passes as watch events and requeues wake the key
        kubelet.daemonsets.set()
        row = run.drive("chain", lambda r: r["ready"], 300, row=row)
        ready_seconds = time.perf_counter() - t_ready
        ready_passes = len(passes)
        _require(row["state"] == "ready" and "Ready" in row["reasons"]
                 and row["slices"] == (1, 1)
                 and row["slice_ready"] == "true",
                 f"ready pass: {row}")
        cpu = reader.get("Node", cpu_name)["metadata"]["labels"]
        _require(not [k for k in cpu if k.startswith(consts.DOMAIN + "/")],
                 f"the CPU node got operator labels: {cpu}")
        val = kubelet.runs["gpu-operator-validator"]
        _require([r["container"] for r in val.records if r["rc"] == 0]
                 == [f"{c}-validation" for c in ("device", "driver",
                                                 "toolkit", "torch", "perf",
                                                 "plugin")],
                 f"the validator's init containers: {val.records}")
        status_dir = Kubelet.map_path("/run/gpu/validations", val.mounts)
        node_seconds = validated_node(torch, host, status_dir, val.init)
        # the driver agent mirrored the node's metadata into its mapped
        # run-gpu dir, not the host's
        mirror = Kubelet.map_path(dict(OPERATOR_DEFAULT_PATHS)[
            "METADATA_DIR"], kubelet.runs["gpu-driver-daemonset"].mounts)
        _require(mirror.startswith(tmp + os.sep) and os.path.isdir(mirror),
                 f"no metadata mirror at {mirror}")

        # steady state: a pass that writes nothing, at the stub either,
        # and reads every watched kind from the cache
        row = run.one("steady")
        _require(row["ready"] and row["writes"] == {} and not row["stub_writes"],
                 f"steady pass wrote: {row['writes']} {row['stub_writes']}")
        listed = sorted(set(row["reads"].get("list", {}))
                        & set(INFORMER_KINDS))
        _require(not listed and row["cache"]["hits"] > 0,
                 f"the steady pass LISTed watched kinds {listed} "
                 f"(reads {row['reads']}, cache {row['cache']})")
        steady_reads = row["reads"]
        # the same steady pass as the parent slice took it: a reconciler
        # with no informer, reading the stub live
        start = len(stub.request_log)
        live = TPUPolicyReconciler(clients[0], namespace=namespace).reconcile()
        steady_reads_live = _reads(stub.request_log[start:], OPERATOR_TOKEN)
        _require(live.ready, f"the uncached steady pass: {live}")

        # every watch stream dropped: each resumes from its resourceVersion
        restarts0 = dict(cache.watch_restarts)
        relists0 = dict(cache.relist_count)
        stub.drop_watches()
        t0 = time.perf_counter()
        while not all(cache.watch_restarts[k] > restarts0[k]
                      for k in INFORMER_KINDS):
            _require(time.perf_counter() - t0 < 30,
                     f"the watches never resumed: {cache.watch_restarts}")
            time.sleep(0.02)
        resume_seconds = time.perf_counter() - t0

        # the negative path: the watchdog's file fails the validator's
        # readiness probe, and the slice goes with it — the resumed watch
        # wakes the policy's key before its requeue
        marks0 = router.marks.get("policy", 0)
        requeue_at = router.queue.deadlines["policy"]
        flag = os.path.join(status_dir, "gpu-degraded")
        with open(flag, "w") as f:  # noqa: TPULNT306 - temp dir
            f.write("reasons=chip_down\n")
        t0 = time.perf_counter()
        while kubelet.status.get("gpu-operator-validator", {}).get(
                "numberReady") != 0:
            _require(time.perf_counter() - t0 < 30,
                     "the validator pod stayed Ready with gpu-degraded")
            time.sleep(0.05)
        degraded_seconds = time.perf_counter() - t0
        row = run.drive("degraded", lambda r: r["slices"] == (1, 0), 30)
        _require(not row["ready"] and row["slices"] == (1, 0)
                 and row["slice_ready"] == "false",
                 f"degraded pass: {row}")
        _require(router.marks.get("policy", 0) > marks0
                 and row["started"] < requeue_at,
                 f"no watch event woke the policy's key: marks "
                 f"{router.marks}, pass at {row['started']}, requeue at "
                 f"{requeue_at}")
        os.remove(flag)
        t0 = time.perf_counter()
        while kubelet.status.get("gpu-operator-validator", {}).get(
                "numberReady") != 1:
            _require(time.perf_counter() - t0 < 30,
                     "the validator pod never came back Ready")
            time.sleep(0.05)
        recovered_seconds = time.perf_counter() - t0
        row = run.drive("recovered", lambda r: r["slices"] == (1, 1), 30)
        _require(row["ready"] and row["slices"] == (1, 1)
                 and row["slice_ready"] == "true",
                 f"recovered pass: {row}")
        _require(cache.relist_count == relists0,
                 f"a dropped watch relisted: {relists0} -> "
                 f"{cache.relist_count}")
        watch = {"restarts": {k: cache.watch_restarts[k] - restarts0[k]
                              for k in INFORMER_KINDS},
                 "relists": {k: cache.relist_count[k] - relists0[k]
                             for k in INFORMER_KINDS},
                 "resume_seconds": resume_seconds,
                 "policy_marks": router.marks.get("policy", 0) - marks0}
        print(json.dumps({"operator_watch_drop": watch}), flush=True)

        # the passes' cost board and one pass's Chrome trace
        traces = [t for t in trace.snapshot(256)["recent"]
                  if t["name"] == "reconcile.operator_pass"]
        slowest = max(traces, key=lambda t: t["duration_ms"])
        chrome = export.chrome_trace(slowest)
        with open(os.path.join(tmp, "operator-pass.trace.json"), "w") as f:  # noqa: TPULNT306 - temp dir
            json.dump(chrome, f)
        obs_out = {"board": profile.board_snapshot(),
                   "traced_passes": len(traces),
                   "chrome_trace": {
                       "pass": next(sp["attrs"].get("label")
                                    for sp in slowest["spans"]
                                    if not sp["parent_id"]),
                       "duration_ms": slowest["duration_ms"],
                       "spans": len(slowest["spans"]),
                       "events": len(chrome["traceEvents"])}}
        print(json.dumps({"operator_obs": obs_out}), flush=True)
        _require(len(slowest["spans"]) > 1
                 and "reconcile.operator_pass" in obs_out["board"],
                 f"the passes' traces: {obs_out}")
        init_records = [r for run in kubelet.runs.values()
                        for r in run.records]
        marked = list(kubelet.marked)
        workload_pods = list(kubelet.pods)
        launches = {name: 0 for name in ops.LAUNCHES}
        for r in init_records + workload_pods:
            for name, n in (r["launches"] or {}).items():
                launches[name] += n
        for name, n in ops.LAUNCHES.items():
            launches[name] += n          # the reconciler's process: none
        operator_seconds = time.perf_counter() - t_phase

        # the upgrade leg, over the same stub, kubelet and temp dirs
        ops.reset_launches()
        upgrade_launches = upgrade(ops, stub, clients[0], reader, kubelet,
                                   rec, node_name, namespace, router, cache)
        # the remediation leg, likewise
        ops.reset_launches()
        remediation_launches = remediation(ops, stub, clients[0], reader,
                                           kubelet, rec, node_name,
                                           namespace, router, cache, tmp)
        snapshot_restart(stub, cache, namespace, tmp)
        names_leg(
            "operator", list(stub.store._store.values()),
            os.path.join(tmp, "host"),
            SCRAPED_PAGES + [metrics.exposition().decode()],
            kubelet.child_envs, [os.path.join(tmp, "snapshot")])
    finally:
        stop.set()
        trace.configure(enabled=False)
        if kubelet is not None:
            exits = kubelet.close()
        endpoint.close()
        for c in clients:
            c.close()
        stub.shutdown()
        restarts = _lines(restarts_file)
        host_after = _tree(host_paths)
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"operator": {
        "run": list(OPERATOR_RUN), "marked_rolled_out": marked,
        "container_exits": exits,
        "init_containers": [{k: r[k] for k in ("pod", "container",
                                               "attempt", "rc", "seconds",
                                               "stages")}
                            for r in init_records],
        "workload_pods": [{k: p[k] for k in ("name", "args", "launches",
                                             "child_seconds", "stages")}
                          for p in workload_pods],
        "containerd_restarts": restarts,
        "pass_seconds": [p["seconds"] for p in passes],
        "writes_by_pass": [p["writes"] for p in passes],
        "reads_by_pass": [p["reads"] for p in passes],
        "cache_by_pass": [p["cache"] for p in passes],
        "steady_reads": steady_reads,
        "steady_reads_uncached": steady_reads_live,
        "policy_to_ready_seconds": ready_seconds,
        "policy_to_ready_passes": ready_passes,
        "probe_to_not_ready_seconds": degraded_seconds,
        "probe_to_ready_seconds": recovered_seconds,
        "validated_node_seconds": node_seconds,
        "validator_launches": launches,
        "metadata_mirror": os.path.relpath(mirror, tmp),
        "host_paths_unchanged": host_paths}}), flush=True)
    _require(kubelet.error is None, f"the kubelet failed: {kubelet.error!r}")
    _require(len(workload_pods) == 1 and workload_pods[0]["child"]
             .returncode == 0, f"the workload pods: {workload_pods}")
    _check_workload_child(workload_pods[0], tmp)
    _require(all(e["rc"] is not None for e in exits),
             f"a container outlived the phase: {exits}")
    moved = sorted(p for p in set(host_after) | set(host_before)
                   if host_after.get(p) != host_before.get(p))
    _require(not moved, "a container wrote on the host outside the "
                        f"phase's dir: {moved}")
    _require(restarts == ["systemctl restart containerd"],
             f"containerd restarts issued: {restarts}")
    _require(all(launches[k] > 0 for k in
                 ("matmul_bf16_f32", "triad_", "fma_relu")),
             f"the validator's children launched {launches}")
    staged = [r for r in init_records if r["stages"] and r["rc"] == 0]
    _require([r["container"] for r in staged]
             == ["torch-validation", "perf-validation"]
             and not staged[0]["stages"]["kernel_cache_hit"]
             and staged[1]["stages"]["kernel_cache_hit"]
             and all(r["stages"]["build_root"].startswith(tmp + os.sep)
                     for r in staged),
             "the validator's kernel build did not land in the node's "
             f"build dir once and load from it after: {staged}")
    print(json.dumps({"operator_seconds": operator_seconds,
                      "operator_and_upgrade_seconds":
                          time.perf_counter() - t_phase}), flush=True)
    return launches, upgrade_launches, remediation_launches


# --------------------------------------------------------------------------
# the upgrade phase: the driver controller and the rolling driver upgrade
# over the operator phase's stub apiserver, kubelet thread and temp dirs
# --------------------------------------------------------------------------

UPGRADE_DRIVER_CR = "h100"
# the user's job the upgrade waits for: one card, the validator's own
# tensor-core and memory burn-in (it launches the matmul kernel), in a pod
# (no status file written)
UPGRADE_JOB = {"name": "burn-in-job", "namespace": "default",
               "labels": {"app": "burn-in-job"},
               "args": ["--component=torch", "--in-pod"]}
# a driver version no card has: its driver pod's NVML check must fail
UPGRADE_WRONG_VERSION = "999.99.99"
# the validation stage's budget on the machine (the JAX tests shorten it
# the same way); the reconciler's 5 s requeue outlasts it, so the stage
# parks on its second blocked pass
UPGRADE_VALIDATION_BUDGET_S = 3.0
# the driver CR's startup probe: 3 s for the agent to clear its
# predecessor's barrier and make its own check (the default waits 10 s)
UPGRADE_STARTUP_PROBE = {"initialDelaySeconds": 3, "periodSeconds": 1,
                         "failureThreshold": 60}
UPGRADE_DEADLINE_S = 180.0


def _upgrade_writes(requests: list) -> dict:
    """The upgrade machine's writes among the stub's ``requests``: Node
    updates (its labels, annotations and cordons: the kubelet writes only
    the Node's status), pod deletions and evictions, with the operator's
    other writes by verb and kind as :func:`_writes` counts them."""
    out = {"node_updates": 0, "pod_deletes": [], "evictions": [],
           **_writes(requests)}
    for method, path in requests:
        parts = path.split("?")[0].strip("/").split("/")
        if method == "PUT" and parts[:3] == ["api", "v1", "nodes"] \
                and len(parts) == 4:
            out["node_updates"] += 1
        elif "pods" in parts:
            i = parts.index("pods")
            name = "/".join([parts[i - 1], parts[i + 1]]) \
                if len(parts) > i + 1 else ""
            if method == "DELETE" and len(parts) == i + 2:
                out["pod_deletes"].append(name)
            elif method == "POST" and parts[-1] == "eviction":
                out["evictions"].append(name)
    return out


def upgrade(ops, stub, client, reader, kubelet, rec, node_name: str,
            namespace: str, router, cache) -> dict:
    """The rolling driver upgrade on the card's node, after the operator
    phase reached ``ready``, over its stub apiserver, kubelet thread and
    temp dirs.

    1. The policy sets ``driver.useDriverCRD`` and a ``GPUDriver`` selects
       the card's node: the policy's driver DaemonSet is swept, the CR's
       ``tpudriver`` DaemonSet renders (its library mount under a path of
       its own), the kubelet runs its driver agent, and the CR reads ready.
    2. ``upgradePolicy.autoUpgrade`` with a ``waitForCompletion``
       podSelector; a job pod on one card (the validator's ``torch``
       component) runs; the CR pins a version the card does not have.
    3. The node steps upgrade-required → cordon-required → wait-for-jobs
       (held while the job runs, passed once it succeeded) → pod deletion
       → drain (no card-holding pod left) → pod restart (the old driver pod
       deleted, the kubelet makes the next from the new template) →
       validation, where the new agent's NVML check fails; on the machine's
       shortened budget the node parks upgrade-failed, still cordoned.
    4. The CR pins NVML's own version and the node's label is reset to
       upgrade-required, as an admin would: the node reaches upgrade-done,
       uncordoned, its driver pod made from the current template.

    The driver and upgrade reconcilers read through the operator phase's
    informer ``cache``.  A pass of the three reconcilers (policy, driver,
    upgrade) is taken when the work queue has one of their keys due —
    marked by a watch event through ``router`` (the node's own transitions
    among them) or by a committed requeue.  Prints the stages' entry times
    and passes, the machine's writes and the job pod; returns the phase's
    kernel launches (the job pod's)."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.controllers import (TPUDriverReconciler,
                                                UpgradeReconciler, metrics)
    from tpu_operator_torch.obs import journal
    from tpu_operator_torch.upgrade import STATE_DONE, STATE_FAILED

    t_phase = time.perf_counter()
    journal.configure(enabled=True)
    drv = TPUDriverReconciler(client, namespace=namespace,
                              reader=cache.reader())
    up = UpgradeReconciler(client, namespace=namespace,
                           reader=cache.reader())
    up.machine.validation_timeout_s = UPGRADE_VALIDATION_BUDGET_S

    def node():
        n = reader.get("Node", node_name)
        return (n["metadata"]["labels"].get(consts.UPGRADE_STATE_LABEL, ""),
                bool(n.get("spec", {}).get("unschedulable")))

    def job_phase():
        pod = reader.get_or_none("Pod", UPGRADE_JOB["name"],
                                 UPGRADE_JOB["namespace"])
        return (pod or {}).get("status", {}).get("phase", "gone")

    def reconcile():
        # the node as the pass found it, then the three reconcilers
        return (node(), rec.reconcile(), drv.reconcile(UPGRADE_DRIVER_CR),
                up.reconcile())

    def row_of(result, sent) -> dict:
        before, pres, dres, ures = result
        state, cordoned = node()
        cr = reader.get("GPUDriver", UPGRADE_DRIVER_CR).get("status", {})
        return {"at": time.perf_counter() - t_phase,
                "from": before[0], "state": state, "cordoned": cordoned,
                "cordon_write": cordoned != before[1],
                "policy_ready": pres.ready, "driver_cr": cr.get("state"),
                "error": pres.error or ures.error,
                "driver_error": dres.error,
                "requeue_after": ures.requeue_after, "job": job_phase(),
                "writes": _upgrade_writes(sent)}

    driver_key = WatchRouter.DRIVER_KEY_PREFIX + UPGRADE_DRIVER_CR
    run = Passes(stub, kubelet, "upgrade_pass", reconcile, row_of, router,
                 ("policy", driver_key, "upgrade"),
                 lambda r: {"policy": r[1], driver_key: r[2],
                            "upgrade": r[3]})
    passes = run.rows

    def drive(label: str, done) -> dict:
        return run.drive(label, done, UPGRADE_DEADLINE_S)

    def stages() -> list:
        """The node's transitions in this cycle, from the journal."""
        return [{"to": e["condition"]["to"], "from": e["condition"]["from"],
                 "at": e["wall"] - wall0}
                for e in journal.entries("node", "", node_name)
                if e["category"] == "upgrade" and e.get("condition")]

    def update(kind, name, ns, edit):
        obj = reader.get(kind, name, ns)
        edit(obj)
        reader.update(obj)

    # 1. the driver CR takes over the node's driver
    wall0 = time.time()
    policy_ds = "gpu-driver-daemonset"
    update("GPUPolicy", "gpu-policy", "", lambda p: p["spec"].setdefault(
        "driver", {}).update(useDriverCrd=True))
    reader.create({"apiVersion": "gpu.operator.dev/v1alpha1",
                   "kind": "GPUDriver",
                   "metadata": {"name": UPGRADE_DRIVER_CR},
                   "spec": {"nodeSelector": {
                       "kubernetes.io/hostname": node_name},
                       "startupProbe": UPGRADE_STARTUP_PROBE}})
    row = drive("switch", lambda r: r["driver_cr"] == "ready"
                and r["policy_ready"])
    names = [d["metadata"]["name"]
             for d in reader.list("DaemonSet", namespace)]
    drivers = [n for n in names if n.startswith("gpu-driver-")]
    _require(policy_ds not in names and len(drivers) == 1
             and drivers[0].startswith(f"gpu-driver-{UPGRADE_DRIVER_CR}-"),
             f"driver DaemonSets after the switch: {names}")
    ds = reader.get("DaemonSet", drivers[0], namespace)
    pod_spec = ds["spec"]["template"]["spec"]
    mount = next(m for m in pod_spec["containers"][0]["volumeMounts"]
                 if m["name"] == "driver-install-dir")
    host_dir = next(v["hostPath"]["path"] for v in pod_spec["volumes"]
                    if v["name"] == "driver-install-dir")
    _require(mount == {"name": "driver-install-dir", "readOnly": True,
                       "mountPath": consts.DRIVER_INSTALL_MOUNT}
             and host_dir == "/usr/lib/x86_64-linux-gnu",
             f"the driver CR's library mount: {mount} of {host_dir}")
    switch = {"seconds": time.perf_counter() - t_phase,
              "passes": len(passes), "daemonset": drivers[0],
              "policy_daemonset_swept": policy_ds not in names}

    # 2. a job on the card, auto-upgrade on, a version no card has
    update("GPUPolicy", "gpu-policy", "", lambda p: p["spec"]["driver"]
           .update(upgradePolicy={
               "autoUpgrade": True, "maxParallelUpgrades": 1,
               "waitForCompletion": {"podSelector": "app=burn-in-job"}}))
    reader.create({"apiVersion": "v1", "kind": "Pod",
                   "metadata": {k: UPGRADE_JOB[k]
                                for k in ("name", "namespace", "labels")},
                   "spec": {"nodeName": node_name, "restartPolicy": "Never",
                            "containers": [{
                                "name": "burn-in", "command": POD_COMMAND,
                                "args": UPGRADE_JOB["args"],
                                "resources": {"limits": {
                                    consts.DEFAULT_RESOURCE_NAME: "1"}}}]}})
    t0 = time.perf_counter()
    while job_phase() != "Running":
        _require(time.perf_counter() - t0 < 30,
                 f"the job pod never ran: {job_phase()}")
        time.sleep(0.05)
    update("GPUDriver", UPGRADE_DRIVER_CR, "", lambda d: d["spec"].update(
        driverVersion=UPGRADE_WRONG_VERSION))

    # 3. the wrong pin: every stage, the job held, parked failed
    cycle = len(passes)
    wall0 = time.time()
    row = drive("wrong-pin", lambda r: r["state"] == STATE_FAILED)
    wrong = passes[cycle:]
    wrong_stages = stages()
    _require([s["to"] for s in wrong_stages] == [
        "upgrade-required", "cordon-required", "wait-for-jobs-required",
        "pod-deletion-required", "drain-required", "pod-restart-required",
        "validation-required", STATE_FAILED],
             f"the wrong pin's stages: {wrong_stages}")
    held = [r for r in wrong if r["from"] == r["state"]
            == "wait-for-jobs-required" and r["job"] == "Running"]
    left = next(r for r in wrong if r["from"] == "wait-for-jobs-required"
                and r["state"] != r["from"])
    _require(held and left["job"] in ("Succeeded", "gone"),
             f"wait-for-jobs held {len(held)} pass(es) on the running job"
             f" and let go with the job {left['job']}")
    job = next(p for p in kubelet.pods if p["name"] == UPGRADE_JOB["name"])
    _require(job["child"].returncode == 0
             and job["launches"]["matmul_bf16_f32"] > 0,
             f"the job pod: rc {job['child'].returncode}, launches "
             f"{job['launches']} {job['child'].stderr[-1500:]}")
    left_pods = [f"{p['metadata']['namespace']}/{p['metadata']['name']}"
                 for p in reader.list("Pod")
                 if p["metadata"].get("namespace") != namespace
                 and any(consts.DEFAULT_RESOURCE_NAME in c.get(
                     "resources", {}).get("limits", {})
                     for c in p["spec"].get("containers", []))]
    _require(not left_pods, f"card-holding pods left after the drain: "
                            f"{left_pods}")
    deletes = [d for r in wrong for d in r["writes"]["pod_deletes"]]
    _require(f"{UPGRADE_JOB['namespace']}/{UPGRADE_JOB['name']}" in deletes
             and f"{namespace}/{drivers[0]}-{node_name}" in deletes,
             f"the machine's pod deletions: {deletes}")
    failed_agent = next(r for r in kubelet.stopped + list(
        kubelet.runs.values()) if r.ds["metadata"]["name"] == drivers[0]
        and UPGRADE_WRONG_VERSION in " ".join(r.main[0].get("args", [])))
    with open(failed_agent.log_path(failed_agent.main[0])) as f:
        agent_log = f.read()
    _require(f"{UPGRADE_WRONG_VERSION} expected" in agent_log
             and "FAILED" in agent_log,
             f"the wrong pin's driver agent: {agent_log[-1500:]}")
    _require(row["cordoned"], "the failed node was uncordoned")
    gauges_failed = {name: getattr(metrics, name)._only().value
                     for name in metrics.UPGRADE_GAUGES}

    # 4. the right pin, the label reset as an admin would: done
    version = _nvml_driver_version()
    update("GPUDriver", UPGRADE_DRIVER_CR, "", lambda d: d["spec"].update(
        driverVersion=version))
    journal.forget("node", "", node_name)
    update("Node", node_name, "", lambda n: n["metadata"]["labels"].update(
        {consts.UPGRADE_STATE_LABEL: "upgrade-required"}))
    cycle = len(passes)
    wall0 = time.time()
    row = drive("right-pin", lambda r: r["state"] == STATE_DONE)
    right = passes[cycle:]
    right_stages = stages()
    _require([s["to"] for s in right_stages] == [
        "cordon-required", "wait-for-jobs-required", "pod-deletion-required",
        "drain-required", "pod-restart-required", "validation-required",
        "uncordon-required", STATE_DONE],
             f"the right pin's stages: {right_stages}")
    _require(not row["cordoned"], "the upgraded node stayed cordoned")
    ds = reader.get("DaemonSet", drivers[0], namespace)
    pod = reader.get("Pod", f"{drivers[0]}-{node_name}", namespace)
    want_hash = ds["metadata"]["annotations"][
        consts.LAST_APPLIED_HASH_ANNOTATION]
    _require(pod["metadata"]["labels"].get(consts.POD_TEMPLATE_HASH_LABEL)
             == want_hash and "deletionTimestamp" not in pod["metadata"],
             f"the driver pod after the upgrade: {pod['metadata']}")
    run = kubelet.runs[drivers[0]]
    barrier = Kubelet.map_path("/run/gpu/validations/.driver-ctr-ready",
                               run.mounts)
    with open(barrier) as f:
        _require(f"driver_version={version}" in f.read(),
                 f"the new driver agent's barrier at {barrier}")
    gauges = {name: getattr(metrics, name)._only().value
              for name in metrics.UPGRADE_GAUGES}
    _require(gauges["nodes_upgrades_done"] == 1
             and gauges["nodes_upgrades_failed"] == 0
             and gauges_failed["nodes_upgrades_failed"] == 1,
             f"upgrade gauges: failed {gauges_failed}, done {gauges}")
    journal.configure(enabled=False)

    def per_stage(rows):
        out = {}
        for r in rows:
            out[r["state"]] = out.get(r["state"], 0) + 1
        return out

    def writes(rows):
        return {"node_updates": sum(r["writes"]["node_updates"]
                                    for r in rows),
                "cordon_writes": sum(r["cordon_write"] for r in rows),
                "pod_deletes": [d for r in rows
                                for d in r["writes"]["pod_deletes"]],
                "evictions": [e for r in rows
                              for e in r["writes"]["evictions"]]}

    launches = {name: job["launches"].get(name, 0) + ops.LAUNCHES[name]
                for name in ops.LAUNCHES}
    print(json.dumps({"upgrade": {
        "switch": switch,
        "wrong_pin": {"version": UPGRADE_WRONG_VERSION,
                      "stages": wrong_stages,
                      "passes_by_stage": per_stage(wrong),
                      "held_passes_on_the_running_job": len(held),
                      "writes": writes(wrong),
                      "validation_budget_s": UPGRADE_VALIDATION_BUDGET_S,
                      "gauges": gauges_failed},
        "right_pin": {"version": version, "stages": right_stages,
                      "passes_by_stage": per_stage(right),
                      "writes": writes(right), "gauges": gauges},
        "job_pod": {"seconds": job["child_seconds"],
                    "stages": job["stages"], "launches": job["launches"]},
        "driver_pod_runs": sum(
            r.ds["metadata"]["name"] == drivers[0]
            for r in kubelet.stopped + list(kubelet.runs.values())),
        "pass_seconds": [r["seconds"] for r in passes],
        "passes": len(passes),
        "upgrade_seconds": time.perf_counter() - t_phase}}), flush=True)
    return launches


# --------------------------------------------------------------------------
# the remediation phase: a watchdog fault on the card's node repaired by
# the remediation controller, while the gang workload controller takes its
# gang off the node and back, over the operator phase's stub apiserver,
# kubelet thread, informer cache and work queue
# --------------------------------------------------------------------------

GANG = "burn-in-gang"
# the policy's remediation knobs for the phase (the JAX tests shorten them
# the same way): a short suspect grace, budgets far above the phase's
REMEDIATION_SPEC = {"suspectGraceSeconds": 2, "drainTimeoutSeconds": 120,
                    "revalidateTimeoutSeconds": 600, "maxRepairCycles": 2}
GANG_GRACE_S = 6
REMEDIATION_DEADLINE_S = 240.0


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def remediation(ops, stub, client, reader, kubelet, rec, node_name: str,
                namespace: str, router, cache, tmp: str) -> dict:
    """Remediation and a gang workload on the card's node, after the
    upgrade phase, over its stub apiserver, kubelet thread, informer cache
    and work queue.

    1. The policy's remediation knobs are shortened and a ``GPUWorkload``
       of one replica is created in the operator's namespace, its command
       ``python3 chip_smoke.py --gang-member`` (:func:`gang_member`) on a
       free coordinator port: placed on the card's node (its own slice),
       the kubelet thread runs the member on the plugin's allocation
       (``MASTER_ADDR`` resolved to 127.0.0.1), the member forms an NCCL
       group through ``env://`` and runs the hand-written matmul, and the
       gang reaches ``Running``.  A pass then writes nothing and LISTs no
       watched kind.
    2. The health watchdog, stepped by hand over the card's telemetry
       daemon with its device nodes behind symlinks that are then removed,
       writes ``gpu-degraded`` on the Node through its own client.
    3. Passes — policy, the remediation sweep and per-node machine, the
       workload discovery and per-gang keys, each taken when the work
       queue has a key due (``remediate/<node>`` and
       ``workload/<ns>/<name>`` made and retired as the JAX runner does) —
       step the node Suspect → Cordoned → Draining (the member evicted,
       its child killed, the gang Degraded) → Revalidating (the validator
       pod deleted); the gang is torn down and held with no pod while its
       node is cordoned; the kubelet reruns the validator's init chain on
       the card with no gang child alive.
    4. The symlinks restored, the watchdog clears the annotation after
       ``recover_after`` steps; the node goes Revalidating → Rejoining →
       uncordoned once the new validator pod is Ready.
    5. The gang is placed again only after the uncordon, reaches
       ``Running``, and ends ``Succeeded`` (told to stop through its stop
       file) with one reschedule.

    Prints the states' and the gang's timelines, the seconds out of
    service, writes and reads per pass, the fleet goodput and the gang's
    badput split; returns the phase's kernel launches (the gang members'
    and the revalidation's children's)."""
    from tpu_operator_torch import consts, nativelib
    from tpu_operator_torch.client.resilience import (
        resilient_incluster_client)
    from tpu_operator_torch.controllers import ReconcileResult
    from tpu_operator_torch.obs import journal
    from tpu_operator_torch.remediation import (RemediationReconciler,
                                                metrics, remediation_state)
    from tpu_operator_torch.validator import _build_metricsd, healthwatch
    from tpu_operator_torch.workload import TPUWorkloadReconciler

    t_phase = time.perf_counter()
    wall0 = time.time()
    journal.configure(enabled=True)
    rem = RemediationReconciler(client, namespace=namespace,
                                reader=cache.reader())
    gangs = TPUWorkloadReconciler(client, namespace=namespace,
                                  reader=cache.reader())
    queue, rem_prefix = router.queue, WatchRouter.REMEDIATION_KEY_PREFIX
    wl_prefix = WatchRouter.WORKLOAD_KEY_PREFIX
    validator = "gpu-operator-validator"
    first_gang = len(kubelet.gangs)

    def dynamic(prefix: str) -> list:
        return [k for k in queue.keys() if k.startswith(prefix)]

    def keys() -> tuple:
        return ("policy", "remediation", "workload", *dynamic(rem_prefix),
                *dynamic(wl_prefix))

    def reconcile():
        # the runner's keys in one pass: the policy, the sweep and the
        # node keys it keeps, the discovery and the per-CR keys it keeps
        # (a key made here is born due and runs in the next pass)
        before = remediation_state(reader.get("Node", node_name))
        results = {"policy": rec.reconcile(),
                   "remediation": ReconcileResult(requeue_after=30.0),
                   "workload": ReconcileResult(requeue_after=60.0)}
        node_keys = dynamic(rem_prefix)
        tracked = rem.sweep()
        for key in node_keys:
            if key[len(rem_prefix):] not in tracked:
                queue.remove_key(key)
        for name in sorted(tracked):
            queue.add_key(rem_prefix + name)
        for key in node_keys:
            if queue.has_key(key):
                results[key] = rem.reconcile_node(key[len(rem_prefix):])
        wl_keys = dynamic(wl_prefix)
        crs = cache.reader().list("GPUWorkload")
        gangs.observe_fleet(crs)
        coords = {f"{wl_prefix}{cr['metadata'].get('namespace', '')}/"
                  f"{cr['metadata']['name']}" for cr in crs}
        for key in wl_keys:
            if key not in coords:
                queue.remove_key(key)
                ns, _, name = key[len(wl_prefix):].partition("/")
                gangs.forget(name, ns)
        for key in sorted(coords):
            queue.add_key(key)
        for key in wl_keys:
            if queue.has_key(key):
                ns, _, name = key[len(wl_prefix):].partition("/")
                results[key] = gangs.reconcile(name, ns)
        return before, results

    def gang_status() -> dict:
        cr = reader.get_or_none("GPUWorkload", GANG, namespace) or {}
        return cr.get("status") or {}

    def gang_pods() -> list:
        return reader.list("Pod", namespace, label_selector={
            consts.WORKLOAD_NAME_LABEL: GANG})

    def row_of(result, sent) -> dict:
        before, results = result
        n = reader.get("Node", node_name)
        status = gang_status()
        pods = [f"{p['metadata']['name']}:"
                f"{p.get('status', {}).get('phase', '')}"
                + (":terminating" if "deletionTimestamp" in p["metadata"]
                   else "") for p in gang_pods()]
        errors = [f"{k}: {r.error}" for k, r in results.items() if r.error]
        failed = [(g.name, g.rc, g.lines[-20:]) for g in kubelet.gangs
                  if g.rc not in (None, 0) and g.deleted_at is None]
        _require(not failed, f"a gang member failed: {failed}")
        return {"at": time.perf_counter() - t_phase, "wall": time.time(),
                "keys": sorted(results), "from": before,
                "state": remediation_state(n),
                "cordoned": bool(n.get("spec", {}).get("unschedulable")),
                "annotated": consts.ICI_DEGRADED_ANNOTATION in n[
                    "metadata"].get("annotations", {}),
                "slice_ready": n["metadata"]["labels"].get(
                    consts.SLICE_READY_LABEL),
                "gang": status.get("phase", ""), "gang_pods": pods,
                "reschedules": status.get("reschedules", 0),
                "goodput": metrics.fleet_goodput_ratio._only().value,
                "error": "; ".join(errors) or None}

    run = Passes(stub, kubelet, "remediation_pass", reconcile, row_of,
                 router, keys, lambda r: r[1])
    passes = run.rows

    def drive(label: str, done) -> dict:
        return run.drive(label, done, REMEDIATION_DEADLINE_S)

    def update(kind, name, ns, edit):
        obj = reader.get(kind, name, ns)
        edit(obj)
        reader.update(obj)

    # 1. the gang on the card
    port = _free_port()
    stop_file = os.path.join(tmp, "gang-stop")
    _require(reader.get("Node", node_name)["metadata"]["labels"].get(
        consts.SLICE_READY_LABEL) == "true", "the card's slice is not ready")
    update("GPUPolicy", "gpu-policy", "", lambda p: p["spec"].update(
        remediation=dict(REMEDIATION_SPEC)))
    reader.create({"apiVersion": "gpu.operator.dev/v1alpha1",
                   "kind": "GPUWorkload",
                   "metadata": {"name": GANG, "namespace": namespace},
                   "spec": {"replicas": 1, "image": "chip-smoke",
                            "command": ["python3", "chip_smoke.py"],
                            "args": ["--gang-member"],
                            "env": [{"name": "GANG_STOP_FILE",
                                     "value": stop_file}],
                            "coordinatorPort": port,
                            "memberGraceSeconds": GANG_GRACE_S}})
    row = drive("place", lambda r: r["gang"] == "Running")
    t_running = time.time()
    (pod,) = gang_pods()
    env = {e["name"]: e["value"]
           for e in pod["spec"]["containers"][0].get("env", [])}
    want = {"MASTER_ADDR": f"{GANG}-0.{GANG}.{namespace}",
            "MASTER_PORT": str(port), "WORLD_SIZE": "1", "RANK": "0"}
    _require({k: env.get(k) for k in want} == want
             and not [k for k in env if k.startswith("JAX_")]
             and pod["spec"]["nodeName"] == node_name
             and pod["spec"]["containers"][0]["resources"]["limits"]
             .get(consts.DEFAULT_RESOURCE_NAME),
             f"the gang pod: {pod['spec']}")
    member = kubelet.gangs[first_gang]
    _require(member.ready_at is not None
             and member.launches.get("matmul_bf16_f32", 0) > 0,
             f"the gang member: {member.lines[-20:]}")
    placed = {"seconds": time.perf_counter() - t_phase,
              "passes": len(passes), "env": want,
              "member_ready_seconds": member.ready_at - member.seen_at}

    # a steady pass: no remediation, the gang Running
    row = run.one("steady")
    listed = sorted(set(row["reads"].get("list", {})) & set(INFORMER_KINDS))
    _require(row["gang"] == "Running" and row["state"] == ""
             and not row["operator_writes"] and not listed,
             f"the steady pass wrote {row['operator_writes']} or LISTed "
             f"watched kinds {listed}: {row}")
    steady = {"reads": row["reads"], "cache": row["cache"],
              "seconds": row["seconds"]}

    # 2. the fault: the watchdog over the card's daemon, nodes removed
    binary = str(_build_metricsd.build())
    minors = sorted(c["index"] for c in
                    nativelib.enumerate_chips("/dev", "/sys") or [])
    devs = os.path.join(tmp, "remediation-dev")
    os.makedirs(devs)

    def link_nodes() -> None:
        for m in minors:
            os.symlink(f"/dev/nvidia{m}", os.path.join(devs, f"nvidia{m}"))

    link_nodes()
    run_dir = Kubelet.map_path("/run/gpu", kubelet.runs[validator].mounts)
    daemon = Metricsd(binary, [f"--dev-root={devs}", f"--run-dir={run_dir}"],
                      os.path.join(tmp, "remediation-metricsd.err"))
    hw_client = resilient_incluster_client(api_server=stub.url,
                                           token="healthwatch")
    watch = healthwatch.HealthWatch(
        f"http://127.0.0.1:{daemon.port}/metrics",
        os.path.join(tmp, "remediation-healthwatch"),
        policy=healthwatch.HealthPolicy(degrade_after=2, recover_after=2),
        on_verdict=healthwatch.node_annotation_publisher(lambda: hw_client,
                                                         node_name))
    steps = []

    def step(phase: str) -> bool:
        verdict = watch.step()
        annotated = consts.ICI_DEGRADED_ANNOTATION in reader.get(
            "Node", node_name)["metadata"].get("annotations", {})
        steps.append({"phase": phase, "at": time.time() - wall0,
                      "verdict": verdict, "annotated": annotated})
        print(json.dumps({"remediation_watchdog": steps[-1]}), flush=True)
        return verdict

    try:
        _require(step("healthy") is False, "a healthy node degraded")
        for m in minors:
            os.remove(os.path.join(devs, f"nvidia{m}"))
        step("nodes-gone")
        _require(step("nodes-gone") is True and steps[-1]["annotated"],
                 f"the watchdog never annotated the node: {steps}")
        t_annotated = time.time()

        # 3. detect -> cordon -> drain -> revalidate
        old_validator = kubelet.runs[validator]
        row = drive("detect", lambda r: r["state"] == "cordoned")
        _require(row["cordoned"], f"cordoned but schedulable: {row}")
        node = reader.get("Node", node_name)
        _require(any(t.get("key") == consts.REMEDIATION_TAINT_KEY
                     for t in node["spec"].get("taints", [])),
                 f"the cordon set no taint: {node['spec']}")
        row = drive("drain", lambda r: r["state"] == "revalidating")
        _require(not gang_pods() and member.deleted_at is not None
                 and member.rc is not None,
                 f"the drain left the gang member: pods {gang_pods()}, "
                 f"deleted {member.deleted_at}, rc {member.rc}")
        t0 = time.perf_counter()
        while member.gone_at is None:       # the kubelet's watch lags
            _require(time.perf_counter() - t0 < 10,
                     "the kubelet never saw the gang pod go")
            time.sleep(0.02)
        evicted = [r for r in passes if r["operator_writes"].get(
            "evict", {}).get("Pod")]
        _require(evicted, "the drain evicted no pod")

        def chain_done() -> bool:
            new = kubelet.runs.get(validator)
            return (new is not None and new is not old_validator
                    and [r["container"] for r in new.records if r["rc"] == 0]
                    == [c["name"] for c in new.init])

        row = drive("revalidate", lambda r: chain_done()
                    and r["gang"] == "Pending" and not r["gang_pods"])
        _require(row["state"] == "revalidating" and row["cordoned"],
                 f"the node left revalidation early: {row}")
        chain = kubelet.runs[validator]
        chain_start = min(r["started"] for r in chain.records)
        chain_end = max(r["started"] + r["seconds"] for r in chain.records)
        alive = [(g.name, g.exited_at) for g in kubelet.gangs[first_gang:]
                 if g.exited_at is None or g.exited_at > chain_start]
        _require(not alive, f"a gang member held the card while the "
                            f"validator's chain ran: {alive}")
        held = [e for e in journal.entries("gpuworkload", namespace, GANG)
                if e["verdict"] == "hold"]
        _require(held and len(kubelet.gangs) == first_gang + 1,
                 f"the gang was not held off the cordoned node: {held}")

        # 4. the nodes back: the annotation clears, the node rejoins
        link_nodes()
        _require(step("nodes-back") is True, "recovered too early")
        _require(step("nodes-back") is False and not steps[-1]["annotated"],
                 f"the watchdog never cleared the annotation: {steps}")
        row = drive("rejoin", lambda r: r["state"] == ""
                    and not r["cordoned"])
        # 5. the gang back on the node, then told to stop
        row = drive("replace", lambda r: r["gang"] == "Running")
        second = kubelet.gangs[-1]
        _require(second is not member and second.ready_at is not None,
                 f"the gang was not run again: {kubelet.gangs}")
        with open(stop_file, "w"):  # noqa: TPULNT306 - the gang's stop file in the run's temp dir
            pass
        row = drive("complete", lambda r: r["gang"] == "Succeeded")
        _require(row["reschedules"] == 1 and second.rc == 0,
                 f"the gang ended {row}, its member rc {second.rc}")
    finally:
        daemon.close()
        hw_client.close()

    # the timelines, from the journal
    states = [{"from": e["condition"]["from"], "to": e["condition"]["to"],
               "event": e["inputs"].get("event"), "at": e["wall"] - wall0}
              for e in journal.entries("node", "", node_name)
              if e["category"] == "remediation"
              and e["verdict"] == "transition"]
    _require([s["to"] for s in states] == list(REMEDIATION_PATH),
             f"the node's remediation states: {states}")
    at = {s["to"]: s["at"] + wall0 for s in states}
    gang_line = [{"verdict": e["verdict"], "category": e["category"],
                  "reason": e["reason"], "at": e["wall"] - wall0,
                  "count": e["count"]}
                 for e in journal.entries("gpuworkload", namespace, GANG)
                 if e["category"] in ("placement", "lifecycle")]
    verdicts = [g["verdict"] for g in gang_line]
    _require(verdicts.index("degrade") < verdicts.index("teardown")
             < verdicts.index("hold"),
             f"the gang's timeline: {verdicts}")
    val_ready = [t for t, name, phase, ready in kubelet.ready_log
                 if name == f"{validator}-{node_name}" and ready
                 and t > t_annotated]
    _require(val_ready and min(val_ready) < at["rejoining"],
             f"the node rejoined at {at['rejoining']} before its new "
             f"validator pod was Ready ({val_ready})")
    _require(second.seen_at > at["healthy"],
             f"the gang was placed again at {second.seen_at}, before the "
             f"uncordon at {at['healthy']}")
    member_gone = member.gone_at
    second_running = next(r["wall"] for r in passes
                          if r["label"] == "replace" and r["gang"] == "Running")
    chain_records = [{k: r[k] for k in ("container", "attempt", "rc",
                                        "seconds", "stages")}
                     for r in chain.records]
    seconds = out_of_service(at, t_annotated, member.deleted_at, member_gone,
                             (chain_start, chain_end), second_running)

    def per_state(rows):
        out = {}
        for r in rows:
            out[r["from"] or "healthy"] = out.get(r["from"] or "healthy",
                                                  0) + 1
        return out

    runs = kubelet.gangs[first_gang:]
    launches = dict(ops.LAUNCHES)            # this process's: none
    for name, n in _gang_launches(runs, chain.records).items():
        launches[name] += n
    goodput = {"fleet_ratio_by_pass": [r["goodput"] for r in passes],
               "node_seconds": rem.goodput.node_seconds(node_name),
               "fleet_ratio": rem.fleet_ratio()}
    print(json.dumps({"remediation": {
        "placed": placed, "steady_pass": steady,
        "running_at": t_running - wall0,
        "watchdog": steps, "states": states,
        "passes_by_state": per_state(passes),
        "gang_timeline": gang_line,
        "gang_phase_by_pass": [(r["label"], r["gang"]) for r in passes],
        "out_of_service_seconds": seconds,
        "validator_rerun_children": chain_records,
        "writes_by_pass": [(r["label"], r["operator_writes"])
                           for r in passes],
        "reads_by_pass": [(r["label"], r["reads"]) for r in passes],
        "goodput": goodput,
        "badput_split": journal.badput_split(namespace, GANG),
        "gang_members": [{"pod": g.name, "rc": g.rc,
                          "ready_seconds": (g.ready_at or 0) - g.seen_at,
                          "alive_seconds": (g.exited_at or 0) - g.seen_at,
                          "launches": g.launches} for g in runs],
        "launches": launches,
        "passes": len(passes),
        "pass_seconds": [r["seconds"] for r in passes],
        "remediation_seconds": time.perf_counter() - t_phase}}),
        flush=True)
    journal.configure(enabled=False)
    _require(launches["matmul_bf16_f32"] > 0,
             f"the remediation leg launched {launches}")
    return launches


def snapshot_restart(stub, cache, namespace: str, tmp: str) -> dict:
    """The operator's restart at the end of the upgrade phase: the
    informer's snapshot saved into the phase's temp dir, then a second
    cache on a new client restored from it and started.  Its watches must
    resume from the snapshot's resourceVersions — no LIST of a restored
    kind reaches the stub — and its stores must come to equal the first
    cache's.  Prints and returns what it saw."""
    from tpu_operator_torch.client.resilience import (
        resilient_incluster_client)
    from tpu_operator_torch.informer import SharedInformerCache, snapshot

    def stores(c) -> dict:
        return {k: sorted(json.dumps(o, sort_keys=True) for o in c.list(k))
                for k in INFORMER_KINDS}

    t0 = time.perf_counter()
    directory = os.path.join(tmp, "snapshot")
    path = snapshot.SnapshotManager(cache, directory).save()
    _require(path is not None, "the informer's snapshot was not saved")
    save_seconds = time.perf_counter() - t0
    start = len(stub.request_log)
    client = resilient_incluster_client(api_server=stub.url,
                                        token="restarted")
    stop = threading.Event()
    try:
        t0 = time.perf_counter()
        second = SharedInformerCache(
            client, kinds=INFORMER_KINDS,
            namespaces={k: namespace for k in INFORMER_NAMESPACED})
        restored = snapshot.SnapshotManager(second, directory).restore()
        second.start(stop=stop)
        while set(_reads(stub.request_log[start:], "restarted").get(
                "watch", {})) < set(INFORMER_KINDS):
            _require(time.perf_counter() - t0 < 30,
                     "the restored cache's watches never opened")
            time.sleep(0.02)
        watching_seconds = time.perf_counter() - t0
        while stores(second) != stores(cache):
            _require(time.perf_counter() - t0 < 30,
                     "the restored cache never came to equal the first")
            time.sleep(0.05)
        equal_seconds = time.perf_counter() - t0
        reads = _reads(stub.request_log[start:], "restarted")
        relists = dict(second.relist_count)
    finally:
        stop.set()
        client.close()
    lists = {k: n for k, n in reads.get("list", {}).items()
             if k in INFORMER_KINDS}
    out = {"snapshot_bytes": os.path.getsize(path),
           "save_seconds": save_seconds, "restored_kinds": sorted(restored),
           "reads": reads, "restart_lists": sum(lists.values()),
           "relists": relists, "watching_seconds": watching_seconds,
           "equal_stores_seconds": equal_seconds,
           "objects": {k: len(cache.list(k)) for k in INFORMER_KINDS}}
    print(json.dumps({"informer_restart": out}), flush=True)
    _require(sorted(restored) == sorted(INFORMER_KINDS),
             f"restored kinds {restored}")
    _require(not lists and not any(relists.values()),
             f"the restart LISTed restored kinds {lists}, relists {relists}")
    return out


# --------------------------------------------------------------------------
# the packaging phase: the port's deploy trees (``tpu_operator_torch/
# deploy/``) as its drift gates and config validator check them, and the
# argv its manifests give the operator and the chart's hooks
# --------------------------------------------------------------------------

PACKAGING_TARGET_S = 10.0


def deploy_tree() -> str:
    """The port's deploy tree: the chart, the kustomize and OLM trees."""
    import tpu_operator_torch

    return os.path.join(os.path.dirname(tpu_operator_torch.__file__),
                        "deploy")


def _yaml(path: str):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def manifest_argv(command: list, args: list, where: str) -> list:
    """A manifest's ``python -m <module>`` command and args as this
    interpreter runs them (the image's ``python``), once ``<module>`` is
    a module of ``tpu_operator_torch`` that exists (a package: with its
    ``__main__``).  A manifest that names another package fails here."""
    import importlib.util

    _require(command[:2] == ["python", "-m"] and len(command) == 3,
             f"{where}: the command {command} is no `python -m <module>`")
    module = command[2]
    _require(module.split(".")[0] == "tpu_operator_torch",
             f"{where} runs {module}, not a module of tpu_operator_torch")
    spec = importlib.util.find_spec(module)
    _require(spec is not None, f"{where}: no module {module}")
    if spec.submodule_search_locations is not None:
        _require(importlib.util.find_spec(module + ".__main__") is not None,
                 f"{where}: the package {module} has no __main__")
    return [sys.executable, "-m", module, *args]


def hook_argv(template: str) -> list:
    """A chart hook's container argv: the one literal ``command: [...]``
    and ``args: [...]`` line of the template, read as YAML (no template
    expression may be in them: the chart is never rendered here, which
    would need helm), as :func:`manifest_argv` runs them."""
    import yaml

    with open(template) as f:
        text = f.read()
    where = os.path.basename(template)
    lines = {}
    for key in ("command", "args"):
        found = re.findall(rf"^\s*{key}: (\[.*\])\s*$", text, re.M)
        _require(len(found) == 1 and "{{" not in found[0],
                 f"{where}: its {key} lines {found}")
        lines[key] = yaml.safe_load(found[0])
    return manifest_argv(lines["command"], lines["args"], where)


def manager_container() -> dict:
    """The operator's container of the kustomize/OLM Deployment
    (``deploy/config/manager/manager.yaml``)."""
    where = "config/manager/manager.yaml"
    dep = _yaml(os.path.join(deploy_tree(), where))
    containers = dep["spec"]["template"]["spec"]["containers"]
    _require(dep["kind"] == "Deployment" and len(containers) == 1,
             f"{where}: {dep['kind']} with {len(containers)} containers")
    return containers[0]


def container_env(container: dict, namespace: str) -> dict:
    """A container's env as the kubelet sets it: each value, and the
    pod's namespace for a ``fieldRef`` to ``metadata.namespace`` (the
    only reference the operator's Deployment makes)."""
    out = {}
    for e in container.get("env", []):
        if "value" in e:
            out[e["name"]] = str(e["value"])
            continue
        ref = e.get("valueFrom", {}).get("fieldRef", {}).get("fieldPath")
        _require(ref == "metadata.namespace",
                 f"the env {e['name']} reads {e.get('valueFrom')}")
        out[e["name"]] = namespace
    return out


def run_hook(argv: list, api_server: str, token: str,
             timeout_s: float = 120.0) -> tuple:
    """A hook's argv with the one flag a stub needs (``--api-server``, the
    token in ``GPU_OPERATOR_TOKEN``): ``(rc, output, seconds)``."""
    t0 = time.perf_counter()
    done = subprocess.run(argv + [f"--api-server={api_server}"], cwd=HERE,
                          env=dict(os.environ, GPU_OPERATOR_TOKEN=token),
                          capture_output=True, text=True, timeout=timeout_s)
    return done.returncode, done.stdout + done.stderr, \
        time.perf_counter() - t0


def packaging(ops) -> dict:
    """The port's packaging as its CI checks it, in children started
    together: ``gen_crds --check`` on the chart's and the kustomize
    tree's CRDs, ``gen_csv --check``, and ``gpuop_cfg validate`` on the
    CSV, the three samples and the chart's ``values.yaml`` policy block;
    any non-zero exit fails the run.  Then the argv the manifests give
    the operator (``manager.yaml``; the chart's Deployment runs the same
    command) and the chart's CRD and cleanup hooks must run modules of the
    port that exist.  ``helm`` and ``kubectl`` are probed (``null`` where
    missing): the chart is never rendered without helm.  Prints each
    step's seconds; returns the leg's launch counts (none)."""
    import yaml

    ops.reset_launches()
    t_phase = time.perf_counter()
    dep = deploy_tree()
    chart, config = os.path.join(dep, "chart"), os.path.join(dep, "config")
    csv = os.path.join(dep, "bundle", "manifests",
                       "gpu-operator.clusterserviceversion.yaml")
    samples = os.path.join(config, "samples")
    tmp = tempfile.mkdtemp(prefix="packaging")
    try:
        values = _yaml(os.path.join(chart, "values.yaml"))
        spec = {k: v for k, v in values["gpupolicy"].items()
                if k != "create"}
        policy = os.path.join(tmp, "values-gpupolicy.yaml")
        with open(policy, "w") as f:  # noqa: TPULNT306 - a values file in the run's temp dir
            yaml.safe_dump({"apiVersion": "gpu.operator.dev/v1",
                            "kind": "GPUPolicy",
                            "metadata": {"name": "gpu-policy"},
                            "spec": spec}, f)
        cfg = ("tpu_operator_torch.cmd.gpuop_cfg", "validate")
        steps = {
            "gen_crds --check chart/crds": (
                "tpu_operator_torch.cmd.gen_crds", "--check", "--out-dir",
                os.path.join(chart, "crds")),
            "gen_crds --check config/crd/bases": (
                "tpu_operator_torch.cmd.gen_crds", "--check", "--out-dir",
                os.path.join(config, "crd", "bases")),
            "gen_csv --check": ("tpu_operator_torch.cmd.gen_csv",
                                "--check"),
            "gpuop_cfg csv": cfg + ("csv", "--input", csv),
            "gpuop_cfg samples/v1_gpupolicy.yaml": cfg + (
                "gpupolicy", "--input",
                os.path.join(samples, "v1_gpupolicy.yaml")),
            "gpuop_cfg samples/v1alpha1_gpudriver.yaml": cfg + (
                "gpudriver", "--input",
                os.path.join(samples, "v1alpha1_gpudriver.yaml")),
            "gpuop_cfg samples/v1alpha1_gpuworkload.yaml": cfg + (
                "gpuworkload", "--input",
                os.path.join(samples, "v1alpha1_gpuworkload.yaml")),
            "gpuop_cfg chart values.yaml gpupolicy": cfg + (
                "gpupolicy", "--input", policy),
        }
        t0 = time.perf_counter()
        procs, seconds, rcs, output = {}, {}, {}, {}
        try:
            for name, argv in steps.items():
                with open(os.path.join(tmp, f"step-{len(procs)}.log"),  # noqa: TPULNT306 - temp dir
                          "wb") as log:
                    procs[name] = (subprocess.Popen(
                        [sys.executable, "-m", *argv], cwd=HERE, stdout=log,
                        stderr=subprocess.STDOUT), log.name)
            while len(rcs) < len(procs):
                _require(time.perf_counter() - t0 < 60.0,
                         f"packaging steps still running: "
                         f"{sorted(set(procs) - set(rcs))}")
                for name, (proc, log) in procs.items():
                    if name not in rcs and proc.poll() is not None:
                        seconds[name] = time.perf_counter() - t0
                        rcs[name] = proc.returncode
                        with open(log, errors="replace") as f:
                            output[name] = f.read()
                time.sleep(0.005)
        finally:
            for proc, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"packaging_steps": {
        name: {"rc": rcs[name], "seconds": seconds[name],
               "output": output[name].strip()[-300:]}
        for name in steps}}), flush=True)
    failed = {name: output[name] for name, rc in rcs.items() if rc != 0}
    _require(not failed, f"packaging steps failed: {failed}")

    container = manager_container()
    argvs = {
        "config/manager/manager.yaml": manifest_argv(
            container["command"], container.get("args", []),
            "manager.yaml"),
        "chart/templates/upgrade_crd.yaml": hook_argv(os.path.join(
            chart, "templates", "upgrade_crd.yaml")),
        "chart/templates/cleanup_crd.yaml": hook_argv(os.path.join(
            chart, "templates", "cleanup_crd.yaml")),
    }
    with open(os.path.join(chart, "templates", "deployment.yaml")) as f:
        deployment = f.read()
    _require(f"command: {json.dumps(container['command'])}" in deployment,
             "the chart's Deployment runs another command than "
             "manager.yaml's")
    out = {"seconds": time.perf_counter() - t_phase, "steps_wall_s": wall_s,
           "argv": {where: argv[1:] for where, argv in argvs.items()},
           "helm": shutil.which("helm"), "kubectl": shutil.which("kubectl")}
    print(json.dumps({"packaging": out}), flush=True)
    _require(out["seconds"] < PACKAGING_TARGET_S,
             f"the packaging phase took {out['seconds']} s")
    return dict(ops.LAUNCHES)


# --------------------------------------------------------------------------
# the lint leg: the port's own tpulint gate on this machine's interpreter
# --------------------------------------------------------------------------

LINT_TARGET_S = 60.0
INVENTORY = os.path.join("tpu_operator_torch", "ASYNC_INVENTORY.md")


def lint(ops) -> dict:
    """The port's lint gate as its CI runs it, in two children started
    together on this interpreter: ``python -m tpu_operator_torch.analysis
    --format json`` over the checkout (the port's package and this
    script), and its ``--inventory -``, which must equal the committed
    inventory byte for byte.  Prints the files scanned, the parses, the
    findings by rule, the reconcile hot path's module count and blocking
    rows, and the children's seconds.  Any finding, a stale baseline
    entry, a blocking row on the hot path or a drifted inventory fails the
    run.  Returns the leg's launch counts (none)."""
    ops.reset_launches()
    base = [sys.executable, "-m", "tpu_operator_torch.analysis"]
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(base + argv, cwd=HERE, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
             for name, argv in (("gate", ["--format", "json"]),
                                ("inventory", ["--inventory", "-"]))}
    out, seconds = {}, {}
    try:
        for name, proc in procs.items():
            out[name] = proc.communicate(
                timeout=max(1.0, LINT_TARGET_S - (time.perf_counter() - t0)))
            seconds[name] = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    (gate, gate_err), (inventory, inv_err) = out["gate"], out["inventory"]
    _require(procs["inventory"].returncode == 0,
             f"tpulint --inventory exited {procs['inventory'].returncode}: "
             f"{inv_err.strip()[-500:]}")
    report = json.loads(gate)
    by_rule: dict = {}
    for f in report["findings"]:
        by_rule[f["rule"]] = by_rule.get(f["rule"], 0) + 1
    head = re.search(r"import-reachable from `([\w.]+)`\): (\d+);",
                     inventory)
    block = re.search(r"<!-- tpulint:inventory -->\s*```json\n(.*?)\n```",
                      inventory, re.S)
    _require(head is not None and block is not None,
             f"tpulint printed no inventory: {inventory[:300]!r}")
    rows = json.loads(block[1])
    with open(os.path.join(HERE, INVENTORY)) as f:
        drifted = f.read() != inventory
    result = {"files": report["stats"]["files"],
              "parses": report["stats"]["parse_count"],
              "findings_by_rule": by_rule,
              "stale_baseline": len(report["stale_baseline"]),
              "entry": head[1], "hot_path_modules": int(head[2]),
              "blocking_rows": len(rows["calls"]),
              "exempt_rows": len(rows["exempt"]),
              "inventory_drifted": drifted,
              "seconds": seconds["gate"],
              "inventory_seconds": seconds["inventory"],
              "engine_wall_s": report["stats"]["wall_s"]}
    print(json.dumps({"lint": result}), flush=True)
    _require(procs["gate"].returncode == 0 and not report["findings"]
             and not report["stale_baseline"],
             f"tpulint failed (rc {procs['gate'].returncode}): "
             + "; ".join(f"{f['path']}:{f['line']}: {f['rule']} "
                         f"{f['message']}" for f in report["findings"])
             + f" {gate_err.strip()[-300:]}")
    _require(result["parses"] == result["files"] > 0,
             f"tpulint parsed {result['parses']} of {result['files']} files")
    _require(result["blocking_rows"] == 0,
             f"blocking calls on the reconcile hot path: {rows['calls']}")
    _require(not drifted, f"{INVENTORY} drifted from the tree")
    return dict(ops.LAUNCHES)


# --------------------------------------------------------------------------
# the runner phase: the operator process as its Deployment runs it,
# ``python -m tpu_operator_torch`` against a stub apiserver of its own
# --------------------------------------------------------------------------

RUNNER_TOKENS = ("runner-1", "runner-2", "runner-standby")
RUNNER_READY_S = 300.0
RUNNER_STEADY_S = 5.0
RUNNER_STOP_S = 15.0
# the runner's serve-stale budget (``--degraded-budget``, 30 s by default)
# and how long the outage may take to show it
RUNNER_DEGRADED_BUDGET_S = 5.0
RUNNER_OUTAGE_DEADLINE_S = 90.0
# the standby's window beside the leader: longer than one Lease poll
# (``LEASE_DURATION_S / 3``), and the Lease's duration, within which the
# standby must take it once the leader is gone
RUNNER_STANDBY_S = 7.0
RUNNER_TAKEOVER_S = 15.0
# the runner's ceiling for ``?n=`` on ``/debug/traces`` and
# ``/debug/explain``: every trace and journal entry it holds
DEBUG_N = 10_000
# the families ``controllers/metrics.py`` adds for the runner, the worker
# pools' and the process families: each must be on ``/metrics`` once
RUNNER_FAMILIES = (
    "gpu_operator_build_info", "gpu_operator_uptime_seconds",
    "gpu_operator_reconcile_duration_seconds",
    "gpu_operator_convergence_latency_seconds",
    "gpu_operator_readiness_triggers_armed_total",
    "gpu_operator_readiness_triggers_fired_total",
    "gpu_operator_span_cpu_seconds_total",
    "gpu_operator_span_wall_seconds_total",
    "gpu_operator_slo_burn_rate", "gpu_operator_slo_budget_remaining",
    "gpu_operator_slo_burning", "gpu_operator_tsdb_samples_total",
    "gpu_operator_tsdb_dropped_samples_total", "gpu_operator_tsdb_series",
    "gpu_operator_reconciliation_status",
    "gpu_operator_worker_pool_size", "gpu_operator_worker_pool_inflight",
    "gpu_operator_worker_pool_tasks_total",
    "gpu_operator_worker_pool_busy_seconds_total",
    "gpu_operator_worker_pool_cpu_seconds_total",
    "process_cpu_seconds_total", "process_resident_memory_bytes",
    "process_start_time_seconds", "process_open_fds", "python_info",
    "python_gc_collections_total")


class RunnerProcess:
    """The operator's container as the packaged Deployment runs it: the
    command, args and env of ``deploy/config/manager/manager.yaml``'s
    container (``container``; the namespace for its ``fieldRef``), and
    only what a stub needs besides: ``--api-server`` and the token
    (``GPU_OPERATOR_TOKEN``), ``--snapshot-dir``,
    ``--snapshot-interval=1``, ``--debug-endpoints``,
    ``--degraded-budget`` shortened to :data:`RUNNER_DEGRADED_BUDGET_S`
    (the ``runner_serve_stale`` leg's outage outlasts it), the health and
    metrics ports on free ones (after the manifest's, so they win), and
    the pod name (``HOSTNAME``, the Lease's holder); its output in
    ``log``."""

    def __init__(self, container: dict, namespace: str, api_server: str,
                 token: str, snapshot_dir: str, log: str, cwd: str = HERE):
        self.token, self.log = token, log
        self.health_port, self.metrics_port = _free_port(), _free_port()
        self.identity = f"gpu-operator-{token}"
        self.argv = manifest_argv(container["command"],
                                  container.get("args", []),
                                  "manager.yaml") + [
            f"--api-server={api_server}", f"--snapshot-dir={snapshot_dir}",
            "--snapshot-interval=1", "--debug-endpoints",
            f"--degraded-budget={RUNNER_DEGRADED_BUDGET_S:g}",
            f"--metrics-port={self.metrics_port}",
            f"--health-port={self.health_port}"]
        self.env = container_env(container, namespace)
        env = dict(os.environ, **self.env, GPU_OPERATOR_TOKEN=token,
                   HOSTNAME=self.identity)
        with open(log, "wb") as out:  # noqa: TPULNT306 - the runner's log in the run's temp dir
            self.proc = subprocess.Popen(
                self.argv, cwd=cwd, env=env, stdout=out,
                stderr=subprocess.STDOUT)
        self.started = time.perf_counter()

    def get(self, path: str, metrics: bool = False) -> tuple:
        """``(status, body)`` of one GET on the health (or metrics) port;
        ``(None, "")`` while nothing answers."""
        port = self.metrics_port if metrics else self.health_port
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=5) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, ""
        except OSError:
            return None, ""

    def json(self, path: str):
        status, body = self.get(path)
        _require(status == 200, f"{self.token} {path}: {status}")
        return json.loads(body)

    def alive(self) -> None:
        _require(self.proc.poll() is None,
                 f"the runner {self.token} exited {self.proc.returncode}: "
                 f"{self.tail()}")

    def tail(self) -> str:
        with open(self.log, errors="replace") as f:
            return f.read()[-2000:]

    def stop(self, timeout_s: float = RUNNER_STOP_S) -> tuple:
        """SIGTERM, then the exit code and the seconds to it (None, and
        the process killed, past ``timeout_s``)."""
        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.close()
            return None, time.perf_counter() - t0
        return rc, time.perf_counter() - t0

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def runner_metrics(body: str) -> dict:
    """A runner's ``/metrics`` page read by the port's parser: every family
    of :data:`RUNNER_FAMILIES` there (the parser refuses a family declared
    twice) and the policy's ``reconciliation_status`` at 1.  Returns the
    page's family count and the reconcile passes by controller and
    outcome."""
    from tpu_operator_torch.exposition import parse

    families = parse(body)
    missing = [f for f in RUNNER_FAMILIES if f not in families]
    _require(not missing, f"/metrics lacks {missing}")
    status = families["gpu_operator_reconciliation_status"].samples
    _require([v for _, _, v in status] == [1.0],
             f"reconciliation_status {status}")
    return {"families": len(families),
            "passes_by_controller": reconcile_passes(families)}


def reconcile_passes(families: dict) -> dict:
    """The reconcile passes a runner's parsed ``/metrics`` page counts, by
    controller and outcome (``gpu_operator_reconcile_duration_seconds``;
    none where the family has no sample)."""
    passes = {}
    family = families.get("gpu_operator_reconcile_duration_seconds")
    for name, labels, value in family.samples if family else []:
        if name.endswith("_count"):
            labels = dict(labels)
            passes[f"{labels['controller']}/{labels['outcome']}"] = value
    return passes


def runner_passes_by_key(traces: dict, since: float = 0.0) -> dict:
    """Reconcile passes per work-queue key among a ``/debug/traces``
    payload's recent traces (each pass's root span carries its key), of
    the traces that began at wall time ``since`` or later."""
    out = {}
    for trace in traces.get("recent", []):
        if trace.get("ts", 0.0) < since:
            continue
        for span in trace["spans"]:
            if not span["parent_id"] and trace["name"].startswith(
                    "reconcile."):
                key = span["attrs"].get("key", trace["name"])
                out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))


def failover_entries(proc: RunnerProcess, namespace: str) -> list:
    """The ``failover`` entries the runner journaled under ``("operator",
    namespace, "leader")``, read through ``/debug/explain``."""
    payload = proc.json(f"/debug/explain/operator/{namespace}/leader")
    return [e for e in payload["entries"] if e["category"] == "failover"]


def backfilled_events(reader, log: list, token: str, node: str,
                      entries: list) -> list:
    """The Events about ``node`` whose reason and message are a journal
    entry's emit reason and reason, where the stub's log shows ``token``
    writing Events."""
    wrote = _token_writes(log, token)
    if not any(kind == "Event" for verb in wrote.values() for kind in verb):
        return []
    reasons = {e["reason"] for e in entries}
    return [{"reason": e.get("reason"), "message": e.get("message"),
             "count": e.get("count", 1)}
            for e in reader.list("Event")
            if e.get("involvedObject", {}).get("name") == node
            and e.get("reason") == "DriverUpgradeStage"
            and e.get("message") in reasons]


# --------------------------------------------------------------------------
# the runner's legs between its /metrics and its handoff: the process as
# the only reconciler through a remediation with a gang, an apiserver
# outage and a standby beside it (:data:`RUNNER_LEGS`)
# --------------------------------------------------------------------------

# a node's remediation states, in the order one repair takes them
REMEDIATION_PATH = ("suspect", "cordoned", "draining", "revalidating",
                    "rejoining", "healthy")


def remediation_states(entries: list) -> list:
    """A node's remediation transitions among journal entries (the
    in-process journal's, or a runner's ``/debug/explain`` payload's),
    oldest first: ``from``, ``to``, the event and the wall time."""
    return [{"from": e["condition"]["from"], "to": e["condition"]["to"],
             "event": e["inputs"].get("event"), "wall": e["wall"]}
            for e in sorted(entries, key=lambda e: e["wall"])
            if e["category"] == "remediation"
            and e["verdict"] == "transition"]


def out_of_service(at: dict, annotated: float, evicted: float, gone: float,
                   chain: tuple, running_again: float) -> dict:
    """The seconds a remediation kept the node and the gang's job out of
    service, from wall times: ``at`` each state of
    :data:`REMEDIATION_PATH` entered, the watchdog's annotation, the gang
    member evicted and its pod gone, the validator chain's rerun
    (``(start, end)``) and the gang ``Running`` again."""
    chain_start, chain_end = chain
    return {
        "annotation_to_cordon": at["cordoned"] - annotated,
        "cordon_to_gang_pod_gone": gone - at["cordoned"],
        "revalidating_to_chain_start": chain_start - at["revalidating"],
        "validator_rerun": chain_end - at["revalidating"],
        "validator_chain_seconds": chain_end - chain_start,
        "cordon_to_uncordon": at["healthy"] - at["cordoned"],
        "uncordon_to_gang_running": running_again - at["healthy"],
        "node_out_of_service": at["healthy"] - at["cordoned"],
        "job_out_of_service": running_again - evicted,
        "annotation_to_gang_running": running_again - annotated}


def standby_writes(log: list, token: str) -> tuple:
    """``(Lease writes, other writes)`` of the client that sent ``token``
    among the stub's ``request_log``: its Lease attempts by verb, and
    every other write by verb and kind."""
    lease, other = {}, {}
    for verb, kinds in _token_writes(log, token).items():
        for kind, n in kinds.items():
            if kind == "Lease":
                lease[verb] = n
            else:
                other.setdefault(verb, {})[kind] = n
    return lease, other


def degraded_journal(payload: dict) -> dict:
    """A ``/debug/explain/operator/<ns>/degraded`` payload's entries by
    verdict (``serving-stale``, ``parked``, ``recovered``): each verdict's
    wall times, oldest first, and the keys parked."""
    entries = payload.get("entries", [])
    walls = {}
    for e in entries:
        walls.setdefault(e["verdict"], []).append(e["wall"])
    return {"walls": {v: sorted(w) for v, w in sorted(walls.items())},
            "parked_keys": sorted(e["inputs"].get("key", "")
                                  for e in entries
                                  if e["verdict"] == "parked")}


def _gang_launches(runs: list, records: list) -> dict:
    """The kernel launches of gang member runs and validator children."""
    out = {}
    for counts in [g.launches for g in runs] + [r["launches"]
                                                for r in records]:
        for name, n in (counts or {}).items():
            out[name] = out.get(name, 0) + n
    return out


def runner_remediation(leg) -> dict:
    """The ``remediation`` phase's scenario with the runner process
    (``leg.leader``) as the only reconciler: the policy's remediation knobs
    shortened (:data:`REMEDIATION_SPEC`) and a one-replica ``GPUWorkload``
    in the operator's namespace running ``python3 chip_smoke.py
    --gang-member``, placed by the runner and run by the kubelet thread on
    the card (NCCL over ``env://``, the hand-written matmul); a steady
    window with the gang ``Running`` in which the runner writes nothing
    but its Lease renewals and LISTs no watched kind; the health watchdog
    stepped by hand over the card's daemon with its device nodes behind
    removed symlinks writes ``gpu-degraded``; the runner takes the node
    Suspect → Cordoned → Draining (the member evicted and its child
    reaped before the chain reruns) → Revalidating → Rejoining, uncordons
    only after the new validator pod is Ready, and places the gang again
    only after the uncordon; the gang ends ``Succeeded`` with one
    reschedule.  The timelines come from the runner's journal through
    ``/debug/explain``.  Prints the seconds out of service, the passes per
    key (``/debug/traces``), the runner's writes and reads by verb and kind
    and the leg's launches; returns the launches and the validator records
    the leg counted."""
    from tpu_operator_torch import consts, nativelib
    from tpu_operator_torch.client.resilience import (
        resilient_incluster_client)
    from tpu_operator_torch.remediation import remediation_state
    from tpu_operator_torch.validator import _build_metricsd, healthwatch

    t_leg, wall0 = time.perf_counter(), time.time()
    stub, reader, kubelet, proc = leg.stub, leg.reader, leg.kubelet, leg.leader
    node_name, namespace, tmp = leg.node_name, leg.namespace, leg.tmp
    validator = "gpu-operator-validator"
    log0 = len(stub.request_log)
    first_gang = len(kubelet.gangs)

    def node() -> dict:
        return reader.get("Node", node_name)

    def gang_phase() -> str:
        cr = reader.get_or_none("GPUWorkload", GANG, namespace) or {}
        return (cr.get("status") or {}).get("phase", "")

    def gang_pods() -> list:
        return reader.list("Pod", namespace, label_selector={
            consts.WORKLOAD_NAME_LABEL: GANG})

    def wait(what: str, done) -> float:
        def step() -> bool:
            failed = [(g.name, g.rc, g.lines[-20:]) for g in kubelet.gangs
                      if g.rc not in (None, 0) and g.deleted_at is None]
            _require(not failed, f"a gang member failed: {failed}")
            return done()
        return leg.wait(what, step, proc, REMEDIATION_DEADLINE_S)

    def explain(kind: str, ns: str, name: str) -> list:
        return proc.json(f"/debug/explain/{kind}/{ns or '-'}/{name}"
                         f"?n={DEBUG_N}")["entries"]

    # 1. the gang on the card, placed by the runner
    port = _free_port()
    stop_file = os.path.join(tmp, "runner-gang-stop")
    policy = reader.get("GPUPolicy", "gpu-policy")
    policy["spec"]["remediation"] = dict(REMEDIATION_SPEC)
    leg.admin.update(policy)
    leg.admin.create({"apiVersion": "gpu.operator.dev/v1alpha1",
                      "kind": "GPUWorkload",
                      "metadata": {"name": GANG, "namespace": namespace},
                      "spec": {"replicas": 1, "image": "chip-smoke",
                               "command": ["python3", "chip_smoke.py"],
                               "args": ["--gang-member"],
                               "env": [{"name": "GANG_STOP_FILE",
                                        "value": stop_file}],
                               "coordinatorPort": port,
                               "memberGraceSeconds": GANG_GRACE_S}})
    place_s = wait("the gang Running", lambda: gang_phase() == "Running")
    (pod,) = gang_pods()
    env = {e["name"]: e["value"]
           for e in pod["spec"]["containers"][0].get("env", [])}
    want = {"MASTER_ADDR": f"{GANG}-0.{GANG}.{namespace}",
            "MASTER_PORT": str(port), "WORLD_SIZE": "1", "RANK": "0"}
    _require({k: env.get(k) for k in want} == want
             and not [k for k in env if k.startswith("JAX_")]
             and pod["spec"]["nodeName"] == node_name,
             f"the gang pod: {pod['spec']}")
    member = kubelet.gangs[first_gang]
    wait("the gang member Ready", lambda: member.ready_at is not None)
    _require(member.launches.get("matmul_bf16_f32", 0) > 0,
             f"the gang member: {member.lines[-20:]}")

    # a steady window with the gang Running: Lease renewals, no LIST
    steady0 = len(stub.request_log)
    time.sleep(RUNNER_STEADY_S)
    steady = stub.request_log[steady0:]
    renewals, writes = standby_writes(steady, proc.token)
    lists = sorted(set(_reads(steady, proc.token).get("list", {}))
                   & set(INFORMER_KINDS))
    _require(not writes and not lists and gang_phase() == "Running",
             f"the steady window with the gang Running wrote {writes}, "
             f"LISTed {lists}")

    # 2. the fault: the watchdog over the card's daemon, nodes removed
    binary = str(_build_metricsd.build())
    minors = sorted(c["index"] for c in
                    nativelib.enumerate_chips("/dev", "/sys") or [])
    devs = os.path.join(tmp, "runner-remediation-dev")
    os.makedirs(devs)

    def link_nodes() -> None:
        for m in minors:
            os.symlink(f"/dev/nvidia{m}", os.path.join(devs, f"nvidia{m}"))

    link_nodes()
    run_dir = Kubelet.map_path("/run/gpu", kubelet.runs[validator].mounts)
    daemon = Metricsd(binary, [f"--dev-root={devs}", f"--run-dir={run_dir}"],
                      os.path.join(tmp, "runner-metricsd.err"))
    hw_client = resilient_incluster_client(api_server=stub.url,
                                           token="healthwatch")
    watch = healthwatch.HealthWatch(
        f"http://127.0.0.1:{daemon.port}/metrics",
        os.path.join(tmp, "runner-healthwatch"),
        policy=healthwatch.HealthPolicy(degrade_after=2, recover_after=2),
        on_verdict=healthwatch.node_annotation_publisher(lambda: hw_client,
                                                         node_name))

    def step() -> tuple:
        """The watchdog's verdict, and whether the Node then carries the
        annotation."""
        verdict = watch.step()
        return verdict, consts.ICI_DEGRADED_ANNOTATION in node()[
            "metadata"].get("annotations", {})

    try:
        _require(step() == (False, False), "a healthy node degraded")
        for m in minors:
            os.remove(os.path.join(devs, f"nvidia{m}"))
        step()
        _require(step() == (True, True),
                 "the watchdog never annotated the node")
        t_annotated = time.time()
        old_validator = kubelet.runs[validator]

        # 3. the runner: detect -> cordon -> drain -> revalidate
        wait("cordoned", lambda: remediation_state(node()) == "cordoned")
        taints = node()["spec"].get("taints", [])
        _require(node()["spec"].get("unschedulable") and any(
            t.get("key") == consts.REMEDIATION_TAINT_KEY for t in taints),
            f"the cordon: {node()['spec']}")
        wait("the gang member evicted and reaped",
             lambda: not gang_pods() and member.gone_at is not None)
        _require(member.deleted_at is not None and member.rc is not None,
                 f"the drain left the gang member: rc {member.rc}")
        wrote = _token_writes(stub.request_log[log0:], proc.token)
        _require(wrote.get("evict", {}).get("Pod", 0),
                 f"the runner evicted no pod; its writes: {wrote}")

        def chain_done() -> bool:
            new = kubelet.runs.get(validator)
            return (new is not None and new is not old_validator
                    and [r["container"] for r in new.records if r["rc"] == 0]
                    == [c["name"] for c in new.init])

        wait("the validator's chain rerun", lambda: chain_done()
             and gang_phase() == "Pending" and not gang_pods())
        _require(remediation_state(node()) == "revalidating"
                 and node()["spec"].get("unschedulable"),
                 f"the node left revalidation early: {node()['metadata']}")
        chain = kubelet.runs[validator]
        chain_start = min(r["started"] for r in chain.records)
        chain_end = max(r["started"] + r["seconds"] for r in chain.records)
        alive = [(g.name, g.exited_at) for g in kubelet.gangs[first_gang:]
                 if g.exited_at is None or g.exited_at > chain_start]
        _require(not alive, f"a gang member held the card while the "
                            f"validator's chain ran: {alive}")
        held = [e for e in explain("gpuworkload", namespace, GANG)
                if e["verdict"] == "hold"]
        _require(held and len(kubelet.gangs) == first_gang + 1,
                 f"the gang was not held off the cordoned node: {held}")

        # 4. the nodes back: the annotation clears, the node rejoins
        link_nodes()
        _require(step()[0] is True, "recovered too early")
        _require(step() == (False, False),
                 "the watchdog never cleared the annotation")
        wait("rejoined", lambda: remediation_state(node()) == ""
             and not node()["spec"].get("unschedulable"))
        # 5. the gang back on the node, then told to stop
        wait("the gang Running again", lambda: gang_phase() == "Running"
             and len(kubelet.gangs) > first_gang + 1
             and kubelet.gangs[-1].ready_at is not None)
        t_running = time.time()
        second = kubelet.gangs[-1]
        with open(stop_file, "w"):  # noqa: TPULNT306 - the gang's stop file in the run's temp dir
            pass
        wait("the gang Succeeded", lambda: gang_phase() == "Succeeded")
        status = reader.get("GPUWorkload", GANG, namespace)["status"]
        _require(status.get("reschedules") == 1 and second.rc == 0,
                 f"the gang ended {status}, its member rc {second.rc}")
    finally:
        daemon.close()
        hw_client.close()

    # the timelines, from the runner's journal
    states = remediation_states(explain("node", "", node_name))
    _require([s["to"] for s in states] == list(REMEDIATION_PATH),
             f"the node's remediation states: {states}")
    at = {s["to"]: s["wall"] for s in states}
    gang_line = [{"verdict": e["verdict"], "category": e["category"],
                  "reason": e["reason"], "at": e["wall"] - wall0,
                  "count": e["count"]}
                 for e in sorted(explain("gpuworkload", namespace, GANG),
                                 key=lambda e: e["wall"])
                 if e["category"] in ("placement", "lifecycle")]
    verdicts = [g["verdict"] for g in gang_line]
    _require(verdicts.index("degrade") < verdicts.index("teardown")
             < verdicts.index("hold"), f"the gang's timeline: {verdicts}")
    val_ready = [t for t, name, phase, ready in kubelet.ready_log
                 if name == f"{validator}-{node_name}" and ready
                 and t > t_annotated]
    _require(val_ready and min(val_ready) < at["rejoining"],
             f"the node rejoined at {at['rejoining']} before its new "
             f"validator pod was Ready ({val_ready})")
    _require(second.seen_at > at["healthy"],
             f"the gang was placed again at {second.seen_at}, before the "
             f"uncordon at {at['healthy']}")
    seconds = out_of_service(at, t_annotated, member.deleted_at,
                             member.gone_at, (chain_start, chain_end),
                             t_running)
    window = stub.request_log[log0:]
    launches = _gang_launches(kubelet.gangs[first_gang:], chain.records)
    out = {"place_seconds": place_s,
           "states": [{"from": s["from"], "to": s["to"], "event": s["event"],
                       "at": s["wall"] - wall0} for s in states],
           "gang_timeline": gang_line,
           "out_of_service_seconds": seconds,
           "passes_by_key": runner_passes_by_key(
               proc.json(f"/debug/traces?n={DEBUG_N}"), wall0),
           "writes": _token_writes(window, proc.token),
           "reads": _reads(window, proc.token),
           "steady": {"seconds": RUNNER_STEADY_S, "lease": renewals,
                      "reads": _reads(steady, proc.token)},
           "validator_rerun_children": [
               {k: r[k] for k in ("container", "attempt", "rc", "seconds")}
               for r in chain.records],
           "launches": launches,
           "seconds": time.perf_counter() - t_leg}
    print(json.dumps({"runner_remediation": out}), flush=True)
    _require(launches.get("matmul_bf16_f32", 0) > 0,
             f"the runner's remediation leg launched {launches}")
    return {"launches": launches, "records": chain.records}


def runner_serve_stale(leg) -> dict:
    """An apiserver partition under the live runner (``leg.leader``): the
    stub refuses every request but watch streams
    (``FaultSchedule.start_outage()``, the chaos tier's server-side
    outage) until the runner has been in serve-stale degraded mode with a
    key parked, longer than its ``--degraded-budget``; the kubelet
    thread's DaemonSet play is paused meanwhile, as a real kubelet keeps
    its pods through an outage.  The process must stay alive, ``/readyz``
    answer 200 ``degraded: serving-stale``, ``/debug/explain`` hold the
    ``serving-stale`` and ``parked`` entries, and no write land (the
    store's resourceVersion does not move).  After ``end_outage()`` the
    ``recovered`` entry appears, ``/readyz`` answers ``ok``, a present
    label another client stripped is repaired and the policy is
    ``ready``, the same process throughout.  Prints the seconds of
    each."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.client.faults import FaultSchedule

    t_leg = time.perf_counter()
    stub, proc, kubelet = leg.stub, leg.leader, leg.kubelet
    pid = proc.proc.pid
    path = (f"/debug/explain/operator/{leg.namespace}/degraded"
            f"?n={DEBUG_N}")

    def journal() -> dict:
        return degraded_journal(proc.json(path))["walls"]

    def wait(what: str, done, deadline_s: float) -> float:
        return leg.wait(what, done, proc, deadline_s)

    before = {v: len(w) for v, w in journal().items()}

    def new(verdict: str) -> bool:
        return len(journal().get(verdict, [])) > before.get(verdict, 0)

    kubelet.daemonsets.clear()
    time.sleep(0.5)          # a DaemonSet step in flight ends first
    log0, rv0 = len(stub.request_log), stub._max_rv()
    t0, wall0 = time.perf_counter(), time.time()
    stub.faults = FaultSchedule(seed=17).start_outage()
    try:
        degraded_s = wait("/readyz serving stale", lambda: proc.get(
            "/readyz") == (200, "degraded: serving-stale\n"),
            RUNNER_OUTAGE_DEADLINE_S)
        parked_s = wait("a parked key", lambda: new("serving-stale")
                        and new("parked"), RUNNER_OUTAGE_DEADLINE_S)
        outage_s = time.perf_counter() - t0
        rv1, log1 = stub._max_rv(), len(stub.request_log)
        refused = len(stub.faults.injected)
    finally:
        stub.faults.end_outage()
    t1 = time.perf_counter()
    kubelet.daemonsets.set()
    attempted = _token_writes(stub.request_log[log0:log1], proc.token)
    _require(rv1 == rv0, f"a write landed during the outage: "
                         f"resourceVersion {rv0} -> {rv1}")
    _require(outage_s > RUNNER_DEGRADED_BUDGET_S,
             f"the outage ({outage_s} s) was shorter than the budget")
    recovered_s = wait("the recovered entry", lambda: new("recovered"),
                       RUNNER_OUTAGE_DEADLINE_S)
    readyz_s = wait("/readyz ok", lambda: proc.get("/readyz") == (200, "ok"),
                    RUNNER_OUTAGE_DEADLINE_S)
    node = leg.reader.get("Node", leg.node_name)
    del node["metadata"]["labels"][consts.TPU_PRESENT_LABEL]
    leg.admin.update(node)
    repair_s = wait("the present label", lambda: leg.reader.get(
        "Node", leg.node_name)["metadata"]["labels"].get(
        consts.TPU_PRESENT_LABEL) == "true", 60.0)
    wait("the policy ready", lambda: leg.policy() == (
        "ready", (1, 1), "true"), 60.0)
    ready_s = time.perf_counter() - t1
    _require(proc.proc.pid == pid and proc.proc.poll() is None,
             "the runner restarted through the outage")
    entries = degraded_journal(proc.json(path))
    out = {"outage_seconds": outage_s, "to_serving_stale": degraded_s,
           "to_parked": parked_s, "refused_requests": refused,
           "runner_writes_refused": attempted,
           "parked_keys": entries["parked_keys"],
           "after_outage": {"recovered": recovered_s, "readyz_ok": readyz_s},
           "label_repair_seconds": repair_s,
           "policy_ready_after_outage_seconds": ready_s,
           "journal_since_outage": {
               v: [w - wall0 for w in walls if w >= wall0]
               for v, walls in entries["walls"].items()},
           "seconds": time.perf_counter() - t_leg}
    print(json.dumps({"runner_serve_stale": out}), flush=True)
    return out


def runner_standby(leg) -> dict:
    """A second runner process beside the live leader (``leg.leader``):
    the same argv and env, a distinct ``HOSTNAME`` and token, its own
    snapshot dir.  While the leader holds the Lease the standby writes
    nothing (its Lease attempts are reads of a Lease held and fresh), runs
    no reconcile pass (its ``/metrics`` counts none) and answers
    ``/readyz`` as the JAX runner's standby does: 200 ``ok`` once its
    cache has synced, since ``main`` marks the health server ready before
    the scheduler stands by and the probe gates on the informer and
    degraded mode alone (``tpu_operator/cmd/operator.py``,
    ``HealthServer``).  Prints what it read and wrote; the leader's
    SIGTERM that follows is the runner phase's handoff
    (:func:`standby_takeover`)."""
    from tpu_operator_torch.cmd.operator import LEASE_NAME
    from tpu_operator_torch.exposition import parse

    t_leg = time.perf_counter()
    stub = leg.stub
    standby = RunnerProcess(leg.container, leg.namespace, stub.url,
                            RUNNER_TOKENS[2], leg.standby_snapshot,
                            os.path.join(leg.tmp, "runner-standby.log"))
    leg.procs.append(standby)
    leg.standby = standby
    log0 = len(stub.request_log)
    ready_s = leg.wait("the standby's /readyz", lambda: standby.get(
        "/readyz")[0] == 200, standby, 60.0)
    time.sleep(RUNNER_STANDBY_S)
    readyz = standby.get("/readyz")
    holder = leg.reader.get("Lease", LEASE_NAME,
                            leg.namespace)["spec"]["holderIdentity"]
    window = stub.request_log[log0:]
    lease, writes = standby_writes(window, standby.token)
    code, body = standby.get("/metrics", metrics=True)
    passes = reconcile_passes(parse(body)) if code == 200 else None
    out = {"readyz": readyz, "readyz_seconds": ready_s,
           "lease_holder": holder, "lease_writes": lease, "writes": writes,
           "reads": _reads(window, standby.token), "passes": passes,
           "seconds": time.perf_counter() - t_leg}
    print(json.dumps({"runner_standby": out}), flush=True)
    _require(holder == leg.leader.identity,
             f"the standby took the Lease from a live leader: {holder}")
    _require(not writes and not lease,
             f"the standby wrote beside the live leader: {out}")
    _require(passes is not None and not any(passes.values()),
             f"the standby ran reconcile passes: {passes}")
    _require(readyz == (200, "ok"), f"the standby's /readyz: {readyz}")
    return out


def standby_takeover(leg, t_term: float, val, records0: int) -> dict:
    """After the leader's SIGTERM (wall time ``t_term``): the standby must
    hold the Lease within :data:`RUNNER_TAKEOVER_S`, LIST no watched kind
    (its cache is current) and keep the policy ``ready`` without a
    validator rerun (``val``, ``records0``: the validator's run and its
    record count before)."""
    from tpu_operator_torch.cmd.operator import LEASE_NAME

    standby, stub = leg.standby, leg.stub
    log0 = len(stub.request_log)
    take_s = leg.wait("the standby takes the Lease", lambda: leg.reader.get(
        "Lease", LEASE_NAME, leg.namespace)["spec"]["holderIdentity"]
        == standby.identity, standby, RUNNER_TAKEOVER_S)
    since_sigterm = time.time() - t_term
    time.sleep(RUNNER_STEADY_S)
    window = stub.request_log[log0:]
    lists = {k: n for k, n in _reads(window, standby.token).get(
        "list", {}).items() if k in INFORMER_KINDS}
    out = {"lease_seconds": take_s,
           "lease_seconds_since_sigterm": since_sigterm,
           "lists_of_watched_kinds": lists,
           "writes": _token_writes(window, standby.token),
           "policy": leg.policy(),
           "validator_records_after": len(val.records) - records0}
    print(json.dumps({"runner_standby_takeover": out}), flush=True)
    _require(not lists, f"the standby LISTed watched kinds: {lists}")
    _require(out["policy"] == ("ready", (1, 1), "true")
             and leg.kubelet.runs["gpu-operator-validator"] is val
             and len(val.records) == records0,
             f"the takeover reran the validator chain: {out}")
    return out


# the legs, in the order :func:`runner` drives them: the outage before the
# standby, since a Lease the partitioned leader cannot renew lapses and a
# standby beside it could take it when the apiserver returns
RUNNER_LEGS = (runner_remediation, runner_serve_stale, runner_standby)


def runner_legs(leg) -> dict:
    """Each of :data:`RUNNER_LEGS` in turn on the runner phase's state
    ``leg``; their results by name."""
    return {fn.__name__: fn(leg) for fn in RUNNER_LEGS}


def runner(torch, ops) -> dict:
    """The operator process on the card's node as its packaged Deployment
    runs it: the command, args and env of ``manager.yaml``'s container
    (:class:`RunnerProcess`) against a stub apiserver that first gets the
    three CRDs from the chart's pre-upgrade hook (``gen_crds --apply``, a
    child with ``--api-server``), then is seeded as the ``operator``
    phase's (the card's Node labelled by fd, a CPU Node,
    ``sample_policy()``), a :class:`Kubelet`
    thread serving the device plugin and running the rendered DaemonSets'
    containers, the validator's children loading the kernel library this
    run built (copied into the node's build dir).  The runner alone must
    take the policy to ``ready`` (slice 1/1, ``tpu.slice.ready=true``,
    ``/readyz`` 200) with the validator chain passing on the card; then
    hold a steady window with no write but its Lease renewals and no LIST
    of a watched kind; serve ``/metrics`` as :func:`runner_metrics`
    requires; then carry :data:`RUNNER_LEGS` as the only reconciler — a
    remediation with a gang (:func:`runner_remediation`), an apiserver
    outage (:func:`runner_serve_stale`) and a standby process beside it
    (:func:`runner_standby`); exit 0 on SIGTERM within 15 s, its Lease
    released and its snapshot flushed, the standby taking the Lease within
    the Lease's duration with no LIST and no validator rerun
    (:func:`standby_takeover`).  The standby handed off by SIGTERM in
    turn, a second process on its snapshot with a new token
    must take the Lease at once, LIST no restored kind, journal one
    ``failover`` entry, keep the policy ``ready`` without rerunning the
    validator chain, and restore a present label another client stripped;
    an admin's upgrade-state reset then takes the node through the driver
    upgrade's stages, the runner's Events carrying the journal's entries
    (the Event backfill).  ``gpu-status`` renders the policy ``ready`` and
    the slice 1/1; ``cleanup``, the chart's pre-delete hook run as a child
    from its argv, deletes the CRs; SIGTERM, exit 0.  Returns the
    validator children's launch counts, and apart from them the
    remediation leg's (its gang members' and its rerun chain's)."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.api.crd import all_crds
    from tpu_operator_torch.client.resilience import (
        resilient_incluster_client)
    from tpu_operator_torch.cmd import status
    from tpu_operator_torch.cmd.operator import LEASE_NAME
    from tpu_operator_torch.fd import build_labels
    from tpu_operator_torch.host import host_for_root
    from tpu_operator_torch.informer import snapshot
    from tpu_operator_torch.testing.fake_cluster import (make_cpu_node,
                                                         sample_policy)
    from tpu_operator_torch.testing.stub_apiserver import StubApiServer
    from tpu_operator_torch.validator import _build

    t_phase = time.perf_counter()
    ops.reset_launches()
    host = host_for_root("/")
    node_name, cpu_name = "h100-node-0", "cpu-node-0"
    namespace = consts.DEFAULT_NAMESPACE
    card_labels = {"kubernetes.io/hostname": node_name,
                   **build_labels(host)}
    stub = StubApiServer([
        {"apiVersion": "v1", "kind": "Node",
         "metadata": {"name": node_name, "labels": card_labels},
         "spec": {}, "status": {"capacity": {}, "nodeInfo": {
             "containerRuntimeVersion": "containerd://1.7.0"}}},
        make_cpu_node(cpu_name)],
        watch_event_window=INFORMER_WATCH_WINDOW)
    clients = {t: resilient_incluster_client(api_server=stub.url, token=t)
               for t in ("kubelet", "reader", "admin", "status")}
    reader = clients["reader"]
    chart = os.path.join(deploy_tree(), "chart", "templates")
    container = manager_container()
    tmp = tempfile.mkdtemp(prefix="runner")
    snap = os.path.join(tmp, "snapshot")
    stubs, _ = _recording_stubs(tmp)
    # the kernel library this run built, in the node's build dir (the
    # validator's pods set TPU_OPERATOR_TORCH_BUILD_DIR to /run/gpu/build
    # on the run-gpu hostPath), so the children load it
    lib = _build.build(torch.cuda.current_device())
    shutil.copytree(lib.parent, os.path.join(
        tmp, "host", "run", "gpu", "build", "kernels", lib.parent.name))
    endpoint = PluginEndpoint(host)
    kubelet, procs, out = None, [], {}
    try:
        # 0. the CRDs, as the chart's pre-upgrade hook applies them; then
        # the policy, as the chart's template creates it
        argv = hook_argv(os.path.join(chart, "upgrade_crd.yaml"))
        rc, text, crd_s = run_hook(argv, stub.url, "upgrade-crd-hook")
        crds = {c["metadata"]["name"]: c["spec"]
                for c in reader.list("CustomResourceDefinition")}
        out["crds"] = {"argv": argv[1:] + ["--api-server=<stub>"], "rc": rc,
                       "seconds": crd_s, "names": sorted(crds)}
        print(json.dumps({"runner_crds": out["crds"]}), flush=True)
        _require(rc == 0 and crds == {c["metadata"]["name"]: c["spec"]
                                      for c in all_crds()},
                 f"gen_crds --apply: rc {rc}, CRDs {sorted(crds)}: {text}")
        clients["admin"].create(sample_policy())
        endpoint.start()
        kubelet = Kubelet(clients["kubelet"], endpoint, endpoint.devices(),
                          node_name, namespace, consts.DEFAULT_RESOURCE_NAME,
                          os.path.join(tmp, "host", "var", "run", "cdi"),
                          api_server=stub.url, tmp=tmp, stubs=stubs)
        kubelet.start()
        stub.pod_containers_running = kubelet.runs_containers_of
        _require(kubelet.advertised.wait(30),
                 f"the kubelet never wrote the capacity: {kubelet.error!r}")
        kubelet.daemonsets.set()

        def policy() -> tuple:
            st = reader.get("GPUPolicy", "gpu-policy").get("status", {})
            labels = reader.get("Node", node_name)["metadata"]["labels"]
            return (st.get("state"), (st.get("slicesTotal"),
                                      st.get("slicesReady")),
                    labels.get(consts.SLICE_READY_LABEL))

        def lease() -> dict:
            return reader.get("Lease", LEASE_NAME, namespace)["spec"]

        def wait(what: str, done, proc, deadline_s: float):
            t0 = time.perf_counter()
            while not done():
                _require(time.perf_counter() - t0 < deadline_s,
                         f"{what}: not within {deadline_s} s")
                _require(kubelet.error is None,
                         f"the kubelet failed: {kubelet.error!r}")
                proc.alive()
                time.sleep(0.1)
            return time.perf_counter() - t0

        # 1. the runner alone takes the policy to ready
        first = RunnerProcess(container, namespace, stub.url,
                              RUNNER_TOKENS[0], snap,
                              os.path.join(tmp, "runner-1.log"))
        procs.append(first)
        out["process"] = {"argv": first.argv[1:], "env": first.env}
        print(json.dumps({"runner_process": out["process"]}), flush=True)
        wait("policy -> ready", lambda: policy() == ("ready", (1, 1), "true")
             and first.get("/readyz")[0] == 200, first, RUNNER_READY_S)
        ready_s = time.perf_counter() - first.started
        ready_log = len(stub.request_log)
        val = kubelet.runs["gpu-operator-validator"]
        chain = [r["container"] for r in val.records if r["rc"] == 0]
        _require(chain == [f"{c}-validation" for c in (
            "device", "driver", "toolkit", "torch", "perf", "plugin")],
            f"the validator's init containers: {val.records}")
        staged = [r for r in val.records if r["stages"] and r["rc"] == 0]
        _require([r["container"] for r in staged]
                 == ["torch-validation", "perf-validation"]
                 and all(r["stages"]["kernel_cache_hit"] for r in staged),
                 f"the validator's children built the library: {staged}")
        traces = first.json("/debug/traces?n=10000")
        out["ready"] = {
            "policy_to_ready_seconds": ready_s,
            "writes": _token_writes(stub.request_log, first.token),
            "reads": _reads(stub.request_log, first.token),
            "passes_by_key": runner_passes_by_key(traces),
            "convergence": first.json("/debug/vars")["convergence"],
            "chain_seconds": {r["container"]: r["seconds"]
                              for r in val.records if r["rc"] == 0}}
        print(json.dumps({"runner_ready": out["ready"]}), flush=True)

        # 2. a steady window: no write but the Lease's renewals, no LIST
        time.sleep(RUNNER_STEADY_S)
        first.alive()
        steady = stub.request_log[ready_log:]
        writes = _token_writes(steady, first.token)
        lists = sorted(set(_reads(steady, first.token).get("list", {}))
                       & set(INFORMER_KINDS))
        renewals = writes.get("update", {}).pop("Lease", 0)
        writes = {verb: kinds for verb, kinds in writes.items() if kinds}
        out["steady"] = {"seconds": RUNNER_STEADY_S, "writes": writes,
                         "lease_renewals": renewals, "lists": lists,
                         "reads": _reads(steady, first.token)}
        print(json.dumps({"runner_steady": out["steady"]}), flush=True)
        _require(not writes and not lists and policy()[0] == "ready",
                 f"the steady window: {out['steady']}")

        # 3. /metrics through the port's parser
        code, body = first.get("/metrics", metrics=True)
        _require(code == 200, f"/metrics: {code}")
        out["metrics"] = runner_metrics(body)
        print(json.dumps({"runner_metrics": out["metrics"]}), flush=True)

        # the legs: a remediation with a gang, an apiserver outage, a
        # standby beside the leader — the runner the only reconciler
        leg = types.SimpleNamespace(
            stub=stub, reader=reader, admin=clients["admin"],
            kubelet=kubelet, leader=first, container=container,
            namespace=namespace, node_name=node_name, tmp=tmp,
            policy=policy, wait=wait, procs=procs, standby=None,
            standby_snapshot=os.path.join(tmp, "standby-snapshot"))
        out["legs"] = runner_legs(leg)
        val = kubelet.runs["gpu-operator-validator"]   # the rerun chain's

        # 4. the graceful handoff, to the standby
        records0 = len(val.records)
        t_term = time.time()
        rc, stop_s = first.stop()
        held = lease()
        saved = snapshot.load_snapshot(os.path.join(
            snap, snapshot.SNAPSHOT_BASENAME))
        out["handoff"] = {
            "rc": rc, "seconds": stop_s, "lease": held,
            "snapshot_saved_after_sigterm_s":
                None if saved is None else saved["saved_at"] - t_term}
        print(json.dumps({"runner_handoff": out["handoff"]}), flush=True)
        _require(rc == 0, f"SIGTERM: rc {rc} after {stop_s} s: "
                          f"{first.tail()}")
        # released, or already taken by the standby (which cannot take a
        # Lease held and fresh)
        _require((held["holderIdentity"] == first.identity
                  and held["leaseDurationSeconds"] == 0)
                 or held["holderIdentity"] == leg.standby.identity,
                 f"the Lease was not released: {held}")
        _require(saved is not None and saved["saved_at"] >= t_term,
                 "the snapshot was not flushed on SIGTERM")
        out["takeover"] = standby_takeover(leg, t_term, val, records0)

        # 5. a restart from the snapshot of the process that then led,
        # the standby, handed off by SIGTERM in turn
        rc, stop_s = leg.standby.stop()
        _require(rc == 0, f"the standby's SIGTERM: rc {rc} after {stop_s} "
                          f"s: {leg.standby.tail()}")
        restart_log = len(stub.request_log)
        records0 = len(val.records)
        second = RunnerProcess(container, namespace, stub.url,
                               RUNNER_TOKENS[1], leg.standby_snapshot,
                               os.path.join(tmp, "runner-2.log"))
        procs.append(second)
        lease_s = wait("the Lease", lambda: lease()["holderIdentity"]
                       == second.identity, second, 10.0)
        wait("the failover entry", lambda: second.get(
            f"/debug/explain/operator/{namespace}/leader")[0] == 200
            and failover_entries(second, namespace), second, 60.0)
        (entry,) = failover_entries(second, namespace)
        node = reader.get("Node", node_name)
        del node["metadata"]["labels"][consts.TPU_PRESENT_LABEL]
        clients["admin"].update(node)
        repair_s = wait("the present label", lambda: reader.get(
            "Node", node_name)["metadata"]["labels"].get(
            consts.TPU_PRESENT_LABEL) == "true", second, 30.0)
        restarted = stub.request_log[restart_log:]
        lists = {k: n for k, n in _reads(restarted, second.token).get(
            "list", {}).items() if k in INFORMER_KINDS}
        out["restart"] = {
            "lease_seconds": lease_s, "failover": entry["inputs"],
            "lists_of_restored_kinds": lists,
            "label_repair_seconds": repair_s,
            "writes": _token_writes(restarted, second.token),
            "validator_records_after": len(val.records) - records0,
            "policy": policy()}
        print(json.dumps({"runner_restart": out["restart"]}), flush=True)
        _require(set(entry["inputs"]["restored_kinds"]) >= set(
            INFORMER_KINDS) and not {k: n for k, n in lists.items()
                                     if k in entry["inputs"][
                                         "restored_kinds"]},
                 f"the restart LISTed restored kinds: {out['restart']}")
        _require(out["restart"]["policy"] == ("ready", (1, 1), "true")
                 and kubelet.runs["gpu-operator-validator"] is val
                 and len(val.records) == records0,
                 f"the restart reran the validator chain: {out['restart']}")

        # 6. the Event backfill: an admin's upgrade-state reset takes the
        # node through the driver upgrade's stages, each a journal entry
        upgrade_log = len(stub.request_log)
        pol = reader.get("GPUPolicy", "gpu-policy")
        pol["spec"]["driver"] = {"upgradePolicy": {
            "autoUpgrade": True, "maxParallelUpgrades": 1}}
        clients["admin"].update(pol)
        node = reader.get("Node", node_name)
        node["metadata"]["labels"][consts.UPGRADE_STATE_LABEL] = \
            "upgrade-required"
        clients["admin"].update(node)
        upgrade_s = wait("the upgrade", lambda: reader.get(
            "Node", node_name)["metadata"]["labels"].get(
            consts.UPGRADE_STATE_LABEL) == "upgrade-done"
            and not reader.get("Node", node_name)["spec"].get(
                "unschedulable") and policy()[0] == "ready", second, 120.0)
        entries = second.json(f"/debug/explain/node/-/{node_name}")[
            "entries"]
        events = backfilled_events(reader, stub.request_log[upgrade_log:],
                                   second.token, node_name, entries)
        out["backfill"] = {
            "upgrade_seconds": upgrade_s, "events": events,
            "journal_entries": len(entries),
            "stage_seconds": [
                [e["wall"] - min(x["wall"] for x in entries),
                 e["condition"]["to"]]
                for e in sorted(entries, key=lambda x: x["wall"])
                if e.get("condition")]}
        print(json.dumps({"runner_backfill": out["backfill"]}), flush=True)
        _require(events, "no Event of the runner carries a journal entry")

        # 7. gpu-status and cleanup
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc_status = status.main(["--namespace", namespace],
                                    client=clients["status"])
        rendered = text.getvalue()
        print(json.dumps({"runner_gpu_status": rendered}), flush=True)
        _require(rc_status == 0 and "state=ready  slices 1/1 ready"
                 in rendered and "hosts 1/1 validated   slice.ready=true"
                 in rendered, f"gpu-status: rc {rc_status}")
        # what the runner wrote, its CRs' status too, before the cleanup
        # hook deletes the CRs (read again, with what came after, below)
        written = {_object_key(o): o for o in stub.store._store.values()}
        rc_cleanup, text, cleanup_s = run_hook(
            hook_argv(os.path.join(chart, "cleanup_crd.yaml")), stub.url,
            "cleanup-hook")
        _require(rc_cleanup == 0 and not reader.list("GPUPolicy")
                 and not reader.list("GPUDriver"),
                 f"cleanup: rc {rc_cleanup}: {text}")
        rc, stop_s = second.stop()
        out["end"] = {"cleanup_seconds": cleanup_s, "rc": rc,
                      "stop_seconds": stop_s,
                      "lease_released": lease()["leaseDurationSeconds"] == 0}
        print(json.dumps({"runner_end": out["end"]}), flush=True)
        _require(rc == 0, f"SIGTERM after cleanup: rc {rc}: "
                          f"{second.tail()}")
        init_records = [r for run in list(kubelet.runs.values())
                        + kubelet.stopped for r in run.records]
        written.update((_object_key(o), o)
                       for o in stub.store._store.values())
        out["names"] = names_leg(
            "runner", list(written.values()), os.path.join(tmp, "host"),
            [body], kubelet.child_envs, [snap, leg.standby_snapshot])
    finally:
        for proc in procs:
            proc.close()
        exits = kubelet.close() if kubelet is not None else []
        endpoint.close()
        for c in clients.values():
            c.close()
        stub.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    # the remediation leg's launches (its gang members' and the rerun
    # chain's) apart from the phase's other validator children
    counted = {id(r) for r in out["legs"]["runner_remediation"]["records"]}
    launches = {name: 0 for name in ops.LAUNCHES}
    for r in init_records:
        for name, n in (r["launches"] or {}).items():
            launches[name] += 0 if id(r) in counted else n
    for name, n in ops.LAUNCHES.items():
        launches[name] += n          # this process: none
    remediated = {name: out["legs"]["runner_remediation"]["launches"].get(
        name, 0) for name in ops.LAUNCHES}
    _require(kubelet.error is None, f"the kubelet failed: {kubelet.error!r}")
    _require(all(e["rc"] is not None for e in exits),
             f"a container outlived the phase: {exits}")
    _require(launches["matmul_bf16_f32"] > 0,
             f"the runner's validator children launched {launches}")
    print(json.dumps({"runner_seconds": time.perf_counter() - t_phase,
                      "runner_launches": launches,
                      "runner_remediation_launches": remediated}),
          flush=True)
    return launches, remediated


def drive_main_path(torch, ops, microbench) -> dict:
    """The port's path through its entry points, leg by leg, each with the
    launch counts reset just before it and read just after; returns the
    counts per leg."""
    from tpu_operator_torch.entry import entry

    with tempfile.TemporaryDirectory() as run_dir:
        legs = node_chain(torch, os.path.join(run_dir, "metadata"))
        legs["health"] = health(torch, ops, run_dir)

    ops.reset_launches()
    node_operands(torch)
    legs["node_operands"] = dict(ops.LAUNCHES)

    legs["operator"], legs["upgrade"], legs["remediation"] = operator(torch,
                                                                      ops)
    legs["packaging"] = packaging(ops)
    legs["lint"] = lint(ops)
    legs["runner"], legs["runner_remediation"] = runner(torch, ops)

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
    print(json.dumps({"entry_loss": loss, "entry_loss_cpu": ref,
                      "entry_launches": legs["entry"]}), flush=True)
    _require(math.isfinite(loss) and math.isclose(loss, ref, rel_tol=1e-5),
             f"entry() loss {loss} vs CPU {ref}")
    _require(legs["entry"] == dict(dict.fromkeys(legs["entry"], 0),
                                   matmul_bf16_f32=2),
             f"entry()'s forward launched {legs['entry']}, want its two "
             "products on the matmul kernel")
    return legs


# --------------------------------------------------------------------------
# the collectives phase; the rank functions are module-level, since on more
# than one card every rank is a new process that imports this file
# --------------------------------------------------------------------------

def _checks_rank() -> list:
    """Every collective check of the port at its defaults, in the order of
    the JAX package's source; the multislice check on an even world only."""
    import torch.distributed as dist

    from tpu_operator_torch.validator import workloads as wl

    reports = [wl.ici_psum_check(), wl.ici_ring_check(),
               wl.ici_all_gather_check(), wl.multihost_allreduce_check(),
               wl.ep_all_to_all_check(), wl.pp_pipeline_check(),
               wl.ring_attention_check(), wl.ulysses_attention_check(),
               wl.ici_bandwidth_probe()]
    if dist.get_world_size() % 2 == 0:
        reports.append(wl.dcn_multislice_check())
    return reports


def _attention_rank(ring_qkv, ulysses_qkv) -> tuple:
    """Ring and Ulysses attention of the given inputs on the default mesh,
    gathered, as numpy."""
    import torch

    from tpu_operator_torch.validator import workloads as wl

    mesh = wl.make_mesh()
    ring = wl.ring_attention(*map(torch.from_numpy, ring_qkv), mesh, "data")
    uly = wl.ulysses_attention(*map(torch.from_numpy, ulysses_qkv), mesh,
                               "data")
    return ring.cpu().numpy(), uly.cpu().numpy()


# train steps a _burn_in_rank takes: its own three and the burn-in's
BURN_IN_RANK_STEPS = 3 + 3
# matmul launches of one train step on a rank: two products forward,
# three backward (dW2, dh, dW1)
STEP_MATMULS = 5


def _burn_in_rank() -> tuple:
    """The losses of three sharded train steps on the default mesh (the
    slice burn-in's), the burn-in's own report (three steps more) and this
    rank's kernel launches."""
    from tpu_operator_torch.validator import ops, workloads as wl

    ops.reset_launches()
    mesh = wl.make_mesh()
    step, params, (x, y) = wl.sharded_train_step(mesh)
    losses = []
    for _ in range(3):
        loss, params = step(params, x, y)
        losses.append(float(loss))
    return losses, wl.slice_burn_in(mesh, steps=3), dict(ops.LAUNCHES)


def _full_rank() -> tuple:
    """run_full_validation at full size, with the launch counts of this
    rank (rank 0 runs the burn-ins that launch the matmul kernel)."""
    from tpu_operator_torch.validator import ops, workloads as wl

    ops.reset_launches()
    reports = wl.run_full_validation()
    return reports, dict(ops.LAUNCHES)


def collectives(torch, ops) -> dict:
    """The multi-device validator over NCCL on every visible card, leg by
    leg, each with the launch counts reset just before it and read just
    after; returns the counts per leg."""
    import numpy as np

    from tpu_operator_torch import statusfiles
    from tpu_operator_torch.entry import dryrun_multigpu
    from tpu_operator_torch.validator import _dist
    from tpu_operator_torch.validator.__main__ import main as validator_main

    world = torch.cuda.device_count()
    legs, seconds = {}, {}

    def leg(name, run):
        ops.reset_launches()
        t0 = time.perf_counter()
        out = run()
        seconds[name] = time.perf_counter() - t0
        legs[name] = dict(ops.LAUNCHES)
        return out

    reports = leg("collective_checks",
                  lambda: _dist.spawn(world, _checks_rank, "cuda"))
    print(json.dumps({"collectives": {"world": world, "backend": "nccl",
                                      "checks": [r.to_dict() for r in reports]}}),
          flush=True)
    want = ["nccl-psum", "nccl-ring", "nccl-all-gather", "multihost-allreduce",
            "ep-all-to-all", "pp-pipeline", "nccl-ring-attention",
            "nccl-ulysses-attention", "nccl-bandwidth"] + (
                ["dcn-multislice"] if world % 2 == 0 else [])
    _require([r.name for r in reports] == want and all(r.ok for r in reports),
             f"collective checks: {[(r.name, r.ok, r.detail) for r in reports]}")

    # the attention gates' inputs, from a seed, at the checks' default sizes
    g = torch.Generator().manual_seed(3)
    seq = world * 32
    ring_qkv = tuple(torch.randn((seq, 32), generator=g).numpy()
                     for _ in range(3))
    uly_qkv = tuple(torch.randn((seq, world, 16), generator=g).numpy()
                    for _ in range(3))
    card = leg("attention_card", lambda: _dist.spawn(
        world, _attention_rank, "cuda", ring_qkv, uly_qkv))
    cpu = _dist.spawn(1, _attention_rank, "cpu", ring_qkv, uly_qkv)
    gaps = {name: float(np.max(np.abs(a - b)))
            for name, a, b in zip(("ring", "ulysses"), card, cpu)}
    print(json.dumps({"attention_card_vs_cpu": gaps}), flush=True)
    _require(all(gap <= 1e-5 for gap in gaps.values()),
             f"attention on the card vs the CPU: {gaps}")

    card_losses, card_rep, rank_launches = leg(
        "burn_in_card", lambda: _dist.spawn(world, _burn_in_rank, "cuda"))
    legs["burn_in_card"] = rank_launches  # rank 0's own: on more than one
    # card its launches happen in another process
    cpu_losses, _, _ = _dist.spawn(world, _burn_in_rank, "cpu")
    print(json.dumps({"slice_burn_in": {
        "card_losses": card_losses, "cpu_losses": cpu_losses,
        "report": card_rep.to_dict(), "rank0_launches": rank_launches}}),
        flush=True)
    _require(card_rep.ok and all(
        math.isclose(a, b, rel_tol=1e-4)
        for a, b in zip(card_losses, cpu_losses)),
        f"slice burn-in on the card {card_losses} vs CPU {cpu_losses}")
    _require(rank_launches == dict(
        dict.fromkeys(rank_launches, 0),
        matmul_bf16_f32=STEP_MATMULS * BURN_IN_RANK_STEPS),
        f"a burn-in rank's {BURN_IN_RANK_STEPS} train steps launched "
        f"{rank_launches}, want {STEP_MATMULS} matmuls a step and nothing "
        "else")

    with tempfile.TemporaryDirectory() as status_dir:
        rc = leg("nccl_component", lambda: validator_main(
            ["--component=nccl", f"--status-dir={status_dir}"]))
        _require(rc == 0, f"--component=nccl exited {rc}")
        ready = statusfiles.read_status("nccl-ready", status_dir)
    # on one card the component's burn-in (two steps) runs in this process
    _require(world > 1 or legs["nccl_component"]["matmul_bf16_f32"]
             == 2 * STEP_MATMULS,
             f"--component=nccl launched {legs['nccl_component']}")
    print(json.dumps({"component": "nccl", "seconds": seconds["nccl_component"],
                      "nccl_ready": ready}), flush=True)
    _require(ready is not None and ready.get("devices") == str(world),
             f"nccl-ready missing or wrong: {ready}")

    reports, launches = leg("full_validation", lambda: _dist.spawn(
        world, _full_rank, "cuda"))
    legs["full_validation"] = launches    # rank 0's own: on more than one
    # card its launches happen in another process
    print(json.dumps({"full_validation": [r.to_dict() for r in reports]}),
          flush=True)
    want = ["device", "matmul-burn-in", "hbm-stress"] + (
        ["nccl-psum", "nccl-ring", "nccl-all-gather", "nccl-ring-attention",
         "multihost-allreduce"] if world > 1 else []) + ["slice-burn-in"]
    _require([r.name for r in reports] == want and all(r.ok for r in reports),
             f"run_full_validation: {[(r.name, r.ok, r.detail) for r in reports]}")

    leg("dryrun", lambda: dryrun_multigpu(world))
    _require(world > 1 or legs["dryrun"]["matmul_bf16_f32"] == STEP_MATMULS,
             f"dryrun_multigpu's train step launched {legs['dryrun']}")
    print(json.dumps({"collectives_seconds": seconds}), flush=True)
    return legs


def main_path(torch, _build, ops, microbench, workloads) -> list:
    """Phases 2-5 on the card: build, kernel checks, the main path's legs
    and the collectives; returns the kernels line's records."""
    t0 = time.perf_counter()
    lib = _build.build(torch.cuda.current_device())
    print(json.dumps({"build_seconds": time.perf_counter() - t0,
                      "library": str(lib.relative_to(_build.BUILD_ROOT.parents[1]))}),
          flush=True)
    check_sass(_build, lib)
    triad_resources(_build)

    t_checks = time.perf_counter()
    records = check_kernels(torch, ops, microbench)
    print(json.dumps({"kernel_checks_seconds":
                      time.perf_counter() - t_checks}), flush=True)
    torch_component_rates(workloads)
    graph_chains(torch, ops, workloads)
    perf_gate(torch, microbench, probe_chain_profile(torch, workloads))
    legs = drive_main_path(torch, ops, microbench)
    legs |= collectives(torch, ops)
    print(json.dumps({"launches_by_leg": legs}), flush=True)
    launches = {name: sum(leg[name] for leg in legs.values())
                for name in ops.LAUNCHES}
    for name, rec in records.items():
        route = rec.get("counted_as", name)
        rec["launches"] = launches[route]
        rec["launches_by_leg"] = {leg: counts[route]
                                  for leg, counts in legs.items()}
    idle = [name for name, count in launches.items() if count == 0]
    _require(not idle, f"kernels never launched on the main path: {idle}")
    _require(legs["hbm_sweep"]["triad_"] > 0,
             "the hbm sweep leg never launched the triad kernel")
    _require(legs["full_validation"]["matmul_bf16_f32"] > 0,
             "run_full_validation never launched the matmul kernel")
    _require(legs["health"]["matmul_bf16_f32"] > 0,
             "the health phase's load never launched the matmul kernel")
    _require(legs["remediation"]["matmul_bf16_f32"] > 0,
             "the remediation phase never launched the matmul kernel")
    _require(legs["runner"]["matmul_bf16_f32"] > 0,
             "the runner phase never launched the matmul kernel")
    _require(legs["runner_remediation"]["matmul_bf16_f32"] > 0,
             "the runner's remediation leg never launched the matmul "
             "kernel")
    return list(records.values())


def main() -> int:
    if sys.argv[1:] == ["--gang-member"]:
        return gang_member_main()
    start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the card")
    from tpu_operator_torch.validator import (_build, _dist, microbench, ops,
                                              workloads)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "collectives": [_dist.all_gather_into.__name__,
                                      _dist.reduce_scatter_into.__name__]}),
          flush=True)

    kernels = main_path(torch, _build, ops, microbench, workloads)
    print(json.dumps({"chip_smoke_seconds": time.perf_counter() - start}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
