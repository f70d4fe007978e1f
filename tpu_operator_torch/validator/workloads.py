"""Validation workloads on PyTorch — the counterpart of
``tpu_operator/validator/workloads.py``.

Single device:

* :func:`device_check` — the card enumerates (``torch.cuda``), the
  ``nvidia-smi`` analogue.
* :func:`matmul_burn_in` — a chain of bf16 products with f32 results through
  the hand-written tensor-core kernel (``ops.matmul_bf16_f32``), checked for
  a finite, deterministic checksum; reports TFLOP/s.
* :func:`hbm_stress` — a STREAM-triad chain over device memory; reports
  GiB/s (3 streams per element per pass).
* :func:`init_mlp_params` / :func:`_mlp_loss` — the flagship forward step
  that ``tpu_operator_torch.entry.entry()`` runs: bf16 operands, f32
  products on the tensor-core kernel (``ops.MatmulBf16F32``).

These take an explicit ``device``: ``"cuda"`` unless the caller asks for
``"cpu"``, where the kernels' plain versions run (the parity tests).  On the
card the burn-in and triad chains replay captured units of steps as CUDA
graphs (``validator/graphs.py``), where the JAX package ran a whole
``fori_loop`` chain in one dispatch, so their marginal rates are the
device's; on the CPU they run eagerly.

Multi-device (from :func:`make_mesh` on): the collective checks, the
sharded dp×tp train step and the full validation chain.  They run SPMD:
every rank of an initialised process group (``_dist``: NCCL on the cards,
gloo on the CPU) calls the same function with the same arguments and holds
only its own block — the block JAX's ``shard_map`` gives the device at its
coordinate in the mesh, row-major.  Each returns the same report on every
rank (``_dist.agree``).  Where JAX drew inputs from ``jax.random``, the port
draws them from a seeded CPU ``torch.Generator`` (then moves them to the
device), so a card and the CPU see the same numbers.

With the port's tracer on (``obs/trace.py``), ``run_full_validation`` is
the span ``validator.full`` (``expected_chips``); each level of
:func:`_escalated_marginal` is a ``validator.escalation`` span (``lo``,
``hi``, the best ``lo_s`` and ``hi_s``, ``target_s``, ``final``) and each
chain call it times a ``validator.chain`` span (``steps``, ``role``
``warm`` or ``timed``).  No span is opened per chain step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..obs import trace
from . import _dist, ops
from .graphs import ChainGraphs, chain
from .spans import ranged


@dataclasses.dataclass
class ValidationReport:
    """Result of one validation workload."""
    name: str
    ok: bool
    duration_s: float
    detail: str = ""
    value: Optional[float] = None
    # the performance floor the value was judged against (same unit as
    # value); None when the probe has no gate
    floor: Optional[float] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _fetch(t: torch.Tensor) -> np.ndarray:
    """Completion barrier: synchronise the device, then copy the (small)
    result to the host."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return t.detach().cpu().numpy()


# --------------------------------------------------------------------------
# device enumeration
# --------------------------------------------------------------------------

def device_check(expected_count: int = 0,
                 device: str = "cuda") -> ValidationReport:
    """The device type enumerates and (optionally) matches the expected
    count.  On ``cuda`` it counts the visible cards; with no usable CUDA it
    reports failure, never the CPU."""
    t0 = time.perf_counter()
    if torch.device(device).type == "cpu":
        n, kinds = 1, ["cpu"]
    else:
        try:
            if not torch.cuda.is_available():
                return ValidationReport(
                    "device", False, time.perf_counter() - t0,
                    "no CUDA device (torch.cuda.is_available() is False)")
            n = torch.cuda.device_count()
            kinds = sorted({torch.cuda.get_device_name(i) for i in range(n)})
        except RuntimeError as e:  # noqa: TPULNT104 - torch raises a CUDA driver/runtime failure as RuntimeError: the check's signal
            return ValidationReport("device", False, time.perf_counter() - t0,
                                    f"CUDA enumeration failed: {e}")
    ok = n > 0 and (expected_count == 0 or n == expected_count)
    return ValidationReport(
        "device", ok, time.perf_counter() - t0,
        f"{n} device(s) of kind {kinds}"
        + (f", expected {expected_count}" if expected_count else ""),
        value=float(n))


# --------------------------------------------------------------------------
# tensor-core burn-in
# --------------------------------------------------------------------------

def _burn_in_step(acc: torch.Tensor, w: torch.Tensor, block: int,
                  kt: int) -> torch.Tensor:
    """One step of the burn-in chain: the bf16 product with an f32 result,
    normalised to stop overflow, then back to bf16 for the next product."""
    out = ops.matmul_bf16_f32(acc, w, kt=kt, block=block)
    out = out / (out.abs().max() + 1e-6)
    return out.bfloat16()


def _burn_in_fn(x: torch.Tensor, w: torch.Tensor, iters: int,
                block: Optional[int] = None, kt: int = 0,
                graphs: Optional[ChainGraphs] = None) -> torch.Tensor:
    """Chained bf16 products with f32 results and a renormalisation — keeps
    the tensor cores busy and yields a value-dependent checksum so silent
    corruption surfaces.  ``block``/``kt`` pick the kernel's tiling (block
    defaults to ``ops.matmul_block``'s for the size and the card, 64 where
    that does not divide it); the microbench's matmul chain is this
    function at the probe's tiling.  On the card the chain
    replays through ``graphs`` (one of its own where None is given)."""
    if block is None:
        block = ops.matmul_block(x.shape[0], w.shape[1],
                                 ops.sm_count(x.device))
        if x.shape[0] % block or w.shape[1] % block:
            block = 64

    def step(acc: torch.Tensor) -> torch.Tensor:
        return _burn_in_step(acc, w, block, kt)

    if x.is_cuda:
        acc = chain(graphs, ("burn-in", w.data_ptr(), tuple(w.shape), block,
                             kt), step, x, iters)
    else:
        acc = x
        for _ in range(iters):
            acc = step(acc)
    return acc.float().sum()


# a marginal timing window below this is indistinguishable from launch and
# synchronisation jitter — escalate until cleared
_MIN_MARGINAL_WINDOW_S = 0.05


def _timed_min(run, n: int, k: int = 2):
    """Best-of-k wall time of ``run(n)`` (the first, untimed call builds the
    kernels and warms the allocator; min discards positive noise).  The
    completion barrier is the synchronise plus the fetch of the small
    result.  Returns (best_seconds, fetched results)."""
    with ranged(trace.span("validator.chain", {"steps": n, "role": "warm"})):
        _fetch(run(n))
    best, vals = float("inf"), []
    for _ in range(k):
        with ranged(trace.span("validator.chain",
                               {"steps": n, "role": "timed"})):
            t0 = time.perf_counter()
            v = _fetch(run(n))
            best = min(best, time.perf_counter() - t0)
        vals.append(v)
    return best, vals


def _escalated_marginal(run, lo: int, cap: int):
    """Marginal wall time between a lo- and a hi-length chain, escalating
    hi x64 until the window clears jitter (or hi would exceed ``cap``).  lo
    is re-timed with every hi level so one inflated baseline cannot bias
    every marginal.  Returns (marginal_s, hi, hi_wall_s, hi results)."""
    hi = lo
    while True:
        hi *= 64
        target = _MIN_MARGINAL_WINDOW_S
        with ranged(trace.span("validator.escalation", {
                "lo": lo, "hi": hi, "target_s": target})) as span:
            dt_lo, _ = _timed_min(run, lo)
            dt, vals = _timed_min(run, hi)
            final = dt - dt_lo > target or hi * 64 > cap
            span.set_attr("lo_s", dt_lo)
            span.set_attr("hi_s", dt)
            span.set_attr("final", final)
        if final:
            return dt - dt_lo, hi, dt, vals


def matmul_burn_in(size: int = 1024, iters: int = 8, seed: int = 0,
                   device: str = "cuda") -> ValidationReport:
    """bf16 product chain on one card; checks the result is finite and
    deterministic across two runs.  Reports achieved TFLOP/s (marginal
    rate, launch cost included) as the value.  ``size`` must be a multiple
    of 64."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((size, size), generator=g, device=device,
                    dtype=torch.bfloat16)
    w = torch.randn((size, size), generator=g, device=device,
                    dtype=torch.bfloat16)
    lo = iters
    with ChainGraphs() as graphs:
        marginal, hi, dt, vals = _escalated_marginal(
            lambda n: _burn_in_fn(x, w, n, graphs=graphs), lo, iters * 65536)
    # the two timed executions double as the determinism pair
    a_val, b_val = (float(v) for v in vals[-2:])
    finite = bool(np.isfinite(a_val))
    deterministic = a_val == b_val
    flops = 2.0 * size * size * size * (hi - lo)
    tflops = flops / marginal / 1e12 if marginal > 1e-5 else 0.0
    ok = finite and deterministic
    detail = (f"checksum={a_val:.6g} "
              f"{'deterministic' if deterministic else f'NONDETERMINISTIC ({b_val:.6g})'}"
              f", {tflops:.2f} TFLOP/s over {size}^2 x {hi}")
    return ValidationReport("matmul-burn-in", ok, dt, detail, value=tflops)


# --------------------------------------------------------------------------
# device-memory stress
# --------------------------------------------------------------------------

def _triad_step(acc: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One triad pass acc = acc*0.25 + c, in acc's storage: one fused
    ``torch.add`` reading acc and c and writing acc — 3 streams, the count
    the GiB/s figure assumes."""
    return torch.add(c, acc, alpha=0.25, out=acc)


def _triad_chain(b: torch.Tensor, c: torch.Tensor, reps: int,
                 graphs: Optional[ChainGraphs] = None) -> torch.Tensor:
    """reps dependent triad passes acc = acc*0.25 + c starting from b (left
    intact); scale 0.25 keeps the fixed point bounded (8/3).  On the card
    the chain replays through ``graphs`` (one of its own where None is
    given)."""
    def step(acc: torch.Tensor) -> torch.Tensor:
        return _triad_step(acc, c)

    if b.is_cuda:
        return chain(graphs, ("stress", c.data_ptr(), tuple(c.shape)), step,
                     b, reps)[:8].clone()
    acc = b.clone()
    for _ in range(reps):
        acc = step(acc)
    return acc[:8]


def hbm_stress(mib: int = 256, iters: int = 4,
               device: str = "cuda") -> ValidationReport:
    """STREAM-triad style device-memory pass: checks correctness and reports
    achieved GiB/s (3 streams — 2 reads + 1 write — per element per pass),
    timed as the marginal rate between a short and a long chain."""
    if torch.device(device).type == "cuda":
        # each array must exceed the H100's 50 MB L2, or the chain runs from
        # cache and this measures L2 bandwidth: 128 MiB is well above it
        mib = max(mib, 128)
    n = mib * 1024 * 1024 // 4  # float32 elements
    b = torch.full((n,), 1.5, dtype=torch.float32, device=device)
    c = torch.full((n,), 2.0, dtype=torch.float32, device=device)
    lo = iters
    with ChainGraphs() as graphs:
        marginal, hi, dt, vals = _escalated_marginal(
            lambda r: _triad_chain(b, c, r, graphs), lo, iters * 4096)
    sample = vals[-1]
    # fixed point of x = x*0.25 + 2.0 is 8/3; after a few passes any start
    # value has converged to it
    ok = bool(np.allclose(sample, 8.0 / 3.0, rtol=1e-3))
    gib = 3.0 * n * 4 * (hi - lo) / (1024 ** 3)
    gibs = gib / marginal if marginal > 1e-5 else 0.0
    return ValidationReport("hbm-stress", ok, dt,
                            f"{gibs:.1f} GiB/s over {mib} MiB x {hi}",
                            value=gibs)


# --------------------------------------------------------------------------
# flagship forward step (the MLP of the slice burn-in)
# --------------------------------------------------------------------------

def init_mlp_params(generator: torch.Generator, d_in: int = 128,
                    d_hidden: int = 256,
                    d_out: int = 128) -> Dict[str, torch.Tensor]:
    """Random f32 MLP weights on ``generator``'s device, scaled 1/sqrt(d_in)."""
    scale = 1.0 / np.sqrt(d_in)
    dev = generator.device
    return {
        "w1": torch.randn((d_in, d_hidden), generator=generator,
                          device=dev) * scale,
        "w2": torch.randn((d_hidden, d_out), generator=generator,
                          device=dev) * scale,
    }


def mlp_params_from_numpy(params: Dict[str, np.ndarray],
                          device: str = "cuda") -> Dict[str, torch.Tensor]:
    """Copy MLP weights given as numpy arrays (e.g. the JAX package's
    ``init_mlp_params`` output) into the port as f32 tensors."""
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                            device=device) for k, v in params.items()}


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, held in f32 (its backward rounds the gradient
    to bf16, as JAX's transpose of ``astype(bfloat16)`` does)."""
    return t.bfloat16().float()


def _mlp_loss(params: Dict[str, torch.Tensor], x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """tanh MLP + mean squared error, with the JAX step's bf16 inputs and
    f32 products: operands are rounded to bf16 and multiplied with f32
    results on the tensor-core kernel (``ops.MatmulBf16F32``)."""
    matmul = ops.MatmulBf16F32.apply
    h = torch.tanh(matmul(_bf16(x), _bf16(params["w1"])))
    out = matmul(_bf16(h), _bf16(params["w2"]))
    return torch.mean((out - y) ** 2)


# --------------------------------------------------------------------------
# mesh construction and the helpers every multi-device check shares
# --------------------------------------------------------------------------

def default_mesh_shape(n: int) -> Tuple[int, int]:
    """The default mesh over n devices: (n // k, k) with k the largest power
    of two ≤ sqrt(n) dividing n, the larger factor on ``data`` (the JAX
    package's rule)."""
    k = 1
    while (k * 2 <= int(np.sqrt(n)) + 1 and n % (k * 2) == 0
           and (k * 2) ** 2 <= n):
        k *= 2
    return (n // k, k)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("data", "model")) -> DeviceMesh:
    """A DeviceMesh over every rank of the group, rank r at r's row-major
    coordinate; default shape :func:`default_mesh_shape` (a caller that
    knows the node's topology passes ``shape``).  Every rank must call it,
    with the same arguments."""
    n = dist.get_world_size()
    shape = tuple(shape) if shape is not None else default_mesh_shape(n)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    return init_device_mesh(_dist.device().type, shape,
                            mesh_dim_names=tuple(axis_names[:len(shape)]))


def _all_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _axis(mesh: DeviceMesh, axis: str):
    """(group, this rank's position, size) along ``axis``."""
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


def _flat_index(mesh: DeviceMesh) -> int:
    """Row-major index of this rank's coordinate: which block of an array
    laid out as ``P(*axes)`` it holds."""
    return int(np.ravel_multi_index(mesh.get_coordinate(), mesh.shape))


def _clock(dev: torch.device) -> float:
    """Host time once the device has finished what was queued on it."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _warm(mesh: DeviceMesh) -> None:
    """One untimed all-reduce on each of the mesh's groups, finished.  NCCL
    sets a group's communicator up at its first collective (seconds on
    several cards), and every check starts its clock only after this."""
    dev = _dist.device()
    t = torch.zeros(1, device=dev)
    for ax in _all_axes(mesh):
        dist.all_reduce(t, group=mesh.get_group(ax))
    _clock(dev)


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's ``t`` concatenated along dim 0, in group order (a tiled
    ``all_gather``)."""
    out = t.new_empty((dist.get_world_size(group) * t.shape[0],
                       *t.shape[1:]))
    _dist.all_gather_into(out, t.contiguous(), group=group)
    return out


def _ring_hop(mesh: DeviceMesh, axis: str,
              *ts: torch.Tensor) -> List[torch.Tensor]:
    """One hop of a ring along ``axis``: position i sends each of ``ts`` to
    i+1 and returns what came from i-1 (``ppermute`` with the perm
    [(i, i+1 mod n)]).  On a 1-long axis the hop is a copy: nothing is
    posted to self."""
    group, me, n = _axis(mesh, axis)
    if n == 1:
        return [t.clone() for t in ts]
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    outs = [torch.empty_like(t) for t in ts]
    p2p = []
    for t, out in zip(ts, outs):
        p2p += [dist.P2POp(dist.isend, t.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, out, prv, group)]
    for work in dist.batch_isend_irecv(p2p):
        work.wait()
    return outs


# --------------------------------------------------------------------------
# collective checks (the psum north-star workload, over NCCL)
# --------------------------------------------------------------------------

def ici_psum_check(mesh: Optional[DeviceMesh] = None) -> ValidationReport:
    """All-reduce over every mesh axis in turn: the rank at flat position i
    contributes i+1; every rank must then hold n(n+1)/2.  Proves the
    all-reduce reaches every card (the BASELINE.json north star)."""
    mesh = make_mesh() if mesh is None else mesh
    n, axes, dev = mesh.size(), _all_axes(mesh), _dist.device()
    y = torch.tensor([_flat_index(mesh) + 1.0], device=dev)
    _warm(mesh)
    t0 = _clock(dev)
    for ax in axes:
        dist.all_reduce(y, group=mesh.get_group(ax))
    dt = _clock(dev) - t0
    got = np.unique(_gather(y, None).cpu().numpy())   # what the ranks hold
    want = n * (n + 1) / 2.0
    ok = got.size == 1 and float(got[0]) == want
    rep = _dist.agree(ValidationReport("nccl-psum", ok, dt, value=float(n)))
    rep.detail = (f"psum over {n} devices (mesh "
                  f"{dict(zip(axes, mesh.shape))}): got {got.tolist()}, "
                  f"want [{want}]")
    return rep


def ici_ring_check(mesh: Optional[DeviceMesh] = None,
                   axis: Optional[str] = None) -> ValidationReport:
    """Send/recv ring: every rank passes its id one hop along the axis, n
    times — the id returns home only if EVERY point-to-point link on the
    ring works (an all-reduce can mask a weak link; this cannot)."""
    mesh = make_mesh() if mesh is None else mesh
    axis = axis or mesh.mesh_dim_names[0]
    n_axis = _axis(mesh, axis)[2]
    dev = _dist.device()
    ids = torch.tensor([float(_flat_index(mesh))], device=dev)
    _warm(mesh)
    t0 = _clock(dev)
    v = ids
    for _ in range(n_axis):
        (v,) = _ring_hop(mesh, axis, v)
    dt = _clock(dev) - t0
    rep = _dist.agree(ValidationReport("nccl-ring", bool(torch.equal(v, ids)),
                                       dt, value=float(n_axis)))
    rep.detail = (f"{n_axis}-hop send/recv ring on axis '{axis}' "
                  f"{'returned home' if rep.ok else 'CORRUPTED'}")
    return rep


def ici_all_gather_check(mesh: Optional[DeviceMesh] = None
                         ) -> ValidationReport:
    """Tiled all_gather over every axis in turn: each rank must then see
    every rank's contribution exactly once (catches duplicated or dropped
    shards)."""
    mesh = make_mesh() if mesh is None else mesh
    n, axes, dev = mesh.size(), _all_axes(mesh), _dist.device()
    y = torch.tensor([float(_flat_index(mesh))], device=dev)
    _warm(mesh)
    t0 = _clock(dev)
    for ax in axes:
        y = _gather(y, mesh.get_group(ax))
    dt = _clock(dev) - t0
    flat = np.unique(y.cpu().numpy())
    ok = bool(np.array_equal(flat, np.arange(float(n))))
    rep = _dist.agree(ValidationReport("nccl-all-gather", ok, dt,
                                       value=float(flat.size)), worst=min)
    rep.detail = f"gathered {int(rep.value)}/{n} distinct shards"
    return rep


def multihost_allreduce_check(processes: int = 0,
                              per_process_elems: int = 64
                              ) -> ValidationReport:
    """The gang-readiness collective over a VIRTUAL multi-process mesh.

    The world is reshaped to ``(process, chip)``, the leading axis standing
    for the gang's hosts; the row-sharded ``arange`` is laid out as JAX's
    ``P("process", "chip")`` places it (row p = process p's contribution,
    column block c on its chip c), and the global sum is reduced over both
    axes.  Distinct per-element contributions make dropped or duplicated
    shards change the sum, and every rank must hold the result (the
    replicated output of JAX's jit)."""
    n, dev = dist.get_world_size(), _dist.device()
    t0 = time.perf_counter()
    if processes <= 0:
        # default gang shape: the leading axis of the standard mesh
        processes = default_mesh_shape(n)[0]
    if processes < 1 or n % processes:
        return ValidationReport(
            "multihost-allreduce", False, time.perf_counter() - t0,
            f"{n} device(s) not divisible into {processes} virtual "
            f"process(es)")
    chips = n // processes
    mesh = make_mesh((processes, chips), ("process", "chip"))
    elems = processes * chips * per_process_elems
    p, c = mesh.get_coordinate()
    start = (p * chips + c) * per_process_elems + 1
    total = torch.arange(start, start + per_process_elems,
                         dtype=torch.float32, device=dev).sum().reshape(1)
    _warm(mesh)
    t0 = _clock(dev)
    for ax in ("process", "chip"):
        dist.all_reduce(total, group=mesh.get_group(ax))
    held = _gather(total, None).cpu().numpy()         # every rank's copy
    dt = time.perf_counter() - t0
    got, want = float(held[0]), elems * (elems + 1) / 2.0
    replicated = bool(np.all(held == got))
    rep = _dist.agree(ValidationReport(
        "multihost-allreduce", got == want and replicated, dt,
        value=float(processes)))
    rep.detail = (f"global sum over {processes} virtual process(es) x "
                  f"{chips} chip(s): got {got:g}, want {want:g}"
                  + ("" if replicated else " (result NOT on every rank)"))
    return rep


def ep_all_to_all_check(mesh: Optional[DeviceMesh] = None,
                        tokens_per_peer: int = 8) -> ValidationReport:
    """Expert-parallel dispatch: ``all_to_all`` over the last (expert) mesh
    axis — every rank exchanges a distinct shard with every other at once.
    Rank k sends block j stamped ``k*n + j``; a correct exchange leaves rank
    k holding ``j*n + k`` from every j — any misrouted, duplicated or
    dropped shard breaks the stamp.  The verdict is the MAX over every
    rank."""
    if mesh is None:
        mesh = make_mesh((dist.get_world_size(),), ("expert",))
    axis = mesh.mesh_dim_names[-1]      # the EP axis by convention
    group, k, n_axis = _axis(mesh, axis)
    dev = _dist.device()
    j = torch.arange(float(n_axis), device=dev)
    blk = (k * n_axis + j)[:, None].expand(n_axis, tokens_per_peer).contiguous()
    _warm(mesh)
    t0 = _clock(dev)
    out = torch.empty_like(blk)
    dist.all_to_all_single(out, blk, group=group)
    err = float((out - (j * n_axis + k)[:, None]).abs().max())
    dt = time.perf_counter() - t0
    rep = _dist.agree(ValidationReport(
        "ep-all-to-all", bool(np.isfinite(err)) and err == 0.0, dt,
        value=err))
    rep.detail = (f"all_to_all over {n_axis}-way '{axis}' axis: "
                  f"max|err|={rep.value:g}")
    rep.value = float(n_axis)
    return rep


def pp_pipeline_check(mesh: Optional[DeviceMesh] = None,
                      microbatches: int = 6, d: int = 8) -> ValidationReport:
    """Pipeline-parallel handoff: a GPipe-style microbatch pipeline where
    stage s applies the NON-commutative affine ``v -> v*(s+1) + s`` and
    hands off to stage s+1 only.  The drained outputs must equal the stages
    composed in order — a swapped, skipped or doubled hop changes the
    result."""
    if mesh is None:
        mesh = make_mesh((dist.get_world_size(),), ("stage",))
    if mesh.ndim != 1:
        return ValidationReport("pp-pipeline", False, 0.0,
                                "pipeline check needs a 1-axis mesh")
    group, s, stages = _axis(mesh, mesh.mesh_dim_names[0])
    m, dev = microbatches, _dist.device()
    xs = torch.arange(float(m * d), device=dev).reshape(m, d) / (m * d)
    nxt = dist.get_global_rank(group, s + 1) if s < stages - 1 else None
    prv = dist.get_global_rank(group, s - 1) if s > 0 else None
    buf, outs = torch.zeros(d, device=dev), torch.zeros((m, d), device=dev)
    _warm(mesh)
    t0 = _clock(dev)
    for t in range(stages + m - 1):
        cur = xs[min(t, m - 1)] if s == 0 else buf
        y = cur * (s + 1.0) + s              # this stage's compute
        out_idx = t - (stages - 1)
        if s == stages - 1 and 0 <= out_idx < m:
            outs[out_idx] = y
        # hand off downstream; stage 0's buffer reads zero, as an unsourced
        # ppermute receiver does
        buf = torch.zeros_like(y)
        p2p = ([dist.P2POp(dist.isend, y, nxt, group)] if nxt is not None
               else []) + ([dist.P2POp(dist.irecv, buf, prv, group)]
                           if prv is not None else [])
        if p2p:
            for work in dist.batch_isend_irecv(p2p):
                work.wait()
    err = 0.0
    if s == stages - 1:                  # the drained output lives here
        want = xs.cpu().numpy()
        for st in range(stages):
            want = want * (st + 1.0) + st
        err = float(np.max(np.abs(outs.cpu().numpy() - want)))
    dt = time.perf_counter() - t0
    rep = _dist.agree(ValidationReport(
        "pp-pipeline", bool(np.isfinite(err)) and err < 1e-5, dt, value=err))
    rep.detail = (f"{stages}-stage pipeline, {m} microbatches: "
                  f"max|err|={rep.value:g}")
    rep.value = float(stages)
    return rep


def _attention_reference(q: np.ndarray, k: np.ndarray,
                         v: np.ndarray) -> np.ndarray:
    """Unsharded softmax attention of (seq, d) arrays on the host."""
    s = (q @ k.T) / np.float32(np.sqrt(q.shape[1]))
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return (p / p.sum(axis=1, keepdims=True)) @ v


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sequence-parallel blockwise attention of the full ``(seq, d)`` q, k
    and v: this rank keeps the sequence block at its position along
    ``axis``, the K/V blocks travel the ring one hop per step while an
    online softmax (running max, normaliser, output) folds each one in.
    Returns the full output, gathered along ``axis``, on the group's
    device."""
    group, i, n = _axis(mesh, axis)
    dev = _dist.device()
    spd = q.shape[0] // n
    q_blk, k_cur, v_cur = (t[i * spd:(i + 1) * spd].to(dev) for t in (q, k, v))
    scale = 1.0 / float(np.sqrt(q.shape[1]))
    m = torch.full((spd, 1), -torch.inf, device=dev)
    l = torch.zeros((spd, 1), device=dev)
    o = torch.zeros_like(q_blk)
    # full f32 products (JAX's Precision.HIGHEST): this is a correctness
    # gate against an f32 host reference, which TF32 would miss by ~1e-3
    with ops.no_tf32():
        for step in range(n):
            s = (q_blk @ k_cur.T) * scale
            m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=1, keepdim=True)
            o = o * corr + p @ v_cur
            m = m_new
            if step < n - 1:     # a last hop would only bring K/V home
                k_cur, v_cur = _ring_hop(mesh, axis, k_cur, v_cur)
    return _gather(o / l, group)


def ring_attention_check(mesh: Optional[DeviceMesh] = None,
                         seq_per_device: int = 32, d_head: int = 32,
                         axis: Optional[str] = None) -> ValidationReport:
    """Ring attention over the send/recv ring — the long-context health
    check.  The sharded result must match full attention computed unsharded
    on the host, so a corrupted link or a dropped block shows up as a
    numeric mismatch, not just a hang."""
    mesh = make_mesh() if mesh is None else mesh
    axis = axis or mesh.mesh_dim_names[0]
    n = _axis(mesh, axis)[2]
    seq = n * seq_per_device
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((seq, d_head), generator=g) for _ in range(3))
    _warm(mesh)
    t0 = _clock(_dist.device())
    out = ring_attention(q, k, v, mesh, axis).cpu().numpy()
    dt = time.perf_counter() - t0
    err = float(np.max(np.abs(out - _attention_reference(
        q.numpy(), k.numpy(), v.numpy()))))
    rep = _dist.agree(ValidationReport(
        "nccl-ring-attention", bool(np.isfinite(err) and err < 1e-4), dt,
        value=err))
    rep.detail = (f"seq {seq} over {n} devices (axis '{axis}'): "
                  f"max|err| {rep.value:.2e} vs full attention")
    return rep


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """All-to-all (Ulysses) sequence parallelism over the full
    ``(seq, heads, d)`` q, k and v, heads a multiple of the axis length:
    this rank keeps the sequence block at its position along ``axis``; one
    all_to_all trades it for the full sequence of 1/n of the heads, which it
    attends; a second trades back.  Returns the full output, gathered along
    ``axis``, on the group's device.

    JAX's tiled ``all_to_all(split_axis=1, concat_axis=0)`` has no direct
    counterpart (``all_to_all_single`` splits dim 0 only): the head chunks
    are moved to dim 0 and made contiguous, exchanged, and the sequence
    blocks that come back (in source order) are laid end to end."""
    group, i, n = _axis(mesh, axis)
    dev = _dist.device()
    seq, heads, d = q.shape
    spd, hpd = seq // n, heads // n

    def exchange(x: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    def dispatch(t: torch.Tensor) -> torch.Tensor:
        # (spd, H, d) -> chunk j = heads j*hpd.. for rank j -> (seq, hpd, d)
        x = t.permute(1, 0, 2).reshape(n, hpd, spd, d).contiguous()
        return exchange(x).permute(0, 2, 1, 3).reshape(seq, hpd, d)

    qh, kh, vh = (dispatch(t[i * spd:(i + 1) * spd].to(dev))
                  for t in (q, k, v))
    with ops.no_tf32():
        s = torch.einsum("shd,thd->hst", qh, kh) / float(np.sqrt(d))
        o = torch.einsum("hst,thd->shd", torch.softmax(s, dim=-1), vh)
    # (seq, hpd, d) -> chunk j = sequence block j for rank j; what comes
    # back from rank j is this block's heads j*hpd.. -> (spd, H, d)
    back = exchange(o.reshape(n, spd, hpd, d).contiguous())
    return _gather(back.permute(1, 0, 2, 3).reshape(spd, heads, d), group)


def ulysses_attention_check(mesh: Optional[DeviceMesh] = None,
                            seq_per_device: int = 32, d_head: int = 16,
                            axis: Optional[str] = None) -> ValidationReport:
    """The other long-context family: Ulysses all-to-all, one head per rank
    once dispatched.  Where the ring rotates K/V one hop per step, this is
    one global shuffle each way, so a link that survives the ring can still
    fail here.  Same contract: the sharded result must match host-side full
    attention."""
    mesh = make_mesh() if mesh is None else mesh
    axis = axis or mesh.mesh_dim_names[0]
    n = _axis(mesh, axis)[2]
    heads, seq = n, n * seq_per_device
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn((seq, heads, d_head), generator=g)
               for _ in range(3))
    _warm(mesh)
    t0 = _clock(_dist.device())
    out = ulysses_attention(q, k, v, mesh, axis).cpu().numpy()
    dt = time.perf_counter() - t0
    qn, kn, vn = q.numpy(), k.numpy(), v.numpy()
    # one head at a time: an all-heads score tensor would grow as n^3
    want = np.stack([_attention_reference(qn[:, h], kn[:, h], vn[:, h])
                     for h in range(heads)], axis=1)
    err = float(np.max(np.abs(out - want)))
    rep = _dist.agree(ValidationReport(
        "nccl-ulysses-attention", bool(np.isfinite(err) and err < 1e-4), dt,
        value=err))
    rep.detail = (f"seq {seq} x {heads} heads over {n} devices (axis "
                  f"'{axis}'): max|err| {rep.value:.2e} vs full attention")
    return rep


def ici_bandwidth_probe(mesh: Optional[DeviceMesh] = None,
                        mib_per_device: int = 16) -> ValidationReport:
    """Timed all-reduce of a large buffer over every axis — reports the
    achieved algorithm bandwidth 2(n-1)/n · bytes / t per rank, the number
    the ring all-reduce model predicts from link speed (0 at n = 1).  A
    warm-up call first, so NCCL's lazy setup stays out of the window; the
    value is the slowest rank's."""
    mesh = make_mesh() if mesh is None else mesh
    n, axes, dev = mesh.size(), _all_axes(mesh), _dist.device()
    elems = mib_per_device * 1024 * 1024 // 4
    x = torch.ones(elems, device=dev)

    def reduce():                  # in place: x grows by n per call
        for ax in axes:
            dist.all_reduce(x, group=mesh.get_group(ax))

    reduce()
    # every rank enters the window together: a rank that starts its clock
    # early would time its wait for the others as transfer
    dist.barrier()
    t0 = _clock(dev)
    reduce()
    dt = _clock(dev) - t0
    algo_bw = ((2.0 * (n - 1) / n) * elems * 4 / dt / 1e9) if dt > 0 else 0.0
    rep = _dist.agree(ValidationReport(
        "nccl-bandwidth", bool(torch.isfinite(x[0])), dt, value=algo_bw),
        worst=min)
    rep.detail = (f"{rep.value:.2f} GB/s algo-bw, {n} devices, "
                  f"{mib_per_device} MiB/device")
    return rep


def dcn_multislice_check(mesh: Optional[DeviceMesh] = None,
                         n_slices: int = 2,
                         elems: int = 2048) -> ValidationReport:
    """Hierarchical multislice all-reduce — the megascale pattern on a
    ("dcn", "ici") mesh: reduce-scatter within the slice, all-reduce of the
    scattered shard across slices (only 1/|ici| of the bytes cross the slow
    axis), all-gather back within the slice.  Per-rank distinguishable
    contributions: the result must equal the global elementwise sum
    exactly, so a dead cross-slice path fails the equality."""
    if mesh is None:
        n = dist.get_world_size()
        if n % n_slices or n // n_slices < 1:
            return ValidationReport(
                "dcn-multislice", False, 0.0,
                f"{n} devices not divisible into {n_slices} slices")
        mesh = make_mesh((n_slices, n // n_slices), ("dcn", "nccl"))
    n_dcn, n_ici = mesh.shape
    n, dev = mesh.size(), _dist.device()
    # elems must tile over the ici axis for the scatter phase
    elems = max(n_ici, elems // n_ici * n_ici)
    base = torch.arange(elems, dtype=torch.float32, device=dev)
    _warm(mesh)
    t0 = _clock(dev)
    shard = base.new_empty(elems // n_ici)
    _dist.reduce_scatter_into(shard, base + (_flat_index(mesh) + 1.0),
                              group=mesh.get_group("nccl"))
    dist.all_reduce(shard, group=mesh.get_group("dcn"))
    full = _gather(shard, mesh.get_group("nccl"))
    err = float((full - (n * base + n * (n + 1) / 2.0)).abs().max())
    dt = time.perf_counter() - t0
    rep = _dist.agree(ValidationReport(
        "dcn-multislice", bool(np.isfinite(err)) and err == 0.0, dt,
        value=err))
    rep.detail = (f"hierarchical allreduce over {n_dcn} slices x {n_ici} "
                  f"hosts: max|err|={rep.value:g}")
    rep.value = float(n_dcn)
    return rep


# --------------------------------------------------------------------------
# sharded training step (slice burn-in: tensor cores + memory + NCCL)
# --------------------------------------------------------------------------

class _SumOverGroup(torch.autograd.Function):
    """Megatron's g: the model shards' partial outputs summed by an
    all-reduce; the gradient passes through unchanged (each shard's partial
    gets the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _model_axis(mesh: DeviceMesh) -> Optional[str]:
    axes = _all_axes(mesh)
    return axes[1] if len(axes) > 1 else None


def _shard(t: torch.Tensor, mesh: DeviceMesh, axis: Optional[str],
           dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` under ``axis``; all of
    ``t`` when ``axis`` is None (replicated)."""
    if axis is None:
        return t
    _, i, n = _axis(mesh, axis)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"{n} ways over '{axis}'")
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size).contiguous()


def sharded_params_from_numpy(params: Dict[str, np.ndarray],
                              mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """This rank's shards of full MLP weights given as numpy arrays (e.g.
    the JAX package's ``init_mlp_params`` output): ``w1`` by columns and
    ``w2`` by rows over ``model``, replicated over ``data``; f32 on the
    group's device."""
    full, model, dev = mlp_params_from_numpy(params, device="cpu"), \
        _model_axis(mesh), _dist.device()
    return {"w1": _shard(full["w1"], mesh, model, 1).to(dev),
            "w2": _shard(full["w2"], mesh, model, 0).to(dev)}


def sharded_batch_from_numpy(x: np.ndarray, y: np.ndarray,
                             mesh: DeviceMesh
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's rows of a full batch: sharded over ``data``, replicated
    over ``model``; f32 on the group's device."""
    data, dev = _all_axes(mesh)[0], _dist.device()
    return tuple(_shard(torch.tensor(np.asarray(a), dtype=torch.float32),
                        mesh, data, 0).to(dev) for a in (x, y))


def sharded_train_step(mesh: DeviceMesh, d_in: int = 128, d_hidden: int = 256,
                       batch_per_device: int = 8, lr: float = 1e-2):
    """One dp×tp training step of the small MLP over the mesh, with
    explicit collectives: batch sharded over ``data``, the hidden dim of
    both weights over ``model`` (``w1`` by columns, ``w2`` by rows), so a
    step runs the two products, an all-reduce of the activations over
    ``model`` (tp) and of the gradients over ``data`` (dp).  The products
    take bf16-rounded operands with f32 results on the tensor-core kernel,
    forward and backward (``ops.MatmulBf16F32``: two products forward,
    three backward — no gradient of ``x``), as JAX's step runs them on the
    MXU.  The loss is the global batch's mean, and the update ``p - lr·g``
    is ``jax.value_and_grad`` of it.  Returns ``(step_fn, params, batch)``
    with this rank's shards; callers run ``step_fn(params, *batch)`` ->
    ``(loss, new_params)``."""
    data_group = mesh.get_group(_all_axes(mesh)[0])
    model = _model_axis(mesh)
    model_group = mesh.get_group(model) if model is not None else None
    params = init_mlp_params(torch.Generator().manual_seed(0), d_in,
                             d_hidden, d_in)
    g = torch.Generator().manual_seed(1)
    rows = batch_per_device * mesh.shape[0]
    x, y = (torch.randn((rows, d_in), generator=g) for _ in range(2))
    params = sharded_params_from_numpy(
        {k: p.numpy() for k, p in params.items()}, mesh)
    batch = sharded_batch_from_numpy(x.numpy(), y.numpy(), mesh)

    def step(params, x, y):
        # the bf16-rounded weights are the leaves: their f32 gradients are
        # summed over data, then rounded (the transpose of the bf16 cast),
        # in the order of JAX's partitioned program
        leaves = {k: _bf16(p).requires_grad_() for k, p in params.items()}
        matmul = ops.MatmulBf16F32.apply
        h = torch.tanh(matmul(_bf16(x), leaves["w1"]))
        out = matmul(_bf16(h), leaves["w2"])
        if model_group is not None:
            out = _SumOverGroup.apply(out, model_group)
        loss = ((out - y) ** 2).sum() / (rows * y.shape[1])
        loss.backward()
        new = {}
        for k, p in params.items():
            grad = leaves[k].grad
            dist.all_reduce(grad, group=data_group)
            new[k] = p - lr * _bf16(grad)
        loss = loss.detach()
        dist.all_reduce(loss, group=data_group)
        return loss, new

    return step, params, batch


def slice_burn_in(mesh: Optional[DeviceMesh] = None,
                  steps: int = 3) -> ValidationReport:
    """A few sharded train steps; the loss must be finite and strictly
    decrease — a functional check of the node's tensor cores (every product
    of the step on the matmul kernel), memory and NCCL together."""
    mesh = make_mesh() if mesh is None else mesh
    step, params, (x, y) = sharded_train_step(mesh)
    _warm(mesh)
    t0 = _clock(_dist.device())
    losses: List[float] = []
    for _ in range(steps):
        loss, params = step(params, x, y)
        losses.append(float(loss))
    dt = time.perf_counter() - t0
    finite = all(np.isfinite(l) for l in losses)
    decreasing = all(b < a for a, b in zip(losses, losses[1:]))
    rep = _dist.agree(ValidationReport(
        "slice-burn-in", finite and decreasing, dt,
        value=losses[-1] if losses else None))
    rep.detail = (f"{steps} dp×tp train steps, loss {losses[0]:.4f} → "
                  f"{losses[-1]:.4f}{'' if decreasing else ' (NOT decreasing)'}")
    return rep


# --------------------------------------------------------------------------
# full suite
# --------------------------------------------------------------------------

def run_full_validation(mesh: Optional[DeviceMesh] = None,
                        expected_chips: int = 0,
                        quick: bool = False) -> List[ValidationReport]:
    """The validator's full workload chain in barrier order (device →
    compute → interconnect → end to end), on every rank of the group.  As
    JAX runs the single-device legs on its default device, rank 0 runs
    ``device_check``, ``matmul_burn_in`` and ``hbm_stress`` on its card and
    every rank returns rank 0's reports for them; the collective legs run
    on every rank."""
    with ranged(trace.span_or_root("validator.full",
                                   {"expected_chips": expected_chips})):
        dev = _dist.device()
        reports = None
        if dist.get_rank() == 0:
            reports = [device_check(expected_chips, device=dev.type)]
            if reports[0].ok:
                reports.append(matmul_burn_in(size=256 if quick else 1024,
                                              device=dev))
                reports.append(hbm_stress(mib=32 if quick else 256,
                                          device=dev))
        shared = [reports]
        dist.broadcast_object_list(shared, src=0)
        reports = shared[0]
        if not reports[0].ok:
            return reports
        mesh = make_mesh() if mesh is None else mesh
        if mesh.size() > 1:
            reports.append(ici_psum_check(mesh))
            reports.append(ici_ring_check(mesh))
            reports.append(ici_all_gather_check(mesh))
            reports.append(ring_attention_check(mesh))
            # the gang-readiness collective over a virtual multi-process
            # mesh shaped like the slice's host axis
            reports.append(
                multihost_allreduce_check(processes=mesh.shape[0]))
        reports.append(slice_burn_in(mesh))
        return reports
