"""Rank functions of the port's multi-device parity tests.

``tpu_operator_torch.validator._dist.spawn`` runs one of these on every
gloo rank; each new rank process imports this module by name, so it
imports torch and the port only — no JAX, which the tests hold the results
against in the parent process.  Each function returns what rank 0 saw.
"""

import contextlib
import warnings

import torch
import torch.distributed as dist

from tpu_operator_torch.validator import _dist, ops, workloads as wl


def _train_parity(params, x, y, want_params, steps):
    """``steps`` sharded steps of the port from the JAX package's weights
    and batch on a (4, 2) mesh; returns the losses and the largest gap of
    any rank's updated shard to the same shard of JAX's updated weights."""
    mesh = wl.make_mesh((4, 2))
    step, _, _ = wl.sharded_train_step(mesh)
    p = wl.sharded_params_from_numpy(params, mesh)
    xs, ys = wl.sharded_batch_from_numpy(x, y, mesh)
    losses = []
    for _ in range(steps):
        loss, p = step(p, xs, ys)
        losses.append(float(loss))
    want = wl.sharded_params_from_numpy(want_params, mesh)
    gap = torch.tensor(max(float((p[k] - want[k]).abs().max()) for k in p),
                       dtype=torch.float64)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return {"losses": losses, "param_gap": float(gap)}


def _step_matmul_calls():
    """How many times one sharded step on a (4, 2) mesh calls the matmul
    kernel's wrapper, on each rank (on the CPU the wrapper runs its plain
    version, which ``ops.LAUNCHES`` does not count)."""
    calls, inner = [0], ops.matmul_bf16_f32

    def counting(*args, **kwargs):
        calls[0] += 1
        return inner(*args, **kwargs)

    step, p, (x, y) = wl.sharded_train_step(wl.make_mesh((4, 2)))
    ops.matmul_bf16_f32 = counting
    try:
        step(p, x, y)
    finally:
        ops.matmul_bf16_f32 = inner
    held = [None] * dist.get_world_size()
    dist.all_gather_object(held, calls[0])
    return held


def mesh_2d(ring_qkv, ulysses_qkv, train):
    """Every case of the parity suite on 2-D meshes, 8 ranks."""
    out = {}
    mesh = wl.make_mesh()
    out["default_shape"] = mesh.shape
    out["default_layout"] = mesh.mesh.tolist()
    try:
        wl.make_mesh((3, 2))
    except ValueError as e:
        out["bad_shape"] = str(e)
    mesh = wl.make_mesh((4, 2))
    out["psum"] = wl.ici_psum_check(mesh)
    out["ring"] = wl.ici_ring_check(mesh, axis="data")
    out["all_gather"] = wl.ici_all_gather_check(mesh)
    out["bandwidth"] = wl.ici_bandwidth_probe(mesh, mib_per_device=1)
    for processes in (4, 8, 0, 3):
        out[f"multihost_{processes}"] = wl.multihost_allreduce_check(
            processes=processes)
    out["ep"] = wl.ep_all_to_all_check(
        wl.make_mesh((2, 4), axis_names=("data", "expert")))
    out["pp"] = wl.pp_pipeline_check()
    out["pp_2axis"] = wl.pp_pipeline_check(mesh)
    out["ring_attention"] = wl.ring_attention_check(mesh)
    out["ring_attention_out"] = wl.ring_attention(
        *map(torch.from_numpy, ring_qkv), mesh, "data").numpy()
    out["ulysses"] = wl.ulysses_attention_check(mesh)
    out["ulysses_out"] = wl.ulysses_attention(
        *map(torch.from_numpy, ulysses_qkv), mesh, "data").numpy()
    for n_slices in (2, 4, 3):
        out[f"dcn_{n_slices}"] = wl.dcn_multislice_check(n_slices=n_slices)
    out["train"] = _train_parity(*train)
    out["step_matmul_calls"] = _step_matmul_calls()
    small = wl.make_mesh((4, 2))
    step, p, (x, y) = wl.sharded_train_step(small, d_in=16, d_hidden=32,
                                            batch_per_device=2)
    l0, p = step(p, x, y)
    l1, _ = step(p, x, y)
    out["small_step_losses"] = [float(l0), float(l1)]
    out["slice_burn_in"] = wl.slice_burn_in(mesh, steps=3)
    out["full"] = wl.run_full_validation(quick=True)
    return out


def mesh_flat(ring_qkv, ulysses_qkv):
    """The parity cases on 1-D and (8, 1) meshes, 8 ranks."""
    out = {}
    out["ring"] = wl.ici_ring_check(wl.make_mesh((8,), axis_names=("data",)))
    mesh = wl.make_mesh((8, 1))
    out["ring_attention"] = wl.ring_attention_check(
        mesh, seq_per_device=16, d_head=16)
    out["ring_attention_out"] = wl.ring_attention(
        *map(torch.from_numpy, ring_qkv), mesh, "data").numpy()
    out["ulysses"] = wl.ulysses_attention_check(
        mesh, seq_per_device=16, d_head=16)
    out["ulysses_out"] = wl.ulysses_attention(
        *map(torch.from_numpy, ulysses_qkv), mesh, "data").numpy()
    out["ep"] = wl.ep_all_to_all_check()
    out["agree"] = {name: _agree(*case) for name, case in AGREE_CASES.items()}
    with _older_spelling():
        out["older"] = {
            "names": [_dist.all_gather_into.__name__,
                      _dist.reduce_scatter_into.__name__],
            "all_gather": wl.ici_all_gather_check(wl.make_mesh((4, 2))),
            "dcn": wl.dcn_multislice_check(n_slices=2)}
    return out


@contextlib.contextmanager
def _older_spelling():
    """The port's collectives through their older names, the only ones a
    torch without ``all_gather_single``/``reduce_scatter_single`` has."""
    saved = _dist.all_gather_into, _dist.reduce_scatter_into
    _dist.all_gather_into = dist.all_gather_into_tensor
    _dist.reduce_scatter_into = dist.reduce_scatter_tensor
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            yield
    finally:
        _dist.all_gather_into, _dist.reduce_scatter_into = saved


# rank r reports ok = oks[r], value = values[r], duration r
AGREE_CASES = {
    "max": ([True] * 8, [0.5 * r for r in range(8)], max),
    "min": ([True] * 3 + [False] + [True] * 4,
            [0.5 * r + 1 for r in range(8)], min),
    "nan": ([True] * 8, [0.0] * 5 + [float("nan")] + [1.0] * 2, max),
    "none": ([True] * 8, [None] * 8, min),
}


def _agree(oks, values, worst):
    """What each rank's ``_dist.agree`` returned, gathered."""
    r = dist.get_rank()
    rep = _dist.agree(wl.ValidationReport("x", oks[r], float(r),
                                          value=values[r]), worst=worst)
    held = [None] * dist.get_world_size()
    dist.all_gather_object(held, (rep.ok, rep.value, rep.duration_s))
    return held


def fail_on_rank_1():
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    return dist.get_rank()


class SlowToReport(RuntimeError):
    """An error whose text takes seconds to format, so the rank that raised
    it exits after a peer that only saw it go."""

    def __str__(self):
        import time
        time.sleep(3)
        return "rank 1 fails"


def fail_on_rank_1_while_0_collects():
    """Rank 1 fails at once; rank 0 is in a collective that loses its
    peer, and exits first with gloo's transport error."""
    if dist.get_rank() == 1:
        raise SlowToReport()
    dist.all_reduce(torch.ones(1))
    return dist.get_rank()
