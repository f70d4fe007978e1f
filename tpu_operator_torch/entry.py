"""Entry points of the port: the flagship forward step and the multi-device
dry run.

``entry()`` is the counterpart of ``__graft_entry__.entry()``: the
validator's burn-in MLP (bf16 inputs, f32 products, MSE loss) with random
weights made from fixed seeds, on the card unless the caller passes
``device="cpu"``.  Its two products run on the tensor-core matmul kernel
(``validator.ops.MatmulBf16F32``), as JAX's run on the MXU.

``dryrun_multigpu(n)`` is the counterpart of
``__graft_entry__.dryrun_multichip(n)``: ``n`` ranks (NCCL, one per card;
gloo ranks with ``device="cpu"``), the dp×tp training step on the default
mesh at tiny shapes (its products forward and backward on the same
kernel), then ring and Ulysses attention, the hierarchical multislice
all-reduce (n even), expert-parallel all_to_all and the pipeline handoff —
every parallelism family once.
"""

from __future__ import annotations

import math

import torch

from .validator import _dist, workloads
from .validator.workloads import _mlp_loss, init_mlp_params


def entry(device: str = "cuda"):
    """Return ``(forward, (params, x, y))``; ``forward(*args)`` is the loss."""
    params = init_mlp_params(torch.Generator(device=device).manual_seed(0),
                             128, 256, 128)
    x = torch.randn((32, 128), device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    y = torch.randn((32, 128), device=device,
                    generator=torch.Generator(device=device).manual_seed(2))

    def forward(params, x, y):
        return _mlp_loss(params, x, y)

    return forward, (params, x, y)


def _dryrun_rank() -> str:
    """One rank of :func:`dryrun_multigpu`; returns the summary line."""
    n = torch.distributed.get_world_size()
    mesh = workloads.make_mesh()
    step, params, (x, y) = workloads.sharded_train_step(
        mesh, d_in=32, d_hidden=64, batch_per_device=2)
    loss = float(step(params, x, y)[0])
    # sequence parallelism, both families, on the same mesh
    sp = workloads.ring_attention_check(mesh, seq_per_device=16, d_head=16)
    ul = workloads.ulysses_attention_check(mesh, seq_per_device=16, d_head=16)
    # multislice: reduce-scatter, cross-slice all-reduce, all-gather
    dcn = workloads.dcn_multislice_check(n_slices=2) if n % 2 == 0 else None
    ep = workloads.ep_all_to_all_check(mesh)
    pp = workloads.pp_pipeline_check()
    failed = [f"{r.name}: {r.detail}" for r in (sp, ul, dcn, ep, pp)
              if r is not None and not r.ok]
    if not math.isfinite(loss):
        failed.insert(0, f"train step: non-finite loss {loss}")
    if failed:
        raise RuntimeError("dryrun_multigpu failed: " + "; ".join(failed))
    return (f"dryrun_multigpu: mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
            f"loss={loss:.5f} ring-attn-err={sp.value:.1e} "
            f"ulysses-err={ul.value:.1e}"
            + (f" dcn-slices={int(dcn.value)}" if dcn else "")
            + f" ep={int(ep.value)}-way pp={int(pp.value)}-stage OK")


def dryrun_multigpu(n_devices: int, device: str = "cuda") -> str:
    """Run the dry run on ``n_devices`` ranks; prints and returns its
    summary, raises if any part fails."""
    summary = _dist.spawn(n_devices, _dryrun_rank, device)
    print(summary)  # noqa: TPULNT120 - the summary is the dry run's output, as dryrun_multichip prints it
    return summary
