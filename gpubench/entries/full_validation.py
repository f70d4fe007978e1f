"""A mix's call ``{"entry": "full_validation", "expected_chips": <n>}``:
``workloads.run_full_validation(mesh, expected_chips=n)``, whose reports
must be those the configuration names (``full_validation.reports``), in
order, and every one ``ok``.

The objects, made once for the run, as a node's long-lived validator holds
them: a world-1 process group (NCCL on the card, gloo on the CPU) and the
mesh ``workloads.make_mesh()`` builds on it.
"""


def open(cell):
    import torch
    import torch.distributed as dist

    from tpu_operator_torch.validator import workloads

    opts = {}
    if cell.device == "cuda":
        opts["device_id"] = torch.device("cuda", 0)
    dist.init_process_group("nccl" if cell.device == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            **opts)
    return {"workloads": workloads, "mesh": workloads.make_mesh()}


def close(cell, objects) -> None:
    import torch.distributed as dist

    objects.clear()
    dist.destroy_process_group()


def answers(config, call):
    return config["full_validation"]["answers"]


def run(cell, objects, call, result) -> str:
    reports = objects["workloads"].run_full_validation(
        mesh=objects["mesh"], expected_chips=call["expected_chips"])
    bad = [f"{r.name}: {r.detail}" for r in reports if not r.ok]
    want = cell.config["full_validation"]["reports"]
    names = [r.name for r in reports]
    if names != want:
        bad.append(f"reports {names}, want {want}")
    return "; ".join(bad)
