"""Validator components of the port — one per ``--component`` flag.

Counterpart of ``tpu_operator/validator/components.py``.  The chain, in
DaemonSet order, is

    device → driver → toolkit → torch → plugin            (DaemonSet order)
    nccl, perf                                           (their own gates)
    vfio                                                 (passthrough nodes)

``device`` (the node has cards), ``driver`` (the driver is loaded and its
user-space and kernel halves agree), ``toolkit`` (the CDI spec and the
containerd drop-in would give a container the cards), ``torch`` (the
counterpart of ``jax``: the card initialises and the tensor-core and memory
burn-ins pass), ``plugin`` (the device plugin's resource shows in the
Node's capacity and a workload pod that requests every card runs the
``nccl`` check in-pod and succeeds), ``nccl`` (the counterpart of ``ici``:
collectives across the node's cards), ``perf`` (the kernel
microbenchmarks) and ``vfio`` (every card is bound to vfio-pci).  Each component validates its layer, then
writes its ``*-ready`` status file — the barrier the next layer's init
container blocks on; ``--wait`` turns a component into a pure barrier
consumer.  With the port's tracer on (``obs/trace.py``) each run of a
component is the root span ``validator.component`` (``component``,
``ok``) of the spans its workloads open.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, Optional

from .. import consts, statusfiles
from ..client import ConflictError
from ..deviceplugin.sharing import DEFAULT_RESOURCE_NAME
from ..driver.install import DriverError, check_driver
from ..host import Host, host_for_root
from ..obs import trace
from .spans import ranged

log = logging.getLogger(__name__)

DRIVER_CTR_READY = consts.DRIVER_CTR_READY

STATUS_FILES = {
    "device": "device-ready",
    "driver": consts.STATUS_FILE_DRIVER,
    "toolkit": consts.STATUS_FILE_TOOLKIT,
    "torch": consts.STATUS_FILE_TORCH,
    "plugin": consts.STATUS_FILE_PLUGIN,
    "nccl": consts.STATUS_FILE_NCCL,
    "perf": "perf-ready",
    "vfio": "vfio-ready",
}

# barrier and workload pod wait: 60 x 5 s (reference main.go:179-181)
POD_WAIT_RETRIES = 60
POD_WAIT_SLEEP_S = 5.0
# resource discovery wait: 30 x 5 s (reference main.go:183-185)
RESOURCE_WAIT_RETRIES = 30
RESOURCE_WAIT_SLEEP_S = 5.0


class ValidationError(RuntimeError):
    pass


@dataclasses.dataclass
class Context:
    # the node's host inventory; the live host when not given
    host: Optional[Host] = None
    client_factory: Optional[Callable] = None   # () -> Client (lazy: only
    # the plugin component talks to the API server)
    node_name: str = ""
    namespace: str = ""
    resource_name: str = DEFAULT_RESOURCE_NAME
    base_resource_name: str = ""
    status_dir: str = ""
    validator_image: str = ""
    sleep: Callable[[float], None] = time.sleep
    # set by run_component: workload pods must never touch status/report
    # files
    in_pod: bool = False
    # torch device the workloads run on: the card, or "cpu" in tests
    device: str = "cuda"
    # ranks of the multi-device components: 0 is one per visible card (one
    # on the CPU); the tests ask for several gloo ranks on the CPU
    world: int = 0

    def __post_init__(self):
        self.host = self.host or host_for_root("/")
        self.node_name = self.node_name or os.environ.get("NODE_NAME", "")
        self.namespace = self.namespace or os.environ.get(
            consts.OPERATOR_NAMESPACE_ENV, consts.DEFAULT_NAMESPACE)
        self.resource_name = os.environ.get("GPU_RESOURCE_NAME",
                                            self.resource_name)
        # taints use the BASE name even when time-slicing renames the
        # advertised resource to <base>.shared; capacity polling and pod
        # requests use the effective resource_name above
        self.base_resource_name = (
            self.base_resource_name
            or os.environ.get("GPU_RESOURCE_BASE_NAME", "")
            or self.resource_name.removesuffix(".shared"))
        self.status_dir = self.status_dir or statusfiles.status_dir()
        self.validator_image = self.validator_image or os.environ.get(
            "VALIDATOR_IMAGE", "gpu-operator:latest")


# --------------------------------------------------------------------------
# components
# --------------------------------------------------------------------------

def validate_device(ctx: Context) -> Dict[str, str]:
    """GPU device nodes exist on the host."""
    inv = ctx.host.discover()
    if inv.chip_count == 0:
        raise ValidationError(
            f"no GPU device nodes under {ctx.host.dev_root} "
            f"(nvidia* or vfio/*) and no GPU PCI functions found")
    return {
        "chip_count": str(inv.chip_count),
        "chip_type": inv.chip_type or "unknown",
        "topology": inv.topology,
        "dev_paths": ",".join(c.dev_path for c in inv.chips),
    }


def validate_driver(ctx: Context) -> Dict[str, str]:
    """The NVIDIA driver is in place and announced by the driver DaemonSet.

    Blocks on the driver agent's barrier file, then makes the agent's own
    check (``driver.install.check_driver``) on ``DRIVER_INSTALL_DIR``
    (default: the host's library dir that holds NVML): both user-space
    libraries present, NVML initialising, and NVML's version equal to the
    kernel module's where the host shows it."""
    statusfiles.wait_for_status(
        DRIVER_CTR_READY, ctx.status_dir,
        timeout_s=POD_WAIT_RETRIES * POD_WAIT_SLEEP_S, sleep=ctx.sleep)
    try:
        return check_driver(ctx.host, os.environ.get(
            "DRIVER_INSTALL_DIR", ctx.host.driver_lib_dir()))
    except DriverError as e:
        raise ValidationError(str(e)) from e


def validate_toolkit(ctx: Context) -> Dict[str, str]:
    """Prove the CDI injection path end to end — the analogue of running
    ``nvidia-smi`` under the injected runtime.

    Three stages: (1) the CDI spec exists and covers every discovered card;
    (2) the containerd drop-in actually enables CDI and points at the
    operator's spec dir (a corrupt or missing drop-in means user pods would
    start WITHOUT cards); (3) resolve the ``all`` device the way
    containerd's CDI plugin would and assert every injected device node and
    mount source exists on this host."""
    from ..toolkit.cdi import CDI_KIND, CDI_SPEC_NAME
    from ..toolkit.containerd import DROPIN_NAME
    from ..toolkit.resolve import (CDIResolutionError, check_dropin,
                                   resolve_and_check, resolve_from_dirs)

    cdi_root = os.environ.get("CDI_ROOT", ctx.host.path("var", "run", "cdi"))
    spec_path = os.path.join(cdi_root, CDI_SPEC_NAME)
    try:
        with open(spec_path) as f:
            spec = json.load(f)
    except OSError as e:
        raise ValidationError(f"CDI spec not found at {spec_path}: {e}") from e
    except ValueError as e:
        raise ValidationError(f"CDI spec at {spec_path} is invalid JSON: {e}") from e
    devices = spec.get("devices", [])
    inv = ctx.host.discover()
    if inv.chip_count and len(devices) < inv.chip_count:
        raise ValidationError(
            f"CDI spec lists {len(devices)} devices but host has "
            f"{inv.chip_count} chips")

    values = {"cdi_spec": spec_path, "cdi_devices": str(len(devices)),
              "cdi_kind": spec.get("kind", "")}

    conf_dir = os.environ.get("CONTAINERD_CONF_DIR",
                              ctx.host.path("etc", "containerd", "conf.d"))
    dropin = os.path.join(conf_dir, DROPIN_NAME)
    no_containerd = os.environ.get("TOOLKIT_NO_CONTAINERD",
                                   "").lower() == "true"
    try:
        if no_containerd:
            # runtimes that read the CDI root natively: no drop-in to check,
            # but the spec-vs-hardware drift gate still applies
            env = (resolve_from_dirs([cdi_root], f"{CDI_KIND}=all",
                                     inv.chip_count)
                   if inv.chip_count else {})
            values["runtime_config"] = "native-cdi"
        elif inv.chip_count:
            env = resolve_and_check(dropin, cdi_root, f"{CDI_KIND}=all",
                                    expected_chips=inv.chip_count)
            values["runtime_config"] = dropin
        else:
            # cardless host (device validation gates on this separately):
            # nothing to resolve, but the runtime config must still be sane
            check_dropin(dropin, cdi_root)
            env = {}
            values["runtime_config"] = dropin
    except CDIResolutionError as e:
        raise ValidationError(f"CDI injection check failed: {e}") from e
    values["injected_env"] = ",".join(sorted(env))
    values["injected_chips"] = env.get("NVIDIA_VISIBLE_DEVICES", "")
    return values


def validate_torch(ctx: Context) -> Dict[str, str]:
    """PyTorch sees the card and the tensor-core and memory burn-ins pass —
    the CUDA vectorAdd analogue, run in-process."""
    from . import workloads  # deferred: torch import is heavy

    reports = [workloads.device_check(device=ctx.device)]
    if reports[0].ok:
        reports.append(workloads.matmul_burn_in(size=512, iters=4,
                                                device=ctx.device))
        reports.append(workloads.hbm_stress(mib=64, iters=2,
                                            device=ctx.device))
    failed = [r for r in reports if not r.ok]
    if failed:
        raise ValidationError("; ".join(f"{r.name}: {r.detail}"
                                        for r in failed))
    return {r.name: f"{r.duration_s:.2f}s" for r in reports} | {
        "devices": str(int(reports[0].value or 0))}


def validate_plugin(ctx: Context) -> Dict[str, str]:
    """The device plugin advertises the cards, then a workload pod
    requesting all of them runs the ``nccl`` check in-pod — the reference
    plugin validation (main.go:1149-1316): poll the Node's capacity, then
    run a pod on the resource and wait for it to succeed."""
    if ctx.client_factory is None:
        raise ValidationError("plugin validation requires API access")
    client = ctx.client_factory()
    capacity = _wait_for_resource(ctx, client)
    pod = _workload_pod_spec(ctx, capacity)
    _run_workload_pod(ctx, client, pod)
    return {"resource": ctx.resource_name, "capacity": str(capacity)}


def _wait_for_resource(ctx: Context, client) -> int:
    for _ in range(RESOURCE_WAIT_RETRIES):
        node = client.get("Node", ctx.node_name)
        cap = node.get("status", {}).get("capacity", {}).get(
            ctx.resource_name)
        if cap and int(cap) > 0:
            return int(cap)
        ctx.sleep(RESOURCE_WAIT_SLEEP_S)
    raise ValidationError(
        f"{ctx.resource_name} never appeared in node {ctx.node_name} "
        f"capacity after {RESOURCE_WAIT_RETRIES * RESOURCE_WAIT_SLEEP_S:.0f}s")


# the workload pod's volume of the node's kernel build dir
KERNEL_CACHE_VOLUME = "kernel-cache"


def _workload_pod_spec(ctx: Context, cards: int) -> dict:
    """The plugin-workload pod: requests the cards and runs the nccl
    validation in-pod.  Its burn-in launches the matmul kernel, so the pod
    mounts the node's kernel build dir (``consts.BUILD_DIR_ON_NODE``, where
    the validator's ``torch`` container built the library) and points
    ``consts.BUILD_DIR_ENV`` at it, as the JAX pod mounts its compile
    cache: the pod loads that build instead of compiling in a throwaway
    container.  ONLY the build dir is mounted: the status files under
    ``/run/gpu/validations`` stay out of the pod's reach.
    ``GPU_MULTISLICE_*`` from the validator's own env is forwarded so the
    in-pod check runs the multislice path on multislice deployments."""
    name = f"gpu-validation-workload-{ctx.node_name}"
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name, "namespace": ctx.namespace,
                     "labels": {"app": "gpu-validation-workload"}},
        "spec": {
            "restartPolicy": "Never",
            "nodeName": ctx.node_name,
            "containers": [{
                "name": "gpu-validation",
                "image": ctx.validator_image,
                "command": ["python", "-m", "tpu_operator_torch.validator"],
                "args": ["--component=nccl", "--in-pod"],
                "env": [{"name": consts.BUILD_DIR_ENV,
                         "value": consts.BUILD_DIR_ON_NODE}]
                + [{"name": k, "value": v}
                   for k, v in sorted(os.environ.items())
                   if k.startswith("GPU_MULTISLICE_")],
                "volumeMounts": [{"name": KERNEL_CACHE_VOLUME,
                                  "mountPath": consts.BUILD_DIR_ON_NODE}],
                "resources": {
                    "limits": {ctx.resource_name: str(cards)},
                    "requests": {ctx.resource_name: str(cards)},
                },
            }],
            "volumes": [{"name": KERNEL_CACHE_VOLUME,
                         "hostPath": {"path": consts.BUILD_DIR_ON_NODE,
                                      "type": "DirectoryOrCreate"}}],
            "tolerations": [{"key": ctx.base_resource_name,
                             "operator": "Exists",
                             "effect": "NoSchedule"}],
        },
    }


def _run_workload_pod(ctx: Context, client, pod: dict) -> None:
    md = pod["metadata"]
    # delete any stale pod from a previous validation round.  Real pod
    # deletion is ASYNCHRONOUS: the old pod lingers Terminating for its
    # grace period and a create at the same name 409s until it finalizes —
    # so the create must wait-and-retry, not assume the name is free
    # (reference waitForPod semantics, cmd/nvidia-validator/main.go:1236).
    client.delete("Pod", md["name"], md["namespace"])
    for _ in range(POD_WAIT_RETRIES):
        try:
            client.create(pod)
            break
        except ConflictError:
            ctx.sleep(POD_WAIT_SLEEP_S)
    else:
        raise ValidationError(
            f"stale workload pod {md['name']} never finalized within "
            f"{POD_WAIT_RETRIES * POD_WAIT_SLEEP_S:.0f}s")
    try:
        for _ in range(POD_WAIT_RETRIES):
            live = client.get("Pod", md["name"], md["namespace"])
            phase = live.get("status", {}).get("phase", "")
            if phase == "Succeeded":
                return
            if phase == "Failed":
                raise ValidationError(
                    f"workload pod {md['name']} failed: "
                    f"{live.get('status', {}).get('message', '')}")
            ctx.sleep(POD_WAIT_SLEEP_S)
        raise ValidationError(
            f"workload pod {md['name']} did not succeed within "
            f"{POD_WAIT_RETRIES * POD_WAIT_SLEEP_S:.0f}s")
    finally:
        client.delete("Pod", md["name"], md["namespace"])


# the all-reduce bandwidth rides the nccl-ready payload
NCCL_BANDWIDTH_KEY = "nccl_allreduce_gbps"


def _nccl_rank(gang_hosts: int, n_slices: int):
    """One rank of the nccl component: the JAX ``validate_ici`` checks, in
    its order, on the default mesh; just the burn-in on a world of one."""
    from . import workloads

    mesh = workloads.make_mesh()
    if mesh.size() == 1:
        return [workloads.slice_burn_in(mesh, steps=2)]
    reports = [workloads.ici_psum_check(mesh),
               workloads.ici_ring_check(mesh),
               workloads.ici_all_gather_check(mesh),
               # gang readiness: the collective a multi-host job runs
               workloads.multihost_allreduce_check(processes=gang_hosts),
               # BOTH long-context families: ring (n-1 point-to-point hops)
               # and Ulysses (one global shuffle) stress the links oppositely
               workloads.ring_attention_check(mesh),
               workloads.ulysses_attention_check(mesh),
               # expert-parallel all_to_all on the model axis and a
               # pipeline handoff chain (own 1-axis mesh over the same ranks)
               workloads.ep_all_to_all_check(mesh),
               workloads.pp_pipeline_check(),
               workloads.ici_bandwidth_probe(mesh),
               workloads.slice_burn_in(mesh)]
    if n_slices:
        reports.append(workloads.dcn_multislice_check(n_slices=n_slices))
    return reports


def validate_nccl(ctx: Context) -> Dict[str, str]:
    """Collectives across the node's cards over NCCL (psum, ring, all-gather,
    gang all-reduce, both attention families, ep, pp, bandwidth, the dp×tp
    burn-in) — the interconnect gate, one rank per card.  With one card
    nothing is exchanged, but the burn-in still runs on a world-1 NCCL
    group.  It reports under ``nccl-*`` names (the JAX package's
    ``ici-*``) and reads ``GPU_HOSTS_PER_SLICE`` and ``GPU_MULTISLICE_*``
    (its ``TPU_HOSTS_PER_SLICE`` and ``MEGASCALE_*``)."""
    import torch

    from . import _dist, workloads

    n = ctx.world or (torch.cuda.device_count()
                      if torch.device(ctx.device).type == "cuda" else 1)
    if n < 1:
        raise ValidationError("no CUDA device to run collectives on")
    # the slice's host count shapes the gang-readiness collective; a node
    # that cannot say falls back to the mesh's leading axis
    try:
        gang_hosts = int(os.environ.get("GPU_HOSTS_PER_SLICE", "0"))
    except ValueError:
        gang_hosts = 0
    if gang_hosts < 1 or n % gang_hosts:
        gang_hosts = workloads.default_mesh_shape(n)[0]
    # multislice deployments additionally prove the hierarchical DCN path
    n_slices = 0
    if os.environ.get("GPU_MULTISLICE_ENABLED", "").lower() in ("true", "1"):
        try:
            n_slices = max(2, int(os.environ.get("GPU_MULTISLICE_NUM_SLICES", "2")))
        except ValueError:
            n_slices = 2
    try:
        reports = _dist.spawn(n, _nccl_rank, ctx.device, gang_hosts, n_slices)
    except _dist.DistributedError as e:
        raise ValidationError(str(e)) from e
    failed = [r for r in reports if not r.ok]
    if failed:
        raise ValidationError("; ".join(f"{r.name}: {r.detail}"
                                        for r in failed))
    if n == 1:
        return {"devices": "1", "note": "single chip; collectives skipped"}
    bw = next(r for r in reports if r.name == "nccl-bandwidth")
    return {"devices": str(n), NCCL_BANDWIDTH_KEY: f"{bw.value:.2f}"} | {
        r.name: f"{r.duration_s:.2f}s" for r in reports}


PERF_REPORT_FILE = "perf-report"

# probe name -> (status-file/metric key, unit), as in the JAX package
PERF_KEYS = {
    "mxu-probe": ("mxu_tflops", "tflops"),
    "hbm-probe": ("hbm_gibs", "gibs"),
}

# non-barrier record files a component owns besides its STATUS_FILES entry;
# cleared alongside the barrier at the start of each (non-pod) run
EXTRA_STATUS_FILES = {
    "perf": (PERF_REPORT_FILE,),
}


def validate_perf(ctx: Context) -> Dict[str, str]:
    """Kernel microbenchmarks: tensor-core TFLOP/s, memory GiB/s, FMA
    correctness, gated against per-part floors (``microbench``'s
    ``*_GATE_FRACTION`` of its ``CHIP_PEAKS``): a card below a floor fails
    and gets no ``perf-ready``.  PERF_ENFORCE=false downgrades the floors
    to report-only.  Numbers and floors are always persisted to
    ``perf-report``; ``perf-ready`` — the barrier — is written by
    run_component only when the gate passes."""
    from . import microbench

    enforce = os.environ.get("PERF_ENFORCE", "true").lower() != "false"
    quick = os.environ.get("PERF_QUICK", "").lower() == "true"
    reports = microbench.run_microbench(enforce=enforce, quick=quick,
                                        device=ctx.device)

    values: Dict[str, str] = {
        "chip_gen": microbench.chip_generation(ctx.device) or "unknown",
        "enforced": "true" if enforce else "false",
    }
    for r in reports:
        key, _unit = PERF_KEYS.get(r.name, (None, None))
        if key and r.value is not None:
            values[key] = f"{r.value:.1f}"
            if r.floor:
                values[f"{key}_floor"] = f"{r.floor:.1f}"
        values[f"{r.name}_ok"] = "true" if r.ok else "false"
    if not ctx.in_pod:
        statusfiles.write_status(PERF_REPORT_FILE, values, ctx.status_dir)

    failed = [r for r in reports if not r.ok]
    if failed:
        raise ValidationError("; ".join(f"{r.name}: {r.detail}"
                                        for r in failed))
    return values


def validate_vfio(ctx: Context) -> Dict[str, str]:
    """VM-passthrough mode: every GPU PCI function is bound to vfio-pci."""
    pci = ctx.host.list_gpu_pci_addresses()
    if not pci:
        raise ValidationError("no GPU PCI functions found")
    unbound = []
    for addr in pci:
        drv = os.path.join(ctx.host.sys_root, "bus", "pci", "devices",
                           addr, "driver")
        try:
            target = os.path.basename(os.readlink(drv))
        except OSError:
            target = ""
        if target != "vfio-pci":
            unbound.append(f"{addr}({target or 'none'})")
    if unbound:
        raise ValidationError(f"not bound to vfio-pci: {', '.join(unbound)}")
    groups = ctx.host.list_vfio_dev_nodes()
    return {"pci_count": str(len(pci)), "vfio_groups": str(len(groups))}


COMPONENTS: Dict[str, Callable[[Context], Dict[str, str]]] = {
    "device": validate_device,
    "driver": validate_driver,
    "toolkit": validate_toolkit,
    "torch": validate_torch,
    "plugin": validate_plugin,
    "nccl": validate_nccl,
    "perf": validate_perf,
    "vfio": validate_vfio,
}


def run_component(component: str, ctx: Context, wait_only: bool = False,
                  in_pod: bool = False) -> Dict[str, str]:
    """Run one component; write its status file on success, clear it first.

    ``wait_only``: act as a barrier consumer — block until the status file
    exists, validate nothing.  ``in_pod``: run the validation but skip
    status files."""
    if component not in COMPONENTS:
        raise ValidationError(f"unknown component {component!r}; "
                              f"valid: {sorted(COMPONENTS)}")
    status_file = STATUS_FILES[component]
    if wait_only:
        return statusfiles.wait_for_status(
            status_file, ctx.status_dir,
            timeout_s=POD_WAIT_RETRIES * POD_WAIT_SLEEP_S, sleep=ctx.sleep)
    ctx.in_pod = in_pod
    with ranged(trace.root_span("validator.component",
                                {"component": component,
                                 "ok": False})) as span:
        if not in_pod:
            statusfiles.clear_status(status_file, ctx.status_dir)
            # non-barrier records too: a surviving report from a previous
            # run would keep serving stale numbers
            for extra in EXTRA_STATUS_FILES.get(component, ()):
                statusfiles.clear_status(extra, ctx.status_dir)
        values = COMPONENTS[component](ctx)
        if not in_pod:
            statusfiles.write_status(status_file, values, ctx.status_dir)
        span.set_attr("ok", True)
    log.info("%s validation succeeded: %s", component, values)
    return values
