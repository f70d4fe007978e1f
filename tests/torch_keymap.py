"""The key map between the JAX operator and the port's, for the parity tests
of the reconcile path (``tests/test_torch_{api,render,state_engine,
controllers}.py``): what the port changes of the JAX package's policy,
manifests and objects, and nothing else.

* every name it writes outside its process — kinds, group, labels,
  annotations, host paths, env, metric families, object and file names,
  reports, CLIs — is :data:`RENAMED`'s of the JAX package's (README
  "The port's names"); :func:`rename` and :func:`renamed` map a JAX
  string or object to the port's, and every view below applies them;
* the validator's sub-specs ``jax``/``ici`` are ``torch``/``nccl``, and its
  init container ``jax-validation`` runs ``--component=torch``;
* every ``python -m tpu_operator.<mod>`` runs ``tpu_operator_torch.<mod>``;
* the resource is ``nvidia.com/gpu`` (``google.com/tpu`` in the JAX
  package), the default toleration for ``google.com/tpu`` is gone, and the
  sandbox plugin advertises ``nvidia.com/gpu-vfio``;
* the driver DaemonSet runs ``install --device-mode=… [--driver-version=…]``
  (the JAX ``--libtpu-version=…`` and its library-source flags are gone);
* ``hostPaths.driverInstallDir`` is the host's driver library dir; the
  driver, toolkit and validator containers see it at
  ``DRIVER_INSTALL_MOUNT`` (read-only, ``DRIVER_INSTALL_DIR`` names it;
  the JAX package mounts its dir at the same path), the toolkit's hostPath
  is the policy's ``toolkit.installDir`` where set, it takes no
  ``--install-dir`` and reads the host's path from
  ``DRIVER_INSTALL_HOST_DIR``, and the telemetry daemon takes
  ``--dev-root`` where the JAX one took ``--sys-root=/host-sys``;
* the validator's XLA compile-cache variable is the kernels' build dir
  (``TPU_OPERATOR_TORCH_BUILD_DIR=/run/tpu/build``), and the validator
  sets ``DRIVER_INSTALL_DIR`` after it;
* every container that mounts the driver's libraries sets ``NVML_LIB`` to
  NVML under the mount, after ``DRIVER_INSTALL_DIR``; the telemetry
  daemon mounts them too (last of its mounts and volumes) and sets
  ``NVML_LIB`` first of its env, the device plugin, fd, the partition
  manager and the cc manager likewise, after ``DRIVER_INSTALL_DIR``;
* the partition manager's default profile is ``all-chips``, and its
  ConfigMap is ``tpu-partition-profiles`` holding ``profiles.json`` (the
  built-in MIG geometries; the JAX package renders ``tpu-partition-config``,
  a name its manager never reads);
* the spec-hash annotation and pod-template label differ with the content
  they hash, so both are blanked.

Objects of a cluster (``cluster_obj``, for the upgrade, driver-CR and
remediation parity tests): a Node made by ``make_tpu_node`` is the node
``make_gpu_node`` makes of the same name, slice, worker and card count
(GKE's TPU
accelerator and topology labels give way to fd's, whatever else it
carries is kept); resource names in ``limits``, ``requests``,
``capacity`` and ``allocatable`` are ``nvidia.com/gpu*`` for
``google.com/tpu*`` (a pod holds a card by requesting one); the upgrade's
and remediation's labels, annotations and taints are the JAX package's.
A ``TPUDriver``'s pool (``driver_daemonset``) is for the GPU type of
``ACCEL``, selects on fd's type and topology labels where the JAX pool
selects on GKE's, and tolerates ``nvidia.com/gpu`` where the JAX one
tolerates ``google.com/tpu``.

The gang workloads' nodes and env (the workload and remediation parity
tests): ``gpu_node`` is the node fd labels on a GPU host for a
``make_tpu_node`` call — its accelerator and topology under fd's labels,
its cards in ``nvidia.com/gpu`` capacity; a gang pod's env is the JAX
contract under :data:`GANG_ENV` (``JAX_COORDINATOR_ADDRESS`` is
``MASTER_ADDR:MASTER_PORT``, ``JAX_PROCESS_ID`` ``RANK``,
``JAX_PROCESS_COUNT`` ``WORLD_SIZE``, every ``TPU_*`` name ``GPU_*``,
``GPU_ACCELERATOR_TYPE`` the port node's fd type), and the replicas
message names a process, not a JAX process.
"""

import copy
import json
import re
import types

from tpu_operator import consts as jax_consts
from tpu_operator_torch import consts
from tpu_operator_torch.partition.manager import builtin_profiles
from tpu_operator_torch.testing import make_gpu_node, sample_policy

# ------------------------------------------------------------ the names
#: every name the port writes outside its process, JAX package's -> port's:
#: a substring of a string is rewritten by the longest key that matches
#: there (:func:`rename`); :data:`KEPT` says what never changes, and a TPU
#: word that neither covers is an error, not a guess
RENAMED = {
    # the API group and label domain, the kinds, their plurals and CRDs
    "tpu.operator.dev": "gpu.operator.dev",
    "TPUPolicy": "GPUPolicy",
    "TPUDriver": "GPUDriver",
    "TPUWorkload": "GPUWorkload",
    "tpupolicies": "gpupolicies",
    "tpupolicy": "gpupolicy",
    "tpudriver": "gpudriver",
    "tpuworkload": "gpuworkload",
    "tpu-policy": "gpu-policy",
    # the policy's and the driver's fields, and their schema
    "libtpuVersion": "driverVersion",
    "libtpuSource": "source",
    "Libtpu Version": "Driver Version",
    "Libtpu Source": "Source",
    "LibtpuSourceSpec": "DriverSourceSpec",
    # node labels and annotations (under the domain)
    "libtpu.version": "driver.version",
    "tpu.present": "gpu.present",
    "tpu.deploy.": "gpu.deploy.",
    "tpu.workload.config": "gpu.workload.config",
    "tpu.slice.ready": "gpu.slice.ready",
    "tpu.slice": "gpu.slice",
    "tpu.worker-id": "gpu.worker-id",
    "tpu.topology": "gpu.topology",
    "tpu.hosts-per-slice": "gpu.hosts-per-slice",
    "tpu.accelerator-type": "gpu.accelerator-type",
    "tpu.chip": "gpu.chip",
    "tpu.count": "gpu.count",
    "tpu.config": "gpu.config",
    "tpu-topology": "gpu-topology",
    "tpu-slice-id": "gpu-slice-id",
    "tpu-hosts-per-slice": "gpu-hosts-per-slice",
    "tpu-accelerator-type": "gpu-accelerator-type",
    # host paths, status files, reports
    "/run/tpu": "/run/gpu",
    "run-tpu": "run-gpu",
    # the workload pod's volume of the build dir (its JAX compile cache)
    "jax-cache": "kernel-cache",
    "ici-degraded": "gpu-degraded",
    "ici_degraded": "gpu_degraded",
    "ici-bandwidth": "nccl-bandwidth",
    "ici-": "nccl-",
    # env
    "TPU_HOSTS_PER_SLICE": "GPU_HOSTS_PER_SLICE",
    "TPU_WORKER_ID": "GPU_WORKER_ID",
    "TPU_WORKER_HOSTNAMES": "GPU_WORKER_HOSTNAMES",
    "TPU_TOPOLOGY": "GPU_TOPOLOGY",
    "TPU_RESOURCE_NAME": "GPU_RESOURCE_NAME",
    "TPU_RESOURCE_BASE_NAME": "GPU_RESOURCE_BASE_NAME",
    "TPU_ACCELERATOR_TYPE": "GPU_ACCELERATOR_TYPE",
    "TPU_CHIP_TYPE": "GPU_CHIP_TYPE",
    "TPU_SLICE_ID": "GPU_SLICE_ID",
    "TPU_DCN_MTU": "GPU_DCN_MTU",
    "TPU_SHARED_REPLICAS": "GPU_SHARED_REPLICAS",
    "TPU_METRICSD_PORT": "GPU_METRICSD_PORT",
    "TPU_METRICSD_URL": "GPU_METRICSD_URL",
    "TPU_HEALTHWATCH": "GPU_HEALTHWATCH",
    "TPU_OPERATOR_API_SERVER": "GPU_OPERATOR_API_SERVER",
    "TPU_OPERATOR_TOKEN": "GPU_OPERATOR_TOKEN",
    "TPU_OPERATOR_IMAGE": "GPU_OPERATOR_IMAGE",
    "TPU_OPERATOR_WRITE_CONCURRENCY": "GPU_OPERATOR_WRITE_CONCURRENCY",
    "TPU_OPERATOR_EXPLAIN_URL": "GPU_OPERATOR_EXPLAIN_URL",
    "TPU_OPERATOR_LOOP_URL": "GPU_OPERATOR_LOOP_URL",
    "TPU_OPERATOR_PROFILE_URL": "GPU_OPERATOR_PROFILE_URL",
    "TPU_OPERATOR_SLO_URL": "GPU_OPERATOR_SLO_URL",
    "TPU_OPERATOR_TRACES_URL": "GPU_OPERATOR_TRACES_URL",
    "TPU_OPERATOR_TSDB_URL": "GPU_OPERATOR_TSDB_URL",
    "TPU_OPERATOR_VARS_URL": "GPU_OPERATOR_VARS_URL",
    "TPU_OPERATOR_REPO": "GPU_OPERATOR_REPO",
    "MEGASCALE_": "GPU_MULTISLICE_",
    "megascale": "multislice",
    # the gang
    "jax-worker": "torch-worker",
    "jax-coordinator": "torch-coordinator",
    "tpu-workload": "gpu-workload",
    # metric families (every tpu_operator_* one by its prefix)
    "tpu_operator_": "gpu_operator_",
    "tpu_operator_node_tpu_chips": "gpu_operator_node_gpu_chips",
    "tpu_nodes_total": "gpu_nodes_total",
    "tpu_chip_up": "gpu_chip_up",
    "tpu_chips_total": "gpu_chips_total",
    "tpu_duty_cycle_percent": "gpu_duty_cycle_percent",
    "tpu_hbm_total_bytes": "gpu_hbm_total_bytes",
    "tpu_hbm_used_bytes": "gpu_hbm_used_bytes",
    "tpu_power_watts": "gpu_power_watts",
    "tpu_temperature_celsius": "gpu_temperature_celsius",
    "tpu_topology_info": "gpu_topology_info",
    "tpu_uncorrectable_errors_total": "gpu_uncorrectable_errors_total",
    "tpu_ici_link_": "gpu_nvlink_",
    "tpu_exporter_metricsd_up": "gpu_exporter_metricsd_up",
    "tpu_exporter_scrape_duration_seconds":
        "gpu_exporter_scrape_duration_seconds",
    "tpu_metricsd_scrapes_total": "gpu_metricsd_scrapes_total",
    "tpu_metricsd_uptime_seconds": "gpu_metricsd_uptime_seconds",
    # alerts and condition reasons
    "TPUICILinkDown": "GPUNVLinkDown",
    "TPUNodeICIDegraded": "GPUNodeDegraded",
    "TPUChipDown": "GPUChipDown",
    "TPUExporterMetricsdDown": "GPUExporterMetricsdDown",
    "TPUHBMNearFull": "GPUHBMNearFull",
    "TPUNodeNotValidated": "GPUNodeNotValidated",
    "TPUUncorrectableErrors": "GPUUncorrectableErrors",
    "NoTPUNodes": "NoGPUNodes",
    # objects, operands, files and programs
    "tpu-operator": "gpu-operator",
    "tpu-operator-validator": "gpu-operator-validator",
    "tpu-driver": "gpu-driver",
    "tpu-container-toolkit": "gpu-container-toolkit",
    "tpu-device-plugin": "gpu-device-plugin",
    "tpu-sandbox-device-plugin": "gpu-sandbox-device-plugin",
    "tpu-sandbox-validator": "gpu-sandbox-validator",
    "tpu-feature-discovery": "gpu-feature-discovery",
    "tpu-exporter": "gpu-exporter",
    "tpu-node-status-exporter": "gpu-node-status-exporter",
    "tpu-partition-manager": "gpu-partition-manager",
    "tpu-partition-profiles": "gpu-partition-profiles",
    "tpu-cc-manager": "gpu-cc-manager",
    "tpu-kata-manager": "gpu-kata-manager",
    "tpu-vfio-manager": "gpu-vfio-manager",
    "tpu-validation": "gpu-validation",
    "zz-tpu-operator-": "zz-gpu-operator-",
    "tpu-metricsd": "gpu-metricsd",
    "kata-tpu": "kata-gpu",
    "tpu-pod.yaml": "gpu-pod.yaml",
    "tpu-status": "gpu-status",
    "tpuop-cfg": "gpuop-cfg",
    "tpuop_cfg": "gpuop_cfg",
    "TPUSNAP1": "GPUSNAP1",
    ".tpusnap": ".gpusnap",
    # the driver type, quoted in an embedded document (the CSV's examples)
    '"tpu"': '"gpu"',
}
#: a whole string the port writes that no row may match inside a longer
#: one: the driver type (``api/tpudriver.py``'s ``DRIVER_TYPE_TPU``)
RENAMED_WHOLE = {"tpu": "gpu"}
#: a word of running text (a description, a help line, an event's
#: message), where no letter, digit, ``_``, ``-`` or ``.`` touches it
RENAMED_PROSE = {"TPU": "GPU", "TPUs": "GPUs", "ICI": "NVLink", "ici": "nccl"}
#: not the port's names: the JAX test files' own data (node and pod names,
#: an env a test sets, the Python names their messages quote) and the JAX
#: defaults that a key map below replaces by the port's value, renamed so
#: that both sides of a comparison read alike
SCENARIO_NAMES = {
    "tpu-0": "gpu-0", "tpu-1": "gpu-1", "tpu-2": "gpu-2",
    "tpu-3": "gpu-3", "tpu-9": "gpu-9", "tpu-n3": "gpu-n3",
    "tpu-node-": "gpu-node-", "tpu-agent": "gpu-agent",
    "tpu-no-vendor": "gpu-no-vendor", "bare-TPU-VM": "bare-GPU-VM",
    "TPU_LOG": "GPU_LOG", "TPU_MIN_LOG_LEVEL": "GPU_MIN_LOG_LEVEL",
    "tpu_duty_cycle": "gpu_duty_cycle", "jax[tpu]": "jax[gpu]",
    "make_tpu_node": "make_gpu_node", "label_tpu_nodes": "label_gpu_nodes",
    "tpu_present": "gpu_present",
    "/home/kubernetes/bin/tpu": "/home/kubernetes/bin/gpu",
    "/usr/local/tpu": "/usr/local/gpu",
}
#: a whole string of a JAX test file's (the constant part of an f-string)
SCENARIO_WHOLE = {"tpu-": "gpu-"}
#: what :func:`rename` leaves as it is, tried before the rows at each
#: place: the Python package and module paths (both packages'; the port's
#: keep the JAX package's module names, ``port_module`` maps the one
#: renamed module), the build dir's variable (named after the package),
#: the vendor's and other projects' names (GKE's labels and TPU types,
#: ``google.com/tpu``, which the resource maps handle), test and Python
#: identifiers that carry the word, and tpulint's rule ids
KEPT = (
    r"tpu_operator(?:_torch)?\b(?:[./](?:tpu(?:policy|driver|workload)"
    r"(?:_controller)?\b|tpuop_cfg\b|(?!\w*tpu)[A-Za-z_]\w*))*",
    r"TPU_OPERATOR_TORCH_BUILD_DIR",
    r"(?:cloud\.)?google\.com/[\w./-]*",
    r"tpu-v\d[\w-]*",
    r"TPULNT\d*", r"tpulint",
    r"test_\w+",
    r"[A-Za-z][A-Za-z0-9]*_TPU\w*",
    r"TPU\w*(?:Reconciler|Spec|Status|Controller)\b",
    r"TPU_PRESENT_LABEL", r"ICI_DEGRADED_[A-Z]+",
    r"has_tpu_nodes", r"tpu_present_label", r"libtpu_\w+", r"_on_tpu",
    r"tpu_node_count",
)
#: a TPU word left over where no row matched ("output", "INSUFFICIENT"
#: and "policies" hold none): :func:`rename` refuses the string
LEFTOVER = re.compile(r"(?<![a-z])tpu|(?<![A-Z])TPU|(?<![A-Za-z])Tpu|"
                      r"(?<![A-Za-z])ici(?![a-z])|(?<![A-Za-z])ICI(?![A-Z])")
_ROWS = {**SCENARIO_NAMES, **RENAMED}
_RENAME = re.compile(
    "|".join([f"(?P<k{i}>{k})" for i, k in enumerate(KEPT)]
             + [re.escape(k) for k in sorted(_ROWS, key=len, reverse=True)]
             + [r"(?P<prose>(?<![\w.-])(?:"
                + "|".join(map(re.escape, RENAMED_PROSE)) + r")(?![\w.-]))"]))
#: the port's one module whose name is not the JAX package's
PORT_MODULES = {"cmd.tpuop_cfg": "cmd.gpuop_cfg"}


def rename(s: str) -> str:
    """``s`` with each JAX name in it as the port's (:data:`RENAMED`); a
    TPU word that no row covers raises ``KeyError``."""
    whole = RENAMED_WHOLE.get(s, SCENARIO_WHOLE.get(s))
    if whole is not None:
        return whole
    out, at, spans = [], 0, []
    for m in _RENAME.finditer(s):
        group = m.lastgroup or ""
        out += [s[at:m.start()],
                m.group(0) if group.startswith("k")
                else RENAMED_PROSE[m.group(0)] if group == "prose"
                else _ROWS[m.group(0)]]
        at = m.end()
        spans.append(m.span())
    for m in LEFTOVER.finditer(s):
        if not any(a <= m.start() < b for a, b in spans):
            raise KeyError(f"no RENAMED row covers {m.group(0)!r} at "
                           f"{m.start()} of {s!r}")
    return "".join(out) + s[at:]


def renamed(obj):
    """``obj`` (a JSON-like tree) with every key and string renamed."""
    if isinstance(obj, dict):
        return {renamed(k): renamed(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(renamed(v) for v in obj))
    if isinstance(obj, (list, tuple, set, frozenset)):
        return type(obj)(renamed(v) for v in obj)
    return rename(obj) if isinstance(obj, str) else obj


def on(port: bool, obj):
    """``obj`` (a JAX name, an object or a tuple of them) as the side
    ``port`` names it: :func:`renamed` on the port's side."""
    return renamed(obj) if port else obj


def port_module(jax_name: str) -> str:
    """``tpu_operator[.x]`` as the port's module's name."""
    rest = jax_name[len("tpu_operator"):].lstrip(".")
    rest = PORT_MODULES.get(rest, rest)
    return "tpu_operator_torch" + (f".{rest}" if rest else "")


JAX_DRIVER_DIR = "/home/kubernetes/bin/tpu"
PORT_DRIVER_DIR = "/usr/lib/x86_64-linux-gnu"
JAX_TOOLKIT_DIR = "/usr/local/tpu-toolkit"
DRIVER_MOUNT = consts.DRIVER_INSTALL_MOUNT
BUILD_DIR_ENV = {"name": consts.BUILD_DIR_ENV,
                 "value": consts.BUILD_DIR_ON_NODE}
# every container that mounts the driver's libraries opens NVML there
NVML_LIB_ENV = {"name": "NVML_LIB",
                "value": f"{DRIVER_MOUNT}/libnvidia-ml.so.1"}
METRICSD = "/usr/local/bin/tpu-metricsd"
# the containers that open NVML and had no driver mount in the JAX package
# (the sandbox device plugin serves VFIO devices and opens no NVML)
NVML_OPERANDS = ("tpu-device-plugin", "tpu-feature-discovery",
                 "tpu-partition-manager", "tpu-cc-manager")
HASH_KEY = "tpu.operator.dev/last-applied-hash"
PORT_HASH_KEY = rename(HASH_KEY)
HASH_LABEL = "last-applied-hash"

VALUES = {
    "google.com/tpu": "nvidia.com/gpu",
    "google.com/tpu.shared": "nvidia.com/gpu.shared",
    "--resource-name=google.com/tpu": "--resource-name=nvidia.com/gpu",
    "--resource-name=google.com/tpu-vfio":
        "--resource-name=nvidia.com/gpu-vfio",
    JAX_DRIVER_DIR: PORT_DRIVER_DIR,
    "--component=jax": "--component=torch",
    "jax-validation": "torch-validation",
    "--sys-root=/host-sys": "--dev-root=/dev",
    "--default-profile=all-disabled": "--default-profile=all-chips",
}


def policy_spec(spec: dict) -> dict:
    """A JAX policy spec (wire form) as the port's: the validator's
    sub-specs and every JAX name renamed."""
    spec = copy.deepcopy(spec)
    v = spec.get("validator")
    if isinstance(v, dict):
        for old, new in (("jax", "torch"), ("ici", "nccl")):
            if old in v:
                v[new] = v.pop(old)
    return renamed(spec)


def default_spec(spec: dict) -> dict:
    """A JAX policy spec with every default shown
    (``to_dict(omit_defaults=False)``) as the port's defaults."""
    spec = policy_spec(spec)
    spec["devicePlugin"]["resourceName"] = "nvidia.com/gpu"
    spec["hostPaths"]["driverInstallDir"] = PORT_DRIVER_DIR
    spec["toolkit"]["installDir"] = ""
    spec["partitionManager"]["defaultProfile"] = "all-chips"
    return spec


def _value(v):
    if isinstance(v, str):
        if v.startswith("tpu_operator."):
            return "tpu_operator_torch." + v[len("tpu_operator."):]
        return rename(VALUES.get(v, v))
    return v


def _walk(obj):
    if isinstance(obj, dict):
        return {rename(k): _walk(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_walk(v) for v in obj]
    return _value(obj)


def _container(c: dict) -> dict:
    args = c.get("args")
    if c.get("command", [None])[-1:] == ["tpu_operator.driver"] \
            and args and args[0] == "install":
        version = next((a.split("=", 1)[1] for a in args
                        if a.startswith("--libtpu-version=")), "")
        rest = [a for a in args[1:]
                if not a.startswith(("--libtpu-version=", "--libtpu-source=",
                                     "--libtpu-url=", "--libtpu-sha256="))]
        mode = [a for a in rest if a.startswith("--device-mode=")]
        extra = [a for a in rest if not a.startswith("--device-mode=")]
        c["args"] = (["install"] + mode
                     + ([f"--driver-version={version}"] if version else [])
                     + extra)
    toolkit = c.get("command", [None])[-1:] == ["tpu_operator.toolkit"]
    if toolkit and args:
        c["args"] = [a for a in args if not a.startswith("--install-dir=")]
    if "env" in c:
        env = []
        for e in c["env"]:
            if e.get("name") == "JAX_COMPILATION_CACHE_DIR":
                env += [dict(BUILD_DIR_ENV), {"name": "DRIVER_INSTALL_DIR",
                                              "value": DRIVER_MOUNT},
                        dict(NVML_LIB_ENV)]
            elif e.get("name") == "DRIVER_INSTALL_DIR":
                env += [{"name": "DRIVER_INSTALL_DIR", "value": DRIVER_MOUNT},
                        dict(NVML_LIB_ENV)]
                if toolkit:
                    env.append({"name": "DRIVER_INSTALL_HOST_DIR",
                                "value": e["value"]})
            else:
                env.append(e)
        c["env"] = env
    for m in c.get("volumeMounts", []):
        if m.get("name") == "driver-install-dir":
            m["mountPath"] = DRIVER_MOUNT
            m["readOnly"] = True
    if _opens_nvml(c):
        c["env"] = [dict(NVML_LIB_ENV)] + c.get("env", [])
        if c.get("name") in NVML_OPERANDS:
            c["env"].insert(0, {"name": "DRIVER_INSTALL_DIR",
                                "value": DRIVER_MOUNT})
        c["volumeMounts"].append({"name": "driver-install-dir",
                                  "mountPath": DRIVER_MOUNT,
                                  "readOnly": True})
    return c


def _opens_nvml(c: dict) -> bool:
    return c.get("command") == [METRICSD] or c.get("name") in NVML_OPERANDS


def _nvml_volume(pod: dict) -> None:
    if any(_opens_nvml(c) for c in pod.get("containers", [])):
        pod["volumes"].append({"name": "driver-install-dir", "hostPath": {
            "path": PORT_DRIVER_DIR, "type": "DirectoryOrCreate"}})


def _partition_configmap(o: dict) -> None:
    if o.get("kind") == "ConfigMap" and \
            o["metadata"]["name"] == "tpu-partition-config":
        o["metadata"]["name"] = "tpu-partition-profiles"
        o["data"] = {"profiles.json": json.dumps(builtin_profiles(),
                                                 sort_keys=True)}
    pod = o.get("spec", {}).get("template", {}).get("spec", {})
    for v in pod.get("volumes", []):
        if v.get("configMap", {}).get("name") == "tpu-partition-config":
            v["configMap"]["name"] = "tpu-partition-profiles"


def obj(o: dict) -> dict:
    """A JAX object (rendered or written) as the port's."""
    o = copy.deepcopy(o)
    _partition_configmap(o)
    md = o.get("metadata", {})
    if HASH_KEY in md.get("annotations", {}):
        md["annotations"][HASH_KEY] = "<hash>"
    tmpl = o.get("spec", {}).get("template")
    if isinstance(tmpl, dict):
        tlabels = tmpl.get("metadata", {}).get("labels", {})
        if HASH_LABEL in tlabels:
            tlabels[HASH_LABEL] = "<hash>"
        pod = tmpl.get("spec", {})
        if "tolerations" in pod:
            pod["tolerations"] = [t for t in pod["tolerations"]
                                  if t.get("key") != "google.com/tpu"]
        _nvml_volume(pod)
        for key in ("initContainers", "containers"):
            if key in pod:
                pod[key] = [_container(c) for c in pod[key]]
    return _walk(o)


def blank_hash(o: dict) -> dict:
    """A port object with its spec hashes blanked, as :func:`obj` blanks
    the JAX one's."""
    o = copy.deepcopy(o)
    md = o.get("metadata", {})
    if PORT_HASH_KEY in md.get("annotations", {}):
        md["annotations"][PORT_HASH_KEY] = "<hash>"
    tmpl = o.get("spec", {}).get("template")
    if isinstance(tmpl, dict):
        tlabels = tmpl.get("metadata", {}).get("labels", {})
        if HASH_LABEL in tlabels:
            tlabels[HASH_LABEL] = "<hash>"
    return o


# ------------------------------------------------------- cluster objects
# the labels make_tpu_node and make_gpu_node set differently
NODE_BASE_LABELS = {jax_consts.GKE_TPU_ACCELERATOR_LABEL,
                    jax_consts.GKE_TPU_TOPOLOGY_LABEL, consts.TFD_LABEL_TYPE,
                    consts.TFD_LABEL_CHIP, consts.TFD_LABEL_CHIPS_PER_HOST,
                    consts.TFD_LABEL_WORKER_ID,
                    consts.TFD_LABEL_HOSTS_PER_SLICE, consts.TFD_LABEL_LIBTPU}
RESOURCE_KEYS = ("limits", "requests", "capacity", "allocatable")
# a TPUDriver pool's accelerator type -> the GPU one
ACCEL = {"tpu-v5-lite-podslice": "nvidia-h100-80gb",
         "tpu-v6e-slice": "nvidia-h100-mega-80gb"}


def _resources(o):
    if isinstance(o, dict):
        out = {}
        for k, v in o.items():
            if k in RESOURCE_KEYS and isinstance(v, dict):
                v = {key.replace("google.com/tpu", "nvidia.com/gpu"): val
                     for key, val in v.items()}
            out[k] = _resources(v)
        return out
    if isinstance(o, list):
        return [_resources(v) for v in o]
    return o


def cluster_obj(o: dict) -> dict:
    """A JAX object of a cluster (a Node, Pod, policy, ...) as the port's
    side of the same cluster holds it (module docstring)."""
    o = _resources(copy.deepcopy(o))
    kind = o.get("kind")
    if kind == "TPUPolicy" and isinstance(o.get("spec"), dict):
        o["spec"] = policy_spec(o["spec"])
    labels = o.get("metadata", {}).get("labels", {})
    if kind == "Node" and jax_consts.GKE_TPU_ACCELERATOR_LABEL in labels:
        gpu = make_gpu_node(
            o["metadata"]["name"],
            slice_id=labels.get(consts.TFD_LABEL_SLICE_ID, ""),
            worker_id=labels.get(consts.TFD_LABEL_WORKER_ID, "0"),
            chips=int(o.get("status", {}).get("capacity", {}).get(
                consts.DEFAULT_RESOURCE_NAME, 8)))
        kept = {k: v for k, v in labels.items()
                if k not in (jax_consts.GKE_TPU_ACCELERATOR_LABEL,
                             jax_consts.GKE_TPU_TOPOLOGY_LABEL)}
        o["metadata"]["labels"] = {**gpu["metadata"]["labels"], **kept}
    return renamed(o)


def _pool_name(ds: dict, new: str) -> dict:
    """``ds`` with its name, and the ``app`` labels that carry it, ``new``."""
    old = ds["metadata"]["name"]
    for labels in (ds["metadata"]["labels"],
                   ds["spec"]["selector"]["matchLabels"],
                   ds["spec"]["template"]["metadata"]["labels"]):
        if labels.get("app") == old:
            labels["app"] = new
    ds["metadata"]["name"] = new
    return ds


def driver_daemonset(ds: dict) -> dict:
    """A JAX ``TPUDriver`` pool's DaemonSet as the port's (module
    docstring), its pool hash blanked."""
    ds = copy.deepcopy(ds)
    for t in ds["spec"]["template"]["spec"].get("tolerations", []):
        if t.get("key") == "google.com/tpu":
            t["key"] = "nvidia.com/gpu"
    out = obj(ds)
    name = out["metadata"]["name"]
    accel = next(a for a in ACCEL if a in name)
    new = name.replace(accel, ACCEL[accel])
    _pool_name(out, new[:new.rindex("-") + 1] + "<pool>")
    sel = out["spec"]["template"]["spec"]["nodeSelector"]
    sel[consts.TFD_LABEL_TYPE] = ACCEL[
        sel.pop(jax_consts.GKE_TPU_ACCELERATOR_LABEL)]
    if jax_consts.GKE_TPU_TOPOLOGY_LABEL in sel:
        sel[consts.TFD_LABEL_TOPOLOGY] = sel.pop(
            jax_consts.GKE_TPU_TOPOLOGY_LABEL)
    return out


def port_driver_daemonset(ds: dict) -> dict:
    """A port ``TPUDriver`` pool's DaemonSet with its hashes blanked, as
    :func:`driver_daemonset` leaves the JAX one."""
    ds = blank_hash(ds)
    name = ds["metadata"]["name"]
    return _pool_name(ds, name[:name.rindex("-") + 1] + "<pool>")


# ------------------------------------------------------------ gang workloads
def gpu_node(name: str, accelerator: str = "tpu-v5-lite-podslice",
             topology: str = "2x4", slice_id: str = "", worker_id: str = "0",
             extra_labels=None, chips: int = 8) -> dict:
    """``make_tpu_node(...)`` with the same arguments, as the port's side
    holds it (module docstring)."""
    return make_gpu_node(name, accelerator=accelerator, topology=topology,
                         slice_id=slice_id, worker_id=worker_id,
                         extra_labels=extra_labels, chips=chips)


def gpu_slice_node(name: str, accelerator: str = "tpu-v5-lite-podslice",
                   topology: str = "2x4", slice_id: str = "",
                   worker_id: str = "0", extra_labels=None,
                   chips: int = 8) -> dict:
    """:func:`gpu_node`, one host of a multi-node slice: fd's hosts-per-slice
    label carries the hosts the JAX package derives from ``topology`` and
    ``chips`` (a GPU node's topology is fd's alone)."""
    hosts = 1
    for dim in topology.split("x"):
        hosts *= int(dim)
    labels = {consts.TFD_LABEL_HOSTS_PER_SLICE: str(max(1, hosts // chips))}
    labels.update(extra_labels or {})
    return gpu_node(name, accelerator, topology, slice_id, worker_id,
                    labels, chips)


def pinned_policy(name: str = "gpu-policy", **spec) -> dict:
    """The port's ``sample_policy`` pinning the JAX sample's driver version
    (the port's pins none)."""
    return sample_policy(name, **{"driver": {"driverVersion": "1.10.0"},
                                  **spec})


# a node's accelerator label: GKE's on a TPU node, fd's type on a GPU node
NODE_ACCELERATOR_LABEL = {jax_consts.GKE_TPU_ACCELERATOR_LABEL:
                          consts.TFD_LABEL_TYPE}


def node_consts():
    """The port's ``consts`` as a JAX scenario reads them: its
    ``GKE_TPU_ACCELERATOR_LABEL`` is the label a node's accelerator type
    is selected by (:data:`NODE_ACCELERATOR_LABEL`)."""
    view = types.ModuleType(consts.__name__)
    view.__dict__.update({k: v for k, v in vars(consts).items()
                          if not k.startswith("__")})
    view.GKE_TPU_ACCELERATOR_LABEL = NODE_ACCELERATOR_LABEL[
        jax_consts.GKE_TPU_ACCELERATOR_LABEL]
    return view

# the JAX gang contract's names -> the port's (a pair: ``host:port``)
GANG_ENV = {"JAX_COORDINATOR_ADDRESS": ("MASTER_ADDR", "MASTER_PORT"),
            "JAX_PROCESS_ID": "RANK",
            "JAX_PROCESS_COUNT": "WORLD_SIZE"}
GANG_MESSAGES = {"(one JAX process per host)": "(one process per host)"}


def port_gang_env(env: list) -> list:
    """A JAX gang pod's env list as the port's pod carries it."""
    out = []
    for e in env:
        new = GANG_ENV.get(e["name"])
        if isinstance(new, tuple):
            host, _, port = e["value"].rpartition(":")
            out += [{"name": new[0], "value": host},
                    {"name": new[1], "value": port}]
        elif new:
            out.append({"name": new, "value": e["value"]})
        else:
            out.append(dict(e, name=rename(e["name"])))
    return out


def jax_gang_env(env: list) -> list:
    """A port gang pod's env list under the JAX contract's names (the
    inverse of :func:`port_gang_env`; the rest keep the port's names,
    :data:`RENAMED`'s of the JAX ones); the port's pod carries no
    ``JAX_*`` variable."""
    assert not [e for e in env if e["name"].startswith("JAX_")], env
    values = {e["name"]: e["value"] for e in env}
    back = {v: k for k, v in GANG_ENV.items() if isinstance(v, str)}
    host, port = GANG_ENV["JAX_COORDINATOR_ADDRESS"]
    out = []
    for e in env:
        if e["name"] == host:
            out.append({"name": "JAX_COORDINATOR_ADDRESS",
                        "value": f"{e['value']}:{values[port]}"})
        elif e["name"] != port:
            out.append({"name": back.get(e["name"], e["name"]),
                        "value": e["value"]})
    return out


def jax_gang_pod(pod: dict) -> dict:
    """A port gang pod with its containers' env under the JAX names."""
    pod = copy.deepcopy(pod)
    for c in pod.get("spec", {}).get("containers", []):
        if "env" in c:
            c["env"] = jax_gang_env(c["env"])
    return pod


def cluster_gang_pod(pod: dict) -> dict:
    """A JAX gang pod of a twin cluster as the port's gang pod reads under
    :func:`jax_gang_pod`: its resources mapped, and ``TPU_ACCELERATOR_TYPE``
    the type ``cluster_obj`` gives the port's node."""
    pod = cluster_obj(pod)
    for c in pod.get("spec", {}).get("containers", []):
        for e in c.get("env", []):
            if e["name"] == "GPU_ACCELERATOR_TYPE":
                e["value"] = make_gpu_node("")["metadata"]["labels"][
                    consts.TFD_LABEL_TYPE]
    return pod


def gang_message(message: str) -> str:
    """A JAX workload status message or event text as the port's."""
    for old, new in GANG_MESSAGES.items():
        message = message.replace(old, new)
    return message


# ------------------------------------------------------------ the runner

#: the Lease the runner elects its leader on, the JAX package's and the
#: port's
JAX_LEASE_NAME = "tpu-operator-leader"
LEASE_NAME = rename(JAX_LEASE_NAME)
#: the families the runner's ``/metrics`` merges, by registry: the port's
#: ``controllers/metrics.exposition`` serves the same names
MERGED_REGISTRIES = ("REGISTRY", "CLIENT_REGISTRY", "INFORMER_REGISTRY",
                     "RENDER_REGISTRY", "STATE_REGISTRY",
                     "REMEDIATION_REGISTRY", "WORKLOAD_REGISTRY",
                     "WORKER_REGISTRY")
#: ``prometheus_client``'s default registry in the JAX runner's
#: ``/metrics``, served by the port under the same names from the standard
#: library (``controllers/metrics.process_exposition``)
PROCESS_FAMILIES = ("python_gc_objects_collected_total",
                    "python_gc_objects_uncollectable_total",
                    "python_gc_collections_total", "python_info",
                    "process_virtual_memory_bytes",
                    "process_resident_memory_bytes",
                    "process_start_time_seconds",
                    "process_cpu_seconds_total", "process_open_fds",
                    "process_max_fds")


def jax_only_family(family: str) -> bool:
    """A family only ``prometheus_client`` writes: the ``_created``
    companion of a counter or histogram (creation time in seconds)."""
    return family.endswith("_created")


# ------------------------------------------------------------ packaging

#: the JAX package's deploy trees (paths from the repo's root) -> the port's
DEPLOY_PATHS = {
    "deployments/tpu-operator": "tpu_operator_torch/deploy/chart",
    "deployments/tpu-operator/crds": "tpu_operator_torch/deploy/chart/crds",
    "config": "tpu_operator_torch/deploy/config",
    "config/crd/bases": "tpu_operator_torch/deploy/config/crd/bases",
    "bundle": "tpu_operator_torch/deploy/bundle",
    "docker": "tpu_operator_torch/deploy/docker",
    "scripts": "tpu_operator_torch/deploy/scripts",
    "tests/e2e_shims": "tpu_operator_torch/testing/e2e_shims",
    "manifests": "tpu_operator_torch/manifests",
}
#: what a generated CRD, a sample or the chart's values carry for the JAX
#: package and the port: the evidence label's PCI vendor, the resource,
#: the generators' package, and the driver version the chart pins (the
#: port's chart pins none)
PACKAGING_VALUES = {
    "1ae0": "10de",
    '"1ae0"': '"10de"',
    "google.com/tpu": "nvidia.com/gpu",
    "1.10.0": "",
    "tpu_operator.cmd.gen_crds": "tpu_operator_torch.cmd.gen_crds",
    "tpu_operator.cmd.gen_csv": "tpu_operator_torch.cmd.gen_csv",
}


def crd(jax_crd: dict) -> dict:
    """A JAX CRD as the port generates it: the validator's sub-specs
    ``jax``/``ici`` are ``torch``/``nccl``, in the port's field order."""
    out = copy.deepcopy(jax_crd)
    spec = out["spec"]["versions"][0]["schema"]["openAPIV3Schema"][
        "properties"]["spec"]["properties"]
    if "validator" in spec:
        v = spec["validator"]["properties"]
        subs = {("torch" if k == "jax" else "nccl" if k == "ici" else k):
                   val for k, val in v.items()}
        order = ["enabled", "repository", "image", "version",
                 "imagePullPolicy", "imagePullSecrets", "args", "env",
                 "resources", "device", "driver", "toolkit", "torch", "perf",
                 "plugin", "nccl", "metrics"]
        spec["validator"]["properties"] = {k: subs[k] for k in order}
    return renamed(out)


# --------------------------------------------------------------- tpulint
#: the JAX gate's modules and files, as the port's gate
#: (``tpu_operator_torch/analysis/``) names them: the package, the
#: committed inventory and the mypy config (the JAX ones are the root's
#: ``docs/ASYNC_INVENTORY.md`` and ``mypy.ini``; the port keeps its own
#: inside its package)
ANALYSIS_FILES = {
    "docs/ASYNC_INVENTORY.md": "tpu_operator_torch/ASYNC_INVENTORY.md",
    "mypy.ini": "tpu_operator_torch/mypy.ini",
}


def analysis_module(name: str) -> str:
    """``tpu_operator[.x]`` → ``tpu_operator_torch[.x]``."""
    if name == "tpu_operator" or name.startswith("tpu_operator."):
        return "tpu_operator_torch" + name[len("tpu_operator"):]
    return name


def analysis_path(rel: str) -> str:
    """A repo-relative path of the JAX gate's, as the port's gate has it."""
    if rel in ANALYSIS_FILES:
        return ANALYSIS_FILES[rel]
    if rel.startswith("tpu_operator/"):
        return "tpu_operator_torch/" + rel[len("tpu_operator/"):]
    return rel


#: the string constants of ``tests/test_analysis_engine.py``'s scenarios
#: that name the JAX package, by scenario
_NODE_AGENT_STACK = ("tpu_operator.cmd.operator", "tpu_operator.driver.install",
                     "tpu_operator.host", "tpu_operator.validator.healthwatch",
                     "tpu_operator.toolkit.containerd",
                     "tpu_operator.exporter.exporter",
                     "tpu_operator.statusfiles")
ANALYSIS_LITERALS = {
    "test_hot_path_excludes_node_agent_stack":
        {m: analysis_module(m) for m in _NODE_AGENT_STACK},
    "test_inventory_is_deterministic_and_parses_back":
        {"docs": "tpu_operator_torch"},
    "test_inventory_has_no_line_numbers": {"docs": "tpu_operator_torch"},
}


def port_analysis_tree(src, dst) -> dict:
    """Copy the JAX gate's fixture tree ``src`` to ``dst`` as the port's
    gate reads it, and return ``{JAX path: port path}`` for its files.

    A tree that holds the JAX package, its inventory or its mypy config
    (``TPULNT302``, ``TPULNT150``) becomes one that holds the port's
    package with them inside it (:data:`ANALYSIS_FILES`), its other
    root-level sources moved in beside them (a root holding the package is
    scanned as the package), and ``tpu_operator.`` module names in the
    inventory and the mypy sections as ``tpu_operator_torch.``.  Any other
    tree is copied as it is."""
    import pathlib
    import shutil

    src, dst = pathlib.Path(src), pathlib.Path(dst)
    rels = sorted(p.relative_to(src).as_posix() for p in src.rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts)
    ported = any(analysis_path(r) != r for r in rels)
    paths = {}
    for rel in rels:
        new = analysis_path(rel)
        if ported and new == rel and "/" not in rel and rel.endswith(".py"):
            new = "tpu_operator_torch/" + rel
        paths[rel] = new
        out = dst / new
        out.parent.mkdir(parents=True, exist_ok=True)
        if rel in ANALYSIS_FILES:
            out.write_text((src / rel).read_text().replace(
                "tpu_operator.", "tpu_operator_torch."))
        else:
            shutil.copyfile(src / rel, out)
    return paths
