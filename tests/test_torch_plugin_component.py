"""The port's ``plugin`` validator component against the JAX package's,
side by side on their ``FakeClient``s, then end to end over HTTP on the
port's stub apiserver.

Key map: the resource ``google.com/tpu`` <-> ``nvidia.com/gpu`` (the device
plugin's), the pod's command ``tpu_operator.validator --component=ici`` <->
``tpu_operator_torch.validator --component=nccl``; the pod's name, label,
container name, namespace and env under ``torch_keymap.RENAMED``.  The JAX
pod's compile cache (``JAX_COMPILATION_CACHE_DIR``, its ``jax-cache``
hostPath) is the port's kernel build dir (``consts.BUILD_DIR_ENV``,
``consts.BUILD_DIR_ON_NODE``, ``kernel-cache``): the in-pod nccl check
launches the matmul kernel, and loads the library the validator built."""

import threading
import time

import pytest

import torch_keymap as km
from tpu_operator.client import FakeClient as JaxFakeClient
from tpu_operator.host import make_fake_host as jax_fake_host
from tpu_operator.testing.fake_cluster import make_tpu_node
from tpu_operator.validator import components as jax_components
from tpu_operator_torch import consts, statusfiles
from tpu_operator_torch.client import FakeClient
from tpu_operator_torch.client.resilience import resilient_incluster_client
from tpu_operator_torch.host import make_fake_host
from tpu_operator_torch.testing.stub_apiserver import StubApiServer
from tpu_operator_torch.validator import components

RESOURCES = {"google.com/tpu": "nvidia.com/gpu"}
COMMANDS = {"tpu_operator.validator": "tpu_operator_torch.validator",
            "--component=ici": "--component=nccl"}
JAX_CACHE = "/run/tpu/jax-cache"

SIDES = {"jax": (jax_components, JaxFakeClient),
         "torch": (components, FakeClient)}


def _mapped(text: str) -> str:
    for tpu, gpu in RESOURCES.items():
        text = text.replace(tpu, gpu)
    return text


def _node(side: str, chips: int = 4) -> dict:
    node = make_tpu_node("node-0", chips=chips)
    if side == "torch":
        cap = node["status"]["capacity"]
        node["status"]["capacity"] = {RESOURCES.get(k, k): v
                                      for k, v in cap.items()}
    return node


class _Recording:
    """A client that records each verb with its kind and name, then hands
    the call to the fake."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def __getattr__(self, verb):
        fn = getattr(self.inner, verb)

        def call(*args, **kw):
            obj = args[0] if args and isinstance(args[0], dict) else None
            what = ((obj["kind"], obj["metadata"]["name"]) if obj
                    else tuple(a for a in args if isinstance(a, str))[:2])
            self.calls.append((verb, *what))
            return fn(*args, **kw)
        return call


@pytest.fixture(autouse=True)
def _no_resource_env(monkeypatch):
    for key in ("TPU_RESOURCE_NAME", "TPU_RESOURCE_BASE_NAME", "NODE_NAME",
                "OPERATOR_NAMESPACE", "VALIDATOR_IMAGE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.delenv("MEGASCALE_ENABLED", raising=False)


def _ctx(side, tmp_path, client, sleep):
    mod = SIDES[side][0]
    host = (jax_fake_host if side == "jax" else make_fake_host)(
        str(tmp_path / side / "host"), chips=4)
    return mod.Context(host=host, status_dir=str(tmp_path / side / "status"),
                       node_name="node-0",
                       namespace=km.on(side == "torch", "tpu-operator"),
                       client_factory=lambda: client, sleep=sleep,
                       validator_image="img:test")


def _kubelet(client, phase, message="", finalize_at=None,
             namespace="tpu-operator"):
    """The sleep of the component: plays the kubelet — on each sleep,
    every live workload pod takes ``phase``; Terminating pods are reaped
    at sleep ``finalize_at``."""
    sleeps = {"n": 0}

    def sleep(_seconds):
        sleeps["n"] += 1
        if finalize_at is not None and sleeps["n"] == finalize_at:
            client.finalize_pods()
        for pod in client.list("Pod", namespace):
            if "deletionTimestamp" in pod["metadata"] or phase is None:
                continue
            pod["status"] = {"phase": phase, "message": message}
            client.update_status(pod)
    return sleep, sleeps


def _run_case(side, tmp_path, case, monkeypatch):
    mod, fake = SIDES[side]
    node = _node(side)
    if case == "no-capacity":
        node["status"]["capacity"] = {}
        monkeypatch.setattr(mod, "RESOURCE_WAIT_RETRIES", 2)
    stale_pod = case in ("terminating-stale-pod", "stale-never-finalizes")
    inner = fake([node], async_pod_deletion=stale_pod)
    ns = km.on(side == "torch", "tpu-operator")
    if stale_pod:
        inner.create({"apiVersion": "v1", "kind": "Pod",
                      "metadata": {"name": km.on(
                          side == "torch", "tpu-validation-workload-node-0"),
                                   "namespace": ns},
                      "spec": {"nodeName": "node-0"},
                      "status": {"phase": "Running"}})
    if case == "stale-never-finalizes":
        monkeypatch.setattr(mod, "POD_WAIT_RETRIES", 3)
    phase = {"pod-failure": "Failed", "no-capacity": None,
             "stale-never-finalizes": None}.get(case, "Succeeded")
    sleep, sleeps = _kubelet(inner, phase, message="OOM",
                             finalize_at=2 if case == "terminating-stale-pod"
                             else None, namespace=ns)
    client = _Recording(inner)
    ctx = _ctx(side, tmp_path, client, sleep)
    try:
        outcome = ("ok", mod.validate_plugin(ctx))
    except mod.ValidationError as e:
        outcome = ("ValidationError", _mapped(str(e)))
    left = [p["metadata"]["name"] for p in inner.list("Pod", ns)
            if "deletionTimestamp" not in p["metadata"]]
    return {"outcome": outcome, "calls": client.calls, "sleeps": sleeps["n"],
            "live_pods_left": left}


CASES = ["happy-path", "pod-failure", "no-capacity", "terminating-stale-pod",
         "stale-never-finalizes"]


@pytest.mark.parametrize("case", CASES)
def test_validate_plugin_matches_jax(case, tmp_path, monkeypatch):
    want = _run_case("jax", tmp_path, case, monkeypatch)
    got = _run_case("torch", tmp_path, case, monkeypatch)
    if want["outcome"][0] == "ok":
        want["outcome"][1]["resource"] = _mapped(
            want["outcome"][1]["resource"])
    assert got == km.renamed(want)
    expected = {
        "happy-path": ("ok", {"resource": "nvidia.com/gpu",
                              "capacity": "4"}),
        "pod-failure": ("ValidationError", "workload pod "
                        "gpu-validation-workload-node-0 failed: OOM"),
        "no-capacity": ("ValidationError", "nvidia.com/gpu never appeared "
                        "in node node-0 capacity after 10s"),
        "terminating-stale-pod": ("ok", {"resource": "nvidia.com/gpu",
                                         "capacity": "4"}),
        "stale-never-finalizes": ("ValidationError", "stale workload pod "
                                  "gpu-validation-workload-node-0 never "
                                  "finalized within 15s"),
    }[case]
    assert got["outcome"] == expected
    assert got["live_pods_left"] == []
    if case == "terminating-stale-pod":
        assert got["sleeps"] >= 2      # the 409 path was exercised


def test_workload_pod_spec_matches_jax_under_the_key_map(tmp_path,
                                                         monkeypatch):
    for name, value in (("MEGASCALE_NUM_SLICES", "2"),
                        ("MEGASCALE_COORDINATOR_ADDRESS", "10.0.0.1")):
        monkeypatch.setenv(name, value)                 # the JAX package's
        monkeypatch.setenv(km.rename(name), value)      # the port's
    jax_ctx = _ctx("jax", tmp_path, None, None)
    jax_ctx.resource_name = "google.com/tpu"
    jax_ctx.base_resource_name = "google.com/tpu"
    want = jax_components._workload_pod_spec(jax_ctx, 4)
    got = components._workload_pod_spec(_ctx("torch", tmp_path, None, None),
                                        4)

    # the key map, applied field by field to the JAX spec
    ctr = want["spec"]["containers"][0]
    ctr["command"] = [COMMANDS.get(a, a) for a in ctr["command"]]
    ctr["args"] = [COMMANDS.get(a, a) for a in ctr["args"]]
    for section in ("limits", "requests"):
        ctr["resources"][section] = {
            RESOURCES[k]: v for k, v in ctr["resources"][section].items()}
    want["spec"]["tolerations"][0]["key"] = RESOURCES[
        want["spec"]["tolerations"][0]["key"]]
    # the cache: the JAX compile cache's env, mount and volume are the
    # kernel build dir's
    assert ctr["env"][0] == {"name": "JAX_COMPILATION_CACHE_DIR",
                             "value": JAX_CACHE}
    ctr["env"][0] = dict(km.BUILD_DIR_ENV)
    assert ctr["volumeMounts"] == [{"name": "jax-cache",
                                    "mountPath": JAX_CACHE}]
    ctr["volumeMounts"][0]["mountPath"] = consts.BUILD_DIR_ON_NODE
    (volume,) = want["spec"]["volumes"]
    assert volume["hostPath"] == {"path": JAX_CACHE,
                                  "type": "DirectoryOrCreate"}
    volume["hostPath"]["path"] = consts.BUILD_DIR_ON_NODE
    assert got == km.renamed(want)
    gctr = got["spec"]["containers"][0]
    assert gctr["command"] == ["python", "-m", "tpu_operator_torch.validator"]
    assert gctr["args"] == ["--component=nccl", "--in-pod"]
    assert gctr["env"] == [
        {"name": "TPU_OPERATOR_TORCH_BUILD_DIR", "value": "/run/gpu/build"},
        {"name": "GPU_MULTISLICE_COORDINATOR_ADDRESS", "value": "10.0.0.1"},
        {"name": "GPU_MULTISLICE_NUM_SLICES", "value": "2"}]
    # only the build dir: the status files stay out of the pod's reach
    assert gctr["volumeMounts"] == [{"name": "kernel-cache",
                                     "mountPath": "/run/gpu/build"}]
    assert got["spec"]["volumes"] == [{"name": "kernel-cache", "hostPath": {
        "path": "/run/gpu/build", "type": "DirectoryOrCreate"}}]
    assert not consts.DEFAULT_STATUS_DIR.startswith(consts.BUILD_DIR_ON_NODE)
    assert got["metadata"] == {"name": "gpu-validation-workload-node-0",
                               "namespace": "gpu-operator",
                               "labels": {"app": "gpu-validation-workload"}}


def test_in_pod_nccl_calls_the_matmul_wrapper(tmp_path, monkeypatch):
    """Why the pod mounts the kernel build dir: the in-pod nccl check on
    one card (the burn-in, two train steps) calls the matmul kernel's
    wrapper five times a step, and no other kernel's; it writes no status
    file."""
    from tpu_operator_torch.validator import ops

    calls = []
    inner = ops.matmul_bf16_f32

    def counting(*args, **kwargs):
        calls.append(kwargs.get("kt", 0))
        return inner(*args, **kwargs)

    def no_kernel(*a, **k):
        raise AssertionError("the in-pod nccl check called another kernel")

    monkeypatch.setattr(ops, "matmul_bf16_f32", counting)
    for name in ("triad_", "fma_relu"):
        monkeypatch.setattr(ops, name, no_kernel)
    values = components.run_component(
        "nccl", components.Context(status_dir=str(tmp_path), device="cpu",
                                   world=1), in_pod=True)
    assert values["devices"] == "1"
    assert calls == [0] * 10
    assert list(tmp_path.iterdir()) == []


def test_context_defaults_match_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("NODE_NAME", "n7")
    monkeypatch.setenv("TPU_RESOURCE_NAME", "nvidia.com/gpu.shared")
    monkeypatch.setenv("GPU_RESOURCE_NAME", "nvidia.com/gpu.shared")
    host = make_fake_host(str(tmp_path / "h"), chips=1)
    ctx = components.Context(host=host, status_dir=str(tmp_path))
    jctx = jax_components.Context(host=jax_fake_host(str(tmp_path / "j")),
                                  status_dir=str(tmp_path))
    for field in ("node_name", "namespace", "resource_name",
                  "base_resource_name", "validator_image"):
        assert getattr(ctx, field) == km.rename(getattr(jctx, field)), field
    assert ctx.base_resource_name == "nvidia.com/gpu"
    monkeypatch.delenv("GPU_RESOURCE_NAME")
    assert components.Context(host=host).resource_name == "nvidia.com/gpu"
    assert components.RESOURCE_WAIT_RETRIES == 30
    assert components.RESOURCE_WAIT_SLEEP_S == 5.0


def test_plugin_requires_api_access(tmp_path):
    ctx = components.Context(host=make_fake_host(str(tmp_path / "h")),
                             status_dir=str(tmp_path / "s"))
    with pytest.raises(components.ValidationError, match="API access"):
        components.validate_plugin(ctx)


# --------------------------------------------------------------------------
# end to end over HTTP: the port's stub, the port's resilient client, a
# kubelet thread
# --------------------------------------------------------------------------

def _http_kubelet(client, stop, cards):
    """Advertise the cards in the Node's capacity after a moment, then
    run each workload pod that appears: Succeeded."""
    time.sleep(0.1)
    node = client.get("Node", "node-0")
    node["status"]["capacity"] = {"nvidia.com/gpu": str(cards)}
    client.update_status(node)
    while not stop.is_set():
        for pod in client.list("Pod", consts.DEFAULT_NAMESPACE):
            if ("deletionTimestamp" not in pod["metadata"]
                    and not pod.get("status", {}).get("phase")):
                pod["status"] = {"phase": "Succeeded"}
                client.update_status(pod)
        stop.wait(0.02)


def test_plugin_component_end_to_end_over_http(tmp_path):
    stub = StubApiServer([{"apiVersion": "v1", "kind": "Node",
                           "metadata": {"name": "node-0"},
                           "spec": {}, "status": {"capacity": {}}}])
    component_client = resilient_incluster_client(api_server=stub.url,
                                                  token="t")
    kubelet_client = resilient_incluster_client(api_server=stub.url,
                                                token="t")
    stop = threading.Event()
    kubelet = threading.Thread(target=_http_kubelet,
                               args=(kubelet_client, stop, 2), daemon=True)
    kubelet.start()
    status_dir = str(tmp_path / "status")
    try:
        values = components.run_component("plugin", components.Context(
            host=make_fake_host(str(tmp_path / "h"), chips=2),
            status_dir=status_dir, node_name="node-0",
            namespace=consts.DEFAULT_NAMESPACE,
            client_factory=lambda: component_client,
            sleep=lambda s: time.sleep(0.2)))
        assert values == {"resource": "nvidia.com/gpu", "capacity": "2"}
        assert statusfiles.read_status(consts.STATUS_FILE_PLUGIN,
                                       status_dir) == values
        # the workload pod is deleted: Terminating, then gone
        deadline = time.monotonic() + 5
        while component_client.list("Pod", consts.DEFAULT_NAMESPACE):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        creates = [r for r in stub.requests
                   if r == ("POST", "/api/v1/namespaces/gpu-operator/pods")]
        assert len(creates) == 1
    finally:
        stop.set()
        kubelet.join(timeout=5)
        loops = [c.loop_bridge._thread for c in (component_client,
                                                 kubelet_client)]
        component_client.close()
        kubelet_client.close()
        stub.shutdown()
    assert not kubelet.is_alive()
    # both clients' loop threads, the kubelet's watch with them, are gone
    assert all(t is not None and not t.is_alive() for t in loops)


def test_cli_accepts_plugin_and_builds_the_resilient_client(monkeypatch):
    from tpu_operator_torch.client.incluster import InClusterClient
    from tpu_operator_torch.client.resilience import RetryingClient
    from tpu_operator_torch.validator import __main__ as cli

    assert cli.make_parser().parse_args(
        ["--component=plugin"]).component == "plugin"
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.1.2.3")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "443")
    client = cli._default_client_factory()
    try:
        assert isinstance(client, RetryingClient)
        assert isinstance(client.inner, InClusterClient)
        assert client.api_server == "https://10.1.2.3:443"
        assert client.inner.loop_bridge._thread is None   # nothing sent
    finally:
        client.close()


def test_cli_runs_plugin_on_a_fake_client(tmp_path, monkeypatch, capsys):
    """``--component=plugin`` through the CLI on a fake client: it writes
    plugin-ready and leaves no workload pod."""
    from tpu_operator_torch.validator import __main__ as cli

    client = FakeClient([_node("torch")])

    def kubelet(verb, obj):
        # the kubelet runs the pod at once: created Succeeded
        if obj is not None:
            obj["status"] = {"phase": "Succeeded"}

    client.reactors.append(("create", "Pod", kubelet))
    monkeypatch.setattr(cli, "_default_client_factory", lambda: client)
    monkeypatch.setenv("NODE_NAME", "node-0")
    status_dir = tmp_path / "status"
    rc = cli.main(["--component=plugin", f"--status-dir={status_dir}",
                   f"--host-root={tmp_path}"])
    assert rc == 0, capsys.readouterr().err
    assert "validation of plugin OK: resource=nvidia.com/gpu capacity=4" in \
        capsys.readouterr().out
    assert statusfiles.read_status("plugin-ready", str(status_dir)) == {
        "resource": "nvidia.com/gpu", "capacity": "4"}
    assert client.list("Pod", "tpu-operator") == []
