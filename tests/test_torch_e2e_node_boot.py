"""The port's node bring-up end to end (``host``, the driver and toolkit
agents, ``validator/components.py``, ``fd``, the device plugin over
``testing/grpc_kubelet.py``, the node-status exporter) against the JAX
package's.

Every scenario of ``tests/test_e2e_node_boot.py`` runs on the port
(``tests/torch_scenarios.py``): its fixture's host is the port's fake GPU
host with the same cards, worker, slice and hosts per slice, and NVML is
a fake over those cards (``torch_fake_nvml``; it starts unavailable in
each test).  The two scenarios that install the driver are in
:data:`ADAPTED`: the port's driver agent installs nothing — ``install``
checks the driver the node carries and takes no ``--libtpu-*`` flag
(ROADMAP "Deliberate differences", driver agent) — so each has a twin
below that boots the node in the same order with the port's agents and
checks what the scenario checks, under the key map (the driver's version
where JAX reads libtpu's, ``nvidia.com/gpu`` CDI names, the ``torch``
component where JAX has ``jax``)."""

import json
import os

import pytest

import test_e2e_node_boot as jax_scenarios
import torch_keymap as km
import torch_rebind
import torch_scenarios
from tpu_operator_torch import consts, statusfiles
from tpu_operator_torch.client import FakeClient
from tpu_operator_torch.deviceplugin import DevicePluginServer
from tpu_operator_torch.driver.__main__ import main as driver_main
from tpu_operator_torch.exposition import parse, render
from tpu_operator_torch.fd.discovery import sync_node_labels
from tpu_operator_torch.host import make_fake_host
from tpu_operator_torch.testing.grpc_kubelet import DevicePluginClient
from tpu_operator_torch.toolkit.__main__ import main as toolkit_main
from tpu_operator_torch.validator.components import (Context,
                                                     ValidationError,
                                                     run_component)
from tpu_operator_torch.validator.metrics import NodeStatusCollector

from torch_fake_nvml import (DRIVER_VERSION, FakeNVML,  # noqa: F401
                             cards_of, no_host_nvml, use_nvml)

# case -> the "Deliberate differences" entry of ROADMAP.md it reaches
ADAPTED = {
    "test_full_node_boot_sequence":
        "Driver agent: installs and removes nothing; install checks the "
        "driver the node carries",
    "test_boot_fails_on_corrupt_containerd_dropin":
        "Driver agent: installs and removes nothing; install checks the "
        "driver the node carries",
}
LIBS = ("libcuda.so.1", "libnvidia-ml.so.1")


def make_gpu_host(root, chips, worker_id, hosts_per_slice, slice_id):
    """``make_fake_host`` of the JAX package, as the port's GPU host."""
    return make_fake_host(root, chips=chips, worker_id=worker_id,
                          hosts_per_slice=hosts_per_slice, slice_id=slice_id,
                          driver_version=DRIVER_VERSION)


SCENARIOS = torch_scenarios.port_twins(
    jax_scenarios, **torch_scenarios.port_globals(
        jax_scenarios, make_fake_host=make_gpu_host,
        make_tpu_node=km.gpu_node))
CASES = torch_scenarios.scenario_cases(jax_scenarios, ADAPTED)
PORT_MODULES = torch_scenarios.port_modules_of(jax_scenarios)


@pytest.fixture(autouse=True)
def _port_state():
    with torch_rebind.port_state():
        yield


def test_every_e2e_node_boot_scenario_is_here():
    assert len(CASES) + len(ADAPTED) == 3
    assert set(ADAPTED) <= set(vars(jax_scenarios))


@pytest.mark.parametrize("name,fn,kwargs", CASES,
                         ids=[c[0] for c in CASES])
def test_scenario_on_the_port(name, fn, kwargs, monkeypatch, tmp_path):
    torch_rebind.imports_from_port(monkeypatch, PORT_MODULES)
    torch_scenarios.call_with_fixtures(jax_scenarios, SCENARIOS, fn, kwargs,
                                    tmp_path=tmp_path,
                                    monkeypatch=monkeypatch)


# ------------------------------------------------------- the adapted twins

@pytest.fixture
def boot_env(tmp_path, monkeypatch):
    """The scenario's fixture on the port: the fake GPU host, the host's
    driver libraries in the install dir, NVML over its cards."""
    torch_rebind.imports_from_port(monkeypatch, PORT_MODULES)
    host, env = torch_scenarios.call_with_fixtures(
        jax_scenarios, SCENARIOS, "boot_env", {}, tmp_path=tmp_path,
        monkeypatch=monkeypatch)
    os.makedirs(env["install"])
    for name in LIBS:
        with open(os.path.join(env["install"], name), "wb") as f:
            f.write(b"\x7fELF")
    use_nvml(monkeypatch, FakeNVML(cards_of(host)))
    return host, env


def _install(host, env) -> int:
    """The driver DaemonSet's container: check the node's driver, open the
    barrier (no ``--libtpu-*``: the agent installs nothing)."""
    return driver_main(["install", f"--driver-version={DRIVER_VERSION}",
                        "--one-shot", f"--host-root={host.root}",
                        f"--install-dir={env['install']}",
                        f"--status-dir={env['status']}"])


def _toolkit(host, env) -> int:
    return toolkit_main([f"--install-dir={env['install']}",
                         f"--cdi-root={env['cdi']}",
                         f"--containerd-conf-dir={env['conf']}",
                         f"--host-root={host.root}",
                         f"--status-dir={env['status']}", "--one-shot"])


def test_full_node_boot_sequence_on_a_gpu_host(boot_env):
    host, env = boot_env
    # 1. driver DaemonSet container: the node's driver checked, barrier open
    assert _install(host, env) == 0
    assert statusfiles.read_status(consts.DRIVER_CTR_READY, env["status"])[
        "driver_version"] == DRIVER_VERSION

    # 2. toolkit DaemonSet: CDI spec + containerd drop-in
    assert _toolkit(host, env) == 0
    assert os.path.exists(os.path.join(env["conf"],
                                       "zz-tpu-operator-cdi.toml"))

    # 3. validator init chain: device -> driver -> toolkit
    ctx = Context(host=host, status_dir=env["status"], node_name="n0",
                  sleep=lambda s: None)
    for comp in ("device", "driver", "toolkit"):
        run_component(comp, ctx)
    for fname in ("device-ready", consts.STATUS_FILE_DRIVER,
                  consts.STATUS_FILE_TOOLKIT):
        assert statusfiles.read_status(fname, env["status"]) is not None
    driver_status = statusfiles.read_status(consts.STATUS_FILE_DRIVER,
                                            env["status"])
    assert DRIVER_VERSION in driver_status.values()

    # 4. feature discovery publishes the node labels
    client = FakeClient([km.gpu_node("n0", chips=4)])
    sync_node_labels(client, "n0", host)
    labels = client.get("Node", "n0")["metadata"]["labels"]
    assert labels[consts.TFD_LABEL_LIBTPU] == DRIVER_VERSION
    assert labels[consts.TFD_LABEL_TOPOLOGY] == "4x4"
    assert labels[consts.TFD_LABEL_WORKER_ID] == "1"

    # 5. device plugin serves the cards over real kubelet gRPC
    srv = DevicePluginServer(host, plugin_dir=env["status"] + "-plugins")
    srv.start()
    try:
        dp = DevicePluginClient(srv.socket_path)
        devs = dp.list_and_watch_once()
        assert [d.ID for d in devs] == ["0", "1", "2", "3"]
        alloc = dp.allocate(["0", "1", "2", "3"])
        assert [c.name for c in alloc.cdi_devices] == ["nvidia.com/gpu=all"]
        with open(os.path.join(env["cdi"], "tpu-operator.json")) as f:
            spec = json.load(f)
        spec_names = {f"{spec['kind']}={d['name']}" for d in spec["devices"]}
        assert set(c.name for c in alloc.cdi_devices) <= spec_names
        assert alloc.envs["TPU_WORKER_ID"] == "1"
        dp.close()
    finally:
        srv.stop()

    # 6. node-status exporter reflects the barrier files
    families = parse(render(NodeStatusCollector(env["status"],
                                                host).collect()))

    def ready(component):
        (sample,) = families[f"tpu_operator_node_{component}_ready"].samples
        return sample[2]

    assert [ready(c) for c in ("device", "driver", "toolkit", "torch")] == [
        1.0, 1.0, 1.0, 0.0]


def test_boot_fails_on_corrupt_containerd_dropin_on_a_gpu_host(boot_env):
    host, env = boot_env
    _install(host, env)
    _toolkit(host, env)
    # a config-management tool tramples the drop-in
    with open(os.path.join(env["conf"], "zz-tpu-operator-cdi.toml"),
              "w") as f:
        f.write("version = [torn")
    ctx = Context(host=host, status_dir=env["status"], node_name="n0",
                  sleep=lambda s: None)
    run_component("device", ctx)
    run_component("driver", ctx)
    with pytest.raises(ValidationError, match="invalid TOML"):
        run_component("toolkit", ctx)
    # barrier stays shut: downstream stages keep blocking
    assert statusfiles.read_status(consts.STATUS_FILE_TOOLKIT,
                                   env["status"]) is None


def test_the_jax_install_flags_are_refused(boot_env):
    """The deliberate difference itself: the JAX scenario's ``install``
    with a libtpu version and source does not parse on the port."""
    host, env = boot_env
    with pytest.raises(SystemExit):
        driver_main(["install", "--libtpu-version=1.10.0",
                     f"--libtpu-source={env['libtpu_src']}", "--one-shot",
                     f"--host-root={host.root}",
                     f"--install-dir={env['install']}",
                     f"--status-dir={env['status']}"])
