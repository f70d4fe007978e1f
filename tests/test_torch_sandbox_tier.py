"""The port's sandbox tier (``cc/manager.py``, ``kata/manager.py``, their
CLIs, the kata and cc states of ``state/{manager,states}.py``,
``statusfiles.py``) against the JAX package's.

Every scenario of ``tests/test_sandbox_tier.py`` runs as written on the
port (``tests/torch_scenarios.py``; ``import tpu_operator.kata.manager as
km`` inside a scenario reaches the port's module) under the key map of
``tests/torch_keymap.py``.  NVML starts unavailable in each test
(``torch_fake_nvml.no_host_nvml``), which the port reads as a card that
is not CC-capable.  The one scenario that needs a card in CC mode is in
:data:`ADAPTED`: the port's ``cc`` manager reads the card's CC feature
through NVML besides the TEE platform (ROADMAP "Deliberate differences",
cc manager), so its twin runs the scenario as written with a fake NVML
whose card is in CC mode exactly where the host is a TEE guest (the key
map of ``tests/test_torch_cc.py``), and pins that a TEE guest whose card
is not in CC mode holds the barrier."""

import pytest

import test_sandbox_tier as jax_scenarios
import torch_keymap as km
import torch_rebind
import torch_scenarios
from tpu_operator_torch import consts, statusfiles, testing
from tpu_operator_torch.cc.manager import detect_cc
from tpu_operator_torch.cc.manager import sync as cc_sync
from tpu_operator_torch.client import FakeClient
from tpu_operator_torch.testing import fake_cluster

from torch_fake_nvml import FakeNVML, no_host_nvml, use_nvml  # noqa: F401

# case -> the "Deliberate differences" entry of ROADMAP.md it reaches
ADAPTED = {"test_cc_sync_mode_on_unsatisfiable_holds_barrier":
           "cc manager: an on request is met only by a TEE platform and "
           "a card in CC mode"}
CARD = [{"minor": 0, "bus_id": "00000000:04:00.0", "device_id": "0x2330",
         "uuid": "GPU-00000000-0000-0000-0000-000000000000",
         "name": "NVIDIA H100 80GB HBM3"}]

KEY_MAP = dict(consts=km.node_consts(), make_tpu_node=km.gpu_slice_node,
               sample_policy=km.pinned_policy)
SCENARIOS = torch_scenarios.port_twins(
    jax_scenarios, **torch_scenarios.port_globals(jax_scenarios, **KEY_MAP))
CASES = torch_scenarios.scenario_cases(jax_scenarios, ADAPTED)
PORT_MODULES = torch_scenarios.port_modules_of(
    jax_scenarios, testing=torch_rebind.module_view(testing, **KEY_MAP),
    testing_fake_cluster=torch_rebind.module_view(fake_cluster, **KEY_MAP))


@pytest.fixture(autouse=True)
def _port_state():
    with torch_rebind.port_state():
        yield


def test_every_sandbox_tier_scenario_is_here():
    assert len(CASES) + len(ADAPTED) == 15
    assert set(ADAPTED) <= set(vars(jax_scenarios))


@pytest.mark.parametrize("name,fn,kwargs", CASES,
                         ids=[c[0] for c in CASES])
def test_scenario_on_the_port(name, fn, kwargs, monkeypatch, tmp_path):
    torch_rebind.imports_from_port(monkeypatch, PORT_MODULES)
    torch_scenarios.call_with_fixtures(jax_scenarios, SCENARIOS, fn, kwargs,
                                    tmp_path=tmp_path,
                                    monkeypatch=monkeypatch)


def _card(monkeypatch, feature: bool) -> None:
    use_nvml(monkeypatch, FakeNVML(CARD, cc={
        "cc_feature": int(feature), "gpus_caps": 1,
        "environment": 2 if feature else 0}))


def test_cc_mode_on_is_met_by_a_tee_guest_whose_card_is_in_cc_mode(
        tmp_path, monkeypatch):
    """The scenario as written, each ``sync`` pass on a card in CC mode
    exactly where the host is a TEE guest; then the same TEE guest with
    its card out of CC mode: ``on`` is not met and the barrier closes."""
    def sync_under_the_key_map(client, node, root, status, **kw):
        _card(monkeypatch, feature=detect_cc(root)[1])
        return cc_sync(client, node, root, status, **kw)

    twin = torch_scenarios.port_twins(jax_scenarios, **dict(
        torch_scenarios.port_globals(jax_scenarios, **KEY_MAP),
        cc_sync=sync_under_the_key_map))
    twin["test_cc_sync_mode_on_unsatisfiable_holds_barrier"](tmp_path)

    _card(monkeypatch, feature=False)
    client = FakeClient([km.gpu_node("n1")])
    status = str(tmp_path / "status")
    assert cc_sync(client, "n1", str(tmp_path / "cvm"), status,
                   default_mode="on") is False
    assert statusfiles.read_status(consts.STATUS_FILE_CC, status) is None
    assert client.get("Node", "n1")["metadata"]["labels"][
        consts.CC_MODE_STATE_LABEL] == "off"
