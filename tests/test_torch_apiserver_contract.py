"""The port's apiserver contract (``client/{incluster,faults}.py``,
``cmd/operator.py``'s ``LEASE_NAME`` and ``LeaderElector``,
``controllers/clusterinfo.py``, ``testing/stub_apiserver.py``).

Every scenario of ``tests/test_apiserver_contract.py`` runs as written on the
port (``tests/torch_scenarios.py``): each name it imports from the JAX package,
at its top or inside a scenario, is the port's; the classes it defines
are rebuilt over those names; a metrics module reads through
``PromView``; and the key map of ``tests/torch_keymap.py`` gives a node
(``gpu_slice_node``), the policy (``pinned_policy``) and the accelerator
label (``node_consts``)."""

import pytest

import test_apiserver_contract as jax_scenarios
import torch_keymap as km
import torch_rebind
import torch_scenarios
from tpu_operator_torch import testing
from tpu_operator_torch.testing import fake_cluster

KEY_MAP = dict(consts=km.node_consts(), make_tpu_node=km.gpu_slice_node,
               sample_policy=km.pinned_policy)
SCENARIOS = torch_scenarios.port_twins(
    jax_scenarios, **torch_scenarios.port_globals(jax_scenarios, **KEY_MAP))
CASES = torch_scenarios.scenario_cases(jax_scenarios)
PORT_MODULES = torch_scenarios.port_modules_of(
    jax_scenarios, testing=torch_rebind.module_view(testing, **KEY_MAP),
    testing_fake_cluster=torch_rebind.module_view(fake_cluster, **KEY_MAP))


@pytest.fixture(autouse=True)
def _port_state():
    with torch_rebind.port_state():
        yield


def test_every_apiserver_contract_scenario_is_here():
    assert len(CASES) == 21


@pytest.mark.parametrize("name,fn,kwargs",
                         torch_scenarios.case_params(jax_scenarios, CASES))
def test_scenario_on_the_port(name, fn, kwargs, monkeypatch, tmp_path,
                              capsys):
    torch_rebind.imports_from_port(monkeypatch, PORT_MODULES)
    torch_scenarios.call_with_fixtures(
        jax_scenarios, SCENARIOS, fn, kwargs, tmp_path=tmp_path,
        monkeypatch=monkeypatch, capsys=capsys)
