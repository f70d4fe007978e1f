"""The port's slice-atomic readiness (``controllers/tpupolicy_controller.py``
over ``client/fake.py`` and ``testing/fake_cluster.py``) against the JAX
package's.

Every scenario of ``tests/test_slice_readiness.py`` runs as written on
the port (``tests/torch_scenarios.py``) under the key map of
``tests/torch_keymap.py``: a slice host is ``gpu_slice_node`` (fd's
labels, its hosts-per-slice label carrying what the JAX package derives
from the topology), the policy ``pinned_policy``.  The one case that
needs a host feature discovery never labelled is in :data:`ADAPTED`: a
GPU node's topology is fd's alone, so the port's counterpart is a node
whose fd wrote the topology and the card count but no hosts-per-slice
label; its twin runs the scenario as written on such nodes."""

import pytest

import test_slice_readiness as jax_scenarios
import torch_keymap as km
import torch_rebind
import torch_scenarios
from tpu_operator_torch import consts, testing
from tpu_operator_torch.controllers import TPUPolicyReconciler
from tpu_operator_torch.testing import fake_cluster

# case -> the "Deliberate differences" entry of ROADMAP.md it reaches
ADAPTED = {"test_incomplete_slice_detected_without_hosts_label":
           "Operator: the topology comes from fd alone"}

KEY_MAP = dict(consts=km.node_consts(), make_tpu_node=km.gpu_slice_node,
               sample_policy=km.pinned_policy)
SCENARIOS = torch_scenarios.port_twins(
    jax_scenarios, **torch_scenarios.port_globals(jax_scenarios, **KEY_MAP))
CASES = torch_scenarios.scenario_cases(jax_scenarios, ADAPTED)
PORT_MODULES = torch_scenarios.port_modules_of(
    jax_scenarios, testing=torch_rebind.module_view(testing, **KEY_MAP),
    testing_fake_cluster=torch_rebind.module_view(fake_cluster, **KEY_MAP))


def fd_node_without_hosts_label(*args, **kwargs) -> dict:
    """``gpu_node``: fd's type, topology and card count, and no
    hosts-per-slice label."""
    node = km.gpu_node(*args, **kwargs)
    del node["metadata"]["labels"][consts.TFD_LABEL_HOSTS_PER_SLICE]
    return node


@pytest.fixture(autouse=True)
def _port_state():
    with torch_rebind.port_state():
        yield


def test_every_slice_readiness_scenario_is_here():
    assert len(CASES) + len(ADAPTED) == 12
    assert set(ADAPTED) <= set(vars(jax_scenarios))


@pytest.mark.parametrize("name,fn,kwargs", CASES,
                         ids=[c[0] for c in CASES])
def test_scenario_on_the_port(name, fn, kwargs, monkeypatch, tmp_path):
    torch_rebind.imports_from_port(monkeypatch, PORT_MODULES)
    torch_scenarios.call_with_fixtures(jax_scenarios, SCENARIOS, fn, kwargs,
                                    tmp_path=tmp_path)


def test_incomplete_slice_without_hosts_label_reads_fds_topology():
    """The scenario as written on hosts fd labelled without a
    hosts-per-slice label: the expectation comes from fd's topology ÷ the
    card count (4x4 ÷ 4 = 4 hosts), so the three survivors read not
    ready; GKE's topology label, which a GPU node does not carry, is not
    read."""
    twin = torch_scenarios.port_twins(
        jax_scenarios, **torch_scenarios.port_globals(
            jax_scenarios, **dict(KEY_MAP,
                                  make_tpu_node=fd_node_without_hosts_label)))
    twin["test_incomplete_slice_detected_without_hosts_label"]()
    node = km.gpu_node("n", topology="4x4", chips=4)
    assert TPUPolicyReconciler._expected_hosts(node) == 4
    node["metadata"]["labels"]["cloud.google.com/gke-tpu-topology"] = \
        node["metadata"]["labels"].pop(consts.TFD_LABEL_TOPOLOGY)
    assert TPUPolicyReconciler._expected_hosts(node) == 0
