"""The port's delta engine (``state/skel.py``, ``state/manager.py``,
``state/delta.py``, ``state/metrics.py``, ``informer/workqueue.py``, the
policy reconciler and the runner's wake batching).

Every scenario of ``tests/test_delta_engine.py`` runs as written on the port
(``tests/torch_scenarios.py``): each name it imports from the JAX package,
at its top or inside a scenario, is the port's; the classes it defines
are rebuilt over those names; a metrics module reads through
``PromView``; and the key map of ``tests/torch_keymap.py`` gives a node
(``gpu_slice_node``), the policy (``pinned_policy``) and the accelerator
label (``node_consts``)."""

import pytest

import test_delta_engine as jax_scenarios
import torch_keymap as km
import torch_rebind
import torch_scenarios
from tpu_operator_torch import consts, testing
from tpu_operator_torch.testing import fake_cluster

NS = consts.DEFAULT_NAMESPACE

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


def test_every_delta_engine_scenario_is_here():
    assert len(CASES) == 20


@pytest.mark.parametrize("name,fn,kwargs",
                         torch_scenarios.case_params(jax_scenarios, CASES))
def test_scenario_on_the_port(name, fn, kwargs, monkeypatch, tmp_path,
                              capsys):
    torch_rebind.imports_from_port(monkeypatch, PORT_MODULES)
    torch_scenarios.call_with_fixtures(
        jax_scenarios, SCENARIOS, fn, kwargs, tmp_path=tmp_path,
        monkeypatch=monkeypatch, capsys=capsys)


# ------------------------------------------- what only the port does here

def test_an_own_uncordon_echo_wakes_the_gangs_and_nothing_else():
    """A deliberate difference (ROADMAP, Runner): the echo of the
    runner's own uncordon — a Node its remediation or upgrade key made
    schedulable again — still wakes the workload keys, so a gang held
    off the node places again at once instead of after its hold
    requeue; the key that wrote it, and every other, stays asleep.  The
    echo of an own label write or an own cordon wakes nothing, as in the
    JAX runner (the drain, not the gang's own teardown, moves a bound
    gang)."""
    import copy
    import time

    from tpu_operator_torch.client import FakeClient
    from tpu_operator_torch.cmd.operator import OperatorRunner, workload_key
    from tpu_operator_torch.state import delta as state_delta

    client = FakeClient([km.gpu_node("h100-0"), km.pinned_policy()])
    runner = OperatorRunner(client, NS)
    client.create({"apiVersion": "tpu.operator.dev/v1alpha1",
                   "kind": "TPUWorkload",
                   "metadata": {"name": "train", "namespace": NS},
                   "spec": {"replicas": 1, "image": "t:1"}})
    gang = workload_key(NS, "train")
    t = 0.0
    for _ in range(3):
        runner.step(now=t)
        t += 100.0
    node = client.get("Node", "h100-0")
    node["spec"]["unschedulable"] = True
    cordoned = client.update(node)          # the sync fake wakes as usual
    runner.step(now=t)
    keys = runner.queue.keys()
    assert gang in keys
    for key in keys:                        # everything asleep
        runner.queue.deadlines[key] = float("inf")

    def due() -> list:
        return sorted(k for k in keys
                      if runner.queue.is_due(k, time.monotonic()))

    def own_echo(edit) -> dict:
        echo = copy.deepcopy(cordoned)
        edit(echo)
        echo["metadata"]["resourceVersion"] = str(
            int(cordoned["metadata"]["resourceVersion"]) + 100)
        state_delta.note_own_write(echo)
        return echo

    runner._on_event("MODIFIED", own_echo(
        lambda n: n["metadata"]["labels"].update(team="a")))
    assert due() == []

    uncordoned = own_echo(lambda n: n["spec"].pop("unschedulable"))
    runner._on_event("MODIFIED", uncordoned)
    assert due() == sorted([gang, "workload"])

    for key in keys:
        runner.queue.deadlines[key] = float("inf")
    cordoned = copy.deepcopy(uncordoned)
    cordoned["spec"]["unschedulable"] = True
    cordoned["metadata"]["resourceVersion"] = str(
        int(uncordoned["metadata"]["resourceVersion"]) + 1)
    state_delta.note_own_write(cordoned)
    runner._on_event("MODIFIED", cordoned)
    assert due() == []
