"""The port's policy and driver reconcilers under seeded random walks of
valid spec mutations (``controllers/tpupolicy_controller.py``,
``controllers/tpudriver_controller.py``) against the JAX package's.

Every scenario of ``tests/test_config_fuzz.py`` runs as written on the
port (``tests/torch_scenarios.py``) under the key map of
``tests/torch_keymap.py`` (``gpu_slice_node``, ``pinned_policy``,
``node_consts``).  The ``TPUDriver`` walk is in :data:`ADAPTED`: its
mutations set ``libtpuSource`` and ``usePrebuilt``, which the port's
driver agent cannot honour, so the port refuses them where JAX renders
them.  Its twin walks the same seeded mutations and requires every step
to converge, or, where the spec sets a field the agent cannot honour, to
read ``notReady`` with ``UnsupportedField`` (``InvalidSpec`` where JAX
refuses the combination too) and never raise."""

import random

import pytest

import test_config_fuzz as jax_scenarios
import torch_keymap as km
import torch_rebind
import torch_scenarios
from tpu_operator_torch import consts, testing
from tpu_operator_torch.client import FakeClient
from tpu_operator_torch.controllers import TPUDriverReconciler
from tpu_operator_torch.testing import FakeKubelet, fake_cluster

# case -> the "Deliberate differences" entry of ROADMAP.md it reaches
ADAPTED = {
    "test_random_tpudriver_walk_always_converges[0]":
        "Driver controller: a TPUDriver that sets libtpuSource or "
        "usePrebuilt: true reads notReady with UnsupportedField",
    "test_random_tpudriver_walk_always_converges[1]":
        "Driver controller: a TPUDriver that sets libtpuSource or "
        "usePrebuilt: true reads notReady with UnsupportedField",
}

KEY_MAP = dict(consts=km.node_consts(), make_tpu_node=km.gpu_slice_node,
               sample_policy=km.pinned_policy)
SCENARIOS = torch_scenarios.port_twins(
    jax_scenarios, **torch_scenarios.port_globals(jax_scenarios, **KEY_MAP))
CASES = torch_scenarios.scenario_cases(jax_scenarios, ADAPTED)
PORT_MODULES = torch_scenarios.port_modules_of(
    jax_scenarios, testing=torch_rebind.module_view(testing, **KEY_MAP),
    testing_fake_cluster=torch_rebind.module_view(fake_cluster, **KEY_MAP))
NS = consts.DEFAULT_NAMESPACE


@pytest.fixture(autouse=True)
def _port_state():
    with torch_rebind.port_state():
        yield


def test_every_config_fuzz_scenario_is_here():
    ids = {c[0] for c in torch_scenarios.scenario_cases(jax_scenarios)}
    assert len(CASES) + len(ADAPTED) == 4
    assert set(ADAPTED) <= ids


@pytest.mark.parametrize("name,fn,kwargs", CASES,
                         ids=[c[0] for c in CASES])
def test_scenario_on_the_port(name, fn, kwargs, monkeypatch, tmp_path):
    torch_rebind.imports_from_port(monkeypatch, PORT_MODULES)
    torch_scenarios.call_with_fixtures(jax_scenarios, SCENARIOS, fn, kwargs,
                                    tmp_path=tmp_path)


def _mutate(mutation, spec: dict, rng) -> None:
    """A JAX driver mutation, its accelerator selector under the key map
    (fd's type label on a GPU node)."""
    mutation(spec, rng)
    selector = spec.get("nodeSelector") or {}
    spec["nodeSelector"] = {km.NODE_ACCELERATOR_LABEL.get(k, k): v
                            for k, v in selector.items()}


@pytest.mark.parametrize("case", sorted(ADAPTED))
def test_random_tpudriver_walk_refuses_what_the_agent_cannot_honour(case):
    (seed,) = [c[2]["seed"] for c in torch_scenarios.scenario_cases(
        jax_scenarios) if c[0] == case]
    rng = random.Random(seed)
    client = FakeClient([
        km.gpu_slice_node("a0", "tpu-v5-lite-podslice", "2x4"),
        km.gpu_slice_node("a1", "tpu-v5-lite-podslice", "2x4"),
        km.gpu_slice_node("b0", "tpu-v6e-slice", "4x4"),
        {"apiVersion": "tpu.operator.dev/v1alpha1", "kind": "TPUDriver",
         "metadata": {"name": "default"},
         "spec": {"driverType": "tpu", "libtpuVersion": "1.10.0"}}])
    kubelet = FakeKubelet(client)
    rec = TPUDriverReconciler(client)
    refused = converged = 0
    for step in range(60):
        cr = client.get("TPUDriver", "default")
        _mutate(rng.choice(jax_scenarios.DRIVER_MUTATIONS), cr["spec"], rng)
        client.update(cr)
        for _ in range(4):
            res = rec.reconcile("default")   # must never raise
            kubelet.step()
            if res.ready:
                break
        status = client.get("TPUDriver", "default").get("status", {})
        spec = client.get("TPUDriver", "default")["spec"]
        if spec.get("usePrebuilt") or spec.get("libtpuSource"):
            reasons = {c.get("reason") for c in status.get("conditions", [])
                       if c.get("status") == "True"}
            want = "InvalidSpec" if spec.get("usePrebuilt") and \
                spec.get("libtpuVersion") else "UnsupportedField"
            assert status.get("state") == "notReady" and want in reasons, (
                step, spec, status)
            refused += 1
        else:
            assert res.ready, (step, spec, status)
            converged += 1
    assert refused and converged
    for ds in client.list("DaemonSet"):
        assert ds["metadata"]["labels"][consts.STATE_LABEL] == \
            "tpudriver-default"
