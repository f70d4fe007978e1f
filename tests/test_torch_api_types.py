"""The port's API types (``api/``, ``api/crd.py``) and their validator
(``cmd/tpuop_cfg.py``) against the JAX package's.

Every scenario of ``tests/test_api_types.py`` runs as written on the port
(``tests/torch_scenarios.py``), each name it imports from the JAX package
being the port's; the dead-knob scan reads the port's trees (the package,
its manifests and ``deploy/``).  The cases that reach a default or a
field the port changed on purpose are in :data:`ADAPTED`, each with the
ROADMAP "Deliberate differences" entry it stands on, and each held below
by a twin that pins the port's side against the JAX package's."""

import pytest

import test_api_types as jax_scenarios
import torch_keymap as km
import torch_rebind
import torch_scenarios
from tpu_operator.api import TPUPolicy as JaxTPUPolicy
from tpu_operator.cmd.tpuop_cfg import \
    validate_tpudriver as jax_validate_tpudriver
from tpu_operator_torch import consts
from tpu_operator_torch.api import TPUPolicy
from tpu_operator_torch.client import FakeClient
from tpu_operator_torch.cmd.tpuop_cfg import (validate_tpudriver,
                                              validate_tpupolicy)
from tpu_operator_torch.controllers import TPUPolicyReconciler
from tpu_operator_torch.testing import FakeKubelet, make_gpu_node

# case -> the "Deliberate differences" entry of ROADMAP.md it reaches
ADAPTED = {
    "test_defaults": "Operator: defaults for a GPU host, nvidia.com/gpu",
    "test_policy_defaults_per_family":
        "Operator: partitionManager.defaultProfile all-chips",
    "test_driver_valid_variants_accepted[2]":
        "Driver controller: a TPUDriver that sets libtpuSource",
    "test_driver_valid_variants_accepted[3]":
        "Driver controller: a TPUDriver that sets libtpuSource",
    "test_driver_valid_variants_accepted[4]":
        "Driver controller: a TPUDriver that sets libtpuSource",
    "test_policy_ambiguous_libtpu_source_fails_render_not_silently_wins":
        "Operator: a policy that sets driver.libtpuSource reads notReady",
}
# the dead-knob scan's trees, as the port's
LITERALS = {"test_no_dead_spec_knobs": {
    "tpu_operator": "tpu_operator_torch",
    "tpu_operator/api/": "tpu_operator_torch/api/",
    "manifests": km.DEPLOY_PATHS["manifests"],
    "deployments": "tpu_operator_torch/deploy"}}

SCENARIOS = torch_scenarios.port_twins(
    jax_scenarios, literals=LITERALS,
    **torch_scenarios.port_globals(jax_scenarios))
CASES = torch_scenarios.scenario_cases(jax_scenarios, ADAPTED)
PORT_MODULES = torch_scenarios.port_modules_of(jax_scenarios)
NS = consts.DEFAULT_NAMESPACE


@pytest.fixture(autouse=True)
def _port_state():
    with torch_rebind.port_state():
        yield


def test_every_api_types_scenario_is_here():
    ids = {c[0] for c in torch_scenarios.scenario_cases(jax_scenarios)}
    assert len(CASES) + len(ADAPTED) == 60
    assert set(ADAPTED) <= ids


@pytest.mark.parametrize("name,fn,kwargs", CASES,
                         ids=[c[0] for c in CASES])
def test_scenario_on_the_port(name, fn, kwargs, monkeypatch, tmp_path):
    torch_rebind.imports_from_port(monkeypatch, PORT_MODULES)
    torch_scenarios.call_with_fixtures(jax_scenarios, SCENARIOS, fn, kwargs,
                                    tmp_path=tmp_path,
                                    monkeypatch=monkeypatch)


# ------------------------------------------------------- the adapted twins

@pytest.mark.parametrize("fn,read,jax_value,port_value", [
    ("test_defaults", lambda p: p.spec.device_plugin.resource_name,
     "google.com/tpu", "nvidia.com/gpu"),
    ("test_policy_defaults_per_family",
     lambda p: p.spec.partition_manager.default_profile,
     "all-disabled", "all-chips")], ids=["resource", "profile"])
def test_defaults_are_the_gpu_hosts(fn, read, jax_value, port_value,
                                    monkeypatch):
    """The two default scenarios as written, with the one default the
    port changed read under its key map: the resource name and the
    partition manager's default profile."""
    assert read(JaxTPUPolicy()) == jax_value
    assert read(TPUPolicy()) == port_value
    twin = torch_scenarios.port_twins(
        jax_scenarios, literals={fn: {jax_value: port_value}},
        **torch_scenarios.port_globals(jax_scenarios))
    torch_rebind.imports_from_port(monkeypatch, PORT_MODULES)
    twin[fn]()


@pytest.mark.parametrize("case", sorted(
    c for c in ADAPTED if c.startswith("test_driver_valid_variants")))
def test_a_driver_source_is_refused_where_jax_accepts_it(case):
    """The three ``libtpuSource`` variants JAX accepts: the port's
    validator reports the one field it cannot honour, and nothing else."""
    (spec,) = [c[2]["spec"] for c in torch_scenarios.scenario_cases(
        jax_scenarios) if c[0] == case]
    doc = SCENARIOS["_driver_doc"](**spec)
    assert jax_validate_tpudriver(doc) == []
    (err,) = validate_tpudriver(doc)
    assert err.startswith("libtpuSource: ") and "cannot honour" in err


def test_an_ambiguous_driver_source_reads_not_ready_and_renders_nothing():
    """The JAX render refuses a source with two of image/url/hostPath;
    the port refuses any source before rendering: the validator names
    the ambiguity, and the policy reads notReady with
    ``UnsupportedField`` and no driver DaemonSet."""
    source = {"url": "https://x", "hostPath": "/p"}
    errs = validate_tpupolicy(SCENARIOS["_policy_doc"](
        driver={"libtpuSource": source}))
    assert any("exactly one" in e for e in errs), errs
    client = FakeClient([make_gpu_node("h100-0"), km.pinned_policy(
        driver={"libtpuSource": source})])
    rec, kubelet = TPUPolicyReconciler(client), FakeKubelet(client)
    for _ in range(3):
        res = rec.reconcile()
        kubelet.step()
    status = client.get("TPUPolicy", "tpu-policy")["status"]
    assert not res.ready and status["state"] == "notReady"
    assert [c["reason"] for c in status["conditions"]
            if c.get("status") == "True" and c["type"] == "Error"] == [
        "UnsupportedField"]
    assert client.get_or_none("DaemonSet", "tpu-driver-daemonset",
                              NS) is None
