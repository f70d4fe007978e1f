"""The port's operator under faults (``cmd/{operator,status}.py``,
``client/{faults,resilience}.py``, ``validator/healthwatch.py``,
``testing/stub_apiserver.py``: fault storms, outages, partitions and the
serve-stale degraded mode, remediation and gangs under them).

Every scenario of ``tests/test_chaos_convergence.py`` runs as written on the
port (``tests/torch_scenarios.py``): each name it imports from the JAX package,
at its top or inside a scenario, is the port's; the classes it defines
are rebuilt over those names; a metrics module reads through
``PromView``; and the key map of ``tests/torch_keymap.py`` gives a node
(``gpu_slice_node``), the policy (``pinned_policy``) and the accelerator
label (``node_consts``)."""

import pytest

import test_chaos_convergence as jax_scenarios
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


def test_every_chaos_convergence_scenario_is_here():
    assert len(CASES) == 23


@pytest.mark.parametrize("name,fn,kwargs",
                         torch_scenarios.case_params(jax_scenarios, CASES))
def test_scenario_on_the_port(name, fn, kwargs, monkeypatch, tmp_path,
                              capsys):
    torch_rebind.imports_from_port(monkeypatch, PORT_MODULES)
    torch_scenarios.call_with_fixtures(
        jax_scenarios, SCENARIOS, fn, kwargs, tmp_path=tmp_path,
        monkeypatch=monkeypatch, capsys=capsys)


# ------------------------------------------- what only the port does here

def test_a_partitioned_leader_serves_stale_and_parks(tmp_path):
    """A deliberate difference (ROADMAP, Operator): a leader whose Lease
    renewals fail on the wire — a full apiserver outage, every request
    refused — enters serve-stale degraded mode once the lease client's
    breaker has been open past the budget, parks each due key with its
    journaled hold, and answers ``/readyz`` with ``degraded:
    serving-stale``; once a renewal lands it journals ``recovered``.  The
    JAX runner stands by on the failed renewal before it ever polls its
    degraded mode, and the steady runner makes no other call, so under
    ``--leader-election`` (its Deployment's argv) no breaker it watches
    opens and ``/readyz`` keeps answering ``ok``."""
    import urllib.request

    from tpu_operator_torch.client import FakeClient, FaultSchedule
    from tpu_operator_torch.client.resilience import (BREAKER_OPEN,
                                                      RetryingClient)
    from tpu_operator_torch.cmd.operator import HealthServer, OperatorRunner
    from tpu_operator_torch.obs import journal
    from tpu_operator_torch.testing import FakeClock

    journal.reset()
    journal.configure(enabled=True)
    clock = FakeClock()
    inner = FakeClient([km.gpu_node("h100-0"), km.pinned_policy()])
    client = RetryingClient(inner, clock=clock, sleep=clock.sleep)
    runner = OperatorRunner(client, NS, leader_election=True,
                            identity="op-a", degraded_budget_s=3.0)
    runner.degraded.clock = clock
    health = HealthServer(0, 0, degraded=lambda: runner.degraded.active)
    health.ready.set()
    url = f"http://127.0.0.1:{health.ports()[0]}/readyz"
    try:
        assert runner.elector.try_acquire()
        runner.step(now=clock())
        inner.faults = FaultSchedule(seed=1).start_outage()
        for _ in range(4):               # the renewals of 20 s, all refused
            assert not runner.elector.try_acquire()
            runner._park_if_partitioned()
            clock.t += 5.0
        runner._park_if_partitioned()
        assert runner.elector.is_leader and runner.degraded.active
        assert runner.elector.client.breaker_state == BREAKER_OPEN
        with urllib.request.urlopen(url, timeout=5) as resp:
            assert (resp.status, resp.read()) == (
                200, b"degraded: serving-stale\n")
        verdicts = [e["verdict"] for e in journal.entries(
            "operator", NS, "degraded")]
        assert verdicts[0] == "serving-stale" and "parked" in verdicts
        inner.faults = None
        clock.t += 5.0
        assert runner.elector.try_acquire()
        assert not runner.degraded.poll()
        assert journal.entries("operator", NS, "degraded")[-1][
            "verdict"] == "recovered"
        with urllib.request.urlopen(url, timeout=5) as resp:
            assert resp.read() == b"ok"
    finally:
        health.shutdown()
        journal.configure(enabled=False)
        journal.reset()
