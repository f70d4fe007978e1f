"""The three legs ``chip_smoke.py``'s ``runner`` phase drives between the
runner's ``/metrics`` and its handoff, in the parts that run without the
card.

* Their readers over canned inputs: a standby's writes from a stub
  request log (``standby_writes``), the degraded journal from a
  ``/debug/explain`` payload (``degraded_journal``), a node's remediation
  transitions from journal entries (``remediation_states``) and the
  seconds out of service (``out_of_service``).
* ``runner_legs`` drives :data:`chip_smoke.RUNNER_LEGS` in order, and
  ``runner()`` calls it between the runner's ``/metrics`` and its
  handoff, so no leg can drop out unseen.
* ``runner_serve_stale``, ``runner_standby`` and ``standby_takeover`` as
  the card runs them: ``RunnerProcess`` (``manager.yaml``'s argv) against
  the port's stub apiserver with a ``FakeKubelet`` thread in place of the
  card's kubelet — the outage refused past the degraded budget, the
  standby beside the leader, then the leader's SIGTERM."""

import ast
import inspect
import os
import threading
import time
from types import SimpleNamespace

import pytest

import chip_smoke
from tpu_operator_torch import consts
from tpu_operator_torch.client.incluster import InClusterClient
from tpu_operator_torch.testing.stub_apiserver import StubApiServer

NS = consts.DEFAULT_NAMESPACE
NODE = "h100-node-0"


# ------------------------------------------------------------- the readers

def test_standby_writes_split_lease_attempts_from_other_writes():
    log = [("runner-standby", "GET", f"/apis/coordination.k8s.io/v1/"
            f"namespaces/{NS}/leases/tpu-operator-leader"),
           ("runner-standby", "GET", "/api/v1/nodes"),
           ("runner-standby", "GET", "/api/v1/nodes?watch"),
           ("runner-1", "PUT", f"/apis/coordination.k8s.io/v1/namespaces/"
            f"{NS}/leases/tpu-operator-leader"),
           ("runner-1", "PUT", f"/api/v1/nodes/{NODE}")]
    assert chip_smoke.standby_writes(log, "runner-standby") == ({}, {})
    assert chip_smoke.standby_writes(log, "runner-1") == (
        {"update": 1}, {"update": {"Node": 1}})
    log.append(("runner-standby", "POST", f"/apis/coordination.k8s.io/v1/"
                f"namespaces/{NS}/leases"))
    log.append(("runner-standby", "PUT", f"/api/v1/nodes/{NODE}/status"))
    assert chip_smoke.standby_writes(log, "runner-standby") == (
        {"create": 1}, {"update_status": {"Node": 1}})


def _entry(verdict, wall, key=None):
    return {"category": "degraded", "verdict": verdict, "wall": wall,
            "reason": verdict, "inputs": {"key": key} if key else {}}


def test_the_degraded_journal_by_verdict():
    payload = {"kind": "operator", "namespace": NS, "name": "degraded",
               "entries": [_entry("parked", 12.0, "telemetry"),
                           _entry("serving-stale", 10.0),
                           _entry("parked", 11.0, "policy"),
                           _entry("recovered", 30.0)]}
    assert chip_smoke.degraded_journal(payload) == {
        "walls": {"parked": [11.0, 12.0], "recovered": [30.0],
                  "serving-stale": [10.0]},
        "parked_keys": ["policy", "telemetry"]}
    assert chip_smoke.degraded_journal({"entries": []}) == {
        "walls": {}, "parked_keys": []}


def test_remediation_states_and_the_seconds_out_of_service():
    path = ("",) + chip_smoke.REMEDIATION_PATH
    entries = [{"category": "remediation", "verdict": "transition",
                "condition": {"from": a, "to": b},
                "inputs": {"event": f"e{i}"}, "wall": 100.0 + 10 * i}
               for i, (a, b) in enumerate(zip(path, path[1:]))]
    entries.append({"category": "remediation", "verdict": "hold",
                    "wall": 101.0, "inputs": {}})
    states = chip_smoke.remediation_states(entries[::-1])
    assert [s["to"] for s in states] == list(chip_smoke.REMEDIATION_PATH)
    assert states[0] == {"from": "", "to": "suspect", "event": "e0",
                         "wall": 100.0}
    at = {s["to"]: s["wall"] for s in states}   # cordoned 110 ... healthy 150
    got = chip_smoke.out_of_service(at, annotated=95.0, evicted=121.0,
                                    gone=123.5, chain=(131.0, 138.0),
                                    running_again=160.0)
    assert got == {"annotation_to_cordon": 15.0,
                   "cordon_to_gang_pod_gone": 13.5,
                   "revalidating_to_chain_start": 1.0,
                   "validator_rerun": 8.0,
                   "validator_chain_seconds": 7.0,
                   "cordon_to_uncordon": 40.0,
                   "uncordon_to_gang_running": 10.0,
                   "node_out_of_service": 40.0,
                   "job_out_of_service": 39.0,
                   "annotation_to_gang_running": 65.0}


# ------------------------------------------------------------ the legs' order

def test_runner_legs_drives_each_leg_in_order(monkeypatch):
    names = ["runner_remediation", "runner_serve_stale", "runner_standby"]
    assert [fn.__name__ for fn in chip_smoke.RUNNER_LEGS] == names
    ran = []

    def recorder(name):
        def leg(state):
            ran.append((name, state))
            return name
        leg.__name__ = name
        return leg

    monkeypatch.setattr(chip_smoke, "RUNNER_LEGS",
                        tuple(recorder(name) for name in names))
    state = SimpleNamespace()
    assert chip_smoke.runner_legs(state) == {name: name for name in names}
    assert ran == [(name, state) for name in names]


def test_the_runner_phase_drives_the_legs_between_metrics_and_handoff():
    """In ``runner()``'s body: ``runner_legs`` once, after the step that
    reads ``/metrics`` and before the leader's SIGTERM, and the standby's
    takeover after that SIGTERM."""
    tree = ast.parse(inspect.getsource(chip_smoke.runner))
    calls = [(n.lineno, n.func.attr if isinstance(n.func, ast.Attribute)
              else n.func.id) for n in ast.walk(tree)
             if isinstance(n, ast.Call)
             and isinstance(n.func, (ast.Name, ast.Attribute))]
    line = {name: [ln for ln, n in calls if n == name]
            for name in ("runner_metrics", "runner_legs", "stop",
                         "standby_takeover")}
    (metrics,), (legs,), (takeover,) = (line["runner_metrics"],
                                        line["runner_legs"],
                                        line["standby_takeover"])
    first_stop = min(line["stop"])
    assert metrics < legs < first_stop < takeover


# --------------------------------------------- the legs against the runner

@pytest.fixture
def phase(tmp_path):
    """The runner phase's state up to its ``/metrics`` step, on the CPU:
    the stub seeded as the phase seeds it, the runner from ``manager.yaml``
    with the policy ``ready``, a ``FakeKubelet`` thread that plays the
    DaemonSets while ``kubelet.daemonsets`` is set."""
    from tpu_operator_torch.cmd.operator import LEASE_NAME
    from tpu_operator_torch.testing import (FakeKubelet, make_cpu_node,
                                            make_gpu_node, sample_policy)

    stub = StubApiServer([make_gpu_node(NODE), make_cpu_node("cpu-0")])
    clients = {t: InClusterClient(api_server=stub.url, token=t)
               for t in ("kubelet", "reader", "admin")}
    reader = clients["reader"]
    clients["admin"].create(sample_policy())
    fake = FakeKubelet(clients["kubelet"])
    stop = threading.Event()
    val = SimpleNamespace(records=[])
    kubelet = SimpleNamespace(daemonsets=threading.Event(),
                              runs={"tpu-operator-validator": val})
    kubelet.daemonsets.set()

    def play():
        while not stop.wait(0.1):
            if kubelet.daemonsets.is_set():
                fake.step()
    thread = threading.Thread(target=play, daemon=True)
    thread.start()

    def policy():
        st = reader.get("TPUPolicy", "tpu-policy").get("status", {})
        labels = reader.get("Node", NODE)["metadata"]["labels"]
        return (st.get("state"), (st.get("slicesTotal"),
                                  st.get("slicesReady")),
                labels.get(consts.SLICE_READY_LABEL))

    def wait(what, done, proc, deadline_s):
        t0 = time.perf_counter()
        while not done():
            assert time.perf_counter() - t0 < deadline_s, (what, proc.tail())
            proc.alive()
            time.sleep(0.1)
        return time.perf_counter() - t0

    procs = []
    try:
        first = chip_smoke.RunnerProcess(
            chip_smoke.manager_container(), NS, stub.url, "runner-1",
            str(tmp_path / "snapshot"), str(tmp_path / "runner-1.log"))
        procs.append(first)
        assert f"--degraded-budget=" \
            f"{chip_smoke.RUNNER_DEGRADED_BUDGET_S:g}" in first.argv
        wait("ready", lambda: policy() == ("ready", (1, 1), "true")
             and first.get("/readyz")[0] == 200, first, 60.0)
        yield SimpleNamespace(
            stub=stub, reader=reader, admin=clients["admin"],
            kubelet=kubelet, leader=first,
            container=chip_smoke.manager_container(), namespace=NS,
            node_name=NODE, tmp=str(tmp_path), policy=policy, wait=wait,
            procs=procs, standby=None,
            standby_snapshot=str(tmp_path / "standby-snapshot"),
            lease=lambda: reader.get("Lease", LEASE_NAME, NS)["spec"],
            val=val)
    finally:
        for proc in procs:
            proc.close()
        stop.set()
        thread.join(5)
        for c in clients.values():
            c.close()
        stub.shutdown()


def test_the_serve_stale_and_standby_legs_then_the_takeover(phase, capsys):
    """The outage leg, the standby leg and the leader's SIGTERM as
    ``runner()`` drives them, each leg's JSON line printed."""
    out = chip_smoke.runner_serve_stale(phase)
    assert out["outage_seconds"] > chip_smoke.RUNNER_DEGRADED_BUDGET_S
    assert out["refused_requests"] > 0 and out["parked_keys"]
    assert set(out["journal_since_outage"]) >= {"serving-stale", "parked",
                                                "recovered"}
    assert phase.kubelet.daemonsets.is_set()

    standby = chip_smoke.runner_standby(phase)
    assert standby["readyz"] == (200, "ok")
    assert phase.standby in phase.procs
    assert phase.lease()["holderIdentity"] == phase.leader.identity

    t_term = time.time()
    assert phase.leader.stop()[0] == 0
    took = chip_smoke.standby_takeover(phase, t_term, phase.val, 0)
    assert took["lease_seconds"] < chip_smoke.RUNNER_TAKEOVER_S
    assert phase.lease()["holderIdentity"] == phase.standby.identity
    assert phase.standby.stop()[0] == 0
    printed = capsys.readouterr().out
    for line in ("runner_serve_stale", "runner_standby",
                 "runner_standby_takeover"):
        assert f'{{"{line}": ' in printed
