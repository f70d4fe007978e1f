"""The port's copies of ``obs/trace.py`` and ``obs/aioprof.py`` against the
JAX package's, side by side.

Key map: none.  As in the JAX package, finished spans feed the
cost-attribution board (``obs/profile.py``), and the slow-callback
watchdog logs the stall with the offender's stack and journals it once."""

import asyncio
import logging
import threading
import time

import pytest

from tpu_operator import obs as jax_obs
from tpu_operator.client.bridge import LoopBridge as JaxLoopBridge
from tpu_operator.obs import aioprof as jax_aioprof
from tpu_operator.obs import trace as jax_trace
from tpu_operator_torch.client import metrics as client_metrics
from tpu_operator_torch.client.bridge import LoopBridge
from tpu_operator_torch.obs import aioprof, trace

SIDES = {"jax": (jax_trace, jax_aioprof, JaxLoopBridge),
         "torch": (trace, aioprof, LoopBridge)}


@pytest.fixture(autouse=True)
def _reset_obs():
    yield
    jax_obs.reset()
    trace.reset()


def _wait_for(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def _shape(tr: dict) -> dict:
    """A finished trace without its ids, clocks and threads."""
    return {"name": tr["name"],
            "spans": [(s["name"], s["parent_id"] != "", s["attrs"],
                       [(e["name"], e["attrs"]) for e in s["events"]])
                      for s in tr["spans"]]}


def _traced(tr):
    tr.configure(enabled=True, capacity=8)
    with tr.root_span("pass", {"kind": "Node"}) as root:
        with tr.span("client.get") as sp:
            sp.set_attr("name", "n0")
            tr.add_event("retry", attempt=1)
        now = time.monotonic()
        tr.record_span("queue.wait", now - 0.01, now, attrs={"n": 1})
        with pytest.raises(KeyError):
            with tr.span("client.update"):
                raise KeyError("x")
        assert tr.current_span() is root
    return tr.snapshot(1)


def _board(profile):
    """The cost board without its clocks: phase → span count."""
    return {phase: row["count"]
            for phase, row in profile.board_snapshot().items()}


def test_trace_tree_matches_jax():
    from tpu_operator.obs import profile as jax_profile
    from tpu_operator_torch.obs import profile
    want, got = _traced(jax_trace), _traced(trace)
    assert [_shape(t) for t in got["recent"]] == \
        [_shape(t) for t in want["recent"]]
    assert _shape(got["recent"][0])["spans"][3][2] == {"error": "KeyError"}
    assert [_shape(t) for t in got["slowest"]] == \
        [_shape(t) for t in want["slowest"]]
    # every finished span fed the cost board, as in the JAX package
    assert _board(profile) == _board(jax_profile) == {
        "pass": 1, "client.get": 1, "queue.wait": 1, "client.update": 1}


def test_exact_clocks_and_span_or_root():
    """The port's additions: a finished span keeps its monotonic and
    wall-clock bounds unrounded; ``span_or_root`` opens a root where no span
    is open and a child where one is."""
    trace.configure(enabled=True)
    before = time.time_ns()
    with trace.span_or_root("phase") as root:
        with trace.span_or_root("inner") as inner:
            assert inner.parent_id == root.span_id
    after = time.time_ns()
    assert trace.span("orphan") is trace.NOOP_SPAN
    (tr,) = trace.snapshot(1)["recent"]
    assert [s["name"] for s in tr["spans"]] == ["phase", "inner"]
    outer, inner = tr["spans"]
    assert before <= outer["start_wall_ns"] <= inner["start_wall_ns"] \
        <= inner["end_wall_ns"] <= outer["end_wall_ns"] <= after
    for s in tr["spans"]:
        assert s["end_mono"] - s["start_mono"] == pytest.approx(
            s["duration_ms"] / 1000.0, abs=1e-6)
    assert outer["parent_id"] == ""
    with trace.span_or_root("alone"):
        pass
    assert trace.snapshot(1)["recent"][0]["name"] == "alone"


@pytest.mark.parametrize("side", sorted(SIDES))
def test_disabled_tracer_is_the_shared_noop(side):
    tr = SIDES[side][0]
    assert not tr.is_enabled()
    assert tr.root_span("x") is tr.NOOP_SPAN
    assert tr.span("y") is tr.NOOP_SPAN
    assert tr.snapshot() == {"recent": [], "slowest": []}


def test_write_capture_and_watch_stamp_match_jax():
    out = []
    for tr in (jax_trace, trace):
        with tr.write_capture() as cap:
            tr.note_write("update")
            tr.note_write("update_status")
        stamp = tr.watch_stamp("ADDED", {"kind": "Pod", "metadata": {
            "name": "p", "namespace": "ns"}})
        out.append((sorted(cap.last), stamp.kind, stamp.verb, stamp.name,
                    stamp.namespace, stamp.trace_id))
    assert out[0] == out[1] == (["status_wall", "wall"], "Pod", "ADDED",
                                "p", "ns", "")


def test_lag_recorder_matches_jax():
    snaps = []
    for mod in (jax_aioprof, aioprof):
        rec = mod.LagRecorder()
        for lag in (0.0005, 0.03, 99.0, -1.0):
            rec.observe(lag)
        snaps.append(rec.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[1]["count"] == 4 and snaps[1]["max_s"] == 99.0


def test_disabled_probe_is_a_noop():
    assert not aioprof.is_enabled()
    bridge = LoopBridge(name="torch-noop-loop")
    try:
        bridge.run(asyncio.sleep(0))
        row = aioprof.snapshot()["loops"]["torch-noop-loop"]
        assert row["lag"]["count"] == 0 and not row["probing"]
        assert not any(t.name == "obs-loopwatchdog"
                       for t in threading.enumerate())
    finally:
        bridge.close()


def test_lag_probe_feeds_the_registry():
    aioprof.configure(enabled=True, interval_s=0.02, slow_callback_s=5.0)
    bridge = LoopBridge(name="torch-probe-loop")
    try:
        bridge.run(asyncio.sleep(0))
        assert _wait_for(lambda: aioprof.snapshot()["loops"]
                         .get("torch-probe-loop", {}).get("lag", {})
                         .get("count", 0) >= 3)
        body = client_metrics.render()
        assert ('gpu_operator_event_loop_lag_seconds_count'
                '{loop="torch-probe-loop"}') in body
        assert 'gpu_operator_event_loop_tasks{loop="torch-probe-loop",' \
            'family="obs"} 1.0' in body
        assert 'gpu_operator_loop_offload_workers_max{bridge=' \
            '"torch-probe-loop"} 64.0' in body
    finally:
        bridge.close()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_spawn_names_registers_and_propagates_trace_ids(side):
    tr, mod, bridge_cls = SIDES[side]
    tr.configure(enabled=True)
    bridge = bridge_cls(name=f"{side}-spawn-loop")
    try:
        async def parked():
            await asyncio.sleep(60)

        async def spawner():
            with tr.root_span("reconcile.test") as root:
                task = mod.spawn(parked(), name="watch-Fake", family="watch")
                return task, root.trace_id

        task, trace_id = bridge.run(spawner())
        assert mod.task_meta(task) == {"family": "watch",
                                       "span": "reconcile.test",
                                       "trace_id": trace_id}
        assert mod.census()[f"{side}-spawn-loop"].get("watch") == 1

        async def spawner2():
            return mod.spawn(parked(), name="pool-discard")

        assert mod.task_meta(bridge.run(spawner2()))["family"] == "pool"
        assert mod.census()[f"{side}-spawn-loop"].get("pool") == 1
    finally:
        bridge.close()


def test_slow_callback_is_logged_and_not_journaled(caplog):
    """One warning with the offender's stack per stall, and, as in the
    JAX package, exactly one decision-journal entry for it (``kind`` loop,
    verdict ``slow-callback``) with the stack among its inputs."""
    from tpu_operator_torch.obs import journal
    was_enabled = journal.is_enabled()
    journal.configure(enabled=True)
    journal.forget("loop", "", "torch-slow-loop")
    aioprof.configure(enabled=True, interval_s=0.02, slow_callback_s=0.1)
    bridge = LoopBridge(name="torch-slow-loop")
    caplog.set_level(logging.WARNING, logger=aioprof.__name__)

    async def offender():
        time.sleep(0.6)           # blocks the loop on purpose

    try:
        bridge.run(asyncio.sleep(0))
        assert _wait_for(lambda: aioprof.snapshot()["loops"]
                         ["torch-slow-loop"]["lag"]["count"] >= 1)
        bridge.run(offender())
        assert _wait_for(lambda: aioprof.snapshot()["loops"]
                         ["torch-slow-loop"]["slow_callbacks"] >= 1)
        entries = journal.entries("loop", "", "torch-slow-loop")
    finally:
        bridge.close()
        journal.configure(enabled=was_enabled)
    assert len(entries) == 1
    assert (entries[0]["category"], entries[0]["verdict"],
            entries[0]["count"]) == ("loop", "slow-callback", 1)
    assert "torch-slow-loop" in entries[0]["reason"]
    assert any("offender" in line for line in entries[0]["inputs"]["stack"])
    records = [r for r in caplog.records
               if "blocked" in r.getMessage()]
    assert len(records) == 1
    assert "torch-slow-loop" in records[0].getMessage()
    assert "offender" in records[0].getMessage()
