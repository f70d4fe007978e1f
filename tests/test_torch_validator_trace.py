"""The port's validator under its tracer (``obs/trace.py``): the spans and
counters of ``run_component``, ``run_full_validation``, the escalation,
the chain calls and the chain graphs, and their ranges on a
``torch.profiler`` timeline.

Every case starts and ends with the tracer off and empty.  The workloads
run at small sizes on the CPU (their plain versions); the escalation's
window is taken down so that a CPU chain clears it, as the card's does, at
the first level unless a case asks for more.  The chain graphs run only on
the card: the ``card`` case holds their capture and release there.
"""

import math

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

from tpu_operator_torch.obs import trace
from tpu_operator_torch.validator import components, graphs, microbench
from tpu_operator_torch.validator import workloads as wl

BURN_IN, STRESS_MIB = 64, 1
GRAPHS = {"validator.graphs.capture", "validator.graphs.release"}
CHILDREN = {
    "torch": {"validator.escalation", "validator.chain"},
    "perf": {"validator.chain"},
    "full": {"validator.escalation", "validator.chain"},
}


@pytest.fixture(autouse=True)
def tracer():
    trace.reset()
    yield trace
    trace.reset()


@pytest.fixture
def card():
    # decided here, never at import: every xdist worker must collect the
    # same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    return torch.cuda.get_device_name(0)


@pytest.fixture
def small(monkeypatch):
    """The burn-in at 64^2 and the stress at 1 MiB, with a 0.1 ms window."""
    burn_in, stress = wl.matmul_burn_in, wl.hbm_stress
    monkeypatch.setattr(wl, "matmul_burn_in",
                        lambda size=1024, iters=8, seed=0, device="cuda":
                        burn_in(BURN_IN, iters, seed, device))
    monkeypatch.setattr(wl, "hbm_stress",
                        lambda mib=256, iters=4, device="cuda":
                        stress(STRESS_MIB, iters, device))
    monkeypatch.setattr(wl, "_MIN_MARGINAL_WINDOW_S", 1e-4)


@pytest.fixture
def mesh():
    """A world-1 gloo group and its mesh, as a node's validator holds."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield wl.make_mesh()
    finally:
        dist.destroy_process_group()


def _run(entry, tmp_path, mesh):
    if entry == "full":
        reports = wl.run_full_validation(mesh, expected_chips=1)
        assert all(r.ok for r in reports), reports
    else:
        ctx = components.Context(status_dir=str(tmp_path), device="cpu")
        components.run_component(entry, ctx)


def _traces():
    return trace.snapshot(256)["recent"]


def _named(tr, name):
    return [s for s in tr["spans"] if s["name"] == name]


def _under(tr, ancestor):
    """Spans of ``tr`` inside ``ancestor`` (its descendants)."""
    by_id = {s["span_id"]: s for s in tr["spans"]}

    def inside(s):
        while s["parent_id"] in by_id:
            s = by_id[s["parent_id"]]
            if s is ancestor:
                return True
        return False
    return [s for s in tr["spans"] if inside(s)]


@pytest.mark.parametrize("entry", ["torch", "full"])
def test_tracer_off_stores_no_trace(entry, small, tmp_path, request):
    mesh = request.getfixturevalue("mesh") if entry == "full" else None
    _run(entry, tmp_path, mesh)
    assert trace.snapshot(256) == {"recent": [], "slowest": []}


@pytest.mark.parametrize("entry", ["torch", "perf", "full"])
def test_tracer_on_one_root_with_its_children(entry, small, tmp_path,
                                              request):
    mesh = request.getfixturevalue("mesh") if entry == "full" else None
    trace.configure(enabled=True)
    _run(entry, tmp_path, mesh)
    (tr,) = _traces()
    root = tr["spans"][0]
    assert root["parent_id"] == ""
    if entry == "full":
        assert tr["name"] == "validator.full"
        assert root["attrs"] == {"expected_chips": 1}
    else:
        assert tr["name"] == "validator.component"
        assert root["attrs"] == {"component": entry, "ok": True}
    names = {s["name"] for s in tr["spans"][1:]}
    # no graphs off the card
    assert names == CHILDREN[entry] and not names & GRAPHS
    assert len(tr["spans"]) < trace.MAX_SPANS_PER_TRACE
    ids = {s["span_id"] for s in tr["spans"]}
    assert all(s["parent_id"] in ids for s in tr["spans"][1:])
    for s in tr["spans"]:
        assert s["start_mono"] <= s["end_mono"]
        assert s["start_wall_ns"] <= s["end_wall_ns"]
    for s in _named(tr, "validator.chain"):
        assert s["attrs"]["role"] in ("warm", "timed")
        assert s["attrs"]["steps"] > 0
    for s in _named(tr, "validator.escalation"):
        assert set(s["attrs"]) == {"lo", "hi", "lo_s", "hi_s", "target_s",
                                   "final"}


def test_full_validation_is_a_child_where_a_span_is_open(small, mesh):
    trace.configure(enabled=True)
    with trace.root_span("node.pass"):
        wl.run_full_validation(mesh, expected_chips=1)
    (tr,) = _traces()
    assert tr["name"] == "node.pass"
    (full,) = _named(tr, "validator.full")
    assert full["parent_id"] == tr["spans"][0]["span_id"]


@pytest.mark.parametrize("phase, counted, run", [
    ("burn_in", "_burn_in_step",
     lambda: wl.matmul_burn_in(size=BURN_IN, iters=4, device="cpu")),
    ("stress", "_triad_step",
     lambda: wl.hbm_stress(mib=STRESS_MIB, iters=2, device="cpu")),
    ("probe", "_burn_in_step",
     lambda: microbench.mxu_probe(device="cpu")),
])
def test_chain_steps_sum_to_the_steps_run(phase, counted, run, small,
                                          monkeypatch):
    """``steps`` of the ``validator.chain`` spans of the call add up to the
    steps its chains ran."""
    original = getattr(wl, counted)
    steps = []

    def step(*args, **kwargs):
        steps.append(1)
        return original(*args, **kwargs)
    monkeypatch.setattr(wl, counted, step)
    trace.configure(enabled=True)
    with trace.root_span("case"):
        assert run().ok
    (tr,) = _traces()
    chains = _named(tr, "validator.chain")
    # mxu_probe checks its kernel once outside any chain
    assert sum(s["attrs"]["steps"] for s in chains) == len(steps)
    assert len(chains) % 6 == 0


@pytest.mark.parametrize("window", [-1.0, math.inf])
def test_exactly_one_escalation_level_is_final(window, monkeypatch):
    """Any marginal clears a window below nought at the first level; an
    endless one escalates until the next level would pass the cap (64^2 at
    one step: 64, then 4096)."""
    monkeypatch.setattr(wl, "_MIN_MARGINAL_WINDOW_S", window)
    trace.configure(enabled=True)
    with trace.root_span("case"):
        rep = wl.matmul_burn_in(size=BURN_IN, iters=1, device="cpu")
    (tr,) = _traces()
    levels = _named(tr, "validator.escalation")
    assert [s["attrs"]["final"] for s in levels].count(True) == 1
    assert levels[-1]["attrs"]["final"]
    his = [s["attrs"]["hi"] for s in levels]
    assert his == ([64] if window < 1 else [64, 4096])
    assert rep.detail.endswith(f"over {BURN_IN}^2 x {his[-1]}")
    for s in levels:
        assert s["attrs"]["target_s"] == window and s["attrs"]["lo"] == 1
        assert {"lo_s", "hi_s"} <= set(s["attrs"])
        chains = [c for c in _under(tr, s) if c["name"] == "validator.chain"]
        assert [(c["attrs"]["steps"], c["attrs"]["role"]) for c in chains] \
            == [(1, "warm"), (1, "timed"), (1, "timed"),
                (s["attrs"]["hi"], "warm"), (s["attrs"]["hi"], "timed"),
                (s["attrs"]["hi"], "timed")]
    assert rep.duration_s == levels[-1]["attrs"]["hi_s"]


def _profiled(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the process's first range pays for loading the profiler's ops
        with record_function("warm-up"):
            pass
        components.run_component(
            "torch", components.Context(status_dir=str(tmp_path),
                                        device="cpu"))
    starts = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("validator."):
            starts.setdefault(e.name(), []).append(e.start_ns())
    return starts


def test_spans_are_profiler_ranges_on_the_wall_clock(small, tmp_path):
    """Each span is a ``record_function`` range of its name, which starts
    within 200 us of the span's wall-clock start (Unix nanoseconds, the
    profiler's clock); with the tracer off nothing is drawn."""
    assert _profiled(tmp_path) == {}
    trace.configure(enabled=True)
    starts = _profiled(tmp_path)
    (tr,) = _traces()
    for s in tr["spans"]:
        gap = min(abs(t - s["start_wall_ns"]) for t in starts[s["name"]])
        assert gap < 200_000, (s["name"], gap)
    assert sum(map(len, starts.values())) == len(tr["spans"])


def test_no_range_outside_a_profiler_session(small, tmp_path, monkeypatch):
    """With the tracer on, a span opens its range only while a profiler
    records: one range a span in a session, none after it."""
    real = torch.profiler.record_function
    opened = []

    def counted(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    trace.configure(enabled=True)
    _profiled(tmp_path)
    (tr,) = _traces()
    assert sorted(opened) == sorted(s["name"] for s in tr["spans"])
    opened.clear()
    trace.clear()
    components.run_component(
        "torch", components.Context(status_dir=str(tmp_path), device="cpu"))
    (tr,) = _traces()
    assert len(tr["spans"]) > 1 and opened == []


@pytest.mark.card
def test_graph_spans_on_the_card(card):
    """A captured chain on the card: a capture span, then a release span
    that hands the graph's pool back to the device (the allocator's reserve,
    read here around the spans, not by the program)."""
    init = torch.full((8, 1 << 20), 1.5, device="cuda")
    held = torch.cuda.memory_reserved()
    trace.configure(enabled=True)
    with trace.root_span("case"):
        with graphs.ChainGraphs() as cg:
            got = float(cg.run("scale", lambda a: a * 0.25 + 2.0, init,
                               2 * graphs.UNIT + 3).sum())
            captured = torch.cuda.memory_reserved()
    released = captured - torch.cuda.memory_reserved()
    assert math.isclose(got, init.numel() * 8.0 / 3.0, rel_tol=1e-4)
    assert captured > held and released > 0
    (tr,) = _traces()
    (capture,) = _named(tr, "validator.graphs.capture")
    assert capture["attrs"] == {"kind": "scale"}
    (release,) = _named(tr, "validator.graphs.release")
    assert release["attrs"] == {"graphs": 1}
    assert capture["end_mono"] <= release["start_mono"]
    assert release["end_mono"] > release["start_mono"]
