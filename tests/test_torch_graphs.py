"""The validator's chains replayed as CUDA graphs (``validator/graphs.py``):
the helper's bookkeeping on the CPU, with a stand-in for
``torch.cuda.CUDAGraph``.

The stand-in records the captured body and runs it again on each replay
with the Python launch counts put back, as a replay launches the recorded
kernels without the wrappers' Python.  The steps are the chains' own
(the burn-in's, the probe's triad and the memory stress's), each wrapped so
that it counts one launch of its kernel as the wrapper does on the card.
On the card ``chip_smoke.py``'s ``graph_chains`` phase holds the replayed
chains against the eager ones bit for bit.
"""

import numpy as np
import pytest
import torch

from tpu_operator_torch.validator import graphs, microbench as mb, ops
from tpu_operator_torch.validator import workloads as wl

K = graphs.UNIT


class FakeGraph:
    """Stand-in for ``torch.cuda.CUDAGraph``."""
    made: list = []
    replaying = False

    def __init__(self):
        self.body = None
        self.replays = 0
        self.released = False
        FakeGraph.made.append(self)

    def record(self, body):
        # a capture runs the body's Python (the wrappers count) once
        self.body = body
        body()

    def replay(self):
        assert self.body is not None and not self.released
        saved = dict(ops.LAUNCHES)
        FakeGraph.replaying = True
        try:
            self.body()
        finally:
            FakeGraph.replaying = False
        ops.LAUNCHES.update(saved)
        self.replays += 1

    def reset(self):
        self.released = True


@pytest.fixture(autouse=True)
def fake_graphs(monkeypatch):
    FakeGraph.made = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(graphs, "_record", lambda graph, body: graph.record(body))
    ops.reset_launches()
    yield FakeGraph
    ops.reset_launches()


def _counted(step, name):
    """``step``, counting one launch of ``name`` per call as its wrapper
    does, and in ``calls`` the calls whose Python ran (not a replay's)."""
    calls = []

    def run(acc):
        ops.LAUNCHES[name] += 1
        if not FakeGraph.replaying:
            calls.append(1)
        return step(acc)
    run.calls = calls
    return run


def _chains():
    """(name, step, start) of each chain the validator replays, at small
    shapes, from a seed."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((64, 64), generator=g).bfloat16()
    w = torch.randn((64, 64), generator=g).bfloat16()
    a = torch.randn((8, 2048), generator=g)
    b = torch.randn((8, 2048), generator=g)
    return {
        "burn-in": (lambda acc: wl._burn_in_step(acc, w, 64, 0), x,
                    "matmul_bf16_f32"),
        "probe-triad": (lambda acc: ops.triad_(acc, b, 0.25, threads=256),
                        a, "triad_"),
        "stress": (lambda acc: wl._triad_step(acc, b[0]), a[0], "triad_"),
    }


def _eager(step, start, n):
    acc = start.clone()
    for _ in range(n):
        acc = step(acc)
    return acc


@pytest.mark.parametrize("n", [0, K - 1, K, 37])
@pytest.mark.parametrize("name", ["burn-in", "probe-triad", "stress"])
def test_replayed_chain_is_the_eager_chain(name, n):
    """n // K replays of the unit and n % K eager steps after them; the
    value equal to the eager chain's bit for bit; in steady state the
    launch counts equal the eager chain's, the first capture adding one
    counted warm-up step; the start value left intact."""
    step, start, kernel = _chains()[name]
    before = start.clone()
    ops.reset_launches()
    want = _eager(_counted(step, kernel), start, n)
    eager_launches = dict(ops.LAUNCHES)
    assert eager_launches[kernel] == n

    replays, rest = divmod(n, K)
    with graphs.ChainGraphs() as cg:
        assert cg.plan(n) == (replays, rest)
        for run in range(2):
            counted = _counted(step, kernel)
            ops.reset_launches()
            got = cg.run(("chain", name), counted, start, n)
            assert torch.equal(got, want), (name, n, run)
            warm = 1 if run == 0 and replays else 0
            assert ops.LAUNCHES[kernel] == n + warm
            assert {k: v for k, v in ops.LAUNCHES.items() if k != kernel} \
                == {k: v for k, v in eager_launches.items() if k != kernel}
            # Python ran: the warm-up and the captured unit at the first
            # run, then only the eager steps after the replays
            assert len(counted.calls) == rest + (1 + K if warm else 0)
        made = list(FakeGraph.made)
        assert len(made) == (1 if replays else 0)
        assert all(g.replays == 2 * replays for g in made)
    assert all(g.released for g in made)
    assert torch.equal(start, before)


def test_one_unit_per_key_and_each_released():
    """A unit is captured once per key and start shape, reused by every
    later chain of the key, and every one released at close."""
    def step(acc):
        return acc.mul_(0.25).add_(2.0)
    start = torch.ones((8, 2048))
    with graphs.ChainGraphs() as cg:
        for n in (K, 2 * K, 37):
            cg.run("a", step, start, n)
        assert len(FakeGraph.made) == 1
        cg.run("b", step, start, K)
        cg.run("a", step, start[:4], K)
        assert len(FakeGraph.made) == 3
        assert [g.replays for g in FakeGraph.made] == [1 + 2 + 2, 1, 1]
    assert all(g.released for g in FakeGraph.made)


def test_chain_without_graphs_releases_its_own():
    step, start, kernel = _chains()["burn-in"]
    want = _eager(step, start, 2 * K + 3)
    got = graphs.chain(None, "k", step, start, 2 * K + 3)
    assert torch.equal(got, want)
    assert len(FakeGraph.made) == 1 and FakeGraph.made[0].released


def test_a_failed_capture_raises_and_counts_only_the_warm_up(monkeypatch):
    """No fallback: a capture that fails raises out of the chain, with the
    counts its recording added taken back."""
    def broken(graph, body):
        body()
        raise RuntimeError("operation not permitted when stream is capturing")
    monkeypatch.setattr(graphs, "_record", broken)
    step, start, kernel = _chains()["probe-triad"]
    with graphs.ChainGraphs() as cg:
        with pytest.raises(RuntimeError, match="capturing"):
            cg.run("k", _counted(step, kernel), start, K)
    assert ops.LAUNCHES[kernel] == 1


def test_a_negative_chain_is_refused():
    with pytest.raises(ValueError):
        graphs.ChainGraphs().plan(-1)


def test_cpu_chains_stay_eager():
    """On CPU tensors the validator's chains run their plain versions
    eagerly: no graph, no launch, the same values as before."""
    step, x, _ = _chains()["burn-in"]
    w = torch.randn((64, 64), generator=torch.Generator().manual_seed(1)
                    ).bfloat16()
    acc = x
    for _ in range(37):
        acc = wl._burn_in_step(acc, w, 64, 0)
    assert float(wl._burn_in_fn(x, w, 37)) == float(acc.float().sum())

    a = torch.full((8, 2048), 1.5)
    b = torch.full((8, 2048), 2.0)
    got = float(mb._triad_chain(a, b, 256, 37))
    assert np.isclose(got, 8 * 8.0 / 3.0, rtol=1e-5)
    assert torch.equal(a, torch.full((8, 2048), 1.5))      # left intact
    assert np.allclose(wl._triad_chain(a[0], b[0], 37).numpy(), 8.0 / 3.0)
    assert FakeGraph.made == [] and set(ops.LAUNCHES.values()) == {0}


def test_spans_of_a_capture_and_a_release():
    """With the tracer on: one ``validator.graphs.capture`` span for the
    key (its kind, the key's first item) and one ``release`` at close (the
    graphs released); none per run or replay, and no release where nothing
    was captured."""
    from tpu_operator_torch.obs import trace

    step, start, kernel = _chains()["stress"]
    trace.reset()
    trace.configure(enabled=True)
    try:
        with trace.root_span("case"):
            with graphs.ChainGraphs() as cg:
                for n in (K - 1, 2 * K + 3, K):
                    cg.run(("stress", 7), step, start, n)
            with graphs.ChainGraphs():
                pass                      # nothing captured: no release
        (tr,) = trace.snapshot(1)["recent"]
    finally:
        trace.reset()
    got = [(s["name"], s["attrs"]) for s in tr["spans"][1:]]
    assert got == [
        ("validator.graphs.capture", {"kind": "stress"}),
        ("validator.graphs.release", {"graphs": 1}),
    ]
    assert [g.replays for g in FakeGraph.made] == [3]
