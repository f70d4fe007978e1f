"""The readers of the program's own spans (``program_spans`` and the
``graphs.*`` and ``escalation.*`` metrics): a traced run on the CPU path
reports the escalation's metrics and no graph's, an untraced run leaves the
port's tracer off, and each reader's arithmetic on spans made by hand.

Importing ``program_spans`` switches the port's tracer on for the process,
so every case starts and ends with the tracer off and the module unloaded.
"""

import json
import statistics
import sys

import pytest

import gpubench
from gpubench import harness, manifest
from gpubench.observed import Observed
from gpubench.tests import cpu_cells
from gpubench.tests.test_gpubench_runs import _limits
from tpu_operator_torch.obs import trace

CELLS = ["gate.node", "fullchain.node"]
ESCALATION = {"escalation.untimed_share", "escalation.window_over_target"}
GRAPHS = {"graphs.release_s", "graphs.capture_s"}


def _unload() -> None:
    """Off, empty, and ``program_spans`` imported anew by the next reader."""
    sys.modules.pop("gpubench.program_spans", None)
    if hasattr(gpubench, "program_spans"):
        del gpubench.program_spans
    trace.reset()


@pytest.fixture(autouse=True)
def tracer_off():
    _unload()
    yield
    _unload()


@pytest.fixture
def root(tmp_path, monkeypatch):
    cpu_cells.shrink(monkeypatch)
    return cpu_cells.small_root(tmp_path, _limits())


def _run(root, cell, trace_flag, capsys):
    rc = harness.main(["--workload", cell, "--seed", str(2 ** 31 + 5),
                       "--seconds", "0.5", "--trace", str(trace_flag)],
                      device="cpu", root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_escalation(root, cell, capsys):
    line = _run(root, cell, 1, capsys)
    assert line["correct"], line["checks"]
    metrics = line["metrics"]
    assert ESCALATION <= set(metrics)
    # no graph runs on the CPU
    assert not GRAPHS & set(metrics)
    assert "span.burn_in_s" in metrics and "span.stress_s" in metrics
    # the CPU path's escalation stops at its first level (cpu_cells.shrink)
    share = metrics["escalation.untimed_share"]["value"]
    assert 0.0 < share < 100.0
    assert metrics["escalation.window_over_target"]["value"] > 1.0
    assert metrics["escalation.window_over_target"]["unit"] == "x"
    assert trace.is_enabled()


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_keeps_the_tracer_off(root, cell, capsys):
    line = _run(root, cell, 0, capsys)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"validate_s", "setup_s"}
    assert "gpubench.program_spans" not in sys.modules
    assert not trace.is_enabled()
    assert trace.snapshot(10) == {"recent": [], "slowest": []}


def _readers():
    bench = manifest.load()
    names = [m["name"] for m in bench["per_layer"]
             if m["source"] == "program_span"]
    assert set(names) == ESCALATION | GRAPHS
    return {name: manifest.reader(name) for name in names}


def _observed(passes, traced=()):
    return Observed(0.0, passes, [], [], [{} for _ in passes], {},
                    traced=set(traced))


def test_a_program_without_spans_reads_nothing():
    """The parent of the spans' change: the tracer is on and nothing is
    stored, so every reader returns None and none raises."""
    readers = _readers()
    assert trace.is_enabled()
    obs = _observed([(0.0, 1.0), (1.0, 2.0)])
    assert {name: r.read(obs) for name, r in readers.items()} == \
        dict.fromkeys(readers)


def _span(sid, parent, name, t0, t1, **attrs):
    return {"span_id": sid, "parent_id": parent, "name": name,
            "start_mono": t0, "end_mono": t1, "attrs": attrs}


def test_readers_on_spans_made_by_hand(monkeypatch):
    """Two passes the profiler did not record and one it did (read by no
    reader): per pass a non-final level, a final one with warm and timed
    chain calls, a capture and a release."""
    readers = _readers()
    from gpubench import program_spans

    def one_pass(p, t, release_s, hi_s):
        return [
            _span(f"{p}r", "", "validator.component", t, t + 0.9),
            _span(f"{p}e1", f"{p}r", "validator.escalation", t, t + 0.1,
                  final=False, hi_s=0.01, target_s=0.05),
            _span(f"{p}c1", f"{p}e1", "validator.chain", t, t + 0.1,
                  role="timed", steps=64),
            _span(f"{p}e2", f"{p}r", "validator.escalation", t + 0.1,
                  t + 0.7, final=True, hi_s=hi_s, target_s=0.05),
            _span(f"{p}c2", f"{p}e2", "validator.chain", t + 0.1, t + 0.3,
                  role="warm", steps=4096),
            _span(f"{p}c3", f"{p}e2", "validator.chain", t + 0.3, t + 0.7,
                  role="timed", steps=4096),
            _span(f"{p}g", f"{p}r", "validator.graphs.capture", t + 0.1,
                  t + 0.125, kind="stress"),
            _span(f"{p}x", f"{p}r", "validator.graphs.release", t + 0.7,
                  t + 0.7 + release_s, graphs=1),
        ]
    traces = [{"spans": one_pass("a", 1.0, 0.5, 1.0)},
              {"spans": one_pass("b", 2.0, 0.25, 0.5)},
              {"spans": one_pass("c", 3.0, 0.0625, 2.0)}]
    monkeypatch.setattr(program_spans.trace, "snapshot",
                        lambda n: {"recent": traces, "slowest": []})
    obs = _observed([(0.5, 2.0), (2.0, 2.95), (3.0, 3.95)], traced={0})
    got = {name: r.read(obs) for name, r in readers.items()}
    assert got["graphs.release_s"] == pytest.approx((0.25 + 0.0625) / 2)
    assert got["graphs.capture_s"] == pytest.approx(0.025)
    # untimed: the non-final level's call and the warm call, 0.1 + 0.2 of
    # the 0.7 chain seconds in each pass
    assert got["escalation.untimed_share"] == pytest.approx(300 / 7)
    assert got["escalation.window_over_target"] == \
        pytest.approx(statistics.median([0.5 / 0.05, 2.0 / 0.05]))
