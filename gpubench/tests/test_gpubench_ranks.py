"""Ranks held for the run (``gpubench.ranks``), on four gloo ranks in the
small root, through the harness: a test-only cell (``tests/held/``, listed
in no ``BENCHMARK.json`` but the small root's) sums a seeded vector over the
ranks each pass and compares rank 0's sum with a plain ``torch`` sum.

Runs in which a child fails go in a process of their own, as a rank 0 that
never returns from a broken call ends its process.  Ranks that break end
the run with exit code 3 and no result line, as does a child that has
loaded JAX."""

import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from gpubench import harness, manifest
from gpubench.manifest import HERE, ROOT
from gpubench.ranks import Ranks, RanksError
from gpubench.tests import cpu_cells, held

HELD = HERE / "tests" / "held"
CELL = "held.sum"


def _held_root(tmp_path, calls=None, **config):
    """The small root with the test-only cell added from files: its
    configuration (``config`` over ``held``'s keys), mix (``calls`` in
    place of its own), entry and kind."""
    root = cpu_cells.small_root(tmp_path, {})
    for folder in ("configs", "mixes", "entries", "kinds"):
        for path in (HELD / folder).iterdir():
            shutil.copy(path, root / "gpubench" / folder / path.name)
    path = root / "gpubench" / "configs" / "held-cpu.json"
    cfg = json.loads(path.read_text())
    cfg["held"].update(config)
    path.write_text(json.dumps(cfg))
    if calls is not None:
        (root / "gpubench" / "mixes" / "held_sum.json").write_text(
            json.dumps({"why": "test only", "calls": calls}))
    bench = manifest.load(root / "BENCHMARK.json")
    bench["configs"].append({"name": "held-cpu", "source": cfg["source"],
                             "file": "gpubench/configs/held-cpu.json",
                             "reduced": [], "why": "test only"})
    bench["workloads"].append({"name": CELL, "config": "held-cpu",
                               "traffic": "held_sum", "chips": 4,
                               "why": "test only"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


ARGS = ["--workload", CELL, "--seed", str(2 ** 31 + 3), "--seconds", "1",
        "--trace", "0"]
# a window far longer than any run that ends at a failed pass takes
LONG_ARGS = ARGS[:-3] + ["300", "--trace", "0"]


def _run(root, capsys):
    assert harness.main(ARGS, device="cpu", root=root) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _gone(pid_file) -> None:
    """No process the run started is left: its children, its forkserver
    and resource tracker, none even a zombie."""
    pids = json.loads(pid_file.read_text())
    assert len(pids["children"]) == 3 and all(pids["servers"])
    for pid in pids["children"] + pids["servers"]:
        assert not os.path.exists(f"/proc/{pid}"), \
            f"process {pid} outlived the run"


def _run_apart(root, device="cpu", args=ARGS):
    """A run in a process of its own: the completed process, its line (None
    where it printed none), its passes' seconds and its own seconds."""
    code = ("import sys; from pathlib import Path; sys.path[0] = sys.argv[1]; "
            "from gpubench.harness import main; "
            f"sys.exit(main({args!r}, device={device!r}, "
            "root=Path(sys.argv[2])))")
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-c", code, str(ROOT), str(root)],
                       capture_output=True, text=True, timeout=600)
    elapsed = time.monotonic() - t0
    line = (json.loads(p.stdout.strip().splitlines()[-1])
            if p.stdout.strip() else None)
    found = re.search(r"pass seconds ([0-9. ]+)", p.stderr)
    passes = [float(s) for s in found.group(1).split()] if found else []
    return p, line, passes, elapsed


def test_sound_run_is_correct(tmp_path, capsys):
    """Correct, with every card's peak beside the fullest (0 each on the
    CPU), and no process left once the run has closed."""
    pid_file = tmp_path / "pids.json"
    line = _run(_held_root(tmp_path, pid_file=str(pid_file)), capsys)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 2
    assert line["checks"]["held_sum_gap"]["value"] <= 1e-5
    assert line["checks"]["answers_off_config"]["value"] == 0
    device = line["device"]
    assert list(device) == ["platform", "kind", "count", "memory_peak_bytes",
                            "memory_peak_by_card"]
    assert device["memory_peak_by_card"] == [0, 0, 0, 0]
    assert device["memory_peak_bytes"] == 0 and device["count"] == 4
    _gone(pid_file)


def test_planted_error_is_caught(tmp_path, capsys):
    line = _run(_held_root(tmp_path, calls=[
        {"entry": "held_sum", "fault": "error", "rank": 2}]), capsys)
    assert not line["correct"]
    assert line["failed"] == 0
    check = line["checks"]["held_sum_gap"]
    assert check["value"] > check["limit"], line["checks"]


@pytest.mark.parametrize("fault, says", [
    ("die", "rank 2 died in gpubench.tests.held:allreduce_sum (exit code -9)"),
    ("raise", "RuntimeError: a fault planted on rank 2")])
def test_a_failing_child_ends_the_run(tmp_path, fault, says):
    """A child killed, or raising, in the middle of a 300 s window, while
    rank 0 is inside the all-reduce: the run ends at that pass, set-up
    included within 120 s, with exit code 3, the child's own error and no
    result line, and no process is left."""
    pid_file = tmp_path / "pids.json"
    root = _held_root(tmp_path, pid_file=str(pid_file), calls=[
        {"entry": "held_sum", "fault": fault, "rank": 2, "from_call": 3}])
    p, line, _, elapsed = _run_apart(root, args=LONG_ARGS)
    assert p.returncode == 3, p.stderr[-4000:]
    assert line is None, p.stdout[-4000:]
    assert says in p.stderr, p.stderr[-4000:]
    assert elapsed < 120.0, elapsed
    _gone(pid_file)


def test_a_rank_that_loaded_jax_ends_the_run(tmp_path, capsys):
    """A child (not rank 0) holding a module named ``jax`` once the window
    has closed: exit code 3, the rank and the module named, no result line,
    and no process left."""
    pid_file = tmp_path / "pids.json"
    root = _held_root(tmp_path, pid_file=str(pid_file), calls=[
        {"entry": "held_sum", "fault": "jax", "rank": 2}])
    assert harness.main(ARGS, device="cpu", root=root) == 3
    out, err = capsys.readouterr()
    assert out.strip() == ""
    assert "loaded in the held ranks: rank 2: jax" in err, err[-4000:]
    assert "jax" not in sys.modules or sys.modules["jax"].__spec__ is not None
    _gone(pid_file)


def test_missing_function_fails_at_open(tmp_path, capsys):
    """An entry naming a function the checkout lacks (as a parent commit
    lacks the function its child adds) fails before any child starts."""
    pid_file = tmp_path / "pids.json"
    root = _held_root(tmp_path, pid_file=str(pid_file),
                      function="gpubench.tests.held:nccl_checks")
    before = set(multiprocessing.active_children())
    t0 = time.monotonic()
    assert harness.main(ARGS, device="cpu", root=root) == 3
    assert time.monotonic() - t0 < 60.0
    assert set(multiprocessing.active_children()) == before
    assert not pid_file.exists()
    out, err = capsys.readouterr()
    assert out.strip() == ""
    assert "no function gpubench.tests.held:nccl_checks" in err, err[-4000:]


def test_run_peaks_and_close_directly():
    """The calls an entry makes, without the harness: one rank is refused,
    a name not given at open is refused, a sound call returns rank 0's sum,
    and close ends every child."""
    with pytest.raises(ValueError):
        Ranks(1, "cpu", [held.FUNCTION])
    ranks = Ranks(4, "cpu", [held.FUNCTION]).open()
    try:
        with pytest.raises(RanksError, match="not named"):
            ranks.run("gpubench.tests.held:allocate", 1)
        out = ranks.run(held.FUNCTION, 64)
        import torch
        want = sum(held.rank_input(64, r) for r in range(4))
        assert torch.allclose(out, want, rtol=0, atol=1e-5)
        assert ranks.peaks() == [0, 0, 0, 0]
        children = ranks.pids
    finally:
        ranks.close()
    assert all(not os.path.exists(f"/proc/{pid}") for pid in children)


@pytest.mark.card
def test_held_ranks_on_four_cards(card, tmp_path):
    """On four cards, NCCL: a sound all-reduce, each card's own peak, a
    planted error caught through the harness, and a child killed or
    raising in a 300 s window ending the run (exit code 3, no result line)
    within 120 s with no process left."""
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    ranks = Ranks(4, "cuda", [held.FUNCTION, "gpubench.tests.held:allocate"])
    ranks.open()
    try:
        out = ranks.run(held.FUNCTION, 1 << 20)
        want = sum(held.rank_input(1 << 20, r) for r in range(4))
        assert torch.allclose(out.cpu(), want, rtol=0, atol=1e-5)
        ranks.run("gpubench.tests.held:allocate", 256)
        peaks = ranks.peaks()
        for rank, peak in enumerate(peaks):
            assert peak >= (rank + 1) * 256 * 1024 * 1024, peaks
    finally:
        ranks.close()
    for fault, says in ((None, None), ("error", None), ("die", "died"),
                        ("raise", "a fault planted on rank 2")):
        pid_file = tmp_path / f"{fault}.json"
        (tmp_path / str(fault)).mkdir()
        calls = [{"entry": "held_sum"} if fault is None else
                 {"entry": "held_sum", "fault": fault, "rank": 2,
                  "from_call": 3}]
        root = _held_root(tmp_path / str(fault), pid_file=str(pid_file),
                          calls=calls)
        if says is not None:
            p, line, _, elapsed = _run_apart(root, device=None,
                                             args=LONG_ARGS)
            assert p.returncode == 3 and line is None, p.stderr[-4000:]
            assert says in p.stderr, p.stderr[-4000:]
            assert elapsed < 120.0, elapsed
            _gone(pid_file)
            continue
        p, line, _, _ = _run_apart(root, device=None)
        assert p.returncode == 0, p.stderr[-4000:]
        assert line["correct"] is (fault is None), line["checks"]
        by_card = line["device"]["memory_peak_by_card"]
        assert len(by_card) == 4 and line["device"]["count"] == 4
        if fault is None:
            assert all(peak > 0 for peak in by_card), by_card
            assert line["device"]["memory_peak_bytes"] == max(by_card)
        _gone(pid_file)
