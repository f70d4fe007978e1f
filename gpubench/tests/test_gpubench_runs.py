"""Whole runs of the harness: without a card, without the program, and on
the CPU path at small sizes with the real limits: sound, with each fault
planted under the timed path, and with the control in the program's
place."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from gpubench import harness, manifest
from gpubench.manifest import HERE, ROOT
from gpubench.tests import cpu_cells


CELLS = ["gate.node", "fullchain.node"]


def _limits():
    """The configurations' limits, the burn-in's at the CPU's sizes taken
    from the tightest of the card's."""
    bench = manifest.load()
    limits = {}
    for c in bench["configs"]:
        for name, value in manifest.config(bench, c["name"])["limits"].items():
            limits[name] = min(value, limits.get(name, value))
    burn = min(v for k, v in limits.items() if k.startswith("burn_in_gap."))
    for size in (cpu_cells.BURN_IN_TORCH, cpu_cells.BURN_IN_FULL,
                 cpu_cells.MXU_CPU):
        limits[f"burn_in_gap.{size}"] = burn
    return limits


@pytest.fixture
def root(tmp_path, monkeypatch):
    cpu_cells.shrink(monkeypatch)
    return cpu_cells.small_root(tmp_path, _limits())


def _run(root, cell, capsys, control=0, trace=0):
    rc = harness.main(["--workload", cell, "--seed", str(2 ** 31 + 17),
                       "--seconds", "0.5", "--trace", str(trace),
                       "--control", str(control)],
                      device="cpu", root=root)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_no_card_no_result():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        "gate.node", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "metrics" not in p.stdout and p.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and gpubench/."""
    shutil.copytree(HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path[0] = sys.argv[1]; "
            "from gpubench.harness import main; "
            "sys.exit(main(['--workload', 'gate.node', '--seed', '1', "
            "'--seconds', '1'], device='cpu'))")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell, capsys):
    line = _run(root, cell, capsys)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert "setup_s" in line["metrics"]
    assert "validate_s" in line["metrics"]
    assert isinstance(line["built_kernels"], bool)
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(root, cell, capsys):
    line = _run(root, cell, capsys, control=1)
    failed = [k for k, v in line["control"].items()
              if v > line["checks"][k]["limit"]]
    assert failed, (line["control"], line["checks"])


def _identity_step(acc, *args, **kwargs):
    return acc


def _stress_half_array(acc, c):
    # a pass over the first half of the array alone
    n = acc.numel() // 2
    torch.add(c[:n], acc[:n], alpha=0.25, out=acc[:n])
    return acc


def _triad_half_array(ops):
    original = ops.triad_

    def broken(a, b, scale, threads=256):
        n = a.shape[0] // 2
        original(a[:n], b[:n], scale, threads=threads)
        return a
    return broken


FAULTS = {
    # a step that returns its state unchanged
    "burn_in_step_unchanged": ("_burn_in_step", _identity_step,
                               CELLS),
    "stress_step_unchanged": ("_triad_step", _identity_step, CELLS),
    # half of the array left out of every pass: the answer the program
    # returns (its first eight elements) is right, the array is not
    "stress_half_array": ("_triad_step", _stress_half_array, CELLS),
}


def _half_batch(workloads):
    original = workloads.sharded_train_step

    def broken(*args, **kwargs):
        step, params, batch = original(*args, **kwargs)

        def half(params, x, y):
            # half of the batch left out, the mean taken over the rest
            return step(params, x[: x.shape[0] // 2], y[: y.shape[0] // 2])
        return half, params, batch
    return broken


def _altered_fma(ops):
    original = ops.fma_relu

    def broken(a, b, c):
        out = original(a, b, c)
        out.view(-1)[7] += 0.5          # one answer altered where produced
        return out
    return broken


def _altered_triad(ops):
    original = ops.triad_

    def broken(a, b, scale, threads=256):
        out = original(a, b, scale, threads=threads)
        out.view(-1)[3] += 0.5
        return out
    return broken


@pytest.mark.parametrize("fault, cell", [
    (name, cell) for name, (_, _, cells) in FAULTS.items() for cell in cells]
    + [("half_batch", "fullchain.node"), ("altered_fma", "gate.node"),
       ("altered_triad", "gate.node"), ("triad_half_array", "gate.node")])
def test_fault_is_caught(root, fault, cell, capsys, monkeypatch):
    from tpu_operator_torch.validator import ops, workloads

    if fault in FAULTS:
        name, broken, _ = FAULTS[fault]
        monkeypatch.setattr(workloads, name, broken)
    elif fault == "half_batch":
        monkeypatch.setattr(workloads, "sharded_train_step",
                            _half_batch(workloads))
    elif fault == "altered_fma":
        monkeypatch.setattr(ops, "fma_relu", _altered_fma(ops))
    elif fault == "triad_half_array":
        monkeypatch.setattr(ops, "triad_", _triad_half_array(ops))
    else:
        monkeypatch.setattr(ops, "triad_", _altered_triad(ops))
    line = _run(root, cell, capsys)
    assert not line["correct"], line["checks"]
    must = {"stress_half_array": "stress_gap",
            "triad_half_array": "triad_gap"}.get(fault)
    if must:
        check = line["checks"][must]
        assert check["value"] > check["limit"], line["checks"]


def test_traced_run_on_cpu(root, capsys):
    line = _run(root, "gate.node", capsys, trace=1)
    assert line["correct"]
    assert "span.burn_in_s" in line["metrics"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(card, cell):
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", cell,
                        "--seed", "12345", "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["kind"] == card
    assert torch.cuda.is_available()


@pytest.mark.card
def test_short_chain_caught_on_card(card, monkeypatch, capsys):
    """A stress chain that runs half its passes where it has passed the
    fixed point (constant arrays) returns the right array; the traced
    run's kernel count catches it, and reads nought in a sound run."""
    from tpu_operator_torch.validator import workloads

    args = ["--workload", "gate.node", "--seed", "77", "--seconds", "3",
            "--trace", "1"]
    assert harness.main(args) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["checks"]["short_chain_calls"]["value"] == 0
    assert line["correct"], line["checks"]

    original = workloads._triad_chain

    def short(b, c, reps, graphs=None):
        return original(b, c, reps if reps < 64 else reps // 2, graphs)

    monkeypatch.setattr(workloads, "_triad_chain", short)
    rc = harness.main(args)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert line["checks"]["stress_gap"]["value"] == 0
    assert line["checks"]["short_chain_calls"]["value"] > 0
    assert not line["correct"]


def test_taps_count_the_rules_steps(monkeypatch, tmp_path):
    """The steps the taps count in one pass are the escalation's and the
    two-point rate's (``roofline``'s restatement of them)."""
    from gpubench import compare, roofline
    from gpubench.cell import Cell
    from gpubench.taps import Taps

    cpu_cells.shrink(monkeypatch)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    config = manifest.config(manifest.load(), "gate-h100")
    mix = manifest.mix("torch_then_perf")
    entries = manifest.entries(mix)
    taps = Taps()
    for kind in manifest.kinds(compare.expected(config, mix,
                                                entries)).values():
        kind.install(taps)
    cell = Cell(config, mix, "cpu", entries).open()
    try:
        taps.pass_index = 0
        assert cell.run_pass().ok
    finally:
        taps.remove()
        cell.close()
    steps = {}
    for a in taps.answers:
        steps[(a.kind, a.size)] = steps.get((a.kind, a.size), 0) + a.steps
    # the CPU's chains stop at the first level (see cpu_cells.shrink)
    assert steps[("burn_in", cpu_cells.BURN_IN_TORCH)] == \
        roofline.escalation_steps(4, [4 * 64])
    assert steps[("stress", cpu_cells.STRESS_ELEMENTS)] == \
        roofline.escalation_steps(2, [2 * 64])
    # mxu_probe and hbm_probe on the CPU: reps 1, so (1, 16) and (1, 4)
    assert steps[("burn_in", cpu_cells.MXU_CPU)] == \
        roofline.two_point_steps(1, 16)
    assert steps[("triad", cpu_cells.TRIAD_CPU)] == \
        roofline.two_point_steps(1, 4)
    assert steps[("fma", cpu_cells.FMA)] == 1
