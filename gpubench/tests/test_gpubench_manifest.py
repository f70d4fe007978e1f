"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its file."""

import json
import re
import shutil

import pytest

from gpubench import manifest
from gpubench.manifest import ROOT
from gpubench.tests import cpu_cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert len(bench["command"]) <= 32
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_and_units(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    names += [w["config"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for kind in ("configs", "workloads"):
        listed = [x["name"] for x in bench[kind]]
        assert len(listed) == len(set(listed))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for text in ([c["source"] for c in bench["configs"]]
                 + [x["why"] for x in bench["configs"] + bench["workloads"]]
                 + [m["layer"] for m in bench["per_layer"]]
                 + bench["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_just_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_cell_reports_what_it_must(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in cells:
        own = [m for m in bench["end_to_end"]
               if cell in m.get("workloads", [cell])]
        assert len(own) >= 2
        assert any(cell in m.get("workloads", [cell])
                   for m in bench["per_layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", cells)) <= moved


def test_every_name_resolves(bench):
    from gpubench import compare

    for c in bench["configs"]:
        assert c["file"].startswith("gpubench/")
        config = manifest.config(bench, c["name"])
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"] == []
        assert config["source"] == c["source"]
        assert "limits" in config
    for w in bench["workloads"]:
        mix = manifest.mix(w["traffic"])
        assert mix["calls"]
        entries = manifest.entries(mix)
        config = manifest.config(bench, w["config"])
        for kind in manifest.kinds(
                compare.expected(config, mix, entries)).values():
            assert kind.STATED != kind.CONTROL
        for name in config.get("spans", {}).values():
            assert name.startswith("tpu_operator_torch.") and ":" in name
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = manifest.reader(m["name"])
        assert reader.UNIT == m["unit"] and reader.BETTER == m["better"]
    # every configuration is some cell's, and no file is two configs'
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])


def test_every_limit_is_a_number_a_cell_compares(bench):
    from gpubench import compare

    for w in bench["workloads"]:
        config = manifest.config(bench, w["config"])
        mix = manifest.mix(w["traffic"])
        want = compare.expected(config, mix, manifest.entries(mix))
        names = {"failed_passes", "answers_off_config", "short_chain_calls"}
        for kind, module in manifest.kinds(want).items():
            names |= set(module.numbers(sorted(want[kind])))
        assert names <= set(config["limits"]), (w["name"], names)


def test_a_cell_from_files_alone(tmp_path):
    """A new cell is a mix file and an entry: no code changes."""
    root = cpu_cells.small_root(tmp_path, {})
    with open(root / "gpubench" / "mixes" / "perf_twice.json", "w") as f:
        json.dump({"why": "the perf gate twice a pass", "calls": [
            {"entry": "component", "component": "perf"}] * 2}, f)
    bench = manifest.load(root / "BENCHMARK.json")
    bench["workloads"].append({"name": "gate.perf2", "config": "gate-cpu",
                               "traffic": "perf_twice", "chips": 1,
                               "why": "a dummy cell"})
    cell = manifest.cell(bench, "gate.perf2")
    mix = manifest.mix(cell["traffic"], root)
    assert mix["calls"][1]["component"] == "perf"
    assert manifest.config(bench, cell["config"], root)["name"] == "gate-cpu"
    entries = manifest.metrics(bench, "gate.perf2", trace=False)
    want = {"validate_s", "setup_s"}
    assert {m["name"] for m in entries} == want
    assert set(manifest.readers(entries, root)) == want
    assert set(manifest.entries(mix, root)) == {"component"}
    assert ROOT != root


def test_a_kind_and_an_entry_from_files_alone(tmp_path):
    """A new kind of call and a new kind of answer are files of their own,
    found by name: a mix that names them runs with no other change."""
    root = cpu_cells.small_root(tmp_path, {})
    (root / "gpubench" / "entries" / "noop.py").write_text(
        "def open(cell):\n    return {}\n\n\n"
        "def close(cell, objects):\n    pass\n\n\n"
        "def answers(config, call):\n    return {'nothing': [1]}\n\n\n"
        "def run(cell, objects, call, result):\n    return ''\n")
    (root / "gpubench" / "kinds" / "nothing.py").write_text(
        "STATED, CONTROL, CHAIN = 'f32', 'bf16', False\n")
    mix = {"why": "nothing", "calls": [{"entry": "noop"}]}
    entries = manifest.entries(mix, root)
    from gpubench import compare
    from gpubench.cell import Cell

    want = compare.expected({}, mix, entries)
    assert want == {"nothing": {1}}
    assert manifest.kinds(want, root)["nothing"].CHAIN is False
    cell = Cell({}, mix, "cpu", entries).open()
    try:
        assert cell.run_pass().ok
    finally:
        cell.close()


def test_a_configuration_from_files_alone(tmp_path, monkeypatch, capsys):
    """A new configuration is files of its own: a checkout that adds one
    with its CPU answer tables (``tests/cpu_configs/``), a mix and a cell,
    and one more without CPU tables, keeps its cells' CPU runs and runs
    the new cell; the configuration without tables is copied as it is."""
    from gpubench import harness
    from gpubench.tests.test_gpubench_runs import _limits

    source = tmp_path / "source"
    shutil.copytree(manifest.HERE, source / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = manifest.load()
    gate = manifest.config(bench, "gate-h100")
    probe = dict(gate, name="probe-h100", source="the perf gate alone",
                 components={"perf": gate["components"]["perf"]})
    later = dict(manifest.config(bench, "fullchain-h100"), name="later-h100")
    gb = source / "gpubench"
    for config in (probe, later):
        (gb / "configs" / f"{config['name']}.json").write_text(
            json.dumps(config))
        bench["configs"].append({
            "name": config["name"], "source": config["source"],
            "file": f"gpubench/configs/{config['name']}.json",
            "reduced": [], "why": "a configuration from files"})
    (gb / "tests" / "cpu_configs" / "probe-h100.json").write_text(
        json.dumps({"name": "probe-cpu", "answers": {"perf": {
            "burn_in": [cpu_cells.MXU_CPU], "triad": [cpu_cells.TRIAD_CPU],
            "fma": [cpu_cells.FMA]}}}))
    (gb / "mixes" / "perf_gate.json").write_text(json.dumps({
        "why": "the perf gate alone", "calls": [
            {"entry": "component", "component": "perf"}]}))
    bench["workloads"] += [
        {"name": "probe.node", "config": "probe-h100", "traffic": "perf_gate",
         "chips": 1, "why": "a cell from files"},
        {"name": "later.node", "config": "later-h100",
         "traffic": "full_validation", "chips": 1, "why": "no CPU tables"}]
    (source / "BENCHMARK.json").write_text(json.dumps(bench))

    cpu_cells.shrink(monkeypatch)
    root = cpu_cells.small_root(tmp_path / "small", _limits(), source=source)
    small = manifest.load(root / "BENCHMARK.json")
    assert [c["name"] for c in small["configs"]] == [
        "gate-cpu", "fullchain-cpu", "probe-cpu", "later-h100"]
    assert manifest.config(small, "later-h100", root) == later
    assert manifest.cell(small, "later.node")["config"] == "later-h100"
    for cell in ("gate.node", "fullchain.node", "probe.node"):
        rc = harness.main(["--workload", cell, "--seed", str(2 ** 31 + 29),
                           "--seconds", "0.5", "--trace", "0"],
                          device="cpu", root=root)
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and line["correct"], (cell, line["checks"])
        assert line["attempted"] >= 1 and line["failed"] == 0
        # a cell on one card reports the one peak, as it always has
        assert list(line["device"]) == ["platform", "kind", "count",
                                        "memory_peak_bytes"]
    assert "burn_in_gap.256" in line["checks"]
    assert "stress_gap" not in line["checks"]
