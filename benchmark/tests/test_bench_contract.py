"""BENCHMARK.json against the benchmark's contract, and the harness's
data-driven lookup."""

import hashlib
import json
import re
import shutil

import pytest

from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["command"]) <= 32 and all(TEXT.match(w) and not w.startswith("/") for w in bench["command"])
    assert (ROOT / bench["command"][1]).is_file() and bench["command"][1].startswith(bench["paths"][0] + "/")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for entry in bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        names.append(entry["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"]) and w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert TEXT.match(c["why"]) and TEXT.match(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in bench["per_layer"]:
        assert TEXT.match(m["layer"])
    assert len(set(n for n in names)) == len(names)


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_reports_setup_another_and_a_layer(bench):
    from benchmark import harness

    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], ROOT, bench)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        assert cell.traffic["metric"] in names


def test_moves_is_reported_by_the_metrics_workloads(bench):
    from benchmark import harness

    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in {x["name"] for x in harness.load_cell(cell, ROOT, bench).end_to_end}


def test_files_lie_under_paths(bench):
    paths = [ROOT / p for p in bench["paths"]]
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert any(p in (ROOT / f).parents for p in paths) and (ROOT / f).is_file()
    for w in bench["workloads"]:
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def test_configs_state_their_reductions(bench):
    for c in bench["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_config_traffic_and_metric_are_added_by_files_alone(tmp_path, bench):
    """A later change adds a configuration, a traffic mix, a metric and a
    cell by adding files and entries; no file the benchmark has changes."""
    from benchmark import harness

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    conf = json.loads((ROOT / bench["configs"][0]["file"]).read_text())
    conf["n"] = 123
    (b / "configs" / "dummy.json").write_text(json.dumps(conf))
    (b / "traffic" / "dummy-mix.json").write_text(json.dumps({"kind": "train", "metric": "step_s",
                                                              "setup_steps": 3, "check_steps": 3,
                                                              "profile_after": 1, "profile_units": 1}))
    (b / "limits" / "dummy.dummy-mix.json").write_text(json.dumps({"loss_gap": 1.0}))
    (b / "metrics" / "dummy_count.train.py").write_text("def read(r):\n    return 7.0\n")
    new = json.loads((tmp_path / "BENCHMARK.json").read_text())
    new["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                           "file": "benchmark/configs/dummy.json", "reduced": [], "why": "dummy"})
    new["workloads"].append({"name": "dummy.dummy-mix", "config": "dummy", "traffic": "dummy-mix", "chips": 1,
                             "why": "dummy"})
    new["end_to_end"][0]["workloads"].append("dummy.dummy-mix")
    new["per_layer"].append({"name": "dummy_count.train", "unit": "1", "better": "lower", "source": "program_counter",
                             "layer": "operator", "moves": "step_s", "workloads": ["dummy.dummy-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    cell = harness.load_cell("dummy.dummy-mix", tmp_path)
    assert cell.config["n"] == 123 and cell.traffic["kind"] == "train" and cell.limits == {"loss_gap": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["dummy_count.train"]
    reading = harness.Reading(cell=cell, units=1, spans={}, span_units=0, launches={}, stretch=None,
                              stretch_launches={})
    assert harness.read_metric("dummy_count.train", reading, b / "metrics") == 7.0
    after = _digest(b)
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == {"configs/dummy.json", "traffic/dummy-mix.json",
                                        "limits/dummy.dummy-mix.json", "metrics/dummy_count.train.py"}
