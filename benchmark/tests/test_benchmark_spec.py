"""BENCHMARK.json and the files it names: every cell, configuration,
traffic kind and metric loads from its own file, names and units keep to
the allowed characters, and each cell reports what the contract asks."""

import json
import os
import re

import pytest

from conftest import ROOT

from benchmark import harness

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert LINE.match(e[key]), (e["name"], key)
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    body = json.load(open(os.path.join(ROOT, cfg["file"])))
    assert body["name"] == cfg["name"]
    assert body["reduced"] == cfg["reduced"] == []
    assert body["assumed"]
    assert os.path.exists(os.path.join(ROOT, "benchmark", "reference",
                                       f"{body['reference']}.py"))
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_file(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    body = json.load(open(os.path.join(ROOT, "benchmark", "workloads",
                                       f"{cell['name']}.json")))
    assert (body["name"], body["config"], body["traffic"]) == (
        cell["name"], cell["config"], cell["traffic"])
    assert "kind" not in body
    assert body["limits"] and all(v >= 0 for v in body["limits"].values())


def _files(folder):
    path = os.path.join(ROOT, "benchmark", folder)
    return sorted(n[:-5] for n in os.listdir(path) if n.endswith(".json"))


@pytest.mark.parametrize("name", _files("configs"))
def test_every_config_finds_its_modules(name):
    """Each configuration file, listed or not, names a model, a data set
    and a reference that are files of their own."""
    body = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                       f"{name}.json")))
    assert body["name"] == name and NAME.match(name)
    for folder, module in (("models", body["model"]),
                           ("datasets", body["data"]["kind"]),
                           ("reference", body["reference"])):
        assert os.path.exists(os.path.join(ROOT, "benchmark", folder,
                                           f"{module}.py")), (folder, module)


@pytest.mark.parametrize("name", _files("workloads"))
def test_every_workload_finds_its_files(name):
    body = json.load(open(os.path.join(ROOT, "benchmark", "workloads",
                                       f"{name}.json")))
    assert body["name"] == name and NAME.match(name)
    assert body["config"] in _files("configs")
    assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic",
                                       f"{body['traffic']}.py"))
    assert LINE.match(body["why"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_reports(cell):
    e2e, per_layer = harness.cell_metrics(SPEC, cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer
    for m in per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(metric):
    path = os.path.join(ROOT, "benchmark", "metrics", f"{metric['name']}.py")
    reader = harness.load_file_module(path, "metric_under_test")
    assert callable(reader.read)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert metric["moves"] in e2e
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
