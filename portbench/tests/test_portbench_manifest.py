"""BENCHMARK.json against the contract's rules, and every name resolving to
its file."""
from __future__ import annotations

import ast
import json
import os
import re

import pytest

from portbench import harness
from portbench.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
MANIFEST = harness.Manifest(REPO)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_name_resolves_to_its_file():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(REPO, c["file"])))
        assert c["file"].startswith("portbench/") and cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in BENCH["workloads"]:
        cell = MANIFEST.cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (w["config"], w["traffic"], w["chips"], w["why"])
        assert all(v is not None for v in cell["limits"].values())
        MANIFEST.config(w["config"])
        MANIFEST.driver(MANIFEST.traffic(w["traffic"])["driver"])
        reported = MANIFEST.metrics_of(w["name"], False)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert MANIFEST.metrics_of(w["name"], True)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        reader = MANIFEST.reader(m["name"])
        assert (reader.UNIT, reader.SOURCE) == (m["unit"], m["source"])
        if "layer" in m:
            assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"]) and m["moves"] in e2e
            for cell in m["workloads"]:
                moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]][0]
                assert cell in moved.get("workloads", [cell])


def test_a_dropped_in_cell_config_and_metric_are_found(tmp_path):
    from portbench.tests import tiny

    root = tiny.make_root(str(tmp_path))
    m = harness.Manifest(root)
    assert m.cell(tiny.TRAIN)["config"] == "tiny" and m.config("tiny")["config"]["data"]["num_points"] == 256
    assert "units.tiny" in {x["name"] for x in m.metrics_of(tiny.SCENE, True)}
    assert m.reader("units.tiny").UNIT == "units"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    top = os.path.join(REPO, "portbench", sub)
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax_and_the_reference_imports_no_program():
    for path in _sources():
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path
    for path in _sources("reference"):
        assert "mvpnet_torch" not in set(_imports(path)), path
