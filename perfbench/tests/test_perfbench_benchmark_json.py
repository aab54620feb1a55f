"""BENCHMARK.json against the files the harness finds by name, and
against the contract's limits on names, keys and sizes."""

import json
import re

import pytest

from perfbench import harness

DOC = json.loads((harness.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in DOC["end_to_end"]}


def test_keys_and_sizes():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert (harness.REPO / "BENCHMARK.json").stat().st_size < 64 * 1024
    assert DOC["paths"] == ["perfbench"]
    assert DOC["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= DOC["run_seconds"] <= 51
    n = len(DOC["workloads"])
    assert 2 + 14 * 24 * (DOC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200 and n <= 24
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]


def test_names_units_and_texts():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in DOC[k]]
    assert len(names) == len(set(names))
    for x in names:
        assert NAME.match(x), x
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in DOC["configs"] + DOC["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]


@pytest.mark.parametrize("w", DOC["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files(w):
    cell = harness.load_cell(w["name"])
    spec = json.loads((harness.ROOT / "workloads" /
                       f"{w['name']}.json").read_text())
    assert (spec["config"], spec["traffic"], spec["chips"]) == (
        w["config"], w["traffic"], w["chips"])
    want = sorted(m for m, e in E2E.items()
                  if w["name"] in e.get("workloads", [w["name"]]))
    assert sorted(cell.end_to_end) == want and "setup_s" in want
    assert len(want) >= 2
    assert harness.per_layer_names(w["name"])
    harness.driver(cell)
    harness.generator(cell.config)


@pytest.mark.parametrize("c", DOC["configs"], ids=lambda c: c["name"])
def test_each_config_has_its_file(c):
    cfg = json.loads((harness.REPO / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    assert any(w["config"] == c["name"] for w in DOC["workloads"])


@pytest.mark.parametrize("m", DOC["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_its_reader(m):
    mod = harness.module("metrics", m["name"])
    # a reader shared by several cells leaves MOVES to BENCHMARK.json
    assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER,
            getattr(mod, "MOVES", m["moves"])) == (
        m["unit"], m["better"], m["source"], m["layer"], m["moves"])
    for cell in m["workloads"]:
        assert cell in E2E[m["moves"]].get("workloads", [cell])
