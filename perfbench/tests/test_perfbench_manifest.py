"""The manifest and the files it names: allowed characters and lengths,
and every cell, configuration, request kind and metric found by name."""

import glob
import json
import os
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_plain(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics():
    allowed = {"name", "unit", "better", "source", "bound", "layer", "moves",
               "workloads"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m) <= allowed
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m for m in harness.metrics_of(BENCH, w["name"], False)]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.metrics_of(BENCH, w["name"], True)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_are_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and _line(w["why"])
    assert NAME.match(w["traffic"])
    cell, cfg = harness.cell_files(w["name"])
    assert cell["config"] == w["config"] == cfg["name"]
    assert cell["chips"] == w["chips"]
    assert cell["why"] == w["why"]
    assert set(cell["limits"]) and harness.request_kind(cell["kind"])
    assert os.path.exists(os.path.join(harness.ROOT, cfg["inputs"]))


def test_few_cells_take_four_cards():
    cells = BENCH["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_are_found_by_name(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"] == "perfbench/configs/%s.json" % c["name"]
    cfg = harness.load_json(harness.ROOT, c["file"])
    assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
    assert all(NAME.match(k) for k in c["reduced"])
    assert isinstance(cfg["assumed"], list)
    assert all(_line(a) for a in cfg["assumed"])
    assert cfg["source"] == c["source"] and _line(c["why"])


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    harness.HERE, "metrics", "*.py"))), ids=os.path.basename)
def test_every_metric_file_is_a_reader(path):
    name = os.path.basename(path)[:-3]
    read = harness.metric_reader(name)
    assert callable(read)
    assert name in {m["name"] for m in BENCH["end_to_end"]
                    + BENCH["per_layer"]}


def test_new_files_need_no_edit(tmp_path, monkeypatch):
    """A metric, cell and configuration added as files are found."""
    for d in ("metrics", "workloads", "configs"):
        (tmp_path / d).mkdir()
    (tmp_path / "metrics" / "new.metric.py").write_text(
        "def read(run):\n    return 1.5\n")
    (tmp_path / "configs" / "c2.json").write_text(json.dumps({"name": "c2"}))
    (tmp_path / "workloads" / "c2.kind.json").write_text(json.dumps(
        {"config": "c2", "kind": "estimate"}))
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    assert harness.metric_reader("new.metric")({}) == 1.5
    cell, cfg = harness.cell_files("c2.kind")
    assert cfg["name"] == "c2" and cell["kind"] == "estimate"
