"""BENCHMARK.json against the benchmark's contract: its keys, names,
units, the files it names, and that every name finds its file."""

import json
import os
import re

import pytest

from pngbench import manifest
from pngbench.tests.conftest import ROOT

TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_size(bench):
    assert set(bench) == TOP
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_and_paths(bench):
    assert 1 <= len(bench["command"]) <= 32
    assert all(LINE.match(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])


def test_run_seconds_fits_the_check(bench):
    s = bench["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def _names(bench):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            yield group, e["name"]


def test_names_units_and_lines(bench):
    seen = {}
    for group, name in _names(bench):
        assert manifest.NAME.match(name), name
        kind = "metric" if group in ("end_to_end", "per_layer") else group
        assert (kind, name) not in seen, name
        seen[(kind, name)] = True
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for e in bench["configs"] + bench["workloads"]:
        assert LINE.match(e["why"])
    for w in bench["workloads"]:
        assert manifest.NAME.match(w["config"])
        assert manifest.NAME.match(w["traffic"])
    for m in bench["per_layer"]:
        assert LINE.match(m["layer"])


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and LINE.match(c["source"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_cells_and_counts(bench):
    assert 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


@pytest.mark.parametrize("workload", [
    "tile_rgb.decode", "frame4k_rgb.decode", "tile_rgba.decode",
    "tile_rgb.encode"])
def test_every_cell_finds_its_files_and_reports(bench, workload):
    cell = manifest.cell(bench, workload)
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert callable(manifest.reader(m["name"]))
    assert callable(manifest.plugin("ops", cell["traffic"]["op"]).Op)
    assert callable(manifest.plugin("content",
                                    cell["config"]["content"]).units)


def test_an_unknown_plugin_is_refused():
    with pytest.raises(SystemExit):
        manifest.plugin("ops", "no_such_op")
    with pytest.raises(SystemExit):
        manifest.plugin("content", "../run")


def test_files_lie_under_paths(bench):
    paths = bench["paths"]
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p + "/") for p in paths)
        with open(os.path.join(ROOT, f)) as fh:
            json.load(fh)
    for m in bench["per_layer"]:
        e2e = {e["name"] for e in bench["end_to_end"]}
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in bench["workloads"]}


def test_file_names_are_names():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "pngbench")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            assert manifest.NAME.match(f), f
