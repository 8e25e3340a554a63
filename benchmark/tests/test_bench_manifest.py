"""BENCHMARK.json against the benchmark's contract, and every name it gives
found by the harness."""

import importlib.util
import json
import os
import re

import pytest

from benchmark.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
        text = f.read()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == TOP
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in bench["paths"])
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert all(not w.startswith("/") and ".." not in w.split("/") for w in cmd)
    assert cmd[1].startswith(tuple(p + "/" for p in bench["paths"]))
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits(bench):
    rs, cells = bench["run_seconds"], 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        body = manifest.config(c["name"])
        assert body["reduced"] == c["reduced"]
        assert manifest.roofline(c["name"]) is not None
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(names)


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    four = sum(1 for w in cells if w["chips"] == 4)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        cell = manifest.Cell(w["name"], bench)
        # the mix's kind and the configuration's model are found by name
        assert importlib.util.find_spec(f"benchmark.harness.kinds.{cell.traffic['kind']}")
        assert importlib.util.find_spec(f"benchmark.harness.adapters.{cell.config['model']}")
        assert os.path.isfile(os.path.join(manifest.BENCH_DIR, "limits", w["name"] + ".json"))


def test_metrics(bench):
    e2e, layer = bench["end_to_end"], bench["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(names) == len(set(names))
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in e2e)
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in layer:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in {e["name"] for e in e2e}
        assert manifest.metric_reader(m["name"]) is not None
        if m["name"].endswith("_roofline") or "mfu" in m["name"] or "roofline" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                 "higher")


def test_every_cell_reports_what_its_metrics_move(bench):
    """Each cell reports setup_s, another end-to-end metric and a per-layer
    one; each per-layer metric's cells report the metric it moves."""
    for w in bench["workloads"]:
        cell = manifest.Cell(w["name"], bench)
        mine = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in mine and len(mine) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in mine, (w["name"], m["name"])
    for m in bench["per_layer"]:
        for name in m["workloads"]:
            cell = manifest.Cell(name, bench)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_names_of_layers_agree(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    with open(os.path.join(manifest.ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in layers:
        assert f"| {layer} |" in perf, layer
