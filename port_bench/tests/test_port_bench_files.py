"""Every cell of BENCHMARK.json resolves to its files, the file keeps to the
benchmark's contract, and a cell defined by files in another directory
runs without an edit to the benchmark's own files."""
import json
import os
import re

import pytest

from port_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_every_cell_resolves_to_its_files(bench):
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        assert cell.rate in {m["name"]
                                            for m in cell.end_to_end()}
        for attr in ("setup", "unit", "drain", "release", "check",
                     "flops_per_unit"):
            assert callable(getattr(cell.kind(), attr))
        assert callable(cell.reference().param_shapes)
        assert callable(cell.counts().train_flops)
        assert cell.limits(), f"{w['name']} has no limits"
        layer = cell.per_layer()
        assert layer, f"{w['name']} reports no per-layer metric"
        for m in layer:
            assert callable(cell.metric(m["name"]).read)


def test_benchmark_json_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["port_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("port_bench/")
        with open(os.path.join(harness.HERE, "..", c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(bench["workloads"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("name", ["densenet121-512.extract.b64",
                                  "densenet121-512.train.b64",
                                  "r21d34-8x224.train.b64"])
def test_a_cell_from_files_elsewhere_runs(small_cells, name):
    cell = small_cells(name, "float64" if "train" in name else None)
    assert cell.roots[0] != harness.HERE
    result, checks = harness.run_cell(cell, 2 ** 31 + 77, 0.2, trace=False,
                                      device="cpu")
    assert result["correct"], checks
    assert result["attempted"] >= 1
    assert cell.rate in result["metrics"]
