"""Tests of the benchmark's harness on the CPU, at small sizes. Run from the
root of the checkout: ``python -m pytest port_bench/tests -q``. Tests
that need the card are marked ``cuda`` and skip here."""
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture(scope="session")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


SMALL = {"densenet121-512": {"data_shape": 64},
         "r21d34-8x224": {"data_shape": 32}}
SMALL_TRAFFIC = {"extract": {"batch": 4, "pool": 12, "warmup_batches": 1,
                             "traced_units": 2, "checked_batches": 2},
                 "train": {"batch": 4, "pool": 12, "warmup_steps": 3,
                           "traced_units": 1}}


@pytest.fixture
def small_cells(tmp_path, bench):
    """``make(cell, dtype=None) -> Cell``: a cell of BENCHMARK.json cut to
    a CPU size, defined by files in a temporary directory only (its
    configuration, traffic and limits; a train cell may state float64,
    where the small step is not chaotic)."""
    import torch

    from port_bench import harness

    torch.set_num_threads(4)

    def make(name, dtype=None):
        real = harness.find_cell(bench, name)
        cfg = dict(real.config, **SMALL[real.entry["config"]])
        if dtype:
            cfg["dtype"] = dtype
        traffic = dict(real.traffic, **SMALL_TRAFFIC[real.traffic["kind"]])
        small = f"small.{name}"
        for folder, fname, data in (
                ("configs", small, cfg), ("traffic", small, traffic),
                ("limits", small, {"limits": real.limits()})):
            os.makedirs(tmp_path / folder, exist_ok=True)
            with open(tmp_path / folder / f"{fname}.json", "w") as f:
                json.dump(data, f)
        b = dict(bench, workloads=[{"name": small, "config": small,
                                    "traffic": small,
                                    "chips": real.chips,
                                    "why": "a CPU-sized copy"}])
        e2e = real.rate
        for key in ("end_to_end", "per_layer"):
            b[key] = [dict(m, workloads=[small])
                      if name in m.get("workloads", [name])
                      or e2e in (m["name"], m.get("moves")) else m
                      for m in bench[key]]
        return harness.find_cell(b, small, roots=(str(tmp_path),))

    return make
