"""The result's last line carries the keys the driver reads, ``breakdown``
in a traced run, and the compared numbers last; a broken timed path, and
the lower-precision control in the program's place, come out not
correct."""
import json

import pytest

from port_bench import faults, harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(small_cells, trace):
    cell = small_cells("densenet121-512.extract.b64")
    result, checks = harness.run_cell(cell, 3, 0.2, trace=trace,
                                      device="cpu")
    line = json.loads(harness.report(result, checks))
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    names = {m["name"] for m in (cell.per_layer() if trace
                                 else cell.end_to_end())}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names


FAULT_CASES = [("densenet121-512.train.b64", "float64", f)
               for f in faults.FAULTS["train"]] + \
    [("densenet121-512.extract.b64", None, f)
     for f in faults.FAULTS["extract"]]


@pytest.mark.parametrize("name,dtype,fault", FAULT_CASES)
def test_a_broken_timed_path_is_not_correct(small_cells, name, dtype,
                                            fault):
    cell = small_cells(name, dtype)
    with faults.planted(cell.traffic["kind"], fault):
        result, checks = harness.run_cell(cell, 11, 0.2, trace=False,
                                          device="cpu")
    assert not result["correct"], checks


@pytest.mark.parametrize("name,dtype", [
    ("densenet121-512.train.b64", "float64"),
    ("densenet121-512.extract.b64", None)])
def test_sound_runs_pass_and_the_control_fails(small_cells, name, dtype):
    import torch
    cell = small_cells(name, dtype)
    kind = cell.kind()
    run = harness.Run(cell, 12, torch.device("cpu"))
    kind.setup(run)
    harness.measure(run, kind, 0.2)
    kind.release(run)
    ok, checks = harness.judge(kind.check(run), cell.limits())
    assert ok, checks
    ok, checks = harness.judge(kind.check(run, "fp8"), cell.limits())
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["densenet121-512.extract.b64",
                                  "densenet121-512.train.b64",
                                  "r21d34-8x224.train.b64"])
def test_a_cell_runs_correct_on_the_card(bench, name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.find_cell(bench, name)
    result, checks = harness.run_cell(cell, 2 ** 31 + 1, 2.0, trace=True)
    assert result["correct"], checks
    assert result["device"]["busy_s"] > 0
