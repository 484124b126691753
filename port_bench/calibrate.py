"""Readings from which a cell's limits are set, in one process: the numbers
that decide ``correct`` for sound runs of the program on many seeds, for
the control (the reference in a lower precision put in the program's
place) and for each fault of ``faults.py`` planted in the program.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault half_batch --fault-seeds 4,5,6] \
        [--seconds 2]

Each run has a short window at the cell's own sizes and load, enough for
the check's batches. One JSON line a reading goes to standard output. The
benchmark's own runs never run this.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache",
                                                  "torch_extensions")


def ints(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def reading(cell, seed: int, seconds: float, control=None, device=None):
    """(program numbers, control numbers or None) of one seed."""
    import torch

    from port_bench import harness

    device = torch.device(device or "cuda")
    kind = cell.kind()
    run = harness.Run(cell, seed, device)
    kind.setup(run)
    harness.measure(run, kind, seconds)
    kind.release(run)
    harness.free_device(run)
    numbers = kind.check(run)
    ctl = kind.check(run, control) if control else None
    run.state.clear()
    harness.free_device(run)
    return numbers, ctl


def main(argv=None) -> int:
    import argparse
    import contextlib
    import json

    from port_bench import faults, harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=ints, default=[])
    p.add_argument("--control-seeds", type=ints, default=[])
    p.add_argument("--control", default="fp8")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--fault-seeds", type=ints, default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(argv)
    bench = harness.read_json(os.path.join(os.path.dirname(HERE),
                                           "BENCHMARK.json"))
    cell = harness.find_cell(bench, a.workload)
    print(json.dumps({"card": harness.power_limit()}), flush=True)
    kind_name = cell.traffic["kind"]
    jobs = [(s, None) for s in a.seeds]
    jobs += [(s, f) for f in a.fault for s in a.fault_seeds]
    for seed, fault in jobs:
        tic = time.perf_counter()
        planted = faults.planted(kind_name, fault) if fault \
            else contextlib.nullcontext()
        control = a.control if fault is None and seed in a.control_seeds \
            else None
        with planted:
            numbers, ctl = reading(cell, seed, a.seconds, control)
        line = {"cell": cell.name, "seed": seed,
                "what": fault or "program", "numbers": numbers,
                "seconds": time.perf_counter() - tic}
        print(json.dumps(line), flush=True)
        if ctl is not None:
            print(json.dumps({"cell": cell.name, "seed": seed,
                              "what": f"control_{a.control}",
                              "numbers": ctl}), flush=True)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"loaded {loaded}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
