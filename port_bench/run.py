"""One run of one cell of the benchmark of tennis_torch on the card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; ``harness.py`` says where its files are. The last line
of standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``), with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared, with its limit. Without a CUDA device, or with the JAX
stack loaded at the end, it exits with another code than 0 and prints no
result.

The program's build caches stay in fixed directories of the checkout:
``tennis_torch/build/`` for its nvcc builds, and ``port_bench/.cache/``
for Triton's and PyTorch's extension caches.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
sys.path.insert(0, ROOT)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    from port_bench import harness

    a = parse_args()
    sys.exit(harness.main(a.workload, a.seed, a.seconds, bool(a.trace), T0))
