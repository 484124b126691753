"""Time one phase of ``chip_smoke.py`` on two checkouts in alternation, on
one card, through the same harness.

    python3 tools/phase_ab.py --trees .scratch/parent . --order ABBA \
        --phase extract_phase --reps 2

Each letter of ``--order`` is one process started for that tree (A the
first of ``--trees``, B the second): it imports the ``tennis_torch``
package of the tree, loads this checkout's ``chip_smoke.py`` as the
harness, builds the tree's kernels (``build_phase``), makes the phase's
inputs (``extraction_inputs``: the phase takes ``(device, model, frames)``,
as ``extract_phase`` and ``evaluate_phase`` do) and runs the phase
``--reps`` times. Every JSON line the phase logs is kept, tagged with the
tree and the process, in ``chiprun_out/phase_ab.jsonl``; the last line
printed is the phase's frames/s per tree. Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELD = "frames_per_s"  # the rate extract_phase and evaluate_phase log

RUN = r"""
import importlib.util, sys
import torch
tree, harness, phase, reps = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("chip_smoke", harness)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import tennis_torch
assert tennis_torch.__file__.startswith(tree), tennis_torch.__file__
cs.build_phase()
dev = torch.device("cuda")
model, frames = cs.extraction_inputs(dev)
for _ in range(reps):
    getattr(cs, phase)(dev, model, frames)
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--trees", nargs=2, required=True,
                   help="the two checkouts, A and B")
    p.add_argument("--order", default="ABBA")
    p.add_argument("--phase", default="extract_phase")
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args(argv)
    trees = {k: os.path.abspath(t) for k, t in zip("AB", args.trees)}
    harness = os.path.join(HERE, "chip_smoke.py")
    out_path = os.path.join(HERE, "chiprun_out", "phase_ab.jsonl")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    summary = {k: [] for k in trees}
    with open(out_path, "a") as out:
        for run, key in enumerate(args.order):
            proc = subprocess.run(
                [sys.executable, "-c", RUN, trees[key], harness, args.phase,
                 str(args.reps)], cwd=trees[key], capture_output=True,
                text=True, timeout=1200)
            if proc.returncode:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                raise SystemExit(f"run {run} ({key}) exited "
                                 f"{proc.returncode}")
            for line in proc.stdout.splitlines():
                if not line.startswith("[") or "] {" not in line:
                    continue
                tag, body = line.split("] ", 1)
                fields = json.loads(body)
                out.write(json.dumps({"tree": key, "path": args.trees[
                    "AB".index(key)], "run": run, "phase": tag[1:],
                    **fields}) + "\n")
                if tag[1:] == args.phase.removesuffix("_phase") \
                        and FIELD in fields:
                    summary[key].append(fields[FIELD])
                    print(f"run {run} {key} {FIELD} {fields[FIELD]}",
                          flush=True)
    print(json.dumps({"phase": args.phase, "field": FIELD,
                      "order": args.order, "reps": args.reps,
                      "trees": {k: args.trees["AB".index(k)] for k in trees},
                      "values": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
