"""How far a two-host run of the classifier trainer lands from one process.

    python tools/driver_gap.py --repo . --dtype float32

Builds the synthetic fixture (``tests/fixtures.py``), trains one epoch of
``resnet18_v2 --flow sixc --data_shape 32`` (the flags of
``tests/test_torch_multihost_driver.py``) in this process and as two
``--multihost`` host processes over gloo on 127.0.0.1, both computing in
``--dtype``, and prints one JSON line: the relative L2 of the two epoch
files' difference over the update, for the parameters and for the running
statistics, and both ``scores.txt`` rows. ``--repo`` is the checkout whose
``tennis_torch`` runs (a copy with a planted fault, to see whether the
test would catch it). CPU only; a minute or so.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile

ARGV = ["--model_id=m", "--backbone=resnet18_v2", "--flow=sixc",
        "--data_shape=32", "--batch_size=8", "--every=1,8,8",
        "--max_batches=2", "--epochs=1", "--num_workers=2",
        "--log_interval=1", "--device=cpu"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--dtype", default="float32",
                   choices=["bfloat16", "float32", "float64"])
    args = p.parse_args(argv)
    repo = os.path.abspath(args.repo)
    sys.path[:0] = [repo, os.path.join(repo, "tests")]
    import numpy as np
    import torch

    from fixtures import build_fixture
    from tennis_torch import train
    from tennis_torch.bridge import to_flax
    from tennis_torch.parallel.distributed import free_port
    from tennis_torch.utils import checkpoint as ckpt

    torch.set_num_threads(1)
    entry = ("import functools, sys, torch; from tennis_torch import train; "
             "train.build_model = functools.partial(train.build_model, "
             f"dtype=torch.{args.dtype}); train.main(sys.argv[1:])")
    work = tempfile.mkdtemp()
    cwd = os.getcwd()
    try:
        root = build_fixture(os.path.join(work, "ds"), with_flow=True)
        single, hosts = (os.path.join(work, d) for d in ("single", "hosts"))
        os.makedirs(single)
        os.makedirs(hosts)
        flags = ARGV + [f"--root={root}"]
        port = free_port()
        env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-c", entry, "--multihost",
             f"--coordinator=127.0.0.1:{port}", "--num_hosts=2",
             f"--host_id={h}", *flags], cwd=hosts, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for h in (0, 1)]
        build = train.build_model
        train.build_model = functools.partial(build,
                                              dtype=getattr(torch, args.dtype))
        os.chdir(single)
        train.main(flags)
        for proc in procs:
            out, _ = proc.communicate(timeout=900)
            if proc.returncode:
                raise SystemExit(out.decode()[-3000:])

        def exp(d):
            return os.path.join(d, "models", "vision", "experiments", "m")

        def leaves(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from leaves(v, f"{prefix}{k}/")
                else:
                    yield f"{prefix}{k}", np.asarray(v)

        want = dict(leaves(ckpt.load_raw(ckpt.epoch_path(exp(single), 0))))
        got = dict(leaves(ckpt.load_raw(ckpt.epoch_path(exp(hosts), 0))))
        init = dict(leaves(to_flax(build(train.parse_args(ARGV), 11))))
        gaps = {"params": [0.0, 0.0], "batch_stats": [0.0, 0.0]}
        for k, w in want.items():
            col = k.split("/")[0]
            if col in gaps:
                gaps[col][0] += ((got[k].astype(np.float64) - w) ** 2).sum()
                gaps[col][1] += ((w.astype(np.float64) - init[k]) ** 2).sum()
        scores = [open(os.path.join(exp(d), "scores.txt")).read().split()
                  for d in (single, hosts)]
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"repo": repo, "dtype": args.dtype, "scores": scores,
                      **{c: float(np.sqrt(a / b))
                         for c, (a, b) in gaps.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
