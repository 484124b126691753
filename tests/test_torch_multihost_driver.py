"""The drivers across processes on the CPU (gloo), on the synthetic fixture
with flow frames.

- ``python -m tennis_torch.train --multihost --coordinator 127.0.0.1:<port>
  --num_hosts 2 --host_id {0,1} --device cpu``, two processes, one epoch of
  ``resnet18_v2`` at ``--data_shape 32``, against the same flags in one
  process: rank 0's epoch file and ``scores.txt`` (only rank 0 writes the
  experiment). The model is the 6-channel ``--flow sixc`` one, whose train
  split takes the test geometry: the random crop draws from each host's own
  generators (in the JAX package too), so frames would differ. Both train
  runs compute in f32 (``build_model(dtype=)``, set by the test around the
  driver's own ``main``): in the driver's bf16 this step is chaotic (two
  hosts lie 0.33 from one process in the measure below), and faults in the
  driver's wiring lie within that. The two runs' parameters and running
  statistics are held within ``F32_STEP_TOL`` of their update (relative L2
  of their difference over the update; 1.2e-5 and 9e-7 measured), the
  step counts exactly and the score to 1e-4. A host reading the other's
  stripe, gradients not averaged, BN statistics per rank or each rank
  taking the global batch lie 0.06 to 3.1 off in f32;
- ``evaluate --multihost --metrics_out`` on the single-process epoch,
  against ``evaluate``: the same PRF1 dict;
- ``train --save_feats --multihost`` on that epoch: the two ranks' files
  together are the single-process dump, every file once, each feature
  within ``FEAT_TOL`` of the largest magnitude (each rank runs 4-row
  batches).

``tests/test_torch_ddp_captioner.py`` runs the captioning drivers on two
ranks.
"""
import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from fixtures import build_fixture
from tennis_torch import evaluate, train
from tennis_torch.bridge import to_flax
from tennis_torch.parallel.distributed import free_port
from tennis_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--model_id=m", "--backbone=resnet18_v2", "--flow=sixc",
          "--data_shape=32", "--batch_size=8", "--every=1,8,8",
          "--max_batches=2", "--epochs=1", "--num_workers=2",
          "--log_interval=1", "--device=cpu"]
F32_STEP_TOL, FEAT_TOL = 1e-4, 1e-2
# ``python -m tennis_torch.train`` computing in f32
F32_TRAIN = ["-c", "import functools, sys, torch; from tennis_torch import "
             "train; train.build_model = functools.partial(train.build_model, "
             "dtype=torch.float32); train.main(sys.argv[1:])"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _exp(workdir, kind="vision"):
    return os.path.join(workdir, "models", kind, "experiments", "m")


def _start_hosts(entry, argv, cwd):
    """Two host processes of ``python <entry> --multihost ...``."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, *entry, "--multihost",
         f"--coordinator=127.0.0.1:{port}", "--num_hosts=2",
         f"--host_id={h}", *argv], cwd=cwd, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for h in (0, 1)]


def _wait(procs):
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out.decode()[-3000:]


def _features(root):
    base = os.path.join(root, "features", "m")
    out = {}
    for d, _, files in os.walk(base):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), base)] = \
                np.load(os.path.join(d, f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process train (in f32), evaluate and feature dump; then,
    all at once, the two-host train (in f32, its own experiment), and the
    two-host evaluate and feature dump of a copy of the single-process
    epoch."""
    root = build_fixture(tmp_path_factory.mktemp("ds"), with_flow=True)
    single, hosts, copy = (str(tmp_path_factory.mktemp(n))
                           for n in ("single", "hosts", "copy"))
    argv = COMMON + [f"--root={root}"]
    old = os.getcwd()
    os.chdir(single)
    try:
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(train, "build_model", functools.partial(
                train.build_model, dtype=torch.float32))
            train.main(argv)
        shutil.copytree(os.path.join(single, "models"),
                        os.path.join(copy, "models"))
        evaluate.main(argv + [f"--metrics_out={single}/m.json"])
        train.main(argv + ["--save_feats"])
    finally:
        os.chdir(old)
    want_feats = _features(root)
    shutil.rmtree(os.path.join(root, "features", "m"))
    procs = (_start_hosts(F32_TRAIN, argv, hosts)
             + _start_hosts(["-m", "tennis_torch.evaluate"],
                            argv + [f"--metrics_out={copy}/m.json"], copy)
             + _start_hosts(["-m", "tennis_torch.train"],
                            argv + ["--save_feats"], copy))
    _wait(procs)
    return dict(root=root, single=single, hosts=hosts, copy=copy,
                want_feats=want_feats)


def test_rank0_writes_the_single_process_epoch(runs):
    single, hosts = _exp(runs["single"]), _exp(runs["hosts"])
    assert sorted(os.listdir(hosts)) == sorted(os.listdir(single))
    rows = [open(os.path.join(d, "scores.txt")).read().split()
            for d in (single, hosts)]
    assert rows[0][0] == rows[1][0] == "0"
    assert float(rows[1][1]) == pytest.approx(float(rows[0][1]), abs=1e-4)
    want = ckpt.load_raw(ckpt.epoch_path(single, 0))
    got = ckpt.load_raw(ckpt.epoch_path(hosts, 0))

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    want, got = dict(leaves(want)), dict(leaves(got))
    assert set(got) == set(want) and int(got["step"]) == 2
    init = dict(leaves(to_flax(train.build_model(
        train.parse_args(COMMON), 11))))
    gaps = {"params": [0.0, 0.0], "batch_stats": [0.0, 0.0]}
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        col = k.split("/")[0]
        if col in gaps:
            gaps[col][0] += ((g.astype(np.float64) - w) ** 2).sum()
            gaps[col][1] += ((w.astype(np.float64) - init[k]) ** 2).sum()
        elif "count" in k or k == "step":
            assert g == w, k
    for col, (num, den) in gaps.items():
        assert np.sqrt(num / den) <= F32_STEP_TOL, (col, np.sqrt(num / den))


def test_evaluate_multihost_writes_the_single_process_metrics(runs):
    want = json.load(open(os.path.join(runs["single"], "m.json")))
    assert json.load(open(os.path.join(runs["copy"], "m.json"))) == want


def test_each_rank_dumps_its_rows(runs):
    want, got = runs["want_feats"], _features(runs["root"])
    assert sorted(got) == sorted(want) and len(want) > 100
    for rel, w in want.items():
        assert got[rel].shape == w.shape and got[rel].dtype == np.float32
        assert np.abs(got[rel] - w).max() <= FEAT_TOL * np.abs(w).max(), rel
