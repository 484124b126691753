"""The captioner slice as a whole, on the synthetic fixture with a 32-d
numpy feature store: ``python -m tennis_torch.train_gnmt`` trains the
features-path captioner for an epoch on the CPU; the JAX package's
``evaluate_gnmt --force`` reads the port's ``valid_best.params`` and writes
the port's ``best_test_out.txt`` again, and the port's ``evaluate_gnmt
--metrics_out`` gives the JAX suite; a run that goes JAX, port, JAX over one
experiment resumes each package's epoch file in the other, Adam's moments and
the learning rate included; and a resume inside the decay zone keeps
compounding from the saved rate, as
``tests/test_drivers_smoke.py::test_train_gnmt_resume_keeps_decay_chain``
holds for the JAX package."""
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from fixtures import VIDEO_EVENTS, build_fixture
from tennis_torch import evaluate_gnmt, train_gnmt
from tennis_torch.bridge import from_flax
from tennis_torch.utils import checkpoint as ckpt
from tennis_torch.utils import msgpack_codec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--feats_model=tf", "--num_hidden=16", "--emb_size=8",
         "--num_buckets=2", "--tgt_max_len=10", "--emb_file=",
         "--test_batch_size=4"]
TRAIN = SMALL + ["--batch_size=4", "--log_interval=10", "--num_workers=2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_feature_store(root, name, dim=32):
    """A seeded .npy feature for every on-disk fixture frame."""
    from tennis_torch.data.tennis_set import get_feature_path

    rng = np.random.default_rng(0)
    for video, events in VIDEO_EVENTS.items():
        for frame in range(events[-1][1]):
            path = get_feature_path(os.path.join(root, "features", name),
                                    video, frame)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, rng.normal(size=(dim,)).astype(np.float32))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The fixture dataset with its feature store, and a working directory
    (experiment directories are relative to it)."""
    root = build_fixture(tmp_path_factory.mktemp("ds"))
    make_feature_store(root, "tf")
    workdir = str(tmp_path_factory.mktemp("work"))
    old = os.getcwd()
    os.chdir(workdir)
    yield root, workdir
    os.chdir(old)


def _exp(workdir, model_id):
    return os.path.join(workdir, "models", "captioning", "experiments",
                        model_id)


def _jax_train(argv):
    from tennis_tpu.train_gnmt import main

    return main(["train_gnmt.py"] + argv)


def _jax_evaluate(argv):
    from tennis_tpu.evaluate_gnmt import main
    from tennis_tpu.train_gnmt import FLAGS

    FLAGS.unparse_flags()
    return main(["evaluate_gnmt.py"] + argv)


def _log_since(path, start):
    with open(path) as f:
        return f.read()[start:]


def _size(path):
    return os.path.getsize(path) if os.path.exists(path) else 0


@pytest.fixture(scope="module")
def trained(env):
    """The port's CLI, one epoch on the CPU, in a subprocess."""
    root, workdir = env
    out = subprocess.run(
        [sys.executable, "-m", "tennis_torch.train_gnmt", f"--root={root}",
         "--model_id=p1", "--epochs=1", "--device=cpu", *TRAIN],
        cwd=workdir, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return _exp(workdir, "p1"), out.stderr


def test_one_epoch_writes_the_jax_drivers_files(trained):
    exp, log = trained
    assert sorted(f for f in os.listdir(exp) if f != "tb") == [
        "0000.params", "best_test_out.txt", "epoch0_test_out.txt",
        "epoch0_val_out.txt", "log.txt", "scores.txt", "test_gt.txt",
        "val_gt.txt", "valid_best.params"]
    for line in ("vocab size", "[Epoch 0][Batch 1] loss=", "[Epoch 0] val "
                 "loss=", "lr decayed to 0.0005", "new best BLEU4"):
        assert line in log, line
    rows = open(os.path.join(exp, "scores.txt")).read().split()
    assert rows[0] == "0" and 0.0 <= float(rows[1]) <= 100.0
    tree = ckpt.load_raw(os.path.join(exp, "valid_best.params"))
    assert list(tree) == ["batch_stats", "params"]
    assert open(os.path.join(exp, "best_test_out.txt")).read() == \
        open(os.path.join(exp, "epoch0_test_out.txt")).read()
    epoch = ckpt.load_raw(os.path.join(exp, "0000.params"))
    assert float(epoch["opt_state"]["hyperparams"]["learning_rate"]) == \
        np.float32(0.0005)


def test_jax_evaluate_reads_the_ports_checkpoint(env, trained):
    """The JAX evaluator decodes the port's ``valid_best.params`` to the
    port's own ``best_test_out.txt``, and the port's evaluator scores it as
    the JAX suite does, its ``--metrics_out`` included."""
    root, workdir = env
    exp, _ = trained
    path = os.path.join(exp, "best_test_out.txt")
    port_hyps = open(path).read()
    want = _jax_evaluate([f"--root={root}", "--model_id=p1", "--force",
                          *SMALL])
    assert open(path).read() == port_hyps
    metrics = os.path.join(workdir, "m.json")
    got = evaluate_gnmt.main([f"--root={root}", "--model_id=p1", "--force",
                              "--device=cpu", f"--metrics_out={metrics}",
                              *SMALL])
    assert open(path).read() == port_hyps
    assert got == want
    dumped = json.load(open(metrics))
    assert dumped == pytest.approx(want)
    for k, v in dumped.items():
        assert 0.0 <= v <= (10.0 if k == "CIDEr" else 1.0), (k, v)
    # without --force the cached hypotheses are scored
    assert evaluate_gnmt.main([f"--root={root}", "--model_id=p1",
                               "--device=cpu", *SMALL]) == want


def test_each_package_resumes_the_others_epochs(env):
    """JAX trains epoch 0, the port resumes it and trains epoch 1, JAX
    resumes that and trains epoch 2. Each resume restores the saved
    learning rate and decays once from it; the port's state loaded from the
    JAX file writes it again byte for byte, Adam's moments included. At
    dropout 0 the port's epoch 1 is the JAX package's own epoch 1 from the
    same file: the same batches, losses and Adam steps, so the parameters
    and moments agree within 1e-4 in relative L2 and the epoch's decodes
    are the same."""
    from tennis_torch.bridge import state_from_flax, state_to_flax
    from tennis_torch.parallel.train_step import adam_with_clip, \
        create_seq2seq_state

    root, workdir = env
    argv = [f"--root={root}", "--model_id=x1", "--lr=0.01", "--dropout=0",
            *TRAIN]
    exp = _exp(workdir, "x1")
    _jax_train(argv + ["--epochs=1"])  # decays at epoch 0: 0.005 saved
    jax_file = ckpt.load_raw(ckpt.epoch_path(exp, 0))
    # the JAX package's own epoch 1 from the same file, in a copy
    os.makedirs(_exp(workdir, "x1j"))
    shutil.copy(ckpt.epoch_path(exp, 0), ckpt.epoch_path(_exp(workdir, "x1j"),
                                                         0))
    _jax_train([a.replace("x1", "x1j") for a in argv] + ["--epochs=2"])
    assert int(jax_file["opt_state"]["inner_state"]["1"]["0"]["count"]) > 0

    args = train_gnmt.parse_args(argv + ["--epochs=1", "--device=cpu"])
    data = train_gnmt.make_datasets(args)
    model = train_gnmt.build_model(args, len(data[0].vocab),
                                   train_gnmt.feature_dim(data[0]))
    state = create_seq2seq_state(model, adam_with_clip(5.0), 0.01)
    state_from_flax(state, jax_file)
    assert state.opt_state.learning_rate == float(np.float32(0.005))
    with open(ckpt.epoch_path(exp, 0), "rb") as f:
        assert msgpack_codec.serialize(state_to_flax(state)) == f.read()

    start = _size(os.path.join(exp, "log.txt"))
    train_gnmt.main(argv + ["--epochs=2", "--device=cpu"])
    log = _log_since(os.path.join(exp, "log.txt"), start)
    assert "resumed from epoch 0 (lr 0.005)" in log
    assert "[Epoch 0]" not in log and "[Epoch 1][Batch 1]" in log
    assert "lr decayed to 0.0025" in log
    port_file = ckpt.load_raw(ckpt.epoch_path(exp, 1))
    assert float(port_file["opt_state"]["hyperparams"]["learning_rate"]) == \
        np.float32(0.0025)
    # the moments went on from the JAX file's
    assert int(port_file["opt_state"]["inner_state"]["1"]["0"]["count"]) > \
        int(jax_file["opt_state"]["inner_state"]["1"]["0"]["count"])
    jax_epoch1 = ckpt.load_raw(ckpt.epoch_path(_exp(workdir, "x1j"), 1))
    for key in ("params", "mu", "nu"):
        got, want = (from_flax({"params": t["params"] if key == "params" else
                                t["opt_state"]["inner_state"]["1"]["0"][key]})
                     for t in (port_file, jax_epoch1))
        assert set(got) == set(want)
        num = sum(((got[k] - want[k]) ** 2).sum() for k in want)
        den = sum((want[k] ** 2).sum() for k in want)
        assert (num / den).sqrt().item() <= 1e-4, key
    for name in ("epoch1_val_out.txt", "epoch1_test_out.txt"):
        with open(os.path.join(exp, name)) as a, \
                open(os.path.join(_exp(workdir, "x1j"), name)) as b:
            assert a.read() == b.read(), name

    start = _size(os.path.join(exp, "log.txt"))
    _jax_train(argv + ["--epochs=3"])
    log = _log_since(os.path.join(exp, "log.txt"), start)
    assert "resumed from epoch 1 (lr 0.0025)" in log
    assert "lr decayed to 0.00125" in log
    assert ckpt.latest_epoch(exp) == 2


def test_resume_keeps_decay_chain(env):
    """A resume inside the decay zone keeps compounding from the restored
    rate: decays at epochs 1, 2 and 3 of 4; after a crash past epoch 1 the
    rerun logs 0.0025 and 0.00125 (a chain restarted from --lr would log
    0.005 first)."""
    root, workdir = env
    args = [f"--root={root}", "--model_id=pres", "--epochs=4", "--lr=0.01",
            "--lr_update_factor=0.5", "--max_batches=1", "--device=cpu",
            *SMALL, "--batch_size=4", "--log_interval=10", "--num_buckets=1"]
    train_gnmt.main(args)
    exp = _exp(workdir, "pres")
    os.remove(os.path.join(exp, "0002.params"))
    os.remove(os.path.join(exp, "0003.params"))
    os.remove(os.path.join(exp, "log.txt"))
    train_gnmt.main(args)
    log = open(os.path.join(exp, "log.txt")).read()
    assert "resumed from epoch 1" in log
    decays = [float(line.rsplit(" ", 1)[1]) for line in log.splitlines()
              if "lr decayed to" in line]
    assert len(decays) == 2, decays
    assert math.isclose(decays[0], 0.0025, rel_tol=1e-5), decays
    assert math.isclose(decays[1], 0.00125, rel_tol=1e-5), decays


def test_refusals(env):
    root, _ = env
    with pytest.raises(NotImplementedError, match="slice 10"):
        train_gnmt.main([f"--root={root}", "--device=cpu",
                         "--pretrained_npz=x.npz"])
    # --num_devices 2 trains data-parallel; a batch that does not divide
    # across the devices raises, as in the JAX trainer
    with pytest.raises(ValueError, match="must divide across 2 devices"):
        train_gnmt.main([f"--root={root}", "--device=cpu", "--feats_model=tf",
                         "--num_devices=2", "--batch_size=3"])
    with pytest.raises(ValueError, match="pixels path"):
        train_gnmt.main([f"--root={root}", "--device=cpu", "--feats_model=tf",
                         "--pretrained_npz=x.npz"])
    with pytest.raises(FileNotFoundError, match="train first"):
        evaluate_gnmt.main([f"--root={root}", "--model_id=none", "--force",
                            "--device=cpu", *SMALL])


def test_cli_flags_are_the_jax_evaluators(env):
    """The evaluator's command line: the trainer's flags, ``--device``,
    ``--force`` and ``--metrics_out``, with the JAX defaults."""
    from tennis_tpu import evaluate_gnmt as jax_eval  # noqa: F401 (flags)
    from tennis_tpu.train_gnmt import FLAGS

    port = vars(evaluate_gnmt.parse_args([]))
    names = {f.name for f in FLAGS.get_key_flags_for_module(
        sys.modules["tennis_tpu.train_gnmt"])} | {"force", "metrics_out"}
    assert set(port) == (names - {"num_gpus"}) | {"device"}
    for name in ("force", "metrics_out"):
        assert port[name] == FLAGS[name].default
    assert port["device"] == "cuda"
    assert evaluate_gnmt.parse_args(["--force"]).force is True
