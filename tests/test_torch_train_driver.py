"""The training slice as a whole, on the synthetic fixture: ``python -m
tennis_torch.train`` trains DenseNet121 at 32^2 for an epoch on the CPU;
the JAX package resumes the port's epoch file into its ``TrainState`` and
its ``evaluate`` scores the experiment as the port's ``evaluate`` does; the
port resumes a JAX-written epoch, momentum included, and goes on at epoch
1, after quarantining a truncated newer epoch to ``.corrupt``.

Tolerances: probabilities within 1e-2 absolute (both packages run
DenseNet121 in bf16, summing in other orders); the metric dicts equal where
every top-1 decision agrees."""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import build_fixture
from tennis_tpu import evaluate as jax_evaluate
from tennis_tpu.utils import checkpoint as jax_ckpt
from tennis_torch import evaluate, train
from tennis_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROB_TOL = 1e-2
COMMON = ["--backbone=DenseNet121", "--data_shape=32", "--batch_size=8",
          "--num_workers=2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _abstract_state(steps_per_epoch=1):
    from tennis_tpu.models import FrameModel, get_backbone
    from tennis_tpu.parallel import create_train_state, sgd_with_schedule

    model = FrameModel(get_backbone("densenet121", dtype=jnp.bfloat16),
                       num_classes=11, dtype=jnp.bfloat16)
    tx, _ = sgd_with_schedule(0.001, 0.9, 1e-4, [10, 20], 0.75,
                              steps_per_epoch)
    return jax.eval_shape(lambda: create_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32),
        tx, {"train": True}))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's one-epoch run, as its CLI runs it, in a fresh working
    directory."""
    workdir = tmp_path_factory.mktemp("work")
    root = build_fixture(tmp_path_factory.mktemp("ds"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "tennis_torch.train", f"--root={root}",
         "--model_id=t1", "--backbone=DenseNet121", "--data_shape=32",
         "--batch_size=8", "--epochs=1", "--device=cpu", "--num_workers=2"],
        cwd=workdir, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    exp = os.path.join(workdir, "models", "vision", "experiments", "t1")
    return dict(workdir=str(workdir), root=root, exp=exp, log=out.stderr)


def test_one_epoch_writes_its_files(trained):
    exp = trained["exp"]
    assert sorted(f for f in os.listdir(exp) if not f.startswith("tb")) == \
        ["0000.params", "log.txt", "scores.txt"]
    rows = open(os.path.join(exp, "scores.txt")).read().split()
    assert rows[0] == "0" and 0.0 <= float(rows[1]) <= 1.0
    log = trained["log"]
    for line in ("[Epoch 0][Batch 1] loss=", "[Epoch 0] val AVG_NB_f1=",
                 "loaded best epoch 0", "test AVG_NB_f1=", "confusion:"):
        assert line in log, line
    tree = ckpt.load_raw(os.path.join(exp, "0000.params"))
    assert list(tree) == ["step", "params", "batch_stats", "opt_state"]
    steps = int(tree["step"])
    assert steps >= 1 and int(tree["opt_state"]["1"]["1"]["count"]) == steps


def test_jax_resumes_the_port_epoch(trained):
    """``tennis_tpu.utils.checkpoint.resume_state`` restores the port's
    file into a JAX TrainState: epoch 1 next, every leaf as written."""
    abstract = _abstract_state()
    target = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                    abstract)
    start, state = jax_ckpt.resume_state(trained["exp"], target)
    assert start == 1
    raw = ckpt.load_raw(os.path.join(trained["exp"], "0000.params"))
    assert int(state.step) == int(raw["step"])
    got = jax.tree_util.tree_leaves((state.params, state.batch_stats,
                                     state.opt_state))
    want = jax.tree_util.tree_leaves((raw["params"], raw["batch_stats"],
                                      raw["opt_state"]))
    assert len(got) == len(want) > 3 * 120
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_both_evaluators_score_the_port_experiment_alike(trained,
                                                         monkeypatch):
    from test_torch_extract import run_jax

    monkeypatch.chdir(trained["workdir"])
    paths = {k: os.path.join(trained["workdir"], f"metrics_{k}.json")
             for k in ("jax", "port")}
    args = [f"--root={trained['root']}", "--model_id=t1", *COMMON]
    res_w, _, _ = run_jax(jax_evaluate.evaluate_model,
                          [*args, f"--metrics_out={paths['jax']}"])
    res_g, _, m_g = evaluate.main([*args, "--device=cpu",
                                   f"--metrics_out={paths['port']}"])
    assert set(res_g) == set(res_w) and len(res_g) == 20
    top1 = True
    for key, p in res_w.items():
        np.testing.assert_allclose(res_g[key], p, atol=PROB_TOL, err_msg=key)
        top1 &= int(np.argmax(res_g[key])) == int(np.argmax(p))
    dumped = {k: json.load(open(p)) for k, p in paths.items()}
    assert dumped["port"] == m_g["prf1"].get_dict()
    assert top1
    assert dumped["port"] == dumped["jax"]


def _jax_epoch(exp, steps_per_epoch, momentum_scale, seed=3):
    """Epoch 0 of a JAX TrainState with seeded weights and momentum (times
    ``momentum_scale``) at step ``steps_per_epoch``, written by the JAX
    package."""
    abstract = _abstract_state(steps_per_epoch)
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if a.dtype != np.float32:
            return np.asarray(steps_per_epoch, a.dtype)
        name = str(getattr(path[-1], "key", ""))
        if path[0].name == "opt_state":
            return (rng.standard_normal(a.shape) * 0.01
                    * momentum_scale).astype(np.float32)
        if name == "kernel":
            return (rng.standard_normal(a.shape)
                    / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)

    state = jax.tree_util.tree_map_with_path(draw, abstract)
    os.makedirs(exp, exist_ok=True)
    jax_ckpt.save_state(jax_ckpt.epoch_path(exp, 0), state)
    jax_ckpt.append_score(exp, 0, 0.25)


def test_port_resumes_a_jax_epoch_with_its_momentum(trained, tmp_path,
                                                    monkeypatch):
    """Epoch 0 written by the JAX package and a truncated epoch 1: the port
    renames 0001.params to .corrupt, resumes epoch 0 (step, update count and
    momentum) and trains epoch 1. The same run from the same epoch with
    the momentum zeroed ends elsewhere: the momentum was carried."""
    monkeypatch.chdir(tmp_path)
    steps = len(train.make_datasets(train.parse_args(
        [f"--root={trained['root']}", *COMMON]))[0]) // 8
    ends = {}
    for model_id, scale in (("t2", 1.0), ("t3", 0.0)):
        exp = os.path.join(str(tmp_path), "models", "vision", "experiments",
                           model_id)
        _jax_epoch(exp, steps, scale)
        first = open(jax_ckpt.epoch_path(exp, 0), "rb").read()
        with open(jax_ckpt.epoch_path(exp, 1), "wb") as f:
            f.write(first[:len(first) // 3])
        train.main([f"--root={trained['root']}", *COMMON,
                    f"--model_id={model_id}", "--epochs=2", "--device=cpu",
                    "--num_workers=1"])
        assert os.path.exists(os.path.join(exp, "0001.params.corrupt"))
        assert open(jax_ckpt.epoch_path(exp, 0), "rb").read() == first
        log = open(os.path.join(exp, "log.txt")).read()
        assert "resumed from epoch 0" in log and "[Epoch 0]" not in log
        assert [r.split()[0] for r in open(os.path.join(
            exp, "scores.txt"))] == ["0", "1"]
        tree = ckpt.load_raw(jax_ckpt.epoch_path(exp, 1))
        assert int(tree["step"]) == 2 * steps
        assert int(tree["opt_state"]["1"]["1"]["count"]) == 2 * steps
        ends[model_id] = tree["params"]["classes"]["kernel"]
    assert np.abs(ends["t2"] - ends["t3"]).max() > 1e-4


def test_training_needs_a_gpu_unless_told_cpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA requests succeed here")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no GPU"):
        train.main(["--backbone=DenseNet121"])


def test_clips_into_a_framewise_densenet_raise(trained, tmp_path,
                                               monkeypatch):
    """``--window 4`` without a temporal model feeds clips to a framewise
    DenseNet: the JAX driver raises initializing it, the port names it."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="--window 4 feeds clips"):
        train.main([f"--root={trained['root']}", *COMMON, "--window=4",
                    "--device=cpu"])


def test_resnet_trains_and_the_jax_driver_resumes_it(trained, tmp_path,
                                                     monkeypatch):
    """``--backbone resnet18_v2``, once refused, trains an epoch whose file
    the JAX package loads into its ``TrainState``."""
    from tennis_tpu.models import FrameModel, get_backbone
    from tennis_tpu.parallel import create_train_state, sgd_with_schedule

    monkeypatch.chdir(tmp_path)
    argv = [a for a in COMMON if not a.startswith("--backbone")]
    train.main([f"--root={trained['root']}", *argv, "--max_batches=2",
                "--backbone=resnet18_v2", "--model_id=r", "--epochs=1",
                "--device=cpu"])
    model = FrameModel(get_backbone("resnet18_v2", dtype=jnp.bfloat16),
                       num_classes=11, dtype=jnp.bfloat16)
    tx, _ = sgd_with_schedule(0.001)
    abstract = jax.eval_shape(lambda: create_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32),
        tx, {"train": True}))
    path = str(tmp_path / "models" / "vision" / "experiments" / "r" /
               "0000.params")
    state = jax_ckpt.load_state(path, abstract)
    assert int(state.step) == 2
    np.testing.assert_array_equal(
        np.asarray(state.params["classes"]["kernel"]),
        ckpt.load_raw(path)["params"]["classes"]["kernel"])


def test_copied_experiment_resumes_where_it_stopped(trained, tmp_path,
                                                    monkeypatch):
    """A copy of the port's one-epoch experiment asked for one epoch trains
    no more: the final test runs on the best epoch alone."""
    exp = tmp_path / "models" / "vision" / "experiments" / "t1"
    shutil.copytree(trained["exp"], exp)
    before = (exp / "0000.params").read_bytes()
    monkeypatch.chdir(tmp_path)
    state = train.main([f"--root={trained['root']}", *COMMON,
                        "--model_id=t1", "--epochs=1", "--device=cpu"])
    assert (exp / "0000.params").read_bytes() == before
    assert state.step == int(ckpt.load_raw(str(exp / "0000.params"))["step"])


def test_profile_steps_and_max_batches(trained, tmp_path, monkeypatch):
    """``--profile_steps 2`` traces two extra train steps at the second
    batch of the first epoch into ``<exp_dir>/tb/profile``, the port's
    phase and BN spans among its ranges, and leaves tracing off after;
    ``--max_batches 2`` ends the epoch after two batches of its own."""
    from tennis_torch.utils import tracing

    monkeypatch.chdir(tmp_path)
    state = train.main([f"--root={trained['root']}", *COMMON,
                        "--model_id=t4", "--epochs=1", "--device=cpu",
                        "--profile_steps=2", "--max_batches=2"])
    exp = tmp_path / "models" / "vision" / "experiments" / "t4"
    with open(exp / "tb" / "profile" / "train_steps.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    for span in ("train_step", "backward", "bn_forward", "bn_backward"):
        assert names.count(tracing.PREFIX + span) >= 2, span
    assert tracing.span("a") is tracing.span("b")
    assert state.step == int(ckpt.load_raw(str(exp / "0000.params"))["step"])
    assert state.step == 2 + 2
