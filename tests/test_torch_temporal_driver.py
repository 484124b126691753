"""The temporal and two-stream slice as a whole, on the synthetic fixture with
flow frames and a seeded 1024-d feature store (DenseNet121's width at
32^2) written with numpy: the port's ``train`` for the CNN-RNN over
features (``--feats_model fs --temp_pool gru --window 4``) and for the
two-stream net (``--flow twos``), 1 epoch of 3 batches on the CPU; the JAX
package resumes both epoch files; the JAX driver trains the next epoch of
the CNN-RNN from the port's file and the port the one after from the JAX
driver's; the port resumes a JAX-written two-stream epoch; both evaluators
score the port's CNN-RNN experiment with the same predicted labels; and
``--backbone_from_id`` of a framewise donor raises in both drivers.

Tolerances: probabilities within 1e-2 absolute (both packages run the
bi-GRU in bf16, summing in other orders)."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import VIDEO_EVENTS, build_fixture
from test_torch_extract import run_jax, write_jax_experiment
from tennis_tpu import evaluate as jax_evaluate
from tennis_tpu import train as jax_train
from tennis_tpu.data.tennis_set import TennisSet as JaxTennisSet
from tennis_tpu.data.tennis_set import get_feature_path
from tennis_tpu.utils import checkpoint as jax_ckpt
from tennis_torch import evaluate, train
from tennis_torch.data.tennis_set import TennisSet
from tennis_torch.utils import checkpoint as ckpt

FEAT_DIM, PROB_TOL, STEPS = 1024, 1e-2, 3
COMMON = ["--backbone=DenseNet121", "--data_shape=32", "--batch_size=8",
          "--num_workers=2", f"--max_batches={STEPS}", "--device=cpu"]
FEATS = ["--feats_model=fs", "--temp_pool=gru", "--window=4"]
CONFIGS = {"cnnrnn": FEATS, "twos": ["--flow=twos"]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _exp(workdir, model_id):
    return os.path.join(workdir, "models", "vision", "experiments", model_id)


def _jax_model(config):
    from tennis_tpu.models import CNNRNN, TwoStreamModel, get_backbone

    if config == "cnnrnn":
        return CNNRNN(None, 11, 128, "gru", dtype=jnp.bfloat16), \
            (1, 4, FEAT_DIM)
    nets = [get_backbone("densenet121", dtype=jnp.bfloat16) for _ in "rf"]
    return TwoStreamModel(*nets, 11, dtype=jnp.bfloat16), (1, 32, 32, 6)


def _abstract_state(config, steps_per_epoch):
    """The JAX driver's ``TrainState`` of ``config``, as shapes."""
    from tennis_tpu.parallel import create_train_state, sgd_with_schedule

    model, sample = _jax_model(config)
    tx, _ = sgd_with_schedule(0.001, 0.9, 1e-4, [10, 20], 0.75,
                              steps_per_epoch)
    return jax.eval_shape(lambda: create_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros(sample, jnp.float32), tx,
        {"train": True}))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The fixture, the feature store, and the port's one-epoch runs of
    both configurations (``c1``, ``f1``), from one working directory."""
    root = build_fixture(tmp_path_factory.mktemp("ds"), with_flow=True)
    rng = np.random.default_rng(0)
    for video, events in VIDEO_EVENTS.items():
        for frame in range(events[-1][1]):
            path = get_feature_path(os.path.join(root, "features", "fs"),
                                    video, frame)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, rng.standard_normal(FEAT_DIM).astype(np.float32))
    workdir = str(tmp_path_factory.mktemp("work"))
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        states = {config: train.main([f"--root={root}", *COMMON, *argv,
                                      f"--model_id={config[0]}1",
                                      "--epochs=1"])
                  for config, argv in CONFIGS.items()}
    finally:
        os.chdir(cwd)
    steps = len(train.make_datasets(train.parse_args(
        [f"--root={root}", *COMMON, *FEATS]))[0]) // 8
    return dict(root=root, workdir=workdir, states=states, steps=steps)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_one_epoch_writes_the_jax_layout(run, config):
    exp = _exp(run["workdir"], f"{config[0]}1")
    assert {"0000.params", "log.txt", "scores.txt"} <= set(os.listdir(exp))
    tree = ckpt.load_raw(os.path.join(exp, "0000.params"))
    assert list(tree) == ["step", "params", "batch_stats", "opt_state"]
    assert int(tree["step"]) == STEPS == run["states"][config].step
    if config == "cnnrnn":
        assert tree["batch_stats"] == {}  # stat-less, as flax writes it
        assert sorted(tree["params"]) == ["classes", "rnn"]
        assert sorted(tree["params"]["rnn"]["bwd"]) == ["i2h", "recurrence"]
    else:
        assert sorted(tree["params"]) == ["classes", "model_flow",
                                          "model_rgb"]
        assert tree["params"]["model_flow"]["conv0"]["kernel"].shape == \
            (7, 7, 3, 64)
    log = open(os.path.join(exp, "log.txt")).read()
    assert "[Epoch 0] val AVG_NB_f1=" in log and "test AVG_NB_f1=" in log


@pytest.mark.parametrize("config", list(CONFIGS))
def test_jax_resumes_the_port_epoch(run, config):
    abstract = _abstract_state(config, run["steps"])
    target = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                    abstract)
    exp = _exp(run["workdir"], f"{config[0]}1")
    start, state = jax_ckpt.resume_state(exp, target)
    assert start == 1 and int(state.step) == STEPS
    raw = ckpt.load_raw(os.path.join(exp, "0000.params"))
    got = jax.tree_util.tree_leaves((state.params, state.batch_stats,
                                     state.opt_state))
    want = jax.tree_util.tree_leaves((raw["params"], raw["batch_stats"],
                                      raw["opt_state"]))
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_jax_driver_and_port_train_on_from_each_other(run, monkeypatch):
    """A copy of the port's CNN-RNN experiment: ``python -m
    tennis_tpu.train`` with the same flags resumes its epoch 0 and writes
    epoch 1, and the port resumes that and writes epoch 2."""
    monkeypatch.chdir(run["workdir"])
    exp = _exp(run["workdir"], "c2")
    shutil.copytree(_exp(run["workdir"], "c1"), exp)
    argv = [f"--root={run['root']}", *FEATS, "--model_id=c2",
            *[a for a in COMMON if a != "--device=cpu"]]
    run_jax(jax_train.train_and_evaluate, argv + ["--epochs=2"])
    assert "resumed from epoch 0" in open(os.path.join(exp, "log.txt")).read()
    assert int(jax_ckpt.load_raw(jax_ckpt.epoch_path(exp, 1))["step"]) == \
        2 * STEPS
    train.main(argv + ["--device=cpu", "--epochs=3"])
    tree = ckpt.load_raw(ckpt.epoch_path(exp, 2))
    assert int(tree["step"]) == 3 * STEPS
    assert int(tree["opt_state"]["1"]["1"]["count"]) == 3 * STEPS
    assert [r.split()[0] for r in open(os.path.join(exp, "scores.txt"))] == \
        ["0", "1", "2"]


def test_port_resumes_a_jax_written_two_stream_epoch(run, monkeypatch):
    """Epoch 0 of the two-stream ``TrainState`` (seeded weights and
    momentum), written by the JAX package: the port resumes it, step and
    momentum, and writes epoch 1."""
    monkeypatch.chdir(run["workdir"])
    exp = _exp(run["workdir"], "f2")
    rng = np.random.default_rng(3)

    def draw(path, a):
        if a.dtype != np.float32:
            return np.asarray(STEPS, a.dtype)
        name = str(getattr(path[-1], "key", ""))
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (rng.standard_normal(a.shape) * 0.05).astype(np.float32)

    state = jax.tree_util.tree_map_with_path(
        draw, _abstract_state("twos", run["steps"]))
    os.makedirs(exp)
    jax_ckpt.save_state(jax_ckpt.epoch_path(exp, 0), state)
    jax_ckpt.append_score(exp, 0, 0.5)
    train.main([f"--root={run['root']}", *COMMON, "--flow=twos",
                "--model_id=f2", "--epochs=2"])
    assert "resumed from epoch 0" in open(os.path.join(exp, "log.txt")).read()
    tree = ckpt.load_raw(ckpt.epoch_path(exp, 1))
    trace = tree["opt_state"]["1"]["0"]["trace"]["classes"]["kernel"]
    assert np.abs(trace).max() > 0 and int(tree["step"]) == 2 * STEPS


def test_both_evaluators_predict_the_same_labels(run, monkeypatch):
    monkeypatch.chdir(run["workdir"])
    args = [f"--root={run['root']}", *FEATS, "--model_id=c1",
            "--backbone=DenseNet121", "--data_shape=32", "--batch_size=8",
            "--num_workers=2"]
    res_j, _, _ = run_jax(jax_evaluate.evaluate_model, args)
    res_p, _, m_p = evaluate.main(args + ["--device=cpu"])
    assert set(res_p) == set(res_j) and len(res_p) > 8
    for key, p in res_j.items():
        np.testing.assert_allclose(res_p[key], p, atol=PROB_TOL, err_msg=key)
        assert int(np.argmax(res_p[key])) == int(np.argmax(p)), key


def test_backbone_from_a_framewise_donor_raises_in_both(run, monkeypatch):
    """``--backbone_from_id`` of a ``FrameModel`` experiment into the
    CNN-RNN: the JAX driver's ``from_bytes`` of the donor's file into the
    CNN-RNN's state raises ``ValueError``; so does the port, naming the
    keys. The two-stream net has no ``backbone`` either."""
    monkeypatch.chdir(run["workdir"])
    write_jax_experiment(run["workdir"], "d1")
    argv = [f"--root={run['root']}", "--backbone_from_id=d1",
            "--model_id=x1", "--epochs=1",
            *[a for a in COMMON if a != "--device=cpu"]]
    with pytest.raises(ValueError):
        run_jax(jax_train.train_and_evaluate, argv + FEATS)
    with pytest.raises(ValueError, match="another architecture"):
        train.main(argv + FEATS + ["--device=cpu"])
    with pytest.raises(ValueError, match="another architecture"):
        train.main(argv + ["--flow=twos", "--device=cpu"])


def test_six_channel_clip_samples_equal_jax(run):
    """Windows of 6-channel frames (the RGB frame's 16-row crop beside its
    flow frame), bit for bit."""
    kw = dict(root=run["root"], split="val", balance=False, window=4,
              flow=True)
    want, got = JaxTennisSet(**kw), TennisSet(**kw)
    assert len(got) == len(want) > 0
    for i in (0, len(got) - 1):
        (xg, yg, _), (xw, yw, _) = got[i], want[i]
        assert xg.shape == (4, 8, 32, 6) and yg == yw
        np.testing.assert_array_equal(xg, xw)


@pytest.mark.parametrize("argv", [["--flow=twos"], ["--window=4"]])
def test_feature_dump_of_a_temporal_or_two_stream_model_raises(run, argv,
                                                               monkeypatch):
    monkeypatch.chdir(run["workdir"])
    extra = FEATS if argv == ["--window=4"] else argv
    with pytest.raises(ValueError, match="backbone-bearing"):
        train.main([f"--root={run['root']}", "--backbone=DenseNet121",
                    "--data_shape=32", "--save_feats", "--device=cpu",
                    "--model_id=s1", *extra])
