"""The ``--temp_pool max|mean`` wrap of a framewise donor: its backbone
features pooled over the window, then its own head. Over features the port
dumped (``--feats_model``), both of the port's drivers (``train`` and
``evaluate``) against the JAX ``evaluate`` wrap on the same features,
probabilities within 1e-2 absolute (the head runs in bf16); over frames
(``--backbone_from_id``), the port's wrap against its own per-frame
features pooled by hand."""
import os

import numpy as np
import pytest
import torch

from fixtures import build_fixture
from test_torch_extract import COMMON, MODEL_ID, run_jax, \
    write_jax_experiment
from tennis_tpu import evaluate as jax_evaluate
from tennis_torch import evaluate, train
from tennis_torch.data import loader as port_loader
from tennis_torch.data.tennis_set import get_image_path

PROB_TOL = 1e-2
POOL = ["--temp_pool=mean", "--window=4", f"--feats_model={MODEL_ID}",
        "--backbone=DenseNet121", "--data_shape=32", "--batch_size=16",
        "--num_workers=2", "--model_id=tp"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The fixture, the JAX-written donor experiment, and the port's
    feature dump of it."""
    workdir = tmp_path_factory.mktemp("work")
    root = build_fixture(tmp_path_factory.mktemp("ds"))
    old = os.getcwd()
    os.chdir(workdir)
    try:
        exp, _ = write_jax_experiment(str(workdir))
        train.main([f"--root={root}", "--save_feats", "--device=cpu",
                    *COMMON])
        want = run_jax(jax_evaluate.evaluate_model, [f"--root={root}", *POOL])
        yield dict(root=root, exp=exp, want=want)
    finally:
        os.chdir(old)


def _agree(got: dict, want: dict):
    assert set(got) == set(want) and len(want) == 20
    for key, p in want.items():
        assert got[key].shape == p.shape == (11,)
        np.testing.assert_allclose(got[key], p, atol=PROB_TOL, err_msg=key)
    return all(int(np.argmax(got[k])) == int(np.argmax(p))
               for k, p in want.items())


def test_evaluate_wrap_matches_jax(env):
    res_w, gts_w, m_w = env["want"]
    res_g, gts_g, m_g = evaluate.main([f"--root={env['root']}",
                                       "--device=cpu", *POOL])
    assert gts_g == gts_w
    if _agree(res_g, res_w):
        assert m_g["prf1"].get() == m_w["prf1"].get()


def test_train_final_test_matches_jax(env, monkeypatch):
    """``train --temp_pool mean`` trains nothing and scores the test split
    with the same wrap: its logits (caught on their way to the metrics)
    give the JAX wrap's probabilities."""
    caught = {}
    real = port_loader.eval_iter

    def spy(loader, step, device=None):
        ds = loader.dataset
        for logits, labels, idxs in real(loader, step, device):
            for row, idx in zip(logits, idxs):
                v, f = ds._samples[int(idx)][:2]
                caught[get_image_path("frames", v, f)] = \
                    torch.softmax(torch.from_numpy(row), -1).numpy()
            yield logits, labels, idxs

    monkeypatch.setattr(port_loader, "eval_iter", spy)
    metrics = train.main([f"--root={env['root']}", "--device=cpu", *POOL])
    res_w, _, m_w = env["want"]
    if _agree(caught, res_w):
        assert metrics["prf1"].get() == m_w["prf1"].get()
    exp_tp = os.path.join("models", "vision", "experiments", "tp")
    assert not [f for f in os.listdir(exp_tp) if f.endswith(".params")]


@pytest.mark.parametrize("pool", ["max", "mean"])
def test_backbone_wrap_pools_frame_features(env, pool):
    """``--backbone_from_id``: each clip's frames through the donor's
    backbone in one forward, pooled, then its head; against the same
    computation from the port's per-frame features."""
    from tennis_torch.data import transforms as tf
    from tennis_torch.data.tennis_set import TennisSet
    from tennis_torch.inference import make_extract_features

    argv = [f"--root={env['root']}", "--device=cpu", f"--temp_pool={pool}",
            "--window=4", "--stride=2", f"--backbone_from_id={MODEL_ID}",
            "--backbone=DenseNet121", "--data_shape=32", "--batch_size=8",
            "--num_workers=2", "--model_id=tb"]
    res, _, _ = evaluate.main(argv)
    args = train.parse_args(argv)
    donor = train.build_model(args, 11)
    # evaluate takes the donor's best epoch (train's final test its newest)
    train.load_epoch(donor, env["exp"], 0)
    extract = make_extract_features(donor, torch.device("cpu"))
    ds = TennisSet(root=env["root"], split="test", balance=False, window=4,
                   stride=2)
    assert len(res) == len(ds) == 20
    for i in (0, 7, 19):
        clip = np.stack([tf.test_geometry(f, 32) for f in ds[i][0]])
        feats = extract(clip)
        pooled = feats.mean(0) if pool == "mean" else feats.amax(0)
        with torch.inference_mode():
            want = torch.softmax(donor.head(pooled[None]), -1)[0].numpy()
        v, f = ds._samples[i][:2]
        np.testing.assert_allclose(res[get_image_path("frames", v, f)], want,
                                   atol=PROB_TOL)


@pytest.mark.parametrize("pool", ["max", "mean"])
def test_pooling_head_matches_flax(pool):
    """``TemporalPooling(num_classes > 0)`` over (B, T, F) features: its
    ``classes`` head takes the flax tree through the weight bridge and
    agrees with the JAX module (bf16 head, 1e-2 of max |logit|)."""
    import jax
    import jax.numpy as jnp

    from tennis_tpu.models import TemporalPooling as JaxTemporalPooling
    from tennis_torch.bridge import load_flax
    from tennis_torch.models import TemporalPooling

    x = np.random.default_rng(1).normal(size=(3, 5, 24)).astype(np.float32)
    jax_tp = JaxTemporalPooling(num_classes=11, pool=pool, feats=True)
    variables = jax.jit(jax_tp.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jax_tp.apply(variables, jnp.asarray(x)))
    tp = TemporalPooling(num_classes=11, pool=pool, feats=True,
                         feature_dim=24)
    load_flax(tp, jax.device_get(dict(variables)))
    got = tp(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (3, 11) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
