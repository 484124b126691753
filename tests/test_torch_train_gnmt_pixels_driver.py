"""The pixels-path captioner's drivers on the synthetic fixture, in the JAX
package's own pixels-path configuration
(``tests/test_drivers_smoke.py::test_train_gnmt_pixels_path``: a
``resnet18_v2`` donor, ``--backbone_from_id``, ``--freeze_backbone``, 32^2
frames, batch 2, ``--max_batches 2``): ``tennis_torch.train_gnmt`` trains an
epoch on the CPU with its per-epoch decodes; ``src_embed`` still equals the
donor's backbone; the epoch file (the three-stage optax chain) restores into
the JAX driver's template through ``tennis_tpu.utils.checkpoint``; the JAX
package's ``evaluate_gnmt --force`` decodes the port's ``valid_best.params``
to the sentences the port's evaluator writes; and the refusals: a donor of
another backbone (``ValueError``), a donor without an epoch
(``FileNotFoundError``) and ``--pretrained_npz``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fixtures import build_fixture
from tennis_torch import evaluate_gnmt, train_gnmt
from tennis_torch.bridge import from_flax, state_to_flax
from tennis_torch.models import FrameModel, backbone_feature_dim, \
    get_backbone
from tennis_torch.parallel.train_step import create_train_state, \
    sgd_with_schedule
from tennis_torch.utils import checkpoint as ckpt
from tennis_torch.utils.experiments import experiment_dir

SMALL = ["--backbone=resnet18_v2", "--data_shape=32", "--test_batch_size=2",
         "--num_hidden=16", "--emb_size=8", "--num_buckets=1",
         "--tgt_max_len=10", "--emb_file=", "--every=10"]
TRAIN = SMALL + ["--backbone_from_id=t2", "--freeze_backbone",
                 "--epochs=1", "--batch_size=2", "--max_batches=2",
                 "--log_interval=1", "--num_workers=2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_donor(model_id, backbone="resnet18_v2", seed=3):
    """A vision experiment with one epoch file of a ``FrameModel(backbone,
    11)`` in f32 (the classifier trainer's layout); returns its tree."""
    g = torch.Generator().manual_seed(seed)
    model = FrameModel(get_backbone(backbone, dtype=torch.float32,
                                    generator=g), 11, dtype=torch.float32,
                       feature_dim=backbone_feature_dim(backbone, 32),
                       generator=g)
    with torch.no_grad():  # statistics away from (0, 1)
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5
                      if name.endswith("var") else
                      torch.randn(buf.shape, generator=g) * 0.1)
    tx, _ = sgd_with_schedule(0.01)
    tree = state_to_flax(create_train_state(model, tx))
    ckpt.save_state(ckpt.epoch_path(experiment_dir("vision", model_id), 0),
                    tree)
    return tree


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = build_fixture(str(tmp_path_factory.mktemp("ds")))
    workdir = str(tmp_path_factory.mktemp("work"))
    old = os.getcwd()
    os.chdir(workdir)
    yield root, workdir
    os.chdir(old)


@pytest.fixture(scope="module")
def trained(env):
    root, workdir = env
    donor = write_donor("t2")
    state = train_gnmt.main([f"--root={root}", "--model_id=px",
                             "--device=cpu", *TRAIN])
    exp = os.path.join(workdir, "models", "captioning", "experiments", "px")
    return donor, state, exp


def test_epoch_files_and_the_frozen_donor(trained):
    donor, state, exp = trained
    assert {"0000.params", "valid_best.params", "best_test_out.txt",
            "epoch0_val_out.txt", "epoch0_test_out.txt", "scores.txt"} <= \
        set(os.listdir(exp))
    log = open(os.path.join(exp, "log.txt")).read()
    for line in ("transplanted backbone from t2 epoch 0",
                 "[Epoch 0][Batch 1] loss=", "[Epoch 0] val loss="):
        assert line in log, line
    want = from_flax({"params": donor["params"]["backbone"],
                      "batch_stats": donor["batch_stats"]["backbone"]})
    got = state.model.src_embed.state_dict()
    params = {n for n, _ in state.model.src_embed.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        if k in params:  # frozen: the donor's weights, bit for bit
            assert torch.equal(got[k], w), k
        else:  # the running statistics moved in the train-mode forward
            assert not torch.equal(got[k], w), k
    tree = ckpt.load_raw(os.path.join(exp, "0000.params"))
    chain = tree["opt_state"]["inner_state"]
    assert sorted(chain) == ["0", "1", "2"]
    assert int(chain["2"]["0"]["count"]) == 2


@pytest.fixture
def jax_flags():
    """The JAX drivers' absl flags, parsed by a test and reset after it (a
    value left set leaks into the next JAX driver run in this process)."""
    from tennis_tpu.train_gnmt import FLAGS

    def parse(argv):
        FLAGS.unparse_flags()
        FLAGS(["x"] + argv)
        return FLAGS

    yield parse
    FLAGS.unparse_flags()


def test_jax_package_reads_the_epoch_file(env, trained, jax_flags):
    """The epoch file restores into the JAX driver's own template (its
    model's ``init`` shapes and its three-stage optimizer)."""
    from tennis_tpu import train_gnmt as jax_tg
    from tennis_tpu.utils import checkpoint as jax_ckpt

    root, _ = env
    _, state, exp = trained
    flags = jax_flags([f"--root={root}", *TRAIN])
    vocab_size = state.model.tgt_embed.weight.shape[0]
    model = jax_tg.build_model(vocab_size)
    src = jnp.zeros((1, 8, flags.data_shape, flags.data_shape, 3), jnp.uint8)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), src,
                            jnp.zeros((1, 9), jnp.int32))

    def chain(learning_rate):
        mask = optax.masked(optax.set_to_zero(), lambda p: {
            k: jax.tree_util.tree_map(lambda _: k == "src_embed", v)
            for k, v in p.items()})
        return optax.chain(mask, optax.clip_by_global_norm(flags.clip),
                           optax.adam(learning_rate))

    opt = optax.inject_hyperparams(chain)(flags.lr)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   dict(shapes))
    template = {"params": zeros["params"],
                "batch_stats": zeros["batch_stats"],
                "opt_state": opt.init(zeros["params"])}
    restored = jax_ckpt.load_state(os.path.join(exp, "0000.params"),
                                   template)
    assert int(restored["opt_state"].count) == 2
    got = from_flax({"params": jax.device_get(restored["params"]),
                     "batch_stats": jax.device_get(restored["batch_stats"])})
    for k, v in state.model.state_dict().items():
        assert torch.equal(got[k], v), k


def test_jax_evaluate_gives_the_ports_sentences(env, trained, jax_flags):
    from tennis_tpu.evaluate_gnmt import main as jax_evaluate

    root, _ = env
    _, _, exp = trained
    path = os.path.join(exp, "best_test_out.txt")
    jax_flags([])
    jax_evaluate(["x", f"--root={root}", "--model_id=px", "--force",
                  *SMALL])
    jax_hyps = open(path).read()
    os.remove(path)
    suite = evaluate_gnmt.main([f"--root={root}", "--model_id=px",
                                "--force", "--device=cpu", *SMALL])
    assert open(path).read() == jax_hyps
    assert set(suite) >= {"Bleu_4", "CIDEr"}


def test_refusals(env, trained):
    root, _ = env
    _, state, _ = trained
    write_donor("t34", backbone="resnet34_v2")
    with pytest.raises(ValueError, match="do not match"):
        train_gnmt.main([f"--root={root}", "--model_id=bad", "--device=cpu",
                         *[a.replace("t2", "t34") for a in TRAIN]])
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        train_gnmt.transplant_backbone(state.model, train_gnmt.parse_args(
            [a.replace("t2", "none") for a in TRAIN]))
    with pytest.raises(NotImplementedError, match="slice 10"):
        train_gnmt.main([f"--root={root}", "--model_id=bad", "--device=cpu",
                         "--pretrained_npz=x.npz", *TRAIN])
