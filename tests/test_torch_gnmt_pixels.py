"""The pixels-path captioner (``NMTModel`` with an f32 ``src_embed`` over
frames) against the JAX package's ``NMTModel(src_embed=...)`` on the CPU,
for a 2-block DenseNet and for ``resnet18_v2``, both at 32^2, from the same
seeded weights carried over by the bridge: eval logits over uint8 frames
(``device_prepare``, B·T folded into one backbone forward) within 1e-5 of
max |logit|; train-mode logits and every gradient over float frames (no
augment, as in JAX) within 1e-4, the backbone's batch statistics over all
B·T frames, padded steps included (the DenseNet stem's BN scale, whose
gradient cancels through every BN after it, is held within 1e-4 of the
port's backbone in f64, where the JAX package's own f32 gradient lies
2.4e-4 off and the port's 3.5e-5); the running statistics after that
forward; and the eval forward's plain dense layers against
``densenet_features_pallas(..., dtype=float32, interpret=True)``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tennis_tpu.models import get_backbone as jax_backbone
from tennis_tpu.models.backbones.densenet import DenseNet as JaxDenseNet
from tennis_tpu.models.backbones.densenet import DenseNetSpec as JaxSpec
from tennis_tpu.models.gnmt import NMTModel as JaxNMT
from tennis_tpu.models.gnmt import get_gnmt_encoder_decoder as jax_enc_dec
from tennis_tpu.models.gnmt import masked_ce_loss as jax_masked_ce_loss
from tennis_tpu.ops.pallas.dense_block import densenet_features_pallas
from tennis_torch.bridge import from_flax, load_flax, to_flax
from tennis_torch.models import DenseNet, DenseNetSpec, get_backbone
from tennis_torch.models.gnmt import NMTModel, get_gnmt_encoder_decoder, \
    masked_ce_loss

V, E, H, B, T, L, S = 14, 8, 16, 2, 4, 6, 32
SPEC = ((2, 2), 32, 64, 4)  # block-final widths 128/128: the kernel's
LOGIT_TOL, GRAD_TOL, STATS_TOL = 1e-5, 1e-4, 1e-5
# held against the port's backbone in f64, not against the JAX package's f32
F64_LEAVES = {"densenet": {"src_embed.bn0.weight"}, "resnet": set()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def backbones(kind):
    """(JAX module, port module, feature size) of an f32 backbone."""
    if kind == "densenet":
        return (JaxDenseNet(JaxSpec(*SPEC), dtype=jnp.float32),
                DenseNet(DenseNetSpec(*SPEC), dtype=torch.float32), 128)
    return (jax_backbone("resnet18_v2", dtype=jnp.float32),
            get_backbone("resnet18_v2", dtype=torch.float32), 512)


def batch(seed=0):
    """uint8 and float frames (B, T, S, S, 3), zero past each source length
    (the bucketed loader's padding), captions and lengths."""
    rng = np.random.default_rng(seed)
    src_vl = np.asarray([T, 3], np.float32)
    tgt_vl = np.asarray([L, 4], np.float32)
    u8 = rng.integers(0, 256, (B, T, S, S, 3)).astype(np.uint8)
    u8[1, 3:] = 0
    fl = rng.normal(size=(B, T, S, S, 3)).astype(np.float32)
    fl[1, 3:] = 0.0
    tgt = rng.integers(0, V, (B, L)).astype(np.int32)
    return u8, fl, tgt, src_vl, tgt_vl


def random_tree(shapes, rng):
    """Every leaf redrawn: kernels N(0, 1/fan_in), scales near 1, biases and
    means small, variances away from 1, embeddings N(0, 1/E)."""
    def draw(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        if name == "embedding":
            return rng.normal(0, shape[-1] ** -0.5, shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return (rng.normal(size=shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_model(kind, variables, feat, dtype=torch.float32):
    """The port's captioner with ``variables``; ``dtype`` float64 builds
    its backbone in f64 (the GNMT stays f32)."""
    _, src_embed, _ = backbones(kind)
    if dtype == torch.float64:
        src_embed.dtype = dtype
        src_embed.double()
    enc, dec = get_gnmt_encoder_decoder(hidden_size=H, input_size=feat,
                                        embed_size=E, dropout=0.0)
    model = NMTModel(V, enc, dec, embed_size=E, hidden_size=H,
                     src_embed=src_embed)
    return load_flax(model, variables)


@pytest.fixture(scope="module", params=["densenet", "resnet"])
def run(request):
    """The JAX model's weights and its outputs: eval logits over uint8
    frames, train-mode logits, loss, gradients and new statistics over
    float frames, and (DenseNet) the Pallas kernel's features."""
    kind = request.param
    jsrc, _, feat = backbones(kind)
    enc, dec = jax_enc_dec(hidden_size=H, dropout=0.0)
    jmodel = JaxNMT(vocab_size=V, encoder=enc, decoder=dec, embed_size=E,
                    src_embed=jsrc)
    u8, fl, tgt, src_vl, tgt_vl = batch()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(fl), jnp.asarray(tgt[:, :-1]))
    variables = random_tree({"params": shapes["params"],
                             "batch_stats": shapes["batch_stats"]},
                            np.random.default_rng(1))
    args = (jnp.asarray(tgt[:, :-1]), jnp.asarray(src_vl),
            jnp.asarray(tgt_vl - 1))

    def loss_fn(params, x):
        logits, mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            *args, train=True, rngs={"dropout": jax.random.PRNGKey(2)},
            mutable=["batch_stats"])
        loss = jax_masked_ce_loss(logits, jnp.asarray(tgt[:, 1:]),
                                  jnp.asarray(tgt_vl - 1))
        return loss, (logits, mutated["batch_stats"])

    def both(v, u8, fl):  # one program: one compile
        return (jmodel.apply(v, u8, *args),
                jax.value_and_grad(loss_fn, has_aux=True)(v["params"], fl))

    eval_logits, ((loss, (train_logits, stats)), grads) = jax.jit(both)(
        variables, jnp.asarray(u8), jnp.asarray(fl))
    out = {"kind": kind, "feat": feat, "variables": variables,
           "eval_logits": np.asarray(eval_logits),
           "train_logits": np.asarray(train_logits), "loss": float(loss),
           "grads": jax.device_get(grads), "stats": jax.device_get(stats)}
    if kind == "densenet":
        from tennis_torch.data.transforms import device_prepare

        x = device_prepare(torch.from_numpy(u8.reshape(B * T, S, S, 3)),
                           torch.float32).numpy()
        out["prepared"] = x
        out["pallas_features"] = np.asarray(jax.jit(
            lambda v, x: densenet_features_pallas(
                JaxSpec(*SPEC), v, x, dtype=jnp.float32, interpret=True))(
            {"params": variables["params"]["src_embed"],
             "batch_stats": variables["batch_stats"]["src_embed"]},
            jnp.asarray(x)))
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_eval_logits_over_uint8_frames(run):
    model = port_model(run["kind"], run["variables"], run["feat"]).eval()
    u8, _, tgt, src_vl, tgt_vl = batch()
    with torch.no_grad():
        got = model(torch.from_numpy(u8), torch.from_numpy(tgt[:, :-1]),
                    torch.from_numpy(src_vl), torch.from_numpy(tgt_vl - 1))
    assert got.shape == run["eval_logits"].shape
    assert _rel(got.numpy(), run["eval_logits"]) <= LOGIT_TOL


def _train_forward(run, dtype=torch.float32):
    model = port_model(run["kind"], run["variables"], run["feat"],
                       dtype).train()
    _, fl, tgt, src_vl, tgt_vl = batch()
    logits = model(torch.from_numpy(fl).to(dtype),
                   torch.from_numpy(tgt[:, :-1]),
                   torch.from_numpy(src_vl), torch.from_numpy(tgt_vl - 1))
    loss = masked_ce_loss(logits, torch.from_numpy(tgt[:, 1:]),
                          torch.from_numpy(tgt_vl - 1))
    return model, logits, loss


def test_train_logits_and_every_gradient_over_float_frames(run):
    model, logits, loss = _train_forward(run)
    assert _rel(logits.detach().numpy(), run["train_logits"]) <= GRAD_TOL
    assert abs(loss.item() - run["loss"]) <= GRAD_TOL * abs(run["loss"])
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    want = from_flax({"params": run["grads"]})
    assert set(want) == set(names)
    assert any(n.startswith("src_embed.") for n in names)
    f64 = F64_LEAVES[run["kind"]]
    if f64:
        m64, _, loss64 = _train_forward(run, torch.float64)
        ref = dict(zip([n for n, _ in m64.named_parameters()],
                       torch.autograd.grad(loss64, list(m64.parameters()))))

    def gap(a, w):
        return np.linalg.norm(a - w) / max(np.linalg.norm(w), 1e-30)

    for name, g in zip(names, grads):
        if name in f64:
            exact = ref[name].numpy()
            assert gap(g.double().numpy(), exact) <= GRAD_TOL, name
            assert gap(g.double().numpy(), exact) < gap(
                want[name].double().numpy(), exact), name
        else:
            assert gap(g.numpy(), want[name].numpy()) <= GRAD_TOL, name


def test_running_statistics_after_one_train_forward(run):
    model, _, _ = _train_forward(run)
    got = to_flax(model)["batch_stats"]
    assert set(got) == {"src_embed"}
    want = from_flax({"batch_stats": run["stats"]})
    before = from_flax({"batch_stats": run["variables"]["batch_stats"]})
    have = from_flax({"batch_stats": got})
    assert set(have) == set(want)
    for name, w in want.items():
        assert not torch.equal(w, before[name]), name  # the forward moved it
        np.testing.assert_allclose(have[name].numpy(), w.numpy(),
                                   rtol=STATS_TOL, atol=STATS_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("run", ["densenet"], indirect=True)
def test_plain_dense_layers_match_the_pallas_kernel(run):
    model = port_model(run["kind"], run["variables"], run["feat"]).eval()
    with torch.no_grad():
        got = model.src_embed(torch.from_numpy(run["prepared"]))
    np.testing.assert_allclose(got.numpy(), run["pallas_features"],
                               rtol=1e-4, atol=1e-4)
