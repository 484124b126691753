"""FlowNet-S and its runner against the JAX package: the module in f32 at
every pixel of the five-scale pyramid (the transposed convolutions' outer
ring included), in bf16 against flax's bf16, the weight bridge both ways,
every ``flownet_run`` helper, ``.flo`` files across packages, and
``FlowRunner.flow_batch`` with its device normalisation.

Tolerances: f32 within ``F32_TOL`` (1e-4) of max |flax flow| per scale (one
summation order against another over up to 9,234-term sums); bf16 within
``BF16_TOL`` (2e-2) of max |flax bf16 flow| (both round every layer's output
to bf16, at other points inside the convolutions; the two lie 5.5e-3 and
5.0e-3 off the f32 flow at this size); the device normalisation within 1e-6
of ``normalise_pair`` (an exact integer mean against numpy's f32 mean)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tennis_tpu.models import flownet_run as jax_run
from tennis_tpu.models.flownet import FlowNetS as JaxFlowNetS
from tennis_tpu.utils import checkpoint as jax_ckpt
from tennis_torch.bridge import from_flax, load_flax, to_flax
from tennis_torch.models import flownet_run as run
from tennis_torch.models.flownet import FlowNetS

F32_TOL = 1e-4
BF16_TOL = 2e-2
SHAPE = (2, 2, 128, 192, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flax_params(seed=1):
    """FlowNetS params from flax's init, every bias redrawn away from 0."""
    rng = np.random.default_rng(seed)
    variables = jax.jit(JaxFlowNetS().init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 2, 64, 64, 3), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    def redraw(leaf, v):
        if leaf == "kernel":
            return v
        return (rng.standard_normal(v.shape) * 0.1).astype(np.float32)

    return {mod: {leaf: redraw(leaf, v) for leaf, v in leaves.items()}
            for mod, leaves in params.items()}


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(0)
    x = (rng.integers(0, 256, SHAPE) / 255.0 - 0.5).astype(np.float32)
    params = flax_params()
    out = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        model = JaxFlowNetS(dtype=dtype)
        pyramid = jax.jit(lambda p, x: model.apply({"params": p}, x,
                                                   train=True))(params, x)
        out[name] = [np.asarray(f) for f in pyramid]
    out["f32_eval"] = out["f32"][0]  # flax's eval output is flow2
    return dict(x=x, params=params, **out)


def rel(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def port(params, dtype):
    return load_flax(FlowNetS(dtype=dtype), {"params": params})


def test_f32_pyramid_matches_flax_at_every_pixel(ref):
    model = port(ref["params"], torch.float32)
    x = torch.from_numpy(ref["x"])
    with torch.no_grad():
        pyramid = model(x, train=True)
        flow = model(x)
        six = model(torch.cat([x[:, 0], x[:, 1]], dim=-1))
    shapes = [(2, 128 // s, 192 // s, 2) for s in (4, 8, 16, 32, 64)]
    assert [tuple(f.shape) for f in pyramid] == shapes
    for got, want in zip(pyramid, ref["f32"]):
        assert got.dtype == torch.float32
        assert rel(got, want) <= F32_TOL
        # the outermost ring of the transposed convolutions' outputs too
        ring = np.ones(want.shape[1:3], bool)
        ring[1:-1, 1:-1] = False
        assert np.abs(got.numpy()[:, ring] - want[:, ring]).max() <= \
            F32_TOL * np.abs(want).max()
    assert rel(flow, ref["f32_eval"]) <= F32_TOL
    np.testing.assert_array_equal(six.numpy(), flow.numpy())


def test_bf16_matches_flax_bf16(ref):
    model = port(ref["params"], torch.bfloat16)
    assert model.dtype == torch.bfloat16  # the default, as flax's
    with torch.no_grad():
        pyramid = model(torch.from_numpy(ref["x"]), train=True)
    for got, want in zip(pyramid, ref["bf16"]):
        assert got.dtype == torch.float32
        assert rel(got, want) <= BF16_TOL
    assert FlowNetS().dtype == torch.bfloat16


def test_bridge_carries_the_tree_both_ways_exactly(ref):
    params = ref["params"]
    model = port(params, torch.float32)
    back = to_flax(model)
    assert back["batch_stats"] == {}
    assert set(back["params"]) == set(params)
    for mod, leaves in params.items():
        assert set(back["params"][mod]) == set(leaves), mod
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(back["params"][mod][leaf], v)
    # a transposed convolution's kernel: HWIO -> IOHW, flipped in space
    k = params["deconv3"]["kernel"]
    np.testing.assert_array_equal(
        model.deconv3.weight.detach().numpy(),
        k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    # without the module, a kernel reads as a convolution's
    assert from_flax({"params": params})["deconv3.weight"].shape == (
        128, 770, 4, 4)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(v.size for leaves in params.values()
                    for v in leaves.values()) == 38_676_506


def test_flownet_run_helpers_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    for h, w in ((720, 1280), (128, 192), (100, 70), (64, 64)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(run.crop_to_64(img),
                                      jax_run.crop_to_64(img))
    assert run.crop_to_64(np.zeros((720, 1280, 3))).shape == (704, 1280, 3)
    pair = rng.integers(0, 256, (2, 64, 128, 3), dtype=np.uint8)
    np.testing.assert_array_equal(run.normalise_pair(pair),
                                  jax_run.normalise_pair(pair))
    np.testing.assert_array_equal(run.make_color_wheel(),
                                  jax_run.make_color_wheel())
    u = rng.standard_normal((17, 23)) * 0.7
    v = rng.standard_normal((17, 23)) * 0.7
    u[0, 0] = np.nan
    v[1, 1] = np.nan
    np.testing.assert_array_equal(run.compute_color(u, v),
                                  jax_run.compute_color(u, v))
    flow = rng.standard_normal((17, 23, 2)).astype(np.float32) * 3
    flow[2, 3, 0] = 2e7  # unknown flow
    flow[4, 5, 1] = -3e7
    for f in (flow, np.zeros_like(flow), flow[:0]):
        np.testing.assert_array_equal(run.flow_to_image(f),
                                      jax_run.flow_to_image(f))
    assert run.flow_to_image(flow)[2, 3].tolist() == [0, 0, 0]
    # .flo files either way
    ours, theirs = str(tmp_path / "a.flo"), str(tmp_path / "b.flo")
    run.write_flo(ours, flow)
    jax_run.write_flo(theirs, flow)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    np.testing.assert_array_equal(jax_run.read_flo(ours), flow)
    np.testing.assert_array_equal(run.read_flo(theirs), flow)
    with open(ours, "r+b") as f:
        f.write(np.float32(1.0).tobytes())
    with pytest.raises(ValueError, match="magic"):
        run.read_flo(ours)


def test_flow_batch_matches_jax(ref, tmp_path):
    rng = np.random.default_rng(4)
    pairs = rng.integers(0, 256, (3, 2, 64, 128, 3), dtype=np.uint8)
    want = jax_run.FlowRunner(params=ref["params"]).flow_batch(pairs)
    mine = run.FlowRunner(params=ref["params"], device="cpu")
    got = mine.flow_batch(pairs)
    assert got.shape == want.shape == (3, 16, 32, 2)
    assert got.dtype == np.float32
    assert rel(got, want) <= BF16_TOL
    # from a checkpoint of {"params": ...} that the JAX package wrote
    path = str(tmp_path / "flownet.params")
    jax_ckpt.save_state(path, {"params": ref["params"]})
    np.testing.assert_array_equal(
        run.FlowRunner(params_path=path, device="cpu").flow_batch(pairs), got)
    # a seeded init
    seeded = run.FlowRunner(device="cpu", seed=5).flow_batch(pairs[:1])
    assert seeded.shape == (1, 16, 32, 2) and np.isfinite(seeded).all()


def test_device_normalisation_equals_normalise_pair():
    rng = np.random.default_rng(6)
    pairs = rng.integers(0, 256, (4, 2, 64, 128, 3), dtype=np.uint8)
    pairs[1] = 255  # a constant pair
    got = run.normalise_pairs(torch.from_numpy(pairs)).numpy()
    want = np.stack([run.normalise_pair(p) for p in pairs])
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6


def test_npz_weights_and_missing_gpu_raise(tmp_path):
    npz = tmp_path / "flownets.npz"
    np.savez(npz, w=np.zeros(1))
    with pytest.raises(NotImplementedError, match="slice 10"):
        run.FlowRunner(params_path=str(npz), device="cpu")
    with pytest.raises(FileNotFoundError):
        run.FlowRunner(params_path=str(tmp_path / "none.params"), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA requests succeed here")
    with pytest.raises(RuntimeError, match="no GPU"):
        run.FlowRunner()
