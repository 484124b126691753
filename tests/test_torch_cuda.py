"""The port on a CUDA card: the dense-layer kernel against its plain version
at small and ragged shapes, the wrapper's refusals, and a DenseNet forward
through the kernel. Marked ``cuda``; each test skips without a card. On a
machine with one, run them without the JAX conftest:
``python -m pytest tests/test_torch_cuda.py --noconftest -q``."""
import pytest
import torch

from tennis_torch.models import DenseNet, DenseNetSpec
from tennis_torch.ops import dense_block as db

pytestmark = pytest.mark.cuda
REL_TOL = 1e-2  # max |kernel - plain| / max |plain| with bf16 state


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(dev, batch, h, w, c_in, c_final, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, std=1.0):
        return torch.empty(shape, device=dev).normal_(0, std, generator=g)

    state = rand(batch, h, w, c_final).to(torch.bfloat16)
    ops = db.LayerOperands(
        rand(c_in).abs() + 0.5, rand(c_in) * 0.5,
        rand(128, c_in, std=c_in ** -0.5).to(torch.bfloat16),
        rand(128).abs() + 0.5, rand(128) * 0.5,
        rand(3, 3, 32, 128, std=1152 ** -0.5).to(torch.bfloat16))
    return state, ops


@pytest.mark.parametrize("batch,h,w,c_in,c_final", [
    (2, 8, 8, 64, 128), (2, 7, 7, 96, 128), (1, 4, 4, 128, 160),
    (3, 13, 9, 32, 64), (1, 1, 1, 64, 96), (2, 24, 17, 224, 256)])
def test_kernel_matches_plain(dev, batch, h, w, c_in, c_final):
    state, ops = _layer(dev, batch, h, w, c_in, c_final)
    launches = db.dense_layer.launches
    got = db.dense_layer(state.clone(), c_in, ops)
    want = db.dense_layer_reference(state.clone(), c_in, ops)
    torch.cuda.synchronize()
    assert db.dense_layer.launches == launches + 1
    part_g = got[..., c_in:c_in + 32].float()
    part_w = want[..., c_in:c_in + 32].float()
    err = (part_g - part_w).abs().max() / part_w.abs().max()
    assert err <= REL_TOL, err.item()
    torch.testing.assert_close(got[..., :c_in], state[..., :c_in], rtol=0, atol=0)
    torch.testing.assert_close(got[..., c_in + 32:], state[..., c_in + 32:],
                               rtol=0, atol=0)


def test_kernel_refuses_what_it_does_not_take(dev):
    state, ops = _layer(dev, 1, 8, 8, 64, 128)
    with pytest.raises(TypeError):
        db.dense_layer(state.float(), 64, ops)
    with pytest.raises(ValueError):
        db.dense_layer(state, 64, ops._replace(w1=ops.w1.cpu()))
    with pytest.raises(ValueError):
        db.dense_layer(state, 48, ops)


def test_densenet_forward_through_kernel(dev):
    """A small DenseNet on the card goes through the kernel once per layer
    and agrees with the plain-version forward on the same card."""
    gen = torch.Generator().manual_seed(0)
    model = DenseNet(DenseNetSpec((2, 3), 32, 64), generator=gen).to(dev).eval()
    model.fold()
    x = torch.randn(2, 64, 64, 3, generator=gen).to(dev)
    with torch.inference_mode():
        launches = db.dense_layer.launches
        got = model(x).float()
        assert db.dense_layer.launches == launches + 5
        want = db.densenet_features(model.spec, model.operands(), x, model.dtype,
                                    layer=db.dense_layer_reference).float()
    err = (got - want).abs().max() / want.abs().max()
    assert err <= 3e-2, err.item()
