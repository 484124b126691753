"""Each plain reference agrees with the program's module on the CPU at a
small size, in float64: features in eval mode, logits and every gradient
in train mode; the reference's input stage agrees with the program's
device augment and preparation. (The test may import both; the reference
itself imports nothing of the program.)"""
import math

import pytest
import torch

from port_bench import harness
from port_bench.reference import inputs

CASES = {"densenet121-512.train.b64": (["--backbone", "DenseNet121"],
                                       (4, 64, 64, 3)),
         "r21d34-8x224.train.b64": (["--backbone", "rdnet", "--window", "8"],
                                    (2, 8, 32, 32, 3))}


def _weights(ref, cfg, gen):
    out = {}
    for name, (shape, kind) in ref.param_shapes(cfg).items():
        v = torch.randn(shape, generator=gen, dtype=torch.float64)
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
        out[name] = {"conv": v * math.sqrt(2 / fan_in),
                     "linear": v * math.sqrt(1 / fan_in),
                     "bn_weight": 1 + 0.1 * v,
                     "bn_var": torch.exp(0.2 * v)}.get(kind, 0.1 * v)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_the_programs_module(bench, name):
    from tennis_torch import train as driver

    argv, shape = CASES[name]
    cell = harness.find_cell(bench, name)
    cfg = dict(cell.config, data_shape=shape[-2])
    ref = cell.reference()
    gen = torch.Generator().manual_seed(0)
    w = _weights(ref, cfg, gen)
    args = driver.parse_args(argv + ["--data_shape", str(shape[-2])])
    with torch.device("meta"):
        model = driver.build_model(args, cfg["num_classes"],
                                   dtype=torch.float64)
    model = model.to_empty(device="cpu").double()
    model.load_state_dict(w, strict=True)
    x = inputs.prepare(torch.randint(0, 256, shape, dtype=torch.uint8,
                                     generator=gen)).double()
    with torch.no_grad():
        got, want = model.features(x), ref.features(w, x, cfg)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    trained = {n: p for n, p in model.named_parameters()}
    y = torch.arange(shape[0]) % cfg["num_classes"]
    loss = torch.nn.functional.cross_entropy(model(x, train=True).double(), y)
    g_prog = dict(zip(trained, torch.autograd.grad(loss,
                                                   list(trained.values()))))
    wr = {n: t.clone().requires_grad_(n in trained) for n, t in w.items()}
    loss_r = torch.nn.functional.cross_entropy(
        ref.logits(wr, x, cfg, train=True, remat=True), y)
    g_ref = torch.autograd.grad(loss_r, [wr[n] for n in trained])
    assert abs(float(loss) - float(loss_r)) <= 1e-6 * abs(float(loss_r))
    for (n, g), gr in zip(g_prog.items(), g_ref):
        scale = max(float(gr.norm()), 1e-12)
        assert float((g - gr).norm()) <= 1e-5 * scale, n


def test_reference_augment_matches_the_programs():
    from tennis_torch.data.transforms import device_augment
    from tennis_torch.parallel.train_step import step_generator

    gen = torch.Generator().manual_seed(1)
    u8 = torch.randint(0, 256, (8, 16, 16, 3), dtype=torch.uint8,
                       generator=gen)
    seed = 2 ** 31 + 5
    for step in (0, 1, 2):
        got = device_augment(u8, step_generator(seed, step, "cpu"),
                             torch.float32)
        want = inputs.augment(u8, seed, step)
        assert float((got - want).abs().max()) <= 1e-5


def test_reference_prepare_matches_the_programs():
    from tennis_torch.data.transforms import device_prepare

    u8 = torch.randint(0, 256, (2, 8, 8, 3), dtype=torch.uint8)
    assert torch.allclose(device_prepare(u8, torch.float32),
                          inputs.prepare(u8), atol=1e-6)
