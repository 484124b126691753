"""The port's tensor-parallel rule (``tennis_torch.parallel.sharding_rules``)
against ``tennis_tpu.parallel.sharding_rules`` on the CPU, leaf for leaf,
at model axes 1, 2 and 4 of the 8 virtual devices: the JAX test's four
leaves, the captioner at width 96 (10 leaves column-sharded) and at the
0102 widths (11 of 24), the CNN-RNN at H 128 over 512 features, and a
ResNet-18 ``FrameModel`` (none sharded); the optimizer state of the CNN-RNN
(SGD) and of the captioner (clip + Adam) against ``state_shardings``; the
World's grid positions against the JAX mesh, and both refusals' messages.
No collective runs here: the rule and the layout are host code."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tennis_torch.models import CNNRNN
from tennis_torch.models.gnmt import NMTModel, get_gnmt_encoder_decoder
from tennis_torch.ops.rnn import dense
from tennis_torch.parallel import distributed as D
from tennis_torch.parallel import sharding_rules as rules
from tennis_torch.parallel import train_step as ts
from tennis_torch.parallel.mesh import World, mesh_shape

AXES = (1, 2, 4)
DEVICES = 8  # tests/conftest.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_sharded(tree_shardings) -> set:
    """The flax paths (tuples) whose spec is column-sharded over model."""
    out = set()
    for path, s in jax.tree_util.tree_leaves_with_path(
            tree_shardings, is_leaf=lambda x: hasattr(x, "spec")):
        assert s.spec in (P(), P(None, "model")), s.spec
        if s.spec == P(None, "model"):
            out.add(tuple(str(getattr(k, "key", k)) for k in path))
    return out


def _port_sharded(world, model, min_tp_dim=256) -> set:
    sh = rules.param_shardings(world, model, min_tp_dim)
    for s in sh.values():
        assert s.block == (world.model_rank if s.sharded else 0)
    return {s.path for s in sh.values() if s.sharded}


def _check(jmodel_init, port_model, m, min_tp_dim=256):
    """The JAX rule on the JAX tree's shapes against the port's on its
    module, on every model rank's world; returns the sharded paths."""
    from tennis_tpu.parallel import make_mesh
    from tennis_tpu.parallel.sharding_rules import param_shardings

    mesh = make_mesh(num_data=DEVICES // m, num_model=m)
    params = jmodel_init()
    want = _jax_sharded(param_shardings(mesh, params, min_tp_dim))
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert n_leaves == len(list(port_model.parameters()))
    for r in range(m):
        world = World(rank=r, size=DEVICES, grouped=True, model_size=m)
        assert _port_sharded(world, port_model, min_tp_dim) == want
    return want, n_leaves


class _FourLeaves(torch.nn.Module):
    """tests/test_sharding_rules.py's tree as torch modules."""

    def __init__(self):
        super().__init__()
        self.wide = dense(128, 512)
        self.narrow = dense(16, 32, bias=False)
        self.odd = dense(128, 257, bias=False)
        self.conv = torch.nn.Conv2d(8, 512, 3, bias=False)


@pytest.mark.parametrize("m", AXES)
def test_the_jax_tests_four_leaves(m):
    def init():
        return {"wide": {"kernel": jnp.zeros((128, 512)),
                         "bias": jnp.zeros((512,))},
                "narrow": {"kernel": jnp.zeros((16, 32))},
                "odd": {"kernel": jnp.zeros((128, 257))},
                "conv": {"kernel": jnp.zeros((3, 3, 8, 512))}}

    want, _ = _check(init, _FourLeaves(), m)
    assert want == ({("wide", "kernel")} if m > 1 else set())


CAPTIONERS = {  # name: (features, hidden, embed, vocab, sharded at m > 1)
    "width96": (32, 96, 8, 30, 10),
    "0102": (4096, 256, 100, 254, 11),
}


def _captioners(name):
    from tennis_tpu.models.gnmt import NMTModel as JaxNMT
    from tennis_tpu.models.gnmt import get_gnmt_encoder_decoder as jax_ed

    feats, hidden, embed, vocab, _ = CAPTIONERS[name]
    enc, dec = jax_ed(hidden_size=hidden)
    jmodel = JaxNMT(vocab_size=vocab, encoder=enc, decoder=dec,
                    embed_size=embed)

    def init():
        return jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 3, feats)),
            jnp.zeros((1, 2), jnp.int32)))["params"]

    enc, dec = get_gnmt_encoder_decoder(hidden_size=hidden, input_size=feats,
                                        embed_size=embed)
    return init, NMTModel(vocab, enc, dec, embed_size=embed,
                          hidden_size=hidden)


@pytest.mark.parametrize("m", AXES)
@pytest.mark.parametrize("name", sorted(CAPTIONERS))
def test_captioner_leaves(name, m):
    init, model = _captioners(name)
    want, n_leaves = _check(init, model, m)
    assert n_leaves == 24
    assert len(want) == (CAPTIONERS[name][-1] if m > 1 else 0)
    if name == "0102" and m > 1:
        assert ("decoder", "step", "attention", "query_proj", "kernel") in want
        assert ("encoder", "rnn0", "fwd", "i2h", "kernel") in want
        assert not any(p[0] in ("tgt_proj", "tgt_embed") for p in want)


def _cnnrnn():
    from tennis_tpu.models import CNNRNN as JaxCNNRNN

    jmodel = JaxCNNRNN(model=None, num_classes=4, hidden_size=128,
                       dtype=jnp.float32)
    port = CNNRNN(None, 4, hidden_size=128, dtype=torch.float32,
                  feature_dim=512)
    return jmodel, port


@pytest.mark.parametrize("m", AXES)
def test_cnnrnn_leaves(m):
    jmodel, port = _cnnrnn()

    def init():
        return jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((4, 3, 512)), train=True)
        )["params"]

    want, _ = _check(init, port, m)
    assert len(want) == (4 if m > 1 else 0)  # i2h, h2h of fwd and bwd


@pytest.mark.parametrize("m", AXES)
def test_resnet18_frame_model_has_no_sharded_leaf(m):
    from tennis_torch.inference import build_frame_model
    from tennis_tpu.models import FrameModel, get_backbone

    jmodel = FrameModel(get_backbone("resnet18_v2", dtype=jnp.float32),
                        num_classes=11, dtype=jnp.float32)

    def init():
        return jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
            train=True))["params"]

    port = build_frame_model("resnet18_v2", 11, 32, dtype=torch.float32)
    want, _ = _check(init, port, m)
    assert want == set()


def _jax_opt_sharded(state_sh, marker) -> set:
    """Paths of the optimizer leaves under ``marker`` (trace, mu, nu)
    that the JAX rule column-shards, as the parameter's flax path."""
    out = set()
    for path, s in jax.tree_util.tree_leaves_with_path(
            state_sh.opt_state, is_leaf=lambda x: hasattr(x, "spec")):
        keys = [str(getattr(k, "key", getattr(k, "name", k))) for k in path]
        if marker in keys and s.spec == P(None, "model"):
            out.add(tuple(keys[keys.index(marker) + 1:]))
    return out


def _port_opt_sharded(world, state, marker) -> set:
    sh = rules.state_shardings(world, state)
    assert all(not s.sharded for s in sh["batch_stats"].values())
    return {s.path for s in sh["opt_state"][marker].values() if s.sharded}


@pytest.mark.parametrize("m", AXES)
def test_sgd_trace_follows_its_parameter(m):
    from tennis_tpu.parallel import create_train_state, make_mesh
    from tennis_tpu.parallel import sgd_with_schedule as jax_sgd
    from tennis_tpu.parallel.sharding_rules import state_shardings

    jmodel, port = _cnnrnn()
    mesh = make_mesh(num_data=DEVICES // m, num_model=m)
    tx, _ = jax_sgd(0.1)
    jstate = jax.eval_shape(lambda: create_train_state(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((4, 3, 512)), tx,
        {"train": True}))
    want = _jax_opt_sharded(state_shardings(mesh, jstate), "trace")
    world = World(rank=m - 1, size=DEVICES, grouped=True, model_size=m)
    state = ts.create_train_state(port, ts.sgd_with_schedule(0.1)[0])
    assert _port_opt_sharded(world, state, "trace") == want
    assert len(want) == (4 if m > 1 else 0)


@pytest.mark.parametrize("m", AXES)
def test_adam_moments_follow_their_parameter(m):
    from flax.training import train_state
    from tennis_tpu.parallel import make_mesh
    from tennis_tpu.parallel.sharding_rules import state_shardings

    init, port = _captioners("0102")
    opt = optax.inject_hyperparams(lambda learning_rate: optax.chain(
        optax.clip_by_global_norm(5.0), optax.adam(learning_rate)))(1e-3)

    class State(train_state.TrainState):
        batch_stats: dict = None

    jstate = jax.eval_shape(lambda: State.create(
        apply_fn=None, params=jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), init()), tx=opt,
        batch_stats={}))
    mesh = make_mesh(num_data=DEVICES // m, num_model=m)
    jsh = state_shardings(mesh, jstate)
    world = World(rank=0, size=DEVICES, grouped=True, model_size=m)
    state = ts.create_seq2seq_state(port, ts.adam_with_clip(5.0), 1e-3)
    for marker in ("mu", "nu"):
        want = _jax_opt_sharded(jsh, marker)
        assert _port_opt_sharded(world, state, marker) == want
        assert len(want) == (11 if m > 1 else 0)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_world_coordinates_are_the_jax_grid_positions(shape):
    from tennis_tpu.parallel import make_mesh

    d, m = shape
    mesh = make_mesh(num_data=d, num_model=m)
    grid = np.vectorize(lambda dev: dev.id)(mesh.devices)
    ids = [dev.id for dev in jax.devices()]
    for r in range(d * m):
        world = World(rank=r, size=d * m, grouped=True, model_size=m)
        (pos,) = np.argwhere(grid == ids[r])
        assert (world.data_rank, world.model_rank) == tuple(pos)
        assert world.data_size == d
        assert world.model_group_ranks() == [ids.index(i)
                                             for i in grid[pos[0]]]
        assert world.data_group_ranks() == [ids.index(i)
                                            for i in grid[:, pos[1]]]


def test_mesh_refusals_give_the_jax_messages(monkeypatch):
    from tennis_tpu.parallel import make_mesh

    with pytest.raises(ValueError) as want:
        make_mesh(num_data=16, num_model=1)
    with pytest.raises(ValueError) as got:
        mesh_shape(16, 1, DEVICES)
    assert str(got.value) == str(want.value)
    assert mesh_shape(None, 2, DEVICES) == (4, 2)
    assert not D.grouped()
    with pytest.raises(ValueError, match=r"^mesh wants 4 devices \(2x2\), "
                                         r"have 1$"):
        D.make_mesh(2, 2)
    # the JAX make_pod_mesh's refusal (tennis_tpu/parallel/distributed.py,
    # reached on several hosts), met by a rank of two hosts of 8
    monkeypatch.setattr(D, "grouped", lambda: True)
    monkeypatch.setattr(D.dist, "get_world_size", lambda *a, **k: 16)
    with pytest.raises(ValueError) as got:
        D.make_pod_mesh(3, num_local=8)
    assert str(got.value) == "num_model=3 must divide local device count 8"


def test_place_blocks_takes_the_rules_leaves_and_refuses_others():
    """Without a model axis the rule places nothing; a named leaf that is
    not a ``Dense`` weight is refused."""
    _, model = _captioners("width96")
    assert rules.place_blocks(model, World()) == []
    assert rules.block_worlds(model) == {}
    with pytest.raises(ValueError, match="no column-parallel forward"):
        rules.place_blocks(model, World(), ["tgt_embed.weight"])
