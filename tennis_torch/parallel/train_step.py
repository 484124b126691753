"""The train steps (counterpart of ``tennis_tpu/parallel/train_step.py``):
for the classifier, SGD with momentum, weight decay and the epoch step
schedule, the softmax cross-entropy, and a step that runs the augment, the
train-mode forward and backward and the update in place; for the captioner,
Adam with global-norm clipping under an injected learning rate
(:func:`adam_with_clip`) and the seq2seq step
(:func:`make_seq2seq_train_step`), with the pixels path's backbone and its
``--freeze_backbone``.

The update is optax's ``chain(add_decayed_weights(wd), sgd(schedule,
momentum))`` op for op, in f32: ``g += wd p`` on every trained parameter,
``trace = g + m trace`` (zero at start), ``p += -lr(k) trace``, with
``lr(k) = lr * factor ** #{boundaries <= k}`` (boundaries at ``epoch *
steps_per_epoch``, optax's ``piecewise_constant_schedule``) and ``k`` the
optimizer's update count. Under ``freeze_backbone`` every parameter with a
``backbone`` component in its name (``backbone.*``, a clip CNN-RNN's
``model.backbone.*``; none of a two-stream net's, as in the JAX rule) gets
no update, no weight decay and no trace (optax's ``multi_transform`` with
``set_to_zero``), while its BN still runs in train mode and moves its
running statistics, as the JAX step does.

Under a model axis (``world`` given to :func:`create_train_state` or
:func:`create_seq2seq_state`, the counterpart of the JAX
``create_train_state(mesh=)`` with ``state_shardings``) the rule's
kernels are placed as column blocks (``sharding_rules.place_blocks``)
before the optimizer state is made, so each trace and moment is a block
where its parameter is; the gradients are averaged over the data axis
only (the model ranks of a data index hold the same rows), the rows and
draws follow the data index, and the clip's global norm sums the squares
of each sharded gradient's blocks over the model group and counts each
whole gradient once.

The captioner's ``--freeze_backbone`` is the JAX driver's
``chain(masked(set_to_zero, src_embed), clip, adam)``: the ``src_embed``
gradients are zero before the global-norm clip, so they leave the norm,
their Adam moments stay zero and their update is zero, while the counts
advance. Here the frozen parameters are left out of the update (the same
result, bit for bit: the parameters do not change) and their backward is
not run; the backbone still runs its train-mode forward and moves its
running statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from tennis_torch.parallel.distributed import current_world, data_group, \
    model_group
from tennis_torch.parallel.mesh import World
from tennis_torch.parallel.sharding_rules import block_worlds, place_blocks
from tennis_torch.utils.tracing import span


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: dict | None = None):
    """``count -> lr``, scaled by each factor whose boundary ``count`` has
    reached, multiplied in f32 in the order of the boundaries as optax
    does."""
    items = sorted((boundaries_and_scales or {}).items())

    def schedule(count: int) -> float:
        v = np.float32(init_value)
        for boundary, scale in items:
            if count >= boundary:
                v = np.float32(np.float32(scale) * v)
        return float(v)

    return schedule


@dataclasses.dataclass
class SGDState:
    """Momentum traces by parameter name, and the number of updates made."""
    trace: dict
    count: int = 0


@dataclasses.dataclass(frozen=True)
class SGD:
    schedule: Callable[[int], float]
    momentum: float
    weight_decay: float

    def init(self, params: dict) -> SGDState:
        return SGDState({n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: SGDState) -> None:
        """One step in place over ``params`` (name -> parameter)."""
        names = list(params)
        ps = [params[n] for n in names]
        traces = [state.trace[n] for n in names]
        g = torch._foreach_mul(ps, self.weight_decay)
        torch._foreach_add_(g, [grads[n] for n in names])
        torch._foreach_mul_(traces, self.momentum)
        torch._foreach_add_(traces, g)
        torch._foreach_add_(ps, torch._foreach_mul(
            traces, -self.schedule(state.count)))
        state.count += 1


def sgd_with_schedule(lr: float, momentum: float = 0.9,
                      weight_decay: float = 1e-4, lr_steps=(),
                      lr_factor: float = 0.75, steps_per_epoch: int = 1):
    """SGD + momentum + weight decay with the epoch step schedule: lr *=
    factor at each epoch in ``lr_steps``. Returns ``(tx, schedule)``."""
    boundaries = {int(e) * steps_per_epoch: lr_factor for e in lr_steps}
    schedule = piecewise_constant_schedule(lr, boundaries)
    return SGD(schedule, momentum, weight_decay), schedule


@dataclasses.dataclass
class TrainState:
    """The trained model, its optimizer (``SGD`` for the classifier,
    ``ClippedOptimizer`` for the captioner) and its state, and the step
    count. ``trained`` names the parameters the optimizer updates: all of
    them, or under ``freeze_backbone`` those with no ``frozen`` component
    in their name (the JAX drivers' path rules: ``backbone`` for the
    classifier, ``src_embed`` for the captioner)."""
    model: torch.nn.Module
    tx: object
    opt_state: object
    step: int = 0
    freeze_backbone: bool = False
    frozen: str = "backbone"

    @property
    def trained(self) -> dict:
        return {n: p for n, p in self.model.named_parameters()
                if not (self.freeze_backbone
                        and self.frozen in n.split("."))}


def _place(model: torch.nn.Module, world: World | None) -> None:
    if world is not None:
        place_blocks(model, world)


def create_train_state(model: torch.nn.Module, tx: SGD,
                       freeze_backbone: bool = False,
                       world: World | None = None) -> TrainState:
    """The classifier's train state; with ``world``, its parameters
    placed by the sharding rule first (the JAX ``mesh=``)."""
    _place(model, world)
    state = TrainState(model, tx, None, 0, freeze_backbone)
    state.opt_state = tx.init(state.trained)
    return state


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of integer labels, on f32 logits."""
    return F.cross_entropy(logits.float(), labels.long())


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)``: a resumed run
    draws the same augment at the same step, as the JAX step's
    ``fold_in(PRNGKey(seed), step)`` does."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(mixed[0]) << 32 | int(mixed[1]))


BUCKET_BYTES = 32 << 20  # gradient bytes per all-reduce


def all_reduce_mean(grads: list, world: World, loss: torch.Tensor):
    """The gradients and the loss averaged over the data axis: summed over
    this rank's data group in flat buckets of up to ``BUCKET_BYTES`` per
    dtype (the loss rides in the first f32 one), then divided by the data
    size. A sharded gradient is this rank's block, averaged with the same
    block of every data index. Returns ``(grads, loss)``; without a
    process group, as given."""
    if not world.grouped:
        return grads, loss
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    group = data_group(world)
    items = [loss.detach().reshape(1).float()] + list(grads)
    out = [None] * len(items)
    by_dtype: dict = {}
    for i, t in enumerate(items):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        bucket, size = [], 0
        for j, i in enumerate(idx):
            bucket.append(i)
            size += items[i].numel() * items[i].element_size()
            if size >= BUCKET_BYTES or j == len(idx) - 1:
                tensors = [items[k] for k in bucket]
                flat = _flatten_dense_tensors(tensors)
                dist.all_reduce(flat, group=group)
                flat.div_(world.data_size)
                for k, t in zip(bucket, _unflatten_dense_tensors(flat,
                                                                 tensors)):
                    out[k] = t
                bucket, size = [], 0
    return out[1:], out[0][0].to(loss.dtype)


def stripe_rows(world: World, n_local: int, device) -> tuple | None:
    """Where this rank's rows sit in the global batch, as the loader
    striped over the data axis deals them: ``(global batch, positions)``,
    position ``data index + i * data size`` for local row i; None without
    a process group. A preprocess draws its per-row randomness for the
    global batch and takes these rows, so that a sample gets the draw of
    its single-process row (and the model ranks of a data index draw
    alike)."""
    if not world.grouped:
        return None
    pos = world.data_rank + world.data_size * torch.arange(n_local,
                                                           device=device)
    return world.data_size * n_local, pos


def make_train_step(state: TrainState, preprocess: Callable | None = None,
                    rng_seed: int = 0, loss_fn: Callable = softmax_ce):
    """``step(images, labels) -> (loss, logits)``, both detached on the
    model's device: ``preprocess(images, generator)`` (the generator from
    ``(rng_seed, state.step)``; under a process group also ``rows``, from
    :func:`stripe_rows`),
    the train-mode forward, the loss, the gradients of the trained
    parameters, the update; the parameters, BN buffers, optimizer state and
    ``state.step`` change in place.

    Under a process group (read at each call, as the BN function reads
    it) the images are this rank's rows of the global batch: the BN
    statistics are the global batch's (the BN function all-reduces them),
    the gradients and the loss are averaged over the ranks before the
    update (:func:`all_reduce_mean`), so every rank makes the
    single-process update of the global batch; the logits stay this
    rank's.

    Each phase is a span of :mod:`tennis_torch.utils.tracing`:
    ``train_step`` around ``augment``, ``forward``, ``loss``,
    ``backward``, ``grad_all_reduce`` and ``update``."""
    model = state.model

    def step(images: torch.Tensor, labels) -> tuple:
        with span("train_step"):
            world = current_world()
            images = torch.as_tensor(images)
            labels = torch.as_tensor(labels, device=images.device)
            if preprocess is not None:
                with span("augment"):
                    generator = step_generator(rng_seed, state.step,
                                               images.device)
                    rows = stripe_rows(world, images.shape[0], images.device)
                    images = preprocess(images, generator) if rows is None \
                        else preprocess(images, generator, rows)
            model.train()
            with span("forward"):
                logits = model(images, train=True)
            with span("loss"):
                loss = loss_fn(logits, labels)
            trained = state.trained
            with span("backward"):
                grads = torch.autograd.grad(loss, list(trained.values()))
            with span("grad_all_reduce"):
                grads, loss = all_reduce_mean(list(grads), world, loss)
            with span("update"):
                state.tx.update(trained, dict(zip(trained, grads)),
                                state.opt_state)
            state.step += 1
            return loss.detach(), logits.detach()

    return step


@dataclasses.dataclass
class AdamState:
    """Adam's moments by parameter name and its update count (optax's
    ``ScaleByAdamState``)."""
    mu: dict
    nu: dict
    count: int = 0


@dataclasses.dataclass
class InjectState:
    """optax's ``inject_hyperparams`` state around ``chain(clip, adam|sgd)``:
    the learning rate (an f32 value; the driver may set it between steps),
    the chain's Adam state (None for plain SGD, which keeps none) and the
    number of updates made."""
    learning_rate: float
    inner: AdamState | None
    count: int = 0


@dataclasses.dataclass(frozen=True)
class ClippedOptimizer:
    """``inject_hyperparams(chain(clip_by_global_norm(clip), adam(lr) or
    sgd(lr)))`` of optax, op for op in f32: the gradients scaled by ``clip /
    |g|`` (global L2 norm) where that norm reaches ``clip``; then Adam (b1
    0.9, b2 0.999, eps 1e-8, bias-corrected moments) and ``-lr``, or plain
    ``-lr`` for ``optimizer="sgd"``; then added to the parameters."""
    clip: float
    optimizer: str = "adam"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: dict, learning_rate: float) -> InjectState:
        inner = None
        if self.optimizer == "adam":
            inner = AdamState({n: torch.zeros_like(p) for n, p in params.items()},
                              {n: torch.zeros_like(p) for n, p in params.items()})
        return InjectState(float(np.float32(learning_rate)), inner)

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: InjectState,
               blocks: dict | None = None) -> None:
        """One step in place over ``params`` (name -> parameter); no host
        synchronisation. ``blocks`` names the column-sharded parameters
        (name -> model world, ``sharding_rules.block_worlds``): each
        gradient's norm is then its blocks' over the model group."""
        names = list(params)
        ps = [params[n] for n in names]
        g = [grads[n].clone() for n in names]
        norms = list(torch._foreach_norm(g))
        sharded = [i for i, n in enumerate(names) if n in (blocks or {})]
        if sharded:
            sq = torch.stack([norms[i] for i in sharded]) ** 2
            torch.distributed.all_reduce(
                sq, group=model_group(blocks[names[sharded[0]]]))
            for i, v in zip(sharded, sq.sqrt()):
                norms[i] = v
        norm = torch.linalg.vector_norm(torch.stack(norms))
        # optax: select(|g| < clip, g, (g / |g|) * clip)
        inside = norm < self.clip
        one = torch.ones((), device=norm.device)
        div = torch.where(inside, one, norm)
        mul = torch.where(inside, one, torch.full_like(norm, self.clip))
        for t in g:
            t.div_(div).mul_(mul)
        if state.inner is not None:
            adam = state.inner
            mu = [adam.mu[n] for n in names]
            nu = [adam.nu[n] for n in names]
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_add_(nu, torch._foreach_mul(g, g),
                                alpha=1.0 - self.b2)
            adam.count += 1
            bc1 = float(1 - np.float32(self.b1) ** np.float32(adam.count))
            bc2 = float(1 - np.float32(self.b2) ** np.float32(adam.count))
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            g = torch._foreach_div(mu, bc1)
            torch._foreach_div_(g, denom)
        torch._foreach_mul_(g, -float(np.float32(state.learning_rate)))
        torch._foreach_add_(ps, g)
        state.count += 1


def adam_with_clip(clip: float = 5.0, optimizer: str = "adam"):
    """The captioner's optimizer: global-norm clipping, then Adam, or plain
    SGD for any other ``optimizer``, as the JAX driver chooses. The learning
    rate is the state's (``create_seq2seq_state``), where the driver can
    change it."""
    return ClippedOptimizer(float(clip), "adam" if optimizer == "adam"
                            else "sgd")


def create_seq2seq_state(model: torch.nn.Module, tx: ClippedOptimizer,
                         learning_rate: float,
                         freeze_backbone: bool = False,
                         world: World | None = None) -> TrainState:
    """A captioner's train state at ``learning_rate``: every parameter
    trained, or under ``freeze_backbone`` all but ``src_embed``'s. The
    optimizer state covers every parameter (a frozen one's Adam moments
    stay zero), as the JAX driver's does. With ``world`` the parameters
    are placed by the sharding rule first."""
    _place(model, world)
    state = TrainState(model, tx, None, 0, freeze_backbone, "src_embed")
    state.opt_state = tx.init(dict(model.named_parameters()), learning_rate)
    return state


def rank_seed(seed: int, world: World) -> int:
    """The host seed of this rank's dropout and augment draws: the step's
    seed on data index 0 (and without a group), one mixed from ``(seed,
    data index)`` on the others, so that no two data indices draw the same
    masks and the model ranks of one draw alike (else their replicated
    weights drift apart)."""
    if world.data_rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), world.data_rank])
               .generate_state(1, np.uint32)[0])


def make_seq2seq_train_step(state: TrainState, loss_fn: Callable):
    """``step(src, tgt, src_vl, tgt_vl, seed) -> loss`` (detached, on the
    model's device) for the captioner: the train-mode forward of ``model(src,
    tgt[:, :-1], src_vl, tgt_vl - 1)`` with its dropout masks drawn from a
    generator seeded with ``seed`` (a host draw, as the JAX step takes one)
    and, for uint8 frames, its augment draws from another generator seeded
    from ``seed`` (the JAX step splits its key into a dropout and an augment
    stream), ``loss_fn(logits, tgt[:, 1:], tgt_vl - 1)``, the gradients of
    the trained parameters (under ``freeze_backbone`` the backbone's
    backward is not run), and the update in place; the backbone's running
    statistics move in the forward; ``state.step`` counts the steps.

    Under a process group (read at each call) the arrays are this rank's contiguous
    rows of the global batch, padded to the global batch's lengths (so that
    ``average="padded"`` divides by the global T); the gradients and the
    loss are averaged over the ranks before the clip and the update
    (:func:`all_reduce_mean`), the backbone's BN statistics are the global
    batch's, and the dropout masks and augment draws come from
    :func:`rank_seed`, each rank drawing for its own rows."""
    model = state.model
    blocks = block_worlds(model)  # placed with the state, before the step

    def step(src, tgt, src_vl, tgt_vl, seed) -> torch.Tensor:
        world = current_world()
        src = torch.as_tensor(src)
        dev = src.device
        tgt, src_vl, tgt_vl = (torch.as_tensor(x).to(dev)
                               for x in (tgt, src_vl, tgt_vl))
        model.train()
        seed = rank_seed(seed, world)
        generator = torch.Generator(device=dev).manual_seed(int(seed))
        augment = step_generator(int(seed), 1, dev) \
            if src.dtype == torch.uint8 else None
        logits = model(src, tgt[:, :-1], src_vl, tgt_vl - 1,
                       generator=generator, augment=augment,
                       src_grad=not state.freeze_backbone)
        loss = loss_fn(logits, tgt[:, 1:], tgt_vl - 1)
        trained = state.trained
        grads = torch.autograd.grad(loss, list(trained.values()))
        grads, loss = all_reduce_mean(list(grads), world, loss)
        state.tx.update(trained, dict(zip(trained, grads)), state.opt_state,
                        blocks)
        state.step += 1
        return loss.detach()

    return step
