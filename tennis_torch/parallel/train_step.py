"""The train steps (counterpart of ``tennis_tpu/parallel/train_step.py``):
for the classifier, SGD with momentum, weight decay and the epoch step
schedule, the softmax cross-entropy, and a step that runs the augment, the
train-mode forward and backward and the update in place; for the captioner,
Adam with global-norm clipping under an injected learning rate
(:func:`adam_with_clip`) and the seq2seq step
(:func:`make_seq2seq_train_step`).

The update is optax's ``chain(add_decayed_weights(wd), sgd(schedule,
momentum))`` op for op, in f32: ``g += wd p`` on every trained parameter,
``trace = g + m trace`` (zero at start), ``p += -lr(k) trace``, with
``lr(k) = lr * factor ** #{boundaries <= k}`` (boundaries at ``epoch *
steps_per_epoch``, optax's ``piecewise_constant_schedule``) and ``k`` the
optimizer's update count. Under ``freeze_backbone`` the backbone's
parameters get no update, no weight decay and no trace (optax's
``multi_transform`` with ``set_to_zero``), while its BN still runs in train
mode and moves its running statistics, as the JAX step does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


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
    them, or under ``freeze_backbone`` all but the backbone's."""
    model: torch.nn.Module
    tx: object
    opt_state: object
    step: int = 0
    freeze_backbone: bool = False

    @property
    def trained(self) -> dict:
        return {n: p for n, p in self.model.named_parameters()
                if not (self.freeze_backbone and n.startswith("backbone."))}


def create_train_state(model: torch.nn.Module, tx: SGD,
                       freeze_backbone: bool = False) -> TrainState:
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


def make_train_step(state: TrainState, preprocess: Callable | None = None,
                    rng_seed: int = 0, loss_fn: Callable = softmax_ce):
    """``step(images, labels) -> (loss, logits)``, both detached on the
    model's device: ``preprocess(images, generator)`` (the generator from
    ``(rng_seed, state.step)``), the train-mode forward, the loss, the
    gradients of the trained parameters, the update; the parameters, BN
    buffers, optimizer state and ``state.step`` change in place."""
    model = state.model

    def step(images: torch.Tensor, labels) -> tuple:
        images = torch.as_tensor(images)
        labels = torch.as_tensor(labels, device=images.device)
        if preprocess is not None:
            images = preprocess(images, step_generator(rng_seed, state.step,
                                                       images.device))
        model.train()
        logits = model(images, train=True)
        loss = loss_fn(logits, labels)
        trained = state.trained
        grads = torch.autograd.grad(loss, list(trained.values()))
        state.tx.update(trained, dict(zip(trained, grads)), state.opt_state)
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
    def update(self, params: dict, grads: dict, state: InjectState) -> None:
        """One step in place over ``params`` (name -> parameter); no host
        synchronisation."""
        names = list(params)
        ps = [params[n] for n in names]
        g = [grads[n].clone() for n in names]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
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
                         learning_rate: float) -> TrainState:
    """A captioner's train state: every parameter trained, the optimizer
    state at ``learning_rate``."""
    state = TrainState(model, tx, None)
    state.opt_state = tx.init(state.trained, learning_rate)
    return state


def make_seq2seq_train_step(state: TrainState, loss_fn: Callable):
    """``step(src, tgt, src_vl, tgt_vl, seed) -> loss`` (detached, on the
    model's device) for the captioner: the train-mode forward of ``model(src,
    tgt[:, :-1], src_vl, tgt_vl - 1)`` with its dropout masks drawn from a
    generator seeded with ``seed`` (a host draw, as the JAX step takes one),
    ``loss_fn(logits, tgt[:, 1:], tgt_vl - 1)``, the gradients of every
    parameter, and the update in place; ``state.step`` counts the steps."""
    model = state.model

    def step(src, tgt, src_vl, tgt_vl, seed) -> torch.Tensor:
        src = torch.as_tensor(src)
        dev = src.device
        tgt, src_vl, tgt_vl = (torch.as_tensor(x).to(dev)
                               for x in (tgt, src_vl, tgt_vl))
        model.train()
        generator = torch.Generator(device=dev).manual_seed(int(seed))
        logits = model(src, tgt[:, :-1], src_vl, tgt_vl - 1,
                       generator=generator)
        loss = loss_fn(logits, tgt[:, 1:], tgt_vl - 1)
        trained = state.trained
        grads = torch.autograd.grad(loss, list(trained.values()))
        state.tx.update(trained, dict(zip(trained, grads)), state.opt_state)
        state.step += 1
        return loss.detach()

    return step
