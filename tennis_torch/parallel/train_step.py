"""The classifier's train step (counterpart of
``tennis_tpu/parallel/train_step.py``): SGD with momentum, weight decay and
the epoch step schedule, the softmax cross-entropy, and a step that runs
the augment, the train-mode forward and backward and the update in place.

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
    """The trained model, its optimizer and the step count. ``trained``
    names the parameters the optimizer updates: all of them, or under
    ``freeze_backbone`` all but the backbone's."""
    model: torch.nn.Module
    tx: SGD
    opt_state: SGDState
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
