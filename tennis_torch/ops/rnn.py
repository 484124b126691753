"""Recurrent cells and layers (counterpart of ``tennis_tpu/ops/rnn.py``).

cuDNN/MXNet gate conventions (GRU r, z, n; LSTM i, f, g, o), fused gate
projections, and masked carries: past ``valid_length`` the state freezes and
outputs are zero; a reverse layer reverses only the first ``valid_length``
steps. Parameter names follow the flax tree so the bridge maps them 1:1:
cells hold ``i2h``/``h2h``; :class:`RNNLayer` holds ``i2h`` and
``recurrence.h2h``.

:class:`RNNLayer` hoists the input projection of the whole sequence into one
matmul. Then, as in the JAX package, the recurrence takes one of two paths:

- inside :func:`gru_decode` (the counterpart of the JAX ``pallas_gru``
  context, which the translator sets around its decode), a GRU layer runs
  :func:`tennis_torch.ops.gru.gru_recurrence`: the forward-only CUDA kernel
  for tensors on the card (the async kernel where it takes H, the grid one
  where the general one would stream Wh, the general one at every other H
  up to 1023), its plain version on the CPU; a shape
  that no card kernel takes and past the JAX kernel's budget (H >= 1024,
  ``ops.gru.gru_decode_route``) runs the plain recurrence below, as the
  JAX package runs its scan there, and counts in
  ``gru_recurrence.plain_routed``. A gradient there raises, on either
  device;
- everywhere else (training, the per-epoch loss, every LSTM) a plain
  differentiable per-step recurrence, the counterpart of the JAX
  ``_RecurrentStep`` scan, which autograd goes through; under
  ``torch.export`` a GRU's runs the same steps as one ``while_loop``.

The context decides the path; no path catches a kernel failure.

Under a model axis (``parallel.sharding_rules.place_blocks``) a
:class:`Dense` may hold a column block of its flax kernel (a block of
weight rows) and runs column-parallel (:func:`column_parallel`): this
rank's columns of the product, all-gathered over the model group, then the
whole bias. A recurrence takes its ``h2h`` kernel whole instead, gathered
once a layer (:func:`whole_weight`), the plain recurrence in training and
the GRU kernels in decode alike, as GSPMD hands the Pallas call a gathered
operand; its backward keeps this rank's block of the whole ``dWh``.

:class:`RNNLayer` and :class:`BiRNN` compute in a ``dtype`` (f32 by
default, the GNMT's), with f32 parameters: in another dtype (the CNN-RNN's
bf16) the rounding points are the flax modules', i.e. each projection's
product and then its bias sum rounded to the dtype (``Dense(dtype)``), the
carry and every gate op in the dtype.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
from torch import nn

from tennis_torch.ops import gru as gru_ops
from tennis_torch.ops.gru import gru_recurrence
from tennis_torch.ops.masking import reverse_sequence, sequence_mask
from tennis_torch.parallel.distributed import gather_blocks, to_model

LSTM_FORGET_BIAS = 1.0  # added at run time (reference gnmt.py:410)

_GRU_DECODE = contextvars.ContextVar("gru_decode", default=False)


@contextlib.contextmanager
def gru_decode(enabled: bool = True):
    """Within this context :class:`RNNLayer` runs a GRU's recurrence through
    ``gru_recurrence`` (the CUDA kernel on the card): forward only, so no
    gradient may be required inside it. Off by default."""
    token = _GRU_DECODE.set(enabled)
    try:
        yield
    finally:
        _GRU_DECODE.reset(token)


def column_parallel(x, weight, bias, world, dtype=None):
    """``x @ W^T + b`` from this rank's block of ``W``'s rows: the local
    product, its columns all-gathered over the model group (whose backward
    keeps this rank's columns of the gradient), then the whole bias. ``x``
    enters through ``to_model``, so that its gradient sums the blocks'
    parts. In ``dtype`` (other than f32) the product and the bias sum are
    rounded to it, as :func:`_affine` rounds them."""
    x = to_model(x, world)
    if dtype is None:
        y = torch.nn.functional.linear(x, weight)
    elif dtype == torch.float32:
        y = torch.nn.functional.linear(x.float(), weight)
    else:
        y = x.to(dtype) @ weight.t().to(dtype)
        bias = None if bias is None else bias.to(dtype)
    y = gather_blocks(y, world, -1)
    return y if bias is None else y + bias


class Dense(nn.Linear):
    """``nn.Linear`` that may hold a column block of its flax kernel:
    ``tp_world`` is None (the weight whole, ``nn.Linear``'s forward) or
    the model world whose ranks hold its blocks of rows
    (:func:`column_parallel`). ``out_features`` stays the whole width."""
    tp_world = None

    def forward(self, x):
        if self.tp_world is None:
            return super().forward(x)
        return column_parallel(x, self.weight, self.bias, self.tp_world)


def dense(in_features: int, out_features: int, bias: bool = True,
          generator: torch.Generator | None = None) -> Dense:
    """flax ``nn.Dense`` initialisation: lecun-normal kernel, zero bias."""
    from tennis_torch.models.backbones.densenet import lecun_normal_

    layer = Dense(in_features, out_features, bias=bias)
    lecun_normal_(layer.weight, in_features, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def whole_weight(layer: nn.Linear) -> torch.Tensor:
    """``layer``'s weight whole: a column-sharded one's blocks gathered
    over the model group, whose backward keeps this rank's block of the
    gradient (no sum over the group: each model rank computed the whole
    gradient alike)."""
    world = getattr(layer, "tp_world", None)
    if world is None:
        return layer.weight
    return gather_blocks(layer.weight, world, 0)


def _affine(layer: nn.Linear, dtype, whole: bool = False):
    """``x -> layer(x)`` in ``dtype``: in f32 as ``nn.Linear`` computes it;
    in another dtype as flax's ``Dense(dtype, param_dtype=f32)`` rounds it,
    the product rounded to the dtype and then the bias sum. A
    column-sharded layer runs column-parallel, or with ``whole`` (a
    recurrence's ``h2h``, applied every step) on its weight gathered
    once."""
    world = getattr(layer, "tp_world", None)
    if world is not None and not whole:
        return lambda x: column_parallel(x, layer.weight, layer.bias, world,
                                         dtype)
    if dtype == torch.float32:
        if world is None:
            return lambda x: layer(x.float())
        w = whole_weight(layer)
        return lambda x: torch.nn.functional.linear(x.float(), w, layer.bias)
    w, b = whole_weight(layer).t().to(dtype), layer.bias.to(dtype)
    return lambda x: x.to(dtype) @ w + b


def _gru_gates(gx, gh, h):
    xr, xz, xn = gx.chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def _lstm_gates(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    new_c = (torch.sigmoid(f + LSTM_FORGET_BIAS) * c
             + torch.sigmoid(i) * torch.tanh(g))
    return torch.sigmoid(o) * torch.tanh(new_c), new_c


class GRUCell(nn.Module):
    """cuDNN-convention GRU: ``n = tanh(Wx_n x + b_n + r * (Wh_n h + c_n))``,
    ``h' = (1-z) n + z h``. ``forward(h, x) -> (h', h')``."""

    def __init__(self, input_size: int, hidden_size: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.i2h = dense(input_size, 3 * hidden_size, generator=generator)
        self.h2h = dense(hidden_size, 3 * hidden_size, generator=generator)

    def initialize_carry(self, batch_size: int, device=None):
        return torch.zeros(batch_size, self.hidden_size, device=device)

    def forward(self, h, x):
        new_h = _gru_gates(self.i2h(x), self.h2h(h), h)
        return new_h, new_h


class LSTMCell(nn.Module):
    """cuDNN-convention LSTM (gates i, f, g, o) with the forget-gate bias
    added at run time. ``forward((h, c), x) -> ((h', c'), h')``."""

    def __init__(self, input_size: int, hidden_size: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.i2h = dense(input_size, 4 * hidden_size, generator=generator)
        self.h2h = dense(hidden_size, 4 * hidden_size, generator=generator)

    def initialize_carry(self, batch_size: int, device=None):
        z = torch.zeros(batch_size, self.hidden_size, device=device)
        return z, z

    def forward(self, carry, x):
        h, c = carry
        new_h, new_c = _lstm_gates(self.i2h(x) + self.h2h(h), c)
        return (new_h, new_c), new_h


def make_cell(cell_type: str, input_size: int, hidden_size: int,
              generator: torch.Generator | None = None) -> nn.Module:
    if cell_type == "gru":
        return GRUCell(input_size, hidden_size, generator)
    if cell_type == "lstm":
        return LSTMCell(input_size, hidden_size, generator)
    raise ValueError(f"unknown cell type {cell_type!r} (want 'gru' or 'lstm')")


def _lstm_recurrence(gates_x, h2h, carry, valid_length):
    """Plain LSTM loop over (T, B, 4H) input gates with masked carries;
    ``h2h`` maps the carry to its gates."""
    h, c = carry
    ys = []
    for t in range(gates_x.shape[0]):
        new_h, new_c = _lstm_gates(gates_x[t] + h2h(h), c)
        alive = (t < valid_length)[:, None]
        h = torch.where(alive, new_h, h)
        c = torch.where(alive, new_c, c)
        ys.append(torch.where(alive, new_h, torch.zeros_like(new_h)))
    return torch.stack(ys), (h, c)


def _gru_step(gx_t, h2h, h, alive):
    """One masked GRU step: h2h(h), the gates, the carry frozen and the
    output zero where ``alive`` (B, 1) is False; (carry, output)."""
    new_h = _gru_gates(gx_t, h2h(h), h)
    return (torch.where(alive, new_h, h),
            torch.where(alive, new_h, torch.zeros_like(new_h)))


def _gru_recurrence(gates_x, h2h, h, valid_length):
    """Plain differentiable GRU loop over (T, B, 3H) input gates with masked
    carries, step by step as the JAX ``_RecurrentStep`` scan; ``h2h`` maps
    the carry to its gates. Under ``torch.export`` the same steps run as one
    ``while_loop`` (:func:`_gru_recurrence_loop`), so that a traced program
    holds one step, not T."""
    if torch.compiler.is_exporting():
        return _gru_recurrence_loop(gates_x, h2h, h, valid_length)
    ys = []
    for t in range(gates_x.shape[0]):
        h, y = _gru_step(gates_x[t], h2h, h, (t < valid_length)[:, None])
        ys.append(y)
    return torch.stack(ys), h


def _gru_recurrence_loop(gates_x, h2h, h, valid_length):
    """:func:`_gru_recurrence` as a ``torch._higher_order_ops.while_loop``
    over t, the counterpart of the JAX scan in a traced program: the same
    steps, bit for bit (forward only)."""
    from torch._higher_order_ops import while_loop

    T = gates_x.shape[0]

    def cond(t, h, ys):
        return t < T

    def body(t, h, ys):
        h, y = _gru_step(gates_x.index_select(0, t[None])[0], h2h, h,
                         (t < valid_length)[:, None])
        return t + 1, h, ys.index_copy(0, t[None], y[None])

    t0 = torch.zeros((), dtype=torch.int64, device=gates_x.device)
    ys = torch.zeros((T,) + tuple(h.shape), dtype=h.dtype, device=h.device)
    _, h, ys = while_loop(cond, body, (t0, h, ys))
    return ys, h


class RNNLayer(nn.Module):
    """One recurrent layer over (B, T, C) with optional masking/reversal;
    ``forward`` returns (final state, outputs (B, T, H)) in ``dtype``. The
    final state is (B, H) for a GRU and (h, c) for an LSTM."""

    def __init__(self, cell_type: str, input_size: int, hidden_size: int,
                 reverse: bool = False,
                 generator: torch.Generator | None = None,
                 dtype=torch.float32):
        super().__init__()
        if cell_type not in ("gru", "lstm"):
            raise ValueError(f"unknown cell type {cell_type!r}")
        self.cell_type = cell_type
        self.hidden_size = hidden_size
        self.reverse = reverse
        self.dtype = dtype
        n_gates = 4 if cell_type == "lstm" else 3
        self.i2h = dense(input_size, n_gates * hidden_size, generator=generator)
        self.recurrence = nn.Module()
        self.recurrence.h2h = dense(hidden_size, n_gates * hidden_size,
                                    generator=generator)

    def forward(self, inputs, valid_length=None, initial_state=None):
        B, T = inputs.shape[:2]
        H, dt = self.hidden_size, self.dtype
        if initial_state is None:
            z = torch.zeros(B, H, device=inputs.device, dtype=dt)
            initial_state = (z, z) if self.cell_type == "lstm" else z
        if self.reverse:
            inputs = reverse_sequence(inputs, valid_length, axis=1)
        # hoisted input projection: one sequence-wide matmul
        gx = _affine(self.i2h, dt)(inputs).transpose(0, 1)  # (T, B, G)
        vl = (torch.full((B,), T, dtype=torch.int32, device=inputs.device)
              if valid_length is None
              else valid_length.to(inputs.device, torch.int32))
        h2h = self.recurrence.h2h
        if self.cell_type == "lstm":
            ys, final = _lstm_recurrence(gx, _affine(h2h, dt, whole=True),
                                         initial_state, vl)
        elif _GRU_DECODE.get():
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in (gx, initial_state, h2h.weight)):
                raise RuntimeError(
                    "the GRU decode context is forward-only: no gradient may "
                    "be required inside gru_decode()")
            if gru_ops.gru_decode_route(T, B, H) == "plain":
                gru_ops.gru_recurrence.plain_routed += 1
                ys, final = _gru_recurrence(gx, _affine(h2h, dt, whole=True),
                                            initial_state, vl)
            else:
                # the kernel runs in f32, as the JAX package's Pallas path
                ys, final = gru_recurrence(gx.float(), initial_state.float(),
                                           whole_weight(h2h).t(), h2h.bias,
                                           vl)
                ys, final = ys.to(dt), final.to(dt)
        else:
            ys, final = _gru_recurrence(gx, _affine(h2h, dt, whole=True),
                                        initial_state, vl)
        ys = ys.transpose(0, 1)
        if self.reverse:
            ys = reverse_sequence(ys, valid_length, axis=1)
        elif valid_length is not None:
            ys = sequence_mask(ys, valid_length, axis=1)
        return final, ys


class BiRNN(nn.Module):
    """Forward + reverse :class:`RNNLayer` (``fwd``, ``bwd``) in ``dtype``,
    outputs concatenated on features; final state ``(fwd_state,
    bwd_state)``."""

    def __init__(self, cell_type: str, input_size: int, hidden_size: int,
                 generator: torch.Generator | None = None,
                 dtype=torch.float32):
        super().__init__()
        self.fwd = RNNLayer(cell_type, input_size, hidden_size, False,
                            generator, dtype)
        self.bwd = RNNLayer(cell_type, input_size, hidden_size, True,
                            generator, dtype)

    def forward(self, inputs, valid_length=None):
        l_final, l_out = self.fwd(inputs, valid_length)
        r_final, r_out = self.bwd(inputs, valid_length)
        return (l_final, r_final), torch.cat([l_out, r_out], dim=-1)


class StackedRNN(nn.Module):
    """Uni-directional stack of layers ``bi{i}`` (:class:`BiRNN`) or
    ``uni{i}`` (:class:`RNNLayer`), no residuals; returns the last outputs."""

    def __init__(self, cell_type: str, input_size: int, hidden_size: int,
                 num_layers: int = 1, bidirectional: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.names = []
        for i in range(num_layers):
            if bidirectional:
                name, layer = f"bi{i}", BiRNN(cell_type, input_size,
                                             hidden_size, generator)
                input_size = 2 * hidden_size
            else:
                name, layer = f"uni{i}", RNNLayer(cell_type, input_size,
                                                  hidden_size,
                                                  generator=generator)
                input_size = hidden_size
            self.add_module(name, layer)
            self.names.append(name)

    def forward(self, inputs, valid_length=None):
        x = inputs
        for name in self.names:
            _, x = getattr(self, name)(x, valid_length)
        return x
