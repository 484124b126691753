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
  for tensors on the card, its plain version on the CPU. A gradient there
  raises, on either device;
- everywhere else (training, the per-epoch loss, every LSTM) a plain
  differentiable per-step recurrence, the counterpart of the JAX
  ``_RecurrentStep`` scan, which autograd goes through.

The context decides the path; no path catches a kernel failure.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
from torch import nn

from tennis_torch.ops.gru import gru_recurrence
from tennis_torch.ops.masking import reverse_sequence, sequence_mask

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


def dense(in_features: int, out_features: int, bias: bool = True,
          generator: torch.Generator | None = None) -> nn.Linear:
    """flax ``nn.Dense`` initialisation: lecun-normal kernel, zero bias."""
    from tennis_torch.models.backbones.densenet import lecun_normal_

    layer = nn.Linear(in_features, out_features, bias=bias)
    lecun_normal_(layer.weight, in_features, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


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
    """Plain LSTM loop over (T, B, 4H) input gates with masked carries."""
    h, c = carry
    ys = []
    for t in range(gates_x.shape[0]):
        new_h, new_c = _lstm_gates(gates_x[t] + h2h(h), c)
        alive = (t < valid_length)[:, None]
        h = torch.where(alive, new_h, h)
        c = torch.where(alive, new_c, c)
        ys.append(torch.where(alive, new_h, torch.zeros_like(new_h)))
    return torch.stack(ys), (h, c)


def _gru_recurrence(gates_x, h2h, h, valid_length):
    """Plain differentiable GRU loop over (T, B, 3H) input gates with masked
    carries, step by step as the JAX ``_RecurrentStep`` scan: h2h(h), the
    gates, the carry frozen and the output zero past ``valid_length``."""
    ys = []
    for t in range(gates_x.shape[0]):
        new_h = _gru_gates(gates_x[t], h2h(h), h)
        alive = (t < valid_length)[:, None]
        h = torch.where(alive, new_h, h)
        ys.append(torch.where(alive, new_h, torch.zeros_like(new_h)))
    return torch.stack(ys), h


class RNNLayer(nn.Module):
    """One recurrent layer over (B, T, C) with optional masking/reversal;
    ``forward`` returns (final state, outputs (B, T, H)). The final state
    is (B, H) for a GRU and (h, c) for an LSTM."""

    def __init__(self, cell_type: str, input_size: int, hidden_size: int,
                 reverse: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cell_type not in ("gru", "lstm"):
            raise ValueError(f"unknown cell type {cell_type!r}")
        self.cell_type = cell_type
        self.hidden_size = hidden_size
        self.reverse = reverse
        n_gates = 4 if cell_type == "lstm" else 3
        self.i2h = dense(input_size, n_gates * hidden_size, generator=generator)
        self.recurrence = nn.Module()
        self.recurrence.h2h = dense(hidden_size, n_gates * hidden_size,
                                    generator=generator)

    def forward(self, inputs, valid_length=None, initial_state=None):
        B, T = inputs.shape[:2]
        H = self.hidden_size
        if initial_state is None:
            z = torch.zeros(B, H, device=inputs.device)
            initial_state = (z, z) if self.cell_type == "lstm" else z
        if self.reverse:
            inputs = reverse_sequence(inputs, valid_length, axis=1)
        # hoisted input projection: one sequence-wide matmul
        gx = self.i2h(inputs.float()).transpose(0, 1)  # (T, B, G)
        vl = (torch.full((B,), T, dtype=torch.int32, device=inputs.device)
              if valid_length is None
              else valid_length.to(inputs.device, torch.int32))
        h2h = self.recurrence.h2h
        if self.cell_type == "lstm":
            ys, final = _lstm_recurrence(gx, h2h, initial_state, vl)
        elif _GRU_DECODE.get():
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in (gx, initial_state, h2h.weight)):
                raise RuntimeError(
                    "the GRU decode context is forward-only: no gradient may "
                    "be required inside gru_decode()")
            ys, final = gru_recurrence(gx, initial_state, h2h.weight.t(),
                                       h2h.bias, vl)
        else:
            ys, final = _gru_recurrence(gx, h2h, initial_state, vl)
        ys = ys.transpose(0, 1)
        if self.reverse:
            ys = reverse_sequence(ys, valid_length, axis=1)
        elif valid_length is not None:
            ys = sequence_mask(ys, valid_length, axis=1)
        return final, ys


class BiRNN(nn.Module):
    """Forward + reverse :class:`RNNLayer` (``fwd``, ``bwd``), outputs
    concatenated on features; final state ``(fwd_state, bwd_state)``."""

    def __init__(self, cell_type: str, input_size: int, hidden_size: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fwd = RNNLayer(cell_type, input_size, hidden_size, False, generator)
        self.bwd = RNNLayer(cell_type, input_size, hidden_size, True, generator)

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
