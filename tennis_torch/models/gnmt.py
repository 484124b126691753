"""GNMT-style encoder/decoder and NMT captioning model (counterpart of
``tennis_tpu/models/gnmt.py``), features path, with ``masked_ce_loss``.

Structure (gnmt_v2):
- encoder: ``num_bi_layers`` bidirectional GRU/LSTM layers, then
  unidirectional layers, residual on uni layers with index > num_bi_layers
  when enabled; output sequence-masked. It keeps the *backward* final state
  of a bidirectional layer;
- decoder: layer 0 consumes concat(step input, attention_vec); scaled-Luong
  attention queries layer 0's output against the encoder memory; layers
  1..n-1 consume concat(previous output, attention_vec). The initial
  attention_vec is zeros.

Parameter names follow the flax tree: ``encoder.rnn{i}[.fwd|.bwd]``,
``decoder.step.rnn{i}.{i2h,h2h}``, ``decoder.step.attention.query_proj``,
``tgt_embed`` and ``tgt_proj``.

Dropout sits where the JAX package puts it: after each encoder layer, before
the residual, and after each decoder layer from 1 on, before the residual.
It acts only in ``train()`` mode, drawing its masks from the
``torch.Generator`` the forward is given (a train-mode forward with dropout
and no generator raises); in ``eval()`` mode it is the identity. The pixels
path (``src_embed``, a DenseNet) is not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tennis_torch.ops.attention import LuongAttention
from tennis_torch.ops.masking import sequence_mask
from tennis_torch.ops.rnn import BiRNN, RNNLayer, dense, make_cell


def dropout(x, rate: float, training: bool,
            generator: torch.Generator | None):
    """flax ``nn.Dropout``: in training, keep each element with probability
    1 - ``rate`` (a mask drawn from ``generator``) scaled by 1 / (1 -
    ``rate``), else zero; the identity at rate 0 or outside training."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("a train-mode forward with dropout needs a "
                         "torch.Generator for its masks")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class GNMTEncoder(nn.Module):
    def __init__(self, cell_type: str = "gru", num_layers: int = 2,
                 num_bi_layers: int = 1, input_size: int = 4096,
                 hidden_size: int = 128, use_residual: bool = False,
                 generator: torch.Generator | None = None,
                 dropout: float = 0.0):
        super().__init__()
        if num_bi_layers > num_layers:
            raise ValueError("num_bi_layers must not exceed num_layers")
        self.dropout = dropout
        self.num_layers = num_layers
        self.num_bi_layers = num_bi_layers
        self.use_residual = use_residual
        size = input_size
        for i in range(num_layers):
            if i < num_bi_layers:
                layer = BiRNN(cell_type, size, hidden_size, generator)
                size = 2 * hidden_size
            else:
                layer = RNNLayer(cell_type, size, hidden_size,
                                 generator=generator)
                size = hidden_size
            self.add_module(f"rnn{i}", layer)

    def forward(self, inputs, valid_length=None, generator=None):
        """(B, T, C) -> (outputs (B, T, H) masked, list of final states);
        ``generator`` draws the train-mode dropout masks."""
        x = inputs.float()
        states = []
        for i in range(self.num_layers):
            layer = getattr(self, f"rnn{i}")
            if i < self.num_bi_layers:
                (_, r_final), out = layer(x, valid_length)
                states.append(r_final)  # the backward state
            else:
                final, out = layer(x, valid_length)
                states.append(final)
            out = dropout(out, self.dropout, self.training, generator)
            if self.use_residual and i > self.num_bi_layers:
                out = out + x
            x = out
        if valid_length is not None:
            x = sequence_mask(x, valid_length, axis=1)
        return x, states


class GNMTDecoderStep(nn.Module):
    """One decoding step, shared across time."""

    def __init__(self, cell_type: str = "gru", num_layers: int = 2,
                 embed_size: int = 100, hidden_size: int = 128,
                 use_residual: bool = False,
                 generator: torch.Generator | None = None,
                 dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.use_residual = use_residual
        self.dropout = dropout
        self.rnn0 = make_cell(cell_type, embed_size + hidden_size, hidden_size,
                              generator)
        self.attention = LuongAttention(hidden_size, hidden_size,
                                        generator=generator)
        for i in range(1, num_layers):
            self.add_module(f"rnn{i}", make_cell(
                cell_type, 2 * hidden_size, hidden_size, generator))

    def forward(self, carry, step_input, mem_value, mem_masks, generator=None):
        """carry (rnn_states, attention_vec), step_input (B, E) ->
        ((new_states, attention_vec), (rnn_out, attention weights))."""
        rnn_states, attention_vec = carry
        state0, rnn_out = self.rnn0(
            rnn_states[0], torch.cat([step_input.float(), attention_vec], -1))
        new_states = [state0]
        attention_vec, attn_weights = self.attention(
            rnn_out[:, None, :], mem_value, mem_value, mem_masks)
        attention_vec = attention_vec[:, 0, :]
        for i in range(1, self.num_layers):
            curr_input = rnn_out
            state_i, rnn_out = getattr(self, f"rnn{i}")(
                rnn_states[i], torch.cat([curr_input, attention_vec], -1))
            rnn_out = dropout(rnn_out, self.dropout, self.training, generator)
            if self.use_residual:
                rnn_out = rnn_out + curr_input
            new_states.append(state_i)
        return (tuple(new_states), attention_vec), (rnn_out, attn_weights)


class GNMTDecoder(nn.Module):
    """Decoder over (B, T, E) step inputs: a loop of :class:`GNMTDecoderStep`
    (``step``); one-step decoding (beam search) is a T = 1 call."""

    def __init__(self, cell_type: str = "gru", num_layers: int = 2,
                 embed_size: int = 100, hidden_size: int = 128,
                 use_residual: bool = False,
                 generator: torch.Generator | None = None,
                 dropout: float = 0.0):
        super().__init__()
        self.step = GNMTDecoderStep(cell_type, num_layers, embed_size,
                                    hidden_size, use_residual, generator,
                                    dropout)

    @staticmethod
    def init_state(encoder_states, mem_value, mem_valid_length=None):
        """(rnn_states, attention_vec, mem_value, mem_masks)."""
        B, T, H = mem_value.shape
        attention_vec = torch.zeros(B, H, dtype=mem_value.dtype,
                                    device=mem_value.device)
        mem_masks = None
        if mem_valid_length is not None:
            mem_masks = (torch.arange(T, device=mem_value.device)[None, :]
                         < mem_valid_length.to(mem_value.device)[:, None])
        return tuple(encoder_states), attention_vec, mem_value, mem_masks

    def forward(self, inputs, states, valid_length=None, generator=None):
        """(B, T, E) teacher-forced decode -> ((B, T, H) outputs, states)."""
        rnn_states, attention_vec, mem_value, mem_masks = states
        carry = (rnn_states, attention_vec)
        outputs = []
        for t in range(inputs.shape[1]):
            carry, (out, _) = self.step(carry, inputs[:, t], mem_value,
                                        mem_masks, generator)
            outputs.append(out)
        outputs = torch.stack(outputs, dim=1)
        if valid_length is not None:
            outputs = sequence_mask(outputs, valid_length, axis=1)
        return outputs, (carry[0], carry[1], mem_value, mem_masks)


class NMTModel(nn.Module):
    """encoder -> decoder -> tgt_proj, with a token-embedding tgt_embed;
    features path (the source is the encoder's input as it is)."""

    def __init__(self, vocab_size: int, encoder: GNMTEncoder,
                 decoder: GNMTDecoder, embed_size: int = 100,
                 hidden_size: int = 128,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.tgt_embed = nn.Embedding(vocab_size, embed_size)
        with torch.no_grad():  # flax nn.Embed: variance 1/embed_size
            self.tgt_embed.weight.normal_(0.0, 1.0 / math.sqrt(embed_size),
                                          generator=generator)
        self.tgt_proj = dense(hidden_size, vocab_size, generator=generator)

    def encode(self, src, valid_length=None, generator=None):
        return self.encoder(src.float(), valid_length, generator)

    def init_decoder_state(self, encoder_outputs, src_valid_length=None):
        mem_value, enc_states = encoder_outputs
        return self.decoder.init_state(enc_states, mem_value, src_valid_length)

    def decode_step(self, step_tokens, states):
        """Beam-search step: token ids (B,) -> (logits (B, V), new states)."""
        emb = self.tgt_embed(step_tokens.long())
        out, new_states = self.decoder(emb[:, None, :], states)
        return self.tgt_proj(out[:, 0]), new_states

    def forward(self, src, tgt_tokens, src_valid_length=None,
                tgt_valid_length=None, generator=None):
        """Teacher-forced forward -> logits (B, T_tgt, V); ``generator``
        draws the dropout masks of a train-mode forward."""
        states = self.init_decoder_state(
            self.encode(src, src_valid_length, generator), src_valid_length)
        outputs, _ = self.decoder(self.tgt_embed(tgt_tokens.long()), states,
                                  tgt_valid_length, generator)
        return self.tgt_proj(outputs)


def masked_ce_loss(logits, labels, valid_length, average: str = "padded",
                   sample_weights=None):
    """gluonnlp ``MaskedSoftmaxCELoss``: the per-step softmax cross-entropy
    of f32 ``logits`` (B, T, V) against ``labels`` (B, T), zero at and past
    ``valid_length`` (B,), averaged per sample over the **padded** length T
    (``average="padded"``; ``"valid"`` divides by the true lengths), then
    over the batch, or weighted by ``sample_weights`` (B,), where a zero
    weight drops a row exactly."""
    B, T, V = logits.shape
    ce = F.cross_entropy(logits.float().reshape(B * T, V),
                         labels.long().reshape(B * T),
                         reduction="none").view(B, T)
    vl = valid_length.to(logits.device)
    mask = torch.arange(T, device=logits.device)[None, :] < \
        vl.to(torch.int32)[:, None]
    ce = torch.where(mask, ce, torch.zeros((), device=ce.device))
    if average == "padded":
        per_sample = ce.sum(1) / T
    else:
        per_sample = ce.sum(1) / torch.clamp(vl.float(), min=1.0)
    if sample_weights is not None:
        w = sample_weights.to(logits.device, torch.float32)
        return (per_sample * w).sum() / torch.clamp(w.sum(), min=1.0)
    return per_sample.mean()


def get_gnmt_encoder_decoder(cell_type="gru", num_layers=2, num_bi_layers=1,
                             hidden_size=128, dropout=0.0, use_residual=False,
                             input_size=4096, embed_size=100,
                             generator: torch.Generator | None = None):
    """Factory of the JAX package's ``get_gnmt_encoder_decoder``; torch
    needs the source feature size and the embedding size up front."""
    encoder = GNMTEncoder(cell_type, num_layers, num_bi_layers, input_size,
                          hidden_size, use_residual, generator, dropout)
    decoder = GNMTDecoder(cell_type, num_layers, embed_size, hidden_size,
                          use_residual, generator, dropout)
    return encoder, decoder
