"""Beam-search translator (counterpart of ``tennis_tpu/translation.py``):
encode -> init decoder state -> beam search, returning (samples, scores,
valid_length) on the host.

The model holds its weights, so ``translate`` takes no variables. It runs
under ``torch.inference_mode()`` on the model's device and encodes inside
``ops.rnn.gru_decode``, as the JAX translator encodes inside its
``pallas_gru`` context: the encoder's GRU recurrences take the forward-only
CUDA kernel on the card. The translator is the only code of the package
that sets that context. There is no per-shape compile cache: PyTorch
runs eagerly.

Under a process group (the JAX translator takes a ``mesh``) each rank
decodes its own rows of a global batch, which the caller pads and deals
out (``parallel.mesh.pad_batch`` and ``shard_rows``), and ``translate``
returns every rank's rows, gathered in rank order (``fetch_global``).
Given a ``world`` (the counterpart of ``mesh=``), ``translate`` takes the
global batch itself: its rows are padded to the data size, dealt over the
data axis, gathered back and sliced to the batch, while the model ranks of
a data index decode the same rows in lockstep over their blocks of a
sequence-sharded memory (``NMTModel.mem_sharding``). Every op of the
search is per row, so a row decodes as it would in the whole batch.

``build_decoder`` is the trace surface of ``tennis_torch.export``: the same
decode for a static batch, with the search as one ``while_loop``
(``beam_search_loop``).
"""
from __future__ import annotations

import torch

from tennis_torch.ops.beam_search import beam_search, beam_search_loop
from tennis_torch.ops.rnn import gru_decode


class BeamSearchTranslator:
    def __init__(self, model, bos_id: int, eos_id: int, beam_size: int = 4,
                 alpha: float = 1.0, K: int = 5, max_length: int = 100,
                 world=None):
        self._model = model
        self._world = world
        self._bos = bos_id
        self._eos = eos_id
        self._beam = beam_size
        self._alpha = alpha
        self._K = K
        self._max_length = max_length

    @property
    def device(self) -> torch.device:
        return next(self._model.parameters()).device

    def build_decoder(self, batch_size: int, gru_kernel: bool = False):
        """``decode(src (B, T, D), src_valid_length (B,) int32) -> (samples
        (B, K, L) int32, scores (B, K) f32, valid_length (B, K) int32)`` for
        a static ``batch_size``, the search as one ``while_loop``
        (:func:`beam_search_loop`): the program ``tennis_torch.export``
        freezes. It encodes inside ``gru_decode()`` only with
        ``gru_kernel`` (the counterpart of the JAX ``use_pallas_gru``): the
        encoder's GRU recurrences then go through the GRU kernel's custom
        op; otherwise through the plain recurrence."""
        model = self._model

        def decode(src, src_valid_length):
            with gru_decode(gru_kernel):
                encoded = model.encode(src, src_valid_length)
            states = model.init_decoder_state(encoded, src_valid_length)
            return beam_search_loop(model.decode_step, states, batch_size,
                                    self._beam, self._bos, self._eos,
                                    self._max_length, self._alpha, self._K)

        return decode

    @torch.inference_mode()
    def translate_tensors(self, src: torch.Tensor, src_valid_length: torch.Tensor):
        """Device tensors in, device tensors out: (samples (B, K, L) int32,
        scores (B, K) f32, valid_length (B, K) int32)."""
        model = self._model
        with gru_decode():
            encoded = model.encode(src, src_valid_length)
        states = model.init_decoder_state(encoded, src_valid_length)
        return beam_search(model.decode_step, states, src.shape[0],
                           self._beam, self._bos, self._eos, self._max_length,
                           self._alpha, self._K)

    def translate(self, src, src_valid_length):
        """src (B, T, D) features or (B, T, H, W, C) uint8 frames,
        array-like or tensor (features as f32, frames as they are),
        src_valid_length (B,) (float lengths are truncated to int32, as the
        JAX translator casts them); returns numpy (samples (B, K, L) int32,
        scores (B, K), valid_length (B, K)). Under a process group the rows
        are this rank's and the results every rank's, in rank order (a
        collective); with a ``world`` the rows are the global batch's, and
        so are the results."""
        from tennis_torch.parallel.distributed import fetch_global
        from tennis_torch.parallel.mesh import pad_batch, shard_rows

        dev = self.device
        src = torch.as_tensor(src, device=dev)
        if src.dtype != torch.uint8:
            src = src.float()
        vl = torch.as_tensor(src_valid_length, device=dev).to(torch.int32)
        world = self._world
        if world is None:
            return fetch_global(self.translate_tensors(src, vl))
        (src, vl), n = pad_batch((src, vl), world.data_size)
        src, vl = shard_rows((src, vl), world.data_rank, world.data_size)
        out = fetch_global(self.translate_tensors(src, vl))
        return tuple(x[:n] for x in out)

    def translate_tokens(self, src, src_valid_length, vocab):
        """Top-beam hypotheses as token lists (BOS/EOS stripped)."""
        samples, _, lengths = self.translate(src, src_valid_length)
        out = []
        for b in range(samples.shape[0]):
            vl = int(lengths[b, 0])
            out.append(vocab.to_tokens(samples[b, 0, 1: vl - 1]))
        return out
