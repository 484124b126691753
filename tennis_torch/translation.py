"""Beam-search translator (counterpart of ``tennis_tpu/translation.py``):
encode -> init decoder state -> beam search, returning (samples, scores,
valid_length) on the host.

The model holds its weights, so ``translate`` takes no variables. It runs
under ``torch.inference_mode()`` on the model's device and encodes inside
``ops.rnn.gru_decode``, as the JAX translator encodes inside its
``pallas_gru`` context: the encoder's GRU recurrences take the forward-only
CUDA kernel on the card. The translator is the only code of the package
that sets that context. There is no per-shape compile cache and no mesh:
PyTorch runs eagerly on one card.
"""
from __future__ import annotations

import torch

from tennis_torch.ops.beam_search import beam_search
from tennis_torch.ops.rnn import gru_decode


class BeamSearchTranslator:
    def __init__(self, model, bos_id: int, eos_id: int, beam_size: int = 4,
                 alpha: float = 1.0, K: int = 5, max_length: int = 100):
        self._model = model
        self._bos = bos_id
        self._eos = eos_id
        self._beam = beam_size
        self._alpha = alpha
        self._K = K
        self._max_length = max_length

    @property
    def device(self) -> torch.device:
        return next(self._model.parameters()).device

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
        """src (B, T, D) array-like or tensor, src_valid_length (B,) (float
        lengths are truncated to int32, as the JAX translator casts them);
        returns numpy (samples (B, K, L) int32, scores (B, K), valid_length
        (B, K))."""
        dev = self.device
        src = torch.as_tensor(src, dtype=torch.float32, device=dev)
        vl = torch.as_tensor(src_valid_length, device=dev).to(torch.int32)
        samples, scores, lengths = self.translate_tensors(src, vl)
        return samples.cpu().numpy(), scores.cpu().numpy(), lengths.cpu().numpy()

    def translate_tokens(self, src, src_valid_length, vocab):
        """Top-beam hypotheses as token lists (BOS/EOS stripped)."""
        samples, _, lengths = self.translate(src, src_valid_length)
        out = []
        for b in range(samples.shape[0]):
            vl = int(lengths[b, 0])
            out.append(vocab.to_tokens(samples[b, 0, 1: vl - 1]))
        return out
