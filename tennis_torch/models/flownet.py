"""FlowNet-S (no batch norm) in NHWC for PyTorch, inference only.

Counterpart of ``tennis_tpu/models/flownet.py``, with the flax names:
``conv1`` .. ``conv6_1`` (the encoder), ``predict_flow6`` .. ``predict_flow2``
(the 2-channel flow side-outputs), ``deconv5`` .. ``deconv2`` and the
bias-free ``upflow6`` .. ``upflow3`` (the refinement's transposed
convolutions). ``train=True`` returns the 5-scale flow pyramid ``(flow2, ..,
flow6)`` in f32; otherwise the quarter-resolution ``flow2``.

Input: (B, 2, H, W, 3) image pairs, folded onto channels as ``[frame0 RGB,
frame1 RGB]``, or (B, H, W, 6); H and W divide by 64. Parameters are f32;
compute runs in ``dtype`` (bf16 by default, as the flax module's default).

Padding: the encoder's convolutions pad ``k // 2`` on every side, as the
flax module does explicitly. Each transposed convolution is flax's
``ConvTranspose(4, strides=2, padding="SAME")``: the input dilated by 2,
padded by 2 on every side and correlated with the kernel as stored. That is
``conv_transpose2d(padding=1)`` with the kernel flipped in space, so the
weight bridge flips a ``ConvTranspose2d`` kernel (``bridge.py``) and every
output pixel, the outermost ring included, is flax's. The JAX package runs
this network through XLA convolutions, not a Pallas kernel, so every
convolution here is cuDNN's on a card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tennis_torch.models.backbones.densenet import lecun_normal_

# (name, c_in, c_out, kernel, stride) of the encoder
ENCODER = (
    ("conv1", 6, 64, 7, 2), ("conv2", 64, 128, 5, 2),
    ("conv3", 128, 256, 5, 2), ("conv3_1", 256, 256, 3, 1),
    ("conv4", 256, 512, 3, 2), ("conv4_1", 512, 512, 3, 1),
    ("conv5", 512, 512, 3, 2), ("conv5_1", 512, 512, 3, 1),
    ("conv6", 512, 1024, 3, 2), ("conv6_1", 1024, 1024, 3, 1),
)
# (level, channels of its input concat, channels of the deconv out of it);
# the concat at level k is [out_k, up_k, flow_{k+1} upsampled]
REFINE = ((6, 1024, 512), (5, 1026, 256), (4, 770, 128), (3, 386, 64),
          (2, 194, None))


def _conv(c_in, c_out, k, generator):
    conv = nn.Conv2d(c_in, c_out, k)
    lecun_normal_(conv.weight, c_in * k * k, generator)
    nn.init.zeros_(conv.bias)
    return conv


def _deconv(c_in, c_out, generator, bias=True):
    deconv = nn.ConvTranspose2d(c_in, c_out, 4, stride=2, padding=1,
                                bias=bias)
    lecun_normal_(deconv.weight, c_in * 16, generator)
    if bias:
        nn.init.zeros_(deconv.bias)
    return deconv


def _leaky(x):
    return F.leaky_relu(x, 0.1)


class FlowNetS(nn.Module):
    def __init__(self, dtype=torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        for name, c_in, c_out, k, _ in ENCODER:
            setattr(self, name, _conv(c_in, c_out, k, generator))
        for level, c_in, c_up in REFINE:
            setattr(self, f"predict_flow{level}", _conv(c_in, 2, 3, generator))
            if c_up is not None:
                setattr(self, f"upflow{level}",
                        _deconv(2, 2, generator, bias=False))
                setattr(self, f"deconv{level - 1}",
                        _deconv(c_in, c_up, generator))

    def _conv(self, name, x, stride=1):
        conv = getattr(self, name)
        return F.conv2d(x, conv.weight.to(self.dtype),
                        conv.bias.to(self.dtype), stride=stride,
                        padding=conv.kernel_size[0] // 2)

    def _deconv(self, name, x):
        deconv = getattr(self, name)
        bias = None if deconv.bias is None else deconv.bias.to(self.dtype)
        return F.conv_transpose2d(x, deconv.weight.to(self.dtype), bias,
                                  stride=2, padding=1)

    def forward(self, x: torch.Tensor, train: bool = False):
        if x.dim() == 5:  # (B, 2, H, W, 3) -> (B, H, W, 6)
            x = torch.cat([x[:, 0], x[:, 1]], dim=-1)
        # NCHW views of NHWC memory: cuDNN runs channels-last
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        outs = {}
        for name, _, _, _, stride in ENCODER:
            h = _leaky(self._conv(name, h, stride))
            outs[name] = h
        flows = []
        concat = outs["conv6_1"]
        for level, _, c_up in REFINE:
            flow = self._conv(f"predict_flow{level}", concat)
            flows.append(flow)
            if c_up is None:
                break
            flow_up = self._deconv(f"upflow{level}", flow)
            up = _leaky(self._deconv(f"deconv{level - 1}", concat))
            out = outs[f"conv{level - 1}_1" if level > 3 else
                       f"conv{level - 1}"]
            concat = torch.cat([out, up, flow_up], dim=1)
        pyramid = tuple(f.float().permute(0, 2, 3, 1) for f in flows[::-1])
        return pyramid if train else pyramid[0]
