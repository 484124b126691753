"""DenseNet dense layers through one hand-written CUDA kernel per layer.

Counterpart of ``tennis_tpu/ops/pallas/dense_block.py``. One launch of
``csrc/dense_layer.cu`` runs a whole DenseNet-BC dense layer at inference
(folded BN1 -> ReLU -> 1x1 conv -> folded BN2 -> ReLU -> 3x3 conv) over an
unpadded NHWC block-state buffer ``(B, H, W, C_block_final)`` and writes the
layer's growth channels in place, so the concatenated state is never built.

For a bf16 state the kernel has three variants.
``csrc/dense_layer_persistent.cu`` runs one CTA per SM with the conv
weights resident in shared memory and takes the maps of side 64 and more,
and the 32^2 maps at batch 8;
``csrc/dense_layer_cluster.cu`` runs one thread-block cluster of 2, 4 or 8
CTAs per 8x8 tile, splitting c_in and the bottleneck between them, and
takes the other small maps; ``csrc/dense_layer.cu`` runs one CTA per 8x8
tile and takes only a c_in past the persistent kernel's budget.
``dense_layer_route`` chooses the variant (and the cluster size) by map
side, batch and c_in, as measured on the card. An f32 state (the
pixels-path captioner's DenseNet ``src_embed``, built in f32 as the JAX
driver builds it) goes to ``csrc/dense_layer_f32_tc.cu`` (``"f32"``): 3xTF32
``wgmma`` on the tensor cores, as exact as f32 FMA, over weights split into
TF32 halves (:func:`tf32_image`) on the card at the first launch with those
weights and kept while they live unchanged.

The TPU kernel computes bottleneck 128 and growth 32 only (it asserts
F == 128), and so do the four CUDA kernels. A layer of other widths
(DenseNet161: bottleneck 192, growth 48) is one that the JAX package runs
through its flax module, i.e. XLA convolutions outside any Pallas kernel;
its counterpart here is ``dense_layer_convs``, two ``F.conv2d`` calls, which
the route names ``"convs"`` from the widths alone.

Beside the kernels sits their plain PyTorch version, ``dense_layer_reference``.
The launch is the ``torch.library`` custom op ``tennis_torch::dense_layer``
(:func:`dense_layer_op`: it mutates the state in place, so ``torch.export``
keeps one node per layer), whose CUDA implementation launches the kernel
its ``variant`` names or raises and whose CPU implementation is the plain
version. ``dense_layer`` resolves the variant from the static shapes and
calls the op, for a live forward and a traced one alike.

``densenet_features`` drives the whole feature extractor: stem, transitions
and the final BN/pool are plain torch ops, every dense layer goes through
``dense_layer`` (DenseNet121: 58 launches per forward). It takes the BN-folded
operands that ``DenseNet.operands()`` prepares once at load.
``plain_dense_layers(model)`` is the yardstick of a comparison: within it
every DenseNet of a model (a two-stream net's two, a clip CNN-RNN's one)
takes its eval forward through the plain version, on any device.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tennis_torch.utils.tracing import span

BOTTLENECK = 128  # bn_size * growth_rate that the kernel takes
GROWTH = 32


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """Eval BatchNorm as a per-channel affine ``x * inv + shift`` (f32)."""
    inv = torch.rsqrt(var.float() + eps) * scale.float()
    shift = bias.float() - mean.float() * inv
    return inv, shift


class LayerOperands(NamedTuple):
    """One dense layer's operands: BN1/BN2 folded (f32), kernels in the
    compute dtype. ``w1`` is (F, C_in); ``w2`` is (3, 3, G, F)."""
    inv1: torch.Tensor
    sh1: torch.Tensor
    w1: torch.Tensor
    inv2: torch.Tensor
    sh2: torch.Tensor
    w2: torch.Tensor


def tf32_split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of an f32 tensor: ``hi`` is ``t`` rounded to TF32 (10
    mantissa bits) to nearest, ties away from zero, as ``cvt.rna.tf32.f32``
    rounds, with its 13 low bits zero; ``lo`` is ``t - hi`` rounded the same
    way. ``hi + lo`` is within 2^-21 of ``t`` (relative). Integer bit
    operations, so the CPU and the card give the same bits (NaN payloads
    aside)."""
    def rna(x):
        return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    t = t.float().contiguous()
    hi = rna(t)
    return hi, rna(t - hi)


def tf32_image(m: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel's shared-memory image of f32 matrices ``m``
    (..., N, K), K a multiple of 32: (..., K/32, 2, N, 32), for each 32-wide
    K block the :func:`tf32_split` halves (hi, then lo), each an (N, 32)
    K-major block whose rows of 128 bytes carry the 128-byte swizzle of a
    ``wgmma`` operand (16-byte piece c of row n stored at c ^ (n % 8))."""
    *lead, n, k = m.shape
    halves = torch.stack(tf32_split(m), -3)  # (..., 2, N, K)
    blocks = halves.reshape(*lead, 2, n, k // 32, 8, 4).movedim(-3, -5)
    perm = (torch.arange(8, device=m.device)
            ^ (torch.arange(n, device=m.device)[:, None] % 8))
    image = torch.gather(blocks, -2, perm[..., None].expand(blocks.shape))
    return image.reshape(*lead, k // 32, 2, n, 32).contiguous()


# w1 -> (w2, the weights' versions, w1's image, w2's image): the split
# weights of the f32 tensor-core kernel, one entry per live set of operands
_TF32_IMAGES = torch.utils.weak.WeakTensorKeyDictionary()


def _tf32_weights(ops: LayerOperands) -> tuple[torch.Tensor, torch.Tensor]:
    """The images that the f32 tensor-core kernel reads for ``ops``:
    :func:`tf32_image` of ``w1`` (C_in/32, 2, F, 32) and of each tap of
    ``w2`` (9, F/32, 2, G, 32). Built at the first call with these weights
    and again only after they change in place (an inference tensor tracks
    no version: it changes only within inference mode); dropped with
    ``w1``."""
    versions = tuple(None if t.is_inference() else t._version
                     for t in (ops.w1, ops.w2))
    hit = _TF32_IMAGES.get(ops.w1)
    if hit is None or hit[0] is not ops.w2 or hit[1] != versions:
        growth, f = ops.w2.shape[2:]
        hit = (ops.w2, versions, tf32_image(ops.w1),
               tf32_image(ops.w2.reshape(9, growth, f)))
        _TF32_IMAGES[ops.w1] = hit
    return hit[2], hit[3]


def layer_operands(bn1, conv1_weight, bn2, conv2_weight, dtype) -> LayerOperands:
    """Fold one layer's BN parameters and lay its kernels out for the kernel.

    ``bn1``/``bn2`` are ``(scale, bias, mean, var)``; the conv weights are
    torch OIHW, cast to ``dtype`` (bf16 for the bf16 kernels, f32 for the
    f32 one). Unlike the TPU version nothing is padded: the kernel reads
    exactly channels ``[0, C_in)``.
    """
    inv1, sh1 = fold_bn(*bn1)
    inv2, sh2 = fold_bn(*bn2)
    w1 = conv1_weight[:, :, 0, 0].to(dtype).contiguous()
    w2 = conv2_weight.permute(2, 3, 0, 1).to(dtype).contiguous()
    return LayerOperands(inv1.contiguous(), sh1.contiguous(), w1,
                         inv2.contiguous(), sh2.contiguous(), w2)


def dense_layer_reference(state: torch.Tensor, c_in: int,
                          ops: LayerOperands) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same function, in place.

    f32 math (f64 for an f64 state: the yardstick that holds the f32
    kernels to f32 accuracy); the BN1 output and the bottleneck are rounded
    to the state's dtype before their convolution, as the kernel's tensor
    cores take them (a no-op for f32 and f64 state). conv2's zero padding
    is the image mask.
    """
    dt = state.dtype
    ct = torch.float64 if dt == torch.float64 else torch.float32
    growth = ops.w2.shape[2]
    x = state[..., :c_in].to(ct)
    h = torch.relu(x * ops.inv1.to(ct) + ops.sh1.to(ct)).to(dt).to(ct)
    b = F.conv2d(h.permute(0, 3, 1, 2), ops.w1.to(ct)[:, :, None, None])
    b = torch.relu(b * ops.inv2.to(ct)[:, None, None]
                   + ops.sh2.to(ct)[:, None, None])
    b = b.to(dt).to(ct)
    part = F.conv2d(b, ops.w2.to(ct).permute(2, 3, 0, 1), padding=1)
    state[..., c_in:c_in + growth] = part.permute(0, 2, 3, 1).to(dt)
    return state


def dense_layer_convs(state: torch.Tensor, c_in: int,
                      ops: LayerOperands) -> torch.Tensor:
    """One dense layer of any widths in place, as two ``F.conv2d`` calls:
    the counterpart of the flax module's XLA convolutions, which the JAX
    package runs for the widths no Pallas kernel takes (DenseNet161), not
    of the kernel. It rounds to the state's dtype where
    :func:`dense_layer_reference` does (the BN1 output and the bottleneck)
    and computes in f32 between, on the state's device."""
    dt = state.dtype
    growth = ops.w2.shape[2]
    x = state[..., :c_in].permute(0, 3, 1, 2).float()
    h = torch.relu(x * ops.inv1[:, None, None] + ops.sh1[:, None, None])
    b = F.conv2d(h.to(dt).float(), ops.w1.float()[:, :, None, None])
    b = torch.relu(b * ops.inv2[:, None, None] + ops.sh2[:, None, None])
    part = F.conv2d(b.to(dt).float(), ops.w2.float().permute(2, 3, 0, 1),
                    padding=1)
    state[..., c_in:c_in + growth] = part.permute(0, 2, 3, 1).to(dt)
    return state


def _check_kernel_args(state, c_in, ops, variant: str | None = None):
    """Raise on what the kernel ``variant`` does not take: the bf16 kernels
    (by default) a bf16 state and bf16 kernels, ``"f32"`` f32 throughout."""
    dt = torch.float32 if variant == "f32" else torch.bfloat16
    if state.dtype != dt:
        raise TypeError(f"dense_layer {variant or 'bf16'} kernel takes "
                        f"{dt} state, got {state.dtype}")
    if state.dim() != 4 or not state.is_contiguous():
        raise ValueError("dense_layer kernel takes a contiguous NHWC state")
    f, growth = ops.w1.shape[0], ops.w2.shape[2]
    if (f, growth) != (BOTTLENECK, GROWTH):
        raise ValueError(f"dense_layer kernel takes bottleneck {BOTTLENECK} and "
                         f"growth {GROWTH}, got {f} and {growth}")
    channels = state.shape[-1]
    if c_in % 32 or channels % 8 or c_in + growth > channels:
        raise ValueError(f"dense_layer kernel: c_in {c_in} must be a multiple "
                         f"of 32 and c_in + {growth} fit in {channels} channels")
    want = {"inv1": ((c_in,), torch.float32), "sh1": ((c_in,), torch.float32),
            "w1": ((f, c_in), dt),
            "inv2": ((f,), torch.float32), "sh2": ((f,), torch.float32),
            "w2": ((3, 3, growth, f), dt)}
    for name, (shape, dtype) in want.items():
        t = getattr(ops, name)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"dense_layer kernel: {name} must be {shape} "
                             f"{dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != state.device or not t.is_contiguous():
            raise ValueError(f"dense_layer kernel: {name} must be contiguous "
                             f"on {state.device}")
    for t in (state, *ops):
        if t.data_ptr() % 16:
            raise ValueError("dense_layer kernel takes 16-byte aligned tensors")


# The persistent kernel's shared memory, mirrored from
# csrc/dense_layer_persistent.cu (bf16 elements unless stated): w2 resident,
# the bottleneck tile, a ring of STAGES x-chunk stages (plus a w1 chunk each
# when w1 streams), w1 resident where it fits, and the BN1 vectors (f32).
SMEM_LIMIT = 232_448  # H100: the most a block can opt in to
STAGES = 3
CHUNK = 64  # input channels per ring stage
_W2_ELEMS = 9 * GROWTH * (BOTTLENECK + 8)
_BNECK_ELEMS = 100 * (BOTTLENECK + 8)
_X_STAGE_ELEMS = 112 * (CHUNK + 8)
_W1_STAGE_ELEMS = BOTTLENECK * (CHUNK + 8)
# maps below this side are the small maps; the persistent kernel was built
# and measured for the 128^2 and 64^2 maps of DenseNet at 512^2
PERSISTENT_MIN_SIDE = 64


def persistent_smem_bytes(c_in: int) -> tuple[int, bool]:
    """(dynamic shared-memory bytes, w1 resident) of the persistent kernel at
    ``c_in``: w1 is resident when that fits in ``SMEM_LIMIT``, else it
    streams beside x. The launcher refuses a launch above the limit."""
    def total(resident):
        stage = _X_STAGE_ELEMS + (0 if resident else _W1_STAGE_ELEMS)
        w1 = BOTTLENECK * (c_in + 8) if resident else 0
        return 2 * (_W2_ELEMS + _BNECK_ELEMS + STAGES * stage + w1) + 8 * c_in

    resident = total(True) <= SMEM_LIMIT
    return total(resident), resident


# The cluster kernel (csrc/dense_layer_cluster.cu), mirrored: CTA r of a
# cluster of S takes the 32-channel units [r n / S, (r + 1) n / S) of the
# n = c_in / 32 (conv1 split-K), streamed in CLUSTER_CHUNK-channel steps,
# then owns bottleneck channels [r F / S, (r + 1) F / S) (the reduce of
# conv1 and conv2's split-K) and output pixels [r 64 / S, (r + 1) 64 / S)
# of its tile. Its shared memory: a CLUSTER_STAGES-deep ring of x and w1
# chunks (later the f32 conv1 partial), its slices of w2 and of the
# bottleneck and an f32 receive buffer for the conv2 partials of its pixels.
CLUSTER_SIZES = (2, 4, 8)
CLUSTER_STAGES = 2
CLUSTER_CHUNK = 64


def cluster_partition(c_in: int, cluster: int):
    """What each CTA of a cluster of ``cluster`` takes, in rank order:
    ``(input channels, bottleneck channels, output pixels)``, each a
    [first, last) pair."""
    n, f, px = c_in // 32, BOTTLENECK // cluster, 64 // cluster
    return [((r * n // cluster * 32, (r + 1) * n // cluster * 32),
             (r * f, (r + 1) * f), (r * px, (r + 1) * px))
            for r in range(cluster)]


def cluster_smem_bytes(cluster: int) -> int:
    """Dynamic shared-memory bytes of one CTA of the cluster kernel."""
    ring = 2 * CLUSTER_STAGES * (112 + BOTTLENECK) * (CLUSTER_CHUNK + 8)
    slices = 2 * (9 * GROWTH + 100) * (BOTTLENECK // cluster + 8)
    return ring + slices + 4 * 64 * (GROWTH + 8)


# Small-map routes (map side < 64), measured on the H100 over the small-map
# layers of DenseNet121/169/201 at batch 1 and 8 (PERF.md, Findings):
# keyed by the layer's number of 8x8 tiles (batch x tiles per image) and
# its c_in. The first row that the layer meets names the kernel. Rows:
# (most tiles, least c_in, variant, cluster size).
SMALL_MAP_ROUTES = (
    (8, 0, "cluster", 8),         # 7x7 at batch 1 and 8; 16^2, 14^2 at batch 1
    (16, 1344, "cluster", 8),     # 32^2 at batch 1, c_in >= 1344
    (64, 0, "cluster", 4),        # 32^2 at batch 1 below; 16^2, 14^2 at batch 8
    (None, 0, "persistent", None),  # 32^2 at batch 8
)


def _small_map_route(tiles: int, c_in: int, variant: str | None = None):
    rows = [r for r in SMALL_MAP_ROUTES if variant in (None, r[2])]
    for most, least, v, size in rows:
        if (most is None or tiles <= most) and c_in >= least:
            return v, size
    return rows[-1][2:]


def _tiles(batch: int, height: int, width: int) -> int:
    return batch * -(-height // 8) * -(-width // 8)


def dense_layer_route(batch: int, height: int, width: int, c_in: int,
                      bottleneck: int = BOTTLENECK, growth: int = GROWTH,
                      dtype=torch.bfloat16) -> tuple[str, int | None]:
    """``(variant, cluster size)`` that ``dense_layer`` runs for a (batch,
    height, width) state of ``dtype`` at ``c_in``; the size is None unless
    the variant is ``"cluster"``. Widths other than (``BOTTLENECK``,
    ``GROWTH``), which no TPU kernel computes, go to ``"convs"``
    (:func:`dense_layer_convs`) at any dtype. An f32 state goes to the f32
    tensor-core kernel, ``"f32"``. For bf16, maps of side >= 64 go to the
    persistent kernel; smaller ones follow ``SMALL_MAP_ROUTES``. A c_in past the
    persistent kernel's budget goes to the tile kernel."""
    if (bottleneck, growth) != (BOTTLENECK, GROWTH):
        return "convs", None
    if dtype == torch.float32:
        return "f32", None
    if min(height, width) >= PERSISTENT_MIN_SIDE:
        variant, cluster = "persistent", None
    else:
        variant, cluster = _small_map_route(_tiles(batch, height, width), c_in)
    if variant == "persistent" and persistent_smem_bytes(c_in)[0] > SMEM_LIMIT:
        return "tile", None
    return variant, cluster


def dense_layer_cluster_size(batch: int, height: int, width: int,
                             c_in: int) -> int:
    """Cluster size of the cluster kernel at this shape: that of the first
    cluster row of ``SMALL_MAP_ROUTES`` that the layer meets, else that of
    the last cluster row."""
    return _small_map_route(_tiles(batch, height, width), c_in, "cluster")[1]


def dense_layer_variant(batch: int, height: int, width: int, c_in: int) -> str:
    """Which kernel ``dense_layer`` launches: :func:`dense_layer_route`'s
    variant."""
    return dense_layer_route(batch, height, width, c_in)[0]


VARIANTS = ("persistent", "tile", "cluster")  # the bf16 dense-layer kernels
KERNEL_VARIANTS = (*VARIANTS, "f32")  # every dense-layer kernel
ROUTES = (*KERNEL_VARIANTS, "convs")
_LIBRARIES = {"tile": "dense_layer", "persistent": "dense_layer_persistent",
              "cluster": "dense_layer_cluster", "f32": "dense_layer_f32_tc"}


def _launcher(variant):
    from tennis_torch.ops._build import load_library

    name = _LIBRARIES[variant]
    fn = getattr(load_library(name), f"{name}_launch")
    if fn.argtypes is None:
        # ... bottleneck, growth, then max_ctas (persistent) or the cluster
        # size (cluster)
        n_int = 7 if variant in ("tile", "f32") else 8
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@torch.library.custom_op("tennis_torch::dense_layer", mutates_args={"state"},
                         device_types="cpu")
def dense_layer_op(state: torch.Tensor, inv1: torch.Tensor, sh1: torch.Tensor,
                   w1: torch.Tensor, inv2: torch.Tensor, sh2: torch.Tensor,
                   w2: torch.Tensor, w1_tf32: torch.Tensor | None,
                   w2_tf32: torch.Tensor | None, c_in: int, variant: str,
                   cluster: int) -> None:
    """``tennis_torch::dense_layer``: one dense layer in place on ``state``,
    as a custom op, so that ``torch.export`` keeps it as one node naming its
    kernel. ``variant`` and ``cluster`` (0 where the variant takes none) are
    :func:`dense_layer_route`'s; ``w1_tf32``/``w2_tf32`` are the f32
    kernel's weight images (:func:`_tf32_weights`), None for the others.
    On the CPU it runs :func:`dense_layer_reference`, whatever the
    variant."""
    dense_layer_reference(state, c_in,
                          LayerOperands(inv1, sh1, w1, inv2, sh2, w2))


@dense_layer_op.register_kernel("cuda")
def _dense_layer_cuda(state, inv1, sh1, w1, inv2, sh2, w2, w1_tf32, w2_tf32,
                      c_in, variant, cluster):
    """The launch: the kernel ``variant`` names, or a raise; no fallback."""
    ops = LayerOperands(inv1, sh1, w1, inv2, sh2, w2)
    _check_kernel_args(state, c_in, ops, variant)
    if variant == "f32":
        if w1_tf32 is None or w2_tf32 is None:
            raise ValueError("dense_layer f32 kernel takes the weight images "
                             "of _tf32_weights")
        w1, w2 = w1_tf32, w2_tf32
    B, H, W, C = state.shape
    args = [state.data_ptr(), inv1.data_ptr(), sh1.data_ptr(), w1.data_ptr(),
            inv2.data_ptr(), sh2.data_ptr(), w2.data_ptr(),
            B, H, W, C, c_in, BOTTLENECK, GROWTH]
    if variant == "persistent":
        args.append(_sm_count(state.device.index))
    elif variant == "cluster":
        args.append(cluster)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    with torch.cuda.device(state.device):
        err = _launcher(variant)(*args, stream)
    if err:
        size = f" (cluster {cluster})" if variant == "cluster" else ""
        raise RuntimeError(f"dense_layer {variant} kernel{size} launch failed: "
                           f"CUDA error {err}")
    dense_layer.launches += 1
    dense_layer.variant_launches[variant] += 1


@dense_layer_op.register_fake
def _(state, inv1, sh1, w1, inv2, sh2, w2, w1_tf32, w2_tf32, c_in, variant,
      cluster):
    return None


def dense_layer(state: torch.Tensor, c_in: int, ops: LayerOperands,
                variant: str | None = None,
                cluster: int | None = None) -> torch.Tensor:
    """One dense layer in place: reads channels ``[0, c_in)`` of the NHWC
    block state, writes its growth part to ``[c_in, c_in + G)``; returns
    ``state``. The kernel widths go through :func:`dense_layer_op`: CUDA
    tensors to the kernel that ``variant`` names (``"persistent"``,
    ``"tile"`` or ``"cluster"``, with ``cluster`` CTAs per tile, for a bf16
    state; ``"f32"`` for an f32 one; by default :func:`dense_layer_route`'s
    choice by the state's dtype), CPU tensors to
    :func:`dense_layer_reference`, whatever the variant. The variant and
    the cluster size are resolved here from the static shapes, so a traced
    graph names the kernel it launches. Widths no kernel takes go to
    :func:`dense_layer_convs` on the card (the reference on the CPU),
    outside the op. The call is the span ``dense_layer``
    (:mod:`tennis_torch.utils.tracing`), around the op."""
    with span("dense_layer"):
        if variant is not None and variant not in KERNEL_VARIANTS:
            raise ValueError(f"dense_layer variant must be one of "
                             f"{KERNEL_VARIANTS}, not {variant!r}")
        if state.device.type not in ("cpu", "cuda"):
            raise ValueError(f"dense_layer runs on cuda or cpu, not "
                             f"{state.device}")
        B, H, W, _ = state.shape
        if variant is None:
            variant, routed = dense_layer_route(
                B, H, W, c_in, ops.w1.shape[0], ops.w2.shape[2], state.dtype)
            cluster = cluster or routed
            if variant == "convs":
                if state.device.type == "cpu":
                    return dense_layer_reference(state, c_in, ops)
                dense_layer_convs(state, c_in, ops)
                dense_layer.variant_launches["convs"] += 1
                return state
        if variant == "cluster" and cluster is None:
            cluster = dense_layer_cluster_size(B, H, W, c_in)
        images = (None, None)
        if variant == "f32" and state.device.type == "cuda":
            images = _tf32_weights(ops)
        dense_layer_op(state, *ops, *images, c_in, variant, cluster or 0)
        return state


# kernel launches, so a run can show it took the kernels, and which one
# ("convs" counts the layers routed to dense_layer_convs, no kernel launch)
dense_layer.launches = 0
dense_layer.variant_launches = dict.fromkeys(ROUTES, 0)


def _bn_relu(x, inv_shift, dtype):
    inv, shift = inv_shift
    return torch.relu(x.float() * inv + shift).to(dtype)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def densenet_features(spec, operands: dict, x: torch.Tensor, dtype,
                      layer=dense_layer) -> torch.Tensor:
    """DenseNet feature extraction, every dense layer through ``layer``.

    Equivalent to ``DenseNet.apply(..., train=False)`` of the JAX package:
    (B, H, W, C) prepared input -> (B, F) features, flattened in NHWC order
    after the fixed k = min(7, side), stride-k average pool (512^2 input:
    2 x 2 x 1024 = 4096). ``operands`` comes from ``DenseNet.operands()``.
    ``layer`` is :func:`dense_layer`; a comparison may pass
    :func:`dense_layer_reference` to run the plain version on any device.
    Each transition is the span ``transition``.
    """
    x = x.to(dtype)
    x = _nhwc(F.conv2d(_nchw(x), operands["conv0"], stride=2, padding=3))
    x = _bn_relu(x, operands["bn0"], dtype)
    # max-pool padding counts as -inf, as in the JAX stem
    x = _nhwc(F.max_pool2d(_nchw(x), 3, stride=2, padding=1))

    channels = spec.num_init_features
    last = len(spec.block_config) - 1
    for i, num_layers in enumerate(spec.block_config):
        c_final = channels + num_layers * spec.growth_rate
        B, H, W, _ = x.shape
        # channels past the live ones are written by a layer before any reads
        state = torch.empty((B, H, W, c_final), dtype=dtype, device=x.device)
        state[..., :channels] = x
        for ops in operands["layers"][i]:
            state = layer(state, channels, ops)
            channels += spec.growth_rate
        x = state
        if i != last:
            with span("transition"):
                bn, w = operands["transitions"][i]
                x = _bn_relu(x, bn, dtype) @ w  # 1x1 conv: (C, C/2) in dtype
                x = _nhwc(F.avg_pool2d(_nchw(x), 2, stride=2))
            channels //= 2

    x = _bn_relu(x, operands["bn_final"], dtype)
    k = min(7, x.shape[1])
    x = _nhwc(F.avg_pool2d(_nchw(x), k, stride=k))
    return x.reshape(x.shape[0], -1)  # NHWC flatten order, as the JAX head


def frame_model_apply(model, x: torch.Tensor, layer=dense_layer) -> torch.Tensor:
    """``FrameModel(DenseNet)`` forward with every dense layer through
    ``layer``: prepared input -> f32 logits (features when the model has no
    head). Counterpart of ``frame_model_apply_pallas``."""
    backbone = model.backbone
    feats = densenet_features(backbone.spec, backbone.operands(), x,
                              backbone.dtype, layer=layer)
    return model.head(feats)


@contextlib.contextmanager
def plain_dense_layers(model):
    """Within this context every ``DenseNet`` of ``model`` runs its eval
    forward with each dense layer through :func:`dense_layer_reference`, on
    any device, and counts no launch: the plain version that a comparison
    holds the kernels against. Only its caller chooses it; no kernel
    failure leads here."""
    from tennis_torch.models.backbones.densenet import DenseNet

    def plain(net):
        def forward(x, train=False):
            if train:
                raise ValueError("the plain version is of the eval forward")
            return densenet_features(net.spec, net.operands(), x, net.dtype,
                                     layer=dense_layer_reference)
        return forward

    nets = [m for m in model.modules() if isinstance(m, DenseNet)]
    for net in nets:
        net.forward = plain(net)
    try:
        yield model
    finally:
        for net in nets:
            del net.forward
