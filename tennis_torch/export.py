"""Ahead-of-time export (counterpart of ``tennis_tpu/export.py``): a trained
experiment -> one ``torch.export`` program plus a JSON sidecar, loadable for
serving without the model code.

``tennis_torch.inference`` builds the live scorers; this module freezes the
same forward through ``torch.export`` into a saved program that carries its
weights, with the JAX package's sidecar (same keys, ``format_version`` 1).
Both TPU kernels are ``torch.library`` custom ops
(``tennis_torch::dense_layer``, ``tennis_torch::gru_recurrence``), so an
exported graph holds one node per kernel launch, and the loaded program
launches the same CUDA kernels as the live path. Two artifact kinds:

- ``vision-classifier``: uint8 (B, S, S, 3) -> ``device_prepare`` -> the eval
  forward (a DenseNet's 58 dense layers through the dense-layer op) -> f32
  softmax. The program carries exactly the tensors its forward reads (for
  a DenseNet the BN-folded operands) as constants.
- ``captioner``: the GNMT beam decode (encode -> Luong-attention decode,
  beam 4, GNMT length penalty) with the search as one ``while_loop`` and
  ``valid_best.params`` as the program's state; the sidecar carries the
  vocabulary and BOS/EOS ids. By default the encoder traces the plain
  recurrence (one ``while_loop`` a layer); ``--pallas_gru`` traces the GRU
  kernel's op.

``load_exported`` and ``load_exported_captioner`` import this module and the
two op registrations only: no model code, no checkpoint code. A program runs
on the device it was traced on, which the sidecar's ``platforms`` names
(``["cuda"]`` or ``["cpu"]``).

CLI (the JAX exporter's flags, plus ``--device``):

    python -m tennis_torch.export --model_id 0006 --backbone DenseNet121 \\
        --batch_size 8 --out 0006.pt2
    python -m tennis_torch.export --kind captioner --model_id 0102 \\
        --gnmt_flag=--feats_model=0006 --batch_size 4 --src_max_len 128

Export is shape-static, as in the JAX package: pick the serving batch size
here; ``tennis_torch.serve --from_export`` pads every batch to it.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

# the op registrations a saved program names; they import torch only
import tennis_torch.ops.dense_block  # noqa: F401
import tennis_torch.ops.gru  # noqa: F401

log = logging.getLogger(__name__)

_META_SUFFIX = ".json"
_FORMAT_VERSION = 1
PLATFORMS = ("cuda", "cpu")
_ZIP_MAGIC = b"PK\x03\x04"  # torch.export.save writes a zip archive


class _Program(torch.nn.Module):
    """The module ``torch.export`` traces: ``fn(*inputs)``; ``state`` (a
    module or None) holds the parameters that become the program's
    state."""

    def __init__(self, fn, state: torch.nn.Module | None = None):
        super().__init__()
        self._fn = fn
        self.state = state

    def forward(self, *inputs):
        return self._fn(*inputs)


def _device(platforms, device: str) -> torch.device:
    """The one device a program is traced for: ``platforms`` (one of
    ``PLATFORMS``) when given, else ``device``."""
    from tennis_torch.inference import resolve_device

    platforms = list(platforms or ())
    if len(platforms) > 1 or any(p not in PLATFORMS for p in platforms):
        raise ValueError(f"platforms {platforms}: a torch.export program runs "
                         f"on the one device it was traced on, one of "
                         f"{PLATFORMS}")
    return resolve_device(platforms[0] if platforms else device)


def _export(fn, inputs, state=None):
    """``torch.export.export`` of ``fn`` under ``torch.no_grad()`` (export
    refuses inference tensors), without ``run_decompositions``: that would
    functionalize the graph and clone the block state at each dense
    layer."""
    with torch.no_grad():
        return torch.export.export(_Program(fn, state), tuple(inputs))


def export_classifier(backbone: str, model_id: str, data_shape: int,
                      batch_size: int, root: str = "data", platforms=None,
                      device: str = "cuda"):
    """Freeze the experiment's best epoch into ``(program, meta)``: an
    ``ExportedProgram`` mapping a uint8 image batch (B, S, S, 3) on its
    device to f32 softmax probabilities (B, num_classes), and the
    sidecar."""
    from tennis_torch.inference import fold_densenets, load_classifier_state, \
        prepare_input

    dev = _device(platforms, device)
    classes, model, info = load_classifier_state(backbone, model_id,
                                                 data_shape, root)
    model = model.to(dev).eval()
    fold_densenets(model)

    def scorer(images):
        logits = model(prepare_input(images, model.dtype))
        return torch.softmax(logits, dim=-1)

    images = torch.zeros((batch_size, data_shape, data_shape, 3),
                         dtype=torch.uint8, device=dev)
    program = _export(scorer, (images,))
    meta = {
        "format_version": _FORMAT_VERSION,
        "kind": "vision-classifier",
        "backbone": backbone,
        "model_id": model_id,
        "classes": list(classes),
        "batch_size": int(batch_size),
        "data_shape": int(data_shape),
        "input": {"shape": [batch_size, data_shape, data_shape, 3],
                  "dtype": "uint8"},
        "output": {"shape": [batch_size, len(classes)], "dtype": "float32"},
        "platforms": [dev.type],
        "epoch": int(info["epoch"]),
        "score": None if info["score"] is None else float(info["score"]),
        "exp_dir": info["exp_dir"],
    }
    return program, meta


def export_captioner(model_id: str, batch_size: int, src_max_len: int = 128,
                     root: str = "data", gnmt_argv=(), platforms=None,
                     gru_kernel: bool = False, device: str = "cuda"):
    """Freeze a captioning experiment's beam decode into ``(program,
    meta)``: f32 features (B, src_max_len, D) + int32 valid lengths (B,) ->
    ``(samples (B, K, L) int32, scores (B, K) f32, valid_length (B, K)
    int32)``, ``valid_best.params`` in the program's state. ``gru_kernel``
    (the CLI's ``--pallas_gru``) traces the encoder's GRU recurrences
    through the GRU kernel's op; by default the plain recurrence, as the
    JAX package's portable default traces its scan."""
    from tennis_torch.inference import load_captioner_state
    from tennis_torch.translation import BeamSearchTranslator

    dev = _device(platforms, device)
    vocab, model, info = load_captioner_state(
        model_id, root=root, gnmt_argv=gnmt_argv, src_max_len=src_max_len)
    model = model.to(dev).eval()
    translator = BeamSearchTranslator(
        model, bos_id=vocab[vocab.bos_token], eos_id=vocab[vocab.eos_token],
        beam_size=info["beam_size"], alpha=info["lp_alpha"], K=info["lp_k"],
        max_length=info["max_length"])
    decode = translator.build_decoder(batch_size, gru_kernel=gru_kernel)
    feat_dim = info["feat_dim"]
    inputs = (torch.zeros((batch_size, src_max_len, feat_dim),
                          dtype=torch.float32, device=dev),
              torch.full((batch_size,), src_max_len, dtype=torch.int32,
                         device=dev))
    program = _export(decode, inputs, state=model)
    meta = {
        "format_version": _FORMAT_VERSION,
        "kind": "captioner",
        "model_id": model_id,
        "batch_size": int(batch_size),
        "src_max_len": int(src_max_len),
        "feat_dim": int(feat_dim),
        "input": {"shape": [batch_size, src_max_len, feat_dim],
                  "dtype": "float32"},
        "idx_to_token": list(vocab.idx_to_token),
        "bos_id": int(vocab[vocab.bos_token]),
        "eos_id": int(vocab[vocab.eos_token]),
        "beam_size": int(info["beam_size"]),
        "lp_alpha": float(info["lp_alpha"]),
        "lp_k": int(info["lp_k"]),
        "max_length": int(info["max_length"]),
        "platforms": [dev.type],
        "exp_dir": info["exp_dir"],
    }
    return program, meta


def save_exported(out_path: str, program, meta: dict) -> None:
    """Write ``out_path`` (``torch.export.save`` of the program) and
    ``out_path + '.json'`` (the sidecar), each via a temporary file and an
    atomic replace."""
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.export.save(program, f)
    os.replace(tmp, out_path)
    tmp = f"{out_path}{_META_SUFFIX}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, out_path + _META_SUFFIX)


def _load_artifact(path: str, kind: str):
    """``(module, meta, device)`` of a saved program after the sidecar's
    ``format_version`` and ``kind`` guards; a ``tennis_tpu.export``
    StableHLO artifact is refused."""
    with open(path + _META_SUFFIX) as f:
        meta = json.load(f)
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"{path}: unsupported export format {meta.get('format_version')} "
            f"(this loader reads version {_FORMAT_VERSION})")
    if meta.get("kind") != kind:
        raise ValueError(f"{path}: artifact kind {meta.get('kind')!r} — this "
                         f"loader reads {kind!r} exports")
    with open(path, "rb") as f:
        magic = f.read(len(_ZIP_MAGIC))
    platforms = meta.get("platforms") or []
    if magic != _ZIP_MAGIC or len(platforms) != 1 or \
            platforms[0] not in PLATFORMS:
        raise ValueError(
            f"{path}: not a tennis_torch.export program (platforms "
            f"{platforms}); a tennis_tpu.export StableHLO artifact runs only "
            f"in the JAX package")
    if platforms[0] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} runs on CUDA but no GPU is available "
                           f"(export it again with --platforms cpu)")
    return torch.export.load(path).module(), meta, torch.device(platforms[0])


def load_exported(path: str):
    """Rebuild ``(classes, predict_probs, meta)`` from an exported artifact,
    the drop-in shape of ``tennis_torch.inference.load_classifier``, with no
    model code. ``predict_probs`` maps a uint8 (B, S, S, 3) batch (B fixed
    at export time) to host (B, num_classes) float32 softmax."""
    program, meta, device = _load_artifact(path, "vision-classifier")
    expect = tuple(meta["input"]["shape"])

    def predict_probs(images) -> np.ndarray:
        images = np.asarray(images)
        if images.shape != expect or images.dtype != np.uint8:
            raise ValueError(
                f"exported program is shape-static: expected uint8 {expect}, "
                f"got {images.dtype} {images.shape}")
        with torch.no_grad():
            probs = program(torch.from_numpy(images).to(device))
        return probs.cpu().numpy()

    return list(meta["classes"]), predict_probs, meta


def load_exported_captioner(path: str):
    """Rebuild ``(idx_to_token, caption_batch, meta)`` from a captioner
    export, the drop-in shape of ``tennis_torch.inference.load_captioner``
    with the sidecar vocabulary in place of the Vocab object.
    ``caption_batch`` maps a float32 (B, src_max_len, D) feature batch and
    int32 (B,) valid lengths to B token lists (the top beam, BOS/EOS
    stripped)."""
    program, meta, device = _load_artifact(path, "captioner")
    expect = tuple(meta["input"]["shape"])
    idx_to_token = list(meta["idx_to_token"])

    def caption_batch(feats, lengths):
        feats = np.asarray(feats, np.float32)
        lengths = np.asarray(lengths, np.int32)
        if feats.shape != expect or lengths.shape != (expect[0],):
            raise ValueError(
                f"exported program is shape-static: expected float32 "
                f"{expect} + int32 ({expect[0]},), got {feats.shape} / "
                f"{lengths.shape}")
        with torch.no_grad():
            samples, _scores, valid = program(
                torch.from_numpy(feats).to(device),
                torch.from_numpy(lengths).to(device))
        samples, valid = samples.cpu().numpy(), valid.cpu().numpy()
        out = []
        for b in range(samples.shape[0]):
            vl = int(valid[b, 0])
            # 1:vl-1 strips BOS and EOS, as translate_tokens does
            out.append([idx_to_token[int(i)] for i in samples[b, 0, 1:vl - 1]])
        return out

    return idx_to_token, caption_batch, meta


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kind", default="vision", choices=["vision", "captioner"],
                   help="what to freeze: the classifier forward or the "
                        "captioner beam decode")
    p.add_argument("--root", default="data",
                   help="dataset root (classes.names)")
    p.add_argument("--model_id", default="0006", help="experiment id")
    p.add_argument("--backbone", default="DenseNet121",
                   help="backbone the experiment was trained with (vision)")
    p.add_argument("--data_shape", type=int, default=512,
                   help="input crop side (vision)")
    p.add_argument("--batch_size", type=int, default=8,
                   help="static serving batch size")
    p.add_argument("--src_max_len", type=int, default=128,
                   help="static source frame count (captioner)")
    p.add_argument("--gnmt_flag", action="append", default=[],
                   help="architecture flags forwarded to the train_gnmt "
                        "surface when loading a captioner (e.g. "
                        "--gnmt_flag=--num_hidden=256 "
                        "--gnmt_flag=--feats_model=0006)")
    p.add_argument("--pallas_gru", action="store_true",
                   help="trace the captioner encoder's GRU recurrences "
                        "through the GRU kernel's custom op")
    p.add_argument("--platforms", default="", choices=("", *PLATFORMS),
                   help="the device the program runs on: cuda or cpu (a "
                        "torch.export program runs on the one device it was "
                        "traced on); empty = --device")
    p.add_argument("--out", default="",
                   help="artifact path (default: <exp_dir>/export_*.pt2)")
    p.add_argument("--device", default="cuda", choices=list(PLATFORMS),
                   help="device the program is traced for")
    args = p.parse_args(argv)
    if min(args.batch_size, args.src_max_len, args.data_shape) < 1:
        p.error("--batch_size, --src_max_len and --data_shape must be >= 1")
    return args


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    platforms = [args.platforms] if args.platforms else []
    if args.kind == "captioner":
        program, meta = export_captioner(
            args.model_id, args.batch_size, src_max_len=args.src_max_len,
            root=args.root, gnmt_argv=args.gnmt_flag, platforms=platforms,
            gru_kernel=args.pallas_gru, device=args.device)
        out = args.out or os.path.join(
            meta["exp_dir"],
            f"export_cap_b{args.batch_size}_t{args.src_max_len}.pt2")
    else:
        program, meta = export_classifier(
            args.backbone, args.model_id, args.data_shape, args.batch_size,
            root=args.root, platforms=platforms, device=args.device)
        out = args.out or os.path.join(
            meta["exp_dir"], f"export_b{args.batch_size}_s{args.data_shape}.pt2")
    save_exported(out, program, meta)
    size = os.path.getsize(out)
    log.info("exported %s (%d bytes, platforms=%s) + %s", out, size,
             ",".join(meta["platforms"]), out + _META_SUFFIX)
    print(f"exported {out} ({size} bytes, "
          f"platforms={','.join(meta['platforms'])})")
    return out


if __name__ == "__main__":
    main()
