"""Online HTTP serving for the event classifier and the captioner
(counterpart of ``tennis_tpu/serve.py``).

A stdlib ``http.server`` endpoint that decodes posted JPEGs, coalesces
concurrent requests into one static-shape device batch, and answers each with
the class distribution; with a captioner mounted, it also captions posted
frame-feature sequences.

API:

- ``POST /predict`` — body: JPEG bytes -> ``{"label": str, "probs": [float],
  "classes": [str]}``
- ``POST /caption`` — body: ``np.save`` bytes of a float (T, D) frame-feature
  sequence -> ``{"caption": str, "tokens": [str], "frames_used": int}``.
  Mounted when ``--caption_model_id`` names a captioning experiment
  (features path) or ``--caption_from_export`` a captioner artifact;
  sequences are truncated or zero-padded to ``--src_max_len`` and coalesced
  by their own batcher into beam decodes of ``--caption_batch_size`` rows.
- ``GET /healthz``  — liveness + counters (requests served, batches run, mean
  rows per batch; caption counters when mounted)

Batching: requests park in a queue; one dispatcher thread drains up to
``--batch_size`` of them (waiting at most ``--max_wait_ms`` after the first),
edge-pads to the static batch shape, runs the model once, and wakes each
waiter with its row. One consumer thread means the model needs no lock.
Decode uses the native libjpeg path (DCT-domain downscale) with a cv2
fallback, like the training loader.

Run: ``python -m tennis_torch.serve --model_id 0006 --backbone DenseNet121
--port 8000`` (on the GPU; ``--device cpu`` to run on the CPU), adding
``--caption_model_id 0102 --gnmt_flag=--feats_model=0006
--gnmt_flag=--num_hidden=256`` to mount ``/caption``; or from
``tennis_torch.export`` artifacts with no model code or checkpoint:
``python -m tennis_torch.serve --from_export 0006.pt2
[--caption_from_export 0102.pt2]`` (the sidecars pin the static batches,
the crop side and the source length; the artifact names its device).
"""
from __future__ import annotations

import argparse
import io
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, NamedTuple

import numpy as np

log = logging.getLogger(__name__)

_MAX_BODY = 32 * 2**20  # reject absurd uploads before reading them


def decode_rgb(data: bytes, data_shape: int) -> np.ndarray:
    """JPEG bytes -> uint8 RGB after the eval geometry (Resize+32,
    CenterCrop). The native libjpeg path first (DCT-domain downscale for
    oversized sources, as the training loader), cv2.imdecode for anything
    else."""
    from tennis_torch.data.transforms import test_geometry
    from tennis_torch.native.jpeg import decode_jpeg

    rgb = decode_jpeg(data, min_short=data_shape + 32)
    if rgb is None:
        import cv2

        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if bgr is None:
            raise ValueError("body is not a decodable image")
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    h, w = rgb.shape[:2]
    # resize_shorter scales the LONG side by data_shape/short: a degenerate
    # 1xN image would ask cv2 for a multi-GB buffer before failing
    if min(h, w) == 0 or max(h, w) / min(h, w) > 20:
        raise ValueError(f"degenerate image geometry {h}x{w}")
    return test_geometry(rgb, data_shape)


class Captioner(NamedTuple):
    """What ``/caption`` serves: ``caption_fn(feats (B, src_max_len,
    feat_dim) f32, lengths (B,) int32) -> B token lists`` at a static
    ``batch_size``."""
    caption_fn: Callable
    feat_dim: int
    src_max_len: int
    batch_size: int


class Batcher:
    """Coalesce concurrent single-image requests into static device batches.

    ``submit`` parks the calling (server) thread; the one dispatcher thread
    drains up to ``batch_size`` requests — waiting at most ``max_wait_s``
    after the first — edge-pads to the static shape, runs ``fn`` once, and
    hands each waiter its row. Single consumer => ``fn`` needs no lock.
    """

    def __init__(self, fn, batch_size: int, max_wait_s: float):
        self._fn = fn
        self._batch = batch_size
        self._wait = max_wait_s
        self._q: queue.Queue = queue.Queue()
        self.batches = 0
        self.rows = 0
        # monotonic start of the device call in flight, None when idle: a
        # hung device call must show up on /healthz, not keep answering 'ok'
        self.inflight_since: float | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @property
    def batch_size(self) -> int:
        return self._batch

    def submit(self, img: np.ndarray, timeout: float | None = None):
        done = threading.Event()
        box: list = [None, None]  # result row | exception
        self._q.put((img, done, box))
        if not done.wait(timeout):
            raise TimeoutError("inference batch did not complete in time")
        if box[1] is not None:
            raise box[1]
        return box[0]

    def stalled(self, bound_s: float) -> bool:
        start = self.inflight_since
        return start is not None and time.monotonic() - start > bound_s

    def _drain(self):
        first = self._q.get()  # block until there is work
        items = [first]
        deadline = time.monotonic() + self._wait
        while len(items) < self._batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                items.append(self._q.get(timeout=left))
            except queue.Empty:
                break
        return items

    def _run(self):
        while True:
            items = self._drain()
            n = len(items)
            imgs = [it[0] for it in items]
            imgs.extend([imgs[-1]] * (self._batch - n))  # edge-pad: static shape
            if isinstance(imgs[0], tuple):
                # multi-component samples stack per component and fan out as
                # positional args
                args = tuple(np.stack(c) for c in zip(*imgs))
            else:
                args = (np.stack(imgs),)
            self.inflight_since = time.monotonic()
            try:
                out = self._fn(*args)
                out = out if isinstance(out, list) else np.asarray(out)
                # count BEFORE waking waiters: a /healthz racing the released
                # requests must never see requests > 0 with batches == 0
                self.batches += 1
                self.rows += n
                for i, (_, done, box) in enumerate(items):
                    box[0] = out[i]
                    done.set()
            except Exception as e:  # surface device errors on every waiter
                self.batches += 1
                self.rows += n
                for _, done, box in items:
                    box[1] = e
                    done.set()
            finally:
                self.inflight_since = None


def make_service(classes, predict_probs, batch_size: int, data_shape: int,
                 max_wait_ms: int = 5, request_timeout_s: int = 120,
                 captioner: Captioner | None = None):
    """Mount ``/predict`` and ``/healthz`` over ``predict_probs`` (uint8
    (B, S, S, 3) -> (B, classes) probabilities), and ``/caption`` over
    ``captioner`` when given; returns (handler_cls, batcher). The handler
    class also carries both batchers (``batcher``, ``caption_batcher``).
    ``predict_probs`` may be None to serve captions only (``/predict`` then
    answers 404). Each model runs once on zeros first, so the first request
    does not pay for the kernel builds and warm-up."""
    batcher = None
    if predict_probs is not None:
        predict_probs(np.zeros((batch_size, data_shape, data_shape, 3),
                               np.uint8))
        batcher = Batcher(predict_probs, batch_size, max_wait_ms / 1e3)
    cap_batcher = None
    if captioner is not None:
        captioner.caption_fn(
            np.zeros((captioner.batch_size, captioner.src_max_len,
                      captioner.feat_dim), np.float32),
            np.ones((captioner.batch_size,), np.int32))
        cap_batcher = Batcher(captioner.caption_fn, captioner.batch_size,
                              max_wait_ms / 1e3)
    timeout_s = float(request_timeout_s)

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply(404, {"error": "unknown path"})
            mounted = [b for b in (batcher, cap_batcher) if b is not None]
            stalled = any(b.stalled(timeout_s) for b in mounted)
            rows = batcher.rows if batcher is not None else 0
            batches = batcher.batches if batcher is not None else 0
            payload = {
                "status": "stalled" if stalled else "ok",
                "requests": rows,
                "batches": batches,
                "mean_rows_per_batch": round(rows / max(batches, 1), 2),
            }
            if cap_batcher is not None:
                payload["caption_requests"] = cap_batcher.rows
                payload["caption_batches"] = cap_batcher.batches
            self._reply(503 if stalled else 200, payload)

        def _read_body(self):
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = 0
            if length <= 0:
                self._reply(400, {"error": f"bad Content-Length {length}"})
                return None
            if length > _MAX_BODY:
                self._reply(413, {"error": f"body over {_MAX_BODY}B"})
                return None
            return self.rfile.read(length)

        def _submit(self, b, item):
            """Batcher round trip with the shared error -> status mapping;
            returns the row, or None after an error reply."""
            try:
                return b.submit(item, timeout=timeout_s)
            except TimeoutError:
                self._reply(503, {"error": "inference timed out"})
            except Exception as e:  # device-side failure: a 500, not a
                log.exception("batch failed")  # dropped connection
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return None

        def do_POST(self):
            if self.path == "/caption":
                return self._do_caption()
            if self.path != "/predict" or batcher is None:
                return self._reply(404, {"error": "unknown path"})
            body = self._read_body()
            if body is None:
                return
            try:
                img = decode_rgb(body, data_shape)
            except Exception as e:
                # cv2.error/MemoryError from adversarial images are the
                # client's fault too — a 400, never a dropped connection
                return self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            probs = self._submit(batcher, img)
            if probs is None:
                return
            self._reply(200, {
                "label": classes[int(np.argmax(probs))],
                "probs": [round(float(p), 6) for p in probs],
                "classes": classes,
            })

        def _do_caption(self):
            """POST /caption: ``np.save`` bytes of a float (T, D) feature
            sequence -> ``{"caption", "tokens", "frames_used"}``. Sequences
            longer than src_max_len use its first src_max_len frames."""
            if cap_batcher is None:
                return self._reply(404, {
                    "error": "no captioner mounted (start with "
                             "--caption_model_id or --caption_from_export)"})
            body = self._read_body()
            if body is None:
                return
            feat_dim, src_max_len = captioner.feat_dim, captioner.src_max_len
            try:
                feats = np.load(io.BytesIO(body), allow_pickle=False)
            except Exception as e:
                return self._reply(400, {"error": f"body is not a .npy "
                                                  f"array: {e}"})
            if feats.ndim != 2 or feats.shape[0] < 1:
                return self._reply(400, {
                    "error": f"expected (T, {feat_dim}) features, got "
                             f"{feats.shape}"})
            # a well-formed .npy can carry strings, datetimes or timedeltas:
            # only real numeric kinds go on to the float32 copy
            # (np.number would admit timedelta64, which subclasses integer)
            if feats.dtype.kind not in "fiu":
                return self._reply(400, {
                    "error": f"expected real numeric features, got dtype "
                             f"{feats.dtype}"})
            if feats.shape[1] != feat_dim:
                return self._reply(400, {
                    "error": f"feature dim {feats.shape[1]} != model's "
                             f"{feat_dim}"})
            n = min(feats.shape[0], src_max_len)
            padded = np.zeros((src_max_len, feat_dim), np.float32)
            padded[:n] = feats[:n]
            tokens = self._submit(cap_batcher, (padded, np.int32(n)))
            if tokens is None:
                return
            self._reply(200, {
                "caption": " ".join(tokens),
                "tokens": list(tokens),
                "frames_used": int(n),
            })

        def log_message(self, fmt, *args):  # route to logging, not stderr
            log.info("%s %s", self.address_string(), fmt % args)

    Handler.batcher = batcher
    Handler.caption_batcher = cap_batcher
    return Handler, batcher


def build_service(args: argparse.Namespace):
    """Load the experiment's best checkpoint, or the ``--from_export``
    artifact, and return (handler_cls, batcher)."""
    if args.from_export:
        # the program and its sidecar are the model: its geometry is fixed,
        # so the sidecar (not the flags) sets the batch and crop side
        from tennis_torch.export import load_exported

        classes, predict_probs, meta = load_exported(args.from_export)
        batch_size, data_shape = meta["batch_size"], meta["data_shape"]
        if (batch_size, data_shape) != (args.batch_size, args.data_shape):
            log.info("export sidecar overrides flags: batch_size=%d "
                     "data_shape=%d (artifact %s, experiment %s epoch %d)",
                     batch_size, data_shape, args.from_export,
                     meta["model_id"], meta["epoch"])
    else:
        from tennis_torch.inference import load_classifier

        classes, predict_probs, _info = load_classifier(
            args.backbone, args.model_id, args.data_shape, args.root,
            device=args.device)
        batch_size, data_shape = args.batch_size, args.data_shape
    captioner = None
    if args.caption_from_export:
        from tennis_torch.export import load_exported_captioner

        _toks, caption_fn, cmeta = load_exported_captioner(
            args.caption_from_export)
        captioner = Captioner(caption_fn, cmeta["feat_dim"],
                              cmeta["src_max_len"], cmeta["batch_size"])
        if cmeta["batch_size"] != args.caption_batch_size:
            log.info("captioner sidecar overrides flags: batch_size=%d "
                     "src_max_len=%d", cmeta["batch_size"],
                     cmeta["src_max_len"])
    elif args.caption_model_id:
        from tennis_torch.inference import load_captioner

        _vocab, caption_fn, info = load_captioner(
            args.caption_model_id, root=args.root, gnmt_argv=args.gnmt_flag,
            src_max_len=args.src_max_len, device=args.device)
        captioner = Captioner(caption_fn, info["feat_dim"], args.src_max_len,
                              args.caption_batch_size)
    return make_service(classes, predict_probs, batch_size, data_shape,
                        args.max_wait_ms, args.request_timeout_s, captioner)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default="data",
                   help="Dataset root (classes.names lookup only)")
    p.add_argument("--model_id", default="0000",
                   help="Experiment id holding the checkpoint")
    p.add_argument("--backbone", default="DenseNet121", help="Backbone CNN name")
    p.add_argument("--data_shape", type=int, default=512, help="Input crop side")
    p.add_argument("--host", default="127.0.0.1", help="Bind address")
    p.add_argument("--port", type=int, default=8000,
                   help="Bind port (0 = ephemeral)")
    p.add_argument("--batch_size", type=int, default=8,
                   help="Static device batch (coalescing cap)")
    p.add_argument("--max_wait_ms", type=int, default=5,
                   help="Max wait after the first queued request before "
                        "dispatching a partial batch")
    p.add_argument("--request_timeout_s", type=int, default=120,
                   help="Per-request wait on the device batch before "
                        "answering 503; /healthz reports 'stalled' past it")
    p.add_argument("--caption_model_id", default="",
                   help="Captioning experiment id; non-empty mounts POST "
                        "/caption (features-path GNMT beam decode)")
    p.add_argument("--gnmt_flag", action="append", default=[],
                   help="Architecture flags forwarded to the train_gnmt flag "
                        "surface when loading --caption_model_id (e.g. "
                        "--gnmt_flag=--num_hidden=256 "
                        "--gnmt_flag=--feats_model=0006)")
    p.add_argument("--src_max_len", type=int, default=128,
                   help="Static source length for /caption: posted feature "
                        "sequences are truncated/padded to this many frames")
    p.add_argument("--caption_batch_size", type=int, default=4,
                   help="Static device batch for /caption coalescing")
    p.add_argument("--from_export", default="",
                   help="Path to a tennis_torch.export artifact: serve "
                        "/predict from the saved program (no model code or "
                        "checkpoint; --backbone/--model_id/--data_shape/"
                        "--batch_size come from its sidecar)")
    p.add_argument("--caption_from_export", default="",
                   help="Path to a tennis_torch.export --kind captioner "
                        "artifact: mount POST /caption from the saved beam "
                        "program (--caption_batch_size/--src_max_len come "
                        "from its sidecar)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device the models run on (an artifact runs on the "
                        "device its sidecar names)")
    args = p.parse_args(argv)
    if min(args.batch_size, args.request_timeout_s, args.src_max_len,
           args.caption_batch_size) < 1 or args.max_wait_ms < 0:
        p.error("--batch_size, --request_timeout_s, --src_max_len and "
                "--caption_batch_size must be >= 1, --max_wait_ms >= 0")
    return args


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    handler, batcher = build_service(args)
    httpd = ThreadingHTTPServer((args.host, args.port), handler)
    log.info("listening on http://%s:%d (batch %d, max wait %d ms)",
             *httpd.server_address, batcher.batch_size, args.max_wait_ms)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
