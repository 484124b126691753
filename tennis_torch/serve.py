"""Online HTTP serving for the event classifier (counterpart of
``tennis_tpu/serve.py``).

A stdlib ``http.server`` endpoint that decodes posted JPEGs, coalesces
concurrent requests into one static-shape device batch, and answers each with
the class distribution.

API:

- ``POST /predict`` — body: JPEG bytes -> ``{"label": str, "probs": [float],
  "classes": [str]}``
- ``GET /healthz``  — liveness + counters (requests served, batches run, mean
  rows per batch)

Batching: requests park in a queue; one dispatcher thread drains up to
``--batch_size`` of them (waiting at most ``--max_wait_ms`` after the first),
edge-pads to the static batch shape, runs the model once, and wakes each
waiter with its row. One consumer thread means the model needs no lock.

Run: ``python -m tennis_torch.serve --model_id 0006 --backbone DenseNet121
--port 8000`` (on the GPU; ``--device cpu`` to run on the CPU). ``/caption``,
``--from_export`` and the native libjpeg decoder are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

log = logging.getLogger(__name__)

_MAX_BODY = 32 * 2**20  # reject absurd uploads before reading them


def decode_rgb(data: bytes, data_shape: int) -> np.ndarray:
    """JPEG bytes -> uint8 RGB after the eval geometry (Resize+32,
    CenterCrop), decoded with cv2."""
    import cv2

    from tennis_torch.data.transforms import test_geometry

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
                 max_wait_ms: int = 5, request_timeout_s: int = 120):
    """Mount ``/predict`` and ``/healthz`` over ``predict_probs`` (uint8
    (B, S, S, 3) -> (B, classes) probabilities); returns (handler_cls,
    batcher). The model runs once on zeros first, so the first request does
    not pay for the kernel build and warm-up."""
    predict_probs(np.zeros((batch_size, data_shape, data_shape, 3), np.uint8))
    batcher = Batcher(predict_probs, batch_size, max_wait_ms / 1e3)
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
            stalled = batcher.stalled(timeout_s)
            self._reply(503 if stalled else 200, {
                "status": "stalled" if stalled else "ok",
                "requests": batcher.rows,
                "batches": batcher.batches,
                "mean_rows_per_batch": round(
                    batcher.rows / max(batcher.batches, 1), 2),
            })

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

        def do_POST(self):
            if self.path != "/predict":
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
            try:
                probs = batcher.submit(img, timeout=timeout_s)
            except TimeoutError:
                return self._reply(503, {"error": "inference timed out"})
            except Exception as e:  # device-side failure: a 500, not a
                log.exception("batch failed")  # dropped connection
                return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            self._reply(200, {
                "label": classes[int(np.argmax(probs))],
                "probs": [round(float(p), 6) for p in probs],
                "classes": classes,
            })

        def log_message(self, fmt, *args):  # route to logging, not stderr
            log.info("%s %s", self.address_string(), fmt % args)

    return Handler, batcher


def build_service(args: argparse.Namespace):
    """Load the experiment's best checkpoint and return (handler_cls,
    batcher)."""
    from tennis_torch.inference import load_classifier

    classes, predict_probs, _info = load_classifier(
        args.backbone, args.model_id, args.data_shape, args.root,
        device=args.device)
    return make_service(classes, predict_probs, args.batch_size,
                        args.data_shape, args.max_wait_ms,
                        args.request_timeout_s)


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
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device the model runs on")
    args = p.parse_args(argv)
    if args.batch_size < 1 or args.max_wait_ms < 0 or args.request_timeout_s < 1:
        p.error("--batch_size and --request_timeout_s must be >= 1, "
                "--max_wait_ms >= 0")
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
