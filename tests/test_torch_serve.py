"""The port's HTTP service on the CPU: Batcher coalescing and error
fan-out, ``/predict`` and ``/healthz`` on an ephemeral port, and the flag
surface of the JAX serve.py (mirrors tests/test_serve.py)."""
import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from tennis_torch import serve
from tennis_torch.bridge import to_flax
from tennis_torch.inference import build_frame_model
from tennis_torch.serve import Batcher


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's default pool per worker oversubscribes them several times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_batcher_coalesces_and_pads():
    seen = []

    def fn(batch):
        seen.append(batch.shape[0])
        return batch[:, 0, 0, :].astype(np.float64)  # row-identifying output

    b = Batcher(fn, batch_size=4, max_wait_s=0.2)
    imgs = [np.full((2, 2, 3), i, np.uint8) for i in range(3)]
    out = [None] * 3
    ts = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, b.submit(imgs[i], timeout=30))) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    # every waiter got ITS row back, every run used the static batch shape
    for i in range(3):
        np.testing.assert_array_equal(out[i], np.full(3, i, np.float64))
    assert set(seen) == {4}
    assert b.rows == 3 and b.batch_size == 4

    # device-side errors surface on every waiting request, not the dispatcher
    def boom(batch):
        raise RuntimeError("device on fire")

    eb = Batcher(boom, batch_size=2, max_wait_s=0.2)
    errors = []

    def submit():
        try:
            eb.submit(imgs[0], timeout=30)
        except RuntimeError as e:
            errors.append(str(e))

    ts = [threading.Thread(target=submit) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert errors == ["device on fire"] * 2
    assert eb.batches >= 1 and eb.rows == 2
    # the dispatcher survived the error and serves the next batch
    ok = Batcher(fn, batch_size=1, max_wait_s=0.0)
    np.testing.assert_array_equal(ok.submit(imgs[2], timeout=30),
                                  np.full(3, 2, np.float64))


def test_batcher_stall_detection_and_timeout():
    entered = threading.Event()

    def slow(batch):
        entered.set()
        time.sleep(0.4)
        return batch[:, 0, 0, :].astype(np.float64)

    b = Batcher(slow, batch_size=1, max_wait_s=0.0)
    img = np.zeros((2, 2, 3), np.uint8)
    waiter = threading.Thread(target=lambda: b.submit(img, timeout=30))
    waiter.start()
    assert entered.wait(5)
    time.sleep(0.1)
    assert b.stalled(0.05)
    assert not b.stalled(10)
    waiter.join(timeout=30)
    assert not b.stalled(0.05)

    with pytest.raises(TimeoutError):
        Batcher(slow, batch_size=1, max_wait_s=0.0).submit(img, timeout=0.05)


def _write_experiment(base, model_id):
    """A DenseNet121 experiment in the JAX package's checkpoint format."""
    from flax import serialization

    model = build_frame_model("DenseNet121", 11, 32, dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0))
    exp = os.path.join(base, "models", "vision", "experiments", model_id)
    os.makedirs(exp)
    with open(os.path.join(exp, "0000.params"), "wb") as f:
        f.write(serialization.msgpack_serialize(to_flax(model)))
    with open(os.path.join(exp, "scores.txt"), "w") as f:
        f.write("0\t0.5\n")


def test_serve_endpoint(tmp_path, monkeypatch):
    import cv2

    monkeypatch.chdir(tmp_path)  # experiment dirs are cwd-relative
    _write_experiment(str(tmp_path), "s1")
    args = serve.parse_args(["--model_id=s1", "--data_shape=32",
                             "--batch_size=4", "--max_wait_ms=30",
                             "--device=cpu"])
    handler, batcher = serve.build_service(args)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    try:
        rng = np.random.default_rng(0)
        ok, enc = cv2.imencode(".jpg", rng.integers(0, 255, (48, 64, 3))
                               .astype(np.uint8))
        assert ok
        data = enc.tobytes()

        def post():
            req = urllib.request.Request(url + "/predict", data=data,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        # concurrent posts exercise request coalescing into one batch
        results = [None] * 3
        posters = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, post())) for i in range(3)]
        for p in posters:
            p.start()
        for p in posters:
            p.join(timeout=60)
        for r in results:
            assert r["label"] in r["classes"]
            assert len(r["probs"]) == len(r["classes"]) == 11
            assert abs(sum(r["probs"]) - 1.0) < 1e-3
        assert results[0]["probs"] == results[1]["probs"] == results[2]["probs"]

        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"
        assert health["requests"] == 3
        assert health["batches"] == batcher.batches >= 1

        for path, body, code in (("/predict", b"not a jpeg", 400),
                                 ("/caption", b"x", 404)):
            req = urllib.request.Request(url + path, data=body, method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=60)
            assert e.value.code == code
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/metrics", timeout=60)
        assert e.value.code == 404

        for bad_len in ("abc", "-5"):
            conn = http.client.HTTPConnection("127.0.0.1",
                                              httpd.server_address[1],
                                              timeout=60)
            conn.putrequest("POST", "/predict")
            conn.putheader("Content-Length", bad_len)
            conn.endheaders()
            assert conn.getresponse().status == 400
            conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_flags_match_jax_serve():
    from tennis_tpu import serve as jax_serve

    args = vars(serve.parse_args([]))
    ported = {"root", "model_id", "backbone", "data_shape", "host", "port",
              "batch_size", "max_wait_ms", "request_timeout_s"}
    assert set(args) == ported | {"device"}
    jax_flags = jax_serve.FLAGS
    for name in ported:
        assert args[name] == jax_flags[name].default, name
    assert args["device"] == "cuda"
    with pytest.raises(SystemExit):
        serve.parse_args(["--batch_size=0"])
    with pytest.raises(SystemExit):
        serve.parse_args(["--device=tpu"])
