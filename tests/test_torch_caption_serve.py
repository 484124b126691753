"""The captioner slice as a whole on the CPU: the port reads a captioning
experiment written by the JAX package, builds the same caption vocabulary,
decodes the same token lists, and serves ``POST /caption`` over HTTP
(mirrors tests/test_serve.py::test_caption_endpoint)."""
import io
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tennis_torch import serve
from tennis_torch.bridge import to_flax
from tennis_torch.inference import build_frame_model

FEAT_DIM = 32
GNMT_ARGV = ["--feats_model=tf", "--num_hidden=16", "--emb_size=8",
             "--tgt_max_len=10", "--emb_file="]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's default pool per worker oversubscribes them several times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A fixture TenniSet with a 32-d feature store, a captioning experiment
    ``c1`` saved by the JAX package from its own init, and a DenseNet121
    vision experiment ``s1`` for the classifier the service always mounts."""
    from flax import serialization

    from tennis_tpu.data import TennisSet
    from tennis_tpu.data.synthetic import VIDEO_EVENTS, build_fixture
    from tennis_tpu.data.tennis_set import get_feature_path
    from tennis_tpu.train_gnmt import FLAGS as GFLAGS, build_model
    from tennis_tpu.utils import checkpoint as ckpt

    base = tmp_path_factory.mktemp("cap")
    root = build_fixture(str(base / "data"))
    rng = np.random.default_rng(0)
    for video, events in VIDEO_EVENTS.items():
        for frame in range(events[-1][1]):
            path = get_feature_path(os.path.join(root, "features", "tf"),
                                    video, frame)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, rng.normal(size=(FEAT_DIM,)).astype(np.float32))

    GFLAGS.unparse_flags()
    GFLAGS(["t", f"--root={root}", "--model_id=c1", *GNMT_ARGV])
    vocab = TennisSet(root=root, captions=True, split="train",
                      feats_model="tf", max_cap_len=10).vocab
    cap_model = build_model(len(vocab))
    variables = jax.jit(cap_model.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, FEAT_DIM), jnp.float32),
        jnp.zeros((1, 2), jnp.int32))
    exp_c = os.path.join(base, "models", "captioning", "experiments", "c1")
    os.makedirs(exp_c)
    ckpt.save_state(os.path.join(exp_c, "valid_best.params"),
                    {"params": variables["params"],
                     "batch_stats": variables.get("batch_stats", {})})

    model = build_frame_model("DenseNet121", 11, 32, dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0))
    exp_v = os.path.join(base, "models", "vision", "experiments", "s1")
    os.makedirs(exp_v)
    with open(os.path.join(exp_v, "0000.params"), "wb") as f:
        f.write(serialization.msgpack_serialize(to_flax(model)))
    with open(os.path.join(exp_v, "scores.txt"), "w") as f:
        f.write("0\t0.5\n")
    return str(base), root, vocab


def test_vocab_and_index_match_jax(experiment):
    from tennis_tpu.data import TennisSet
    from tennis_torch.data.tennis_set import CaptionIndex

    _, root, _ = experiment
    for split in ("train", "val", "test"):
        want = TennisSet(root=root, captions=True, split=split,
                         feats_model="tf", max_cap_len=10)
        got = CaptionIndex(root, split=split, feats_model="tf", max_cap_len=10)
        assert got.vocab.idx_to_token == want.vocab.idx_to_token
        assert got.samples == want._samples
        assert len(got) == len(want) > 0
        for i in range(len(got)):
            np.testing.assert_array_equal(got.caption_ids[got.samples[i]],
                                          want.get_captions(ids=True)[i])
        feats = np.stack([np.load(got.feature_path(0, f))
                          for f in got.frames(0)])
        np.testing.assert_array_equal(feats, want[0][0])


def test_load_captioner_matches_jax(experiment, monkeypatch):
    """Token lists identical to the JAX loader's on the same features."""
    from tennis_tpu.inference import load_captioner as jax_load_captioner
    from tennis_torch.inference import load_captioner

    base, root, vocab = experiment
    monkeypatch.chdir(base)
    vocab_j, caption_j, info_j = jax_load_captioner(
        "c1", root=root, gnmt_argv=GNMT_ARGV, src_max_len=16)
    vocab_t, caption_t, info_t = load_captioner(
        "c1", root=root, gnmt_argv=GNMT_ARGV, src_max_len=16, device="cpu")
    assert vocab_t.idx_to_token == vocab_j.idx_to_token == vocab.idx_to_token
    assert info_t == info_j
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(3, 16, FEAT_DIM)).astype(np.float32)
    lengths = np.asarray([16, 9, 1], np.int32)
    feats[1, 9:] = 0.0
    feats[2, 1:] = 0.0
    want = caption_j(feats, lengths)
    got = caption_t(feats, lengths)
    assert got == want
    assert all(tok in vocab.token_to_idx for toks in got for tok in toks)


def test_caption_endpoint(experiment, monkeypatch):
    base, root, vocab = experiment
    monkeypatch.chdir(base)
    args = serve.parse_args(
        ["--model_id=s1", "--data_shape=32", "--batch_size=2",
         "--max_wait_ms=30", f"--root={root}", "--caption_model_id=c1",
         "--src_max_len=16", "--caption_batch_size=2", "--device=cpu"]
        + [f"--gnmt_flag={a}" for a in GNMT_ARGV])
    handler, _ = serve.build_service(args)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://127.0.0.1:%d" % httpd.server_address[1]

    def npy(a):
        buf = io.BytesIO()
        np.save(buf, a)
        return buf.getvalue()

    def post(body):
        req = urllib.request.Request(url + "/caption", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        feats = np.random.default_rng(2).normal(size=(10, FEAT_DIM))
        body = npy(feats.astype(np.float32))
        # two concurrent requests coalesce into one beam batch
        results = [None] * 2
        posters = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, post(body))) for i in range(2)]
        for p in posters:
            p.start()
        for p in posters:
            p.join(timeout=120)
        for r in results:
            assert r["frames_used"] == 10
            assert all(tok in vocab.token_to_idx for tok in r["tokens"])
            assert r["caption"] == " ".join(r["tokens"])
        assert results[0] == results[1]

        # longer than src_max_len: truncated, not rejected
        long_feats = np.random.default_rng(3).normal(size=(40, FEAT_DIM))
        assert post(npy(long_feats.astype(np.float32)))["frames_used"] == 16

        for bad in (npy(np.zeros((5, 7), np.float32)), b"definitely not npy",
                    npy(np.full((5, FEAT_DIM), "a", dtype="<U1")),
                    npy(np.zeros((5, FEAT_DIM), dtype="timedelta64[s]")),
                    npy(np.zeros((FEAT_DIM,), np.float32))):
            req = urllib.request.Request(url + "/caption", data=bad,
                                         method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=60)
            assert e.value.code == 400

        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"
        assert health["caption_requests"] == 3
        assert health["caption_batches"] >= 2
        assert handler.caption_batcher.rows == 3
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_gnmt_flags_match_jax():
    """The port's captioner flag surface: every JAX train_gnmt flag by name
    (``--num_gpus`` as the alias of ``--num_devices``), with its default,
    plus ``--device``."""
    from tennis_tpu import train_gnmt as jax_gnmt
    from tennis_torch.train_gnmt import parse_args

    port = vars(parse_args([]))
    jax_flags = jax_gnmt.FLAGS
    names = {f.name for f in jax_flags.get_key_flags_for_module(jax_gnmt)}
    assert set(port) == (names - {"num_gpus"}) | {"device"}
    assert port.pop("device") == "cuda"
    for name, value in port.items():
        assert value == jax_flags[name].default, name
    assert parse_args(["--num_gpus=2"]).num_devices == 2
    assert parse_args(["--freeze_backbone"]).freeze_backbone is True
    with pytest.raises(SystemExit):
        parse_args(["--cell_type=rnn"])


def test_load_captioner_without_gpu_raises(experiment, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA requests succeed here")
    from tennis_torch.inference import load_captioner

    base, root, _ = experiment
    monkeypatch.chdir(base)
    with pytest.raises(RuntimeError, match="no GPU"):
        load_captioner("c1", root=root, gnmt_argv=GNMT_ARGV)
    with pytest.raises(ValueError, match="features-path"):
        load_captioner("c1", root=root, gnmt_argv=["--num_hidden=16"],
                       device="cpu")
