"""The port's ``torch.export`` artifacts against the JAX package's on the
CPU: one ``resnet18_v2`` classifier at 32^2 and one small captioner, both
written by ``tennis_tpu`` and exported with both packages. The sidecars
agree key for key (``platforms`` and ``exp_dir`` aside); the port's
probabilities lie within 1e-2 of JAX's exported program (same top-1) and
within 1e-6 of the port's live scorer; the port's captioner artifacts (the
plain recurrence and the GRU op) give the top beams of JAX's artifact and
of the port's live translator. A port-written DenseNet121 at 32^2 exports
to a graph of 58 ``tennis_torch.dense_layer`` nodes with no
``auto_functionalized`` node. The loader's guards, a subprocess that loads
an artifact without importing model code, ``serve --from_export`` and
``--caption_from_export`` over HTTP, and the CLI's flags against
``tennis_tpu.export``'s."""
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from fixtures import VIDEO_EVENTS, build_fixture
from tennis_torch import export, serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONE, SHAPE, BATCH = "resnet18_v2", 32, 2
FEAT_DIM, SRC_MAX_LEN, CAP_BATCH = 32, 16, 2
GNMT_ARGV = ["--feats_model=tf", "--num_hidden=16", "--emb_size=8",
             "--tgt_max_len=10", "--emb_file="]
PROB_TOL = 1e-2   # bf16 forwards in two frameworks
LIVE_TOL = 1e-6   # the same ops in the port, traced and live


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_tree(abstract, seed):
    """Seeded numpy leaves for an abstract flax tree: kernels with variance
    1/fan_in, BN scales around 1 and statistics away from (0, 1),
    embeddings with variance 1/width, optimizer state zero."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        keys = [str(getattr(k, "key", getattr(k, "name", ""))) for k in path]
        name, shape = keys[-1], leaf.shape
        if keys[0] == "params" and name in ("kernel", "embedding"):
            value = rng.standard_normal(shape) / np.sqrt(
                shape[-1] if name == "embedding" else np.prod(shape[:-1]))
        elif keys[0] == "params" and name == "scale":
            value = rng.uniform(0.5, 1.5, shape)
        elif keys[0] == "batch_stats" and name == "var":
            value = rng.uniform(0.5, 2.0, shape)
        elif keys[0] in ("params", "batch_stats"):  # biases and means
            value = rng.standard_normal(shape) * 0.1
        else:  # step and optimizer state
            value = np.zeros(shape)
        return np.asarray(value, dtype=leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, abstract)


def _jax_experiments(root):
    """A ``resnet18_v2`` vision experiment ``t9`` and a captioner ``c9``
    over a 32-d feature store, both written by the JAX package, of seeded
    weights (``jax.eval_shape`` gives the trees: no compile)."""
    import jax
    import jax.numpy as jnp

    from tennis_tpu.data import TennisSet
    from tennis_tpu.data.tennis_set import get_feature_path, load_classes
    from tennis_tpu.models import FrameModel, get_backbone
    from tennis_tpu.parallel import create_train_state, sgd_with_schedule
    from tennis_tpu.train_gnmt import FLAGS as GFLAGS, build_model
    from tennis_tpu.utils import checkpoint as ckpt
    from tennis_tpu.utils.experiments import experiment_dir

    model = FrameModel(get_backbone(BACKBONE, dtype=jnp.bfloat16),
                       num_classes=len(load_classes(root)), dtype=jnp.bfloat16)
    tx, _ = sgd_with_schedule(0.001)
    abstract = jax.eval_shape(lambda: create_train_state(
        model, jax.random.PRNGKey(3),
        jnp.zeros((1, SHAPE, SHAPE, 3), jnp.float32), tx, {"train": True}))
    exp_dir = experiment_dir("vision", "t9")
    ckpt.save_state(ckpt.epoch_path(exp_dir, 0), _random_tree(abstract, 3))
    ckpt.append_score(exp_dir, 0, 0.5)

    rng = np.random.default_rng(0)
    for video, events in VIDEO_EVENTS.items():
        for frame in range(events[-1][1]):
            p = get_feature_path(os.path.join(root, "features", "tf"), video,
                                 frame)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            np.save(p, rng.normal(size=(FEAT_DIM,)).astype(np.float32))
    GFLAGS.unparse_flags()
    GFLAGS(["t", f"--root={root}", "--model_id=c9", *GNMT_ARGV])
    vocab = TennisSet(root=root, captions=True, split="train",
                      feats_model="tf", max_cap_len=10).vocab
    cap_model = build_model(len(vocab))
    abstract = jax.eval_shape(
        cap_model.init, jax.random.PRNGKey(1),
        jnp.zeros((1, SRC_MAX_LEN, FEAT_DIM)), jnp.zeros((1, 2), jnp.int32))
    variables = _random_tree(abstract, 1)
    exp_c = os.path.join("models", "captioning", "experiments", "c9")
    os.makedirs(exp_c)
    ckpt.save_state(os.path.join(exp_c, "valid_best.params"),
                    {"params": variables["params"],
                     "batch_stats": variables.get("batch_stats", {})})


def _port_densenet(root):
    """A DenseNet121 experiment ``d1`` at 32^2 written by the port."""
    from tennis_torch.bridge import to_flax
    from tennis_torch.inference import build_frame_model
    from tennis_torch.utils import checkpoint as ckpt

    model = build_frame_model("DenseNet121", 11, SHAPE,
                              generator=torch.Generator().manual_seed(2))
    exp = os.path.join("models", "vision", "experiments", "d1")
    ckpt.save_state(ckpt.epoch_path(exp, 0), to_flax(model))
    ckpt.append_score(exp, 0, 0.25)


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """Every artifact of the file, exported once: JAX's and the port's
    classifier and captioner, the port's captioner through the GRU op, and
    the port's DenseNet121 (its program kept for the graph check)."""
    from tennis_tpu import export as jax_export

    base = tmp_path_factory.mktemp("export")
    root = build_fixture(str(base / "ds"))
    cwd = os.getcwd()
    os.chdir(base)
    try:
        _jax_experiments(root)
        _port_densenet(root)
        out = {"base": base, "root": root}
        blob, meta = jax_export.export_classifier(BACKBONE, "t9", SHAPE,
                                                  BATCH, root=root)
        jax_export.save_exported(str(base / "t9.hlo"), blob, meta)
        blob, meta = jax_export.export_captioner(
            "c9", CAP_BATCH, src_max_len=SRC_MAX_LEN, root=root,
            gnmt_argv=GNMT_ARGV)
        jax_export.save_exported(str(base / "c9.hlo"), blob, meta)
        # the port's classifier through its CLI
        export.main(["--model_id=t9", f"--backbone={BACKBONE}",
                     f"--data_shape={SHAPE}", f"--batch_size={BATCH}",
                     f"--root={root}", "--device=cpu",
                     f"--out={base / 't9.pt2'}"])
        for name, kernel in (("c9", False), ("c9_gru", True)):
            program, meta = export.export_captioner(
                "c9", CAP_BATCH, src_max_len=SRC_MAX_LEN, root=root,
                gnmt_argv=GNMT_ARGV, gru_kernel=kernel, device="cpu")
            export.save_exported(str(base / f"{name}.pt2"), program, meta)
            out[f"{name}_graph"] = program.graph
        program, meta = export.export_classifier(
            "DenseNet121", "d1", SHAPE, BATCH, root=root, platforms=["cpu"])
        export.save_exported(str(base / "d1.pt2"), program, meta)
        out["d1_graph"] = program.graph
        yield out
    finally:
        os.chdir(cwd)


def _sidecar(path):
    with open(path + ".json") as f:
        return json.load(f)


def _frames(seed=11):
    return np.random.default_rng(seed).integers(
        0, 256, (BATCH, SHAPE, SHAPE, 3), dtype=np.uint8)


def _targets(graph, name):
    return [str(n.target) for n in graph.nodes
            if n.op == "call_function" and name in str(n.target)]


@pytest.mark.parametrize("name", ["t9", "c9"])
def test_sidecars_match_jax(art, name):
    got = _sidecar(str(art["base"] / f"{name}.pt2"))
    want = _sidecar(str(art["base"] / f"{name}.hlo"))
    assert got["platforms"] == ["cpu"]
    for meta in (got, want):
        del meta["platforms"], meta["exp_dir"]
    assert got == want


def test_classifier_matches_jax_and_the_live_scorer(art):
    from tennis_torch.inference import load_classifier
    from tennis_tpu.export import load_exported as jax_load

    classes, predict, meta = export.load_exported(str(art["base"] / "t9.pt2"))
    j_classes, j_predict, _ = jax_load(str(art["base"] / "t9.hlo"))
    assert classes == j_classes and meta["batch_size"] == BATCH
    os.chdir(art["base"])
    _, live, _ = load_classifier(BACKBONE, "t9", SHAPE, root=art["root"],
                                 device="cpu")
    for seed in (11, 12):
        images = _frames(seed)
        probs = predict(images)
        want = np.asarray(j_predict(images))
        assert probs.shape == (BATCH, len(classes)) and probs.dtype == np.float32
        np.testing.assert_allclose(probs, want, rtol=0, atol=PROB_TOL)
        np.testing.assert_array_equal(probs.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(probs, live(images), rtol=0, atol=LIVE_TOL)


def test_densenet_graph_holds_one_op_per_dense_layer(art):
    """58 ``tennis_torch.dense_layer`` nodes, kept in place (no
    ``auto_functionalized``), and the loaded program gives the live
    scorer's probabilities."""
    from tennis_torch.inference import load_classifier

    graph = art["d1_graph"]
    assert len(_targets(graph, "tennis_torch.dense_layer")) == 58
    assert not _targets(graph, "auto_functionalized")
    _, predict, meta = export.load_exported(str(art["base"] / "d1.pt2"))
    assert meta["backbone"] == "DenseNet121" and meta["platforms"] == ["cpu"]
    os.chdir(art["base"])
    _, live, _ = load_classifier("DenseNet121", "d1", SHAPE, root=art["root"],
                                 device="cpu")
    np.testing.assert_allclose(predict(_frames()), live(_frames()), rtol=0,
                               atol=LIVE_TOL)


def test_loader_guards(art, tmp_path):
    path = str(art["base"] / "t9.pt2")
    _, predict, _ = export.load_exported(path)
    with pytest.raises(ValueError, match="shape-static"):
        predict(np.zeros((BATCH + 1, SHAPE, SHAPE, 3), np.uint8))
    with pytest.raises(ValueError, match="shape-static"):
        predict(np.zeros((BATCH, SHAPE, SHAPE, 3), np.float32))
    _, caption, _ = export.load_exported_captioner(str(art["base"] / "c9.pt2"))
    with pytest.raises(ValueError, match="shape-static"):
        caption(np.zeros((3, SRC_MAX_LEN, FEAT_DIM), np.float32),
                np.ones((3,), np.int32))
    with pytest.raises(ValueError, match="artifact kind"):
        export.load_exported_captioner(path)
    with pytest.raises(ValueError, match="artifact kind"):
        export.load_exported(str(art["base"] / "c9.pt2"))
    bad = str(tmp_path / "bad.pt2")
    shutil.copyfile(path, bad)
    meta = _sidecar(path)
    meta["format_version"] = 999
    with open(bad + ".json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="unsupported export format"):
        export.load_exported(bad)
    # a JAX artifact, sidecar and all, is refused by name
    with pytest.raises(ValueError, match="tennis_tpu.export"):
        export.load_exported(str(art["base"] / "t9.hlo"))
    with pytest.raises(ValueError, match="tennis_tpu.export"):
        export.load_exported_captioner(str(art["base"] / "c9.hlo"))


def test_loading_imports_no_model_code(art):
    code = ("import sys\n"
            "import numpy as np\n"
            "from tennis_torch.export import load_exported\n"
            f"_, predict, _ = load_exported({str(art['base'] / 't9.pt2')!r})\n"
            f"p = predict(np.zeros(({BATCH}, {SHAPE}, {SHAPE}, 3), np.uint8))\n"
            "bad = [m for m in ('tennis_torch.models', 'tennis_torch.inference',"
            " 'tennis_torch.utils.checkpoint') if m in sys.modules]\n"
            "print(p.shape, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == f"({BATCH}, 11) []"


def _mount(argv):
    handler, batcher = serve.build_service(serve.parse_args(argv))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, handler, batcher


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_serve_from_export_over_http(art):
    """``--from_export`` and ``--caption_from_export`` boot both endpoints
    from the artifacts alone; the sidecars set the static batches."""
    import cv2

    httpd, handler, batcher = _mount([
        f"--from_export={art['base'] / 't9.pt2'}",
        f"--caption_from_export={art['base'] / 'c9.pt2'}",
        "--max_wait_ms=30", "--device=cpu"])
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    try:
        assert batcher.batch_size == BATCH  # not the flag default 8
        assert handler.caption_batcher.batch_size == CAP_BATCH
        rng = np.random.default_rng(5)
        ok, enc = cv2.imencode(".jpg", rng.integers(0, 255, (48, 64, 3))
                               .astype(np.uint8))
        assert ok
        out = _post(url + "/predict", enc.tobytes())
        assert out["label"] in out["classes"]
        assert abs(sum(out["probs"]) - 1.0) < 1e-3
        buf = io.BytesIO()
        np.save(buf, rng.normal(size=(9, FEAT_DIM)).astype(np.float32))
        out = _post(url + "/caption", buf.getvalue())
        assert out["frames_used"] == 9
        assert out["caption"] == " ".join(out["tokens"])
        toks = _sidecar(str(art["base"] / "c9.pt2"))["idx_to_token"]
        assert all(t in toks for t in out["tokens"])
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_captioner_matches_jax_and_the_live_translator(art):
    """Top beams of the port's two artifacts equal JAX's artifact's and the
    live translator's; the GRU-op artifact holds three recurrence nodes
    (two bidirectional, one forward), the default one none."""
    from tennis_torch.inference import load_captioner
    from tennis_tpu.export import load_exported_captioner as jax_load

    assert len(_targets(art["c9_gru_graph"],
                        "tennis_torch.gru_recurrence")) == 3
    assert not _targets(art["c9_graph"], "tennis_torch.gru_recurrence")
    _, j_caption, _ = jax_load(str(art["base"] / "c9.hlo"))
    os.chdir(art["base"])
    _, live, _ = load_captioner("c9", root=art["root"], gnmt_argv=GNMT_ARGV,
                                src_max_len=SRC_MAX_LEN, device="cpu")
    rng = np.random.default_rng(7)
    for lengths in ([10, 16], [1, 7]):
        feats = rng.normal(size=(CAP_BATCH, SRC_MAX_LEN, FEAT_DIM)).astype(
            np.float32)
        lengths = np.asarray(lengths, np.int32)
        want = j_caption(feats, lengths)
        assert [list(c) for c in live(feats, lengths)] == want
        for name in ("c9", "c9_gru"):
            toks, caption, meta = export.load_exported_captioner(
                str(art["base"] / f"{name}.pt2"))
            assert caption(feats, lengths) == want, name


def test_flags_match_jax_export(monkeypatch):
    """The CLI's flags are ``tennis_tpu.export``'s by name and default, plus
    ``--device`` (``cuda``); ``--platforms`` takes ``cuda`` or ``cpu``."""
    from absl import flags

    from tennis_tpu import export as jax_export

    seen = []

    class Recording(flags.FlagValues):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)

    monkeypatch.setattr(flags, "FlagValues", Recording)
    monkeypatch.setattr(jax_export, "export_classifier",
                        lambda *a, **k: (b"", {"exp_dir": ".",
                                              "platforms": []}))
    monkeypatch.setattr(jax_export, "save_exported", lambda *a: None)
    jax_export.main([])
    fv = seen[0]
    args = vars(export.parse_args([]))
    assert set(args) == set(fv) | {"device"}
    for name in fv:
        assert args[name] == fv[name].default, name
    assert args["device"] == "cuda"
    assert export.parse_args(["--platforms=cpu"]).platforms == "cpu"
    assert export.parse_args(["--pallas_gru"]).pallas_gru
    for bad in ("--platforms=tpu", "--platforms=cuda,cpu", "--device=tpu",
                "--kind=flow"):
        with pytest.raises(SystemExit):
            export.parse_args([bad])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_recurrence_loop_form_equals_the_python_loop(dtype):
    """The plain GRU recurrence as one ``while_loop`` (the form an export
    traces) gives the Python loop's outputs and carry bit for bit, rows
    ending early and at 0 included."""
    from tennis_torch.ops import rnn

    layer = rnn.RNNLayer("gru", 12, 16, generator=torch.Generator()
                         .manual_seed(3), dtype=dtype)
    x = torch.randn(3, 9, 12, generator=torch.Generator().manual_seed(4))
    vl = torch.tensor([9, 4, 0], dtype=torch.int32)
    with torch.no_grad():
        gx = rnn._affine(layer.i2h, dtype)(x).transpose(0, 1)
        h2h = rnn._affine(layer.recurrence.h2h, dtype)
        h0 = torch.randn(3, 16, generator=torch.Generator().manual_seed(5)
                         ).to(dtype)
        want = rnn._gru_recurrence(gx, h2h, h0, vl)
        got = rnn._gru_recurrence_loop(gx, h2h, h0, vl)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype and torch.equal(a, b)
