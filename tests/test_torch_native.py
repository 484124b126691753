"""The port's copy of the native host libraries against the JAX package's
on the CPU: ``decode_jpeg``, ``jpeg_dims``, ``skipgram_lookup``,
``cbow_lookup`` and ``center_context_pairs`` give the same results on the
same inputs and seed; ``TennisSet`` and ``serve.decode_rgb`` give JAX's
pixels for 1080- and 2160-line JPEGs at 512^2 (ROADMAP departure 1,
closed); ``train_embeddings`` takes the JAX trainer's native pairs
(departure 6, closed); the frame-cache writer's output decodes to the JAX
writer's; four processes building at once compile once; the libraries land
in ``tennis_torch/build/``."""
import os
import shutil
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

from fixtures import build_fixture
from tennis_torch import native
from tennis_torch.native import jpeg
from tennis_tpu import native as jax_native
from tennis_tpu.native import jpeg as jax_jpeg

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG = {"1080": (1080, 1920), "2160": (2160, 3840)}


def _jpeg_bytes(h, w, seed, quality=90):
    """A smooth seeded RGB image of (h, w), JPEG-encoded."""
    rng = np.random.default_rng(seed)
    img = cv2.resize(rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3),
                                  np.uint8), (w, h),
                     interpolation=cv2.INTER_CUBIC)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return enc.tobytes()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The fixture dataset with two of its test-split frames replaced by a
    1080-line and a 2160-line JPEG."""
    from tennis_tpu.data.tennis_set import TennisSet as JaxTennisSet
    from tennis_tpu.data.tennis_set import get_image_path

    base = tmp_path_factory.mktemp("native")
    root = build_fixture(str(base / "ds"))
    ds = JaxTennisSet(root=root, split="test", balance=False)
    big = {}
    for i, (name, (h, w)) in enumerate(BIG.items()):
        video, frame = ds._samples[i][:2]
        path = get_image_path(os.path.join(root, "frames"), video, frame)
        with open(path, "wb") as f:
            f.write(_jpeg_bytes(h, w, seed=i))
        big[name] = (i, path)
    return {"base": base, "root": root, "big": big}


def test_libraries_are_built_in_tennis_torch_build():
    assert native.HAVE_NATIVE and jpeg.HAVE_NATIVE_JPEG
    build = os.path.join(REPO, "tennis_torch", "build")
    for src, link in ((native._SRC, ()), (jpeg._SRC, ("-ljpeg",))):
        lib = native.library_path(src, link)
        assert os.path.dirname(lib) == build and os.path.exists(lib)
    here = os.listdir(os.path.join(REPO, "tennis_torch", "native"))
    assert not [f for f in here if f.endswith((".so", ".lock"))]


@pytest.mark.parametrize("h,w", [(720, 1280), (1080, 1920), (24, 32),
                                 (2160, 3840)])
def test_decode_and_dims_equal_jax(h, w):
    data = _jpeg_bytes(h, w, seed=h)
    assert jpeg.jpeg_dims(data) == jax_jpeg.jpeg_dims(data) == (h, w)
    for min_short in (None, 544, 360, 90, 16):
        got = jpeg.decode_jpeg(data, min_short)
        want = jax_jpeg.decode_jpeg(data, min_short)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    full = cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8),
                                     cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), full)
    for bad in (b"", b"\x89PNG....", data[:2] + b"\x00" * 16):
        assert jpeg.decode_jpeg(bad) is None and jpeg.jpeg_dims(bad) is None


def test_batch_ops_equal_jax():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 5, 40)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    subwords = rng.integers(0, 200, ptr[-1]).astype(np.int64)
    indices = rng.integers(0, 40, 64)
    rows, cols = np.sort(rng.integers(0, 16, 90)), rng.integers(0, 40, 90)
    sents = [list(rng.integers(0, 30, rng.integers(0, 12))) for _ in range(25)]
    cases = [
        (native.skipgram_lookup, jax_native.skipgram_lookup,
         (indices, subwords, ptr, 40)),
        (native.cbow_lookup, jax_native.cbow_lookup,
         (rows, cols, subwords, ptr, 40)),
        (native.center_context_pairs, jax_native.center_context_pairs,
         (sents, 4, 9)),
        (native._skipgram_lookup_np, jax_native._skipgram_lookup_np,
         (indices, subwords, ptr, 40)),
        (native._cbow_lookup_np, jax_native._cbow_lookup_np,
         (rows, cols, subwords, ptr, 40)),
        (native._center_context_pairs_np, jax_native._center_context_pairs_np,
         (sents, 4, 9)),
    ]
    for port_fn, jax_fn, args in cases:
        got, want = port_fn(*args), jax_fn(*args)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # the compiled lookups compute the numpy fallbacks' function
    for a, b in zip(native.skipgram_lookup(indices, subwords, ptr, 40),
                    native._skipgram_lookup_np(indices, subwords, ptr, 40)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(BIG))
def test_tennis_set_pixels_equal_jax_at_512(data, name):
    """A 1080- and a 2160-line frame at decode short side 544 (512^2 + 32)
    read to JAX's pixels; the 2160-line one at a 1/2 DCT scale."""
    from tennis_torch.data.tennis_set import TennisSet
    from tennis_tpu.data.tennis_set import TennisSet as JaxTennisSet

    idx, _ = data["big"][name]
    kw = dict(root=data["root"], split="test", balance=False,
              decode_short=544)
    got, label, i = TennisSet(**kw)[idx]
    want, j_label, j = JaxTennisSet(**kw)[idx]
    assert (label, i) == (j_label, j)
    assert got.shape == want.shape == (1080, 1920, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(BIG))
def test_serve_decode_equals_jax(data, name):
    from tennis_torch.serve import decode_rgb
    from tennis_tpu.serve import decode_rgb as jax_decode_rgb

    with open(data["big"][name][1], "rb") as f:
        body = f.read()
    got, want = decode_rgb(body, 512), jax_decode_rgb(body, 512)
    assert got.shape == (512, 512, 3)
    np.testing.assert_array_equal(got, want)


def test_train_embeddings_takes_the_jax_trainers_pairs(data, monkeypatch,
                                                       tmp_path):
    """The port's trainer draws each epoch's pairs from the native library,
    which gives the JAX trainer's pairs for the same corpus and seed."""
    from tennis_torch import train_embeddings
    from tennis_tpu import train_embeddings as jte

    calls = []
    real = native.center_context_pairs

    def recording(coded, window, seed):
        calls.append((coded, window, seed, real(coded, window, seed)))
        return calls[-1][-1]

    monkeypatch.setattr(native, "center_context_pairs", recording)
    monkeypatch.chdir(tmp_path)
    train_embeddings.main([f"--root={data['root']}", "--epochs=2",
                           "--batch_size=64", "--emb_size=8",
                           "--ngram_buckets=50", "--device=cpu", "--notsne",
                           "--overwrite"])
    sentences = jte.load_corpus(data["root"], True)
    vocab = jte.EmbeddingVocab(Counter(t for s in sentences for t in s))
    coded = [[vocab[t] for t in s if t in vocab] for s in sentences]
    assert [c[2] for c in calls] == [1, 2]  # seed + epoch, the default seed 0
    for got_coded, window, seed, got in calls:
        assert got_coded == coded and window == 3
        for a, b in zip(got, jax_native.center_context_pairs(coded, window,
                                                             seed)):
            np.testing.assert_array_equal(a, b)


def test_concurrent_first_use_builds_once(tmp_path):
    src = str(tmp_path / "batch_ops.cpp")
    shutil.copyfile(native._SRC, src)
    code = ("import sys\n"
            "from tennis_torch import native\n"
            f"lib = native.build_shared({src!r}, build_dir={str(tmp_path)!r})\n"
            "import ctypes; ctypes.CDLL(lib)\n"
            "print(lib, len(native.built))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    libs, built = zip(*(o[0].split() for o in outs))
    assert len(set(libs)) == 1 and sorted(built) == ["0", "0", "0", "1"]
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["batch_ops.cpp", os.path.basename(libs[0]),
         os.path.basename(libs[0]) + ".lock"])


def test_frame_cache_writer_equals_jax(data, tmp_path):
    """The port's writer and the JAX one, over the same frames tree (the
    fixture's small frames are copied, the two large ones resized), write
    files that decode to the same pixels; a re-run writes nothing."""
    from tennis_torch.data import frame_cache
    from tennis_tpu.data import frame_cache as jax_frame_cache

    roots = []
    for name in ("jax", "port"):
        root = str(tmp_path / name)
        shutil.copytree(os.path.join(data["root"], "frames"),
                        os.path.join(root, "frames"))
        roots.append(root)
    want = jax_frame_cache.build_frame_cache(roots[0], 544, workers=1)
    got = frame_cache.build_frame_cache(roots[1], 544, workers=1)
    assert got == want and got[0] > 0
    assert frame_cache.build_frame_cache(roots[1], 544, workers=1) == \
        (0, got[0])
    n = 0
    for dirpath, _, files in os.walk(frame_cache.cache_dir(roots[0], 544)):
        for f in files:
            a = os.path.join(dirpath, f)
            b = a.replace(roots[0], roots[1], 1)
            np.testing.assert_array_equal(cv2.imread(b), cv2.imread(a))
            n += 1
    assert n == got[0]
    big = [p.replace(data["root"], roots[1], 1).replace(
        "frames", "frames_s544", 1) for _, p in data["big"].values()]
    assert [min(cv2.imread(p).shape[:2]) for p in big] == [544, 544]
    assert frame_cache.parse_args([]).short == 544
