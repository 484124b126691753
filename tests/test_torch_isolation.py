"""The port stands alone: it imports neither JAX, flax nor the JAX package,
imports its optional packages only where they are used, and its entry points
refuse to fall back to the CPU when a GPU was asked for."""
import os
import re
import subprocess
import sys

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    torch's default pool per worker oversubscribes them several times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tennis_torch")
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(jax|flax|tennis_tpu)\b"
    r"|(?:__import__|import_module)\(\s*['\"](jax|flax|tennis_tpu)\b",
    re.MULTILINE)


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith((".py", ".cu", ".cuh"))]
    return paths


def test_no_jax_imports_in_sources():
    sources = _port_sources()
    assert len(sources) >= 15
    for path in sources:
        with open(path) as f:
            hit = FORBIDDEN.search(f.read())
        assert hit is None, f"{path}: {hit.group(0)!r}"


def test_importing_the_port_loads_no_jax_or_optional_packages():
    """Every module of the port and chip_smoke.py, imported in a fresh
    interpreter, leave JAX, flax, the JAX package, cv2, msgpack and absl
    unloaded."""
    modules = sorted(
        os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
        for root, _, files in os.walk(PORT) for f in files
        if f.endswith(".py"))
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules] + ["chip_smoke"]
    # only what the imports add counts: a site hook may preload packages
    code = ("import importlib, sys\n"
            "before = set(sys.modules)\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(n for n in set(sys.modules) - before if "
            "n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tennis_tpu', "
            "'cv2', 'msgpack', 'absl'))\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_cuda_without_gpu_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA requests succeed here")
    from tennis_torch import serve
    from tennis_torch.inference import load_classifier, resolve_device

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no GPU"):
        load_classifier("DenseNet121", "none", 32)  # device defaults to cuda
    with pytest.raises(RuntimeError, match="no GPU"):
        serve.build_service(serve.parse_args(["--model_id=none"]))
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    """No result line without a GPU, and none from a lone copy of the script."""
    import shutil

    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    runs = [[sys.executable, str(lone)]]
    if not torch.cuda.is_available():
        runs.append([sys.executable, os.path.join(REPO, "chip_smoke.py")])
    for cmd in runs:
        out = subprocess.run(cmd, cwd=os.path.dirname(cmd[1]),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
