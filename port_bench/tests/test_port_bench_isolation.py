"""Nothing the benchmark runs imports the JAX stack or the JAX package,
compared by top-level module name whole; the references import nothing
of the program; a run with the JAX stack loaded reports no result."""
import ast
import os
import sys
import types

from port_bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "tennis_tpu"}


def _run_files():
    for dirpath, dirnames, files in os.walk(harness.HERE):
        dirnames[:] = [d for d in dirnames if d not in ("tests", ".cache")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_the_benchmark_runs_imports_jax():
    files = list(_run_files())
    assert len(files) > 20
    for path in files:
        found = set(_imports(path)) & FORBIDDEN
        assert not found, f"{path} imports {found}"


def test_the_references_import_nothing_of_the_program():
    ref_dir = os.path.join(harness.HERE, "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            names = set(_imports(os.path.join(ref_dir, f)))
            assert "tennis_torch" not in names, f
            assert names <= {"__future__", "itertools", "math", "numpy",
                             "torch", "port_bench"}, (f, names)


def test_forbidden_modules_are_found_by_whole_top_level_name(monkeypatch):
    assert "tennis_torch" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "tennis_tpu_extra", types.ModuleType("x"))
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "tennis_tpu", types.ModuleType("x"))
    assert harness.forbidden_loaded() == ["jax", "tennis_tpu"]


def test_a_run_with_the_jax_stack_loaded_prints_no_result(
        monkeypatch, capsys, bench):
    monkeypatch.setattr(harness, "run_cell",
                        lambda *a, **k: ({"correct": True}, {}))
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    code = harness.main(bench["workloads"][0]["name"], 1, 1.0, False, 0.0)
    out = capsys.readouterr()
    assert code != 0 and out.out == "" and "flax" in out.err


def test_a_run_without_a_card_prints_no_result(monkeypatch, capsys, bench):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = harness.main(bench["workloads"][0]["name"], 1, 1.0, False, 0.0)
    assert code != 0 and capsys.readouterr().out == ""
