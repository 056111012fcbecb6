"""No module of the benchmark imports JAX or the JAX package, and the
references import nothing of the program (top-level names compared
whole)."""

import ast
import os

import pytest

from benchmark import harness

FORBIDDEN = set(harness.FORBIDDEN)


def imported_top_levels(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


def _sources(sub=""):
    base = os.path.join(harness.BENCH_DIR, sub)
    for here, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(here, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax_anywhere_in_the_benchmark(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_the_reference_imports_nothing_of_the_program(path):
    assert imported_top_levels(path) <= {"__future__", "math", "torch", "benchmark"}


def test_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import sparkdl_tpux\nfrom jaxy import a\nimport flax.linen\n")
    assert imported_top_levels(str(src)) & FORBIDDEN == {"flax"}


def test_the_run_time_check_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jaxlike", types.ModuleType("jaxlike"))
    assert "jaxlike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax.numpy"]
