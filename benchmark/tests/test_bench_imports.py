"""The import guard: nothing under ``benchmark/`` imports JAX, jaxlib, flax
or the JAX package ``witw_tpu`` (top-level names compared whole: the port
``witw_tpu_torch`` begins with ``witw_tpu``), the reference imports nothing
of the port, and a run checks ``sys.modules`` by the same rule."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark import run

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "witw_tpu"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def sources(sub=""):
    return sorted((BENCH / sub).rglob("*.py"))


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    bad = set(imported_tops(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sources("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = set(imported_tops(path))
    assert "witw_tpu_torch" not in tops and not (tops & FORBIDDEN)
    assert tops <= {"torch", "numpy", "math", "contextlib", "typing", "__future__", "benchmark"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("benchmark"):
            assert node.module.startswith("benchmark.reference"), node.module


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "witw_tpu_torch_fake", object())
    assert "witw_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "witw_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    found = run.forbidden_modules()
    assert "witw_tpu.models" in found and "jaxlib" in found
