"""No module of the benchmark imports jax or the JAX package, and the
reference imports nothing of the port (top-level names compared whole)."""

import ast
from pathlib import Path

import pytest

from benchmark import harness

FILES = sorted(harness.HERE.rglob("*.py"))


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "kajo_tpu"}


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_is_the_benchmarks_own(path):
    assert not _imports(path) & {"kajo_tpu_torch", "kajo_tpu", "benchmark"}


def test_top_level_names_are_compared_whole():
    import sys

    sys.modules.setdefault("kajo_tpu_torch_probe", None)
    try:
        assert "kajo_tpu" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("kajo_tpu_torch_probe", None)
