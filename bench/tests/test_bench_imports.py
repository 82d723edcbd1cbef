"""No module under ``bench/`` imports JAX or the JAX package, and the
plain reference imports nothing of the program: every import statement's
top-level name, compared whole (``repro_torch`` begins with ``repro``)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not {"jax", "jaxlib", "flax", "repro"} & set(_imported(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not {"repro_torch", "repro", "bench"} & set(_imported(path))


def test_the_walk_sees_imports():
    names = set(_imported(BENCH / "harness" / "serve.py"))
    assert {"torch", "queue", "threading"} <= names
