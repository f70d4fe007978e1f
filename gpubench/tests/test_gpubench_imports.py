"""Nothing under gpubench imports JAX or the JAX package, and the reference
imports nothing of the program (top-level module names compared whole)."""

import ast
from pathlib import Path

import pytest

from gpubench.manifest import HERE

JAX = {"jax", "jaxlib", "flax", "tpu_operator"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not set(_imports(path)) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert not set(_imports(path)) & (JAX | {"tpu_operator_torch"})
    assert "gpubench" not in set(_imports(path))


def test_whole_names():
    # the port's name begins with the JAX package's: compared whole
    assert "tpu_operator_torch".split(".")[0] not in JAX
