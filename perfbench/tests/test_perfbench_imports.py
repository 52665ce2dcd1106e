"""No module of the benchmark imports JAX or the JAX package, and the reference
imports nothing of the program; compared by whole top-level module names."""

import ast

import pytest
from conftest import REPO

BANNED = {"jax", "jaxlib", "flax", "videopose3d_tpu"}
ROOT = REPO / "perfbench"
FILES = sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_there_are_modules_to_check():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "contextlib", "numpy", "torch",
                                       "perfbench"}
    # Of the benchmark, the reference imports only the reference.
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith("perfbench"):
            assert node.module.startswith("perfbench.reference")


def test_whole_names_are_compared():
    # "videopose3d_torch" begins with "videopose3d_t..." but is not the JAX package.
    assert "videopose3d_torch".split(".")[0] not in BANNED
