"""No module of the benchmark imports JAX or the JAX package, and the
plain references import nothing of the program. Import names are
compared by their top-level name, whole: `pathway_tpu_torch` begins with
`pathway_tpu` and is not it."""

from __future__ import annotations

import ast
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "pathway_tpu"}


def sources(sub: str = "") -> list:
    out = []
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sources("reference"), ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "pathway_tpu_torch" not in names
    assert names <= {"__future__", "bench_port", "torch", "numpy", "math", "re", "zlib", "contextlib"}
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("bench_port."):
            assert node.module.startswith("bench_port.reference"), node.module


def test_the_prefix_trap_is_compared_whole():
    assert "pathway_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "pathway_tpu.models".split(".")[0] in FORBIDDEN
