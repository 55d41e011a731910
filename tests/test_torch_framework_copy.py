"""Drift guard: the port's host framework is a copy of the JAX package's.

The engine, Table DSL, connectors, persistence, debug and observability
modules under pathway_tpu_torch/ were copied whole from pathway_tpu/,
with `pathway_tpu` rewritten to `pathway_tpu_torch`. For each one, the
port's file (with `pathway_tpu_torch` read as `pathway_tpu`) and the JAX
file must parse to the same syntax tree once docstrings are stripped:
comments and docstrings may differ (the port's drop the TPU timings), the
code may not. A change to either side shows up here, so the two are
changed together.

The modules in EDITED differ on purpose; each carries its reason and is
left out of the equality.
"""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "pathway_tpu")
PORT_PKG = os.path.join(REPO, "pathway_tpu_torch")

# the copied subpackages, and the copied modules outside them
_COPIED_DIRS = ("analysis", "debug", "engine", "internals", "io", "persistence")
_COPIED_FILES = ("universes.py",)

EDITED = {
    "internals/device_pipeline.py": (
        "_default_wait reads back one element of a CUDA tensor (or returns for "
        "CPU tensors and None) in place of the jnp.sum readback"
    ),
    "internals/memtrack.py": (
        "device_memory_stats reads torch.cuda's allocator stats and the card's "
        "total memory in place of jax's memory_stats; capacity has no TPU chip table"
    ),
    "internals/mesh_backend.py": (
        "no device mesh in the port yet: activate() and batch_sharding() raise "
        "in place of building a jax.sharding.Mesh"
    ),
    "internals/runner.py": (
        "the static analyzer is not ported: analysis='warn'/'strict' raise "
        "NotImplementedError in _apply_analysis (mesh= already raised in "
        "mesh_backend.activate), and the threaded run has no AnalysisError to surface"
    ),
    "analysis/__init__.py": "exports the fusion planner only; the analyzer's passes are not ported",
}


def _copied_modules():
    out = [os.path.join(PORT_PKG, f) for f in _COPIED_FILES]
    for sub in _COPIED_DIRS:
        for root, _dirs, files in os.walk(os.path.join(PORT_PKG, sub)):
            out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, PORT_PKG) for p in out)


def _strip_docstrings(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                getattr(body[0], "value", None), ast.Constant
            ) and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _tree(path: str, *, port: bool) -> str:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    if port:
        src = src.replace("pathway_tpu_torch", "pathway_tpu")
    return ast.dump(_strip_docstrings(ast.parse(src)), include_attributes=False)


def test_every_copied_module_has_a_jax_counterpart():
    mods = _copied_modules()
    assert len(mods) >= 70
    missing = [m for m in mods if not os.path.exists(os.path.join(JAX_PKG, m))]
    assert not missing, missing
    assert set(EDITED) <= set(mods)


@pytest.mark.parametrize("module", [m for m in _copied_modules() if m not in EDITED])
def test_copied_module_matches_the_jax_source(module):
    assert _tree(os.path.join(PORT_PKG, module), port=True) == _tree(
        os.path.join(JAX_PKG, module), port=False
    ), f"pathway_tpu_torch/{module} drifted from pathway_tpu/{module}"


@pytest.mark.parametrize("module", sorted(EDITED))
def test_edited_module_still_differs_and_names_no_jax(module):
    """An edited module keeps its edit (else it belongs in the equality
    test) and, like every port file, reaches no JAX, not even through
    sys.modules."""
    port = _tree(os.path.join(PORT_PKG, module), port=True)
    assert port != _tree(os.path.join(JAX_PKG, module), port=False), (
        f"{module} matches its source again: drop it from EDITED"
    )
    with open(os.path.join(PORT_PKG, module), encoding="utf-8") as f:
        code = ast.dump(_strip_docstrings(ast.parse(f.read())))
    assert not re.search(r"\bjax\b|jnp", code)


def test_wire_codec_extension_matches_the_jax_source():
    with open(os.path.join(PORT_PKG, "native", "wire_ext.cpp"), encoding="utf-8") as f:
        port = f.read().replace("pathway_tpu_torch", "pathway_tpu")
    with open(os.path.join(JAX_PKG, "native", "wire_ext.cpp"), encoding="utf-8") as f:
        assert port == f.read()
