"""Drift guard: the port's host framework is a copy of the JAX package's.

The engine, Table DSL (with internals/interactive.py), connectors
(pw.io.http with its REST server among them), persistence, debug,
observability, UDF, stdlib (indexing, temporal windows and joins,
ordered, stateful, statistical, utils, ml, graphs, viz) and xpack
modules (the LLM xpack with RAG question answering, prompts, chats,
rerankers and the REST / MCP servers, and xpacks/connectors) under
pathway_tpu_torch/ were copied whole from pathway_tpu/,
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
_COPIED_DIRS = (
    "analysis", "debug", "engine", "internals", "io", "persistence", "stdlib", "xpacks",
)
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
    "internals/costmodel.py": (
        "device_name reads torch.cuda.get_device_name in place of jax.devices(), "
        "and the peak tables hold the H100's published numbers in place of the TPUs'"
    ),
    "internals/device_probe.py": (
        "_PROBE_CODE runs a torch matmul on cuda with torch.cuda.synchronize() in "
        "place of a jax.jit dispatch; device_status reads a live CUDA context and "
        "memtrack.device_memory_stats in place of jax's"
    ),
    "stdlib/indexing/nearest_neighbors.py": (
        "_quiesce_device reads back one element of the torch buffer in place of a "
        "jnp.sum; the fused impl builds its index and FusedEmbedSearch on the "
        "encoder's device; BruteForceKnn / BruteForceKnnFactory take device= for "
        "the vector impl; mesh= and an active mesh backend raise (no device mesh); "
        "the vector impl keeps its host mirror and numpy search for a CPU index only, "
        "and on the card a degraded monitor makes search_many raise DeviceDegradedError "
        "instead of moving the search to the host"
    ),
    "xpacks/llm/embedders.py": (
        "SentenceTransformerEmbedder(device=None) places the encoder (None: the "
        "CUDA card) and passes it to SentenceEncoder.cached; the JAX package "
        "ignores its device='tpu'"
    ),
    "stdlib/ml/index.py": (
        "KNNIndex(device=None) places its BruteForceKnn index (None: the CUDA card) "
        "and passes it to BruteForceKnn(device=); the JAX package's KNNIndex takes no device"
    ),
    "stdlib/ml/classifiers.py": (
        "knn_lsh_classifier_train passes kwargs.get('device') to KNNIndex, so the "
        "classifier's index is placed as KNNIndex's is (None: the CUDA card)"
    ),
    "xpacks/llm/llms.py": (
        "HFPipelineChat(device=None) places the decoder (None: the CUDA card) and "
        "passes it to ChatModel.cached; the JAX package ignores its device='tpu'"
    ),
    "xpacks/llm/rerankers.py": (
        "CrossEncoderReranker and EncoderReranker take device=None (the CUDA card) "
        "and pass it to CrossEncoderModel.cached / SentenceEncoder.cached; the JAX "
        "package's rerankers take no device"
    ),
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
