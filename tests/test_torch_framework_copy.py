"""Drift guard: the port's host framework is a copy of the JAX package's.

The engine, Table DSL (with internals/interactive.py), connectors
(pw.io.http with its REST server among them), persistence, debug,
observability (the profiler among them), the static analyzer and the cli
(cli.py), UDF, stdlib (indexing, temporal windows and joins,
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
    "analysis", "debug", "demo", "engine", "internals", "io", "persistence", "stdlib", "xpacks",
)
_COPIED_FILES = ("cli.py", "universes.py")

EDITED = {
    "internals/device_pipeline.py": (
        "_default_wait reads back one element of a CUDA tensor (or returns for "
        "CPU tensors and None) in place of the jnp.sum readback; the stage spans "
        "go to the process's host-span ring (internals/tracing.py) in place of a "
        "private deque, _spans is a read-only view of this pipeline's records "
        "there, and take_aux_spans is gone"
    ),
    "internals/tracing.py": (
        "a process-wide host-span ring (SpanRing, record_span, spans_between) on "
        "perf_counter, off with PATHWAY_TRACE=0, which the pipeline, decoder and "
        "ingest record into; TraceStore.pipeline_spans hands a sampled epoch the "
        "ring's pipeline spans in place of the nodes' take_aux_spans"
    ),
    "engine/engine.py": (
        "a sampled epoch takes the device pipeline's spans from the host-span "
        "ring (TraceStore.pipeline_spans) in place of each node's take_aux_spans"
    ),
    "internals/qtrace.py": (
        "marks are perf_counter readings (the host-span ring's clock), made wall "
        "time at export and on the TCP wire; udf_start / udf_end marks split the "
        "merge stage of a query through a batched UDF into merge, udf and "
        "post_udf; finished spans stay in a bounded ring (finished_between); "
        "stage_intervals gives a span's stages for the profiler's export"
    ),
    "engine/expression_eval.py": (
        "a batched UDF's evaluation stamps udf_start / udf_end on the query spans "
        "of its rows' keys (internals/qtrace.py)"
    ),
    "internals/memtrack.py": (
        "device_memory_stats reads torch.cuda's allocator stats and the card's "
        "total memory in place of jax's memory_stats; capacity has no TPU chip table"
    ),
    "internals/mesh_backend.py": (
        "activate() builds a parallel.mesh.Mesh of torch devices, those of the mesh "
        "with_mesh holds (whose axes must be the spec's, else ValueError) or the "
        "process's CUDA devices, in place of a jax.sharding.Mesh over jax.devices(); "
        "batch_sharding() returns parallel.mesh.NamedSharding in place of JAX's"
    ),
    "internals/profiler.py": (
        "captures with torch.profiler (CPU activity, plus CUDA where the process "
        "has a card) into one Chrome trace JSON file, named in the result as "
        "trace_file, in place of jax.profiler's XPlane directory; every profiler "
        "user holds the busy guard through exclusive(), which also sets the "
        "session's CUPTI teardown; a process's first capture on a card sets CUPTI "
        "up in a session of its own before the window (setup_seconds); "
        "capture_local drives a bf16 torch matmul on device= (None: the CUDA "
        "card) in place of a jitted jnp chain; capture adds the host-span ring's "
        "and the finished query spans of its window to the trace as a 'host "
        "spans' process, on the trace's clock through an anchor record_function"
    ),
    "analysis/capacity.py": (
        "predict_index_bytes predicts the port's DeviceKnnIndex allocation from "
        "ops/knn.py's index_rows / index_row_bytes: rows padded to a multiple of "
        "4 float32 columns, which the JAX package's slab does not have, so the "
        "PWT601 message names the padded row bytes"
    ),
    "cli.py": (
        "the parser's prog is pathway-tpu-torch (the JAX package owns pathway and "
        "pathway-tpu), and profile's help names torch.profiler and the CUDA card "
        "in place of jax.profiler"
    ),
    "internals/trace_tool.py": (
        "the top frame and the restart hint name pathway-tpu-torch, profile "
        "points at the Chrome trace file (chrome://tracing, Perfetto) in place of "
        "tensorboard / xprof, and profile --url waits 120 s past the window, not "
        "30: a job's first capture on a card sets CUPTI up before its window"
    ),
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
        "the vector impl, which under a mesh the mesh's devices place (a contradicting "
        "device= raises); _quiesce_device waits on each shard's block; "
        "the vector impl keeps its host mirror and numpy search for a CPU index only, "
        "and on the card a degraded monitor makes search_many raise DeviceDegradedError "
        "instead of moving the search to the host; the fused impl's close() stops its "
        "DevicePipeline at the run's end, which would hold the index's device memory; "
        "take_aux_spans is gone (the epoch tracer reads the host-span ring)"
    ),
    "engine/index_node.py": (
        "ExternalIndexNode.on_end calls the index backend's close() where it has one, "
        "so that the fused index's pipeline threads do not hold it past its run; "
        "take_aux_spans is gone (the epoch tracer reads the host-span ring)"
    ),
    "io/_connector_runtime.py": (
        "when the streaming driver's run ends it detaches its sinks: they drop the "
        "queue and the source (and through it the engine, its index and its model), "
        "later rows and commits go nowhere, and ConnectorSubjectBase."
        "_wait_for_run_end wakes the polling readers so that they return; the "
        "health controller's pacing sleep no longer counts toward the autocommit "
        "deadline, which at a delay as long as the interval flushed every tick "
        "before reading and never read the queue again"
    ),
    "io/http/_server.py": (
        "a REST connector takes a micro-batcher of its own when its run starts and "
        "retires it when the run ends; shared by the route for the life of the "
        "process, as in the JAX package, a server on the route in a later run "
        "parked its requests on the ended run's connector and never answered; "
        "PathwayWebserver._ensure_started starts the server's thread once and "
        "waits again for a thread still starting, where the JAX package's starts "
        "a second server on the port after 10 s, which dies with EADDRINUSE"
    ),
    "internals/serving.py": (
        "ServingTier.batcher makes a new micro-batcher for each REST connector's "
        "run, and ServingTier.retire closes it at the run's end and keeps its "
        "counts, in place of one get-or-create batcher per route for the life "
        "of the process"
    ),
    "io/fs.py": (
        "the streaming reader waits out its refresh interval through "
        "_wait_for_run_end and returns when the run has ended, in place of a sleep "
        "that held the finished run for the interval and then polled on"
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
    "internals/yaml_loader.py": (
        "_resolve_dotted refuses a tag that names pathway_tpu, so that a manifest "
        "cannot make the port import the JAX package; !pw. tags resolve inside "
        "pathway_tpu_torch as there"
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


# the JAX package's modules that the port has no counterpart for: none
# (internals/mesh_backend.py is in EDITED: its device half builds the
# port's mesh of torch devices)
UNPORTED: set = set()


def _modules(pkg: str) -> set:
    out = set()
    for root, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out |= {os.path.relpath(os.path.join(root, f), pkg) for f in files if f.endswith(".py")}
    return out


def test_every_jax_module_has_a_counterpart():
    assert _modules(JAX_PKG) - _modules(PORT_PKG) == UNPORTED == set()
    assert "internals/mesh_backend.py" in EDITED


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
