"""Build-time static analysis of the dataflow graph.

`analyze()` walks the recorded parse graph (see
`internals/parse_graph.OpSpec`) and returns an `AnalysisResult` of
structured diagnostics — stable PWT codes, user stack frames, rendered
expressions — plus per-node columnar-eligibility predictions.

Three surfaces consume it:
  * `pathway-tpu-torch analyze script.py` (cli.py) — text/JSON, --fail-on for CI
  * `pw.run(analysis="strict"|"warn"|"off")` (internals/runner.py)
  * the `/status` observability endpoint (internals/monitoring.py)
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

from pathway_tpu_torch.analysis.diagnostics import (
    CODES,
    FAMILIES,
    SCHEMA_VERSION,
    AnalysisResult,
    Diagnostic,
    Severity,
    make_diag,
)
from pathway_tpu_torch.analysis.capacity import capacity_pass, verify_capacity
from pathway_tpu_torch.analysis.cost import cost_pass
from pathway_tpu_torch.analysis.fusion import FusionChain, FusionPlan, plan_fusion
from pathway_tpu_torch.analysis.graph import GraphView
from pathway_tpu_torch.analysis.mesh import MeshSpec
from pathway_tpu_torch.analysis.purity import (
    classify_callable,
    purity_pass,
    verify_purity,
)
from pathway_tpu_torch.analysis.provenance import provenance_pass
from pathway_tpu_torch.analysis.serving import serving_pass
from pathway_tpu_torch.analysis.passes import (
    columnar_pass,
    dead_pass,
    dtype_pass,
    embedder_pass,
    fusion_pass,
    mesh_pass,
    state_pass,
    udf_pass,
    verify_against_plan,
    verify_fusion,
)


class AnalysisError(RuntimeError):
    """Raised by pw.run(analysis="strict") when the analyzer finds
    warning-or-worse diagnostics."""

    def __init__(self, result: AnalysisResult):
        self.result = result
        super().__init__(
            "static analysis failed:\n" + result.render_text()
        )


def _worker_count() -> int:
    from pathway_tpu_torch.internals.config import pathway_config

    threads = getattr(pathway_config, "threads", 1) or 1
    processes = getattr(pathway_config, "processes", 1) or 1
    return max(threads, 1) * max(processes, 1)


def analyze(
    graph: Any = None,
    *,
    extra_tables: Iterable[Any] = (),
    workers: Optional[int] = None,
    mesh: Any = None,
    slo: Optional[float] = None,
) -> AnalysisResult:
    """Run every pass over `graph` (default: the global parse graph).

    `extra_tables` anchors tables that are not registered as sinks (e.g.
    run_tables captures); `workers` overrides the configured worker
    count for the exchange-related lints; `mesh` (a MeshSpec,
    "dp=4,tp=2" string or mapping) additionally runs the PWT4xx
    mesh-compatibility pass against that device topology; `slo` is the
    declared p99 target in milliseconds (pw.run(slo=)), consumed by the
    PWT70x serving lints (PATHWAY_SLO_P99_MS is the fallback)."""
    if graph is None:
        from pathway_tpu_torch.internals.parse_graph import G as graph
    if workers is None:
        workers = _worker_count()
    if mesh is not None:
        mesh = MeshSpec.parse(mesh)
    view = GraphView(graph, extra_tables=extra_tables)
    result = AnalysisResult()
    dtype_pass(view, result)
    state_pass(view, result)
    columnar_pass(view, result, workers=workers)
    dead_pass(view, result)
    udf_pass(view, result, workers=workers)
    purity_pass(view, result, workers=workers)
    embedder_pass(view, result, workers=workers)
    fusion_pass(view, result)
    mesh_pass(view, result, mesh=mesh, workers=workers)
    capacity_pass(view, result, mesh=mesh, workers=workers)
    serving_pass(view, result, slo=slo)
    cost_pass(view, result)
    provenance_pass(view, result)
    return result


__all__ = [
    "AnalysisError",
    "AnalysisResult",
    "CODES",
    "Diagnostic",
    "FAMILIES",
    "FusionChain",
    "FusionPlan",
    "GraphView",
    "MeshSpec",
    "SCHEMA_VERSION",
    "Severity",
    "analyze",
    "capacity_pass",
    "classify_callable",
    "cost_pass",
    "make_diag",
    "plan_fusion",
    "provenance_pass",
    "purity_pass",
    "serving_pass",
    "verify_against_plan",
    "verify_capacity",
    "verify_fusion",
    "verify_purity",
]
