"""Build-time analysis of the dataflow graph: the fusion planner only.

`pw.run` plans select/filter fusion over the parse graph on every run
(internals/runner.py `_install_fusion`), so the planner and the graph
view it walks are ported. The analyzer's diagnostic passes
(`analyze`, `pw.run(analysis="warn"|"strict")`, `pw.run(mesh=...)`) are
not: the port's runner refuses them with NotImplementedError.
"""

from __future__ import annotations

from pathway_tpu_torch.analysis.fusion import FusionChain, FusionPlan, plan_fusion
from pathway_tpu_torch.analysis.graph import GraphView

__all__ = ["FusionChain", "FusionPlan", "GraphView", "plan_fusion"]
