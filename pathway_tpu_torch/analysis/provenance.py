"""PWT10xx — record-level lineage coverage (internals/provenance.py).

The provenance tracker reconstructs a row's backward lineage from the
edges the hooked operators record (sources, joins, groupbys, flatten,
fused chains, external indexes) plus the key-preserving operators it
can walk through for free (select/filter/exchange never change keys).
Some operators are neither: they derive output keys the tracker has no
hook for, so a backward BFS that reaches them dead-ends with no path
to a source offset.  That is knowable at BUILD time:

  * PWT1001 — a lineage-opaque operator sits on an anchored path while
    the tracker is armed: `explain` trees that cross it will terminate
    early ("source / untracked") instead of reaching connector offsets.
  * PWT1099 — the job declared that explain MUST work end to end
    (`PATHWAY_PROVENANCE_REQUIRE=1`) but the graph contains an opaque
    operator, so the declaration is unmeetable by construction.  ERROR:
    strict mode aborts the run (the PWT399/599/699/999 parity-gate
    pattern).

The pass only runs when the tracker is armed (`PATHWAY_PROVENANCE=1`):
an unarmed job records no lineage, so opacity costs nothing.
"""

from __future__ import annotations

import os
from typing import Any

from pathway_tpu_torch.analysis.diagnostics import AnalysisResult, make_diag

# Operators whose output keys are derived with no lineage hook: the
# tracker cannot map an output row of these back to its input rows.
# Key-preserving kinds (select/filter/copy/concat/...) are deliberately
# absent — the BFS walks through them without needing an edge — and the
# hooked kinds (join/reduce/flatten/external_index) record their own.
OPAQUE_KINDS = {
    "reindex",      # re-keys rows by an arbitrary expression
    "ix",           # output keyed by another table's indexer column
    "deduplicate",  # instance-derived keys, acc-dependent emission
    "iterate",      # nested subgraph; inner edges are not recorded
}


def provenance_pass(view: Any, result: AnalysisResult) -> None:
    """PWT1001 per anchored lineage-opaque operator; PWT1099 when
    PATHWAY_PROVENANCE_REQUIRE=1 promises end-to-end explain anyway."""
    from pathway_tpu_torch.internals import provenance

    if not provenance.ACTIVE:
        return
    opaque = []
    for kind in sorted(OPAQUE_KINDS):
        opaque.extend(view.anchored_by_kind.get(kind, ()))
    if not opaque:
        return
    for table, op in opaque:
        result.add(make_diag(
            "PWT1001",
            f"`{op.kind}` derives its output keys without a lineage "
            "hook: the provenance tracker records no edge here, so an "
            "`explain` of any downstream row stops at this operator "
            "instead of reaching source-connector offsets; restructure "
            "with a hooked operator (join/groupby/flatten) or accept "
            "the truncated tree",
            trace=getattr(table, "_trace", None),
            operator=view.op_label(table),
            kind=op.kind,
        ))
    if os.environ.get("PATHWAY_PROVENANCE_REQUIRE") == "1":
        table, op = opaque[0]
        result.add(make_diag(
            "PWT1099",
            "PATHWAY_PROVENANCE_REQUIRE=1 declares that every output "
            f"row must explain back to a source offset, but {len(opaque)} "
            "lineage-opaque operator(s) sit on anchored paths (see "
            "PWT1001) — the declaration is unmeetable by construction",
            trace=getattr(table, "_trace", None),
            operator=view.op_label(table),
            opaque_count=len(opaque),
            kinds=sorted({o.kind for _t, o in opaque}),
        ))
