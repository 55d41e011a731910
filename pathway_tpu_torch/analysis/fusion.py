"""Chain-level fusion planning (PWT5xx substrate).

The analyzer's columnar pass predicts per-node implementation choices;
this module plans across nodes: maximal linear chains of row-wise
select/filter ops that can collapse into ONE fused interpreter node
(engine/operators.py FusedChainNode) — one `process()` entry per batch,
no intermediate materialization or per-stage consolidation.

The plan is a contract, not a suggestion.  `internals/runner.py` installs
the same plan on the RunContext before building sinks, the build step
consumes it (RunContext.node builds a chain tail as one fused node), and
`passes.verify_fusion` (PWT599) cross-checks the plan the build claimed
against the fused nodes it actually instantiated — mirroring the
PWT399 discipline for columnar twins.

A chain member must be provably safe to defer behind a single emit:
  * kind is select or filter with exactly one input table (foreign-table
    selects read other universes and need the multi-input RowwiseNode
    state machine);
  * every expression is synchronous and deterministic — an async or
    non-deterministic UDF is a barrier (PWT504): its per-stage outputs
    must be materialized so retractions can cancel insertions.
Interior members additionally need exactly one anchored consumer (the
next member) and must not be sink-anchored themselves: a sink table has
to materialize its own node for the sink to attach to, so it can only
ever be a chain tail.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

from pathway_tpu_torch.analysis.graph import GraphView

_FUSABLE_KINDS = {"select", "filter"}


def fusion_enabled() -> bool:
    """Fusion is on by default; PATHWAY_DISABLE_FUSION=1 restores the
    classic one-node-per-op build (A/B lever for benchmarks and tests)."""
    return os.environ.get("PATHWAY_DISABLE_FUSION", "0").lower() not in (
        "1", "true", "yes",
    )


def udf_barrier(apply_sites: Iterable[Any]) -> Optional[Tuple[str, str]]:
    """(udf name, why) for the first fusion-blocking UDF among the op's
    ApplyExpression sites (GraphView.apply_index — a select/filter's
    payload is exactly its stage expressions), or None when every
    expression is fusable."""
    for node in apply_sites:
        name = getattr(node._fun, "__name__", "<udf>")
        if node._is_async:
            return name, "async"
        if not node._deterministic:
            return name, "non-deterministic"
    return None


@dataclass
class FusionChain:
    """One maximal fusable run of select/filter ops, head to tail.

    `tables` holds strong refs (the plan must outlive the build), and
    `skipped` is the build-side off switch: a skipped chain stays in the
    serialized plan (the claim) but builds classically — which is exactly
    the drift PWT599 exists to catch (tests force it via
    PATHWAY_FUSION_FORCE_SKIP)."""

    tables: List[Any]
    op_ids: Tuple[int, ...]
    kinds: Tuple[str, ...]
    break_reason: str  # "end" | "sink" | "fanout" | "kind" | "udf"
    break_info: Any = None
    skipped: bool = False

    def __len__(self) -> int:
        return len(self.tables)

    @property
    def tail(self) -> Any:
        return self.tables[-1]

    def chain_id(self) -> str:
        return "-".join(str(i) for i in self.op_ids)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.chain_id(),
            "op_ids": list(self.op_ids),
            "kinds": list(self.kinds),
            "length": len(self.tables),
            "break": {
                "reason": self.break_reason,
                "info": (
                    None if self.break_info is None else str(self.break_info)
                ),
            },
        }


@dataclass
class FusionPlan:
    chains: List[FusionChain] = field(default_factory=list)
    # every anchored select/filter op blocked by a UDF: (table, name, why)
    barrier_sites: List[Tuple[Any, str, str]] = field(default_factory=list)
    enabled: bool = True

    def by_tail(self) -> Dict[int, FusionChain]:
        return {id(c.tables[-1]): c for c in self.chains}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "chains": [c.to_dict() for c in self.chains],
            "barriers": [
                {"udf": name, "why": why}
                for _t, name, why in self.barrier_sites
            ],
        }


def plan_fusion(view: GraphView) -> FusionPlan:
    """Walk the anchored op graph and compute maximal fusable chains.

    Deterministic over a given graph build: the same function runs on the
    analyzer side (fusion_pass) and the build side (runner install), so
    the two plans cannot disagree about the same parse graph."""
    # fusable-member status over the anchored single-input select/filters
    # (every chain decision — head, input, next link — looks at anchored
    # tables only: a chain member's input is anchored by construction and
    # anchored_consumers never yields an unanchored next link).  Barriers
    # come from the shared UDF-site index: only apply-bearing ops can
    # carry one, so the full scan just classifies kinds.
    fusable: set = set()
    for kind in _FUSABLE_KINDS:
        for t, op in view.anchored_by_kind.get(kind, ()):
            if len(op.inputs) == 1:
                fusable.add(id(t))
    barrier: Dict[int, Tuple[str, str]] = {}
    for t, op, sites in view.apply_sites():
        if id(t) in fusable:
            b = udf_barrier(sites)
            if b is not None:
                barrier[id(t)] = b

    cons = view.anchored_consumers()
    sinkish = view.sink_ids

    def is_member(t: Any) -> bool:
        return id(t) in fusable and id(t) not in barrier

    def extendable(t: Any) -> bool:
        """Can a chain continue PAST t (t becomes interior)?"""
        return id(t) not in sinkish and len(cons.get(id(t), ())) == 1

    plan = FusionPlan(enabled=fusion_enabled())
    for t, op in view.ops(anchored_only=True):
        tid = id(t)
        if tid in barrier:
            name, why = barrier[tid]
            plan.barrier_sites.append((t, name, why))
            continue
        if tid not in fusable:
            continue
        inp = op.inputs[0]
        if is_member(inp) and extendable(inp):
            continue  # t is interior/tail of the chain started upstream
        members = [t]
        cur = t
        break_reason, break_info = "end", None
        while True:
            if not extendable(cur):
                consumers = cons.get(id(cur), ())
                if id(cur) in sinkish:
                    break_reason = "sink" if consumers else "end"
                elif len(consumers) > 1:
                    break_reason, break_info = "fanout", len(consumers)
                break
            (nxt,) = cons[id(cur)]
            nid = id(nxt)
            if nid not in fusable:
                break_reason = "kind"
                nxt_op = getattr(nxt, "_op", None)
                break_info = nxt_op.kind if nxt_op is not None else "sink"
                break
            if nid in barrier:
                break_reason, break_info = "udf", barrier[nid]
                break
            members.append(nxt)
            cur = nxt
        if len(members) < 2:
            continue  # a single op fuses with nothing; build it classically
        plan.chains.append(FusionChain(
            tables=members,
            op_ids=tuple(m._op.op_id for m in members),
            kinds=tuple(m._op.kind for m in members),
            break_reason=break_reason,
            break_info=break_info,
        ))
    plan.chains.sort(key=lambda c: c.op_ids)
    return plan


def plan_for_build(graph: Any, extra_tables: Iterable[Any] = ()):
    """Build-side entry point (internals/runner.py): plan over the current
    parse graph, honoring the disable/force-skip env levers.  Returns None
    when fusion is globally disabled — the runner then leaves the context
    untouched and every op builds its classic node."""
    if not fusion_enabled():
        return None
    plan = plan_fusion(GraphView(graph, extra_tables=extra_tables))
    force = os.environ.get("PATHWAY_FUSION_FORCE_SKIP", "")
    if force:
        # drift injection for the PWT599 negative tests: the plan still
        # claims these chains (to_dict is unchanged) but the build drops
        # them, so the verifier must notice
        if force.strip().lower() == "all":
            for c in plan.chains:
                c.skipped = True
        else:
            wanted = {s.strip() for s in force.split(",") if s.strip()}
            for c in plan.chains:
                if str(c.op_ids[-1]) in wanted or c.chain_id() in wanted:
                    c.skipped = True
    return plan
