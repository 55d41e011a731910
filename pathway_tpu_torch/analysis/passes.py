"""The analyzer passes.

Each pass takes the `GraphView` and appends findings / predictions to an
`AnalysisResult`.  Passes only report what they can prove from recorded
ops, markers and schemas — anything uninferable stays silent (a lint
that guesses is worse than no lint).

The columnar-eligibility pass does not re-implement the runtime gates:
joins expose `_columnar_reasons()` next to `_join_keys_hashable()`,
reduce records the gate outcome (`use_vector` + reasons) on its OpSpec
from the very variable the build closure captures, and flatten asks
`vector_flatten_supported()`.  Prediction and selection share one source
of truth, which is what lets `verify_against_plan` treat a mismatch as
an internal error (PWT399) rather than an expected drift.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set

from pathway_tpu_torch.analysis.diagnostics import AnalysisResult, make_diag
from pathway_tpu_torch.analysis.graph import GraphView, infer, op_exprs, walk_expr
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    BinaryOpExpression,
    CastExpression,
    ColumnReference,
    IdReference,
)
from pathway_tpu_torch.internals.expression_printer import print_expression

_ARITH_OPS = {"+", "-", "*", "/", "//", "%", "**"}
_COMPARE_OPS = {"==", "!=", "<", "<=", ">", ">="}
# dtypes whose values ref_scalar can always hash — the exchange layer
# routes by that hash; anything else risks the unroutable-to-worker-0
# fallback (engine/exchange.py _Route.codes)
_ROUTABLE_CORES = (
    dt.STR, dt.INT, dt.FLOAT, dt.BOOL, dt.BYTES, dt.POINTER,
    dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC, dt.DURATION, dt.NONE,
)
# op kinds that accumulate state keyed on their input rows: a
# non-deterministic UDF upstream of one of these makes retractions
# recompute a *different* value, so deletions stop cancelling insertions
STATEFUL_KINDS = {
    "reduce", "join", "semijoin", "deduplicate", "sort", "iterate",
    "clocked", "stream_to_table", "merge_streams", "gradual_broadcast",
    "ix", "reindex",
}
# kinds whose engine nodes sit behind an exchange on multi-worker runs
_EXCHANGE_KINDS = {"reduce", "join", "semijoin", "deduplicate", "sort"}


def _trace_or_none(table: Any):
    return getattr(table, "_trace", None)


def _core(d: Optional[dt.DType]) -> Optional[dt.DType]:
    if d is None:
        return None
    if isinstance(d, dt.Optionalized):
        d = dt.unoptionalize(d)
    return d


# ---------------------------------------------------------------------------
# Pass 1 — dtype / coercion checks (PWT101, PWT102, PWT103)
# ---------------------------------------------------------------------------

_NUMERIC = (dt.INT, dt.FLOAT, dt.BOOL)


def _comparable(a: dt.DType, b: dt.DType) -> bool:
    if a == b:
        return True
    if a in _NUMERIC and b in _NUMERIC:
        return True
    # naive/utc datetimes, durations etc. must match exactly; ANY-family
    # and container dtypes are handled by the caller (skipped)
    return False


def dtype_pass(view: GraphView, result: AnalysisResult) -> None:
    for table, op in view.ops():
        if op.synthetic:
            continue
        seen_nodes: Set[int] = set()
        for expr in op_exprs(op):
            for node in walk_expr(expr):
                if id(node) in seen_nodes:
                    continue  # shared subexpressions report once
                seen_nodes.add(id(node))
                trace = _trace_or_none(table)
                operator = view.op_label(table)
                if isinstance(node, CastExpression):
                    inner = _core(infer(node._expr))
                    target = _core(node._target)
                    if inner is dt.FLOAT and target is dt.INT:
                        result.add(make_diag(
                            "PWT101",
                            "cast from float to int truncates: "
                            f"{print_expression(node)}",
                            trace=trace, operator=operator,
                            expression=print_expression(node),
                        ))
                elif isinstance(node, BinaryOpExpression):
                    lhs = infer(node._left)
                    rhs = infer(node._right)
                    lc, rc = _core(lhs), _core(rhs)
                    if lc is None or rc is None:
                        continue
                    simple = (
                        lc in _ROUTABLE_CORES and rc in _ROUTABLE_CORES
                    )
                    if (
                        node._op in _COMPARE_OPS
                        and simple
                        and not _comparable(lc, rc)
                    ):
                        result.add(make_diag(
                            "PWT102",
                            f"comparison {print_expression(node)} mixes "
                            f"incompatible dtypes {lhs} and {rhs}",
                            trace=trace, operator=operator,
                            expression=print_expression(node),
                            left_dtype=str(lhs), right_dtype=str(rhs),
                        ))
                    elif node._op in _ARITH_OPS and (
                        isinstance(lhs, dt.Optionalized)
                        or isinstance(rhs, dt.Optionalized)
                    ):
                        if lc in _NUMERIC and rc in _NUMERIC:
                            result.add(make_diag(
                                "PWT103",
                                "arithmetic on optional operand "
                                f"{print_expression(node)} silently "
                                "propagates None",
                                trace=trace, operator=operator,
                                expression=print_expression(node),
                            ))


# ---------------------------------------------------------------------------
# Pass 2 — state growth (PWT201, PWT202, PWT203)
# ---------------------------------------------------------------------------

# temporal entry points that accept behavior=; window_join has no such
# knob, so flagging it would be unsatisfiable noise
_BEHAVIORAL_TEMPORAL = {"windowby", "interval_join", "asof_join"}


def state_pass(view: GraphView, result: AnalysisResult) -> None:
    for marker in view.markers:
        if (
            marker.kind in _BEHAVIORAL_TEMPORAL
            and not marker.info.get("has_behavior")
        ):
            result.add(make_diag(
                "PWT201",
                f"{marker.kind} without behavior= keeps every row "
                "forever; pass pw.temporal.common_behavior(...) to bound "
                "state",
                trace=marker.trace, operator=marker.kind,
                temporal_op=marker.kind,
            ))
    for table, op in view.ops():
        if op.kind == "reduce" and not op.synthetic:
            for g in op.exprs.get("grouping", ()):
                gd = infer(g)
                core = _core(gd)
                if core is dt.FLOAT or core is dt.ANY:
                    result.add(make_diag(
                        "PWT202",
                        f"groupby key {print_expression(g)} has "
                        f"unbounded-cardinality dtype {gd}: every "
                        "distinct value becomes a group held in state",
                        trace=_trace_or_none(table),
                        operator=view.op_label(table),
                        key=print_expression(g), dtype=str(gd),
                    ))
        elif op.kind == "iterate" and op.info.get("iteration_limit") is None:
            result.add(make_diag(
                "PWT203",
                "iterate without iteration_limit= may never converge on "
                "adversarial input; bound it or document why the "
                "fixpoint is guaranteed",
                trace=_trace_or_none(table),
                operator=view.op_label(table),
            ))


# ---------------------------------------------------------------------------
# Pass 3 — columnar eligibility + predictions (PWT301..PWT304)
# ---------------------------------------------------------------------------

def _routable(d: Optional[dt.DType]) -> bool:
    """Can ref_scalar hash every value of this dtype?  Containers of
    routable dtypes hash fine; Json / ANY / arrays may not."""
    core = _core(d)
    if core is None:
        return False
    if core in _ROUTABLE_CORES:
        return True
    if isinstance(core, dt.TupleDType):
        return all(_routable(a) for a in core.args)
    if isinstance(core, dt.ListDType):
        return _routable(core.arg)
    return False


def _prediction(
    view: GraphView,
    table: Any,
    op_kind: str,
    op_id: int,
    reasons: List[str],
) -> Dict[str, Any]:
    from pathway_tpu_torch.analysis.diagnostics import _trace_to_dict

    return {
        "op": op_kind,
        "op_id": op_id,
        "predicted": "classic" if reasons else "columnar",
        "reasons": list(reasons),
        "trace": _trace_to_dict(_trace_or_none(table)),
        "operator": view.op_label(table),
        "anchored": view.is_anchored(table),
    }


def columnar_pass(
    view: GraphView, result: AnalysisResult, *, workers: int = 1
) -> None:
    from pathway_tpu_torch.engine.vector_flatten import vector_flatten_supported

    seen_joins: Set[int] = set()
    for table, op in view.ops():
        trace = _trace_or_none(table)
        operator = view.op_label(table)
        if op.kind == "join":
            from pathway_tpu_torch.internals.joins import JoinResult

            jr = op.info.get("join_result")
            if jr is None or id(jr) in seen_joins:
                continue  # several selects on one JoinResult share a node
            seen_joins.add(id(jr))
            # temporal subclasses (interval/asof) build their own node
            # kinds — the vector-join gate does not apply to them
            if type(jr) is JoinResult:
                reasons = jr._columnar_reasons()
                result.predictions.append(
                    _prediction(view, table, "join", op.op_id, reasons)
                )
                if reasons:
                    result.add(make_diag(
                        "PWT301",
                        "join cannot take the columnar path: "
                        + "; ".join(reasons),
                        trace=trace, operator=operator, reasons=reasons,
                    ))
            if workers > 1:
                for key in (
                    list(op.exprs.get("on_left", ()))
                    + list(op.exprs.get("on_right", ()))
                ):
                    if not _routable(infer(key)):
                        result.add(make_diag(
                            "PWT302",
                            f"join key {print_expression(key)} has "
                            f"dtype {infer(key)} the exchange layer "
                            "cannot hash: rows pile up on worker 0 "
                            "(pathway_exchange_unroutable_rows)",
                            trace=trace, operator=operator,
                            key=print_expression(key),
                        ))
        elif op.kind == "reduce":
            reasons = list(op.info.get("vector_reasons", ()))
            result.predictions.append(
                _prediction(view, table, "reduce", op.op_id, reasons)
            )
            if reasons and not op.synthetic:
                result.add(make_diag(
                    "PWT303",
                    "reduce cannot take the columnar path: "
                    + "; ".join(reasons),
                    trace=trace, operator=operator, reasons=reasons,
                ))
            if workers > 1 and not op.synthetic:
                for g in op.exprs.get("grouping", ()):
                    if not _routable(infer(g)):
                        result.add(make_diag(
                            "PWT302",
                            f"groupby key {print_expression(g)} has "
                            f"dtype {infer(g)} the exchange layer "
                            "cannot hash: rows pile up on worker 0 "
                            "(pathway_exchange_unroutable_rows)",
                            trace=trace, operator=operator,
                            key=print_expression(g),
                        ))
        elif op.kind == "flatten":
            reasons = (
                []
                if vector_flatten_supported()
                else ["vector flatten disabled by configuration"]
            )
            result.predictions.append(
                _prediction(view, table, "flatten", op.op_id, reasons)
            )
            if reasons:
                result.add(make_diag(
                    "PWT304",
                    "flatten runs the classic row-wise path: "
                    + "; ".join(reasons),
                    trace=trace, operator=operator, reasons=reasons,
                ))


# ---------------------------------------------------------------------------
# Pass 4 — dead subgraphs and unused columns (PWT110, PWT111)
# ---------------------------------------------------------------------------

def dead_pass(view: GraphView, result: AnalysisResult) -> None:
    if not view.sink_tables:
        return  # nothing is anchored; "everything is dead" is not useful
    for table, op in view.ops():
        if op.synthetic or view.is_anchored(table):
            continue
        # report only subgraph leaves (no consumers): the table the user
        # computed and dropped, not every op that fed it
        if view.consumers.get(id(table)):
            continue
        result.add(make_diag(
            "PWT110",
            f"result of {op.kind} is never written to a sink: the "
            "subgraph computes rows nobody reads",
            trace=_trace_or_none(table),
            operator=view.op_label(table),
        ))

    # backward column liveness over the anchored region
    live: Dict[int, Set[str]] = {
        id(t): set(t.column_names()) for t in view.sink_tables
    }
    by_id = {id(t): t for t in view.anchored}
    work = list(view.sink_tables)

    def mark(tbl: Any, col: str) -> None:
        s = live.setdefault(id(tbl), set())
        if col not in s:
            s.add(col)
            work.append(tbl)

    def mark_refs(expr: Any) -> None:
        for node in walk_expr(expr):
            if isinstance(node, ColumnReference) and not isinstance(
                node, IdReference
            ):
                mark(node._table, node._name)

    processed: Set[tuple] = set()
    while work:
        t = work.pop()
        op = getattr(t, "_op", None)
        if op is None:
            continue
        out_live = frozenset(live.get(id(t), ()))
        key = (id(t), out_live)
        if key in processed:
            continue
        processed.add(key)
        if op.kind == "select":
            for name in out_live:
                expr = op.exprs.get("cols", {}).get(name)
                if expr is not None:
                    mark_refs(expr)
        elif op.kind == "filter":
            (inp,) = op.inputs
            for name in out_live:
                mark(inp, name)
            mark_refs(op.exprs.get("expr"))
        else:
            # conservative: the op may read anything from its inputs
            for inp in op.inputs:
                for name in inp.column_names():
                    mark(inp, name)
            for expr in op_exprs(op):
                mark_refs(expr)

    for t in view.anchored:
        op = getattr(t, "_op", None)
        if op is None or op.kind != "select" or op.synthetic:
            continue
        if not view.consumers.get(id(t)):
            continue  # sink-written tables keep every column
        unused = sorted(set(t.column_names()) - live.get(id(t), set()))
        for name in unused:
            result.add(make_diag(
                "PWT111",
                f"column {name!r} is computed but never read "
                "downstream",
                trace=_trace_or_none(t),
                operator=view.op_label(t),
                column=name,
            ))


# ---------------------------------------------------------------------------
# Pass 5 — UDF hazards (PWT305, PWT306)
# ---------------------------------------------------------------------------

def udf_pass(
    view: GraphView, result: AnalysisResult, *, workers: int = 1
) -> None:
    for table, op, sites in view.apply_sites():
        if op.synthetic:
            continue
        stateful_here = op.kind in STATEFUL_KINDS
        reaches_stateful = stateful_here or view.reaches_kind(
            table, STATEFUL_KINDS
        )
        crosses_exchange = workers > 1 and (
            op.kind in _EXCHANGE_KINDS
            or view.reaches_kind(table, _EXCHANGE_KINDS)
        )
        for node in sites:
            fname = getattr(node._fun, "__name__", "<udf>")
            if not node._deterministic and reaches_stateful:
                result.add(make_diag(
                    "PWT305",
                    f"UDF {fname!r} is not marked deterministic but "
                    "feeds a stateful operator: retractions recompute "
                    "it and may not cancel the original insertion "
                    "(mark it @pw.udf(deterministic=True) if it is)",
                    trace=_trace_or_none(table),
                    operator=view.op_label(table),
                    udf=fname,
                ))
            if node._is_async and crosses_exchange:
                result.add(make_diag(
                    "PWT306",
                    f"async UDF {fname!r} sits on an exchange-"
                    "crossing path: its completion times differ per "
                    "worker, so downstream keyed state sees "
                    "interleavings that are hard to reproduce",
                    trace=_trace_or_none(table),
                    operator=view.op_label(table),
                    udf=fname,
                ))


# ---------------------------------------------------------------------------
# Pass 6 — embedder batch-shape waste (PWT401)
# ---------------------------------------------------------------------------

# Deterministic stand-in for typical short-document corpora (final token
# counts per doc, CLS/SEP included — roughly what bench.py's synthetic
# ingest feeds the embedder). The lint is a shape argument, not a data
# argument: any distribution with mean/max in this range predicts the
# same verdict, and determinism keeps the golden matrix stable.
_SAMPLE_TOKEN_LENGTHS = (18, 24, 30, 34, 38, 42, 48, 56)
_PAD_WASTE_THRESHOLD = 0.5


def embedder_pass(
    view: GraphView, result: AnalysisResult, *, workers: int = 1
) -> None:
    """PWT401: embedder configs whose max_batch_size / bucket shape force
    most MXU cycles onto pad tokens. Embedder UDFs carry a `_pw_embedder`
    marker dict (xpacks/llm/embedders.py) with the shape facts, so the
    pass never builds a model."""
    from pathway_tpu_torch.models.tokenizer import predict_pad_waste

    for table, op, sites in view.apply_sites():
        if op.synthetic:
            continue
        for node in sites:
            marker = getattr(node._fun, "_pw_embedder", None)
            if not isinstance(marker, dict):
                continue
            batch = int(marker.get("max_batch_size") or 0)
            max_len = int(marker.get("max_len") or 512)
            if batch <= 0:
                continue
            waste = predict_pad_waste(
                _SAMPLE_TOKEN_LENGTHS, batch, max_len=max_len
            )
            if waste <= _PAD_WASTE_THRESHOLD:
                continue
            fname = getattr(node._fun, "__name__", "<udf>")
            result.add(make_diag(
                "PWT401",
                f"embedder {fname!r} with max_batch_size={batch} "
                f"predicts {round(100 * waste)}% padding waste on "
                "sampled input lengths: the batch buckets to a power "
                "of two (minimum 8) and every doc pads to the bucket "
                "max, so most MXU cycles process pad tokens; raise "
                "max_batch_size or keep packed ragged batching on "
                "(PATHWAY_PACK_TOKEN_BUDGET > 0 with the default "
                "PATHWAY_DEVICE_PIPELINE=1)",
                trace=_trace_or_none(table),
                operator=view.op_label(table),
                udf=fname,
                predicted_waste=round(waste, 3),
                max_batch_size=batch,
            ))


# ---------------------------------------------------------------------------
# Plan verification (PWT399)
# ---------------------------------------------------------------------------

# engine node class name -> (op kind, selected path)
_NODE_PATHS = {
    "VectorJoinNode": ("join", "columnar"),
    "JoinNode": ("join", "classic"),
    "VectorReduceNode": ("reduce", "columnar"),
    "ReduceNode": ("reduce", "classic"),
    "VectorFlattenNode": ("flatten", "columnar"),
    "FlattenNode": ("flatten", "classic"),
}


def verify_against_plan(engine: Any, result: AnalysisResult) -> None:
    """Compare the analyzer's anchored columnar predictions against the
    node classes the build actually instantiated.  Counts (not per-node
    identity) — parse-level ops and engine nodes have no shared id, but
    every anchored join/reduce/flatten op builds exactly one node, so the
    histograms must agree."""
    predicted: Dict[tuple, int] = {}
    for p in result.predictions:
        if not p.get("anchored"):
            continue
        key = (p["op"], p["predicted"])
        predicted[key] = predicted.get(key, 0) + 1
    actual: Dict[tuple, int] = {}
    for node in getattr(engine, "nodes", ()):
        hit = _NODE_PATHS.get(type(node).__name__)
        if hit is not None:
            actual[hit] = actual.get(hit, 0) + 1
    for key in sorted(set(predicted) | set(actual)):
        if predicted.get(key, 0) != actual.get(key, 0):
            op_kind, path = key
            result.add(make_diag(
                "PWT399",
                f"analyzer predicted {predicted.get(key, 0)} {path} "
                f"{op_kind} node(s) but the built plan has "
                f"{actual.get(key, 0)} — the static gate and the build "
                "gate have drifted; please report this",
                operator=f"{op_kind}/{path}",
                predicted=predicted.get(key, 0),
                actual=actual.get(key, 0),
            ))


# ---------------------------------------------------------------------------
# Pass 7 — chain-level fusion planning (PWT501..PWT504)
# ---------------------------------------------------------------------------

def fusion_pass(view: GraphView, result: AnalysisResult) -> None:
    """Plan maximal fusable select/filter chains and attach the
    serialized FusionPlan to the result (analysis/fusion.py holds the
    walk; the build step runs the same planner, which is what makes the
    PWT599 cross-check meaningful).  Chain findings are informational:
    PWT501 says a chain will build as one fused node, PWT502/503 say why
    it stops where it does, PWT504 marks the ops a UDF keeps out."""
    from pathway_tpu_torch.analysis.diagnostics import _trace_to_dict
    from pathway_tpu_torch.analysis.fusion import plan_fusion

    plan = plan_fusion(view)
    result.fusion = plan  # serialized lazily on first read
    for chain in plan.chains:
        tail = chain.tables[-1]
        trace = _trace_to_dict(_trace_or_none(tail))
        operator = view.op_label(tail)
        shape = " -> ".join(chain.kinds)
        result.add(make_diag(
            "PWT501",
            f"fusable chain of {len(chain)} row-wise ops ({shape}) "
            "collapses into one fused interpreter node: no intermediate "
            "materialization or per-stage consolidation",
            trace=trace, operator=operator,
            chain=chain.chain_id(), length=len(chain),
            kinds=list(chain.kinds),
        ))
        if chain.break_reason == "kind":
            result.add(make_diag(
                "PWT502",
                f"fusion chain ({shape}) stops at a non-fusable "
                f"{chain.break_info} consumer: that operator keeps keyed "
                "state and must see materialized rows",
                trace=trace, operator=operator,
                chain=chain.chain_id(), consumer=str(chain.break_info),
            ))
        elif chain.break_reason == "fanout":
            result.add(make_diag(
                "PWT503",
                f"fusion chain ({shape}) stops at fan-out: "
                f"{chain.break_info} consumers read the chain tail, so "
                "its rows must materialize once instead of being "
                "recomputed per consumer",
                trace=trace, operator=operator,
                chain=chain.chain_id(), consumers=chain.break_info,
            ))
    for table, name, why in plan.barrier_sites:
        op = table._op
        result.add(make_diag(
            "PWT504",
            f"{why} UDF {name!r} keeps this {op.kind} out of any fused "
            "chain: its outputs must materialize per stage so "
            "retractions can cancel the original insertions",
            trace=_trace_or_none(table),
            operator=view.op_label(table),
            udf=name, why=why,
        ))


# ---------------------------------------------------------------------------
# Pass 8 — mesh compatibility (PWT402..PWT405)
# ---------------------------------------------------------------------------

# reducers whose merge depends on arrival order across shards: sharding
# the groupby over dp devices makes their output depend on the shard
# interleaving (internals/reducers.py sorts entries per worker, but a
# cross-shard merge has no shared (time, seq) order)
_ORDER_SENSITIVE_REDUCERS = {"tuple", "earliest", "latest"}


def mesh_pass(
    view: GraphView, result: AnalysisResult, *, mesh, workers: int = 1
) -> None:
    """Lint graphs that cannot shard onto the proposed device mesh.

    Runs only when a mesh spec is given (pw.run(mesh=...) or
    `analyze --mesh dp=4,tp=2`).  Everything here is provable from the
    recorded graph + the spec: no devices are touched."""
    if mesh is None:
        return
    dp, tp = mesh.dp, mesh.tp

    # PWT402 — embedder output shapes vs the proposed axes.  Embedder
    # UDFs carry a `_pw_embedder` marker (xpacks/llm/embedders.py) with
    # the model's dimension; minilm's encode path additionally buckets
    # the batch axis to a power of two, so a non-pow2 dp count never
    # divides the batch evenly (models/minilm.py raises at build time —
    # this is the fail-fast twin of that check).
    for table, op, sites in view.apply_sites():
        if not view.is_anchored(table):
            continue
        for node in sites:
            marker = getattr(node._fun, "_pw_embedder", None)
            if not isinstance(marker, dict):
                continue
            fname = getattr(node._fun, "__name__", "<udf>")
            trace = _trace_or_none(table)
            operator = view.op_label(table)
            dim = int(marker.get("dimension") or 0)
            if tp > 1 and dim and dim % tp:
                result.add(make_diag(
                    "PWT402",
                    f"embedder {fname!r} produces {dim}-dim vectors, "
                    f"which a tp={tp} axis cannot shard evenly "
                    f"({dim} % {tp} != 0): pick a tp that divides "
                    "the hidden dimension",
                    trace=trace, operator=operator,
                    udf=fname, dimension=dim, tp=tp,
                ))
            if dp > 1 and dp & (dp - 1):
                # wording mirrors models/minilm.py SentenceEncoder's
                # build-time ValueError (this lint is its fail-fast twin)
                result.add(make_diag(
                    "PWT402",
                    f"embedder {fname!r}: encode_batch buckets every "
                    f"batch to a power of two (minimum 8), so a "
                    f"dp={dp} axis would never divide the batch axis "
                    "evenly. Use a power-of-two dp device count, or "
                    "drop the mesh and run the single-device async "
                    "pipeline (PATHWAY_DEVICE_PIPELINE=1, the "
                    "default); models/minilm.py enforces the same "
                    "rule at encoder build time",
                    trace=trace, operator=operator,
                    udf=fname, dp=dp,
                ))

    # PWT403 — order-sensitive / opaque custom reducers under a sharded
    # groupby: per-shard partials have no shared order to merge by
    if dp > 1:
        for table, op in view.anchored_by_kind.get("reduce", ()):
            if op.synthetic:
                continue
            for rexpr in op.exprs.get("reducers", ()):
                red = getattr(rexpr, "_reducer", None)
                rname = getattr(red, "name", None)
                if not rname:
                    continue
                if rname in _ORDER_SENSITIVE_REDUCERS:
                    detail = (
                        "its result depends on cross-shard arrival order"
                    )
                elif rname.startswith(("udf_", "stateful_")):
                    detail = (
                        "custom accumulators carry no mergeable partial "
                        "state across shards"
                    )
                else:
                    continue
                result.add(make_diag(
                    "PWT403",
                    f"reducer {rname!r} cannot shard over dp={dp}: "
                    + detail
                    + "; keep the groupby on one shard or use an "
                    "associative built-in",
                    trace=_trace_or_none(table),
                    operator=view.op_label(table),
                    reducer=rname, dp=dp,
                ))

    # PWT404 — exchange shard codes vs device axes: the exchange layer
    # routes by ref_scalar hash over `workers` (engine/value.py
    # SHARD_BITS), so when the worker count does not tile the dp axis,
    # rows land on devices that do not own the corresponding model shard
    if dp > 1 and workers % dp != 0:
        n_exchange = sum(
            len(view.anchored_by_kind.get(k, ()))
            for k in sorted(_EXCHANGE_KINDS)
        )
        if n_exchange:
            result.add(make_diag(
                "PWT404",
                f"{n_exchange} exchange-crossing op(s) route rows over "
                f"{workers} worker(s), which does not tile the dp={dp} "
                "device axis: shard codes and device placement disagree, "
                "so every mismatched row pays a cross-device hop; run "
                "with workers as a multiple of dp",
                operator="exchange/mesh",
                exchange_ops=n_exchange, workers=workers, dp=dp,
            ))

    # PWT405 — single-worker-pinned sources starve a multi-device mesh:
    # exclusive connectors (pw.io.python.read) ingest on one worker only.
    # parse_graph.pending_sources sees descriptors before build-time
    # registration; only sink-anchored ones matter (dead sources are
    # PWT110's business).
    if mesh.devices() > 1:
        # same union as parse_graph.pending_sources, but over the view's
        # already-collected descriptor tables (no weakref re-walk):
        # registered sources first, then connector tables' descriptors
        tables_by_source: Dict[int, Any] = {}
        pending: List[Any] = list(view.graph.sources)
        seen_src: Set[int] = {id(s) for s in pending}
        for live, t in view.live_source_tables:
            tables_by_source[id(live)] = t
            if id(live) not in seen_src:
                seen_src.add(id(live))
                pending.append(live)
        for live in pending:
            if not getattr(live, "exclusive", False):
                continue
            table = tables_by_source.get(id(live))
            if table is None or not view.is_anchored(table):
                continue
            sname = getattr(live, "name", None) or type(live).__name__
            result.add(make_diag(
                "PWT405",
                f"source {sname!r} is pinned to a single worker but the "
                f"mesh has {mesh.devices()} devices ({mesh.describe()}): "
                "ingest serializes on one device while the rest idle; "
                "use a partitioned connector or shard the input upstream",
                trace=_trace_or_none(table),
                operator=view.op_label(table),
                source=sname, devices=mesh.devices(),
            ))


# ---------------------------------------------------------------------------
# Fusion plan verification (PWT599)
# ---------------------------------------------------------------------------

def verify_fusion(engine: Any, result: AnalysisResult) -> None:
    """Compare the FusionPlan the build consumed (engine.fusion_plan,
    installed by internals/runner.py before any node was built) against
    the fused nodes it actually instantiated (engine.fused_chains).
    Chains are identified by their op_id tuples, so a dropped chain, a
    phantom fused node, or a stage-count mismatch each become a hard
    PWT599 — the fusion twin of PWT399."""
    plan = getattr(engine, "fusion_plan", None)
    if not plan or not plan.get("enabled"):
        return  # fusion off at build time: nothing was promised
    planned: Dict[tuple, Dict[str, Any]] = {
        tuple(c["op_ids"]): c for c in plan.get("chains", ())
    }
    built: Dict[tuple, Any] = {
        tuple(getattr(n, "op_ids", ())): n
        for n in getattr(engine, "fused_chains", ())
    }
    for key in sorted(set(planned) | set(built)):
        c = planned.get(key)
        node = built.get(key)
        if c is not None and node is None:
            result.add(make_diag(
                "PWT599",
                f"planned fused chain of {c['length']} ops "
                f"({' -> '.join(c['kinds'])}) was not built as a fused "
                "node — the fusion planner and the build have drifted; "
                "please report this",
                operator=f"fused_chain#{c['id']}",
                chain=c["id"], planned=c["length"], built=0,
            ))
        elif c is None and node is not None:
            result.add(make_diag(
                "PWT599",
                f"a fused node over {len(node.op_ids)} ops was built "
                "without a matching planned chain — the fusion planner "
                "and the build have drifted; please report this",
                operator="fused_chain#" + "-".join(
                    str(i) for i in node.op_ids
                ),
                planned=0, built=len(node.op_ids),
            ))
        elif len(node.stages) != c["length"]:
            result.add(make_diag(
                "PWT599",
                f"fused chain {c['id']} was planned with {c['length']} "
                f"stages but built with {len(node.stages)} — the fusion "
                "planner and the build have drifted; please report this",
                operator=f"fused_chain#{c['id']}",
                chain=c["id"], planned=c["length"],
                built=len(node.stages),
            ))
