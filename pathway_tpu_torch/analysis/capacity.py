"""PWT6xx — capacity planning: predicted device-memory footprint.

Knowing at BUILD time whether a graph's device-resident state fits the
card. This pass predicts the footprint of every anchored external index
from the recorded OpSpec graph + MeshSpec — no devices touched — using
exactly the allocation rules the port's runtime applies:

  * index slab: `ops/knn.DeviceKnnIndex` allocates `index_rows` rows
    (the next power of two of max(reserved_space, 2*dp), at least 8) of
    `index_row_bytes(dimensions)` bytes: float32 rows zero-padded to a
    multiple of 4 columns, plus a bool valid flag. The rows and the width
    come from ops/knn.py itself, one source for the allocator and this
    prediction. (The JAX package's slab has no padded columns, so at a
    width that is not a multiple of 4 its prediction is smaller.)
  * encoder params: `internals/costmodel.encoder_param_count` — the
    analytic twin of models/transformer.init_params — at float32,
    tp-sharded within a replica but replicated per dp replica (PWT605);
  * pipeline in-flight slabs: window(2) x token-budget packed arrays
    (informational only — transient, excluded from the parity gate).

Predictions are judged against `memtrack.hbm_capacity_bytes()` — the
same resolution order the live forecaster uses (PATHWAY_ASSUME_HBM_BYTES
-> the card's total memory -> costmodel table), so the analyzer and the
runtime can never disagree about how big the card is.

`verify_capacity` is the PWT699 parity gate mirroring PWT399/PWT599:
after the engine builds (live DeviceKnnIndex + encoder params registered
in internals/memtrack.py), the predicted component bytes must match the
live accounting within CAPACITY_PARITY_TOLERANCE — drift means the
predictor and the allocator have diverged, which would silently invalidate
every capacity plan.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from pathway_tpu_torch.analysis.diagnostics import AnalysisResult, make_diag

# Relative drift beyond which PWT699 fires (both components are exact
# formulas today; the tolerance absorbs future dtype/layout tweaks).
CAPACITY_PARITY_TOLERANCE = 0.10

# Device-pipeline in-flight window (internals/device_pipeline.py keeps
# two slabs resident: one executing, one queued).
_INFLIGHT_WINDOW = 2


def _trace_or_none(table: Any):
    return getattr(table, "_trace", None)


def _mib(b: float) -> str:
    return f"{b / 2**20:.1f} MiB"


def predict_index_bytes(
    dimensions: int, reserved_space: int, dp: int = 1
) -> Dict[str, int]:
    """The DeviceKnnIndex allocation, predicted: bucketed capacity rows
    and the padded float32-buffer + bool-valid byte count."""
    from pathway_tpu_torch.ops.knn import index_row_bytes, index_rows

    min_cap = 8
    if dp > 1:
        min_cap = max(min_cap, 2 * dp)
    rows = index_rows(max(int(reserved_space), min_cap))
    return {"rows": rows, "bytes": rows * index_row_bytes(dimensions)}


def _pipeline_inflight_bytes() -> int:
    """Transient packed-slab bytes while the async pipeline runs: the
    in-flight window x (ids + seg) int32 arrays at the token budget."""
    from pathway_tpu_torch.models.tokenizer import pack_token_budget

    budget = pack_token_budget()
    if budget <= 0:
        return 0
    return _INFLIGHT_WINDOW * budget * 2 * 4


def capacity_pass(
    view: Any, result: AnalysisResult, *, mesh=None, workers: int = 1
) -> None:
    """PWT601..PWT605 over the anchored external-index ops (recorded by
    stdlib/indexing/data_index.DataIndex).  Attaches the full byte
    breakdown as ``result.capacity`` so /status, the CLI JSON, and
    verify_capacity all read one structure."""
    indexes = view.anchored_by_kind.get("external_index", ())
    if not indexes:
        return
    from pathway_tpu_torch.internals import costmodel, memtrack

    dp = mesh.dp if mesh is not None else 1
    tp = mesh.tp if mesh is not None else 1
    cap = memtrack.hbm_capacity_bytes()
    inflight = _pipeline_inflight_bytes()
    rows_out: List[Dict[str, Any]] = []
    per_device_total = float(inflight)

    for table, op in indexes:
        info = op.info
        label = view.op_label(table)
        trace = _trace_or_none(table)
        dim = int(info.get("dimensions") or 0)
        if dim <= 0:
            result.add(make_diag(
                "PWT602",
                f"external index {info.get('index') or 'factory'!s} "
                "exposes no embedding dimension, so its device-memory "
                "footprint cannot be predicted: pass dimensions= (and "
                "reserved_space=) to the index factory so the capacity "
                "plan covers it",
                trace=trace, operator=label,
                index=str(info.get("index") or ""),
            ))
            rows_out.append({
                "op_id": op.op_id,
                "index": str(info.get("index") or ""),
                "dimensions": None,
                "index_bytes": None,
                "param_bytes": None,
            })
            continue
        reserved = int(info.get("reserved_space") or 512)
        pred = predict_index_bytes(dim, reserved, dp)
        enc = info.get("encoder")
        param_bytes = 0
        if isinstance(enc, dict):
            param_bytes = 4 * costmodel.encoder_param_count(
                vocab_size=int(enc.get("vocab_size", 30522)),
                hidden=int(enc.get("hidden", dim)),
                layers=int(enc.get("layers", 6)),
                mlp_dim=int(enc.get("mlp_dim", 4 * dim)),
                max_len=int(enc.get("max_len", 512)),
            )
        # placement: index rows shard over dp; matmul params shard over
        # tp within a replica and replicate across dp replicas
        per_device = pred["bytes"] / dp + param_bytes / tp
        per_replica = pred["bytes"] / dp + param_bytes
        per_device_total += per_device
        rows_out.append({
            "op_id": op.op_id,
            "index": str(info.get("index") or ""),
            "dimensions": dim,
            "reserved_space": reserved,
            "predicted_rows": pred["rows"],
            "index_bytes": pred["bytes"],
            "param_bytes": param_bytes,
            "per_device_bytes": per_device,
            "per_replica_bytes": per_replica,
        })
        result.add(make_diag(
            "PWT601",
            f"external index predicts {_mib(pred['bytes'])} of index "
            f"slab ({pred['rows']} bucketed rows x "
            f"{pred['bytes'] // pred['rows']} bytes "
            f"at d={dim})"
            + (
                f" + {_mib(param_bytes)} of encoder params"
                if param_bytes else ""
            )
            + f"; per device that is {_mib(per_device)}"
            + (f" under dp={dp},tp={tp}" if mesh is not None else ""),
            trace=trace, operator=label,
            index_bytes=pred["bytes"], param_bytes=param_bytes,
            per_device_bytes=round(per_device),
            predicted_rows=pred["rows"], dimensions=dim,
        ))
        if dp > 1 and param_bytes:
            result.add(make_diag(
                "PWT605",
                f"encoder params ({_mib(param_bytes)}) replicate per dp "
                f"replica: dp={dp} holds {dp} copies "
                f"({_mib(dp * param_bytes)} across the mesh); budget "
                "them per replica, not once",
                trace=trace, operator=label,
                param_bytes=param_bytes, dp=dp,
            ))
        if cap is not None and per_device > cap:
            result.add(make_diag(
                "PWT603",
                f"predicted per-device footprint {_mib(per_device)} "
                f"exceeds device HBM capacity {_mib(cap)}: the index "
                "will OOM before reserved_space fills; shrink "
                "reserved_space, widen dp, or move to a tiered index",
                trace=trace, operator=label,
                per_device_bytes=round(per_device),
                hbm_capacity_bytes=round(cap),
            ))

    headroom = cap - per_device_total if cap is not None else None
    if (
        cap
        and headroom is not None
        and headroom > 0
        and 100.0 * headroom / cap < memtrack.HEADROOM_WARN_PCT
    ):
        result.add(make_diag(
            "PWT604",
            f"predicted per-device usage {_mib(per_device_total)} "
            f"leaves {_mib(headroom)} of {_mib(cap)} HBM "
            f"({100.0 * headroom / cap:.1f}% — below the "
            f"{memtrack.HEADROOM_WARN_PCT:g}% warning threshold): "
            "ingest growth or a compile-time doubling will tip this "
            "over; plan capacity now",
            operator="capacity/headroom",
            per_device_bytes=round(per_device_total),
            headroom_bytes=round(headroom),
        ))
    result.capacity = {
        "mesh": mesh.describe() if mesh is not None else None,
        "hbm_capacity_bytes": cap,
        "indexes": rows_out,
        "pipeline_inflight_bytes": inflight,
        "per_device_bytes": per_device_total,
        "headroom_bytes": headroom,
    }


def verify_capacity(engine: Any, result: AnalysisResult) -> None:
    """PWT699 — predicted-vs-live parity, the capacity twin of
    PWT399/PWT599.  Runs after the engine built its sinks (so every
    DeviceKnnIndex / encoder-param copy is registered live in
    internals/memtrack.py) and compares component byte sums.  Skips when
    memtrack is disabled, nothing was predicted, or the live entry count
    does not match the prediction count (another engine's registrations
    are still alive in this process — a sum comparison would be
    meaningless, and guessing is worse than silence)."""
    from pathway_tpu_torch.internals import memtrack

    if not memtrack.ENABLED:
        return
    section = result.capacity if hasattr(result, "capacity") else None
    if not section:
        return
    predicted = [
        r for r in section["indexes"] if r.get("index_bytes")
    ]
    if not predicted:
        return
    tracker = memtrack.tracker()
    checks = [
        (
            "knn_index",
            sum(r["index_bytes"] for r in predicted),
            tracker.entries("knn_index"),
            len(predicted),
        ),
        (
            "encoder_params",
            sum(r.get("param_bytes") or 0 for r in predicted),
            tracker.entries("encoder_params"),
            len([r for r in predicted if r.get("param_bytes")]),
        ),
    ]
    for component, pred_bytes, live_entries, expected_n in checks:
        if not pred_bytes or len(live_entries) != expected_n:
            continue
        live_bytes = sum(e["nbytes"] for e in live_entries)
        if not live_bytes:
            continue
        drift = abs(pred_bytes - live_bytes) / live_bytes
        if drift > CAPACITY_PARITY_TOLERANCE:
            result.add(make_diag(
                "PWT699",
                f"capacity plan predicted {_mib(pred_bytes)} of "
                f"{component} but live accounting holds "
                f"{_mib(live_bytes)} ({100 * drift:.1f}% drift > "
                f"{100 * CAPACITY_PARITY_TOLERANCE:.0f}%) — the "
                "predictor and the allocator have diverged; please "
                "report this",
                operator=f"capacity/{component}",
                predicted_bytes=round(pred_bytes),
                live_bytes=round(live_bytes),
                drift_pct=round(100 * drift, 2),
            ))
