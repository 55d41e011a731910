"""PWT7xx — serving-tier lints (internals/serving.py).

The serving micro-batcher only pays off when a coalesced query batch
actually collapses into one fused device program, and its batch window
only makes sense when it is small against the latency budget.  Both are
knowable at BUILD time:

  * PWT701 — serving is enabled but an anchored external index has no
    encoder config: queries reach the index as raw vectors/text with no
    `FusedEmbedSearch` path, so a coalesced batch still costs a
    per-query host loop instead of one jit — the batcher adds latency
    (the window) without buying dispatch fusion.
  * PWT702 — the serving batch window (`PATHWAY_SERVE_BATCH_WINDOW_MS`)
    is larger than the declared p99 SLO target (`pw.run(slo=...)` /
    `PATHWAY_SLO_P99_MS`): every query waits up to the window before the
    engine even sees it, so the SLO is unmeetable by configuration.
"""

from __future__ import annotations

from typing import Any, Optional

from pathway_tpu_torch.analysis.diagnostics import AnalysisResult, make_diag


def _trace_or_none(table: Any):
    return getattr(table, "_trace", None)


def serving_pass(
    view: Any, result: AnalysisResult, *, slo: Optional[float] = None
) -> None:
    """PWT701/PWT702 over the anchored external-index ops.  Runs only
    when the serving tier is enabled and armed (a non-zero batch window);
    `slo` is the p99 target in milliseconds threaded from pw.run(slo=)
    with PATHWAY_SLO_P99_MS as the CLI-path fallback."""
    import os

    from pathway_tpu_torch.internals import serving

    if not serving.ENABLED:
        return
    indexes = view.anchored_by_kind.get("external_index", ())
    if not indexes:
        return
    window_ms = serving.batch_window_ms()
    if window_ms <= 0:
        return

    for table, op in indexes:
        enc = op.info.get("encoder")
        if not isinstance(enc, dict):
            result.add(make_diag(
                "PWT701",
                "serving micro-batching is enabled but this external "
                "index has no encoder config, so a coalesced query batch "
                "cannot run as one fused embed+search program (ops/knn."
                "FusedEmbedSearch) — the batch window adds up to "
                f"{window_ms:g} ms of queueing without buying dispatch "
                "fusion; use an embedder-backed index factory or set "
                "PATHWAY_SERVE_BATCH_WINDOW_MS=0 for this job",
                trace=_trace_or_none(table),
                operator=view.op_label(table),
                batch_window_ms=window_ms,
                index=str(op.info.get("index") or ""),
            ))

    if slo is None:
        env_slo = os.environ.get("PATHWAY_SLO_P99_MS")
        if env_slo:
            try:
                slo = float(env_slo)
            except ValueError:
                slo = None
    if slo is not None and window_ms > float(slo):
        table, op = indexes[0]
        result.add(make_diag(
            "PWT702",
            f"serving batch window {window_ms:g} ms exceeds the declared "
            f"p99 SLO target {float(slo):g} ms: every query waits up to "
            "the full window before the engine sees it, so the target is "
            "unmeetable by configuration; shrink "
            "PATHWAY_SERVE_BATCH_WINDOW_MS well below the SLO (the "
            "size trigger PATHWAY_SERVE_MAX_BATCH still coalesces "
            "bursts)",
            trace=_trace_or_none(table),
            operator=view.op_label(table),
            batch_window_ms=window_ms,
            slo_p99_ms=float(slo),
        ))
