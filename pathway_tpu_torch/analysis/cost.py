"""PWT8xx — cost-attribution lints (internals/costledger.py).

The cost ledger's attribution quality depends on configuration that is
knowable at BUILD time:

  * PWT801 — the admission controller is armed with per-tenant rate
    limits (``PATHWAY_SERVE_TENANT_RATE`` > 0) while query tracing is
    disabled (``PATHWAY_QTRACE=0``).  The tenant resolved from
    ``X-Tenant`` dies at the token bucket: no span carries it into the
    batched dispatch, so every shed decision and every device-second a
    tenant spends is unattributable — the ledger charges the whole serve
    workload to the ``""`` bucket and per-tenant limits cannot be
    audited against per-tenant cost.
  * PWT802 — the cost ledger is enabled but the attached device has no
    peak-FLOPs entry in the chip table (internals/costmodel.py — CPU CI,
    new chip generations).  Attribution still works, but every derived
    efficiency gauge (``pathway_cost_efficiency_pct``) reports None;
    stated as a finding so the gap is visible instead of a silently
    absent metric.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.analysis.diagnostics import AnalysisResult, make_diag


def _trace_or_none(table: Any):
    return getattr(table, "_trace", None)


def cost_pass(view: Any, result: AnalysisResult) -> None:
    """PWT801/PWT802 over the anchored external-index ops — the ops the
    serve workload's device time flows through.  Runs only when a graph
    actually serves (an anchored external index exists)."""
    from pathway_tpu_torch.internals import costledger, costmodel, qtrace, serving

    indexes = view.anchored_by_kind.get("external_index", ())
    if not indexes:
        return
    table, op = indexes[0]

    if (
        serving.ENABLED
        and serving.tenant_rate() > 0
        and not qtrace.ENABLED
    ):
        result.add(make_diag(
            "PWT801",
            "per-tenant admission rate limits are armed "
            f"(PATHWAY_SERVE_TENANT_RATE={serving.tenant_rate():g}/s) but "
            "query tracing is disabled (PATHWAY_QTRACE=0): the resolved "
            "X-Tenant dies at the token bucket instead of riding the "
            "query span into the batched dispatch, so shed decisions and "
            "per-tenant device cost are unattributable — the ledger "
            "charges all serve time to the \"\" tenant; re-enable "
            "PATHWAY_QTRACE or drop the tenant limits",
            trace=_trace_or_none(table),
            operator=view.op_label(table),
            tenant_rate_per_s=serving.tenant_rate(),
        ))

    if costledger.ENABLED and not costmodel.device_capacity_known():
        result.add(make_diag(
            "PWT802",
            "the cost ledger is enabled but the attached device "
            f"('{costmodel.device_name()}') has no peak-FLOPs entry in "
            "the chip table (internals/costmodel.py): attribution works, "
            "but every derived efficiency gauge "
            "(pathway_cost_efficiency_pct, MFU-style ratios) will report "
            "None; add the chip to DEVICE_PEAK_BF16_FLOPS or expect "
            "absent efficiency series",
            trace=_trace_or_none(table),
            operator=view.op_label(table),
            device=costmodel.device_name(),
        ))
