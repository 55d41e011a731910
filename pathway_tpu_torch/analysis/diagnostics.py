"""Diagnostic model for the build-time graph analyzer.

Every finding carries a stable code (PWT1xx correctness, PWT2xx
state/robustness, PWT3xx performance), a severity, a human message, and
a location: the user stack frame that built the operator when
`internals/trace.py` found one, otherwise the operator id + graph path —
synthetic/stdlib-built operators still produce findings, they just point
at the graph instead of a user line.

The JSON form (`AnalysisResult.to_dict`/`from_dict`) round-trips exactly
so CI tooling can consume `pathway-tpu-torch analyze --json` output.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class Severity(enum.IntEnum):
    INFO = 10
    WARNING = 20
    ERROR = 30

    def __str__(self) -> str:
        return self.name.lower()

    @classmethod
    def parse(cls, name: str) -> "Severity":
        return cls[name.upper()]


# code -> (default severity, short title).  Codes are append-only: once
# published they keep their meaning, tooling may match on them.
CODES: Dict[str, tuple] = {
    # PWT1xx — correctness
    "PWT101": (Severity.WARNING, "lossy numeric cast"),
    "PWT102": (Severity.ERROR, "comparison between incompatible dtypes"),
    "PWT103": (Severity.WARNING, "arithmetic on optional operand"),
    "PWT110": (Severity.WARNING, "dead subgraph never reaches a sink"),
    "PWT111": (Severity.INFO, "unused column"),
    # PWT2xx — state growth / robustness
    "PWT201": (Severity.WARNING, "temporal operator without behavior"),
    "PWT202": (Severity.WARNING, "groupby key of unbounded cardinality"),
    "PWT203": (Severity.WARNING, "iterate without iteration_limit"),
    # PWT3xx — performance
    "PWT301": (Severity.INFO, "join falls back to the classic path"),
    "PWT302": (Severity.WARNING, "unroutable routing dtype on exchange"),
    "PWT303": (Severity.INFO, "reduce falls back to the classic path"),
    "PWT304": (Severity.INFO, "flatten vector path disabled"),
    "PWT305": (Severity.WARNING, "non-deterministic UDF feeds stateful operator"),
    "PWT306": (Severity.WARNING, "async/blocking UDF on exchange-crossing path"),
    "PWT399": (Severity.ERROR, "analyzer prediction disagrees with built plan"),
    # PWT4xx — accelerator utilization / mesh compatibility
    "PWT401": (Severity.WARNING, "embedder batch shape wastes MXU on padding"),
    "PWT402": (Severity.ERROR, "embedding shape incompatible with mesh axes"),
    "PWT403": (Severity.WARNING, "reducer is not shardable across the mesh"),
    "PWT404": (Severity.WARNING, "exchange sharding disagrees with mesh axes"),
    "PWT405": (Severity.WARNING, "single-worker-pinned source on a mesh"),
    # PWT5xx — fusion planning
    "PWT501": (Severity.INFO, "fusable select/filter chain found"),
    "PWT502": (Severity.INFO, "fusion chain broken by non-fusable operator"),
    "PWT503": (Severity.INFO, "fusion chain broken by fan-out"),
    "PWT504": (Severity.INFO, "UDF barrier blocks chain fusion"),
    "PWT599": (Severity.ERROR, "fusion plan disagrees with built nodes"),
    # PWT6xx — memory / capacity planning
    "PWT601": (Severity.INFO, "predicted device-memory footprint"),
    "PWT602": (Severity.WARNING, "external index without capacity info"),
    "PWT603": (Severity.ERROR, "predicted footprint exceeds device memory"),
    "PWT604": (Severity.WARNING, "predicted HBM headroom below threshold"),
    "PWT605": (Severity.INFO, "encoder params replicated per dp replica"),
    "PWT699": (Severity.ERROR, "capacity plan disagrees with live accounting"),
    # PWT7xx — serving tier (internals/serving.py)
    "PWT701": (Severity.WARNING, "serving enabled over a non-batchable index"),
    "PWT702": (Severity.WARNING, "serving batch window exceeds the SLO target"),
    # PWT8xx — cost attribution (internals/costledger.py)
    "PWT801": (Severity.WARNING, "tenant rate limits armed without query tracing"),
    "PWT802": (Severity.INFO, "cost ledger without a device-capacity entry"),
    # PWT9xx — determinism & replay safety (analysis/purity.py)
    "PWT901": (Severity.WARNING, "UDF reads a nondeterminism source"),
    "PWT902": (Severity.WARNING, "unordered set/dict iteration feeds UDF output"),
    "PWT903": (Severity.WARNING, "replay-unsafe side effect in UDF"),
    "PWT904": (Severity.WARNING, "UDF closure captures unpicklable state"),
    "PWT905": (Severity.WARNING, "UDF mutates its input rows"),
    "PWT999": (Severity.ERROR, "determinism contract disagrees with purity analysis"),
    # PWT10xx — provenance / lineage coverage (analysis/provenance.py)
    "PWT1001": (Severity.WARNING, "lineage-opaque operator on an anchored path"),
    "PWT1099": (Severity.ERROR, "explain required but graph contains an opaque node"),
}

# PWT family prefix -> (family name, owning pass) — the `analyze
# --list-codes` table and the doc-sync guard derive from this instead of
# hand-maintained doc tables.
FAMILIES: Dict[str, tuple] = {
    "PWT1": ("correctness", "dtype_pass / dead_pass"),
    "PWT2": ("state growth", "state_pass"),
    "PWT3": ("performance", "columnar_pass / udf_pass / verify_against_plan"),
    "PWT4": ("mesh compatibility", "mesh_pass / embedder_pass"),
    "PWT5": ("fusion planning", "fusion_pass / verify_fusion"),
    "PWT6": ("capacity planning", "capacity_pass / verify_capacity"),
    "PWT7": ("serving", "serving_pass"),
    "PWT8": ("cost attribution", "cost_pass"),
    "PWT9": ("determinism", "purity_pass / verify_purity"),
    "PWT10": ("provenance", "provenance_pass"),
}

# JSON schema version for analyze --json payloads and the golden matrix.
# Bump when the payload shape changes (v2: schema_version stamp itself,
# deterministic finding order, the "fusion" plan section; v3: the
# "capacity" plan section; v4: the "purity" verdict section).
SCHEMA_VERSION = 4


def _trace_to_dict(trace: Any) -> Optional[Dict[str, Any]]:
    if trace is None:
        return None
    if isinstance(trace, dict):
        # already converted — passes that emit several findings for one
        # operator convert once and share the dict (read-only by
        # convention; Diagnostic.to_dict copies on serialization)
        return trace
    return {
        "file": trace.file,
        "line": trace.line,
        "function": trace.function,
        "line_text": trace.line_text,
    }


@dataclass
class Diagnostic:
    code: str
    message: str
    severity: Severity
    # user frame, as a plain dict (file/line/function/line_text); None for
    # synthetic operators with no user frame
    trace: Optional[Dict[str, Any]] = None
    # always-present fallback location: "kind#op_id" (+ graph path) — the
    # finding is never dropped just because the trace is missing
    operator: Optional[str] = None
    details: Dict[str, Any] = field(default_factory=dict)

    def location(self) -> str:
        if self.trace is not None:
            loc = f"{self.trace['file']}:{self.trace['line']}"
            if self.trace.get("line_text"):
                return f"{loc}: {self.trace['line_text']}"
            return loc
        if self.operator:
            return f"<{self.operator}>"
        return "<unknown>"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "code": self.code,
            "severity": str(self.severity),
            "message": self.message,
            "trace": dict(self.trace) if self.trace is not None else None,
            "operator": self.operator,
            "details": dict(self.details),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Diagnostic":
        return cls(
            code=d["code"],
            message=d["message"],
            severity=Severity.parse(d["severity"]),
            trace=dict(d["trace"]) if d.get("trace") is not None else None,
            operator=d.get("operator"),
            details=dict(d.get("details", {})),
        )


def make_diag(
    code: str,
    message: str,
    *,
    trace: Any = None,
    operator: Optional[str] = None,
    severity: Optional[Severity] = None,
    **details: Any,
) -> Diagnostic:
    default_sev, _title = CODES[code]
    return Diagnostic(
        code=code,
        message=message,
        severity=severity if severity is not None else default_sev,
        trace=_trace_to_dict(trace),
        operator=operator,
        details=details,
    )


def _finding_sort_key(f: Diagnostic) -> tuple:
    """Deterministic order regardless of pass/thread scheduling: (code,
    trace location, operator, message).  Applied before every render and
    serialization so golden-matrix comparisons cannot flake."""
    trace = f.trace or {}
    return (
        f.code,
        trace.get("file") or "",
        trace.get("line") or 0,
        f.operator or "",
        f.message,
    )


@dataclass
class AnalysisResult:
    findings: List[Diagnostic] = field(default_factory=list)
    # columnar-eligibility predictions, one per join/reduce/flatten op:
    # {"op", "op_id", "predicted": "columnar"|"classic", "reasons": [...],
    #  "trace": {...}|None}
    predictions: List[Dict[str, Any]] = field(default_factory=list)
    # FusionPlan section, attached by fusion_pass.  Holds either the
    # serialized dict or the live FusionPlan object (serialized lazily
    # on first read — the common pw.run path never reads it)
    _fusion: Any = field(default=None, repr=False)
    # capacity-plan section (analysis/capacity.py): predicted per-index /
    # per-device byte breakdown; None when the graph has no external index
    capacity: Optional[Dict[str, Any]] = None
    # purity-verdict section (analysis/purity.py): callable name ->
    # {"verdict": "deterministic"|"impure"|"unknown", "codes": [...]};
    # None when the graph has no UDF call sites
    purity: Optional[Dict[str, Any]] = None

    @property
    def fusion(self) -> Optional[Dict[str, Any]]:
        src = self._fusion
        if src is not None and not isinstance(src, dict):
            src = self._fusion = src.to_dict()
        return src

    @fusion.setter
    def fusion(self, value: Any) -> None:
        self._fusion = value

    def add(self, diag: Diagnostic) -> None:
        self.findings.append(diag)

    def sorted_findings(self) -> List[Diagnostic]:
        return sorted(self.findings, key=_finding_sort_key)

    def max_severity(self) -> Optional[Severity]:
        if not self.findings:
            return None
        return max(f.severity for f in self.findings)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[str(f.severity)] = out.get(str(f.severity), 0) + 1
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": SCHEMA_VERSION,
            "findings": [f.to_dict() for f in self.sorted_findings()],
            "predictions": [dict(p) for p in self.predictions],
            "fusion": dict(self.fusion) if self.fusion is not None else None,
            "capacity": (
                dict(self.capacity) if self.capacity is not None else None
            ),
            "purity": (
                dict(self.purity) if self.purity is not None else None
            ),
            "summary": self.counts(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AnalysisResult":
        fusion = d.get("fusion")
        capacity = d.get("capacity")
        purity = d.get("purity")
        return cls(
            findings=[Diagnostic.from_dict(f) for f in d.get("findings", [])],
            predictions=[dict(p) for p in d.get("predictions", [])],
            _fusion=dict(fusion) if fusion is not None else None,
            capacity=dict(capacity) if capacity is not None else None,
            purity=dict(purity) if purity is not None else None,
        )

    def render_text(self) -> str:
        lines: List[str] = []
        order = sorted(
            self.sorted_findings(), key=lambda f: (-int(f.severity), f.code)
        )
        for f in order:
            _sev, title = CODES.get(f.code, (Severity.INFO, ""))
            lines.append(f"{f.severity}: {f.code} [{title}]")
            lines.append(f"  {f.message}")
            lines.append(f"  at {f.location()}")
            for key, value in sorted(f.details.items()):
                lines.append(f"  {key}: {value}")
        counts = self.counts()
        if counts:
            summary = ", ".join(
                f"{counts[k]} {k}" for k in ("error", "warning", "info")
                if k in counts
            )
            lines.append(f"{len(self.findings)} finding(s): {summary}")
        else:
            lines.append("no findings")
        return "\n".join(lines)
