"""Diagnostic baselines: adopt strict analysis on an existing graph.

`pathway-tpu-torch analyze --baseline findings.json` (and
`pw.run(analysis_baseline=...)`) snapshots the current findings on the
first run, then suppresses exact matches on later runs — `--fail-on` and
strict mode only see NEW findings.  The baseline file is the reviewable
artifact: full finding dicts under a schema_version stamp, so a
teammate can read exactly what was grandfathered in.

A finding matches the baseline when (code, message, location) agree;
location is the user trace file:line when present, else the operator
label.  Message text participates on purpose — a finding whose numbers
changed (e.g. predicted pad waste) is news, not noise.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Set, Tuple

from pathway_tpu_torch.analysis.diagnostics import (
    SCHEMA_VERSION,
    AnalysisResult,
    Diagnostic,
)


def finding_key(f: Diagnostic) -> Tuple[str, str, str]:
    trace = f.trace or {}
    if trace.get("file"):
        loc = f"{trace['file']}:{trace.get('line')}"
    else:
        loc = f.operator or ""
    return (f.code, f.message, loc)


def write_baseline(path: str, result: AnalysisResult) -> int:
    payload = {
        "schema_version": SCHEMA_VERSION,
        "findings": [f.to_dict() for f in result.sorted_findings()],
    }
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return len(result.findings)


def load_baseline(path: str) -> Set[Tuple[str, str, str]]:
    with open(path) as fh:
        payload = json.load(fh)
    return {
        finding_key(Diagnostic.from_dict(d))
        for d in payload.get("findings", ())
    }


def apply_baseline(result: AnalysisResult, path: str) -> Dict[str, Any]:
    """Mutate `result` to only hold findings NOT in the baseline at
    `path`; create the baseline from the current findings when the file
    does not exist yet.  Returns a summary dict for reports/JSON."""
    if not os.path.exists(path):
        count = write_baseline(path, result)
        result.findings = []
        return {"file": path, "created": True, "suppressed": count}
    known = load_baseline(path)
    kept = [f for f in result.findings if finding_key(f) not in known]
    suppressed = len(result.findings) - len(kept)
    result.findings = kept
    return {"file": path, "created": False, "suppressed": suppressed}
