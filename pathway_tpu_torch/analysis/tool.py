"""`pathway-tpu-torch analyze` implementation: load a user script, intercept
pw.run, analyze the graph it built.

The script is executed for its graph-building side effects only —
`runner.run`/`run_all` are patched to record that they were called (and
with what) instead of starting the engine, so analysis stays cheap and
side-effect-free even for streaming jobs.  Exit codes: 0 clean, 1
findings at or above --fail-on, 2 the script itself failed to load.
"""

from __future__ import annotations

import json
import runpy
import sys
from typing import List, Optional

from pathway_tpu_torch.analysis import AnalysisResult, Severity, analyze


def analyze_script(path: str, *, mesh=None) -> AnalysisResult:
    """Execute `path` with pw.run patched out, then analyze the graph it
    registered on the global parse graph."""
    from pathway_tpu_torch.internals import runner
    from pathway_tpu_torch.internals.parse_graph import G

    G.clear()
    calls: List[dict] = []

    def _capture_run(**kwargs):
        calls.append(kwargs)

    real_run, real_run_all = runner.run, runner.run_all
    # patch both the module and the package re-export: scripts call
    # pw.run, which resolved at import time
    import pathway_tpu_torch as pw

    pw_run, pw_run_all = pw.run, pw.run_all
    runner.run = _capture_run
    runner.run_all = _capture_run
    pw.run = _capture_run
    pw.run_all = _capture_run
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        runner.run, runner.run_all = real_run, real_run_all
        pw.run, pw.run_all = pw_run, pw_run_all
    return analyze(G, mesh=mesh)


def list_codes(*, as_json: bool = False) -> str:
    """`analyze --list-codes`: render the diagnostics registry — every
    PWT code with its default severity, title and owning pass family —
    from diagnostics.CODES/FAMILIES, so docs and users never
    hand-maintain the table."""
    from pathway_tpu_torch.analysis.diagnostics import CODES, FAMILIES

    def family_of(code: str):
        # the family prefix is everything but the two code digits —
        # "PWT101" -> "PWT1", "PWT1001" -> "PWT10" (a fixed [:4] slice
        # would misfile the four-digit families under PWT1)
        return FAMILIES.get(code[:-2], ("", ""))

    if as_json:
        payload = {
            "codes": [
                {
                    "code": code,
                    "severity": str(sev),
                    "title": title,
                    "family": family_of(code)[0],
                    "pass": family_of(code)[1],
                }
                for code, (sev, title) in sorted(CODES.items())
            ],
            "families": {
                prefix: {"family": fam, "pass": owner}
                for prefix, (fam, owner) in sorted(FAMILIES.items())
            },
        }
        return json.dumps(payload, indent=2, sort_keys=True)
    lines: List[str] = []
    last_prefix = None
    for code, (sev, title) in sorted(CODES.items()):
        prefix = code[:-2]
        if prefix != last_prefix:
            fam, owner = family_of(code)
            lines.append(f"{prefix}xx — {fam} ({owner})")
            last_prefix = prefix
        lines.append(f"  {code}  {str(sev):7s}  {title}")
    lines.append(f"{len(CODES)} registered code(s)")
    return "\n".join(lines)


def main_analyze(args) -> int:
    """Entry point for the cli.py `analyze` subcommand."""
    if getattr(args, "list_codes", False):
        print(list_codes(as_json=bool(args.json)))
        return 0
    if not getattr(args, "script", None):
        print(
            "error: a script argument is required unless --list-codes "
            "is given",
            file=sys.stderr,
        )
        return 2
    mesh = getattr(args, "mesh", None)
    if mesh is not None:
        from pathway_tpu_torch.analysis.mesh import MeshSpec

        try:
            mesh = MeshSpec.parse(mesh)
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
    try:
        result = analyze_script(args.script, mesh=mesh)
    except SystemExit as exc:  # script called sys.exit()
        code = exc.code if isinstance(exc.code, int) else 1
        if code != 0:
            print(
                f"error: {args.script} exited with {code} during graph "
                "build",
                file=sys.stderr,
            )
            return 2
        from pathway_tpu_torch.internals.parse_graph import G

        result = analyze(G, mesh=mesh)
    except Exception as exc:  # noqa: BLE001 — report, don't traceback
        print(f"error: failed to load {args.script}: {exc}", file=sys.stderr)
        return 2

    baseline_info = None
    if getattr(args, "baseline", None):
        from pathway_tpu_torch.analysis.baseline import apply_baseline

        try:
            baseline_info = apply_baseline(result, args.baseline)
        except (OSError, ValueError, KeyError) as exc:
            print(
                f"error: unusable baseline {args.baseline}: {exc}",
                file=sys.stderr,
            )
            return 2
        if baseline_info["created"]:
            print(
                f"baseline written: {baseline_info['suppressed']} "
                f"finding(s) -> {args.baseline}",
                file=sys.stderr,
            )

    if args.json:
        payload = result.to_dict()
        if baseline_info is not None:
            payload["baseline"] = baseline_info
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        if baseline_info is not None and baseline_info["suppressed"]:
            print(
                f"baseline {args.baseline}: "
                f"{baseline_info['suppressed']} known finding(s) "
                "suppressed",
                file=sys.stderr,
            )
        print(result.render_text())

    threshold: Optional[Severity] = None
    if args.fail_on:
        threshold = Severity.parse(args.fail_on)
    worst = result.max_severity()
    if threshold is not None and worst is not None and worst >= threshold:
        return 1
    return 0
