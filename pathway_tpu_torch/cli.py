"""Command-line interface of the port: `pathway-tpu-torch` (pyproject.toml
[project.scripts]) or `python -m pathway_tpu_torch.cli`. The JAX package's
cli with its subcommands (reference: python/pathway/cli.py — `pathway
spawn` multi-process launcher :53-205, `replay` :265, `spawn-from-env`
:297); `profile` captures a torch.profiler trace, `profile --device` on
the card."""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def _spawn(args) -> int:
    """Launch a program across N processes with worker env vars set
    (reference: cli.py spawn — PATHWAY_PROCESSES/PROCESS_ID/FIRST_PORT)."""
    env_base = dict(os.environ)
    env_base["PATHWAY_THREADS"] = str(args.threads)
    env_base["PATHWAY_PROCESSES"] = str(args.processes)
    env_base["PATHWAY_FIRST_PORT"] = str(args.first_port)
    if args.record:
        env_base["PATHWAY_REPLAY_STORAGE"] = args.record_path
        env_base["PATHWAY_REPLAY_MODE"] = "record"
    program = list(args.program)
    if program and program[0] == "--":
        program = program[1:]
    if program and program[0].endswith(".py"):
        program = [sys.executable, *program]
    procs = []
    for pid in range(args.processes):
        env = dict(env_base)
        env["PATHWAY_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(program, env=env))
    code = 0
    for p in procs:
        code = p.wait() or code
    return code


def _replay(args) -> int:
    env = dict(os.environ)
    env["PATHWAY_REPLAY_STORAGE"] = args.record_path
    env["PATHWAY_REPLAY_MODE"] = args.mode
    program = list(args.program)
    if program and program[0] == "--":
        program = program[1:]
    if program and program[0].endswith(".py"):
        program = [sys.executable, *program]
    return subprocess.call(program, env=env)


def _spawn_from_env(args) -> int:
    spawn_args = os.environ.get("PATHWAY_SPAWN_ARGS", "")
    argv = spawn_args.split() + list(args.program)
    return main(["spawn", *argv])


def _airbyte_create_source(args) -> int:
    """`pathway-tpu-torch airbyte create-source <name> --image <img>` (reference:
    cli.py:311-329)."""
    from pathway_tpu_torch.io.airbyte import create_connection_config

    try:
        path = create_connection_config(args.connection, args.image)
    except FileExistsError as exc:
        print(str(exc), file=sys.stderr)
        return 1
    print(
        f"Connection `{args.connection}` with source `{args.image}` "
        f"created successfully at `{path}`"
    )
    return 0


def _analyze(args) -> int:
    from pathway_tpu_torch.analysis.tool import main_analyze

    return main_analyze(args)


def _trace(args) -> int:
    from pathway_tpu_torch.internals.trace_tool import main_trace

    return main_trace(args)


def _status(args) -> int:
    from pathway_tpu_torch.internals.trace_tool import main_status

    return main_status(args)


def _top(args) -> int:
    from pathway_tpu_torch.internals.trace_tool import main_top

    return main_top(args)


def _profile(args) -> int:
    from pathway_tpu_torch.internals.trace_tool import main_profile

    return main_profile(args)


def _restart(args) -> int:
    from pathway_tpu_torch.internals.trace_tool import main_restart

    return main_restart(args)


def _explain(args) -> int:
    from pathway_tpu_torch.internals.trace_tool import main_explain

    return main_explain(args)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pathway-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    analyze = sub.add_parser(
        "analyze",
        help="statically analyze a script's dataflow graph without "
        "running it",
    )
    analyze.add_argument(
        "script",
        nargs="?",
        default=None,
        help="python script that builds a graph",
    )
    analyze.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    analyze.add_argument(
        "--list-codes",
        action="store_true",
        help="list every registered PWT diagnostic code (with severity, "
        "title and owning pass) instead of analyzing a script",
    )
    analyze.add_argument(
        "--fail-on",
        choices=["info", "warning", "error"],
        default=None,
        help="exit 1 when a finding at or above this severity exists",
    )
    analyze.add_argument(
        "--mesh",
        default=None,
        metavar="AXES",
        help="also run the PWT4xx mesh-compatibility pass against this "
        "device mesh, e.g. dp=4,tp=2",
    )
    analyze.add_argument(
        "--baseline",
        default=None,
        metavar="FILE",
        help="suppress findings recorded in FILE (created from the "
        "current findings when missing); --fail-on sees only new ones",
    )
    analyze.set_defaults(func=_analyze)

    trace = sub.add_parser(
        "trace",
        help="run a script with epoch tracing on and dump a "
        "Chrome/Perfetto trace (open at https://ui.perfetto.dev)",
    )
    trace.add_argument("script", help="python script that calls pw.run")
    trace.add_argument(
        "--out", default="trace.json", help="output trace file"
    )
    trace.add_argument(
        "--duration",
        type=float,
        default=10.0,
        help="terminate a streaming run after this many seconds",
    )
    trace.add_argument(
        "--sample",
        type=int,
        default=1,
        help="trace every Nth epoch (1 = every epoch)",
    )
    trace.set_defaults(func=_trace)

    status = sub.add_parser(
        "status",
        help="summarize the /status endpoint of a running job "
        "(pw.run(with_http_server=True))",
    )
    status.add_argument(
        "--url", default=None, help="full /status URL (overrides --port)"
    )
    status.add_argument(
        "--port",
        type=int,
        default=20000,
        help="local monitoring port (default: worker 0's 20000)",
    )
    status.add_argument(
        "--json", action="store_true", help="raw JSON output"
    )
    status.set_defaults(func=_status)

    top = sub.add_parser(
        "top",
        help="live cost dashboard for a running job: top tenants/routes "
        "by device share, bound-state, HBM headroom, SLO burn "
        "(1 Hz redraw from /status; curses-free)",
    )
    top.add_argument(
        "--url", default=None, help="full /status URL (overrides --port)"
    )
    top.add_argument(
        "--port",
        type=int,
        default=20000,
        help="local monitoring port (default: worker 0's 20000)",
    )
    top.add_argument(
        "--interval",
        type=float,
        default=1.0,
        help="seconds between redraws (default 1.0)",
    )
    top.add_argument(
        "--iterations",
        type=int,
        default=0,
        help="stop after N frames (0 = run until interrupted)",
    )
    top.add_argument(
        "--once",
        action="store_true",
        help="print a single frame without clearing the screen and exit",
    )
    top.set_defaults(func=_top)

    profile = sub.add_parser(
        "profile",
        help="capture an on-demand torch.profiler trace (Chrome trace "
        "JSON) — from a running job's /profile endpoint, or locally on "
        "the card with --device",
    )
    profile.add_argument(
        "--url",
        default=None,
        help="base monitoring URL of the running job (overrides --port)",
    )
    profile.add_argument(
        "--port",
        type=int,
        default=20000,
        help="local monitoring port (default: worker 0's 20000)",
    )
    profile.add_argument(
        "--seconds",
        type=float,
        default=2.0,
        help="capture window length (bounded server-side)",
    )
    profile.add_argument(
        "--out",
        default=None,
        help="trace output directory (default: a fresh tempdir)",
    )
    profile.add_argument(
        "--device",
        action="store_true",
        help="capture in THIS process on the CUDA card, driving a "
        "calibration bf16 matmul (no running job needed)",
    )
    profile.set_defaults(func=_profile)

    restart = sub.add_parser(
        "restart",
        help="rolling restart of a running job's workers, one at a "
        "time under load (health controller; exactly-once sinks "
        "preserved)",
    )
    restart.add_argument(
        "--url",
        default=None,
        help="base monitoring URL of the running job (overrides --port)",
    )
    restart.add_argument(
        "--port",
        type=int,
        default=20000,
        help="local monitoring port (default: worker 0's 20000)",
    )
    restart.add_argument(
        "--workers",
        default=None,
        metavar="IDS",
        help="comma-separated worker ids to roll (default: all)",
    )
    restart.set_defaults(func=_restart)

    explain = sub.add_parser(
        "explain",
        help="backward lineage of one output row of a running job: "
        "which operators produced it, from which input offsets, and "
        "its emit/retract history (requires PATHWAY_PROVENANCE=1)",
    )
    explain.add_argument(
        "key",
        help="output row key — full 32-hex pointer value or ^-prefixed "
        "pointer repr",
    )
    explain.add_argument(
        "--url",
        default=None,
        help="base monitoring URL of the running job (overrides --port)",
    )
    explain.add_argument(
        "--port",
        type=int,
        default=20000,
        help="local monitoring port (default: worker 0's 20000)",
    )
    explain.add_argument(
        "--json", action="store_true", help="raw JSON lineage tree"
    )
    explain.set_defaults(func=_explain)

    spawn = sub.add_parser("spawn", help="run a program on multiple workers")
    spawn.add_argument("--threads", "-t", type=int, default=1)
    spawn.add_argument("--processes", "-n", type=int, default=1)
    spawn.add_argument("--first-port", type=int, default=10000)
    spawn.add_argument("--record", action="store_true")
    spawn.add_argument("--record-path", default="record")
    spawn.add_argument("program", nargs=argparse.REMAINDER)
    spawn.set_defaults(func=_spawn)

    replay = sub.add_parser("replay", help="replay recorded inputs")
    replay.add_argument("--record-path", default="record")
    replay.add_argument(
        "--mode", choices=["batch", "speedrun"], default="batch"
    )
    replay.add_argument("program", nargs=argparse.REMAINDER)
    replay.set_defaults(func=_replay)

    sfe = sub.add_parser("spawn-from-env")
    sfe.add_argument("program", nargs=argparse.REMAINDER)
    sfe.set_defaults(func=_spawn_from_env)

    airbyte = sub.add_parser(
        "airbyte", help="airbyte connector utilities"
    )
    airbyte_sub = airbyte.add_subparsers(dest="airbyte_command", required=True)
    create_source = airbyte_sub.add_parser(
        "create-source",
        help="create a connection config template for an Airbyte source",
    )
    create_source.add_argument("connection")
    create_source.add_argument(
        "--image",
        default="airbyte/source-faker:0.1.4",
        help="any public docker Airbyte source image",
    )
    create_source.set_defaults(func=_airbyte_create_source)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())


def entry() -> None:
    """console_scripts entry point (pyproject.toml [project.scripts])."""
    sys.exit(main())
