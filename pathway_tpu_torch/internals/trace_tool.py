"""`pathway-tpu-torch trace`, `status`, and `top` implementations.

`trace` runs a user script with epoch tracing forced on (every epoch by
default), bounds the run with a termination watchdog, then serialises
the merged span store to a Chrome/Perfetto ``trace_event`` JSON file —
open it at https://ui.perfetto.dev or chrome://tracing.

`status` fetches the /status JSON a running job serves (pw.run with
``with_http_server=True``; internals/monitoring.py PrometheusServer)
and renders a terminal summary: per-worker progress, hottest nodes,
sink freshness, the critical path of the latest traced epoch, and
device health.

The trace subcommand is single-process (PATHWAY_THREADS > 1 is fine:
thread workers share memory, so the dump merges them locally).  For
multi-process jobs call ``engine.dump_trace()`` from the script itself
on every worker — it is an SPMD collective.
"""

from __future__ import annotations

import json
import os
import runpy
import sys
import threading
from typing import List


def trace_script(
    path: str, *, out: str, duration: float, sample: int
) -> int:
    """Execute `path` with tracing on; dump the trace when it finishes
    (or when the watchdog terminates a streaming run after `duration`).
    Returns the number of trace events written, or -1 when the script
    never ran a dataflow."""
    from pathway_tpu_torch.internals import runner
    from pathway_tpu_torch.internals.parse_graph import G

    os.environ["PATHWAY_TRACE"] = "1"
    os.environ["PATHWAY_TRACE_SAMPLE"] = str(max(1, sample))
    G.clear()
    ran: List[bool] = []

    real_run, real_run_all = runner.run, runner.run_all
    import pathway_tpu_torch as pw

    pw_run, pw_run_all = pw.run, pw.run_all

    def _traced_run(**kwargs):
        ran.append(True)
        stop = threading.Event()

        def _watchdog():
            if stop.wait(duration):
                return
            eng = runner.last_engine()
            if eng is not None:
                eng.terminate_flag.set()

        # bounds streaming scripts; a static run finishes on its own and
        # the late terminate_flag.set() on a finished engine is harmless
        t = threading.Thread(
            target=_watchdog, daemon=True, name="pw-trace-watchdog"
        )
        t.start()
        try:
            real_run(**kwargs)
        finally:
            stop.set()

    runner.run = _traced_run
    runner.run_all = _traced_run
    pw.run = _traced_run
    pw.run_all = _traced_run
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        runner.run, runner.run_all = real_run, real_run_all
        pw.run, pw.run_all = pw_run, pw_run_all

    eng = runner.last_engine()
    if not ran or eng is None:
        return -1
    trace = eng.dump_trace(out)
    return len(trace.get("traceEvents", []))


def main_trace(args) -> int:
    """Entry point for the cli.py `trace` subcommand."""
    try:
        n = trace_script(
            args.script,
            out=args.out,
            duration=args.duration,
            sample=args.sample,
        )
    except SystemExit as exc:  # script called sys.exit()
        code = exc.code if isinstance(exc.code, int) else 1
        print(
            f"error: {args.script} exited with {code} before the trace "
            "could be dumped",
            file=sys.stderr,
        )
        return 2
    except Exception as exc:  # noqa: BLE001 — report, don't traceback
        print(f"error: failed to trace {args.script}: {exc}", file=sys.stderr)
        return 2
    if n < 0:
        print(
            f"error: {args.script} never called pw.run — nothing to trace",
            file=sys.stderr,
        )
        return 2
    print(
        f"wrote {n} trace events to {args.out} — open at "
        "https://ui.perfetto.dev or chrome://tracing"
    )
    return 0


def fetch_status(url: str, timeout: float = 5.0) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def render_status(status: dict) -> str:
    lines = [f"workers: {status.get('worker_count')}"]
    for w in status.get("workers", []):
        lines.append(
            f"  worker {w.get('worker')}: time={w.get('engine_time')} "
            f"rows={w.get('rows_processed')} ticks={w.get('ticks')} "
            f"lag={w.get('watermark_lag_s')}s errors={w.get('errors')}"
        )
        for name, stats in sorted((w.get("connectors") or {}).items()):
            lines.append(f"    connector {name}: {stats}")
        nodes = sorted(
            w.get("nodes") or [],
            key=lambda n: n.get("total_s") or 0.0,
            reverse=True,
        )
        for n in nodes[:5]:
            lines.append(
                f"    node {n.get('name')}: total={n.get('total_s')}s "
                f"p99={n.get('p99_ms')}ms rows={n.get('rows_out')}"
            )
    sinks = status.get("sinks") or []
    if sinks:
        lines.append("sink freshness (ingest -> emit):")
        for s in sinks:
            lines.append(
                f"  {s.get('sink')}: p50={s.get('p50_ms')}ms "
                f"p99={s.get('p99_ms')}ms n={s.get('count')}"
            )
    cp = status.get("critical_path")
    if cp:
        lines.append(
            f"critical path (epoch {cp.get('epoch')}, "
            f"{cp.get('total_ms')}ms total):"
        )
        for ent in cp.get("entries", []):
            lines.append(
                f"  [{ent.get('kind')}] {ent.get('name')} "
                f"w{ent.get('worker')}: {ent.get('duration_ms')}ms "
                f"({ent.get('share_pct')}%)"
            )
    device = status.get("device")
    if device:
        rtt = device.get("rtt_ms")
        lines.append(
            f"device: {device.get('status')}"
            + (f" rtt={rtt}ms" if rtt is not None else "")
            + (f" error={device['error']}" if device.get("error") else "")
        )
    util = status.get("utilization")
    if util and util.get("enabled") and util.get("dispatches"):
        mfu = util.get("mfu_pct")
        lines.append(
            "utilization: "
            + (f"mfu={mfu:.1f}% " if mfu is not None else "")
            + f"tokens/s={util.get('tokens_per_sec', 0):.0f} "
            + f"docs/s={util.get('docs_per_sec', 0):.1f} "
            + f"[{util.get('bound_state')}] "
            + f"window={util.get('window_s')}s"
        )
    mesh = status.get("mesh")
    if mesh and mesh.get("active") and mesh.get("skew_ratio") is not None:
        line = f"mesh replica skew: {mesh['skew_ratio']:.2f}x"
        straggler = mesh.get("straggler")
        if straggler:
            line += (
                f" — STRAGGLER replica {straggler.get('replica')}"
                f" ({straggler.get('skew_ratio')}x over"
                f" {straggler.get('streak')} dispatches)"
            )
        lines.append(line)
    health = status.get("health")
    if health and health.get("enabled"):
        line = f"health: bp_scale={health.get('backpressure_scale')}"
        if health.get("pressure"):
            line += f" PRESSURE[{health.get('pressure_reason')}]"
        drained = health.get("drained_replicas") or {}
        if drained:
            line += f" drained={sorted(drained)}"
        roll = health.get("rolling_restart") or {}
        if roll.get("in_progress"):
            cur = roll.get("current") or {}
            line += (
                f" rolling worker {cur.get('worker')} ({cur.get('phase')})"
            )
        elif roll.get("last"):
            last = roll["last"]
            line += (
                f" last roll: {len(last.get('workers', []))} workers in "
                f"{last.get('total_s')}s (max recovery "
                f"{last.get('max_recovery_s')}s)"
            )
        actions = health.get("actions") or {}
        acted = {k: v for k, v in actions.items() if v}
        if acted:
            line += " actions=" + ",".join(
                f"{k}:{v}" for k, v in sorted(acted.items())
            )
        lines.append(line)
    queries = status.get("queries")
    if queries and queries.get("enabled") and queries.get("completed"):
        stages = queries.get("stages") or {}
        total = stages.get("total") or {}
        lines.append(
            f"queries: qps={queries.get('qps')} "
            f"p50={total.get('p50_ms')}ms p99={total.get('p99_ms')}ms "
            f"p999={total.get('p999_ms')}ms n={queries.get('completed')} "
            f"inflight={queries.get('inflight')}"
        )
        for stage in ("network", "queue", "batch", "device", "merge", "emit"):
            st = stages.get(stage)
            if st:
                lines.append(
                    f"  stage {stage}: p50={st.get('p50_ms')}ms "
                    f"p99={st.get('p99_ms')}ms"
                )
        slo = queries.get("slo") or {}
        if slo.get("target_p99_ms") is not None:
            line = (
                f"  slo: target_p99={slo['target_p99_ms']}ms "
                f"burn_rate={slo.get('burn_rate')} "
                f"violations={slo.get('violations')}"
            )
            if slo.get("burning"):
                line += " BURNING"
            lines.append(line)
        for ex in queries.get("exemplars") or []:
            line = (
                f"  slow query {ex.get('qid')}: {ex.get('total_ms')}ms "
                f"(slowest stage: {ex.get('slowest_stage')}"
            )
            if ex.get("replica") is not None:
                line += f", replica {ex['replica']}"
            lines.append(line + ")")
    serving = status.get("serving")
    if serving and serving.get("enabled") and serving.get("active"):
        line = (
            f"serving: window={serving.get('batch_window_ms')}ms "
            f"batches={serving.get('batches')} "
            f"occ_p50={serving.get('batch_occupancy_p50')} "
            f"occ_p99={serving.get('batch_occupancy_p99')}"
        )
        part = serving.get("partitioner") or {}
        if part.get("priority"):
            line += (
                f" PRIORITY[scale={part.get('serving_scale')}]"
            )
        lines.append(line)
        cache = serving.get("cache") or {}
        if cache.get("hits") or cache.get("misses"):
            lines.append(
                f"  cache: hit_rate={cache.get('hit_rate')} "
                f"entries={cache.get('entries')} "
                f"invalidations={cache.get('invalidations')}"
            )
        adm = serving.get("admission") or {}
        if adm.get("shed_total"):
            sheds = adm.get("sheds") or {}
            lines.append(
                "  shed: total="
                f"{adm['shed_total']} "
                + " ".join(
                    f"{r}={n}" for r, n in sorted(sheds.items()) if n
                )
            )
        tenants = adm.get("tenants") or {}
        for tenant, tb in sorted(tenants.items()):
            lines.append(
                f"  tenant {tenant}: tokens={tb.get('tokens')} "
                f"rate={tb.get('rate')}/s burst={tb.get('burst')}"
            )
    prov = status.get("provenance")
    if prov and prov.get("enabled"):
        line = (
            f"provenance: edges={prov.get('edges')} "
            f"bytes={prov.get('bytes')} "
            f"truncations={prov.get('truncations')} "
            f"sampled={prov.get('sampled_fraction')}"
        )
        lines.append(line)
    analysis = status.get("analysis")
    if analysis and analysis.get("findings"):
        lines.append(f"analysis findings: {len(analysis['findings'])}")
    return "\n".join(lines)


def main_status(args) -> int:
    """Entry point for the cli.py `status` subcommand."""
    url = args.url or f"http://127.0.0.1:{args.port}/status"
    try:
        status = fetch_status(url)
    except Exception as exc:  # noqa: BLE001 — connection refused etc.
        print(f"error: could not fetch {url}: {exc}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(status, indent=2, sort_keys=True))
    else:
        print(render_status(status))
    return 0


def _fmt_bytes(n) -> str:
    if n is None:
        return "?"
    n = float(n)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}TB"


def render_top(status: dict) -> str:
    """One frame of `pathway-tpu-torch top`: who is spending the device RIGHT
    NOW, from the /status JSON alone (no in-process state) — headline
    (bound-state, MFU, SLO burn, HBM headroom), per-workload device
    shares over the ledger's rolling window, and the heaviest
    (workload, route, tenant) attribution cells."""
    cost = status.get("cost") or {}
    util = status.get("utilization") or {}
    queries = status.get("queries") or {}
    memory = status.get("memory") or {}

    head = [f"workers={status.get('worker_count')}"]
    if cost.get("devices"):
        head.append(f"devices={cost['devices']}")
    if util.get("enabled"):
        head.append(f"bound={util.get('bound_state', '?')}")
        mfu = util.get("mfu_pct")
        if mfu is not None:
            head.append(f"mfu={mfu:.1f}%")
    slo = queries.get("slo") or {}
    if slo.get("target_p99_ms") is not None:
        burn = slo.get("burn_rate")
        head.append(
            f"slo_burn={burn}" + (" BURNING" if slo.get("burning") else "")
        )
    if memory.get("enabled", True) and memory.get("headroom_pct") is not None:
        head.append(
            f"hbm_headroom={memory['headroom_pct']:.1f}% "
            f"({_fmt_bytes(memory.get('hbm_headroom_bytes'))})"
        )
    lines = ["pathway-tpu-torch top — " + " ".join(head)]

    if not cost.get("enabled"):
        # /status may lack the "cost" key entirely (PATHWAY_COSTLEDGER=0
        # on an older job): render a full dashed frame, never crash or
        # go blank — the dashboard stays useful for the headline fields
        lines.append("cost ledger disabled (PATHWAY_COSTLEDGER=0)")
        lines.append(
            f"{'WORKLOAD':<12}{'ROUTE':<18}{'TENANT':<14}"
            f"{'DEV_S':>10}{'SHARE':>7}{'QUERIES':>9}{'DOCS':>8}"
            f"{'BYTES':>10}"
        )
        lines.append(
            f"{'-':<12}{'-':<18}{'-':<14}"
            f"{'-':>10}{'-':>7}{'-':>9}{'-':>8}{'-':>10}"
        )
        return "\n".join(lines)
    if not cost.get("active"):
        lines.append("cost ledger idle — no dataflow charged yet")
        return "\n".join(lines)

    shares = cost.get("shares") or {}
    per = shares.get("shares") or {}
    seconds = shares.get("seconds") or {}
    parts = [
        f"{w}={per[w]:.0%} ({seconds.get(w, 0):.3f}s)"
        for w in sorted(per)
        if per[w] is not None
    ]
    if parts:
        lines.append(
            f"device share [{shares.get('window_s')}s window]: "
            + "  ".join(parts)
        )
    cons = cost.get("conservation") or {}
    if cons.get("ratio") is not None:
        lines.append(
            f"conservation: attributed={cons.get('attributed_s')}s "
            f"window={cons.get('utilization_window_s'):.6f}s "
            f"ratio={cons['ratio']}"
        )
    eff = cost.get("efficiency_pct")
    if eff is not None:
        lines.append(f"attributed efficiency: {eff}% of peak")
    elif not cost.get("device_capacity_known", True):
        lines.append(
            "attributed efficiency: n/a (device peak unknown — PWT802)"
        )

    top = cost.get("top") or []
    if top:
        lines.append(
            f"{'WORKLOAD':<12}{'ROUTE':<18}{'TENANT':<14}"
            f"{'DEV_S':>10}{'SHARE':>7}{'QUERIES':>9}{'DOCS':>8}"
            f"{'BYTES':>10}"
        )
        total_s = sum(c.get("device_s", 0.0) for c in top) or None
        for cell in top:
            dev_s = cell.get("device_s", 0.0)
            share = f"{dev_s / total_s:.0%}" if total_s else "-"
            lines.append(
                f"{cell.get('workload', ''):<12}"
                f"{(cell.get('route') or '-'):<18}"
                f"{(cell.get('tenant') or '-'):<14}"
                f"{dev_s:>10.4f}{share:>7}"
                f"{cell.get('queries', 0):>9}{cell.get('docs', 0):>8}"
                f"{_fmt_bytes(cell.get('bytes')):>10}"
            )
    savings = cost.get("cache_savings") or {}
    for tenant, s in sorted(savings.items()):
        lines.append(
            f"cache savings [{tenant or '-'}]: {s.get('hits')} hits, "
            f"{s.get('saved_device_s')}s device time saved"
        )
    return "\n".join(lines)


def main_top(args) -> int:
    """Entry point for the cli.py `top` subcommand: a curses-free live
    dashboard — fetch /status, render one frame, ANSI clear-screen and
    redraw every ``--interval`` seconds (default 1 Hz).  ``--iterations``
    bounds the loop (0 = until interrupted); ``--once`` prints a single
    frame with no screen clearing (scripts, tests)."""
    import time as time_mod

    url = args.url or f"http://127.0.0.1:{args.port}/status"
    iterations = 1 if args.once else args.iterations
    n = 0
    try:
        while True:
            try:
                status = fetch_status(url)
            except Exception as exc:  # noqa: BLE001 — connection refused etc.
                print(f"error: could not fetch {url}: {exc}", file=sys.stderr)
                return 1
            frame = render_top(status)
            if args.once:
                print(frame)
            else:
                # ANSI clear + home: live redraw without curses
                sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
                sys.stdout.flush()
            n += 1
            if iterations and n >= iterations:
                return 0
            time_mod.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def render_explain(payload: dict) -> str:
    """Terminal render of one /explain lineage tree: the retraction
    story first, then the backward tree indented two spaces per hop,
    each node listing its operator hops and source offsets."""
    lines = [f"key {payload.get('key')}"]
    if not payload.get("found"):
        lines.append("  (no lineage recorded for this key)")
        return "\n".join(lines)
    for story in payload.get("retractions") or []:
        lines.append(f"  {story}")

    def _walk(node: dict, depth: int) -> None:
        pad = "  " * (depth + 1)
        label = node.get("key", "?")
        ops = node.get("ops") or []
        line = f"{pad}{label}"
        if ops:
            line += " <- " + ", ".join(ops)
        if not node.get("found"):
            line += " (source / untracked)"
        lines.append(line)
        offs = node.get("source_offsets")
        if offs:
            lines.append(
                f"{pad}  source offsets: "
                + ", ".join(str(o) for o in offs)
            )
        chains = node.get("chains")
        if chains:
            lines.append(f"{pad}  fused chains: " + ", ".join(chains))
        if node.get("truncated"):
            lines.append(f"{pad}  ... (tree truncated)")
        for child in node.get("inputs") or []:
            _walk(child, depth + 1)

    tree = payload.get("tree")
    if tree:
        _walk(tree, 0)
    return "\n".join(lines)


def main_explain(args) -> int:
    """Entry point for the cli.py `explain` subcommand: fetch the
    backward lineage tree of one output key from a RUNNING job
    (``/explain?key=...``; requires PATHWAY_PROVENANCE=1 on the job)
    and render it as an indented tree (or raw JSON with ``--json``)."""
    import urllib.error
    import urllib.parse
    import urllib.request

    base = args.url or f"http://127.0.0.1:{args.port}"
    url = (
        base.rstrip("/")
        + "/explain?"
        + urllib.parse.urlencode({"key": args.key})
    )
    try:
        with urllib.request.urlopen(url, timeout=10.0) as resp:
            payload = json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        try:
            payload = json.loads(exc.read().decode())
        except Exception:  # noqa: BLE001
            payload = {"error": str(exc)}
    except Exception as exc:  # noqa: BLE001 — connection refused etc.
        print(
            f"error: could not reach {url}: {exc} — is the job running "
            "with pw.run(with_http_server=True)?",
            file=sys.stderr,
        )
        return 1
    if payload.get("error"):
        print(f"error: {payload['error']}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        print(render_explain(payload))
    return 0


def main_restart(args) -> int:
    """Entry point for the cli.py `restart` subcommand: ask a RUNNING
    job's monitoring server to start a rolling restart (drain and
    respawn one worker at a time, under load, exactly-once sinks
    preserved).  ``--workers 0,2`` limits the roll; default rolls every
    worker the server knows about."""
    import urllib.error
    import urllib.parse
    import urllib.request

    base = args.url or f"http://127.0.0.1:{args.port}"
    url = base.rstrip("/") + "/restart"
    if args.workers:
        url += "?" + urllib.parse.urlencode({"workers": args.workers})
    try:
        with urllib.request.urlopen(url, timeout=10.0) as resp:
            result = json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        try:
            result = json.loads(exc.read().decode())
        except Exception:  # noqa: BLE001
            result = {"error": str(exc)}
    except Exception as exc:  # noqa: BLE001 — connection refused etc.
        print(
            f"error: could not reach {url}: {exc} — is the job running "
            "with pw.run(with_http_server=True)?",
            file=sys.stderr,
        )
        return 1
    if result.get("error"):
        print(f"error: {result['error']}", file=sys.stderr)
        roll = result.get("rolling_restart") or {}
        if roll.get("in_progress"):
            cur = roll.get("current") or {}
            print(
                f"  a roll is already in progress: worker "
                f"{cur.get('worker')} ({cur.get('phase')}), "
                f"queued={roll.get('queued')}",
                file=sys.stderr,
            )
        return 1
    workers = result.get("requested", [])
    print(
        f"rolling restart requested for {len(workers)} worker(s): "
        f"{workers} — one at a time, under load; watch progress with "
        "`pathway-tpu-torch status` (health line)"
    )
    return 0


def main_profile(args) -> int:
    """Entry point for the cli.py `profile` subcommand.

    Default mode asks a RUNNING job's monitoring server for a capture
    (``/profile?seconds=N`` — the job records whatever it is doing);
    ``--device`` captures in THIS process instead, on the CUDA card,
    driving a small calibration matmul so the trace shows the card even
    without a job."""
    if args.device:
        from pathway_tpu_torch.internals import profiler

        result = profiler.capture_local(args.seconds, args.out)
    else:
        import urllib.error
        import urllib.parse
        import urllib.request

        base = args.url or f"http://127.0.0.1:{args.port}"
        query = {"seconds": args.seconds}
        if args.out:
            query["dir"] = args.out
        url = (
            base.rstrip("/")
            + "/profile?"
            + urllib.parse.urlencode(query)
        )
        try:
            # a job's first capture on a card sets CUPTI up before its
            # window opens, which can take tens of seconds
            with urllib.request.urlopen(
                url, timeout=args.seconds + 120.0
            ) as resp:
                result = json.loads(resp.read().decode())
        except urllib.error.HTTPError as exc:
            try:
                result = json.loads(exc.read().decode())
            except Exception:  # noqa: BLE001
                result = {"error": str(exc)}
        except Exception as exc:  # noqa: BLE001 — connection refused etc.
            print(
                f"error: could not reach {url}: {exc} — is the job "
                "running with pw.run(with_http_server=True)?",
                file=sys.stderr,
            )
            return 1
    if result.get("error"):
        print(f"error: {result['error']}", file=sys.stderr)
        return 1
    print(
        f"captured {result.get('seconds')}s of device trace "
        f"({result.get('files', '?')} files) under "
        f"{result.get('trace_dir')} — open {result.get('trace_file')} in "
        "chrome://tracing or https://ui.perfetto.dev"
    )
    return 0
