#!/usr/bin/env python3
"""Sets of runs of the benchmark, one process a run, and their spreads.

    python3 bench_port/sets.py OUT.jsonl WORKLOAD:SEED:SECONDS:TRACE ...

Each argument after the output file is one run of `bench_port/run.py`,
in the order given. Each run's result line (or its failure, with the
end of its standard error) is appended to OUT.jsonl with its wall time
and exit code. At the end it prints, per workload and metric, the
median and the spread: the distance between the first and the third
quartile (statistics.quantiles(n=4)) as a share of the median.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def one(workload: str, seed: int, seconds: int, trace: int) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload", workload, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1300,
    )
    row = {"workload": workload, "seed": seed, "seconds": seconds, "trace": trace,
           "rc": proc.returncode, "wall_s": time.perf_counter() - t0,
           "stderr_tail": proc.stderr[-3000:]}
    lines = proc.stdout.strip().splitlines()
    try:
        row["result"] = json.loads(lines[-1]) if lines else None
    except ValueError:
        row["result"] = None
        row["stdout_tail"] = proc.stdout[-2000:]
    return row


def spread(values: list) -> tuple:
    med = statistics.median(values)
    if len(values) < 2:
        return med, None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med if med else None


def main(argv) -> int:
    out, runs = argv[0], argv[1:]
    rows = []
    for spec in runs:
        workload, seed, seconds, trace = spec.split(":")
        row = one(workload, int(seed), int(seconds), int(trace))
        rows.append(row)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        res = row["result"] or {}
        print(json.dumps({"workload": workload, "seed": int(seed), "trace": int(trace), "rc": row["rc"],
                          "wall_s": round(row["wall_s"], 1), "correct": res.get("correct"),
                          "metrics": {k: v["value"] for k, v in res.get("metrics", {}).items()},
                          "checks": {k: v["value"] for k, v in res.get("checks", {}).items()}}),
              flush=True)
        if row["result"] is None:
            print(row["stderr_tail"][-1500:], flush=True)
    by: dict = {}
    for row in rows:
        res = row["result"]
        if res and not row["trace"]:
            for k, v in res["metrics"].items():
                by.setdefault((row["workload"], k), []).append(v["value"])
    for (w, k), vals in sorted(by.items()):
        med, sp = spread(vals)
        print(f"{w} {k}: n={len(vals)} median={med!r} spread={sp!r} values={vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
