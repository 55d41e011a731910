"""One run of one cell: `python3 bench_port/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>`.

The order is what makes a run fail fast: the data files first, then the
port's import, the card, and the port's kernels from their compile cache
(pathway_tpu_torch/_build/, inside the checkout); only then traffic,
weights, the engine and the reference. A run that cannot give a result
prints its reason on standard error, as a last line with `"correct":
false`, prints nothing on standard output, and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import tempfile
import threading
import time

from bench_port.harness import spec as specs
from bench_port.harness.core import (BenchFailure, Run, Watchdog, err, exit_now, install_thread_hook,
                                     print_result)

# a run's whole deadline: a run has 360 s, and a checkout's first run, which
# builds the kernels, 1,200 s; the watchdog adds the build's time
RUN_LIMIT_S = 345.0
BUILD_LIMIT_S = 1150.0
JAX_MODULES = ("jax", "jaxlib", "flax", "pathway_tpu")


class Job:
    """What a driver is given: the cell, its files, the run's seed and
    window, the device, a work directory and the run's deadlines."""

    def __init__(self, run: Run, root: str, bench_dir: str, cell: dict, config: dict, traffic: dict,
                 seed: int, seconds: int, trace: bool, device: str, workdir: str):
        self.run, self.root, self.bench_dir = run, root, bench_dir
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.workdir = workdir
        self.t_start = run.t_start
        self.t_ready = time.perf_counter()
        self.t_close = None
        self.window = None
        # control runs (control.py) also read the reference in the
        # control's precision in the program's place
        self.control = False
        self.control_readings = None

    def deadline(self, phase: str) -> float:
        """setup: from the kernels' load; drain (the wait for answers in
        flight, the drain and the program's stop): from the window's close."""
        if phase == "setup":
            return self.t_ready + float(self.traffic["setup_limit_s"])
        if phase == "drain":
            anchor = self.t_close if self.t_close is not None else time.perf_counter()
            return anchor + float(self.traffic["drain_limit_s"])
        raise ValueError(phase)

    def trace_window(self):
        """The traced run's profiler window (set up with the job), else None."""
        return self.window


def jax_loaded() -> list:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(JAX_MODULES))


def card_kind() -> tuple:
    import torch

    kind = torch.cuda.get_device_name(0)
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        limit = res.stdout.strip().splitlines()[0] if res.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = None
    return kind, limit


def judge(checks: dict) -> bool:
    return all(isinstance(v, (int, float)) and not math.isnan(v) and v <= lim
               for v, lim in checks.values())


def run_cell(job: Job, spec: dict, device_info: dict) -> dict:
    """Drive the cell and assemble its result line (without printing)."""
    out = specs.driver(job.traffic["driver"], job.bench_dir).run(job)
    job.run.check()
    found = jax_loaded()
    if found:
        raise BenchFailure(f"the process holds {', '.join(found)} after the window")
    name = job.cell["name"]
    device = dict(device_info, memory_peak_bytes=int(out["memory_peak_bytes"]))
    result = {"correct": judge(out["checks"]), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": {}, "device": device}
    if job.trace:
        reading = job.window.read(out["ctx"].get("host", ()))
        ctx = dict(out["ctx"], trace=reading)
        for m in specs.per_layer(spec, name):
            value = specs.metric_reader(m["name"], job.bench_dir)(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
        device["busy_s"] = reading.busy_s
        device["window_s"] = reading.window_s
        result["breakdown"] = {"device_ops": reading.device_ops(), "idle_gaps": reading.idle_gaps()}
    else:
        for m in specs.end_to_end(spec, name):
            result["metrics"][m["name"]] = {"value": float(out["end_to_end"][m["name"]]),
                                            "unit": m["unit"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    return result


def drive(run: Run, args, device_info: dict, device: str, root: str = specs.ROOT,
          bench_dir: str = specs.BENCH_DIR, control: bool = False) -> dict:
    """Everything of a run after the look for the card: the cell driven
    on `device`, its result line returned. Raises BenchFailure. With
    `control` (control.py) the result also holds, under "control", the
    readings of the reference in the control's precision."""
    spec = specs.load_spec(root)
    cell = specs.cell(spec, args.workload)
    config = specs.load_config(spec, cell["config"], root)
    traffic = specs.load_traffic(cell["traffic"], bench_dir)
    saved_hook = threading.excepthook
    install_thread_hook(run)
    workdir = tempfile.mkdtemp(prefix="bench_port_")
    run.on_exit(lambda: shutil.rmtree(workdir, ignore_errors=True))
    try:
        job = Job(run, root, bench_dir, cell, config, traffic, args.seed, args.seconds,
                  bool(args.trace), device, workdir)
        job.control = control
        if job.trace:
            from bench_port.harness.trace import Window

            job.window = Window()
        result = run_cell(job, spec, device_info)
        if control:
            result["control"] = job.control_readings
        return result
    except BenchFailure:
        raise
    except Exception as exc:  # noqa: BLE001 - the run's end, with its traceback
        import traceback

        err(traceback.format_exc())
        raise BenchFailure(f"{type(exc).__name__}: {exc}") from exc
    finally:
        run.cleanup()
        threading.excepthook = saved_hook


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(reason: str, code: int = 2) -> None:
    err(json.dumps({"correct": False, "error": reason}))
    exit_now(code)


def cli(t_start: float, argv) -> int:
    args = parse(argv)
    run = Run(t_start)
    watchdog = Watchdog(t_start + BUILD_LIMIT_S, run)
    try:
        spec = specs.load_spec()
        cell = specs.cell(spec, args.workload)
        specs.load_config(spec, cell["config"])
        specs.load_traffic(cell["traffic"])
    except (OSError, KeyError, ValueError) as exc:
        fail(f"the benchmark's files: {exc!r}")
    try:
        import torch

        import pathway_tpu_torch  # noqa: F401 - the system under test
    except ImportError as exc:
        fail(f"the port does not import: {exc!r}")
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        fail(f"{int(cell['chips'])} CUDA card(s) wanted, "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    try:
        from pathway_tpu_torch.ops.kernels import _build

        t_build = time.perf_counter()
        _build.load()
        built_s = time.perf_counter() - t_build
        # a build of more than a few seconds is a checkout's first run
        watchdog.deadline = t_start + RUN_LIMIT_S + (built_s if built_s > 5.0 else 0.0)
        kind, limit = card_kind()
    except Exception as exc:  # noqa: BLE001 - any failure to load is the run's end
        fail(f"the port's kernels did not load: {exc!r}")
    device_info = {"platform": "gpu", "kind": kind, "count": int(cell["chips"]),
                   "power_limit": limit}
    try:
        result = drive(run, args, device_info, "cuda")
    except BenchFailure as exc:
        fail(str(exc), 3)
    watchdog.cancel()
    print_result(result)
    exit_now(0 if result["correct"] else 1)
    return 0
