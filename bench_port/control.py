#!/usr/bin/env python3
"""The control of a cell: one run of the cell (its program's readings,
as the benchmark's runs compare them) that also reads the reference in
the control's precision in the program's place (fp8 products for the
configurations' bfloat16: reference/numerics.py).

    python3 bench_port/control.py --workload <name> --seed <n> --seconds <s>

Prints one JSON line: the seed, the program's readings with their
limits, and the control's readings. The limits in the configuration
files were set from such lines (PERF.md). Not run by the benchmark's own
runs; it needs the card.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port.harness import main  # noqa: E402
from bench_port.harness.core import Run, exit_now  # noqa: E402


def cli(argv) -> int:
    args = main.parse(argv + ["--trace", "0"])
    import torch

    if not torch.cuda.is_available():
        main.fail("the control needs a CUDA card")
    from pathway_tpu_torch.ops.kernels import _build

    _build.load()
    kind, limit = main.card_kind()
    info = {"platform": "gpu", "kind": kind, "count": 1, "power_limit": limit}
    result = main.drive(Run(T_START), args, info, "cuda", control=True)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "correct": result["correct"],
                      "program": result["checks"], "control": result["control"],
                      "device": result["device"]}), flush=True)
    exit_now(0)
    return 0


if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:]))
