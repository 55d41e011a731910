#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It measures `pathway_tpu_torch` on the
CUDA card(s) of the machine it runs on, and prints one JSON result line
last on standard output (harness/main.py).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main.cli(T_START, sys.argv[1:]))
