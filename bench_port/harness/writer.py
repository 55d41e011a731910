"""The traffic writer, a process of its own so that making text never
takes the serving process's interpreter lock.

    python writer.py ROOT SEED TRAFFIC_JSON WATCH_DIR STAGE_DIR

It reads target file counts from standard input, one a line, and writes
files 0, 1, ... up to the newest target into WATCH_DIR, each first into
STAGE_DIR and then renamed, so the reader never sees half a file. After
each file it prints the count written so far. It stops at the end of its
input, which the parent's death also gives it.
"""

from __future__ import annotations

import json
import os
import sys
import threading


def main() -> int:
    root, seed, traffic_json, watch, stage = sys.argv[1:6]
    sys.path.insert(0, root)
    from bench_port.harness.textgen import TextGen, json_line

    with open(traffic_json) as f:
        gen = TextGen(int(seed), json.load(f))
    target = [0]
    cond = threading.Condition()
    done = [False]

    def read_targets():
        for line in sys.stdin:
            with cond:
                target[0] = max(target[0], int(line))
                cond.notify()
        with cond:
            done[0] = True
            cond.notify()

    threading.Thread(target=read_targets, daemon=True).start()
    written = 0
    while True:
        with cond:
            while written >= target[0] and not done[0]:
                cond.wait()
            if done[0]:
                return 0
        name = f"chunks_{written:06d}.jsonl"
        tmp = os.path.join(stage, name)
        with open(tmp, "w") as f:
            f.write("".join(json_line(t) for t in gen.file_chunks(written)))
        os.replace(tmp, os.path.join(watch, name))
        written += 1
        sys.stdout.write(f"{written}\n")
        sys.stdout.flush()


if __name__ == "__main__":
    sys.exit(main())
