"""The parent's side of the traffic writer (writer.py): a watched
directory that a separate process fills with jsonlines files of chunks."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from bench_port.harness.core import BenchFailure

HERE = os.path.dirname(os.path.abspath(__file__))


class Feed:
    """Files of `traffic`'s chunks written into `watch` on demand."""

    def __init__(self, run, root: str, seed: int, traffic: dict, workdir: str):
        self.run = run
        self.per_file = int(traffic["chunks_per_file"])
        self.watch = os.path.join(workdir, "watch")
        stage = os.path.join(workdir, "stage")
        os.makedirs(self.watch)
        os.makedirs(stage)
        traffic_json = os.path.join(workdir, "traffic.json")
        with open(traffic_json, "w") as f:
            json.dump(traffic, f)
        self.written = 0
        self._target = 0
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "writer.py"), root, str(seed), traffic_json,
             self.watch, stage],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, bufsize=1,
        )
        self._reader = run.thread("feed-acks", self._read_acks)
        run.on_exit(self.close)

    def _read_acks(self) -> None:
        for line in self.proc.stdout:
            self.written = int(line)

    def chunks_written(self) -> int:
        return self.written * self.per_file

    def want(self, files: int) -> None:
        """Have at least `files` files written (asynchronously)."""
        if files > self._target:
            if self.proc.poll() is not None:
                raise BenchFailure(f"the traffic writer ended with code {self.proc.returncode}")
            self._target = files
            self.proc.stdin.write(f"{files}\n")
            self.proc.stdin.flush()

    def close(self, timeout: float = 10.0) -> None:
        """Stop the writer and wait for it to end."""
        if self.proc.returncode is not None:
            return
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        t_end = time.perf_counter() + timeout
        while self.proc.poll() is None and time.perf_counter() < t_end:
            time.sleep(0.02)
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=timeout)
        self._reader.join(timeout=timeout)

    def read_file(self, f: int) -> list:
        """The texts of file f as written (the raw file both sides read)."""
        with open(os.path.join(self.watch, f"chunks_{f:06d}.jsonl")) as fh:
            return [json.loads(row)["data"] for row in fh]
