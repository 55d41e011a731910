"""Run-wide plumbing: deadlines, the watchdog, failures raised in other
threads, and the lines a run prints at its end.

Every wait of a run goes through `Run.wait_until`, which raises at its
deadline and as soon as any thread of the process has died with an
exception, so no wait is unbounded and no failure is swallowed while the
main thread polls. The watchdog ends the process at the run's whole
deadline, whatever the main thread is doing.
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
import time
import traceback


class BenchFailure(RuntimeError):
    """A run that cannot give a result: it exits non-zero, prints no result."""


class Run:
    """State shared by the threads of one run."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self._lock = threading.Lock()
        self._errors: list = []
        self.stop = threading.Event()
        self._cleanups: list = []

    def on_exit(self, fn) -> None:
        """Call `fn` when the run ends, however it ends (child processes)."""
        self._cleanups.append(fn)

    def cleanup(self) -> None:
        while self._cleanups:
            fn = self._cleanups.pop()
            try:
                fn()
            except Exception as exc:  # noqa: BLE001 - the run is ending anyway
                err(f"bench_port: clean-up failed: {exc!r}")

    def fail(self, where: str, exc: BaseException) -> None:
        text = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        with self._lock:
            self._errors.append(f"{where}: {text}")
        self.stop.set()

    def check(self) -> None:
        """Raise in the calling thread if any other thread has failed."""
        with self._lock:
            errors = list(self._errors)
        if errors:
            raise BenchFailure("a thread of the run failed:\n" + "\n".join(errors))

    def wait_until(self, pred, deadline: float, what: str, poll: float = 0.02,
                   give_up: bool = False):
        """Poll `pred` until it returns a true value, which is returned.
        At the deadline: raise, or with `give_up` return False (an answer
        that never came, which the caller judges)."""
        while True:
            self.check()
            got = pred()
            if got:
                return got
            if time.perf_counter() >= deadline:
                if give_up:
                    return False
                raise BenchFailure(f"{what}: not within its deadline "
                                   f"({deadline - self.t_start:.1f} s after the start)")
            time.sleep(poll)

    def thread(self, name: str, target, *args) -> threading.Thread:
        """A daemon thread whose exception fails the run."""

        def body():
            try:
                target(*args)
            except BaseException as exc:  # noqa: BLE001 - handed to the main thread
                self.fail(name, exc)

        t = threading.Thread(target=body, name=name, daemon=True)
        t.start()
        return t


def install_thread_hook(run: Run) -> None:
    """An uncaught exception in any thread, the program's own included
    (its engine and server threads), fails the run."""

    def hook(args):
        if args.exc_type is SystemExit:
            return
        run.fail(f"thread {getattr(args.thread, 'name', '?')}",
                 args.exc_value or args.exc_type())

    threading.excepthook = hook


class Watchdog:
    """Ends the process at `deadline` (a perf_counter time, which the
    caller may move)."""

    def __init__(self, deadline: float, run: "Run | None" = None):
        self.deadline = deadline
        self.run = run
        self._cancel = threading.Event()
        self._thread = threading.Thread(target=self._watch, name="bench-watchdog", daemon=True)
        self._thread.start()

    def cancel(self) -> None:
        self._cancel.set()

    def _watch(self) -> None:
        while not self._cancel.wait(0.5):
            if time.perf_counter() >= self.deadline:
                err("bench_port: the run passed its whole deadline; ending it")
                if self.run is not None:
                    self.run.cleanup()
                exit_now(3)


def err(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def exit_now(code: int) -> None:
    """Exit at once: a non-daemon thread of the program cannot hold the
    process up once the last line is out."""
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    finally:
        os._exit(code)


def print_result(result: dict) -> None:
    """The result as the last line of standard output, with `checks`
    last, and each compared number beside its limit as the last lines of
    standard error."""
    checks = result.pop("checks", {})
    for row in checks.values():
        if isinstance(row["value"], float) and not math.isfinite(row["value"]):
            row["value"] = str(row["value"])  # strict JSON has no inf or nan
    result["checks"] = checks
    for name, row in checks.items():
        err(f"check {name} {row['value']!r} limit {row['limit']!r}")
    sys.stdout.write(json.dumps(result, allow_nan=False) + "\n")
    sys.stdout.flush()
