"""A bounded torch.profiler window and what the benchmark reads from it.

The profiler records every kernel of the process (CUPTI) and the host
ops of the thread that opened it; it does not record the other threads'
host ops, which would slow a served run several-fold. Host intervals
the benchmark knows on its own clock (time.perf_counter: the generate
calls its recorder timed, the DevicePipeline's stage spans) are laid on
the profiler's clock by the `bench.window` span, whose start is the
window's opening on both. Idle gaps are named by the host interval that
holds them. The device-busy union of kernel intervals is trace_port.py's
`_busy_us`, copied.
"""

from __future__ import annotations

import bisect
import time

WINDOW_SPAN = "bench.window"
HOST_SPAN_PREFIX = "bench."
GAP_LOOKBACK_US = 5_000_000.0
NAMED_GAPS = 500


def union_us(spans) -> tuple:
    """The union of (start, end) intervals: (total length, merged list).
    The merge loop is trace_port.py's `_busy_us`."""
    spans = sorted(spans)
    busy, end = 0.0, float("-inf")
    merged: list = []
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
            merged.append([s, e])
        elif e > end:
            busy += e - end
            end = e
            merged[-1][1] = e
    return busy, merged


def idle_gaps(merged: list, lo: float, hi: float) -> list:
    """(start, end) of the window [lo, hi] not covered by `merged`."""
    gaps, at = [], lo
    for s, e in merged:
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def clip(spans, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi]


def name_gap(gap, starts, spans) -> str:
    """What the host was doing over an idle gap: the shortest host
    interval that covers half of it, else the one overlapping it most."""
    s, e = gap
    i0 = bisect.bisect_left(starts, s - GAP_LOOKBACK_US)
    i1 = bisect.bisect_right(starts, e)
    best, best_over, cover = None, 0.0, None
    for ev_s, ev_e, name in spans[i0:i1]:
        over = min(ev_e, e) - max(ev_s, s)
        if over <= 0:
            continue
        if over >= 0.5 * (e - s) and (cover is None or ev_e - ev_s < cover[0]):
            cover = (ev_e - ev_s, name)
        if over > best_over:
            best, best_over = name, over
    if cover is not None:
        return cover[1]
    return best or "no host interval recorded"


class Reading:
    """What one traced window gives: kernels, host intervals, the window.
    `t_open` is the window's opening on the host's perf_counter clock;
    `host` holds (name, start, end) intervals on that clock."""

    def __init__(self, prof, t_open: float, host=()):
        from torch.autograd import DeviceType

        self.kernels, intervals = [], []
        window = None
        for e in prof.events():
            s, t = float(e.time_range.start), float(e.time_range.end)
            if e.name.startswith(HOST_SPAN_PREFIX) and e.device_type == DeviceType.CUDA:
                continue  # a host span's shadow on the device's timeline, not a kernel
            if e.device_type == DeviceType.CUDA:
                self.kernels.append((s, t, e.name))
            elif e.name == WINDOW_SPAN:
                window = (s, t)
            else:
                intervals.append((s, t, e.name))
        if window is None:
            raise RuntimeError("the profiler recorded no window span")
        self.lo, self.hi = window
        self.offset_us = self.lo - t_open * 1e6
        intervals += [(self.to_us(a), self.to_us(b), name) for name, a, b in host]
        intervals.sort()
        self._host = intervals
        self._host_starts = [c[0] for c in intervals]
        inside = clip([(s, t) for s, t, _ in self.kernels], self.lo, self.hi)
        self.busy_us, self._merged = union_us(inside)

    def to_us(self, perf_s: float) -> float:
        """A perf_counter time on the profiler's clock."""
        return perf_s * 1e6 + self.offset_us

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6

    def device_ops(self, n: int = 10) -> list:
        """[[kernel, seconds], ...] of the kernels that took most time."""
        by_name: dict = {}
        for s, t, name in self.kernels:
            over = min(t, self.hi) - max(s, self.lo)
            if over > 0:
                by_name[name[:120]] = by_name.get(name[:120], 0.0) + over / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[host activity, seconds], ...]: the longest device idle gaps,
        each named by what the host was doing, summed by name."""
        gaps = sorted(idle_gaps(self._merged, self.lo, self.hi), key=lambda g: g[0] - g[1])
        by_name: dict = {}
        for g in gaps[:NAMED_GAPS]:
            name = name_gap(g, self._host_starts, self._host)[:120]
            by_name[name] = by_name.get(name, 0.0) + (g[1] - g[0]) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def kernel_seconds(self, needle: str, within: list) -> float:
        """Device seconds of kernels whose name holds `needle` and that lie
        inside one of the `within` (start, end) perf_counter intervals."""
        spans = [(self.to_us(a), self.to_us(b)) for a, b in within]
        total = 0.0
        for s, t, name in self.kernels:
            if needle in name and any(a <= s and t <= b for a, b in spans):
                total += (t - s) / 1e6
        return total


class Window:
    """torch.profiler over CPU and CUDA around a `bench.window` span.

    A process's first CUDA profiler session sets CUPTI up, which takes
    seconds and holds the process's CUDA work meanwhile; `Window()` does
    that in a short session of its own at set-up, so the window opens at
    once. CUPTI is torn down after each session (TEARDOWN_CUPTI=1):
    kept up, a later session of a process can miss the kernels of other
    threads (internals/profiler.py's finding on this card)."""

    def __init__(self):
        import os

        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        os.environ.setdefault("TEARDOWN_CUPTI", "1")
        os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "0")
        if torch.cuda.is_available():
            with profile(activities=[ProfilerActivity.CUDA]):
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._span = record_function(WINDOW_SPAN)
        self.t_open = self.t_close = None

    def open(self) -> None:
        self._prof.__enter__()
        self._span.__enter__()
        self.t_open = time.perf_counter()

    def close(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t_close = time.perf_counter()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def read(self, host=()) -> Reading:
        return Reading(self._prof, self.t_open, host)
