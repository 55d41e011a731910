"""Temporal stream operators: buffer, forget, freeze.

TPU-native rebuild of the reference's time-column operators (reference:
src/engine/dataflow/operators/time_column.rs — postpone_core:302 (buffer),
forget:536, freeze:627, ignore_late:673). All three share one clock model:
`global_now` is the running maximum of the current-time column over every
row seen; a per-row `threshold` decides when the operator acts:

  * BufferNode  — holds insertions until global_now >= threshold, then
    releases them (late-result delay / exactly-once emission);
  * ForgetNode  — passes rows through immediately and retracts them once
    global_now >= threshold (sliding out of the active window);
  * FreezeNode  — drops updates that arrive after global_now >= threshold
    (late-data cutoff).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from pathway_tpu_torch.engine.engine import Engine, Node
from pathway_tpu_torch.engine.stream import Delta
from pathway_tpu_torch.engine.value import Error, Pointer


class _ClockedNode(Node):
    def __init__(self, engine: Engine, input_: Node, threshold_prog, time_prog):
        super().__init__(engine, [input_])
        self.threshold_prog = threshold_prog
        self.time_prog = time_prog
        self.global_now = None

    def _advance_clock(self, keys, rows) -> None:
        for t in self.time_prog(keys, rows):
            if isinstance(t, Error) or t is None:
                continue
            if self.global_now is None or t > self.global_now:
                self.global_now = t

    def _thresholds(self, keys, rows):
        return self.threshold_prog(keys, rows)


class BufferNode(_ClockedNode):
    """reference: postpone_core (time_column.rs:302)."""

    name = "buffer"
    snapshot_attrs = ('global_now', 'held', 'released')

    def __init__(self, engine, input_, threshold_prog, time_prog, *, flush_on_end: bool = True):
        super().__init__(engine, input_, threshold_prog, time_prog)
        # key -> (threshold, values)
        self.held: Dict[Pointer, tuple] = {}
        self.released: set = set()
        self.flush_on_end = flush_on_end

    def process(self, time: int) -> None:
        deltas = self.take(0)
        out: List[Delta] = []
        if deltas:
            keys = [d[0] for d in deltas]
            rows = ([d[1] for d in deltas],)
            self._advance_clock(keys, rows)
            thresholds = self._thresholds(keys, rows)
            for (key, values, diff), th in zip(deltas, thresholds):
                if diff > 0:
                    if (
                        th is None
                        or isinstance(th, Error)
                        or (self.global_now is not None and th <= self.global_now)
                    ):
                        self.released.add(key)
                        out.append((key, values, diff))
                    else:
                        self.held[key] = (th, values)
                else:
                    if key in self.held:
                        del self.held[key]
                    else:
                        self.released.discard(key)
                        out.append((key, values, diff))
        # release held rows whose threshold has passed
        if self.global_now is not None and self.held:
            ready = [
                k for k, (th, _v) in self.held.items() if th <= self.global_now
            ]
            for k in ready:
                _th, values = self.held.pop(k)
                self.released.add(k)
                out.append((k, values, 1))
        self.emit(time, out)

    def on_flush(self) -> None:
        if self.flush_on_end and self.held:
            out = [(k, v, 1) for k, (_th, v) in self.held.items()]
            self.held.clear()
            self.released.update(k for k, _v, _d in out)
            # delivered via the pending mechanism: engine.finish drains it
            for node, port in self.downstream:
                node.receive(port, list(out))


class ForgetNode(_ClockedNode):
    """reference: forget (time_column.rs:536). `mark_forgetting_records`
    retracts without marking (marks are a monitoring nicety)."""

    name = "forget"
    snapshot_attrs = ('global_now', 'alive')

    def __init__(self, engine, input_, threshold_prog, time_prog, *, mark_forgetting_records: bool = False):
        super().__init__(engine, input_, threshold_prog, time_prog)
        # key -> (threshold, values); rows currently alive downstream
        self.alive: Dict[Pointer, tuple] = {}

    def process(self, time: int) -> None:
        deltas = self.take(0)
        out: List[Delta] = []
        if deltas:
            keys = [d[0] for d in deltas]
            rows = ([d[1] for d in deltas],)
            self._advance_clock(keys, rows)
            thresholds = self._thresholds(keys, rows)
            for (key, values, diff), th in zip(deltas, thresholds):
                if diff > 0:
                    self.alive[key] = (th, values)
                    out.append((key, values, diff))
                else:
                    if key in self.alive:
                        del self.alive[key]
                        out.append((key, values, diff))
        if self.global_now is not None and self.alive:
            expired = [
                (k, v)
                for k, (th, v) in self.alive.items()
                if th is not None and not isinstance(th, Error) and th <= self.global_now
            ]
            for k, v in expired:
                del self.alive[k]
                out.append((k, v, -1))
        self.emit(time, out)


class FreezeNode(_ClockedNode):
    """reference: freeze/ignore_late (time_column.rs:627,673)."""

    name = "freeze"
    snapshot_attrs = ('global_now', 'passed')

    def __init__(self, engine, input_, threshold_prog, time_prog):
        super().__init__(engine, input_, threshold_prog, time_prog)
        self.passed: set = set()

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        keys = [d[0] for d in deltas]
        rows = ([d[1] for d in deltas],)
        # late decision uses the clock BEFORE this batch advances it: a
        # batch's own rows are not late relative to themselves
        clock_before = self.global_now
        self._advance_clock(keys, rows)
        thresholds = self._thresholds(keys, rows)
        out: List[Delta] = []
        for (key, values, diff), th in zip(deltas, thresholds):
            if diff > 0:
                late = (
                    clock_before is not None
                    and th is not None
                    and not isinstance(th, Error)
                    and th <= clock_before
                )
                if late:
                    continue
                self.passed.add(key)
                out.append((key, values, diff))
            else:
                if key in self.passed:
                    out.append((key, values, diff))
        self.emit(time, out)
