"""Temporal behaviors: late-data cutoff, delays, exactly-once emission
(reference: python/pathway/stdlib/temporal/temporal_behavior.py:29,83).

In batch mode behaviors are no-ops (all data shares one time); in streaming
they wire the engine's buffer/forget/freeze operators (reference:
src/engine/dataflow/operators/time_column.rs).

>>> import pathway_tpu_torch as pw
>>> b = pw.temporal.common_behavior(delay=2, cutoff=10)
>>> type(b).__name__
'CommonBehavior'
>>> e = pw.temporal.exactly_once_behavior()
>>> type(e).__name__
'ExactlyOnceBehavior'
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


class Behavior:
    pass


@dataclass
class CommonBehavior(Behavior):
    delay: Any = None
    cutoff: Any = None
    keep_results: bool = True


def common_behavior(delay=None, cutoff=None, keep_results: bool = True) -> CommonBehavior:
    return CommonBehavior(delay=delay, cutoff=cutoff, keep_results=keep_results)


@dataclass
class ExactlyOnceBehavior(Behavior):
    shift: Any = None


def exactly_once_behavior(shift=None) -> ExactlyOnceBehavior:
    return ExactlyOnceBehavior(shift=shift)
