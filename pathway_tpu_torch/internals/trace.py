"""User-frame tracing: remember which user line created each operator and
resurface it in engine errors (reference: python/pathway/internals/trace.py;
re-attachment at graph_runner/__init__.py:221-232, OperatorProperties
graph.rs:431)."""

from __future__ import annotations

import os
import sys
import traceback
from dataclasses import dataclass
from typing import Optional

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass(frozen=True)
class Trace:
    file: str
    line: int
    function: str
    line_text: str

    def __str__(self) -> str:
        loc = f"{self.file}:{self.line}"
        if self.line_text:
            return f"{loc} in {self.function}: {self.line_text}"
        return f"{loc} in {self.function}"


def _is_user_frame(filename: str) -> bool:
    if filename.startswith(_PACKAGE_DIR):
        return False
    # frozen importlib / runpy / pytest internals are not user code either,
    # but stopping at the first non-package frame matches the reference's
    # behavior (trace.py walks out of the pathway package)
    return True


def trace_user_frame() -> Optional[Trace]:
    """The innermost stack frame outside pathway_tpu_torch — the user's line."""
    frame = sys._getframe(1)
    while frame is not None:
        filename = frame.f_code.co_filename
        if _is_user_frame(filename):
            line_text = ""
            try:
                import linecache

                line_text = linecache.getline(filename, frame.f_lineno).strip()
            except Exception:  # noqa: BLE001
                pass
            return Trace(
                file=filename,
                line=frame.f_lineno,
                function=frame.f_code.co_name,
                line_text=line_text,
            )
        frame = frame.f_back
    return None


def trace_from_exception(exc: BaseException) -> Optional[Trace]:
    """The deepest user frame inside an exception's traceback (for errors
    raised inside user UDF bodies)."""
    best: Optional[Trace] = None
    for fs in traceback.extract_tb(exc.__traceback__):
        if _is_user_frame(fs.filename):
            best = Trace(
                file=fs.filename,
                line=fs.lineno or 0,
                function=fs.name,
                line_text=(fs.line or "").strip(),
            )
    return best
