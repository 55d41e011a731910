"""pw.io.python — custom python connectors (reference:
python/pathway/io/python/__init__.py:47 ConnectorSubject)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io._connector_runtime import (
    ConnectorSubjectBase as ConnectorSubject,
)
from pathway_tpu_torch.io._connector_runtime import connector_table


def read(
    subject: ConnectorSubject | type,
    *,
    schema,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    **kwargs,
):
    """Read from a user ConnectorSubject."""
    if isinstance(subject, type) or (
        callable(subject) and not isinstance(subject, ConnectorSubject)
    ):
        factory = subject
    else:
        # a subject instance can be consumed once
        used = [False]

        def factory():
            if used[0]:
                raise RuntimeError("ConnectorSubject instance already consumed")
            used[0] = True
            return subject

    return connector_table(
        schema, factory, mode=mode, name=name, exclusive=True
    )
