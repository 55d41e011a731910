"""pw.io — connectors (reference: python/pathway/io/__init__.py).

Connector modules are populated progressively; `subscribe` and the python
ConnectorSubject are the core primitives (reference: io/_subscribe.py:16,
io/python/__init__.py:47).
"""

from __future__ import annotations

from pathway_tpu_torch.io._subscribe import (
    OnChangeCallback,
    OnFinishCallback,
    subscribe,
)
from pathway_tpu_torch.io.fs import CsvParserSettings
from pathway_tpu_torch.io._synchronization import register_input_synchronization_group

from pathway_tpu_torch.io import csv, fs, jsonlines, null, plaintext, python

__all__ = [
    "subscribe",
    "CsvParserSettings",
    "OnChangeCallback",
    "OnFinishCallback",
    "register_input_synchronization_group",
    "csv",
    "fs",
    "jsonlines",
    "null",
    "plaintext",
    "python",
]


def __getattr__(name):
    # lazily import heavier connector modules
    import importlib

    known = {
        "http",
        "kafka",
        "redpanda",
        "debezium",
        "s3",
        "minio",
        "sqlite",
        "postgres",
        "elasticsearch",
        "mongodb",
        "nats",
        "mqtt",
        "deltalake",
        "iceberg",
        "bigquery",
        "pubsub",
        "dynamodb",
        "questdb",
        "logstash",
        "slack",
        "gdrive",
        "airbyte",
        "pyfilesystem",
    }
    if name in known:
        return importlib.import_module(f"pathway_tpu_torch.io.{name}")
    raise AttributeError(f"module pathway_tpu_torch.io has no attribute {name!r}")
