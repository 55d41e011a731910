"""pw.io.dynamodb — DynamoDB snapshot sink (reference:
python/pathway/io/dynamodb write:19; Rust writer
src/connectors/aws/dynamodb.rs:375 — upsert/delete keyed by partition+sort
key, i.e. snapshot semantics)."""

from __future__ import annotations

from typing import Sequence

from pathway_tpu_torch.io._writer import OutputWriter, RowEvent, attach_writer, jsonable


class DynamoDBWriter(OutputWriter):
    def __init__(self, table_client, partition_key: str, sort_key: str | None):
        self.table_client = table_client
        self.partition_key = partition_key
        self.sort_key = sort_key

    def _key(self, ev: RowEvent) -> dict:
        key = {self.partition_key: jsonable(ev.values[self.partition_key])}
        if self.sort_key is not None:
            key[self.sort_key] = jsonable(ev.values[self.sort_key])
        return key

    def write_batch(self, events: Sequence[RowEvent]) -> None:
        for ev in sorted(events, key=lambda e: e.diff):
            if ev.diff > 0:
                item = {k: jsonable(v) for k, v in ev.values.items()}
                self.table_client.put_item(Item=item)
            else:
                self.table_client.delete_item(Key=self._key(ev))


def write(
    table,
    table_name: str,
    partition_key,
    sort_key=None,
    *,
    init_mode: str = "default",
    name: str | None = None,
    _table_client=None,
    **kwargs,
) -> None:
    """Maintain the table as a DynamoDB item snapshot (reference:
    io/dynamodb write:19)."""
    pk = getattr(partition_key, "name", partition_key)
    sk = getattr(sort_key, "name", sort_key) if sort_key is not None else None
    if _table_client is None:
        try:
            import boto3  # type: ignore
        except ImportError:
            raise ImportError(
                "pw.io.dynamodb requires boto3; install it or inject a table "
                "client via _table_client"
            )
        _table_client = boto3.resource("dynamodb").Table(table_name)
    attach_writer(table, DynamoDBWriter(_table_client, pk, sk), name=name)
