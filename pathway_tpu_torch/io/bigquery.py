"""pw.io.bigquery — BigQuery sink (reference: python/pathway/io/bigquery
write:57, buffered via _OutputBuffer:15 — streaming inserts of change-stream
rows with time/diff columns)."""

from __future__ import annotations

from typing import Sequence

from pathway_tpu_torch.io._writer import OutputWriter, RowEvent, attach_writer, jsonable


class BigQueryWriter(OutputWriter):
    def __init__(self, client, table_ref: str, max_batch_size: int | None = None):
        self.client = client
        self.table_ref = table_ref
        self.max_batch_size = max_batch_size

    def write_batch(self, events: Sequence[RowEvent]) -> None:
        rows = []
        for ev in events:
            obj = {k: jsonable(v) for k, v in ev.values.items()}
            obj["time"] = ev.time
            obj["diff"] = ev.diff
            rows.append(obj)
        step = self.max_batch_size or len(rows) or 1
        for i in range(0, len(rows), step):
            errors = self.client.insert_rows_json(
                self.table_ref, rows[i : i + step]
            )
            if errors:
                raise RuntimeError(f"BigQuery insert errors: {errors}")


def write(
    table,
    dataset_name: str,
    table_name: str,
    service_user_credentials_file: str | None = None,
    *,
    max_batch_size: int | None = None,
    name: str | None = None,
    _client=None,
    **kwargs,
) -> None:
    """Stream change-stream rows into a BigQuery table (reference:
    io/bigquery write:57)."""
    if _client is None:
        try:
            from google.cloud import bigquery  # type: ignore
            from google.oauth2.service_account import Credentials  # type: ignore
        except ImportError:
            raise ImportError(
                "pw.io.bigquery requires google-cloud-bigquery; install it or "
                "inject a client via _client"
            )
        creds = (
            Credentials.from_service_account_file(service_user_credentials_file)
            if service_user_credentials_file
            else None
        )
        _client = bigquery.Client(credentials=creds)
    attach_writer(
        table,
        BigQueryWriter(
            _client, f"{dataset_name}.{table_name}", max_batch_size=max_batch_size
        ),
        name=name,
    )
