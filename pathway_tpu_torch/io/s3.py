"""pw.io.s3 — S3 object-store connector (reference: python/pathway/io/s3 —
AwsS3Settings, read:95, read_from_digital_ocean:320, read_from_wasabi:459;
Rust scanner src/connectors/scanner/s3.rs, StorageType S3Csv/S3Lines).

Object listing/fetching goes through an `S3Client` interface: boto3 if
installed, or any injected client (tests use an in-memory fake). Parsing
mirrors the fs connector: csv / json / plaintext / plaintext_by_object /
binary.
"""

from __future__ import annotations

import csv as csv_mod
import io as io_mod
import json
import time as time_mod
from typing import Dict, Iterable, List, Optional, Tuple

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import ColumnSchema, schema_from_columns
from pathway_tpu_torch.io._connector_runtime import (
    ConnectorSubjectBase,
    connector_table,
)
from pathway_tpu_torch.io._formats import parse_object
from pathway_tpu_torch.io.fs import (
    _binary_schema,
    _plaintext_schema,
    _with_metadata,
)


class AwsS3Settings:
    """Connection settings (reference: io/s3 AwsS3Settings)."""

    def __init__(
        self,
        *,
        bucket_name: str | None = None,
        access_key: str | None = None,
        secret_access_key: str | None = None,
        with_path_style: bool = False,
        region: str | None = None,
        endpoint: str | None = None,
    ):
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.with_path_style = with_path_style
        self.region = region
        self.endpoint = endpoint

    def boto3_kwargs(self) -> dict:
        """boto3.client("s3", ...) keyword mapping — the single place the
        settings-to-boto3 translation lives (shared with the lake
        connectors' resolve_lake_fs)."""
        return {
            "aws_access_key_id": self.access_key,
            "aws_secret_access_key": self.secret_access_key,
            "region_name": self.region,
            "endpoint_url": self.endpoint,
        }

    def create_client(self):
        try:
            import boto3  # type: ignore
        except ImportError:
            raise ImportError(
                "pw.io.s3 requires boto3; install it or inject a client via "
                "_client_factory"
            )
        return _Boto3Client(
            boto3.client("s3", **self.boto3_kwargs()),
            self.bucket_name,
        )


class DigitalOceanS3Settings(AwsS3Settings):
    """DigitalOcean Spaces (reference: io/s3 DigitalOceanS3Settings:23)."""


class WasabiS3Settings(AwsS3Settings):
    """Wasabi (reference: io/s3 WasabiS3Settings:58)."""


class S3Client:
    """list_objects(prefix) -> [(key, etag/mtime)]; get_object(key) -> bytes."""

    def list_objects(self, prefix: str) -> List[Tuple[str, str]]:
        raise NotImplementedError

    def get_object(self, key: str) -> bytes:
        raise NotImplementedError


class _Boto3Client(S3Client):
    def __init__(self, client, bucket: str):
        self.client = client
        self.bucket = bucket

    def list_objects(self, prefix: str):
        out = []
        paginator = self.client.get_paginator("list_objects_v2")
        for page in paginator.paginate(Bucket=self.bucket, Prefix=prefix):
            for obj in page.get("Contents", []):
                out.append((obj["Key"], obj.get("ETag", str(obj.get("LastModified", "")))))
        return out

    def get_object(self, key: str) -> bytes:
        resp = self.client.get_object(Bucket=self.bucket, Key=key)
        return resp["Body"].read()


class _S3Subject(ConnectorSubjectBase):
    def __init__(self, client_factory, prefix, format, schema, mode, with_metadata, refresh_interval=1.0, csv_settings=None, json_field_paths=None):
        super().__init__()
        self.client_factory = client_factory
        self.prefix = prefix
        self.format = format
        self.schema = schema
        self.mode = mode
        self.with_metadata = with_metadata
        self.refresh_interval = refresh_interval
        self.csv_settings = csv_settings
        self.json_field_paths = json_field_paths
        self._seen: Dict[str, str] = {}

    def _emit_object(self, key: str, payload: bytes) -> None:
        meta = {}
        if self.with_metadata:
            from pathway_tpu_torch.engine.value import Json

            meta = {
                "_metadata": Json(
                    {"path": key, "size": len(payload), "seen_at": int(time_mod.time())}
                )
            }
        for row in parse_object(
            payload, self.format, self.schema,
            csv_settings=self.csv_settings,
            json_field_paths=self.json_field_paths,
        ):
            self.next(**row, **meta)

    def run(self) -> None:
        client = self.client_factory()
        while True:
            for key, version in client.list_objects(self.prefix):
                if self._seen.get(key) == version:
                    continue
                self._seen[key] = version
                self._emit_object(key, client.get_object(key))
            self.commit()
            if self.mode == "static":
                return
            time_mod.sleep(self.refresh_interval)

    def _persisted_state(self):
        return {"seen": dict(self._seen)}

    def _restore_persisted_state(self, state) -> None:
        if state and "seen" in state:
            self._seen.update(state["seen"])


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    format: str = "csv",
    schema=None,
    mode: str = "streaming",
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    refresh_interval: float = 1.0,
    csv_settings=None,
    json_field_paths=None,
    _client_factory=None,
    **kwargs,
):
    """Read objects under an S3 path as a table (reference: io/s3 read:95).

    `path` may be "s3://bucket/prefix" or a bare prefix when the bucket is
    set in the settings.
    """
    prefix = path
    if path.startswith("s3://"):
        rest = path[len("s3://") :]
        bucket, _, prefix = rest.partition("/")
        if aws_s3_settings is None:
            aws_s3_settings = AwsS3Settings(bucket_name=bucket)
        elif aws_s3_settings.bucket_name is None:
            aws_s3_settings.bucket_name = bucket
    if schema is None:
        if format in ("plaintext", "plaintext_by_object"):
            schema = _plaintext_schema()
        elif format == "binary":
            schema = _binary_schema()
        else:
            raise ValueError(f"schema required for format {format!r}")
    out_schema = _with_metadata(schema) if with_metadata else schema
    if _client_factory is None:
        settings = aws_s3_settings or AwsS3Settings()

        def _client_factory():
            return settings.create_client()

    def factory():
        return _S3Subject(
            _client_factory,
            prefix,
            format,
            schema,
            mode,
            with_metadata,
            refresh_interval=refresh_interval,
            csv_settings=csv_settings,
            json_field_paths=json_field_paths,
        )

    return connector_table(out_schema, factory, mode=mode, name=name)


def read_from_digital_ocean(
    path: str,
    do_s3_settings: DigitalOceanS3Settings,
    *,
    format: str = "csv",
    schema=None,
    mode: str = "streaming",
    **kwargs,
):
    """(reference: io/s3 read_from_digital_ocean:320)"""
    return read(
        path, aws_s3_settings=do_s3_settings, format=format, schema=schema, mode=mode, **kwargs
    )


def read_from_wasabi(
    path: str,
    wasabi_s3_settings: WasabiS3Settings,
    *,
    format: str = "csv",
    schema=None,
    mode: str = "streaming",
    **kwargs,
):
    """(reference: io/s3 read_from_wasabi:459)"""
    return read(
        path, aws_s3_settings=wasabi_s3_settings, format=format, schema=schema, mode=mode, **kwargs
    )
