"""Storage backend abstraction for the data-lake connectors.

The reference opens Delta/Iceberg tables over local disk, S3, or Azure via
storage options (reference: src/connectors/data_lake/delta.rs:215,273 —
`register_handlers`/storage options resolution). Here the same role is
played by a small filesystem interface: the lake modules speak
root-relative POSIX paths and every byte goes through a `LakeFS`, so a
table at ``s3://bucket/prefix`` uses the identical commit protocol as one
at ``/data/table``.

Object stores have no atomic rename; single-writer-per-table is assumed
(the reference's delta-rs makes the same assumption for S3 without a
locking client).
"""

from __future__ import annotations

import os
from typing import List


class LakeFS:
    """Minimal filesystem surface the lake formats need. Paths are
    POSIX-style and relative to the table root."""

    display_uri: str

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        """Atomically publish `data` at `path` (tmp+rename locally,
        single put on object stores)."""
        raise NotImplementedError

    def listdir(self, dirpath: str) -> List[str]:
        """Immediate child names of a directory; [] when absent."""
        raise NotImplementedError

    def makedirs(self, dirpath: str) -> None:
        raise NotImplementedError

    def mtime(self, path: str) -> float | None:
        """Modification time, or None when the backend cannot provide one
        (object stores) — callers must treat None as 'unknown', never as
        epoch 0."""
        raise NotImplementedError


class LocalLakeFS(LakeFS):
    def __init__(self, root: str):
        self.root = root
        self.display_uri = os.path.abspath(root)

    def _p(self, path: str) -> str:
        return os.path.join(self.root, *path.split("/")) if path else self.root

    def read_bytes(self, path: str) -> bytes:
        with open(self._p(path), "rb") as fh:
            return fh.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        full = self._p(path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        tmp = full + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.rename(tmp, full)

    def listdir(self, dirpath: str) -> List[str]:
        full = self._p(dirpath)
        if not os.path.isdir(full):
            return []
        return os.listdir(full)

    def makedirs(self, dirpath: str) -> None:
        os.makedirs(self._p(dirpath), exist_ok=True)

    def mtime(self, path: str) -> float | None:
        try:
            return os.path.getmtime(self._p(path))
        except OSError:
            return None  # unknown, NOT epoch 0


class ObjectLakeFS(LakeFS):
    """Lake over any object client with put/get/list (boto3 S3, Azure
    blobs, or an injected in-memory fake — the same client interface the
    persistence layer's ObjectStoreBackend uses)."""

    def __init__(self, client, prefix: str, display_uri: str):
        self.client = client
        self.prefix = prefix.strip("/")
        self.display_uri = display_uri

    def _k(self, path: str) -> str:
        return f"{self.prefix}/{path}" if self.prefix else path

    def read_bytes(self, path: str) -> bytes:
        data = self.client.get(self._k(path))
        if data is None:
            raise FileNotFoundError(self._k(path))
        return data

    def write_bytes(self, path: str, data: bytes) -> None:
        self.client.put(self._k(path), data)

    def listdir(self, dirpath: str) -> List[str]:
        prefix = self._k(dirpath).rstrip("/") + "/"
        names = set()
        for key in self.client.list(prefix):
            rest = key[len(prefix):]
            if rest:
                names.add(rest.split("/", 1)[0])
        return sorted(names)

    def makedirs(self, dirpath: str) -> None:
        pass  # object stores have no directories

    def mtime(self, path: str) -> float | None:
        return None  # commitInfo timestamps are authoritative on stores


def _split_bucket_uri(uri: str, scheme: str) -> tuple[str, str]:
    rest = uri[len(scheme):]
    bucket, _, prefix = rest.partition("/")
    if not bucket:
        raise ValueError(f"{uri!r}: missing bucket/container name")
    return bucket, prefix.strip("/")


def resolve_lake_fs(
    uri: str,
    *,
    s3_connection_settings=None,
    _object_client=None,
) -> LakeFS:
    """Map a table URI to a backend: ``s3://`` / ``az://`` to an object
    store (credentials via `s3_connection_settings`, the io.s3 settings
    object; `_object_client` injects a ready client, used by tests),
    anything else to the local filesystem."""
    if uri.startswith("s3://"):
        bucket, prefix = _split_bucket_uri(uri, "s3://")
        if _object_client is None:
            kwargs = (
                s3_connection_settings.boto3_kwargs()
                if s3_connection_settings is not None
                else {}
            )
            from pathway_tpu_torch.persistence import _Boto3ObjectClient

            _object_client = _Boto3ObjectClient(bucket, **kwargs)
        return ObjectLakeFS(_object_client, prefix, uri)
    if uri.startswith(("az://", "azure://")):
        scheme = "az://" if uri.startswith("az://") else "azure://"
        container, prefix = _split_bucket_uri(uri, scheme)
        if _object_client is None:
            conn = os.environ.get("AZURE_STORAGE_CONNECTION_STRING")
            if not conn:
                raise ValueError(
                    f"{uri!r}: Azure lakes need credentials — set "
                    "AZURE_STORAGE_CONNECTION_STRING (the azure-sdk "
                    "convention) or inject a client"
                )
            from pathway_tpu_torch.persistence import _AzureBlobClient

            _object_client = _AzureBlobClient(
                container, connection_string=conn
            )
        return ObjectLakeFS(_object_client, prefix, uri)
    return LocalLakeFS(uri)


def as_fs(fs_or_uri) -> LakeFS:
    """Coerce a LakeFS or URI/path to a LakeFS."""
    if isinstance(fs_or_uri, LakeFS):
        return fs_or_uri
    return resolve_lake_fs(fs_or_uri)


def write_parquet(fs: LakeFS, path: str, table) -> int:
    """Serialize an arrow table and publish it; returns the byte size."""
    import io as io_mod

    import pyarrow.parquet as pq

    sink = io_mod.BytesIO()
    pq.write_table(table, sink)
    data = sink.getvalue()
    fs.write_bytes(path, data)
    return len(data)


def read_parquet(fs: LakeFS, path: str):
    import io as io_mod

    import pyarrow.parquet as pq

    return pq.read_table(io_mod.BytesIO(fs.read_bytes(path)))
