"""pw.io.gdrive — Google Drive connector (reference:
python/pathway/io/gdrive — _GDriveClient:73, _GDriveTree:237,
_GDriveSubject:261; polls a folder tree, emits file payloads with metadata,
detects modifications and deletions).

The google-api-python-client is optional/gated; tests may inject a client
implementing `tree(root_id) -> {file_id: meta}` and `download(meta) -> bytes`
via `_client_factory`.
"""

from __future__ import annotations

import time as time_mod
from typing import Any, Dict, Optional

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import ColumnSchema, schema_from_columns
from pathway_tpu_torch.io._connector_runtime import (
    ConnectorSubjectBase,
    connector_table,
)

_DEFAULT_MIME_TYPE_MAPPING = {
    "application/vnd.google-apps.document": (
        "application/vnd.openxmlformats-officedocument.wordprocessingml.document"
    ),
    "application/vnd.google-apps.spreadsheet": (
        "application/vnd.openxmlformats-officedocument.spreadsheetml.sheet"
    ),
    "application/vnd.google-apps.presentation": (
        "application/vnd.openxmlformats-officedocument.presentationml.presentation"
    ),
}


class _GDriveApiClient:
    """Thin adapter over googleapiclient (reference: _GDriveClient:73)."""

    def __init__(self, credentials_file: str):
        try:
            from google.oauth2.service_account import Credentials  # type: ignore
            from googleapiclient.discovery import build  # type: ignore
        except ImportError:
            raise ImportError(
                "pw.io.gdrive requires google-api-python-client and "
                "google-auth; install them or inject _client_factory"
            )
        creds = Credentials.from_service_account_file(
            credentials_file, scopes=["https://www.googleapis.com/auth/drive.readonly"]
        )
        self.service = build("drive", "v3", credentials=creds)

    def tree(self, root_id: str) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        stack = [root_id]
        while stack:
            parent = stack.pop()
            page_token = None
            while True:
                resp = (
                    self.service.files()
                    .list(
                        q=f"'{parent}' in parents and trashed = false",
                        fields="nextPageToken, files(id, name, mimeType, modifiedTime, size)",
                        pageToken=page_token,
                    )
                    .execute()
                )
                for f in resp.get("files", []):
                    if f["mimeType"] == "application/vnd.google-apps.folder":
                        stack.append(f["id"])
                    else:
                        out[f["id"]] = f
                page_token = resp.get("nextPageToken")
                if page_token is None:
                    break
        return out

    def download(self, meta: dict) -> bytes:
        mime = meta.get("mimeType", "")
        if mime in _DEFAULT_MIME_TYPE_MAPPING:
            req = self.service.files().export_media(
                fileId=meta["id"], mimeType=_DEFAULT_MIME_TYPE_MAPPING[mime]
            )
        else:
            req = self.service.files().get_media(fileId=meta["id"])
        return req.execute()


class _GDriveSubject(ConnectorSubjectBase):
    """(reference: _GDriveSubject:261 — poll loop with deletions)"""

    def __init__(self, client_factory, object_id, mode, refresh_interval, with_metadata):
        super().__init__()
        self.client_factory = client_factory
        self.object_id = object_id
        self.mode = mode
        self.refresh_interval = refresh_interval
        self.with_metadata = with_metadata
        self._seen: Dict[str, dict] = {}

    def _row(self, meta: dict, payload: bytes) -> dict:
        row = {"data": payload}
        if self.with_metadata:
            from pathway_tpu_torch.engine.value import Json

            row["_metadata"] = Json(
                {
                    "id": meta.get("id"),
                    "name": meta.get("name"),
                    "mimeType": meta.get("mimeType"),
                    "modifiedTime": meta.get("modifiedTime"),
                    "seen_at": int(time_mod.time()),
                    "url": f"https://drive.google.com/file/d/{meta.get('id')}/view",
                    "status": "loaded",
                }
            )
        return row

    def run(self) -> None:
        client = self.client_factory()
        first_poll = True
        while True:
            tree = client.tree(self.object_id)
            changed = False
            cache = self._object_cache
            if first_poll and cache is not None:
                # files deleted while the pipeline was down never enter
                # _seen — reconcile the persistent cache against the
                # remote listing once so stale blobs don't accumulate
                for stale_id in set(cache.list_objects()) - set(tree):
                    cache.evict(stale_id)
            first_poll = False
            for fid, meta in tree.items():
                old = self._seen.get(fid)
                version = meta.get("modifiedTime")
                if old is not None and old["meta"].get("modifiedTime") == version:
                    continue
                # persistence-backed object cache: a restart re-serves
                # unchanged files without re-downloading (reference:
                # cached_object_storage.rs)
                payload = cache.get(fid, version) if cache is not None else None
                if payload is None:
                    payload = client.download(meta)
                    if cache is not None:
                        cache.put(fid, version, payload)
                if old is not None:
                    # retract the exact row emitted earlier (same seen_at)
                    self._remove(old["row"])
                row = self._row(meta, payload)
                self._seen[fid] = {"meta": meta, "row": row}
                self.next(**row)
                changed = True
            for fid in list(self._seen):
                if fid not in tree:
                    old = self._seen.pop(fid)
                    self._remove(old["row"])
                    if cache is not None:
                        cache.evict(fid)
                    changed = True
            if changed:
                self.commit()
            if self.mode == "static":
                return
            time_mod.sleep(self.refresh_interval)


def read(
    object_id: str,
    *,
    mode: str = "streaming",
    object_size_limit: int | None = None,
    service_user_credentials_file: str | None = None,
    with_metadata: bool = False,
    refresh_interval: float = 30.0,
    name: str | None = None,
    _client_factory=None,
    **kwargs,
):
    """Read files from a Drive folder/file id (reference: io/gdrive read)."""
    cols = {"data": ColumnSchema(name="data", dtype=dt.BYTES)}
    if with_metadata:
        cols["_metadata"] = ColumnSchema(name="_metadata", dtype=dt.JSON)
    schema = schema_from_columns(cols, name="GDriveSchema")
    if _client_factory is None:

        def _client_factory():
            return _GDriveApiClient(service_user_credentials_file)

    def factory():
        return _GDriveSubject(
            _client_factory, object_id, mode, refresh_interval, with_metadata
        )

    # stable default name: persistence scopes (input snapshots, the
    # source-object cache) must survive restarts, and the global
    # source_<n> counter does not
    return connector_table(
        schema, factory, mode=mode, name=name or f"gdrive_{object_id}"
    )
