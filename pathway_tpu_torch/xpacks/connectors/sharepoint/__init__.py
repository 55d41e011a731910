"""SharePoint file source (reference:
python/pathway/xpacks/connectors/sharepoint/__init__.py read:255 —
certificate-authenticated Office365 client, polling scanner with
modify/delete detection, binary `data` column + optional `_metadata`).

The Office365 client is optional and injectable: production passes
tenant/client_id/cert credentials (requires Office365-REST-Python-Client),
tests inject `_client_factory` returning any object with
`list_files(root_path, recursive) -> [(path, modified_at, created_at,
size)]` and `download(path) -> bytes`."""

from __future__ import annotations

import time as time_mod
from typing import Any, Callable, Dict, Optional, Tuple

from pathway_tpu_torch.engine.value import Json
from pathway_tpu_torch.internals.schema import schema_from_types
from pathway_tpu_torch.io._connector_runtime import (
    ConnectorSubjectBase,
    connector_table,
)


class _Office365Client:
    """Thin adapter over Office365-REST-Python-Client (gated)."""

    def __init__(self, url, tenant, client_id, thumbprint, cert_path):
        try:
            from office365.sharepoint.client_context import (  # type: ignore
                ClientContext,
            )
        except ImportError as exc:
            raise ImportError(
                "pw.xpacks.connectors.sharepoint requires "
                "Office365-REST-Python-Client; install it or inject "
                "_client_factory"
            ) from exc
        self._ctx = ClientContext(url).with_client_certificate(
            tenant=tenant,
            client_id=client_id,
            thumbprint=thumbprint,
            cert_path=cert_path,
        )

    def list_files(self, root_path: str, recursive: bool):
        folder = self._ctx.web.get_folder_by_server_relative_url(root_path)
        out = []
        stack = [folder]
        while stack:
            current = stack.pop()
            self._ctx.load(current.files)
            self._ctx.load(current.folders)
            self._ctx.execute_query()
            for f in current.files:
                out.append(
                    (
                        f.serverRelativeUrl,
                        f.time_last_modified.timestamp(),
                        f.time_created.timestamp(),
                        f.length,
                    )
                )
            if recursive:
                stack.extend(list(current.folders))
        return out

    def download(self, path: str) -> bytes:
        import io

        buf = io.BytesIO()
        (
            self._ctx.web.get_file_by_server_relative_url(path)
            .download(buf)
            .execute_query()
        )
        return buf.getvalue()


class _SharePointSubject(ConnectorSubjectBase):
    def __init__(
        self,
        client_factory: Callable[[], Any],
        root_path: str,
        *,
        mode: str,
        recursive: bool,
        with_metadata: bool,
        object_size_limit: int | None,
        refresh_interval: float,
        max_failed_attempts_in_row: int | None,
    ):
        super().__init__()
        self.client_factory = client_factory
        self.root_path = root_path
        self.mode = mode
        self.recursive = recursive
        self.with_metadata = with_metadata
        self.object_size_limit = object_size_limit
        self.refresh_interval = refresh_interval
        self.max_failed = max_failed_attempts_in_row
        # path -> (modified_at, row) for update/delete detection
        self._seen: Dict[str, Tuple[float, dict]] = {}

    def _row(self, payload: bytes, path: str, modified, created) -> dict:
        row = {"data": payload}
        if self.with_metadata:
            row["_metadata"] = Json(
                {
                    "path": path,
                    "modified_at": int(modified),
                    "created_at": int(created),
                    "size": len(payload),
                }
            )
        return row

    def run(self) -> None:
        client = self.client_factory()
        failures = 0
        while True:
            try:
                listing = client.list_files(self.root_path, self.recursive)
                failures = 0
            except Exception:  # noqa: BLE001
                failures += 1
                if self.max_failed is not None and failures >= self.max_failed:
                    raise
                time_mod.sleep(self.refresh_interval)
                continue
            current_paths = set()
            for path, modified, created, size in listing:
                current_paths.add(path)
                if (
                    self.object_size_limit is not None
                    and size > self.object_size_limit
                ):
                    continue
                prev = self._seen.get(path)
                if prev is not None and prev[0] == modified:
                    continue
                cache = self._object_cache
                payload = (
                    cache.get(path, modified) if cache is not None else None
                )
                if payload is None:
                    payload = client.download(path)
                    if cache is not None:
                        cache.put(path, modified, payload)
                row = self._row(payload, path, modified, created)
                if prev is not None:
                    self._remove(prev[1])
                self.next(**row)
                self._seen[path] = (modified, row)
            for path in list(self._seen):
                if path not in current_paths:
                    _mtime, row = self._seen.pop(path)
                    self._remove(row)
                    if self._object_cache is not None:
                        self._object_cache.evict(path)
            self.commit()
            if self.mode == "static":
                return
            time_mod.sleep(self.refresh_interval)

    def _persisted_state(self):
        # the full rows persist (payload included): retracting a modified/
        # deleted file after a restart needs the OLD row's values, exactly
        # why the reference caches source objects for recovery
        # (src/persistence/cached_object_storage.rs)
        return {"seen": dict(self._seen)}

    def _restore_persisted_state(self, state) -> None:
        if not state:
            return
        if "seen" in state:
            self._seen.update(state["seen"])
        elif "seen_mtimes" in state:
            # legacy cursor (mtimes only): keep it so unchanged files are
            # not re-downloaded/re-emitted on top of the snapshot replay;
            # the known limitation is that a file modified later cannot
            # retract its pre-upgrade row (no cached payload)
            for p, m in state["seen_mtimes"].items():
                self._seen.setdefault(p, (m, {}))


def read(
    url: str = "",
    *,
    tenant: str = "",
    client_id: str = "",
    cert_path: str = "",
    thumbprint: str = "",
    root_path: str,
    mode: str = "streaming",
    recursive: bool = True,
    object_size_limit: int | None = None,
    with_metadata: bool = False,
    refresh_interval: float = 30,
    max_failed_attempts_in_row: int | None = 8,
    _client_factory: Callable[[], Any] | None = None,
    name: str | None = None,
):
    """reference: sharepoint/__init__.py read:255 (binary `data` column,
    optional `_metadata`)."""
    if _client_factory is None:
        def _client_factory():
            return _Office365Client(
                url, tenant, client_id, thumbprint, cert_path
            )

    schema_cols: dict = {"data": bytes}
    if with_metadata:
        schema_cols["_metadata"] = Json
    schema = schema_from_types(**schema_cols)

    def factory():
        return _SharePointSubject(
            _client_factory,
            root_path,
            mode=mode,
            recursive=recursive,
            with_metadata=with_metadata,
            object_size_limit=object_size_limit,
            refresh_interval=refresh_interval,
            max_failed_attempts_in_row=max_failed_attempts_in_row,
        )

    return connector_table(
        schema,
        factory,
        mode=mode,
        # site url + path: two sites sharing a root_path must not share a
        # persistence scope (object cache / input snapshots)
        name=name or f"sharepoint_{url}_{root_path}",
        exclusive=True
    )
