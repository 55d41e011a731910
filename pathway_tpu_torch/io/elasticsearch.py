"""pw.io.elasticsearch — Elasticsearch sink (reference:
python/pathway/io/elasticsearch write:89, ElasticSearchAuth:16; Rust
Elasticsearch writer in src/connectors/data_storage.rs)."""

from __future__ import annotations

from typing import Sequence

from pathway_tpu_torch.io._writer import OutputWriter, RowEvent, attach_writer, jsonable


class ElasticSearchAuth:
    """Auth settings holder (reference: io/elasticsearch:16)."""

    def __init__(self, kind: str, **kwargs):
        self.kind = kind
        self.kwargs = kwargs

    @classmethod
    def basic(cls, username: str, password: str):
        return cls("basic", username=username, password=password)

    @classmethod
    def apikey(cls, apikey_id: str, apikey: str):
        return cls("apikey", apikey_id=apikey_id, apikey=apikey)

    @classmethod
    def bearer(cls, bearer: str):
        return cls("bearer", bearer=bearer)

    def as_client_kwargs(self) -> dict:
        if self.kind == "basic":
            return {"basic_auth": (self.kwargs["username"], self.kwargs["password"])}
        if self.kind == "apikey":
            return {"api_key": (self.kwargs["apikey_id"], self.kwargs["apikey"])}
        if self.kind == "bearer":
            return {"bearer_auth": self.kwargs["bearer"]}
        return {}


class ElasticsearchWriter(OutputWriter):
    def __init__(self, client, index_name: str):
        self.client = client
        self.index_name = index_name

    def write_batch(self, events: Sequence[RowEvent]) -> None:
        for ev in events:
            doc = {k: jsonable(v) for k, v in ev.values.items()}
            doc["time"] = ev.time
            doc["diff"] = ev.diff
            self.client.index(index=self.index_name, document=doc)

    def close(self) -> None:
        close = getattr(self.client, "close", None)
        if close:
            close()


def write(
    table,
    host: str,
    auth: ElasticSearchAuth | None,
    index_name: str,
    *,
    name: str | None = None,
    _client=None,
    **kwargs,
) -> None:
    """Index each change-stream delta as a document (reference:
    io/elasticsearch write:89)."""
    if _client is None:
        try:
            from elasticsearch import Elasticsearch  # type: ignore
        except ImportError:
            raise ImportError(
                "pw.io.elasticsearch requires the elasticsearch package; "
                "install it or inject a client via _client"
            )
        _client = Elasticsearch(
            host, **(auth.as_client_kwargs() if auth else {})
        )
    attach_writer(table, ElasticsearchWriter(_client, index_name), name=name)
