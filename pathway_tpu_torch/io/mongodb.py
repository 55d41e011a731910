"""pw.io.mongodb — MongoDB sink (reference: python/pathway/io/mongodb
write:17; Rust side Bson formatter data_format.rs:2257 + MongoDB writer)."""

from __future__ import annotations

from typing import Sequence

from pathway_tpu_torch.io._writer import OutputWriter, RowEvent, attach_writer, jsonable


class MongoWriter(OutputWriter):
    def __init__(self, collection, max_batch_size: int | None = None):
        self.collection = collection
        self.max_batch_size = max_batch_size

    def write_batch(self, events: Sequence[RowEvent]) -> None:
        docs = []
        for ev in events:
            doc = {k: jsonable(v) for k, v in ev.values.items()}
            doc["time"] = ev.time
            doc["diff"] = ev.diff
            docs.append(doc)
        step = self.max_batch_size or len(docs) or 1
        for i in range(0, len(docs), step):
            self.collection.insert_many(docs[i : i + step])


def write(
    table,
    *,
    connection_string: str | None = None,
    database: str | None = None,
    collection: str | None = None,
    max_batch_size: int | None = None,
    name: str | None = None,
    _collection=None,
    **kwargs,
) -> None:
    """Append change-stream documents to a MongoDB collection (reference:
    io/mongodb write:17)."""
    if _collection is None:
        try:
            from pymongo import MongoClient  # type: ignore
        except ImportError:
            raise ImportError(
                "pw.io.mongodb requires pymongo; install it or inject a "
                "collection via _collection"
            )
        client = MongoClient(connection_string)
        _collection = client[database][collection]
    attach_writer(
        table, MongoWriter(_collection, max_batch_size=max_batch_size), name=name
    )
