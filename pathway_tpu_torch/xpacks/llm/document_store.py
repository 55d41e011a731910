"""DocumentStore: sources → parse → post-process → split → index
(reference: python/pathway/xpacks/llm/document_store.py DocumentStore:53,
build_pipeline:319, retrieve_query:530, statistics_query:409,
inputs_query:453)."""

from __future__ import annotations

import json
from typing import Any, Callable, Iterable, List, Optional

from pathway_tpu_torch.engine.value import Json
from pathway_tpu_torch.internals import api as pw_api
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.internals.table import Table


class DocumentStore:
    """reference: document_store.py DocumentStore:53."""

    class RetrieveQuerySchema(Schema):
        query: str
        k: int
        metadata_filter: Optional[str]
        filepath_globpattern: Optional[str]

    class StatisticsQuerySchema(Schema):
        pass

    class InputsQuerySchema(Schema):
        metadata_filter: Optional[str]
        filepath_globpattern: Optional[str]

    class QueryResultSchema(Schema):
        result: Json

    def __init__(
        self,
        docs,
        retriever_factory,
        parser=None,
        splitter=None,
        doc_post_processors: List[Callable] | None = None,
    ):
        from pathway_tpu_torch.xpacks.llm.parsers import Utf8Parser
        from pathway_tpu_torch.xpacks.llm.splitters import NullSplitter

        if isinstance(docs, Table):
            docs = [docs]
        self.docs_tables = list(docs)
        self.retriever_factory = retriever_factory
        self.parser = parser or Utf8Parser()
        self.splitter = splitter or NullSplitter()
        self.doc_post_processors = doc_post_processors or []
        self.build_pipeline()

    # -- pipeline ---------------------------------------------------------
    def build_pipeline(self) -> None:
        """reference: document_store.py build_pipeline:319."""
        normalized = []
        for t in self.docs_tables:
            cols = {"data": t.data}
            if "_metadata" in t.column_names():
                cols["_metadata"] = t._metadata
            else:
                cols["_metadata"] = Json({})
            normalized.append(t.select(**cols))
        docs = normalized[0]
        if len(normalized) > 1:
            docs = docs.concat_reindex(*normalized[1:])
        self.input_docs = docs

        parsed = docs.select(
            parts=self.parser(docs.data), _metadata=docs._metadata
        ).flatten(thisclass.this.parts)
        parsed = parsed.select(
            text=parsed.parts.get(0),
            metadata=pw_api.apply_with_type(
                _merge_meta, Json, parsed._metadata, parsed.parts.get(1)
            ),
        )
        for post in self.doc_post_processors:
            parsed = parsed.select(
                text=pw_api.apply_with_type(
                    lambda t, m, post=post: post(t, m)[0], str,
                    parsed.text, parsed.metadata,
                ),
                metadata=pw_api.apply_with_type(
                    lambda t, m, post=post: Json(post(t, m)[1]), Json,
                    parsed.text, parsed.metadata,
                ),
            )

        from pathway_tpu_torch.xpacks.llm.splitters import NullSplitter

        if type(self.splitter) is NullSplitter:
            # a null split is one chunk per document with metadata passed
            # through — the split/flatten/repack stages would only rebuild
            # identical rows (bulk-ingest host path stays O(1) per doc)
            self.chunked_docs = parsed
        else:
            chunked = parsed.select(
                chunks=self.splitter(parsed.text, parsed.metadata),
            ).flatten(thisclass.this.chunks)
            self.chunked_docs = chunked.select(
                text=chunked.chunks.get(0),
                metadata=pw_api.apply_with_type(
                    lambda m: Json(
                        m if isinstance(m, dict) else getattr(m, "value", {})
                    ),
                    Json,
                    chunked.chunks.get(1),
                ),
            )
        self._index = self.retriever_factory.build_index(
            self.chunked_docs.text,
            self.chunked_docs,
            metadata_column=self.chunked_docs.metadata,
        )

    @property
    def index(self):
        return self._index

    @staticmethod
    def merge_filters(queries: Table) -> Table:
        """Fold filepath_globpattern into the metadata filter (reference:
        document_store.py merge_filters)."""
        return queries.select(
            thisclass.this.without("metadata_filter", "filepath_globpattern"),
            metadata_filter=pw_api.apply_with_type(
                _combined_filter,
                Optional[str],
                queries.metadata_filter,
                queries.filepath_globpattern,
            ),
        )

    # -- endpoints --------------------------------------------------------
    def retrieve_query(self, retrieval_queries: Table) -> Table:
        """reference: document_store.py retrieve_query:530."""
        queries = self.merge_filters(retrieval_queries)
        reply = self._index.query_as_of_now(
            queries.query,
            number_of_matches=queries.k,
            metadata_filter=queries.metadata_filter,
            collapse_rows=True,
        )
        result = reply.select(
            result=pw_api.apply_with_type(
                _pack_retrieval_results,
                Json,
                reply.text,
                reply.metadata,
                reply._pw_index_reply_score,
            )
        )
        return result

    def statistics_query(self, info_queries: Table) -> Table:
        """reference: document_store.py statistics_query:409."""
        stats = self.input_docs.reduce(
            count=reducers.count(),
            metas=reducers.tuple(self.input_docs._metadata),
        )

        def pack_stats(count, metas):
            modified = [
                m.value.get("modified_at")
                for m in (metas or ())
                if isinstance(m, Json) and isinstance(m.value, dict)
                and m.value.get("modified_at") is not None
            ]
            seen = [
                m.value.get("seen_at")
                for m in (metas or ())
                if isinstance(m, Json) and isinstance(m.value, dict)
                and m.value.get("seen_at") is not None
            ]
            return Json(
                {
                    "file_count": count,
                    "last_modified": max(modified) if modified else None,
                    "last_indexed": max(seen) if seen else None,
                }
            )

        packed = stats.select(
            result=pw_api.apply_with_type(
                pack_stats, Json, stats.count, stats.metas
            )
        )
        joined = info_queries.join(
            packed, id=__import__('pathway_tpu_torch').left.id
        ).select(result=packed.result)
        return joined

    def inputs_query(self, input_queries: Table) -> Table:
        """reference: document_store.py inputs_query:453."""
        queries = self.merge_filters(input_queries)
        files = self.input_docs.reduce(
            metas=reducers.tuple(self.input_docs._metadata)
        )

        def pack_inputs(metas, metadata_filter):
            from pathway_tpu_torch.stdlib.indexing._filters import evaluate_filter

            out = []
            for m in metas or ():
                value = m.value if isinstance(m, Json) else m
                if metadata_filter and not evaluate_filter(
                    metadata_filter, value
                ):
                    continue
                out.append(value)
            return Json(out)

        joined = queries.join(
            files, id=__import__('pathway_tpu_torch').left.id
        ).select(
            result=pw_api.apply_with_type(
                pack_inputs, Json, files.metas, queries.metadata_filter
            )
        )
        return joined


class SlidesDocumentStore(DocumentStore):
    """reference: document_store.py SlidesDocumentStore:575."""


class DocumentStoreClient:
    """HTTP client for a served DocumentStore (reference:
    document_store.py DocumentStoreClient:636)."""

    def __init__(self, host: str | None = None, port: int | None = None, url: str | None = None, timeout: int = 30):
        if url is None:
            url = f"http://{host}:{port}"
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _post(self, route: str, payload: dict):
        import urllib.request

        req = urllib.request.Request(
            self.url + route,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def retrieve(self, query: str, k: int = 3, metadata_filter: str | None = None, filepath_globpattern: str | None = None):
        return self._post(
            "/v1/retrieve",
            {
                "query": query,
                "k": k,
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )

    __call__ = retrieve

    def statistics(self):
        return self._post("/v1/statistics", {})

    def get_input_files(self, metadata_filter: str | None = None, filepath_globpattern: str | None = None):
        return self._post(
            "/v1/inputs",
            {
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )


def _merge_meta(doc_meta, part_meta) -> Json:
    # bulk-ingest fast path: parsers without per-chunk metadata (Utf8 on
    # the hot path) pass the document metadata through untouched — no new
    # Json per row.  Only for dict-valued metadata: non-dicts must still
    # normalize to Json({}) like the slow path.
    if (
        (not part_meta or (isinstance(part_meta, Json) and not part_meta.value))
        and isinstance(doc_meta, Json)
        and isinstance(doc_meta.value, dict)
    ):
        return doc_meta
    base = doc_meta.value if isinstance(doc_meta, Json) else (doc_meta or {})
    extra = part_meta.value if isinstance(part_meta, Json) else (part_meta or {})
    if not isinstance(base, dict):
        base = {}
    if not isinstance(extra, dict):
        extra = {}
    return Json({**base, **extra})


def _combined_filter(metadata_filter, globpattern) -> str | None:
    filters = []
    if metadata_filter:
        filters.append(f"({metadata_filter})")
    if globpattern:
        filters.append(f"globmatch('{globpattern}', path)")
    return " && ".join(filters) if filters else None


def _pack_retrieval_results(texts, metas, scores) -> Json:
    out = []
    for text, meta, score in zip(texts or (), metas or (), scores or ()):
        out.append(
            {
                "text": text,
                "metadata": meta.value if isinstance(meta, Json) else meta,
                "dist": -float(score),
                "score": float(score),
            }
        )
    return Json(out)
