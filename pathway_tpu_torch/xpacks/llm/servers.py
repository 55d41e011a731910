"""REST servers for document stores and RAG apps (reference:
python/pathway/xpacks/llm/servers.py BaseRestServer:16,
DocumentStoreServer:92, QARestServer:140, QASummaryRestServer:207)."""

from __future__ import annotations

import threading
from typing import Callable, Optional, Type

from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector


class BaseRestServer:
    """reference: servers.py BaseRestServer:16."""

    def __init__(self, host: str, port: int, with_cors: bool = False, **kwargs):
        self.host = host
        self.port = port
        self.webserver = PathwayWebserver(host, port, with_cors=with_cors)

    def serve(
        self,
        route: str,
        schema: Type[Schema],
        handler: Callable,
        *,
        methods=("POST",),
        documentation=None,
        **kwargs,
    ) -> None:
        """Register a route: requests become a table, `handler(table)`
        returns the result table whose `result` column is the response."""
        queries, writer = rest_connector(
            webserver=self.webserver,
            route=route,
            schema=schema,
            methods=methods,
            documentation=documentation,
            delete_completed_queries=True,
        )
        writer(handler(queries))

    def run(
        self,
        *,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend=None,
        terminate_on_error: bool = True,
        **kwargs,
    ):
        """reference: servers.py run — pw.run under the hood."""
        from pathway_tpu_torch.internals.runner import run as pw_run

        if threaded:
            t = threading.Thread(target=pw_run, daemon=True, name="pw-server")
            t.start()
            return t
        pw_run()
        return None


class DocumentStoreServer(BaseRestServer):
    """reference: servers.py DocumentStoreServer:92."""

    def __init__(self, host: str, port: int, document_store, **kwargs):
        super().__init__(host, port, **kwargs)
        self.document_store = document_store
        ds = document_store
        self.serve(
            "/v1/retrieve", ds.RetrieveQuerySchema, ds.retrieve_query
        )
        self.serve(
            "/v1/statistics", ds.StatisticsQuerySchema, ds.statistics_query
        )
        self.serve("/v1/inputs", ds.InputsQuerySchema, ds.inputs_query)


class QARestServer(BaseRestServer):
    """reference: servers.py QARestServer:140."""

    def __init__(self, host: str, port: int, rag_question_answerer, **kwargs):
        super().__init__(host, port, **kwargs)
        self.rag = rag_question_answerer
        rag = rag_question_answerer
        self.serve(
            "/v1/pw_ai_answer", rag.AnswerQuerySchema, rag.answer_query
        )
        self.serve(
            "/v2/answer", rag.AnswerQuerySchema, rag.answer_query
        )
        self.serve(
            "/v1/retrieve",
            rag.indexer.RetrieveQuerySchema,
            rag.indexer.retrieve_query,
        )
        self.serve(
            "/v2/list_documents",
            rag.indexer.InputsQuerySchema,
            rag.indexer.inputs_query,
        )
        self.serve(
            "/v1/statistics",
            rag.indexer.StatisticsQuerySchema,
            rag.indexer.statistics_query,
        )


class QASummaryRestServer(QARestServer):
    """reference: servers.py QASummaryRestServer:207."""

    def __init__(self, host: str, port: int, rag_question_answerer, **kwargs):
        super().__init__(host, port, rag_question_answerer, **kwargs)
        rag = rag_question_answerer
        self.serve(
            "/v1/pw_ai_summary", rag.SummarizeQuerySchema, rag.summarize_query
        )
        self.serve(
            "/v2/summarize", rag.SummarizeQuerySchema, rag.summarize_query
        )
