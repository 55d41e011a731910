"""VectorStoreServer — DocumentStore + auto embedder index + REST server
(reference: python/pathway/xpacks/llm/vector_store.py VectorStoreServer:31,
run_server:64). The north-star entrypoint (BASELINE.json configs[0-1])."""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.xpacks.llm.document_store import (
    DocumentStore,
    DocumentStoreClient,
)


class VectorStoreServer:
    """reference: vector_store.py VectorStoreServer:31."""

    def __init__(
        self,
        *docs: Table,
        embedder=None,
        parser=None,
        splitter=None,
        doc_post_processors=None,
        index_factory=None,
    ):
        if index_factory is None:
            from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
                BruteForceKnnFactory,
            )

            if embedder is None:
                raise ValueError("provide embedder= or index_factory=")
            index_factory = BruteForceKnnFactory(
                dimensions=embedder.get_embedding_dimension(),
                embedder=embedder,
            )
        self.embedder = embedder
        self.document_store = DocumentStore(
            list(docs),
            retriever_factory=index_factory,
            parser=parser,
            splitter=splitter,
            doc_post_processors=doc_post_processors,
        )

    @classmethod
    def from_langchain_components(
        cls, *docs, embedder=None, parser=None, splitter=None, **kwargs
    ):
        """reference: document_store.py from_langchain_components:121 —
        wraps langchain embedder/splitter callables."""
        from pathway_tpu_torch.internals.udfs import udf

        lc_embedder = embedder

        @udf
        async def embedding_udf(text: str):
            import numpy as np

            result = await lc_embedder.aembed_documents([text])
            return np.array(result[0], dtype=np.float32)

        class _Wrapper:
            def __call__(self, column):
                return embedding_udf(column)

            def get_embedding_dimension(self):
                import asyncio

                return len(asyncio.run(lc_embedder.aembed_documents(["."]))[0])

        wrapped_splitter = None
        if splitter is not None:

            @udf
            def splitter_udf(text: str, metadata) -> list:
                return [
                    (c.page_content, dict(c.metadata))
                    for c in splitter.create_documents([text])
                ]

            class _SplitWrapper:
                def __call__(self, text, metadata):
                    return splitter_udf(text, metadata)

            wrapped_splitter = _SplitWrapper()

        return cls(
            *docs,
            embedder=_Wrapper(),
            parser=parser,
            splitter=wrapped_splitter,
            **kwargs,
        )

    @classmethod
    def from_llamaindex_components(
        cls, *docs, transformations=None, parser=None, **kwargs
    ):
        """Build the store from LlamaIndex TransformComponents (reference:
        document_store.py from_llamaindex_components:162): each document
        becomes a TextNode, runs through the transformation pipeline, and
        the resulting nodes become (text, metadata) chunks."""
        try:
            from llama_index.core.ingestion.pipeline import (  # type: ignore
                run_transformations,
            )
            from llama_index.core.schema import (  # type: ignore
                MetadataMode,
                TextNode,
            )
        except ImportError as exc:
            raise ImportError(
                "Please install llama-index-core: "
                "`pip install llama-index-core`"
            ) from exc

        from pathway_tpu_torch.internals.udfs import udf

        @udf
        def splitter_udf(text: str, metadata) -> list:
            nodes = run_transformations(
                [TextNode(text=text)], transformations or []
            )
            return [
                (
                    node.get_content(metadata_mode=MetadataMode.NONE),
                    dict(node.extra_info or {}),
                )
                for node in nodes
            ]

        return cls(*docs, parser=parser, splitter=splitter_udf, **kwargs)

    def run_server(
        self,
        host: str,
        port: int,
        *,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend=None,
        terminate_on_error: bool = True,
    ):
        """Serve /v1/retrieve, /v1/statistics, /v1/inputs (reference:
        vector_store.py run_server:64)."""
        from pathway_tpu_torch.xpacks.llm.servers import DocumentStoreServer

        server = DocumentStoreServer(
            host=host, port=port, document_store=self.document_store
        )
        return server.run(threaded=threaded, with_cache=with_cache)


class VectorStoreClient(DocumentStoreClient):
    """reference: vector_store client (query by text)."""

    def query(self, query: str, k: int = 3, metadata_filter: str | None = None):
        return self.retrieve(query, k=k, metadata_filter=metadata_filter)
