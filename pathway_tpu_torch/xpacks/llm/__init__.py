"""LLM xpack: embedders, chats, splitters, parsers, rerankers, document
store, vector store, RAG question answering, servers (reference:
python/pathway/xpacks/llm/)."""

from pathway_tpu_torch.xpacks.llm._typing import (
    Doc,
    DocTransformer,
    DocTransformerCallable,
)
from pathway_tpu_torch.xpacks.llm import (
    embedders,
    llms,
    parsers,
    prompts,
    rerankers,
    splitters,
)

__all__ = [
    "Doc",
    "DocTransformer",
    "DocTransformerCallable",
    "embedders",
    "llms",
    "parsers",
    "prompts",
    "rerankers",
    "splitters",
]


def __getattr__(name):
    import importlib

    known = {
        "document_store",
        "vector_store",
        "question_answering",
        "servers",
        "mcp_server",
    }
    if name in known:
        return importlib.import_module(f"pathway_tpu_torch.xpacks.llm.{name}")
    raise AttributeError(name)
