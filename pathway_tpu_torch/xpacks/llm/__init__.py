"""LLM xpack: embedders, parsers, splitters and the document store
(reference: python/pathway/xpacks/llm/).

Counterpart of pathway_tpu/xpacks/llm; llms, prompts, rerankers,
vector_store, question_answering, servers and mcp_server are still to
come (ROADMAP, Queue 1, item 1.4)."""

from pathway_tpu_torch.xpacks.llm._typing import (
    Doc,
    DocTransformer,
    DocTransformerCallable,
)
from pathway_tpu_torch.xpacks.llm import (
    embedders,
    parsers,
    splitters,
)

__all__ = [
    "Doc",
    "DocTransformer",
    "DocTransformerCallable",
    "embedders",
    "parsers",
    "splitters",
]


def __getattr__(name):
    import importlib

    known = {
        "document_store",
    }
    if name in known:
        return importlib.import_module(f"pathway_tpu_torch.xpacks.llm.{name}")
    raise AttributeError(name)
