"""Prompt library (reference: python/pathway/xpacks/llm/prompts.py)."""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Any, List, Tuple

from pathway_tpu_torch.engine.value import Json
from pathway_tpu_torch.internals.api import apply_with_type


@dataclass
class BasePromptTemplate:
    """reference: prompts.py template classes :12-104."""

    template: str = ""

    def format(self, **kwargs) -> str:
        return self.template.format(**kwargs)


@dataclass
class RAGPromptTemplate(BasePromptTemplate):
    template: str = (
        "Please answer the question using only the provided context.\n"
        "If the answer is not in the context, reply exactly: No information found.\n"
        "Context: {context}\nQuestion: {query}\nAnswer:"
    )


@dataclass
class RAGFunctionPromptTemplate(BasePromptTemplate):
    pass


def _docs_to_context(docs: Any) -> str:
    if isinstance(docs, Json):
        docs = docs.value
    parts: List[str] = []
    for doc in docs or ():
        if isinstance(doc, Json):
            doc = doc.value
        if isinstance(doc, dict):
            parts.append(str(doc.get("text", doc)))
        else:
            parts.append(str(doc))
    return "\n\n".join(parts)


def prompt_qa(
    query,
    docs,
    information_not_found_response: str = "No information found.",
    additional_rules: str = "",
):
    """reference: prompts.py prompt_qa:173."""

    def build(q: str, d) -> str:
        context = _docs_to_context(d)
        return (
            "Please provide an answer based solely on the provided sources. "
            "When referencing information from a source, cite it. "
            f"If none of the sources are helpful, respond with "
            f"{information_not_found_response!r}.{additional_rules}\n"
            f"Context: {context}\nQuestion: {q}\nAnswer:"
        )

    return apply_with_type(build, str, query, docs)


def prompt_short_qa(
    query, docs, additional_rules: str = ""
):
    """reference: prompts.py prompt_short_qa:133."""

    def build(q: str, d) -> str:
        context = _docs_to_context(d)
        return (
            "Answer the question concisely (a few words) based on the "
            f"context.{additional_rules}\n"
            f"Context: {context}\nQuestion: {q}\nAnswer:"
        )

    return apply_with_type(build, str, query, docs)


def prompt_qa_geometric_rag(
    query,
    docs,
    information_not_found_response: str = "No information found.",
    additional_rules: str = "",
):
    """reference: prompts.py prompt_qa_geometric_rag:223 (adaptive RAG)."""
    return prompt_qa(
        query,
        docs,
        information_not_found_response=information_not_found_response,
        additional_rules=additional_rules,
    )


def prompt_summarize(text_list):
    """reference: prompts.py prompt_summarize."""

    def build(texts) -> str:
        if isinstance(texts, Json):
            texts = texts.value
        joined = "\n".join(str(t) for t in (texts or ()))
        return f"Summarize the following texts:\n{joined}\nSummary:"

    return apply_with_type(build, str, text_list)


def prompt_rerank(query, doc):
    """reference: prompts.py prompt_rerank:256."""

    def build(q: str, d: str) -> str:
        return (
            'Rate relevance 1-5. Respond as JSON: {"score": <n>}\n'
            f"Query: {q}\nDocument: {d}"
        )

    return apply_with_type(build, str, query, doc)


def parse_score_json(response: str) -> float:
    """reference: prompts.py parse_score_json:307."""
    match = re.search(r"\{[^}]*\}", response or "")
    if match:
        try:
            return float(json.loads(match.group(0)).get("score", 1.0))
        except (json.JSONDecodeError, TypeError, ValueError):
            pass
    digits = re.search(r"[1-5]", response or "")
    return float(digits.group(0)) if digits else 1.0


def prompt_citing_qa(query, docs, additional_rules: str = ""):
    """reference: prompts.py prompt_citing_qa:324."""

    def build(q: str, d) -> str:
        if isinstance(d, Json):
            d = d.value
        numbered = []
        for i, doc in enumerate(d or ()):
            if isinstance(doc, Json):
                doc = doc.value
            text = doc.get("text", doc) if isinstance(doc, dict) else doc
            numbered.append(f"[{i}] {text}")
        context = "\n".join(numbered)
        return (
            "Answer using the sources; cite them as [number].\n"
            f"{additional_rules}\nSources:\n{context}\n"
            f"Question: {q}\nAnswer:"
        )

    return apply_with_type(build, str, query, docs)


def parse_cited_response(response: str, docs: list) -> Tuple[str, list]:
    """reference: prompts.py parse_cited_response:372."""
    cited = [int(m) for m in re.findall(r"\[(\d+)\]", response or "")]
    cited_docs = [docs[i] for i in cited if 0 <= i < len(docs)]
    answer = re.sub(r"\s*\[\d+\]", "", response or "").strip()
    return answer, cited_docs
