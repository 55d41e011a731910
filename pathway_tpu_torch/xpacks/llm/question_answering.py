"""RAG question answering (reference:
python/pathway/xpacks/llm/question_answering.py: BaseQuestionAnswerer:389,
SummaryQuestionAnswerer:428, BaseRAGQuestionAnswerer:443,
AdaptiveRAGQuestionAnswerer:744, answer_with_geometric_rag_strategy:185,
RAGClient:995)."""

from __future__ import annotations

import json
from typing import Any, Callable, List, Optional

from pathway_tpu_torch.engine.value import Json
from pathway_tpu_torch.internals import api as pw_api
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.xpacks.llm import prompts as prompt_lib
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore


class BaseContextProcessor:
    """Turn retrieved docs into prompt context (reference:
    question_answering.py:40-106)."""

    def docs_to_context(self, docs) -> str:
        return prompt_lib._docs_to_context(docs)


class BaseQuestionAnswerer:
    """reference: question_answering.py BaseQuestionAnswerer:389."""

    class AnswerQuerySchema(Schema):
        prompt: str
        filters: Optional[str]
        metadata_filter: Optional[str]
        filepath_globpattern: Optional[str]
        model: Optional[str]
        return_context_docs: Optional[bool]

    class SummarizeQuerySchema(Schema):
        text_list: Json
        model: Optional[str]

    def answer_query(self, pw_ai_queries: Table) -> Table:
        raise NotImplementedError


class BaseRAGQuestionAnswerer(BaseQuestionAnswerer):
    """Standard RAG: retrieve → prompt → llm (reference:
    question_answering.py BaseRAGQuestionAnswerer:443)."""

    def __init__(
        self,
        llm,
        indexer: DocumentStore,
        *,
        default_llm_name: str | None = None,
        short_prompt_template=None,
        long_prompt_template=None,
        summarize_template=None,
        search_topk: int = 6,
        prompt_template=None,
        context_processor: BaseContextProcessor | None = None,
    ):
        self.llm = llm
        self.indexer = indexer
        self.search_topk = search_topk
        self.prompt_udf = prompt_template or prompt_lib.prompt_qa
        self.context_processor = context_processor or BaseContextProcessor()
        self.server = None

    # -- retrieval helper -------------------------------------------------
    def _retrieve_docs(self, queries: Table, k: int | None = None) -> Table:
        retrieval_queries = queries.select(
            query=queries.prompt,
            k=k or self.search_topk,
            metadata_filter=pw_api.coalesce(
                queries.filters, queries.metadata_filter, None
            ),
            filepath_globpattern=queries.filepath_globpattern,
        )
        return self.indexer.retrieve_query(retrieval_queries)

    def answer_query(self, pw_ai_queries: Table) -> Table:
        """reference: question_answering.py answer endpoint :560-740."""
        docs = self._retrieve_docs(pw_ai_queries)
        with_docs = pw_ai_queries.select(
            prompt=pw_ai_queries.prompt,
            return_context_docs=pw_ai_queries.return_context_docs,
            docs=docs.result,
        )
        prompted = with_docs.select(
            prompt_text=self.prompt_udf(with_docs.prompt, with_docs.docs),
            docs=with_docs.docs,
            return_context_docs=with_docs.return_context_docs,
        )
        from pathway_tpu_torch.xpacks.llm.llms import prompt_chat_single_qa

        answered = prompted.select(
            response=self.llm(prompt_chat_single_qa(prompted.prompt_text)),
            docs=prompted.docs,
            return_context_docs=prompted.return_context_docs,
        )

        def pack(response, docs, return_context_docs) -> Json:
            out: dict = {"response": response}
            if return_context_docs:
                out["context_docs"] = (
                    docs.value if isinstance(docs, Json) else docs
                )
            return Json(out)

        return answered.select(
            result=pw_api.apply_with_type(
                pack,
                Json,
                answered.response,
                answered.docs,
                answered.return_context_docs,
            )
        )

    def summarize_query(self, summarize_queries: Table) -> Table:
        """reference: SummaryQuestionAnswerer:428."""
        from pathway_tpu_torch.xpacks.llm.llms import prompt_chat_single_qa

        prompted = summarize_queries.select(
            prompt_text=prompt_lib.prompt_summarize(
                summarize_queries.text_list
            ),
        )
        answered = prompted.select(
            result=pw_api.apply_with_type(
                lambda r: Json({"response": r}),
                Json,
                self.llm(prompt_chat_single_qa(prompted.prompt_text)),
            )
        )
        return answered

    # -- serving ----------------------------------------------------------
    def build_server(self, host: str, port: int, **kwargs) -> None:
        """reference: question_answering.py build_server."""
        from pathway_tpu_torch.xpacks.llm.servers import QASummaryRestServer

        self.server = QASummaryRestServer(host, port, self, **kwargs)

    def run_server(self, *args, threaded: bool = False, **kwargs):
        if self.server is None:
            raise RuntimeError("call build_server(host, port) first")
        return self.server.run(threaded=threaded)


SummaryQuestionAnswerer = BaseRAGQuestionAnswerer


def answer_with_geometric_rag_strategy(
    questions: List[str],
    documents: List[List[str]],
    llm_chat_model,
    n_starting_documents: int = 2,
    factor: int = 2,
    max_iterations: int = 4,
    strict_prompt: bool = False,
) -> List[str]:
    """Geometric doc-count escalation (reference: question_answering.py
    answer_with_geometric_rag_strategy:185): ask with n docs, escalate n*=factor
    while the model answers 'No information found'."""
    no_answer = "No information found."
    answers: List[str] = []
    for question, docs in zip(questions, documents):
        n = n_starting_documents
        answer = no_answer
        for _ in range(max_iterations):
            context = "\n\n".join(docs[:n])
            strictness = (
                "Answer with the shortest possible span from the context, "
                "no explanations. "
                if strict_prompt
                else ""
            )
            prompt = (
                f"{strictness}Please answer using only the context. If the "
                f"context is insufficient, reply exactly {no_answer!r}.\n"
                f"Context: {context}\nQuestion: {question}\nAnswer:"
            )
            result = llm_chat_model.func([{"role": "user", "content": prompt}])
            import asyncio
            import inspect

            if inspect.isawaitable(result):
                result = asyncio.run(result)
            if isinstance(result, list):
                result = result[0]
            answer = str(result).strip() if result is not None else no_answer
            if no_answer.lower() not in answer.lower():
                break
            n *= factor
        answers.append(answer)
    return answers


def answer_with_geometric_rag_strategy_from_index(
    questions,
    index,
    documents_column_name,
    llm_chat_model,
    *,
    n_starting_documents: int = 2,
    factor: int = 2,
    max_iterations: int = 4,
    metadata_filter=None,
    strict_prompt: bool = False,
):
    """Dataflow form of geometric RAG (reference: question_answering.py
    answer_with_geometric_rag_strategy_from_index:304): retrieve
    ``n_starting_documents * factor^(max_iterations-1)`` documents from the
    index once, then escalate the per-prompt document count geometrically
    until the chat commits to an answer. Returns the answer column."""
    if not isinstance(documents_column_name, str):
        documents_column_name = documents_column_name.name
    if questions.name == documents_column_name:
        # collapse_rows gives query columns precedence over same-named
        # reply columns — requery under a reserved name so the documents
        # column survives
        qt = questions._table.select(**{"_pw_rag_query": questions})
        questions = qt["_pw_rag_query"]
    max_documents = n_starting_documents * (factor ** (max_iterations - 1))
    reply = index.query_as_of_now(
        questions,
        number_of_matches=max_documents,
        collapse_rows=True,
        metadata_filter=metadata_filter,
    )
    q_name = questions.name

    def per_row(question, docs):
        return answer_with_geometric_rag_strategy(
            [question],
            [[d for d in (docs or []) if d is not None]],
            llm_chat_model,
            n_starting_documents=n_starting_documents,
            factor=factor,
            max_iterations=max_iterations,
            strict_prompt=strict_prompt,
        )[0]

    result = reply.select(
        answer=pw_api.apply_with_type(
            per_row,
            str,
            reply[q_name],
            reply[documents_column_name],
        )
    )
    return result.answer


class AdaptiveRAGQuestionAnswerer(BaseRAGQuestionAnswerer):
    """Adaptive RAG: retrieve max docs once, escalate the prompt doc count
    geometrically until the LLM commits to an answer (reference:
    question_answering.py AdaptiveRAGQuestionAnswerer:744)."""

    def __init__(
        self,
        llm,
        indexer: DocumentStore,
        *,
        n_starting_documents: int = 2,
        factor: int = 2,
        max_iterations: int = 4,
        strict_prompt: bool = False,
        **kwargs,
    ):
        super().__init__(llm, indexer, **kwargs)
        self.n_starting_documents = n_starting_documents
        self.factor = factor
        self.max_iterations = max_iterations
        max_docs = n_starting_documents * factor ** (max_iterations - 1)
        self.search_topk = max(self.search_topk, max_docs)

    def answer_query(self, pw_ai_queries: Table) -> Table:
        docs = self._retrieve_docs(pw_ai_queries, k=self.search_topk)
        with_docs = pw_ai_queries.select(
            prompt=pw_ai_queries.prompt,
            return_context_docs=pw_ai_queries.return_context_docs,
            docs=docs.result,
        )
        llm = self.llm
        n0, factor, max_iter = (
            self.n_starting_documents,
            self.factor,
            self.max_iterations,
        )

        def adaptive_answer(question: str, docs_json) -> Json:
            doc_entries = (
                docs_json.value if isinstance(docs_json, Json) else docs_json
            ) or []
            texts = [
                d.get("text", "") if isinstance(d, dict) else str(d)
                for d in doc_entries
            ]
            (answer,) = answer_with_geometric_rag_strategy(
                [question],
                [texts],
                llm,
                n_starting_documents=n0,
                factor=factor,
                max_iterations=max_iter,
            )
            return Json({"response": answer})

        return with_docs.select(
            result=pw_api.apply_with_type(
                adaptive_answer, Json, with_docs.prompt, with_docs.docs
            )
        )


class DeckRetriever(BaseQuestionAnswerer):
    """reference: question_answering.py DeckRetriever:877 — slide search."""

    def __init__(self, indexer: DocumentStore, *, search_topk: int = 6):
        self.indexer = indexer
        self.search_topk = search_topk

    def answer_query(self, pw_ai_queries: Table) -> Table:
        retrieval_queries = pw_ai_queries.select(
            query=pw_ai_queries.prompt,
            k=self.search_topk,
            metadata_filter=pw_ai_queries.metadata_filter,
            filepath_globpattern=pw_ai_queries.filepath_globpattern,
        )
        return self.indexer.retrieve_query(retrieval_queries)


class RAGClient:
    """HTTP client for QA servers (reference: question_answering.py
    RAGClient:995)."""

    def __init__(self, host: str | None = None, port: int | None = None, url: str | None = None, timeout: int = 90):
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

    def answer(self, prompt: str, filters: str | None = None, model: str | None = None, return_context_docs: bool = False):
        return self._post(
            "/v2/answer",
            {
                "prompt": prompt,
                "filters": filters,
                "model": model,
                "return_context_docs": return_context_docs,
            },
        )

    pw_ai_answer = answer

    def summarize(self, text_list: List[str], model: str | None = None):
        return self._post(
            "/v2/summarize", {"text_list": text_list, "model": model}
        )

    pw_ai_summary = summarize

    def retrieve(self, query: str, k: int = 6, metadata_filter: str | None = None, filepath_globpattern: str | None = None):
        return self._post(
            "/v1/retrieve",
            {
                "query": query,
                "k": k,
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )

    def list_documents(self, filters: str | None = None):
        return self._post("/v2/list_documents", {"metadata_filter": filters})

    def statistics(self):
        return self._post("/v1/statistics", {})
