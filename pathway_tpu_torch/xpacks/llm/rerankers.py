"""Rerankers (reference: python/pathway/xpacks/llm/rerankers.py).

`CrossEncoderReranker` scores the whole candidate batch in one encoder
pass on the card; the reference scores ONE (query, doc) pair per call
(rerankers.py:209-213). Counterpart of pathway_tpu/xpacks/llm/rerankers.py;
the one difference is that `CrossEncoderReranker(device=...)` and
`EncoderReranker(device=...)` place their models."""

from __future__ import annotations

import json
from typing import Any, List, Optional, Tuple

from pathway_tpu_torch.engine.value import Json
from pathway_tpu_torch.internals.api import apply_with_type
from pathway_tpu_torch.internals.expression import ColumnExpression
from pathway_tpu_torch.internals.udfs import UDF, async_executor


def rerank_topk_filter(
    docs, scores, k: int = 5
) -> ColumnExpression:
    """Keep the k best docs by score (reference: rerankers.py
    rerank_topk_filter:17). Returns (docs_tuple, scores_tuple)."""

    def topk(docs_v, scores_v):
        ranked = sorted(
            zip(docs_v, scores_v), key=lambda p: p[1], reverse=True
        )[:k]
        if not ranked:
            return ((), ())
        kept_docs, kept_scores = zip(*ranked)
        return (tuple(kept_docs), tuple(kept_scores))

    return apply_with_type(topk, tuple, docs, scores)


class LLMReranker(UDF):
    """Score relevance 1-5 by prompting an LLM (reference: rerankers.py
    LLMReranker:60)."""

    def __init__(
        self,
        llm,
        *,
        retry_strategy=None,
        cache_strategy=None,
        use_logit_bias: bool | None = None,
    ):
        super().__init__(
            return_type=float,
            executor=async_executor(retry_strategy=retry_strategy),
            cache_strategy=cache_strategy,
        )
        self.llm = llm

        async def rerank(doc: str, query: str, **kwargs) -> float:
            prompt = (
                "Rate the relevance of the document to the query on a "
                "scale from 1 to 5. Answer with a single number only.\n"
                f"Query: {query}\nDocument: {doc}"
            )
            response = self.llm.func(
                [{"role": "user", "content": prompt}]
            )
            import inspect

            if inspect.isawaitable(response):
                response = await response
            if isinstance(response, list):
                response = response[0]
            try:
                return float(str(response).strip().split()[0])
            except (ValueError, IndexError):
                return 1.0

        self.func = rerank

    def __call__(self, doc, query, **kwargs) -> ColumnExpression:
        return super().__call__(doc, query, **kwargs)


class CrossEncoderReranker(UDF):
    """Cross-encoder scoring on the card, batched (reference: rerankers.py
    CrossEncoderReranker:163 — one pair per call there; one encoder pass
    over the whole batch here). `device=None` means the CUDA card;
    `device="cpu"` runs the encoder's plain PyTorch path."""

    def __init__(
        self,
        model_name: str = "cross-encoder/ms-marco-MiniLM-L-6-v2",
        *,
        cache_strategy=None,
        max_batch_size: int = 256,
        device=None,
        **init_kwargs,
    ):
        super().__init__(
            return_type=float,
            deterministic=True,
            cache_strategy=cache_strategy,
            max_batch_size=max_batch_size,
        )
        from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel

        self.model = CrossEncoderModel.cached(model_name, device=device)

        def score_batch(docs: List[str], queries: List[str]) -> List[float]:
            scores = self.model.score(list(zip(queries, docs)))
            return [float(s) for s in scores]

        self.func = score_batch

    def __call__(self, doc, query, **kwargs) -> ColumnExpression:
        return super().__call__(doc, query, **kwargs)


class EncoderReranker(UDF):
    """Bi-encoder dot-product reranker (reference: rerankers.py
    EncoderReranker:228). `device=None` means the CUDA card."""

    def __init__(
        self,
        model_name: str = "all-MiniLM-L6-v2",
        *,
        cache_strategy=None,
        max_batch_size: int = 512,
        device=None,
        **init_kwargs,
    ):
        super().__init__(
            return_type=float,
            deterministic=True,
            cache_strategy=cache_strategy,
            max_batch_size=max_batch_size,
        )
        from pathway_tpu_torch.models.minilm import SentenceEncoder

        self.encoder = SentenceEncoder.cached(model_name, device=device)

        def score_batch(docs: List[str], queries: List[str]) -> List[float]:
            import numpy as np

            doc_vecs = self.encoder.encode(docs)
            query_vecs = self.encoder.encode(queries)
            return [float(np.dot(d, q)) for d, q in zip(doc_vecs, query_vecs)]

        self.func = score_batch

    def __call__(self, doc, query, **kwargs) -> ColumnExpression:
        return super().__call__(doc, query, **kwargs)


class FlashRankReranker(UDF):
    """reference: rerankers.py FlashRankReranker:296 — requires flashrank."""

    def __init__(self, model_name: str = "ms-marco-TinyBERT-L-2-v2", **kwargs):
        super().__init__(return_type=float, deterministic=True)

        def score(doc: str, query: str) -> float:
            raise ImportError(
                "FlashRankReranker requires the flashrank package"
            )

        self.func = score

    def __call__(self, doc, query, **kwargs) -> ColumnExpression:
        return super().__call__(doc, query, **kwargs)
