"""Cross-encoder (query, doc) scorer on PyTorch + CUDA (counterpart of
pathway_tpu/models/cross_encoder.py).

Replaces the reference's sentence_transformers CrossEncoder (reference:
xpacks/llm/rerankers.py CrossEncoderReranker:163), which scores ONE pair
per call: here the whole candidate batch is one encoder pass on the card.
The encoder is the port's `TransformerLM` with cls pooling over
`encode_batch(..., pair_texts=...)`; the score is the pooled vector times
a [hidden] head.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from pathway_tpu_torch.models.tokenizer import HashTokenizer, encode_batch
from pathway_tpu_torch.models.transformer import TransformerConfig, TransformerLM

CROSS_ENCODER_CFG = TransformerConfig(
    vocab_size=30522, hidden=384, layers=4, heads=12, mlp_dim=1536,
    pooling="cls",
)

_model_cache: dict = {}


class CrossEncoderModel:
    """`device=None` means the CUDA card and raises without one;
    `device="cpu"` runs the plain PyTorch path. The weights are drawn
    from `seed`: the encoder as `TransformerLM` draws it, the head from a
    `torch.Generator` seeded with seed + 1, scaled by 0.02."""

    def __init__(
        self,
        model: str = "cross-encoder/ms-marco-MiniLM-L-6-v2",
        *,
        config: TransformerConfig | None = None,
        seed: int = 1,
        max_len: int = 256,
        device=None,
    ):
        self.name = model
        self.config = config or CROSS_ENCODER_CFG
        self.max_len = min(max_len, self.config.max_len)
        self.tokenizer = HashTokenizer(vocab_size=self.config.vocab_size)
        self.lm = TransformerLM(self.config, seed=seed, device=device)
        self.device = self.lm.device
        self.head = (
            torch.randn(
                self.config.hidden,
                generator=torch.Generator().manual_seed(seed + 1),
                dtype=torch.float32,
            )
            * 0.02
        ).to(self.device)

    @classmethod
    def cached(cls, model: str = "cross-encoder/ms-marco-MiniLM-L-6-v2", **kw):
        key = (model, tuple(sorted(kw.items())))
        if key not in _model_cache:
            _model_cache[key] = cls(model, **kw)
        return _model_cache[key]

    def score(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        """Scores for (query, doc) pairs, one fused batch."""
        if not pairs:
            return np.zeros((0,), dtype=np.float32)
        queries = [q for q, _ in pairs]
        docs = [d for _, d in pairs]
        ids, mask = encode_batch(
            self.tokenizer, queries, pair_texts=docs, max_len=self.max_len
        )
        pooled = self.lm(ids, mask)[: len(pairs)]
        return (pooled @ self.head).cpu().numpy()
