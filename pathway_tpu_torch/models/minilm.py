"""SentenceTransformer-class sentence encoder on PyTorch + CUDA
(counterpart of pathway_tpu/models/minilm.py).

Batches are bucketed to stable shapes by the tokenizer and encoded in bf16
on the card; the pooled vectors come back to the host in one copy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pathway_tpu_torch.models import hf_loader
from pathway_tpu_torch.models.tokenizer import (
    PACK_MAX_SEGMENTS,
    HashTokenizer,
    encode_batch,
    pack_batch,
    pack_token_budget,
)
from pathway_tpu_torch.models.transformer import (
    MINILM_L6,
    TransformerConfig,
    TransformerLM,
)

_model_cache: dict = {}


class SentenceEncoder:
    """encode(list[str]) -> np.ndarray [B, hidden] (L2-normalized)."""

    def __init__(
        self,
        model: str = "all-MiniLM-L6-v2",
        *,
        config: TransformerConfig | None = None,
        seed: int = 0,
        max_len: int = 256,
        device=None,
    ):
        self.name = model
        params = None
        tokenizer = None
        if hf_loader.is_checkpoint_dir(model):
            # real weights from a local HF checkpoint dir; random weights
            # with the hashing tokenizer stay the offline default
            config, params = hf_loader.load_hf_encoder(model)
            tokenizer = hf_loader.load_tokenizer(model)
        self.config = config or MINILM_L6
        self.max_len = min(max_len, self.config.max_len)
        self.tokenizer = tokenizer or HashTokenizer(vocab_size=self.config.vocab_size)
        self.lm = TransformerLM(self.config, params=params, seed=seed, device=device)
        self.device = self.lm.device

    @classmethod
    def cached(cls, model: str = "all-MiniLM-L6-v2", **kwargs) -> "SentenceEncoder":
        key = (model, tuple(sorted((k, str(v)) for k, v in kwargs.items())))
        if key not in _model_cache:
            _model_cache[key] = cls(model, **kwargs)
        return _model_cache[key]

    @property
    def dimension(self) -> int:
        return self.config.hidden

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode_await(self.encode_submit(texts))

    def encode_submit(self, texts: Sequence[str]):
        """Tokenize and queue the device encode, returning a handle without
        waiting for it: CUDA work is asynchronous, so the caller can
        tokenize the next batch while this one runs. encode() is exactly
        encode_await(encode_submit(...))."""
        if not texts:
            return None
        ids, mask = encode_batch(self.tokenizer, list(texts), max_len=self.max_len)
        return (self.lm(ids, mask), len(texts))

    def encode_await(self, handle) -> np.ndarray:
        """One host copy of the pooled [B, hidden] block, trimmed to the
        real batch."""
        if handle is None:
            return np.zeros((0, self.config.hidden), dtype=np.float32)
        pooled, n = handle
        return pooled[:n].cpu().numpy()

    def encode_packed(self, texts: Sequence[str]) -> np.ndarray:
        """Packed ragged encode: docs concatenate into token-budget slabs
        (tokenizer.pack_batch) so the card runs on real tokens instead of
        per-doc pad. Falls back to the classic bucketed `encode` when
        packing is disabled (PATHWAY_PACK_TOKEN_BUDGET=0)."""
        budget = pack_token_budget()
        if budget <= 0 or not texts:
            return self.encode(texts)
        ids, seg, slots = pack_batch(
            self.tokenizer, list(texts), max_len=self.max_len, token_budget=budget
        )
        pooled = self.lm.encode_packed(ids, seg, PACK_MAX_SEGMENTS)
        rows, segs = _slot_index(slots, pooled.device)
        return pooled[rows, segs].cpu().numpy()

    def encode_one(self, text: str) -> np.ndarray:
        return self.encode([text])[0]


def _slot_index(slots, device):
    """pack_batch slots [(row, seg), ...] as two index tensors."""
    at = torch.tensor(slots, dtype=torch.int64).reshape(-1, 2).to(device)
    return at[:, 0], at[:, 1]
