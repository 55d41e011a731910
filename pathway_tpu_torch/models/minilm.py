"""SentenceTransformer-class sentence encoder on PyTorch + CUDA
(counterpart of pathway_tpu/models/minilm.py).

Batches are bucketed to stable shapes by the tokenizer and encoded in bf16
on the card; the pooled vectors come back to the host in one copy. With a
mesh, the batch axis shards over its `dp` (or first) axis: each position
encodes its block of rows on its device.
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
from pathway_tpu_torch.models.transformer import MINILM_L6, TransformerConfig, TransformerLM
from pathway_tpu_torch.parallel.mesh import NamedSharding, P, dp_axis, same_device

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
        mesh=None,
    ):
        self.name = model
        if mesh is not None:
            axis = dp_axis(mesh)
            n_dev = mesh.shape[axis]
            if n_dev & (n_dev - 1):
                raise ValueError(
                    f"SentenceEncoder mesh axis {axis!r} has {n_dev} "
                    f"devices, which is not a power of two: encode_batch "
                    f"buckets every batch to a power of two (minimum 8), "
                    f"so a {n_dev}-way '{axis}' shard would never divide "
                    f"the batch axis evenly. Use a power-of-two device "
                    f"count on that axis, or drop the mesh and run the "
                    f"single-device async pipeline "
                    f"(PATHWAY_DEVICE_PIPELINE=1, the default)"
                )
            # the weights live on the mesh's first device
            first = mesh.devices.flat[0]
            if device is not None and not same_device(device, first):
                raise ValueError(
                    f"SentenceEncoder: device {device} contradicts the mesh, whose first "
                    f"device is {first}"
                )
            device = first
        self.mesh = mesh
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
        if self.mesh is not None:
            # data-parallel dispatch: the (bucketed, power-of-two) batch
            # axis shards over the mesh's dp / first axis, each position
            # encoding its rows with the weights on its device (replicated,
            # as the JAX package's are); the pooled blocks come back in order
            axis = dp_axis(self.mesh)
            if ids.shape[0] % self.mesh.shape[axis] == 0:
                sharding = NamedSharding(self.mesh, P(axis, None))
                blocks = zip(sharding.shard(ids.astype(np.int32)), sharding.shard(mask.astype(np.int32)))
                pooled = torch.cat([
                    self.lm(i, m, params=self.lm.params_on(i.device)).to(self.device)
                    for i, m in blocks
                ])
                return (pooled, len(texts))
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
        packing is disabled (PATHWAY_PACK_TOKEN_BUDGET=0) or a mesh is
        attached: the mesh path needs the power-of-two batch-axis contract
        that packed row counts do not honor."""
        budget = pack_token_budget()
        if budget <= 0 or self.mesh is not None or not texts:
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
