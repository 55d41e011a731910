"""Decoder-only chat model on PyTorch + CUDA (counterpart of
pathway_tpu/models/decoder_lm.py).

Replaces the reference's local HF pipeline (xpacks/llm/llms.py
HFPipelineChat). A local Llama/Mistral-family checkpoint directory loads
real weights; any other name builds random weights from a seed, with
Mistral-7B geometry when "mistral" is in the name and the tiny decoder
otherwise, and the hashing tokenizer.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.models import hf_loader
from pathway_tpu_torch.models.decoder import (
    MISTRAL_7B_DECODER,
    TINY,
    DecoderConfig,
    generate_tokens,
    init_decoder_params,
)
from pathway_tpu_torch.models.tokenizer import HashTokenizer

_model_cache: dict = {}


class ChatModel:
    """KV-cached decoder (models/decoder.py): one prefill through the flash
    kernel, then decode steps on the device with no host round trip per
    token. `device=None` means the CUDA card and raises without one;
    `device="cpu"` runs the plain path.

    The default max_len=128 keeps every prompt under the flash gate
    (L > 256), as in the JAX package; pass a larger max_len to prefill
    long prompts through the kernel."""

    def __init__(
        self,
        model: str = "tiny-decoder",
        *,
        config: DecoderConfig | None = None,
        seed: int = 2,
        max_len: int = 128,
        device=None,
    ):
        self.device = resolve_device(device)
        params = None
        tokenizer = None
        if hf_loader.is_decoder_checkpoint(model):
            if config is not None:
                raise ValueError(
                    "pass either a checkpoint directory (its config.json "
                    "defines the architecture) or an explicit config=, not both"
                )
            config, params = hf_loader.load_hf_decoder(model)
            params = _to_device(params, self.device)
            tok_json = os.path.join(model, "tokenizer.json")
            if os.path.exists(tok_json):
                from pathway_tpu_torch.models.tokenizer import FastTokenizer

                tokenizer = FastTokenizer(tok_json)
        if config is None:
            config = MISTRAL_7B_DECODER if "mistral" in model.lower() else TINY
        self.name = model
        self.config = config
        self.max_len = min(max_len, config.max_len)
        self.tokenizer = tokenizer or HashTokenizer(vocab_size=config.vocab_size)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_decoder_params(gen, config, self.device)
        self.params = params

    @classmethod
    def cached(cls, model: str = "tiny-decoder", **kw) -> "ChatModel":
        key = (model, tuple(sorted((k, str(v)) for k, v in kw.items())))
        if key not in _model_cache:
            _model_cache[key] = cls(model, **kw)
        return _model_cache[key]

    def encode_prompts(self, prompts: Sequence[str], max_new_tokens: int):
        """Left-aligned [B, L] int32 ids and mask. A prompt longer than
        the cache leaves room for keeps its most recent tokens: the tail
        conditions the reply (the reference HF pipeline cuts the same
        end)."""
        budget = min(self.max_len, self.config.max_len - max_new_tokens)
        if budget <= 0:
            raise ValueError(
                f"max_new_tokens ({max_new_tokens}) leaves no cache room "
                f"for any prompt token (model max_len {self.config.max_len})"
            )
        encoded = [self.tokenizer.encode(t, None)[-budget:] for t in prompts]
        longest = max(len(e) for e in encoded)
        ids = np.zeros((len(encoded), longest), dtype=np.int32)
        mask = np.zeros_like(ids)
        for r, e in enumerate(encoded):
            ids[r, : len(e)] = e
            mask[r, : len(e)] = 1
        return ids, mask

    def generate(
        self,
        prompts: Sequence[str],
        *,
        max_new_tokens: int = 16,
        temperature: float = 0.0,
    ) -> List[str]:
        if not prompts:
            return []
        ids, mask = self.encode_prompts(prompts, max_new_tokens)
        tokens = generate_tokens(
            self.params, self.config, ids, mask,
            max_new_tokens=max_new_tokens, temperature=temperature,
        )
        return [self.tokenizer.decode(row) for row in tokens[: len(prompts)]]


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
