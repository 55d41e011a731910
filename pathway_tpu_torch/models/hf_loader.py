"""Local HF encoder checkpoints -> the port's parameter tree (the encoder
half of pathway_tpu/models/hf_loader.py, with the same tensor mapping).

Point `SentenceEncoder` at a directory holding a BERT-family checkpoint
(`config.json` + `model.safetensors` / `pytorch_model.bin` / `weights.npz`
+ `vocab.txt`) and the tensors are remapped into the post-LN ("bert")
layout of models/transformer.py. Loading is from the filesystem only.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer
from pathway_tpu_torch.models.transformer import TransformerConfig


def is_checkpoint_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "config.json"))


def _read_tensors(path: str) -> Dict[str, np.ndarray]:
    """Read raw named tensors from whichever serialized form is present."""
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        from safetensors.numpy import load_file

        return {k: np.asarray(v) for k, v in load_file(st).items()}
    npz = os.path.join(path, "weights.npz")
    if os.path.exists(npz):
        with np.load(npz) as data:
            return {k: np.asarray(data[k]) for k in data.files}
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(bin_path):
        state = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in state.items()}
    raise FileNotFoundError(
        f"no model.safetensors / weights.npz / pytorch_model.bin in {path}"
    )


def _strip_prefix(tensors: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop the leading module name HF sometimes nests under (`bert.`,
    `roberta.`, `0.auto_model.` for sentence-transformers exports)."""
    for prefix in ("bert.", "roberta.", "0.auto_model.", "auto_model."):
        if any(k.startswith(prefix) for k in tensors):
            return {
                (k[len(prefix):] if k.startswith(prefix) else k): v
                for k, v in tensors.items()
            }
    return tensors


def load_hf_encoder(path: str, *, dtype: str = "bfloat16"):
    """Returns (TransformerConfig, params) for a BERT-family encoder
    checkpoint directory; params are f32 CPU tensors. Tensor mapping:

      embeddings.word_embeddings.weight          -> embed [V,H]
      embeddings.position_embeddings.weight      -> pos_embed [P,H]
      embeddings.token_type_embeddings.weight    -> type_embed [T,H]
      embeddings.LayerNorm.{weight,bias}         -> embed_ln
      encoder.layer.i.attention.self.{q,k,v}     -> qkv [H,3H] (transposed,
                                                    concatenated)
      encoder.layer.i.attention.output.dense     -> out [H,H]
      encoder.layer.i.attention.output.LayerNorm -> ln1 (post-attn)
      encoder.layer.i.intermediate.dense         -> up [H,M]
      encoder.layer.i.output.dense               -> down [M,H]
      encoder.layer.i.output.LayerNorm           -> ln2 (post-mlp)

    torch Linear stores weight as [out, in]; the forward computes x @ W,
    so every dense weight is transposed on load."""
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        cfg = json.load(f)
    config = TransformerConfig(
        vocab_size=cfg["vocab_size"],
        hidden=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"],
        mlp_dim=cfg["intermediate_size"],
        max_len=cfg.get("max_position_embeddings", 512),
        causal=False,
        pooling="mean",
        norm_style="post",
        dtype=dtype,
    )

    tensors = _strip_prefix(_read_tensors(path))

    def get(name: str) -> torch.Tensor:
        if name not in tensors:
            raise KeyError(
                f"checkpoint {path} is missing tensor {name!r}; "
                f"has {sorted(tensors)[:8]}..."
            )
        return torch.from_numpy(np.array(tensors[name], dtype=np.float32))

    params: Dict[str, Any] = {
        "embed": get("embeddings.word_embeddings.weight"),
        "pos_embed": get("embeddings.position_embeddings.weight"),
        "type_embed": get("embeddings.token_type_embeddings.weight"),
        "embed_ln": {
            "scale": get("embeddings.LayerNorm.weight"),
            "bias": get("embeddings.LayerNorm.bias"),
        },
        # post-LN forward never reads ln_f; an identity keeps the tree shape
        "ln_f": {"scale": torch.ones(config.hidden), "bias": torch.zeros(config.hidden)},
        "layers": [],
    }
    for i in range(config.layers):
        p = f"encoder.layer.{i}."
        qkv = [get(p + f"attention.self.{n}.weight").T for n in ("query", "key", "value")]
        qkv_b = [get(p + f"attention.self.{n}.bias") for n in ("query", "key", "value")]
        params["layers"].append(
            {
                "qkv": torch.cat(qkv, dim=1).contiguous(),
                "qkv_b": torch.cat(qkv_b),
                "out": get(p + "attention.output.dense.weight").T.contiguous(),
                "out_b": get(p + "attention.output.dense.bias"),
                "ln1": {
                    "scale": get(p + "attention.output.LayerNorm.weight"),
                    "bias": get(p + "attention.output.LayerNorm.bias"),
                },
                "up": get(p + "intermediate.dense.weight").T.contiguous(),
                "up_b": get(p + "intermediate.dense.bias"),
                "down": get(p + "output.dense.weight").T.contiguous(),
                "down_b": get(p + "output.dense.bias"),
                "ln2": {
                    "scale": get(p + "output.LayerNorm.weight"),
                    "bias": get(p + "output.LayerNorm.bias"),
                },
            }
        )
    return config, params


def load_tokenizer(path: str, lowercase: bool | None = None):
    """WordPiece tokenizer from the checkpoint's vocab.txt, or None when
    the file is absent."""
    vocab_path = os.path.join(path, "vocab.txt")
    if not os.path.exists(vocab_path):
        return None
    if lowercase is None:
        lowercase = True
        cfg_tok = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_tok):
            with open(cfg_tok, encoding="utf-8") as f:
                lowercase = bool(json.load(f).get("do_lower_case", True))
    return WordPieceTokenizer(vocab_path, lowercase=lowercase)
