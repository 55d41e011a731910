"""Carry weights from the JAX package's parameter trees to the port.

The port keeps the JAX layout (same key names, dense weights [in, out]),
so conversion is a checked tree map from numpy arrays to f32 tensors. It
covers both layouts the JAX package produces: `init_params` (pre-LN, with
`ln_f`) and `hf_loader.load_hf_encoder` (post-LN, with `type_embed`,
`embed_ln` and the HF dense weights already transposed to [in, out]).
`decoder_params_from_jax` does the same for the decoder's tree
(models/decoder.py), keeping each array's dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_TOP_KEYS = {"embed", "pos_embed", "ln_f", "layers", "type_embed", "embed_ln"}
_LAYER_KEYS = {
    "ln1", "ln2", "qkv", "qkv_b", "out", "out_b", "up", "up_b", "down", "down_b",
}


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _norm(tree) -> Dict[str, torch.Tensor]:
    return {"scale": _tensor(tree["scale"]), "bias": _tensor(tree["bias"])}


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """JAX encoder parameters as numpy arrays (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) -> the port's tree of
    f32 CPU tensors, accepted by ``TransformerLM(config, params=...)``."""
    unknown = set(tree) - _TOP_KEYS
    if unknown:
        raise KeyError(f"unknown encoder parameters {sorted(unknown)}")
    out: Dict[str, Any] = {
        "embed": _tensor(tree["embed"]),
        "pos_embed": _tensor(tree["pos_embed"]),
        "ln_f": _norm(tree["ln_f"]),
        "layers": [],
    }
    if "type_embed" in tree:
        out["type_embed"] = _tensor(tree["type_embed"])
    if "embed_ln" in tree:
        out["embed_ln"] = _norm(tree["embed_ln"])
    for i, layer in enumerate(tree["layers"]):
        if set(layer) != _LAYER_KEYS:
            raise KeyError(f"layer {i} has keys {sorted(layer)}, expected {sorted(_LAYER_KEYS)}")
        out["layers"].append(
            {
                k: (_norm(v) if k in ("ln1", "ln2") else _tensor(v))
                for k, v in layer.items()
            }
        )
    return out


_DECODER_TOP_KEYS = {"embed", "ln_f", "layers", "lm_head"}
_DECODER_LAYER_KEYS = {"ln1", "ln2", "wq", "wk", "wv", "wo", "gate", "up", "down"}


def _decoder_tensor(x) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, which torch cannot read
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def decoder_params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """JAX decoder parameters as numpy arrays (``init_decoder_params`` or
    ``load_hf_decoder``, through ``jax.tree_util.tree_map(np.asarray,
    params)``) -> the port's tree of CPU tensors in the same dtypes,
    accepted by models/decoder.py. `lm_head` is optional."""
    unknown = set(tree) - _DECODER_TOP_KEYS
    missing = {"embed", "ln_f", "layers"} - set(tree)
    if unknown or missing:
        raise KeyError(f"decoder parameters: unknown {sorted(unknown)}, missing {sorted(missing)}")
    out: Dict[str, Any] = {
        k: _decoder_tensor(tree[k]) for k in ("embed", "ln_f", "lm_head") if k in tree
    }
    out["layers"] = []
    for i, layer in enumerate(tree["layers"]):
        if set(layer) != _DECODER_LAYER_KEYS:
            raise KeyError(
                f"layer {i} has keys {sorted(layer)}, expected {sorted(_DECODER_LAYER_KEYS)}"
            )
        out["layers"].append({k: _decoder_tensor(v) for k, v in layer.items()})
    return out
