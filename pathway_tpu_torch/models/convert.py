"""Carry encoder weights from the JAX package's parameter tree to the port.

The port keeps the JAX layout (same key names, dense weights [in, out]),
so conversion is a checked tree map from numpy arrays to f32 tensors. It
covers both layouts the JAX package produces: `init_params` (pre-LN, with
`ln_f`) and `hf_loader.load_hf_encoder` (post-LN, with `type_embed`,
`embed_ln` and the HF dense weights already transposed to [in, out]).
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
