"""PyTorch transformer encoder (counterpart of pathway_tpu/models/transformer.py).

Same parameterisation and layouts as the JAX package: a nested dict of
tensors with the JAX key names, dense weights as [in, out], attention over
[B, H, L, D]. Numerics follow the JAX forward: the embedding sum in f32
then cast to the compute dtype, matmul weights and biases in the compute
dtype, LayerNorm statistics in f32, erf GELU in f32 for post-LN and tanh
GELU for pre-LN, mean pooling summed in the compute dtype, and the final
L2 normalisation in f32.

Attention over long sequences (bucketed L > 256) on the card goes through
the hand-written flash kernel (ops/kernels/flash_attention.py); packed
slabs use dense segment-masked attention, as in the JAX package. Decoder
configs and generation, and mesh parameters, are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.ops.kernels.flash_attention import (
    NEG_INF,
    flash_attention,
    reference_attention,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    mlp_dim: int = 1536
    max_len: int = 512
    causal: bool = False
    pooling: str = "mean"  # mean | cls | none
    dtype: str = "bfloat16"
    # "pre" = GPT-style pre-LN; "post" = BERT/MiniLM layout (embedding
    # LayerNorm, residual-then-LN, erf GELU), needed for HF checkpoints
    norm_style: str = "pre"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


# MiniLM-L6-class config (the reference's default embedder model family)
MINILM_L6 = TransformerConfig(
    vocab_size=30522, hidden=384, layers=6, heads=12, mlp_dim=1536
)

# the dense weights and biases that run in the compute dtype
_MATMUL_KEYS = ("qkv", "qkv_b", "out", "out_b", "up", "up_b", "down", "down_b")


def init_params(generator: torch.Generator, config: TransformerConfig) -> Dict[str, Any]:
    """Random weights with the JAX package's shapes and key names (values
    differ: torch's generator is not JAX's). Drawn on the CPU so a seed
    gives the same weights on every device."""
    h, mlp, v = config.hidden, config.mlp_dim, config.vocab_size
    scale = 0.02

    def dense(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32) * scale

    def norm():
        return {"scale": torch.ones(h), "bias": torch.zeros(h)}

    params: Dict[str, Any] = {
        "embed": dense(v, h),
        "pos_embed": dense(config.max_len, h),
        "ln_f": norm(),
        "layers": [],
    }
    for _ in range(config.layers):
        params["layers"].append(
            {
                "ln1": norm(),
                "ln2": norm(),
                "qkv": dense(h, 3 * h),
                "qkv_b": torch.zeros(3 * h),
                "out": dense(h, h),
                "out_b": torch.zeros(h),
                "up": dense(h, mlp),
                "up_b": torch.zeros(mlp),
                "down": dense(mlp, h),
                "down_b": torch.zeros(h),
            }
        )
    return params


def _compute_dtype(config: TransformerConfig) -> torch.dtype:
    return torch.bfloat16 if config.dtype == "bfloat16" else torch.float32


def _layer_norm(x, scale, bias, eps=1e-6):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    out = (x32 - mean) * (1.0 / torch.sqrt(var + eps))
    return (out * scale + bias).to(x.dtype)


def _attention(q, k, v, mask, causal: bool, use_flash):
    """Flash kernel or dense attention. q,k,v: [B,H,L,D]; mask: [B,L].
    By default flash runs on the card for L > 256, where the O(L^2)
    scores hurt; `use_flash=True` on the CPU takes the kernel's plain
    version through the same wrapper."""
    if use_flash is None:
        use_flash = q.is_cuda and q.shape[2] > 256
    if use_flash:
        return flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), mask, causal=causal
        )
    return reference_attention(q, k, v, mask, 1.0 / math.sqrt(q.shape[3]), causal)


def _segment_attention(q, k, v, seg, sm_scale):
    """Dense attention confined to same-segment pairs for packed slabs.
    q,k,v: [B,H,L,D]; seg: [B,L], 1..S per packed document, 0 = padding.
    The reference numerics (f32 scores, additive -1e30, +1e-30
    denominator), so a packed doc sees exactly the tokens it would alone.
    Pad rows give finite values that pooling never reads."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    same = (seg[:, None, :, None] == seg[:, None, None, :]) & (seg[:, None, :, None] > 0)
    s = torch.where(same, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / (p.sum(dim=-1, keepdim=True) + 1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


def _packed_positions(seg):
    """Positions that restart at every segment boundary, so a packed doc
    reads the pos_embed rows it would alone."""
    pos = torch.arange(seg.shape[1], device=seg.device).expand(seg.shape)
    is_start = torch.cat(
        [torch.ones_like(seg[:, :1], dtype=torch.bool), seg[:, 1:] != seg[:, :-1]],
        dim=1,
    )
    seg_start = torch.cummax(torch.where(is_start, pos, torch.zeros_like(pos)), dim=1).values
    return pos - seg_start


def forward(
    params,
    config: TransformerConfig,
    ids,
    mask,
    *,
    return_hidden: bool = False,
    use_flash: Optional[bool] = None,
    seg=None,
    max_segments: int = 0,
):
    """Encoder forward. ids, mask: [B, L] integer tensors. Returns pooled
    L2-normalised embeddings [B, H] (pooling != none), else logits
    [B, L, V].

    Packed mode (seg is not None): rows hold several concatenated docs told
    apart by segment ids; attention stays within a segment, positions
    restart per segment, and pooling returns [B, max_segments, H], one
    vector per packed doc slot (empty slots are zero). mask is ignored."""
    compute_dtype = _compute_dtype(config)
    post_ln = config.norm_style == "post"
    b, l = ids.shape
    ids = ids.long()
    if seg is not None:
        if config.causal:
            raise ValueError("packed segment batching requires a bidirectional encoder")
        seg = seg.long()
        # the pad run at a slab's end restarts at 0 and may count past the
        # table when the slab is longer than max_len; those rows are never
        # attended to or pooled, so clamp as the JAX gather does
        pos = _packed_positions(seg).clamp(max=params["pos_embed"].shape[0] - 1)
        x = params["embed"][ids] + params["pos_embed"][pos]
    else:
        x = params["embed"][ids] + params["pos_embed"][:l][None, :, :]
    if post_ln and "type_embed" in params:
        x = x + params["type_embed"][0][None, None, :]
    if post_ln and "embed_ln" in params:
        x = _layer_norm(x, params["embed_ln"]["scale"], params["embed_ln"]["bias"], eps=1e-12)
    x = x.to(compute_dtype)
    eps = 1e-12 if post_ln else 1e-6

    heads, hd = config.heads, config.head_dim

    def dense(y, w, bias):
        return y @ w.to(compute_dtype) + bias.to(compute_dtype)

    for layer in params["layers"]:
        y = x if post_ln else _layer_norm(x, layer["ln1"]["scale"], layer["ln1"]["bias"])
        qkv = dense(y, layer["qkv"], layer["qkv_b"])
        q, k, v = (
            t.reshape(b, l, heads, hd).transpose(1, 2) for t in qkv.split(config.hidden, dim=-1)
        )
        if seg is not None:
            ctx = _segment_attention(q, k, v, seg, 1.0 / np.sqrt(hd))
        else:
            ctx = _attention(q, k, v, mask, config.causal, use_flash)
        ctx = ctx.to(compute_dtype).transpose(1, 2).reshape(b, l, config.hidden)
        attn_out = dense(ctx, layer["out"], layer["out_b"])
        if post_ln:
            x = _layer_norm(
                x + attn_out, layer["ln1"]["scale"], layer["ln1"]["bias"], eps=eps
            ).to(compute_dtype)
            y = x
        else:
            x = x + attn_out
            y = _layer_norm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])
        y = dense(y, layer["up"], layer["up_b"])
        if post_ln:
            # exact erf GELU (BERT convention), in f32 for checkpoint parity
            y32 = y.float()
            y = (y32 * 0.5 * (1.0 + torch.erf(y32 * 0.7071067811865476))).to(compute_dtype)
        else:
            y = y * 0.5 * (1.0 + torch.tanh(0.7978845608 * (y + 0.044715 * y**3)))
        mlp_out = dense(y, layer["down"], layer["down_b"])
        if post_ln:
            x = _layer_norm(
                x + mlp_out, layer["ln2"]["scale"], layer["ln2"]["bias"], eps=eps
            ).to(compute_dtype)
        else:
            x = x + mlp_out

    if not post_ln:
        x = _layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
    if return_hidden or config.pooling == "none":
        return torch.einsum("blh,vh->blv", x.float(), params["embed"])
    if seg is not None:
        # per-segment mean pooling: one-hot segment ids contracted over the
        # token axis, [B, L, H] x [B, L, S] -> [B, S, H], summed in x.dtype
        slots = torch.arange(1, max_segments + 1, device=seg.device)
        oh = (seg[:, :, None] == slots[None, None, :]).to(x.dtype)
        pooled = torch.einsum("blh,bls->bsh", x, oh) / (oh.sum(dim=1)[:, :, None] + 1e-9)
    elif config.pooling == "cls":
        pooled = x[:, 0, :]
    else:  # mean over valid tokens
        m = mask[:, :, None].to(x.dtype)
        pooled = (x * m).sum(dim=1) / (m.sum(dim=1) + 1e-9)
    pooled = pooled.float()
    return pooled / (torch.linalg.vector_norm(pooled, dim=-1, keepdim=True) + 1e-9)


def _as_tensor_tree(tree):
    if isinstance(tree, dict):
        return {k: _as_tensor_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_tensor_tree(v) for v in tree]
    return torch.as_tensor(np.asarray(tree, dtype=np.float32) if not torch.is_tensor(tree) else tree)


class _Tree(nn.Module):
    """A nested dict of tensors in the JAX layout, held as frozen
    parameters so state_dict / .to() see them."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, _Tree(val))
            elif isinstance(val, list):
                self.add_module(key, nn.ModuleList(_Tree(v) for v in val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val.float().contiguous(), requires_grad=False)
                )

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self._parameters)
        for name, mod in self._modules.items():
            if isinstance(mod, nn.ModuleList):
                out[name] = [m.tree() for m in mod]
            else:
                out[name] = mod.tree()
        return out


def _to_device_ints(x, device) -> torch.Tensor:
    """Wire-narrowed ids / masks / segment ids (int16, or uint16 for
    32768-65535 vocabularies) upcast before any indexing."""
    if torch.is_tensor(x):
        return x.to(device=device).to(torch.int64)
    return torch.from_numpy(np.asarray(x).astype(np.int32)).to(device)


class TransformerLM(nn.Module):
    """Config + weights on one device, with the encoder entry points.
    params: a tree in the JAX layout (torch tensors or numpy arrays, e.g.
    from models/convert.params_from_jax); None draws random weights from
    `torch.Generator().manual_seed(seed)`."""

    def __init__(self, config: TransformerConfig, params=None, seed: int = 0, device=None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        if params is None:
            params = init_params(torch.Generator().manual_seed(seed), config)
        self.weights = _Tree(_as_tensor_tree(params)).to(self.device)
        self._compute = None

    def _apply(self, fn, *args, **kwargs):
        self._compute = None  # compute-dtype copies follow the weights
        return super()._apply(fn, *args, **kwargs)

    @property
    def params(self) -> Dict[str, Any]:
        """The f32 weights as a JAX-layout tree."""
        return self.weights.tree()

    def compute_params(self) -> Dict[str, Any]:
        """The tree with the dense weights and biases cast once to the
        compute dtype (the forward's casts are then no-ops)."""
        if self._compute is None:
            dt = _compute_dtype(self.config)
            tree = self.params
            tree["layers"] = [
                {k: (v.to(dt) if k in _MATMUL_KEYS else v) for k, v in layer.items()}
                for layer in tree["layers"]
            ]
            self._compute = tree
        return self._compute

    def forward(self, ids, mask, *, params=None, use_flash: Optional[bool] = None):
        """Classic encode of a bucketed [B, L] batch: pooled [B, H] f32 on
        the device (the work is queued, not waited for)."""
        with torch.no_grad():
            return forward(
                self.compute_params() if params is None else params,
                self.config,
                _to_device_ints(ids, self.device),
                _to_device_ints(mask, self.device),
                use_flash=use_flash,
            )

    def encode_packed(self, ids, seg, max_segments: int, *, params=None):
        """Packed ragged encode of tokenizer.pack_batch slabs: pooled
        [R, max_segments, H] f32 on the device; empty slots are zero."""
        with torch.no_grad():
            return forward(
                self.compute_params() if params is None else params,
                self.config,
                _to_device_ints(ids, self.device),
                None,
                seg=_to_device_ints(seg, self.device),
                max_segments=int(max_segments),
            )
