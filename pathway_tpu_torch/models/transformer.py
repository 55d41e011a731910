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
slabs use dense segment-masked attention, as in the JAX package. The
decoder configs (`MISTRAL_7B`, `TINY_DECODER`) and `TransformerLM.generate`
(greedy, recomputing the prefix) are here too; the KV-cached decoder is
models/decoder.py.

Tensor parallelism: `param_sharding_rules` gives the JAX package's
PartitionSpecs over a mesh's `tp` axis, `tp_split` / `tp_gather` lay a
tree out into per-shard trees and back, and `tp_forward` runs `forward`'s
math Megatron-style over the list of shards, with parallel/collectives.py
in the place of the collectives XLA's partitioner inserts in the JAX
package; `tp_encode` is the pooled encode over them, classic and packed.
`TransformerLM.mesh_params` caches a mesh's tp shards per dp position, and
the encoder entry points take them as `params=`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from pathway_tpu_torch._device import resolve_device, to_device
from pathway_tpu_torch.ops.kernels.flash_attention import (
    NEG_INF,
    flash_attention,
    reference_attention,
)
from pathway_tpu_torch.parallel.collectives import psum
from pathway_tpu_torch.parallel.mesh import P, dp_axis


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

# Mistral-7B-class geometry (the reference's Private-RAG HFPipelineChat
# target); instantiate smaller variants for tests
MISTRAL_7B = TransformerConfig(
    vocab_size=32000,
    hidden=4096,
    layers=32,
    heads=32,
    mlp_dim=14336,
    max_len=4096,
    causal=True,
    pooling="none",
)

TINY_DECODER = TransformerConfig(
    vocab_size=1024,
    hidden=64,
    layers=2,
    heads=4,
    mlp_dim=128,
    max_len=128,
    causal=True,
    pooling="none",
)

# the dense weights and biases that run in the compute dtype
_MATMUL_KEYS = ("qkv", "qkv_b", "out", "out_b", "up", "up_b", "down", "down_b")


def init_params(generator: torch.Generator, config: TransformerConfig) -> Dict[str, Any]:
    """Random f32 weights with the JAX package's shapes and key names
    (values differ: torch's generator is not JAX's), drawn on the
    generator's device. A CPU generator gives the same weights whatever
    device they go to; a CUDA one draws a 7B-class tree on the card in
    well under a second."""
    h, mlp, v = config.hidden, config.mlp_dim, config.vocab_size
    scale = 0.02
    device = generator.device

    def dense(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device).mul_(scale)

    def norm():
        return {"scale": torch.ones(h, device=device), "bias": torch.zeros(h, device=device)}

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
                "qkv_b": torch.zeros(3 * h, device=device),
                "out": dense(h, h),
                "out_b": torch.zeros(h, device=device),
                "up": dense(h, mlp),
                "up_b": torch.zeros(mlp, device=device),
                "down": dense(mlp, h),
                "down_b": torch.zeros(h, device=device),
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


# attention over more keys than this takes the flash kernel on the card,
# where dense attention's O(L^2) scores hurt
FLASH_MIN_LEN = 256


def _attention(q, k, v, mask, causal: bool, use_flash):
    """Flash kernel or dense attention. q,k,v: [B,H,L,D]; mask: [B,L].
    By default flash runs on the card for L > FLASH_MIN_LEN; `use_flash=True`
    on the CPU takes the kernel's plain version through the same wrapper."""
    if use_flash is None:
        use_flash = q.is_cuda and q.shape[2] > FLASH_MIN_LEN
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
    hd = config.head_dim

    def attend(q, k, v):
        if seg is not None:
            return [_segment_attention(q[0], k[0], v[0], seg, 1.0 / np.sqrt(hd))]
        return [_attention(q[0], k[0], v[0], mask, config.causal, use_flash)]

    for layer in params["layers"]:
        if not post_ln:
            x = _pre_ln_layer([x], [layer], attend, hd, compute_dtype)[0]
            continue
        ctx = _self_attention([x], [layer], attend, hd, compute_dtype)[0]
        x = _layer_norm(
            x + _dense(ctx, layer["out"], layer["out_b"], compute_dtype),
            layer["ln1"]["scale"], layer["ln1"]["bias"], eps=1e-12,
        ).to(compute_dtype)
        # exact erf GELU (BERT convention), in f32 for checkpoint parity
        y32 = _dense(x, layer["up"], layer["up_b"], compute_dtype).float()
        y = (y32 * 0.5 * (1.0 + torch.erf(y32 * 0.7071067811865476))).to(compute_dtype)
        x = _layer_norm(
            x + _dense(y, layer["down"], layer["down_b"], compute_dtype),
            layer["ln2"]["scale"], layer["ln2"]["bias"], eps=1e-12,
        ).to(compute_dtype)

    if not post_ln:
        x = _final_norm(x, params)
    if return_hidden or config.pooling == "none":
        return _tied_logits(x, params)
    return _pool(x, config, mask, seg, max_segments)


def _pool(x, config: TransformerConfig, mask, seg, max_segments: int):
    """Pooled, L2-normalised rows of the final hidden states x [B, L, H]:
    one per packed doc slot ([B, max_segments, H]) when seg is given, else
    the CLS token or the mean over the mask's valid tokens ([B, H])."""
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
    return _normalize(pooled)


def _gelu_tanh(y):
    return y * 0.5 * (1.0 + torch.tanh(0.7978845608 * (y + 0.044715 * y**3)))


def _dense(y, w, bias, compute_dtype):
    return y @ w.to(compute_dtype) + bias.to(compute_dtype)


def _self_attention(ys: list, layers: list, attend, head_dim: int, compute_dtype) -> list:
    """The qkv projection, heads split, `attend`, heads merged, over a list
    of positions (one for `forward`, or a mesh axis's). ys: [B, L, H] per
    position; layers: each position's layer tree, whose qkv may hold a tp
    shard's heads. attend(qs, ks, vs) -> the [B, heads, L, D] contexts.
    Returns [B, L, heads * D] per position, before the out projection."""
    qkvs = []
    for y, layer in zip(ys, layers):
        b, l, _ = y.shape
        width = layer["qkv"].shape[1] // 3
        qkvs.append([
            u.reshape(b, l, width // head_dim, head_dim).transpose(1, 2)
            for u in _dense(y, layer["qkv"], layer["qkv_b"], compute_dtype).split(width, dim=-1)
        ])
    ctx = attend(*([t[j] for t in qkvs] for j in range(3)))
    return [c.to(compute_dtype).transpose(1, 2).reshape(*y.shape[:2], -1) for c, y in zip(ctx, ys)]


def _pre_ln_layer(x: list, layers: list, attend, head_dim: int, compute_dtype,
                  reduce=lambda parts: parts) -> list:
    """One pre-LN block (LN1, attention, out, residual, LN2, up, tanh GELU,
    down, residual) over a list of positions: one for `forward`, one per
    position of a tp or sp axis. `reduce` takes every position's out and
    down products, before their biases, and returns what each position
    adds: the identity, or a psum where the positions hold row shards."""
    ys = [_layer_norm(xt, layer["ln1"]["scale"], layer["ln1"]["bias"]) for xt, layer in zip(x, layers)]
    ctx = _self_attention(ys, layers, attend, head_dim, compute_dtype)
    parts = reduce([c @ layer["out"].to(compute_dtype) for c, layer in zip(ctx, layers)])
    x = [xt + (s + layer["out_b"].to(compute_dtype)) for xt, s, layer in zip(x, parts, layers)]
    parts = reduce([
        _gelu_tanh(_dense(_layer_norm(xt, layer["ln2"]["scale"], layer["ln2"]["bias"]),
                          layer["up"], layer["up_b"], compute_dtype))
        @ layer["down"].to(compute_dtype)
        for xt, layer in zip(x, layers)
    ])
    return [xt + (s + layer["down_b"].to(compute_dtype)) for xt, s, layer in zip(x, parts, layers)]


def _final_norm(x, params):
    return _layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])


def _tied_logits(x, params):
    """Logits [B, L, V] in f32 against the (tied) embedding table, or
    against a tp position's vocab shard of it."""
    return torch.einsum("blh,vh->blv", x.float(), params["embed"])


def _normalize(pooled):
    """L2-normalised rows, in f32."""
    pooled = pooled.float()
    return pooled / (torch.linalg.vector_norm(pooled, dim=-1, keepdim=True) + 1e-9)


# -- tensor parallelism over a mesh's `tp` axis ----------------------------------

# qkv's columns are [q | k | v]; its tp shard t holds the t-th column block
# of each of the three (whole heads of q, k and v), so a shard's attention
# needs no other shard's activations
_QKV_KEYS = ("qkv", "qkv_b")


def param_sharding_rules(config: TransformerConfig, mesh) -> Dict[str, Any]:
    """PartitionSpecs for tensor parallelism on the mesh's 'tp' axis:
    qkv/up column-sharded, out/down row-sharded (Megatron-style),
    embeddings vocab-sharded, the rest replicated."""
    tp = "tp" if "tp" in mesh.axis_names else None
    return {
        "embed": P(tp, None),
        "pos_embed": P(None, None),
        "ln_f": {"scale": P(None), "bias": P(None)},
        "layers": [
            {
                "ln1": {"scale": P(None), "bias": P(None)},
                "ln2": {"scale": P(None), "bias": P(None)},
                "qkv": P(None, tp),
                "qkv_b": P(tp),
                "out": P(tp, None),
                "out_b": P(None),
                "up": P(None, tp),
                "up_b": P(tp),
                "down": P(tp, None),
                "down_b": P(None),
            }
            for _ in range(config.layers)
        ],
    }


def _leaves_with_specs(params, rules, key=None):
    """(key, leaf, spec) for each leaf of `params`, walking `rules` beside
    it; `key` is the leaf's own name in its dict."""
    if isinstance(params, dict):
        if set(params) != set(rules):
            raise ValueError(
                f"parameters {sorted(params)} do not match the sharding rules' {sorted(rules)}"
            )
        for k in params:
            yield from _leaves_with_specs(params[k], rules[k], k)
    elif isinstance(params, (list, tuple)):
        for p, r in zip(params, rules, strict=True):
            yield from _leaves_with_specs(p, r)
    else:
        yield key, params, rules


def _leaves(tree):
    """The leaves of a nested dict / list tree, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _rebuild(tree, leaves):
    """`tree`'s structure with its leaves taken in order from `leaves`."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def _sharded_dim(spec) -> Optional[int]:
    dims = [i for i, axis in enumerate(spec) if axis is not None]
    if len(dims) > 1:
        raise ValueError(f"{spec}: at most one dim may be sharded")
    return dims[0] if dims else None


def split_by_rules(params, rules, tp: int, groups=lambda key: 1) -> list:
    """One tree per position of a tp axis of size `tp`: each leaf split by
    its rule into `tp` equal blocks along its sharded dim (a replicated
    leaf is the same tensor in every tree). A leaf whose key has
    groups(key) > 1 is that many column blocks side by side (qkv's q, k
    and v), and position t takes the t-th block of each. A block of a
    one-group leaf is a view of it, so splitting copies nothing; a size
    that does not divide by tp raises, as JAX's even sharding does."""
    per_leaf = []
    for key, leaf, spec in _leaves_with_specs(params, rules):
        dim = _sharded_dim(spec)
        if dim is None:
            per_leaf.append([leaf] * tp)
            continue
        n = groups(key)
        if leaf.shape[dim] % (n * tp):
            raise ValueError(
                f"{key} of shape {tuple(leaf.shape)}, sharded {spec}, does not split evenly "
                f"over the tp axis of size {tp}"
            )
        if n == 1:
            per_leaf.append(list(leaf.chunk(tp, dim)))
            continue
        blocks = [b.chunk(tp, dim) for b in leaf.chunk(n, dim)]
        per_leaf.append([torch.cat([b[t] for b in blocks], dim) for t in range(tp)])
    return [_rebuild(params, iter(leaves)) for leaves in zip(*per_leaf)]


def tp_split(params, config: TransformerConfig, mesh) -> list:
    """One tree per position of the mesh's tp axis: each leaf split by its
    `param_sharding_rules` rule (`split_by_rules`)."""
    return split_by_rules(
        params, param_sharding_rules(config, mesh), mesh.shape.get("tp", 1),
        groups=lambda key: 3 if key in _QKV_KEYS else 1,
    )


def tp_gather(shards: list, config: TransformerConfig, mesh) -> Dict[str, Any]:
    """The full tree from `tp_split`'s per-shard trees, on the first
    shard's devices."""
    rules = param_sharding_rules(config, mesh)
    per_shard = [list(_leaves_with_specs(tree, rules)) for tree in shards]
    leaves = []
    for parts in zip(*per_shard):
        key, first, spec = parts[0]
        dim = _sharded_dim(spec)
        if dim is None:
            leaves.append(first)
            continue
        groups = 3 if key in _QKV_KEYS else 1
        pieces = [p[1].to(first.device).chunk(groups, dim) for p in parts]
        leaves.append(torch.cat([piece[g] for g in range(groups) for piece in pieces], dim))
    return _rebuild(shards[0], iter(leaves))


def _mesh_position(mesh, dp: int = 0, tp: int = 0) -> torch.device:
    """The device at dp position `dp` and tp position `tp` of a mesh (the
    other axes at 0); an axis the mesh lacks is at 0. Where the dp axis
    is `tp` itself (a one-axis `tp` mesh), the tp position decides."""
    position = {dp_axis(mesh): dp}
    if "tp" in mesh.axis_names:
        position["tp"] = tp
    return mesh.device(**position)


def _tree_device(tree) -> torch.device:
    """The device of a param tree (of its final norm's scale)."""
    return tree["ln_f"]["scale"].device


def _tree_to(tree, device):
    """`tree` with every leaf on `device`; a leaf already there is itself."""
    return _rebuild(tree, (p.to(device) for p in _leaves(tree)))


def vocab_parallel_lookup(shards: list, ids: list, key: str = "embed") -> list:
    """Rows of a vocab-sharded table: position t holds rows [t * R, (t + 1)
    * R) of shards[t][key] and looks up only the ids in its range (zeros
    elsewhere); the psum adds the lookups, so each position gets every
    row, exactly. ids: one [B, L] tensor per position, on its device."""
    rows = shards[0][key].shape[0]
    lookups = []
    for t, (tree, tid) in enumerate(zip(shards, ids)):
        local = tid - t * rows
        hit = (local >= 0) & (local < rows)
        lookups.append(tree[key][local.clamp(0, rows - 1)] * hit[..., None].to(tree[key].dtype))
    return psum(lookups)


def _tp_hidden(shards: list, config: TransformerConfig, ids, mask, *, seg=None,
               use_flash: Optional[bool] = None) -> list:
    """The final-normed hidden states [B, L, H] of `forward` (pre-LN) on
    every tp position, Megatron-style: one param tree per position from
    `tp_split`, each on its position's device. ids, mask (or seg for a
    packed slab): [B, L], the same batch for every position.

    qkv and up are column shards (whole heads per shard), out and down row
    shards each followed by a psum; the embedding is vocab-sharded, so a
    shard looks up only the ids in its range and a psum adds the lookups.
    LayerNorms, pos_embed and the out / down biases are replicated. A
    position attends over its own heads, [B, H / tp, L, D]: through flash
    on the card for L > FLASH_MIN_LEN, or within segments for a slab."""
    if config.norm_style != "pre":
        raise ValueError("tensor parallelism runs the pre-LN layout only")
    compute_dtype = _compute_dtype(config)
    devices = [_tree_device(tree) for tree in shards]
    tp = len(shards)
    l = ids.shape[1]
    if config.heads % tp:
        raise ValueError(f"heads {config.heads} not divisible by the tp axis of size {tp}")
    ids = [ids.long().to(dev) for dev in devices]
    if seg is not None:
        if config.causal:
            raise ValueError("packed segment batching requires a bidirectional encoder")
        segs = [seg.long().to(dev) for dev in devices]
        table = shards[0]["pos_embed"].shape[0]
        pos = [tree["pos_embed"][_packed_positions(s).clamp(max=table - 1)]
               for s, tree in zip(segs, shards)]
    else:
        masks = [mask.to(dev) for dev in devices]
        pos = [tree["pos_embed"][:l][None, :, :] for tree in shards]
    x = [(e + p).to(compute_dtype) for e, p in zip(vocab_parallel_lookup(shards, ids), pos)]
    hd = config.head_dim

    def attend(qs, ks, vs):
        if seg is not None:
            return [_segment_attention(q, k, v, s, 1.0 / np.sqrt(hd))
                    for q, k, v, s in zip(qs, ks, vs, segs)]
        return [_attention(q, k, v, m, config.causal, use_flash)
                for q, k, v, m in zip(qs, ks, vs, masks)]

    for i in range(config.layers):
        layers = [tree["layers"][i] for tree in shards]
        x = _pre_ln_layer(x, layers, attend, hd, compute_dtype, reduce=psum)
    return [_final_norm(xt, tree) for xt, tree in zip(x, shards)]


def tp_forward(shards: list, config: TransformerConfig, ids, mask) -> list:
    """`forward(..., return_hidden=True)` (pre-LN, unpacked) over the tp
    axis (`_tp_hidden`). Returns each position's logits over its vocab
    shard, [B, L, V / tp]: the caller reduces them where it needs them
    (the training loss does so vocab-parallel, never gathering [B, L, V])."""
    return [_tied_logits(xt, tree) for xt, tree in zip(_tp_hidden(shards, config, ids, mask), shards)]


def tp_encode(shards: list, config: TransformerConfig, ids, mask, *, seg=None,
              max_segments: int = 0, use_flash: Optional[bool] = None):
    """`forward`'s pooled encode over the tp axis (`_tp_hidden`), classic
    ([B, H]) or packed ([B, max_segments, H] when seg is given): the JAX
    package's encode with `mesh_params`. The hidden states are replicated
    after the last psum, so the first position pools them; the result is
    on its device."""
    x = _tp_hidden(shards, config, ids, mask, seg=seg, use_flash=use_flash)[0]
    dev = x.device
    return _pool(x, config, None if mask is None else mask.to(dev),
                 None if seg is None else seg.long().to(dev), max_segments)


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
        return to_device(x, device).to(torch.int64)
    return to_device(torch.from_numpy(np.asarray(x).astype(np.int32)), device)


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
        self._placed: dict = {}
        self._mesh_params: Optional[tuple] = None

    def _apply(self, fn, *args, **kwargs):
        # compute-dtype copies and mesh shards follow the weights
        self._compute = None
        self._placed = {}
        self._mesh_params = None
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

    def params_on(self, device) -> Dict[str, Any]:
        """The compute-dtype tree on `device` (the tree itself on the
        weights' device), copied once per device."""
        device = torch.device(device)
        if device not in self._placed:
            self._placed[device] = _tree_to(self.compute_params(), device)
        return self._placed[device]

    def mesh_params(self, mesh) -> list:
        """Tensor-parallel copies of the weights for a mesh: for each
        position of the mesh's dp axis, the `tp_split` trees of the
        compute-dtype weights, tree t on the device at (dp, tp = t); cached
        per mesh. Without a tp axis a position's one tree is `params_on`
        its device. On one device the positions share their tensors, and a
        shard of a one-group leaf is a view, so only qkv's shards copy.
        The encoder entry points take a dp position's list as `params=`."""
        cached = self._mesh_params
        if cached is not None and cached[0] is mesh:
            return cached[1]
        positions = range(mesh.shape[dp_axis(mesh)])
        if "tp" not in mesh.axis_names:
            placed = [[self.params_on(_mesh_position(mesh, dp=d))] for d in positions]
        else:
            shards = tp_split(self.compute_params(), self.config, mesh)
            placed = [
                [_tree_to(tree, _mesh_position(mesh, dp=d, tp=t)) for t, tree in enumerate(shards)]
                for d in positions
            ]
        self._mesh_params = (mesh, placed)
        return placed

    def forward(self, ids, mask, *, params=None, use_flash: Optional[bool] = None):
        """Classic encode of a bucketed [B, L] batch: pooled [B, H] f32 on
        the device of the weights it runs (the work is queued, not waited
        for). params: a tree (on any device), or a list of tp trees, one
        dp position of `mesh_params`."""
        params = self.compute_params() if params is None else params
        with torch.no_grad():
            if isinstance(params, list):
                dev = _tree_device(params[0])
                return tp_encode(params, self.config, _to_device_ints(ids, dev),
                                 _to_device_ints(mask, dev), use_flash=use_flash)
            dev = _tree_device(params)
            return forward(
                params,
                self.config,
                _to_device_ints(ids, dev),
                _to_device_ints(mask, dev),
                use_flash=use_flash,
            )

    def encode_packed(self, ids, seg, max_segments: int, *, params=None):
        """Packed ragged encode of tokenizer.pack_batch slabs: pooled
        [R, max_segments, H] f32 on the weights' device; empty slots are
        zero. params as `forward`'s."""
        params = self.compute_params() if params is None else params
        with torch.no_grad():
            if isinstance(params, list):
                dev = _tree_device(params[0])
                return tp_encode(params, self.config, _to_device_ints(ids, dev), None,
                                 seg=_to_device_ints(seg, dev), max_segments=int(max_segments))
            dev = _tree_device(params)
            return forward(
                params,
                self.config,
                _to_device_ints(ids, dev),
                None,
                seg=_to_device_ints(seg, dev),
                max_segments=int(max_segments),
            )

    def generate(self, ids, mask, max_new_tokens: int = 16) -> np.ndarray:
        """Greedy decode that recomputes the whole prefix each step, with
        the JAX package's rules: prompts longer than max_len are cut, the
        [B, L] buffer doubles (up to max_len) when a row reaches its end,
        and decoding stops early once the buffer is full at max_len.
        ids, mask: [B, L] left-aligned. Returns [B, steps] int32."""
        ids = np.array(ids)
        mask = np.array(mask)
        max_len = self.config.max_len
        if ids.shape[1] > max_len:
            ids = ids[:, :max_len]
            mask = mask[:, :max_len]
        out_tokens = []
        for _ in range(max_new_tokens):
            logits = self(ids, mask)
            lengths = mask.sum(axis=1) - 1
            b, l = ids.shape
            rows = torch.arange(b, device=logits.device)
            last = logits[rows, torch.from_numpy(lengths).to(logits.device)]
            nxt = last.argmax(-1).cpu().numpy().astype(np.int32)
            out_tokens.append(nxt)
            if (lengths + 1 >= l).any():
                if l >= max_len:
                    # the position table is the hard ceiling
                    break
                grow = min(l, max_len - l)
                ids = np.concatenate([ids, np.zeros((b, grow), dtype=ids.dtype)], axis=1)
                mask = np.concatenate([mask, np.zeros((b, grow), dtype=mask.dtype)], axis=1)
            ids[np.arange(b), lengths + 1] = nxt
            mask[np.arange(b), lengths + 1] = 1
        return np.stack(out_tokens, axis=1)
