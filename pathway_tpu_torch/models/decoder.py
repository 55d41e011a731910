"""Decoder-only LM, Mistral-7B-class architecture, on PyTorch + CUDA
(counterpart of pathway_tpu/models/decoder.py).

GQA (8 kv heads against 32 q heads), RoPE, RMSNorm and SwiGLU, the
Mistral-7B recipe, with

  * prefill through the hand-written flash kernel (causal, O(L) memory;
    ops/kernels/flash_attention.py, head dim 128) on the card for L > 256;
  * a preallocated KV cache ([B, kv_heads, max_len, hd] per layer) written
    in place: the JAX package returns an updated copy, the port writes the
    slots of the cache it was given and returns that same cache;
  * a generation loop of decode steps on the device with no host sync per
    token: the tokens are gathered on the device and copied to the host
    once.

Parameters are a plain dict in the JAX package's layout and key names
(dense weights [in, out]), so models/convert.decoder_params_from_jax
carries weights across.

Tensor parallelism: `decoder_sharding_rules` gives the JAX package's
Megatron PartitionSpecs over a mesh's `tp` axis, and `decoder_tp_split`
lays a tree out into one tree per tp position by them (whole q and kv
heads per position, wo / down row shards, the tied embedding
vocab-sharded). `decoder_forward` and `generate_tokens` take such a list
in place of the tree: each position runs its heads (flash on its own
prefill), its slice of the KV cache and its vocab slice of the logits,
with a psum after wo and down (parallel/collectives.py, in the place of
the collectives XLA's partitioner inserts in the JAX package).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pathway_tpu_torch.models.transformer import (
    _attention,
    _compute_dtype,
    _to_device_ints,
    _tree_to,
    split_by_rules,
    vocab_parallel_lookup,
)
from pathway_tpu_torch.ops.kernels.knn_topk import NEG_INF
from pathway_tpu_torch.parallel.collectives import all_gather, psum
from pathway_tpu_torch.parallel.mesh import P


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    hidden: int = 4096
    layers: int = 32
    q_heads: int = 32
    kv_heads: int = 8
    mlp_dim: int = 14336
    max_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.q_heads


MISTRAL_7B_DECODER = DecoderConfig()

TINY = DecoderConfig(
    vocab_size=1024, hidden=64, layers=2, q_heads=4, kv_heads=2,
    mlp_dim=128, max_len=128, dtype="float32",
)


def init_decoder_params(
    generator: torch.Generator, config: DecoderConfig, device=None
) -> Dict[str, Any]:
    """Random weights with the JAX package's shapes and key names: dense
    weights N(0, 0.02) stored in the config dtype, f32 norm scales of one,
    no `lm_head` (the head is tied to `embed`). Values differ from JAX's:
    torch's generator is not JAX's. Each tensor is drawn in f32 on the
    generator's device and cast one at a time, so for 7B on the card the
    f32 temporaries stay at one matrix; the result lands on `device`
    (default: the generator's)."""
    device = torch.device(device) if device is not None else generator.device
    h, kv_dim = config.hidden, config.kv_heads * config.head_dim
    dtype = _compute_dtype(config)

    def dense(*shape):
        x = torch.randn(shape, generator=generator, device=generator.device) * 0.02
        return x.to(device=device, dtype=dtype)

    def ones():
        return torch.ones((h,), device=device)

    params: Dict[str, Any] = {
        "embed": dense(config.vocab_size, h),
        "ln_f": ones(),
        "layers": [],
    }
    for _ in range(config.layers):
        params["layers"].append(
            {
                "ln1": ones(),
                "ln2": ones(),
                "wq": dense(h, h),
                "wk": dense(h, kv_dim),
                "wv": dense(h, kv_dim),
                "wo": dense(h, h),
                "gate": dense(h, config.mlp_dim),
                "up": dense(h, config.mlp_dim),
                "down": dense(config.mlp_dim, h),
            }
        )
    return params


def decoder_sharding_rules(config: DecoderConfig, mesh) -> Dict[str, Any]:
    """Megatron TP specs on the mesh's 'tp' axis."""
    tp = "tp" if "tp" in mesh.axis_names else None
    layer = {
        "ln1": P(None),
        "ln2": P(None),
        "wq": P(None, tp),
        "wk": P(None, tp),
        "wv": P(None, tp),
        "wo": P(tp, None),
        "gate": P(None, tp),
        "up": P(None, tp),
        "down": P(tp, None),
    }
    return {
        "embed": P(tp, None),
        "ln_f": P(None),
        "layers": [dict(layer) for _ in range(config.layers)],
    }


def decoder_tp_split(params, config: DecoderConfig, mesh) -> list:
    """One tree per position of the mesh's tp axis, each leaf split by its
    `decoder_sharding_rules` rule and placed on the position's device. q,
    k and v split by whole heads (position t holds q heads [t QH / tp,
    (t + 1) QH / tp) and the kv heads they read, `_repeat_kv`'s order), so
    no position needs another's activations. A block is a view of its
    leaf on the leaf's own device, so on one device the split copies
    nothing."""
    tp = mesh.shape.get("tp", 1)
    if config.q_heads % tp or config.kv_heads % tp:
        raise ValueError(
            f"q heads {config.q_heads} and kv heads {config.kv_heads} must divide by the tp "
            f"axis of size {tp}"
        )
    devices = mesh.axis_devices("tp") if "tp" in mesh.axis_names else [mesh.devices.flat[0]]
    shards = split_by_rules(params, decoder_sharding_rules(config, mesh), tp)
    return [_tree_to(tree, dev) for tree, dev in zip(shards, devices)]


def _as(t, dtype):
    """t in dtype; a tensor already in it is returned as it is, without a
    call into the dispatcher (a decode step makes hundreds of these)."""
    return t if t.dtype == dtype else t.to(dtype)


def _rms_norm(x, scale, eps):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * (1.0 / torch.sqrt(var + eps)) * scale).to(x.dtype)


def _rope_tables(positions, d: int, theta: float):
    """cos and sin of RoPE's angles, [B, 1, L, d / 2] f32, for positions
    [B, L] (absolute token positions); one pair serves q and k of every
    layer."""
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[:, None, :, None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def _rope(x, cos, sin):
    """x: [B, H, L, D] rotated by the tables of `_rope_tables`."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _repeat_kv(x, n_rep: int):
    if n_rep == 1:
        return x
    b, h, l, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, l, d).reshape(b, h * n_rep, l, d)


def init_kv_cache(config: DecoderConfig, batch: int, device=None,
                  tp: int = 1) -> List[Dict[str, torch.Tensor]]:
    """Preallocated cache: per layer {'k', 'v'} [B, KVH / tp, max_len, hd]
    of zeros in the compute dtype (one tp position's kv heads)."""
    shape = (batch, config.kv_heads // tp, config.max_len, config.head_dim)
    dtype = _compute_dtype(config)
    return [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(config.layers)
    ]


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 products in full f32 (TF32 off) for the logits, as the JAX
    package computes them, whatever the caller set."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _cache_mask(kv_valid, slot_offset: int, l: int):
    """[B, 1, 1, L, slot_offset + L] True where a query may NOT attend a
    cache slot: slot j is attended when kv_valid[b, j] and j <=
    slot_offset + query index. Shared by every layer."""
    end = slot_offset + l
    slot = torch.arange(end, device=kv_valid.device)
    q_slot = slot_offset + torch.arange(l, device=kv_valid.device)
    attend = (slot[None, None, :] <= q_slot[None, :, None]) & kv_valid[:, None, :end].bool()
    return ~attend[:, None, None]


def _cache_attention(q, ck, cv, dead, n_rep: int, dtype):
    """Dense f32 attention of q [B, QH, L, hd] over the cache slots
    [0, slot_offset + L), `dead` from `_cache_mask`. The query heads are
    grouped per kv head by a reshape (head = kv head * n_rep + r,
    `_repeat_kv`'s order), so the cache is never repeated. Slots at and
    past slot_offset + L are masked for every query row, so leaving them
    out is exact for any row with a live slot, which a decode row always
    has (its own); a row with none is finite but not the JAX package's
    average over all max_len slots."""
    b, qh, l, hd = q.shape
    end = dead.shape[-1]
    kvh = qh // n_rep
    qg = q.float().reshape(b, kvh, n_rep * l, hd)
    s = (qg @ ck[:, :, :end].float().transpose(2, 3)) / math.sqrt(hd)
    s = s.reshape(b, kvh, n_rep, l, end).masked_fill(dead, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / (p.sum(dim=-1, keepdim=True) + 1e-30)
    ctx = p.to(dtype).reshape(b, kvh, n_rep * l, end) @ _as(cv[:, :, :end], dtype)
    return ctx.reshape(b, qh, l, hd)


def decoder_forward(params, config: DecoderConfig, ids, mask, *,
                    positions=None, kv_cache=None, kv_valid=None,
                    slot_offset: int = 0, use_flash: Optional[bool] = None):
    """ids, mask: [B, L] integer tensors on the weights' device
    (left-aligned prompts).

    Cacheless mode (kv_cache is None): causal attention over the batch
    (flash kernel on the card for L > 256).

    Cache mode: writes this call's K/V into slots [slot_offset,
    slot_offset + L) of the preallocated cache, in place, and attends over
    every cache slot j with kv_valid[b, j] == 1 and j <= slot_offset +
    query index. The first prefill (slot_offset == 0, L > 1) attends over
    its own K/V, causally, with kv_valid[:, :L] as the key mask: the flash
    path. Decode steps and chunked prefill take dense f32 attention over
    the cache. `positions` feeds RoPE with each row's true token position.

    Returns (logits [B, L, V] f32, the cache or None).

    Tensor parallel: params a list of `decoder_tp_split` trees and
    kv_cache a list of per-position caches (`init_kv_cache(..., tp=)`);
    ids, mask, positions and kv_valid on the first position's device.
    Returns (each position's logits over its vocab slice [B, L, V / tp],
    the caches)."""
    if isinstance(params, list):
        return _forward_positions(params, config, ids, mask, positions, kv_cache, kv_valid,
                                  slot_offset, use_flash, psum), kv_cache
    logits = _forward_positions([params], config, ids, mask, positions,
                                None if kv_cache is None else [kv_cache], kv_valid,
                                slot_offset, use_flash, lambda parts: parts)
    return logits[0], kv_cache


def _f32_product(a, w):
    """a @ w accumulated in f32 and returned unrounded: a row shard's
    partial product, so that the psum of the shards' partials rounds to
    the compute dtype once, as the unsharded product does (bf16 partials
    rounded before their sum drift apart from the unsharded decoder
    through 32 layers: row cosine 0.9987 on the card at 7B width)."""
    if a.dtype == torch.float32:
        return a @ w
    if a.is_cuda:
        flat = torch.mm(a.reshape(-1, a.shape[-1]), w, out_dtype=torch.float32)
        return flat.reshape(*a.shape[:-1], w.shape[-1])
    return a.float() @ w.float()


def _forward_positions(shards: list, config: DecoderConfig, ids, mask, positions, caches,
                       kv_valid, slot_offset: int, use_flash, reduce) -> list:
    """`decoder_forward`'s body over a list of positions: one for the
    whole tree, one per tp position. `reduce` takes every position's wo
    and down products and returns what each adds to its residual: the
    identity, or a psum where the positions hold row shards (whose
    partials are f32, `_f32_product`)."""
    dtype = _compute_dtype(config)
    product = (lambda a, w: a @ w) if len(shards) == 1 else _f32_product
    b, l = ids.shape
    if positions is None:
        positions = torch.arange(l, device=ids.device).expand(b, l)
    devices = [tree["ln_f"].device for tree in shards]
    if len(shards) == 1:
        x = [_as(shards[0]["embed"][ids.long()], dtype)]
    else:
        x = [_as(e, dtype) for e in vocab_parallel_lookup(shards, [ids.long().to(d) for d in devices])]
    hd = config.head_dim
    n_rep = config.q_heads // config.kv_heads
    is_prefill = caches is not None and slot_offset == 0 and l > 1
    cos, sin = _rope_tables(positions, hd, config.rope_theta)
    ropes = [(cos.to(d), sin.to(d)) for d in devices]
    if caches is not None:
        valid = [kv_valid.to(d) for d in devices]
        if not is_prefill:
            dead = [_cache_mask(v, slot_offset, l) for v in valid]
    if caches is None:
        masks = [mask.to(d) for d in devices]

    for li in range(config.layers):
        parts = []
        for t, xt in enumerate(x):
            layer = shards[t]["layers"][li]
            qh, kvh = layer["wq"].shape[1] // hd, layer["wk"].shape[1] // hd
            y = _rms_norm(xt, layer["ln1"], config.norm_eps)
            q = (y @ _as(layer["wq"], dtype)).reshape(b, l, qh, hd)
            k = (y @ _as(layer["wk"], dtype)).reshape(b, l, kvh, hd)
            v = (y @ _as(layer["wv"], dtype)).reshape(b, l, kvh, hd)
            q = _rope(q.transpose(1, 2), *ropes[t])
            k = _rope(k.transpose(1, 2), *ropes[t])
            v = v.transpose(1, 2)

            if caches is not None:
                ck, cv = caches[t][li]["k"], caches[t][li]["v"]
                ck[:, :, slot_offset : slot_offset + l] = k
                cv[:, :, slot_offset : slot_offset + l] = v
                if is_prefill:
                    # no slot past this call's L can be live yet, so attention
                    # over the cache is causal attention over this call's K/V
                    ctx = _attention(
                        q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                        valid[t][:, :l], True, use_flash,
                    )
                else:
                    ctx = _cache_attention(q, ck, cv, dead[t], n_rep, dtype)
            else:
                ctx = _attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), masks[t], True,
                                 use_flash)
            ctx = _as(ctx, dtype).transpose(1, 2).reshape(b, l, qh * hd)
            parts.append(product(ctx, _as(layer["wo"], dtype)))
        x = [xt + _as(p, dtype) for xt, p in zip(x, reduce(parts))]
        parts = []
        for t, xt in enumerate(x):
            layer = shards[t]["layers"][li]
            y = _rms_norm(xt, layer["ln2"], config.norm_eps)
            gate = y @ _as(layer["gate"], dtype)
            up = y @ _as(layer["up"], dtype)
            swish = gate * torch.sigmoid(gate.float()).to(dtype)
            parts.append(product(swish * up, _as(layer["down"], dtype)))
        x = [xt + _as(p, dtype) for xt, p in zip(x, reduce(parts))]

    logits = []
    for xt, tree in zip(x, shards):
        xt = _rms_norm(xt, tree["ln_f"], config.norm_eps)
        # HF Llama/Mistral checkpoints ship an untied lm_head; a random init
        # ties the head to the embedding (a tp position's vocab slice of it)
        head = tree.get("lm_head", tree["embed"])
        with _full_f32_matmul():
            logits.append(torch.einsum("blh,vh->blv", xt.float(), head.float()))
    return logits


def generate_tokens(params, config: DecoderConfig, ids, mask, *,
                    max_new_tokens: int = 16, temperature: float = 0.0,
                    seed: int = 0) -> np.ndarray:
    """Greedy or temperature generation on the weights' device. ids, mask:
    [B, L] (left-aligned prompts; numpy or tensors). Returns [B,
    max_new_tokens] int32 on the host.

    One prefill writes the prompts into a preallocated cache; then a
    Python loop of decode steps writes slot L + t for every row while RoPE
    takes each row's true position. No step waits for the host: tokens
    are chosen and gathered on the device and copied back once. Greedy is
    argmax, as in the JAX package. With temperature > 0 the tokens are
    drawn from softmax(logit / T) with a torch.Generator seeded by `seed`,
    which cannot match JAX's random draws token for token.

    params may be a list of `decoder_tp_split` trees: each tp position
    then keeps its slice of the cache and its vocab slice of the logits.
    A greedy pick takes each slice's max and its global index, then the
    max over the slices, equal scores going to the lowest index, as an
    argmax over the whole vocabulary does; a sampled pick gathers the
    logits first."""
    b, l = np.shape(ids)
    if l + max_new_tokens > config.max_len:
        raise ValueError(
            f"prompt_len ({l}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"the cache budget max_len ({config.max_len}); the decode steps "
            "would write past the preallocated cache slots"
        )
    shards = params if isinstance(params, list) else [params]
    device = shards[0]["embed"].device
    ids = _to_device_ints(ids, device).long()
    mask = _to_device_ints(mask, device).long()
    # the head in f32 once, not once per step (the same product)
    shards = [dict(tree, lm_head=tree.get("lm_head", tree["embed"]).float()) for tree in shards]
    gen = None
    if temperature != 0.0:
        gen = torch.Generator(device=device).manual_seed(seed)

    def sample(logits: list):
        """The next token [B] from each position's [B, V / tp] logits."""
        if temperature == 0.0:
            if len(logits) == 1:
                return logits[0].argmax(dim=-1)
            width = logits[0].shape[-1]
            best = [lg.max(dim=-1) for lg in logits]
            vals = torch.stack([m.values.to(device) for m in best])
            idx = torch.stack([(m.indices + t * width).to(device) for t, m in enumerate(best)])
            return idx.gather(0, vals.argmax(dim=0)[None])[0]
        logit = all_gather(logits, axis=-1)[0] if len(logits) > 1 else logits[0]
        probs = torch.softmax(logit / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def forward(*args, **kwargs) -> list:
        logits, _ = decoder_forward(shards if len(shards) > 1 else shards[0], config,
                                    *args, **kwargs)
        return logits if len(shards) > 1 else [logits]

    with torch.no_grad():
        positions = mask.cumsum(dim=1) - 1
        lengths = mask.sum(dim=1)
        caches = [init_kv_cache(config, b, tree["ln_f"].device, tp=len(shards)) for tree in shards]
        kv_valid = torch.zeros((b, config.max_len), dtype=torch.int32, device=device)
        kv_valid[:, :l] = mask
        logits = forward(ids, mask, positions=positions,
                         kv_cache=caches if len(shards) > 1 else caches[0],
                         kv_valid=kv_valid, slot_offset=0)
        rows = torch.arange(b, device=device)
        tok = sample([lg[rows.to(lg.device), (lengths - 1).to(lg.device)] for lg in logits])
        toks = torch.empty((b, max_new_tokens), dtype=torch.int64, device=device)
        ones = torch.ones((b, 1), dtype=torch.int64, device=device)
        for t in range(max_new_tokens):
            toks[:, t] = tok
            if t == max_new_tokens - 1:
                break  # the JAX scan's last step feeds a token it never returns
            kv_valid[:, l + t] = 1
            logits = forward(tok[:, None], ones, positions=(lengths + t)[:, None],
                             kv_cache=caches if len(shards) > 1 else caches[0],
                             kv_valid=kv_valid, slot_offset=l + t)
            tok = sample([lg[:, 0] for lg in logits])
    return toks.cpu().numpy().astype(np.int32)
