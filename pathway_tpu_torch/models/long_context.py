"""Long-context forward: the whole transformer under sequence parallelism
(counterpart of pathway_tpu/models/long_context.py).

Runs the full layer stack over the chunks of a mesh's `sp` axis:
activations stay sequence-sharded end to end ([B, L/sp, H] per position),
attention is exact ring attention or Ulysses all-to-all
(parallel/ring_attention.py), and everything else (LayerNorm, QKV and MLP
matmuls) is per-token work on each chunk. Context length scales with the
number of devices.

Params are replicated over sp (they're O(H^2); activations at long L are
the memory problem sequence parallelism solves). Each position reads them
through `.to(its device)`, so positions that share a device share the
tensors: four sp positions on one card hold one copy of a 7B model.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pathway_tpu_torch.models.transformer import (
    TransformerConfig,
    _compute_dtype,
    _final_norm,
    _leaves,
    _normalize,
    _pre_ln_layer,
    _rebuild,
    _tied_logits,
)
from pathway_tpu_torch.parallel.collectives import psum
from pathway_tpu_torch.parallel.ring_attention import ring_attention, ulysses_attention


def _local_forward(params: list, config: TransformerConfig, ids: list, masks: list,
                   *, attn: str, use_flash):
    """The body over the sp chunks: params, ids, masks hold one entry per
    position (ids / masks: its [B, C] chunk), each on its position's
    device. Returns one output per position: its [B, C, V] logits, or the
    pooled [B, H] (the same at every position)."""
    compute_dtype = _compute_dtype(config)
    c = ids[0].shape[1]
    x = []
    for my, (p, chunk) in enumerate(zip(params, ids)):
        # global positions of this chunk for the positional table
        pos = torch.arange(my * c, (my + 1) * c, device=chunk.device)
        x.append((p["embed"][chunk] + p["pos_embed"][pos][None, :, :]).to(compute_dtype))

    def attend(q, k, v):
        if attn == "ring":
            return ring_attention(q, k, v, masks, causal=config.causal)
        return ulysses_attention(q, k, v, masks, causal=config.causal, use_flash=use_flash)

    for i in range(config.layers):
        layers = [p["layers"][i] for p in params]
        x = _pre_ln_layer(x, layers, attend, config.head_dim, compute_dtype)

    x = [_final_norm(xt, p) for xt, p in zip(x, params)]
    if config.pooling == "none":
        return [_tied_logits(xt, p) for xt, p in zip(x, params)]
    # mean pooling needs the cross-chunk sums: two tiny psums
    m = [mt[:, :, None].to(xt.dtype) for xt, mt in zip(x, masks)]
    sums = psum([(xt * mt).sum(1) for xt, mt in zip(x, m)])
    counts = psum([mt.sum(1) for mt in m])
    return [_normalize(s / (n + 1e-9)) for s, n in zip(sums, counts)]


def sequence_parallel_forward(params, config: TransformerConfig, ids, mask, mesh, *,
                              axis_name: str = "sp", attn: str = "ring",
                              use_flash: Optional[bool] = None):
    """Run the transformer (pre-LN) with sequences sharded over `axis_name`
    of `mesh`. ids, mask: [B, L] (tensors or arrays) with L divisible by
    the axis size; params: the tree of `forward`. Returns logits [B, L, V]
    (pooling='none') or pooled [B, H], on the mesh's first device along
    the axis. `use_flash=None` runs Ulysses' attention through flash on a
    CUDA device."""
    if attn not in ("ring", "ulysses"):
        raise ValueError(f"attn must be 'ring' or 'ulysses', not {attn!r}")
    if config.norm_style != "pre":
        raise ValueError("sequence_parallel_forward runs the pre-LN layout only")
    devices = mesh.axis_devices(axis_name)
    sp = len(devices)
    ids, mask = (a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a)) for a in (ids, mask))
    l = ids.shape[1]
    if l % sp != 0:
        raise ValueError(f"sequence length {l} not divisible by sp={sp}")
    leaves = list(_leaves(params))
    # `.to` of a tensor to its own device is that tensor: no copy per position
    shard_params = [_rebuild(params, (p.to(dev) for p in leaves)) for dev in devices]
    ids_c = [chunk.long().to(dev) for chunk, dev in zip(ids.chunk(sp, dim=1), devices)]
    mask_c = [chunk.to(dev) for chunk, dev in zip(mask.chunk(sp, dim=1), devices)]
    outs = _local_forward(shard_params, config, ids_c, mask_c, attn=attn, use_flash=use_flash)
    if config.pooling == "none":
        return torch.cat([o.to(devices[0]) for o in outs], dim=1)
    return outs[0]
