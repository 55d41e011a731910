"""Sequence parallelism: ring attention and Ulysses all-to-all
(counterpart of pathway_tpu/parallel/ring_attention.py).

Sequences shard over an `sp` mesh axis, so context length scales with the
number of devices: KV chunks rotate around the ring (ring attention) or
heads reshard through an all-to-all (Ulysses). Where the JAX functions run
inside `shard_map` on one device's chunk, these take the list of every
position's chunk, one per mesh position along the axis, each on its
position's device, and return the list of output chunks. The ring's hop
loop sees every position's KV chunk at each hop; the collectives are
parallel/collectives.py's.

Online-softmax accumulation makes the ring exact (the same numbers as full
attention), not an approximation: per hop it is the JAX package's plain
f32 online softmax, which is not a kernel there either. Ulysses runs each
position's H/sp heads over the full sequence through `flash_attention`,
the card's kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from pathway_tpu_torch.ops.kernels.flash_attention import flash_attention, reference_attention
from pathway_tpu_torch.parallel.collectives import all_gather, all_to_all, ppermute

NEG_INF = -1e30


def _one_chunk(q32, k_chunk, v_chunk, kvm, q_pos, k_pos, m, l, acc, sm_scale, causal):
    """One hop's online-softmax update of (m, l, acc) for q against one
    KV chunk, in f32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k_chunk.float()) * sm_scale
    s = s + (1.0 - kvm[:, None, None, :].float()) * NEG_INF
    if causal:
        s = torch.where((q_pos[:, None] >= k_pos[None, :])[None, None], s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v_chunk.float())
    return m_new, l_new, acc_new


def ring_attention(qs: Sequence[torch.Tensor], ks, vs, kv_masks, *, causal: bool = False,
                   sm_scale: Optional[float] = None) -> list:
    """Exact attention over a sequence sharded on a mesh axis.

    qs, ks, vs: one [B, H, C, D] chunk per position (C = L / sp);
    kv_masks: one [B, C] chunk of the padding mask per position (1 = valid).
    Returns one [B, H, C, D] output chunk per position.

    At hop s position `my` holds the KV chunk of position (my - s) % sp,
    attends its queries to it, and the chunks rotate one hop around the
    ring; running (max, normaliser, accumulator) carry across hops, so the
    [L, L] scores never exist. With `causal`, a chunk wholly in a
    position's future is skipped (the ring still rotates)."""
    sp = len(qs)
    b, h, c, d = qs[0].shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    rot = [(i, (i + 1) % sp) for i in range(sp)]
    q32 = [q.float() for q in qs]
    positions = [torch.arange(my * c, (my + 1) * c, device=q.device) for my, q in enumerate(qs)]
    m = [torch.full((b, h, c, 1), NEG_INF, dtype=torch.float32, device=q.device) for q in qs]
    l = [torch.zeros((b, h, c, 1), dtype=torch.float32, device=q.device) for q in qs]
    acc = [torch.zeros((b, h, c, d), dtype=torch.float32, device=q.device) for q in qs]
    k_c, v_c, kvm = list(ks), list(vs), list(kv_masks)
    for s in range(sp):
        for my in range(sp):
            src = (my - s) % sp
            if causal and src > my:
                continue
            m[my], l[my], acc[my] = _one_chunk(
                q32[my], k_c[my], v_c[my], kvm[my], positions[my],
                positions[src].to(q32[my].device), m[my], l[my], acc[my], sm_scale, causal,
            )
        if s != sp - 1:  # the last hop's rotation would be discarded
            k_c, v_c, kvm = ppermute(k_c, rot), ppermute(v_c, rot), ppermute(kvm, rot)
    out = []
    for q, l_my, acc_my in zip(qs, l, acc):
        l_my = torch.where(l_my == 0.0, torch.ones_like(l_my), l_my)
        out.append((acc_my / l_my).to(q.dtype))
    return out


def ulysses_attention(qs: Sequence[torch.Tensor], ks, vs, kv_masks, *, causal: bool = False,
                      sm_scale: Optional[float] = None, use_flash: Optional[bool] = None) -> list:
    """Ulysses sequence parallelism: an all-to-all reshards so each position
    holds all L positions of H/sp heads, full attention runs per position,
    and a second all-to-all reshards back to sequence chunks.

    qs, ks, vs: one [B, H, C, D] chunk per position; H must divide by sp.
    `use_flash=None` means flash when the chunks are on a CUDA device."""
    sp = len(qs)
    h, d = qs[0].shape[1], qs[0].shape[3]
    if h % sp != 0:
        raise ValueError(f"heads {h} not divisible by sp axis {sp}")

    # [B, H, C, D] -> [B, H/sp, L, D]: split heads, gather the sequence
    qh, kh, vh = (all_to_all(x, split_axis=1, concat_axis=2) for x in (qs, ks, vs))
    full_masks = all_gather(kv_masks, axis=1)
    if use_flash is None:
        use_flash = qs[0].is_cuda
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if use_flash:
        outs = [
            flash_attention(q, k, v, m, causal=causal, sm_scale=sm_scale)
            for q, k, v, m in zip(qh, kh, vh, full_masks)
        ]
    else:
        outs = [
            reference_attention(q, k, v, m, sm_scale, causal)
            for q, k, v, m in zip(qh, kh, vh, full_masks)
        ]
    return [o.to(qs[0].dtype) for o in all_to_all(outs, split_axis=2, concat_axis=1)]
