"""Flash attention (forward): the CUDA kernel and its plain version.

Counterpart of pathway_tpu/ops/kernels/flash_attention.py. The kernel
(csrc/flash_attention.cu) runs online-softmax attention with f32 softmax
state and never writes the [L, L] scores; bf16 inputs go through the
tensor cores (wgmma, with k and v brought in by TMA), f32 inputs through
a simple CUDA-core kernel. Head dims 16, 32, 64 (the encoders) and 128
(the decoder's prefill).
`reference_attention` is the
plain version, the same function as the JAX package's
`_reference_attention`; the wrapper takes it only for tensors on the CPU.

Rows whose keys are all masked are not zero: the additive -1e30 leaves
every score near -1e30, so such a row averages v. The kernel is finite
there and matches the reference on every row with at least one live key.
No backward: serving needs none.
"""

from __future__ import annotations

import math

import torch

from pathway_tpu_torch.ops.kernels import _build
from pathway_tpu_torch.ops.kernels.knn_topk import NEG_INF

_HEAD_DIMS = (16, 32, 64, 128)


def reference_attention(q, k, v, kv_mask, sm_scale: float, causal: bool):
    """Dense attention. q,k,v: [B, H, L, D]; kv_mask: [B, Lk] (1 = live).
    f32 scores, additive -1e30 mask, +1e-30 softmax denominator."""
    lq, lk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    s = s + (1.0 - kv_mask[:, None, None, :].float()) * NEG_INF
    if causal:
        keep = (
            torch.arange(lq, device=q.device)[:, None]
            >= torch.arange(lk, device=q.device)[None, :]
        )
        s = torch.where(keep[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / (p.sum(dim=-1, keepdim=True) + 1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


def flash_attention(q, k, v, kv_mask=None, *, causal: bool = False, sm_scale=None):
    """Fused attention forward. q: [B, H, Lq, D]; k, v: [B, H, Lk, D];
    kv_mask: [B, Lk] (1 = valid), default all valid. Output like q. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if kv_mask is None:
        kv_mask = torch.ones((k.shape[0], k.shape[2]), dtype=torch.int32, device=k.device)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, kv_mask, sm_scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("flash_attention: q, k, v must be float32 or bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: expected [B, H, L, D] tensors")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != k.shape or tuple(kv_mask.shape) != (b, lk):
        raise ValueError("flash_attention: q, k, v and kv_mask disagree in shape")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must start on 16-byte boundaries")
    if k.device != q.device or v.device != q.device or kv_mask.device != q.device:
        raise ValueError("flash_attention: inputs must be on one device")
    mask = kv_mask.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _build.load()
    err = lib.pwt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, h, lq, lk, d, float(sm_scale), int(bool(causal)),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
