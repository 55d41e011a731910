"""Flash attention (forward): the CUDA kernel and its plain version.

Counterpart of pathway_tpu/ops/kernels/flash_attention.py. The kernel
(csrc/flash_attention.cu) runs online-softmax attention with f32 softmax
state and never writes the [L, L] scores. bf16 inputs go through the
tensor cores (wgmma, with q, k and v brought in by TMA) in one instance
per head dim, each scheduled for what bounds it on an H100:

- 16, 32, 64 (the encoders): the exp unit; each warpgroup runs S, its
  softmax and P v in turn, and two blocks share an SM;
- 128 (the decoder's prefill) and 256 (heads above 128): the tensor
  cores and, at 128, memory as well; a warpgroup starts the next tile's
  S before this tile's softmax, the two warpgroups of a block take turns
  at the tensor cores (ping-pong), the producer warpgroup hands its
  registers to them, and the output leaves by TMA.

f32 inputs take the tensor cores too, to f32 accuracy
(csrc/flash_attention_f32.cu, `flash_fwd_tf32x3<D>`): each product is
three tf32 passes (hi hi + lo hi + hi lo of the operands split into tf32
hi and lo parts), an effective 165 TFLOP/s, which bounds it. tf32 wgmma
reads its B operand K-major only, so a producer warpgroup loads each kv
tile, splits it and writes v transposed into shared memory; the kernel
needs no scratch in device memory. The wrapper pads any other head dim up
to the next instance (256 at most) with zero columns, which add nothing
to q k^T or to P v, and slices the output back.
`reference_attention` is the plain version, the same function as the JAX
package's `_reference_attention`; the wrapper takes it only for tensors
on the CPU. A CUDA tensor launches the kernel or raises.

Rows whose keys are all masked are not zero: the additive -1e30 leaves
every score near -1e30, so such a row averages v. The kernel is finite
there and matches the reference on every row with at least one live key.

Differentiable, as the JAX package's `flash_attention` (a custom_vjp) is:
where q, k or v require grad, the card's forward runs inside a
`torch.autograd.Function` whose backward recomputes `reference_attention`
and differentiates it (dq, dk, dv; the mask gets none). There is no
backward kernel. Under `torch.no_grad()`, as on every serving path, the
wrapper launches the kernel alone and saves nothing.
"""

from __future__ import annotations

import math

import torch

from pathway_tpu_torch.ops.kernels import _build
from pathway_tpu_torch.ops.kernels.knn_topk import NEG_INF

_HEAD_DIMS = (16, 32, 64, 128, 256)


def padded_head_dim(d: int) -> int:
    """The kernel instance's head dim for a head dim of `d`."""
    for dim in _HEAD_DIMS:
        if d <= dim:
            return dim
    raise ValueError(f"flash_attention: head dim {d} above {_HEAD_DIMS[-1]} has no kernel")


def pad_head_dim(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    """[..., D] -> [..., d_pad] with zero columns, contiguous."""
    return torch.nn.functional.pad(x, (0, d_pad - x.shape[-1])).contiguous()


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
    """Fused attention. q: [B, H, Lq, D]; k, v: [B, H, Lk, D]; kv_mask:
    [B, Lk] (1 = valid), default all valid. Output like q. CPU tensors take
    the plain version; CUDA tensors launch the kernel, inside
    `_FlashAttention` where q, k or v require grad."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if kv_mask is None:
        kv_mask = torch.ones((k.shape[0], k.shape[2]), dtype=torch.int32, device=k.device)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, kv_mask, sm_scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, kv_mask, sm_scale, causal)
    return _launch(q, k, v, kv_mask, sm_scale, causal)


def _launch(q, k, v, kv_mask, sm_scale: float, causal: bool):
    """One launch of the kernel on CUDA tensors, after checking them and
    padding the head dim to the next instance."""
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
    d_pad = padded_head_dim(d)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must start on 16-byte boundaries")
    if k.device != q.device or v.device != q.device or kv_mask.device != q.device:
        raise ValueError("flash_attention: inputs must be on one device")
    if d_pad != d:
        # sm_scale stays 1/sqrt(D) of the true D
        q, k, v = (pad_head_dim(t, d_pad) for t in (q, k, v))
    mask = kv_mask.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _build.load()
    err = lib.pwt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, h, lq, lk, d_pad, float(sm_scale), int(bool(causal)),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    instance = f"{'bf16' if q.dtype == torch.bfloat16 else 'f32'}<{d_pad}>"
    flash_attention.launches_by_instance[instance] = (
        flash_attention.launches_by_instance.get(instance, 0) + 1
    )
    return out if d_pad == d else out[..., :d].contiguous()


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward with the JAX package's backward: recompute the
    plain version and differentiate it (pathway_tpu's `attn_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, sm_scale, causal):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return _launch(q, k, v, kv_mask, sm_scale, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = reference_attention(*inputs, kv_mask, ctx.sm_scale, ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, inputs, g)
        return dq, dk, dv, None, None, None


flash_attention.launches = 0
# the same launches by kernel instance: "bf16<32>", "f32<256>", ...
flash_attention.launches_by_instance = {}
