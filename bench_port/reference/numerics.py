"""The products of the plain references, in full f32 or in the control's
lower precision.

`mode` "f32" multiplies in float32 with TF32 off. "fp8" is the control:
each product's two inputs are first rounded to float8 e4m3 with one scale
per row of the left input and one per column of the right (the common
fp8 serving recipe), then multiplied and summed in float32 — the step
below the bfloat16 that the configurations state.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


def full_f32():
    """TF32 off for the products inside, whatever the caller set."""

    @contextlib.contextmanager
    def scope():
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    return scope()


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along `dim`'s reduction."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a [..., m, k] @ b [..., k, n] in float32, or fp8-rounded inputs."""
    a, b = a.float(), b.float()
    if mode == "fp8":
        a, b = fp8_round(a, -1), fp8_round(b, -2)
    elif mode != "f32":
        raise ValueError(f"unknown precision {mode!r}")
    return a @ b
