"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card. Without CUDA that raises: an entry point
    never carries on on the CPU unless the caller asks for it by passing
    ``device="cpu"`` (as the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pathway_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """`x` on `device`. A host tensor goes to the card through pinned
    memory without blocking: a copy from pageable memory synchronises the
    card's stream, so the caller would wait for every kernel queued before
    it (the JAX package's transfers are asynchronous)."""
    device = torch.device(device)
    if device.type != "cuda" or x.is_cuda:
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)
