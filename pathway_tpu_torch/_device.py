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
