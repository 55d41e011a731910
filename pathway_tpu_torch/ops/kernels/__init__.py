"""Hand-written Hopper kernels for the data-plane hot ops.

Counterpart of pathway_tpu/ops/kernels: each Pallas TPU kernel of the JAX
package is a CUDA C++ kernel here (csrc/), built by nvcc at first use
(_build.py) and bound with ctypes:

  * knn_topk — streaming similarity + top-k, never materialising [Q, N];
  * flash_attention — online-softmax attention forward, O(L) memory.

Each wrapper runs its plain PyTorch version for CPU tensors (the role
Pallas interpret mode plays for the JAX package's CPU tests) and launches
its kernel for CUDA tensors, counting launches in `<wrapper>.launches`.
"""

from pathway_tpu_torch.ops.kernels.flash_attention import flash_attention
from pathway_tpu_torch.ops.kernels.knn_topk import knn_topk

__all__ = ["flash_attention", "knn_topk", "on_cuda"]


def on_cuda() -> bool:
    import torch

    return torch.cuda.is_available()
