"""PyTorch + CUDA port of pathway_tpu's retrieval data plane.

A package of its own beside the JAX package: it imports torch, numpy and
the standard library, never JAX and nothing of `pathway_tpu`. It holds the
MiniLM-class encoder (models/), the device KNN index and the fused
embed+search object (ops/knn.py), and hand-written Hopper kernels for the
JAX package's two Pallas kernels (ops/kernels/). Entry points take
``device=None``, meaning the CUDA card; ``device="cpu"`` runs the plain
PyTorch versions of the kernels instead.
"""

from pathway_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
