"""Streaming KNN similarity + top-k: the CUDA kernel and its plain version.

Counterpart of pathway_tpu/ops/kernels/knn_topk.py. The kernel
(csrc/knn_topk.cu) splits the index over many blocks, keeps a per-block
top-k per query and merges the per-block lists in a second pass; the
[Q, N] score matrix never exists. `reference_knn_topk` computes the same
function with a dense matmul and `torch.topk`; the wrapper takes it only
for tensors on the CPU.
"""

from __future__ import annotations

import functools

import torch

from pathway_tpu_torch.ops.kernels import _build

NEG_INF = -1e30  # additive penalty of dead index slots and masked attention keys
METRICS = ("cos", "ip", "l2sq")
_TILE_ROWS = 128


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def reference_knn_topk(index, valid, queries, k: int, *, metric: str = "cos"):
    """Plain version: f32 scores q.x (or 2 q.x - ||x||^2 for l2sq), dead
    slots plus -1e30, then `torch.topk`. Returns (scores [Q, k] f32,
    idx [Q, k] int32)."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    x = index.float()
    s = queries.float() @ x.T
    if metric == "l2sq":
        s = 2.0 * s - (x * x).sum(dim=1)[None, :]
    s = s + (1.0 - valid.float())[None, :] * NEG_INF
    top_s, top_i = torch.topk(s, k, dim=1)
    return top_s, top_i.to(torch.int32)


def knn_topk(index, valid, queries, k: int, *, metric: str = "cos"):
    """Global top-k of similarity(queries, index) without materialising
    [Q, N]. index: [N, D] f32; valid: [N] bool (True = live slot);
    queries: [Q, D] f32. metric: cos | ip | l2sq (cos expects rows and
    queries already normalised, so it is the inner product here; l2sq
    drops the rank-invariant -||q||^2). Returns (scores [Q, k] f32,
    idx [Q, k] int32). CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if index.device.type == "cpu":
        return reference_knn_topk(index, valid, queries, k, metric=metric)
    if index.device.type != "cuda":
        raise ValueError(f"knn_topk: unsupported device {index.device}")
    if index.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError("knn_topk: index and queries must be float32")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError("knn_topk: valid must be bool or uint8")
    if index.dim() != 2 or queries.dim() != 2 or valid.dim() != 1:
        raise ValueError("knn_topk: expected index [N, D], valid [N], queries [Q, D]")
    n, d = index.shape
    qn = queries.shape[0]
    if queries.shape[1] != d or valid.shape[0] != n:
        raise ValueError("knn_topk: index, valid and queries disagree in shape")
    if not (index.is_contiguous() and valid.is_contiguous() and queries.is_contiguous()):
        raise ValueError("knn_topk: inputs must be contiguous")
    if valid.device != index.device or queries.device != index.device:
        raise ValueError("knn_topk: inputs must be on one device")
    if d % 4:
        raise ValueError("knn_topk: D must be a multiple of 4")
    if not 1 <= k <= min(128, n):
        raise ValueError(f"knn_topk: need 1 <= k <= min(128, N), got k={k}, N={n}")
    lib = _build.load()
    qt = min(64, max(8, next_pow2(qn)))
    kp = next_pow2(k)
    ntiles = -(-n // _TILE_ROWS)
    # a few blocks per SM: enough loads in flight to stream the index,
    # few enough per-block candidate lists for the merge pass
    target = 4 * _sm_count(index.device.index or 0)
    tiles_per_block = -(-ntiles // target)
    nblocks = -(-ntiles // tiles_per_block)
    groups = -(-qn // qt)
    dev = index.device
    cand_s = torch.empty((groups, nblocks, qt, kp), dtype=torch.float32, device=dev)
    cand_i = torch.empty((groups, nblocks, qt, kp), dtype=torch.int32, device=dev)
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    err = lib.pwt_knn_topk(
        index.data_ptr(), valid.data_ptr(), queries.data_ptr(),
        n, d, qn, k, kp, qt, int(metric == "l2sq"), tiles_per_block, nblocks,
        cand_s.data_ptr(), cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "knn_topk")
    knn_topk.launches += 1
    return out_s, out_i


knn_topk.launches = 0
