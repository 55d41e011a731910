"""Brute-force KNN on the card (counterpart of pathway_tpu/ops/knn.py).

  * The index buffer is device-resident, f32 [capacity, d] (each row
    padded with zero columns to 16 bytes for the kernel) plus a bool
    `valid`, with capacity in powers of two. Adds and removes are staged on
    the host and flushed as one indexed assignment before the next search.
  * `DeviceKnnIndex.search` goes through the hand-written knn_topk kernel
    (ops/kernels/knn_topk.py), which streams the index and never builds
    [Q, N].
  * `FusedEmbedSearch` runs tokens -> encoder -> similarity -> top-k with
    one upload and one packed [Q, 2k] host copy per query batch. Its search
    is dense similarity + `torch.topk`, as the JAX package's fused path is.
  * Across a mesh (`DeviceKnnIndex(mesh=...)`) the index rows shard on the
    mesh's first axis, one block of rows per position on its device, at
    the JAX package's global slot numbering; a search takes each shard's
    top-k through the kernel and merges the gathered [Q, n_dev * k]
    candidates (`sharded_knn_search`), the fused search too.
    `FusedEmbedSearch(backend=...)` packs ingest per dp replica and
    encodes each replica's block on its dp position with the encoder's
    tp shards (`TransformerLM.mesh_params`).

The JAX package's hooks sit where it places them: serving's result-cache
invalidation on every add and remove, memtrack's index and encoder-param
bytes and its ingest note, qtrace's device window around `search_texts`,
and costmodel's `useful_flops` in `prepare_batch`'s meta.
"""

from __future__ import annotations

import time as time_mod
from typing import Tuple

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device, to_device
from pathway_tpu_torch.internals import costmodel, memtrack
from pathway_tpu_torch.internals import qtrace as _qtrace
from pathway_tpu_torch.internals import tracing as _tracing
from pathway_tpu_torch.internals import serving as _serving
from pathway_tpu_torch.internals.mesh_backend import pack_batch_dp
from pathway_tpu_torch.models.tokenizer import (
    PACK_MAX_SEGMENTS,
    encode_batch,
    pack_batch,
    pack_encoded,
    pack_token_budget,
    pad_encoded,
)
from pathway_tpu_torch.models.transformer import FLASH_MIN_LEN, _to_device_ints
from pathway_tpu_torch.ops.kernels.knn_topk import METRICS, knn_topk, next_pow2
from pathway_tpu_torch.parallel.collectives import all_gather
from pathway_tpu_torch.parallel.mesh import NamedSharding, P, same_device

_KERNEL_MAX_K = 128


def _format_rows(scores, idx, key_of_slot) -> list:
    """[(key, score)] rows from top-k output, dropping invalid slots."""
    out = []
    for scores_row, idx_row in zip(scores, idx):
        row = []
        for s, i in zip(scores_row, idx_row):
            if not np.isfinite(s):
                continue
            key = key_of_slot.get(int(i))
            if key is not None:
                row.append((key, float(s)))
        out.append(row)
    return out


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    return x * (1.0 / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-30))


def _similarity(index, valid, queries, metric: str):
    """Dense [Q, N] scores; dead slots are -inf."""
    if metric == "cos":
        # x_n . q_n with the row norms applied to the [Q, N] product rather
        # than to a normalised copy of the whole index
        inv = 1.0 / (torch.linalg.vector_norm(index, dim=1) + 1e-30)
        scores = (_normalize_rows(queries) @ index.T) * inv[None, :]
    elif metric == "ip":
        scores = queries @ index.T
    elif metric == "l2sq":
        # -||q - x||^2; rank by negated squared distance
        sq_i = (index * index).sum(dim=1)
        sq_q = (queries * queries).sum(dim=1, keepdim=True)
        scores = 2.0 * (queries @ index.T) - sq_i[None, :] - sq_q
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.where(valid[None, :], scores, torch.full_like(scores, -torch.inf))


def _search(index, valid, queries, k: int, metric: str):
    """Top-k (scores [Q, k] f32, slots [Q, k]) over the live slots."""
    if k > _KERNEL_MAX_K:
        top_s, top_i = torch.topk(_similarity(index, valid, queries, metric), k, dim=1)
        return top_s, top_i
    # kernel path: index rows for cos were normalised at insert, so only
    # the queries are normalised here and the kernel takes the plain
    # inner product
    if metric == "cos":
        queries = _normalize_rows(queries)
    top_s, top_i = knn_topk(
        index, valid, queries, k, metric="ip" if metric == "cos" else metric
    )
    if metric == "l2sq":
        # the kernel drops the rank-invariant -||q||^2; restore it
        top_s = top_s - (queries * queries).sum(dim=1, keepdim=True)
    # dead slots carry ~-1e30; surface them as -inf so _format_rows drops them
    top_s = torch.where(top_s < -1e29, torch.full_like(top_s, -torch.inf), top_s)
    return top_s, top_i


def index_rows(reserved_space: int) -> int:
    """The buffer rows DeviceKnnIndex allocates for `reserved_space`: the
    next power of two, at least 8. analysis/capacity.py predicts from it."""
    return max(8, next_pow2(int(reserved_space)))


def padded_width(dimensions: int) -> int:
    """The buffer's row width: `dimensions` padded with zero columns to a
    multiple of 4 (16-byte rows, as the kernel's TMA loads need); zeros
    change no ip, cos or l2sq score."""
    return -(-int(dimensions) // 4) * 4


def index_row_bytes(dimensions: int) -> int:
    """Device bytes a buffer row takes: f32 at the padded width plus its
    bool valid flag."""
    return 4 * padded_width(dimensions) + 1


class DeviceKnnIndex:
    """Mutable KNN index with a device-resident, power-of-two buffer.

    Adds and removes are staged host-side and flushed as ONE indexed
    assignment before the next search. With `mesh`, the rows shard over
    the mesh's first axis: slot s lives in block s // (capacity / n_dev),
    on that position's device, and a search takes each shard's top-k and
    merges them (`sharded_knn_search`)."""

    def __init__(
        self,
        dimensions: int,
        *,
        metric: str = "cos",
        reserved_space: int = 512,
        device=None,
        mesh=None,
    ):
        if metric not in METRICS:
            raise ValueError(f"unknown metric {metric!r}")
        # mesh: shard the index rows over the mesh's first axis; searches
        # run per-shard top-k + a merge of the gathered candidates instead
        # of the reference's full copy per worker
        self.mesh = mesh
        min_cap = 8
        if mesh is not None:
            n_dev = mesh.shape[mesh.axis_names[0]]
            if n_dev & (n_dev - 1):
                raise ValueError(
                    f"DeviceKnnIndex mesh axis {mesh.axis_names[0]!r} has "
                    f"{n_dev} devices; a power of two is required (the "
                    "index buffer is bucketed to power-of-two capacities "
                    "and shards evenly only then)"
                )
            min_cap = max(min_cap, 2 * n_dev)
            first = mesh.devices.flat[0]
            if device is not None and not same_device(device, first):
                raise ValueError(
                    f"DeviceKnnIndex: device {device} contradicts the mesh, whose first "
                    f"device is {first}"
                )
            device = first
        self.device = resolve_device(device)
        self.d = dimensions
        self._d_pad = padded_width(dimensions)
        self.metric = metric
        self.capacity = max(index_rows(reserved_space), min_cap)
        # the buffer as row blocks, one per shard (a single block without a
        # mesh), and their valid flags
        self._blocks, self._valid_blocks = self._zero_blocks(self.capacity)
        self._slot_of_key: dict = {}
        self._key_of_slot: dict = {}
        self._free: list[int] = list(range(self.capacity - 1, -1, -1))
        # mesh: per-shard free buckets so dp-routed rows get slots inside
        # their replica's row range (exchange <-> device alignment). The
        # flat list keeps the global order for shardless callers;
        # _free_set arbitrates lazily-stale entries in both structures.
        self._free_set: set | None = None
        self._free_by_shard: list | None = None
        if mesh is not None:
            self._free_set = set(self._free)
            self._rebuild_shard_buckets()
        # staged updates: slot -> vector, or None for an invalidation
        self._dirty: dict[int, np.ndarray | None] = {}
        if memtrack.ENABLED:
            self._register_memory()

    def __len__(self) -> int:
        return len(self._slot_of_key)

    # -- memory accounting (internals/memtrack.py) --------------------------

    def _mem_span(self) -> int:
        """Devices the buffer spreads over: its rows shard on the mesh's
        first axis (dp), so both the per-device divisor and the
        per-replica divisor are that axis size."""
        return self._shard_count()

    def _register_memory(self) -> None:
        """(Re-)register the buffer's bytes: f32 rows at the padded width
        plus the bool valid, at the current capacity. Upserts on the same
        owner, so _grow calls it again after doubling."""
        span = self._mem_span()
        memtrack.tracker().register(
            "knn_index",
            self,
            self.capacity * index_row_bytes(self.d),
            device_span=span,
            dp_shards=span,
            capacity=self.capacity,
            dimensions=self.d,
        )

    def _note_ingest(self, new_rows: int) -> None:
        """Feed the ingest-rate forecaster: each new row takes one buffer
        row, divided over the shard span."""
        memtrack.tracker().note_ingest(
            new_rows, new_rows * index_row_bytes(self.d) / self._mem_span()
        )

    # -- the shards ----------------------------------------------------------

    def _shard_count(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.shape[self.mesh.axis_names[0]])

    def _zero_blocks(self, capacity: int) -> tuple:
        """One zero block of capacity / n_dev rows (and its valid flags) per
        position of the mesh's first axis, on its device; without a mesh,
        one block of every row on the index's device."""
        if self.mesh is None:
            devices = [self.device]
        else:
            devices = self.mesh.axis_devices(self.mesh.axis_names[0])
        rows = capacity // len(devices)
        return (
            [torch.zeros((rows, self._d_pad), dtype=torch.float32, device=dev) for dev in devices],
            [torch.zeros((rows,), dtype=torch.bool, device=dev) for dev in devices],
        )

    def _device_buffers(self) -> list:
        """The live buffer tensors: each shard's block."""
        return list(self._blocks)

    def _write(self, slots: np.ndarray, vectors: torch.Tensor, valid) -> None:
        """Rows `vectors` [n, d_pad] into global `slots` (a host int64
        array), in place, each into its shard's block; valid: a bool
        tensor [n] or True."""
        rows = self.capacity // self._shard_count()
        owner = slots // rows
        for s, (block, live) in enumerate(zip(self._blocks, self._valid_blocks)):
            pick = np.nonzero(owner == s)[0]
            if not len(pick):
                continue
            part, part_valid = vectors, valid
            if len(pick) < len(slots):
                sel = to_device(torch.from_numpy(pick), vectors.device)
                part = vectors[sel]
                part_valid = True if valid is True else valid[sel]
            at = to_device(torch.from_numpy(slots[pick] - s * rows), block.device)
            block.index_copy_(0, at, part.to(block.device))
            if part_valid is True:
                live.index_fill_(0, at, True)
            else:
                live[at] = part_valid.to(block.device)

    # -- free-slot bookkeeping (shard-aware under a mesh) -------------------

    def _rebuild_shard_buckets(self) -> None:
        """Bucket the free slots by owning shard (slot // shard_rows).
        Rebuilt after _grow because the per-shard row ranges shift when
        capacity doubles. Buckets are descending so pop() hands out the
        lowest slot in the shard first, mirroring the flat list."""
        n_dev = self._shard_count()
        shard_rows = self.capacity // n_dev
        buckets: list[list[int]] = [[] for _ in range(n_dev)]
        for slot in sorted(self._free_set, reverse=True):
            buckets[slot // shard_rows].append(slot)
        self._free_by_shard = buckets

    def _free_count(self) -> int:
        return len(self._free_set) if self._free_set is not None else len(self._free)

    def _pop_free(self, shard: int | None = None) -> int:
        if self._free_set is None:
            return self._free.pop()
        if shard is not None:
            bucket = self._free_by_shard[shard % len(self._free_by_shard)]
            while bucket:
                slot = bucket.pop()
                if slot in self._free_set:
                    self._free_set.discard(slot)
                    return slot
        # shardless callers, and a full shard bucket's overflow, take the
        # global order the flat list keeps (placement is locality, never
        # correctness)
        while True:
            slot = self._free.pop()
            if slot in self._free_set:
                self._free_set.discard(slot)
                return slot

    def _push_free(self, slot: int) -> None:
        self._free.append(slot)
        if self._free_set is not None:
            self._free_set.add(slot)
            shard_rows = self.capacity // self._shard_count()
            self._free_by_shard[slot // shard_rows].append(slot)

    def _normalize(self, vectors):
        """cos rows are normalised ONCE at insert time so searches never
        re-read the whole buffer just to normalise it."""
        if self.metric != "cos":
            return vectors
        if torch.is_tensor(vectors):
            return vectors * (
                1.0 / (torch.linalg.vector_norm(vectors, dim=-1, keepdim=True) + 1e-30)
            )
        return vectors / (np.linalg.norm(vectors, axis=-1, keepdims=True) + 1e-30)

    def add(self, key, vector) -> None:
        vector = np.asarray(vector, dtype=np.float32).reshape(-1)
        if vector.shape[0] != self.d:
            raise ValueError(f"vector dim {vector.shape[0]} != index dim {self.d}")
        if memtrack.ENABLED and key not in self._slot_of_key:
            self._note_ingest(1)
        if _serving.ENABLED:
            # an insert or an update can enter any cached query's top-k:
            # a global bump of the result cache's generation
            _serving.note_index_add(1)
        slot = self._assign_slot(key)
        self._dirty[slot] = self._normalize(vector)

    def add_batch(self, keys, vectors, shards=None) -> None:
        """vectors: [B, d], a host array or a tensor. A tensor is written
        from the device with no host round trip. shards (optional, mesh
        only): per-key dp-shard hints; such a key's slot is drawn from its
        replica's row range, so engine sharding and device sharding
        agree."""
        keys = list(keys)
        if _serving.ENABLED and keys:
            _serving.note_index_add(len(keys))
        if torch.is_tensor(vectors):
            # host span index.write: slot assignment, the slot copy and
            # the enqueued write
            t0 = time_mod.perf_counter() if _tracing.HOST_SPANS else 0.0
            self._flush()
            new = len(keys) - sum(1 for k in keys if k in self._slot_of_key)
            if memtrack.ENABLED and new:
                self._note_ingest(new)
            while self._free_count() < new:
                self._grow()
            slots = np.array(
                [
                    self._assign_slot(k, None if shards is None else shards[i])
                    for i, k in enumerate(keys)
                ],
                dtype=np.int64,
            )
            # in place: the buffer is updated where it lies (the JAX package
            # donates the old buffer to the scatter for the same effect)
            self._write(slots, self._pad_cols(self._normalize(vectors.to(torch.float32))), True)
            if _tracing.HOST_SPANS:
                _tracing.record_span("index.write", t0, time_mod.perf_counter() - t0, len(keys))
            return
        vectors = self._normalize(np.asarray(vectors, dtype=np.float32))
        if memtrack.ENABLED:
            new = sum(1 for k in keys if k not in self._slot_of_key)
            if new:
                self._note_ingest(new)
        for key, vec in zip(keys, vectors):
            self._dirty[self._assign_slot(key)] = vec

    def _pad_cols(self, x: torch.Tensor) -> torch.Tensor:
        """[B, d] -> [B, d_pad] with zero columns."""
        if self._d_pad == self.d:
            return x
        return torch.nn.functional.pad(x, (0, self._d_pad - self.d))

    def _assign_slot(self, key, shard: int | None = None) -> int:
        slot = self._slot_of_key.get(key)
        if slot is None:
            if not self._free_count():
                self._grow()
            slot = self._pop_free(shard)
            self._slot_of_key[key] = slot
            self._key_of_slot[slot] = key
        return slot

    def remove(self, key) -> None:
        slot = self._slot_of_key.pop(key, None)
        if slot is None:
            return
        if _serving.ENABLED:
            # a removal can only change cached queries whose results held
            # this key: a bump of its cluster alone
            _serving.note_index_remove(key)
        del self._key_of_slot[slot]
        self._push_free(slot)
        self._dirty[slot] = None

    def _grow(self) -> None:
        new_capacity = self.capacity * 2
        # the shard boundaries move: the old rows keep their global slots,
        # so block s (rows [s R, (s + 1) R)) lands at offset s R mod 2R of
        # new block s R // 2R (one block: the old rows, then zeros)
        blocks, valid = self._zero_blocks(new_capacity)
        rows = self.capacity // self._shard_count()
        for s, (old, old_valid) in enumerate(zip(self._blocks, self._valid_blocks)):
            j, at = divmod(s * rows, 2 * rows)
            blocks[j][at : at + rows] = old.to(blocks[j].device)
            valid[j][at : at + rows] = old_valid.to(valid[j].device)
        self._blocks, self._valid_blocks = blocks, valid
        self._free.extend(range(new_capacity - 1, self.capacity - 1, -1))
        if self._free_set is not None:
            self._free_set.update(range(self.capacity, new_capacity))
        self.capacity = new_capacity
        if self._free_set is not None:
            self._rebuild_shard_buckets()
        if memtrack.ENABLED:
            self._register_memory()

    def _flush(self) -> None:
        if not self._dirty:
            return
        slots = np.fromiter(self._dirty.keys(), dtype=np.int64, count=len(self._dirty))
        vectors = np.zeros((len(slots), self._d_pad), dtype=np.float32)
        slot_valid = np.zeros((len(slots),), dtype=bool)
        for i, vec in enumerate(self._dirty.values()):
            if vec is not None:
                vectors[i, : self.d] = vec
                slot_valid[i] = True
        # one in-place indexed write per flush (the JAX package's donated
        # scatter), per shard under a mesh
        self._write(slots, torch.from_numpy(vectors), torch.from_numpy(slot_valid))
        self._dirty.clear()

    @property
    def device_buffer(self) -> torch.Tensor:
        """A copy of the first d columns, in slot order (the shards' blocks
        concatenated on the first device): later flushes update the live
        buffer in place."""
        self._flush()
        return torch.cat([b.to(self.device) for b in self._blocks])[:, : self.d]

    @property
    def device_valid(self) -> torch.Tensor:
        self._flush()
        return torch.cat([v.to(self.device) for v in self._valid_blocks])

    def _top_k(self, queries: torch.Tensor, k: int):
        """(scores [Q, k], slots [Q, k]) of `_search` over the buffer, or
        over the shards with their merge, for queries [Q, d_pad] on the
        index's (first) device."""
        if len(self._blocks) == 1:
            return _search(self._blocks[0], self._valid_blocks[0], queries, k, self.metric)
        return _sharded_search_body(self._blocks, self._valid_blocks, queries, k, self.metric)

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Return (scores [Q,k], slot indices [Q,k], slot->key map). Scores
        are similarity-like: higher is better for every metric."""
        if torch.is_tensor(queries):
            queries = queries.to(device=self.device, dtype=torch.float32)
        else:
            queries = torch.from_numpy(np.asarray(queries, dtype=np.float32))
        if queries.dim() == 1:
            queries = queries[None, :]
        q = queries.shape[0]
        if q == 0 or not self._slot_of_key:
            return (
                np.zeros((q, 0), dtype=np.float32),
                np.zeros((q, 0), dtype=np.int64),
                {},
            )
        self._flush()
        padded = torch.zeros(
            (next_pow2(q), self._d_pad), dtype=torch.float32, device=self.device
        )
        padded[:q, : self.d] = queries.to(self.device)
        top_scores, top_idx = self._top_k(padded, min(k, self.capacity))
        return top_scores[:q].cpu().numpy(), top_idx[:q].cpu().numpy(), self._key_of_slot

    def search_keys(self, queries, k: int) -> list:
        """Per query: list of (key, score) with invalid slots dropped."""
        top_scores, top_idx, key_of_slot = self.search(queries, k)
        return _format_rows(top_scores, top_idx, key_of_slot)


def _sharded_search_body(blocks: list, valid_blocks: list, queries, k: int, metric: str):
    """Per-shard top-k + merge: each shard's `_search` (the knn_topk
    kernel for k <= 128) takes its top min(k, shard rows), its slots are
    made global (shard s's local slot i is s * shard_rows + i), the
    candidates are gathered into [Q, n_dev * local_k] in shard order and
    the merge takes their top min(k, capacity), equal scores in gathered
    order (the JAX package's lax.top_k over the gathered candidates).
    queries: [Q, d_pad]; the result is on the first shard's device."""
    n_dev = len(blocks)
    shard_rows = blocks[0].shape[0]
    # each shard needs only min(k, shard_rows) candidates; the pool of
    # n_dev of those always holds min(k, capacity), so the caller gets the
    # full k it asked for
    local_k = min(k, shard_rows)
    k = min(k, n_dev * shard_rows)
    scores, slots = [], []
    for s, (block, valid) in enumerate(zip(blocks, valid_blocks)):
        top_s, top_i = _search(block, valid, queries.to(block.device), local_k, metric)
        scores.append(top_s)
        slots.append(top_i.long() + s * shard_rows)
    all_scores, all_slots = all_gather(scores, axis=1)[0], all_gather(slots, axis=1)[0]
    order = torch.sort(all_scores, dim=1, descending=True, stable=True).indices[:, :k]
    return all_scores.gather(1, order), all_slots.gather(1, order)


def sharded_knn_search(mesh, index, valid, queries, k: int, metric: str = "cos"):
    """Mesh-sharded search: index rows sharded over the mesh's first axis,
    per-shard top-k, then a global merge of the [Q, k] candidates (the
    reference instead broadcasts the whole index to every worker,
    external_index.rs:70). index, valid: [N, d] and [N] tensors, cut into
    the axis's equal blocks here, or lists of those blocks on their
    devices; queries: [Q, d]. cos expects index rows already normalised,
    as DeviceKnnIndex keeps them. Returns (scores [Q, k], slots [Q, k])."""
    if torch.is_tensor(index):
        axis = mesh.axis_names[0]
        index = NamedSharding(mesh, P(axis, None)).shard(index.float().contiguous())
        valid = NamedSharding(mesh, P(axis)).shard(valid.bool())
    queries = queries if torch.is_tensor(queries) else torch.from_numpy(np.asarray(queries))
    return _sharded_search_body(list(index), list(valid), queries.float(), k, metric)


class FusedEmbedSearch:
    """tokens -> encoder -> similarity -> top-k with one upload and one
    host copy per query batch. The encoder and the index must both live
    on `device` (None: the CUDA card); under a mesh, on its first device.
    backend: the mesh execution backend (internals/mesh_backend), for
    dp-grouped packed ingest and tp-sharded encoder params; None keeps
    the single-device path."""

    def __init__(self, encoder, index: DeviceKnnIndex, *, backend=None, device=None):
        self.device = resolve_device(device)
        if not (same_device(encoder.device, self.device) and same_device(index.device, self.device)):
            raise ValueError(
                f"encoder on {encoder.device} and index on {index.device}, "
                f"expected both on {self.device}"
            )
        self.encoder = encoder
        self.index = index
        self.backend = backend
        if memtrack.ENABLED:
            # param bytes, keyed on the lm so an encoder shared between
            # FusedEmbedSearch instances counts once. Matmul params shard
            # over tp within a replica, but every dp replica holds a full
            # copy (dp_shards=1)
            memtrack.tracker().register(
                "encoder_params",
                encoder.lm,
                sum(p.numel() * p.element_size() for p in encoder.lm.parameters()),
                device_span=backend.tp if backend is not None else 1,
                dp_shards=1,
                model=type(encoder).__name__,
            )

    def _params(self, replica: int = 0):
        """The weights a dp replica's encode runs: its tp shards under a
        backend, else the compute-dtype tree."""
        if self.backend is not None:
            return self.encoder.lm.mesh_params(self.backend.mesh)[replica]
        return self.encoder.lm.compute_params()

    def embed_and_add(self, keys, texts) -> None:
        """Embed a doc batch and write it into the index, all on the device.
        Classic synchronous entry: unpacked prepare, then dispatch."""
        self.dispatch_batch(self.prepare_batch(keys, texts, pack=False)[0])

    def prepare_batch(self, keys, texts, *, pack: bool = True):
        """Host-side PREPARE stage: tokenize, packing into token-budget
        slabs when enabled (per dp replica under a backend, none under a
        mesh of the index alone). Returns (payload, meta); payload is
        consumed by dispatch_batch, meta carries rows / real-token /
        slab-token / slab-byte accounting, per replica too under a
        backend. On the card, a batch that holds a doc longer than
        FLASH_MIN_LEN tokens takes the classic path: packed slabs attend
        densely within their segments, [rows, heads, L, L] scores, where
        the classic path's masked attention takes the flash kernel."""
        texts = list(texts)
        keys = list(keys)
        packable = self.index.mesh is None or self.backend is not None
        budget = pack_token_budget() if pack and packable else 0
        tokenizer, max_len = self.encoder.tokenizer, self.encoder.max_len
        replica_rows = replica_real = replica_slab = None
        if budget > 0 and texts:
            on_card = self.device.type == "cuda"
            encoded = None
            if self.backend is None or (on_card and max_len > FLASH_MIN_LEN):
                encoded = [tokenizer.encode(t, max_len) for t in texts]
            if on_card and encoded is not None and max(map(len, encoded)) > FLASH_MIN_LEN:
                ids, mask = pad_encoded(tokenizer, encoded, max_len=max_len)
                payload = ("classic", keys, ids, mask, None)
            elif self.backend is not None:
                # mesh backend: pack PER dp SHARD so each replica's rows
                # lie in its own block of the slab
                ids, seg, slots, replica_rows = pack_batch_dp(
                    tokenizer,
                    keys,
                    texts,
                    self.backend,
                    max_len=max_len,
                    token_budget=budget,
                    max_segments=PACK_MAX_SEGMENTS,
                )
                payload = ("packed_dp", keys, ids, seg, slots)
                # per-replica token counts for the labeled pad-waste gauge
                # and the straggler detector: slab rows land on replica
                # r // block by construction
                dp = self.backend.dp
                block = seg.shape[0] // dp
                replica_real = [
                    int(np.count_nonzero(seg[r * block : (r + 1) * block])) for r in range(dp)
                ]
                replica_slab = [int(block * seg.shape[1])] * dp
                for r in self.backend.drained_replicas():
                    # a drained replica's block is empty on purpose: count
                    # it as zero slab, not as waste or skew
                    if 0 <= r < dp:
                        replica_slab[r] = replica_real[r]
            else:
                ids, seg, slots = pack_encoded(
                    tokenizer,
                    encoded,
                    max_len=max_len,
                    token_budget=budget,
                    max_segments=PACK_MAX_SEGMENTS,
                )
                payload = ("packed", keys, ids, seg, slots)
        else:
            ids, mask = encode_batch(tokenizer, texts, max_len=max_len)
            payload = ("classic", keys, ids, mask, None)
        # real tokens: the nonzero entries of the segment ids or the mask
        real, total = int(np.count_nonzero(payload[3])), int(payload[3].size)
        meta = {
            "rows": len(keys),
            "real_tokens": real,
            "slab_tokens": total,
            # bytes of the two wire arrays (ids + seg/mask)
            "slab_bytes": int(payload[2].nbytes) + int(payload[3].nbytes),
            # mask-aware useful FLOPs for the live MFU gauge
            # (internals/utilization.py); padding is not useful work
            "useful_flops": costmodel.encoder_flops_for_config(
                self.encoder.config, real, len(keys)
            ),
        }
        if replica_rows is not None:
            meta["replica_rows"] = replica_rows
            meta["replica_real_tokens"] = replica_real
            meta["replica_slab_tokens"] = replica_slab
        return payload, meta

    def dispatch_batch(self, payload):
        """Device DISPATCH stage: queue the encode (+ per-segment gather for
        packed slabs) and the index write; returns the embeddings [B, d] on
        the device. Batches must dispatch in submission order. A dp-packed
        slab's replica blocks are encoded each on its dp position with
        the tp shards, and each doc's row goes to its replica's shard."""
        kind, keys, ids, second, slots = payload
        lm = self.encoder.lm
        shards = None
        # host span encode.h2d: the slab's ids, its segment ids (or mask)
        # and its gather slots, queued to the card before the encode (a
        # dp-packed slab's ids go to each position inside its encode)
        t0 = time_mod.perf_counter() if _tracing.HOST_SPANS else 0.0
        if kind != "packed_dp":
            ids, second = _to_device_ints(ids, self.device), _to_device_ints(second, self.device)
        if slots is not None:
            at = to_device(torch.tensor(slots, dtype=torch.int64).reshape(-1, 2), self.device)
        if _tracing.HOST_SPANS:
            _tracing.record_span("encode.h2d", t0, time_mod.perf_counter() - t0, len(keys))
        if kind == "packed_dp":
            sharding = self.backend.batch_sharding()
            pooled = torch.cat([
                lm.encode_packed(i, s, PACK_MAX_SEGMENTS, params=self._params(d)).to(self.device)
                for d, (i, s) in enumerate(zip(
                    sharding.shard(ids.astype(np.int32)), sharding.shard(second.astype(np.int32))
                ))
            ])
            shards = [self.backend.dp_shard_of(k) for k in keys]
        elif kind == "packed":
            pooled = lm.encode_packed(ids, second, PACK_MAX_SEGMENTS)
        if kind == "classic":
            emb = lm(ids, second)[: len(keys)]
        else:
            emb = pooled[at[:, 0], at[:, 1]]
        if keys:
            self.index.add_batch(keys, emb, shards=shards)
        return emb

    def _top_k(self, emb: torch.Tensor, k: int) -> torch.Tensor:
        """Top-k of [Q, d] embeddings over the index, packed as [Q, 2k]
        (scores, then slots as f32) for one host copy: dense similarity +
        top-k on one device, the shards' `_sharded_search_body` under a
        mesh."""
        index = self.index
        if index.mesh is not None:
            top_scores, top_idx = index._top_k(index._pad_cols(emb.to(index.device)), k)
        else:
            scores = _similarity(
                index._blocks[0], index._valid_blocks[0], index._pad_cols(emb), index.metric
            )
            top_scores, top_idx = torch.topk(scores, k, dim=1)
        return torch.cat([top_scores, top_idx.float()], dim=1)

    def _fused(self, ids, mask, k: int) -> torch.Tensor:
        return self._top_k(self.encoder.lm(ids, mask, params=self._params()), k)

    def _packed_query_search(self, texts, k_eff: int) -> torch.Tensor:
        """Serving opt-in (PATHWAY_SERVE_PACK_QUERIES=1): the query batch
        is packed into token-budget slabs, then packed encode -> per-query
        gather -> similarity -> top-k. Off by default: the packed
        reduction order is numerically equivalent to the classic bucketed
        encode, not bitwise identical."""
        ids, seg, slots = pack_batch(
            self.encoder.tokenizer,
            texts,
            max_len=self.encoder.max_len,
            token_budget=pack_token_budget() or 256,
            max_segments=PACK_MAX_SEGMENTS,
        )
        pooled = self.encoder.lm.encode_packed(ids, seg, PACK_MAX_SEGMENTS, params=self._params())
        at = torch.tensor(slots, dtype=torch.int64).reshape(-1, 2).to(pooled.device)
        with torch.no_grad():
            return self._top_k(pooled[at[:, 0], at[:, 1]], k_eff)

    def search_texts(self, texts, k: int) -> list:
        texts = list(texts)
        if not len(self.index):
            return [[] for _ in texts]
        self.index._flush()
        k_eff = min(k, self.index.capacity)
        t0 = time_mod.perf_counter() if _qtrace.ENABLED else 0.0
        if _serving.ENABLED and len(texts) > 1 and _serving.pack_queries():
            packed = self._packed_query_search(texts, k_eff)
        else:
            ids, mask = encode_batch(
                self.encoder.tokenizer, texts, max_len=self.encoder.max_len
            )
            with torch.no_grad():
                packed = self._fused(ids, mask, k_eff)
        packed = packed[: len(texts)].cpu().numpy()
        if _qtrace.ENABLED:
            # the device portion of the query (encode + search, up to the
            # host copy) into the tail-attribution window
            _qtrace.tracker().note_device_window(
                time_mod.perf_counter() - t0, source="knn_search"
            )
        if self.backend is not None:
            self.backend.note_serve_batch(len(texts))
        scores = packed[:, :k_eff]
        idx = packed[:, k_eff:].astype(np.int64)
        return _format_rows(scores, idx, self.index._key_of_slot)
