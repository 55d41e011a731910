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

The JAX package's hooks sit where it places them: serving's result-cache
invalidation on every add and remove, memtrack's index and encoder-param
bytes and its ingest note, qtrace's device window around `search_texts`,
and costmodel's `useful_flops` in `prepare_batch`'s meta. Single device
only: mesh sharding is not ported yet.
"""

from __future__ import annotations

import time as time_mod
from typing import Tuple

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device, to_device
from pathway_tpu_torch.internals import costmodel, memtrack
from pathway_tpu_torch.internals import qtrace as _qtrace
from pathway_tpu_torch.internals import serving as _serving
from pathway_tpu_torch.models.tokenizer import (
    PACK_MAX_SEGMENTS,
    encode_batch,
    pack_batch,
    pack_encoded,
    pack_token_budget,
    pad_encoded,
)
from pathway_tpu_torch.models.transformer import FLASH_MIN_LEN, forward
from pathway_tpu_torch.ops.kernels.knn_topk import METRICS, knn_topk, next_pow2

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
    assignment before the next search."""

    def __init__(
        self,
        dimensions: int,
        *,
        metric: str = "cos",
        reserved_space: int = 512,
        device=None,
    ):
        if metric not in METRICS:
            raise ValueError(f"unknown metric {metric!r}")
        self.device = resolve_device(device)
        self.d = dimensions
        self._d_pad = padded_width(dimensions)
        self.metric = metric
        self.capacity = index_rows(reserved_space)
        self._buffer = torch.zeros(
            (self.capacity, self._d_pad), dtype=torch.float32, device=self.device
        )
        self._valid_dev = torch.zeros((self.capacity,), dtype=torch.bool, device=self.device)
        self._slot_of_key: dict = {}
        self._key_of_slot: dict = {}
        self._free: list[int] = list(range(self.capacity - 1, -1, -1))
        # staged updates: slot -> vector, or None for an invalidation
        self._dirty: dict[int, np.ndarray | None] = {}
        if memtrack.ENABLED:
            self._register_memory()

    def __len__(self) -> int:
        return len(self._slot_of_key)

    # -- memory accounting (internals/memtrack.py) --------------------------

    def _register_memory(self) -> None:
        """(Re-)register the buffer's bytes: f32 rows at the padded width
        plus the bool valid, at the current capacity. Upserts on the same
        owner, so _grow calls it again after doubling."""
        memtrack.tracker().register(
            "knn_index",
            self,
            self.capacity * index_row_bytes(self.d),
            device_span=1,
            dp_shards=1,
            capacity=self.capacity,
            dimensions=self.d,
        )

    def _note_ingest(self, new_rows: int) -> None:
        """Feed the ingest-rate forecaster: each new row takes one buffer
        row."""
        memtrack.tracker().note_ingest(new_rows, new_rows * index_row_bytes(self.d))

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

    def add_batch(self, keys, vectors) -> None:
        """vectors: [B, d], a host array or a tensor. A tensor is written
        from the device with no host round trip."""
        keys = list(keys)
        if _serving.ENABLED and keys:
            _serving.note_index_add(len(keys))
        if torch.is_tensor(vectors):
            self._flush()
            new = len(keys) - sum(1 for k in keys if k in self._slot_of_key)
            if memtrack.ENABLED and new:
                self._note_ingest(new)
            while len(self._free) < new:
                self._grow()
            slots = to_device(
                torch.tensor([self._assign_slot(k) for k in keys], dtype=torch.int64),
                self.device,
            )
            vectors = self._pad_cols(
                self._normalize(vectors.to(device=self.device, dtype=torch.float32))
            )
            # in place: the buffer is updated where it lies (the JAX package
            # donates the old buffer to the scatter for the same effect)
            self._buffer.index_copy_(0, slots, vectors)
            self._valid_dev.index_fill_(0, slots, True)
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

    def _assign_slot(self, key) -> int:
        slot = self._slot_of_key.get(key)
        if slot is None:
            if not self._free:
                self._grow()
            slot = self._free.pop()
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
        self._free.append(slot)
        self._dirty[slot] = None

    def _grow(self) -> None:
        new_capacity = self.capacity * 2
        buffer = torch.zeros(
            (new_capacity, self._d_pad), dtype=torch.float32, device=self.device
        )
        valid = torch.zeros((new_capacity,), dtype=torch.bool, device=self.device)
        buffer[: self.capacity] = self._buffer
        valid[: self.capacity] = self._valid_dev
        self._buffer, self._valid_dev = buffer, valid
        self._free.extend(range(new_capacity - 1, self.capacity - 1, -1))
        self.capacity = new_capacity
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
        at = torch.from_numpy(slots).to(self.device)
        # one in-place indexed write per flush (the JAX package's donated
        # scatter)
        self._buffer.index_copy_(0, at, torch.from_numpy(vectors).to(self.device))
        self._valid_dev[at] = torch.from_numpy(slot_valid).to(self.device)
        self._dirty.clear()

    @property
    def device_buffer(self) -> torch.Tensor:
        """A copy of the first d columns: later flushes update the live
        buffer in place."""
        self._flush()
        return self._buffer[:, : self.d].clone()

    @property
    def device_valid(self) -> torch.Tensor:
        self._flush()
        return self._valid_dev.clone()

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
        top_scores, top_idx = _search(
            self._buffer, self._valid_dev, padded, min(k, self.capacity), self.metric
        )
        return top_scores[:q].cpu().numpy(), top_idx[:q].cpu().numpy(), self._key_of_slot

    def search_keys(self, queries, k: int) -> list:
        """Per query: list of (key, score) with invalid slots dropped."""
        top_scores, top_idx, key_of_slot = self.search(queries, k)
        return _format_rows(top_scores, top_idx, key_of_slot)


class FusedEmbedSearch:
    """tokens -> encoder -> similarity -> top-k with one upload and one
    host copy per query batch. The encoder and the index must both live
    on `device` (None: the CUDA card)."""

    def __init__(self, encoder, index: DeviceKnnIndex, *, device=None):
        self.device = resolve_device(device)
        if encoder.device != self.device or index.device != self.device:
            raise ValueError(
                f"encoder on {encoder.device} and index on {index.device}, "
                f"expected both on {self.device}"
            )
        self.encoder = encoder
        self.index = index
        if memtrack.ENABLED:
            # param bytes, keyed on the lm so an encoder shared between
            # FusedEmbedSearch instances counts once
            memtrack.tracker().register(
                "encoder_params",
                encoder.lm,
                sum(p.numel() * p.element_size() for p in encoder.lm.parameters()),
                device_span=1,
                dp_shards=1,
                model=type(encoder).__name__,
            )

    def embed_and_add(self, keys, texts) -> None:
        """Embed a doc batch and write it into the index, all on the device.
        Classic synchronous entry: unpacked prepare, then dispatch."""
        self.dispatch_batch(self.prepare_batch(keys, texts, pack=False)[0])

    def prepare_batch(self, keys, texts, *, pack: bool = True):
        """Host-side PREPARE stage: tokenize, packing into token-budget
        slabs when enabled. Returns (payload, meta); payload is consumed by
        dispatch_batch, meta carries rows / real-token / slab-token /
        slab-byte accounting. On the card, a batch that holds a doc longer
        than FLASH_MIN_LEN tokens takes the classic path: packed slabs
        attend densely within their segments, [rows, heads, L, L] scores,
        where the classic path's masked attention takes the flash kernel.
        The texts are tokenized once for either path."""
        texts = list(texts)
        keys = list(keys)
        budget = pack_token_budget() if pack else 0
        tokenizer, max_len = self.encoder.tokenizer, self.encoder.max_len
        if budget > 0 and texts:
            encoded = [tokenizer.encode(t, max_len) for t in texts]
            if self.device.type == "cuda" and max(map(len, encoded)) > FLASH_MIN_LEN:
                ids, mask = pad_encoded(tokenizer, encoded, max_len=max_len)
                payload = ("classic", keys, ids, mask, None)
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
        return payload, meta

    def dispatch_batch(self, payload):
        """Device DISPATCH stage: queue the encode (+ per-segment gather for
        packed slabs) and the index write; returns the embeddings [B, d] on
        the device. Batches must dispatch in submission order."""
        kind, keys, ids, second, slots = payload
        lm = self.encoder.lm
        if kind == "packed":
            pooled = lm.encode_packed(ids, second, PACK_MAX_SEGMENTS)
            at = to_device(torch.tensor(slots, dtype=torch.int64).reshape(-1, 2), pooled.device)
            emb = pooled[at[:, 0], at[:, 1]]
        else:
            emb = lm(ids, second)[: len(keys)]
        if keys:
            self.index.add_batch(keys, emb)
        return emb

    def _top_k(self, emb: torch.Tensor, k: int) -> torch.Tensor:
        """Dense similarity + top-k of [Q, d] embeddings over the index,
        packed as [Q, 2k] (scores, then slots as f32) for one host copy."""
        scores = _similarity(
            self.index._buffer, self.index._valid_dev, self.index._pad_cols(emb),
            self.index.metric,
        )
        top_scores, top_idx = torch.topk(scores, k, dim=1)
        return torch.cat([top_scores, top_idx.float()], dim=1)

    def _fused(self, ids, mask, k: int) -> torch.Tensor:
        lm = self.encoder.lm
        with torch.no_grad():
            emb = forward(
                lm.compute_params(),
                lm.config,
                torch.from_numpy(ids.astype(np.int32)).to(self.device),
                torch.from_numpy(mask.astype(np.int32)).to(self.device),
            )
            return self._top_k(emb, k)

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
        with torch.no_grad():
            pooled = self.encoder.lm.encode_packed(ids, seg, PACK_MAX_SEGMENTS)
            at = torch.tensor(slots, dtype=torch.int64).reshape(-1, 2).to(pooled.device)
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
            packed = self._fused(ids, mask, k_eff)
        packed = packed[: len(texts)].cpu().numpy()
        if _qtrace.ENABLED:
            # the device portion of the query (encode + search, up to the
            # host copy) into the tail-attribution window
            _qtrace.tracker().note_device_window(
                time_mod.perf_counter() - t0, source="knn_search"
            )
        scores = packed[:, :k_eff]
        idx = packed[:, k_eff:].astype(np.int64)
        return _format_rows(scores, idx, self.index._key_of_slot)
