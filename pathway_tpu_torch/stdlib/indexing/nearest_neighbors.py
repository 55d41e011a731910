"""KNN inner indexes (reference:
python/pathway/stdlib/indexing/nearest_neighbors.py: BruteForceKnn:170,
USearchKnn:65, LshKnn:262, factories :407-580).

BruteForceKnn runs on the port's device index (ops/knn.py): the knn_topk
kernel for pre-embedded vectors, the fused embed+search for a local
sentence encoder. The classes keep API parity with the reference so user
code ports unchanged. Counterpart of
pathway_tpu/stdlib/indexing/nearest_neighbors.py; the differences:

  * the index lives on a torch device: the encoder's for the fused impl,
    `device=` (None: the CUDA card) for the vector impl;
  * `_quiesce_device` reads back one element of the index buffer;
  * the vector impl's host path serves a CPU index only: on the card a
    degraded monitor makes its searches raise;
  * under a mesh (`mesh=`, or the run's mesh backend) the mesh's devices
    place the index, and a `device=` that contradicts them raises.
"""

from __future__ import annotations

import logging
import os
import enum
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from pathway_tpu_torch.engine.index_node import IndexImpl
from pathway_tpu_torch.internals import serving as _serving
from pathway_tpu_torch.ops.knn import DeviceKnnIndex
from pathway_tpu_torch.stdlib.indexing._filters import evaluate_filter
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex


class BruteForceKnnMetricKind(enum.Enum):
    COS = "cos"
    L2SQ = "l2sq"
    IP = "ip"


class USearchMetricKind(enum.Enum):
    COS = "cos"
    L2SQ = "l2sq"
    IP = "ip"


def _ingest_backend():
    """The process-wide mesh execution backend, when it can shard the
    bucketed ingest/index axes (power-of-two dp). Impls are built at
    engine-build time — inside pw.run(mesh=...) — so this is where an
    explicit `mesh=None` factory picks up the run's mesh."""
    from pathway_tpu_torch.internals.mesh_backend import active_backend

    backend = active_backend()
    if backend is not None and backend.can_shard_ingest():
        return backend
    return None


class DeviceDegradedError(RuntimeError):
    """A search reached an index on the card while the device monitor
    holds the card degraded."""


class _KnnIndexImpl(IndexImpl):
    """Device KNN; a host path while the monitor holds a CPU index
    degraded, none on the card.

    ``DeviceKnnIndex.add``/``remove`` only mutate host-side staging (the
    device scatter happens lazily inside ``search``). The JAX package
    answers from a numpy brute force over a host mirror while the device
    monitor reports DEGRADED. On the card that would move the index's
    work to the CPU behind the caller's back, so a search on a CUDA index
    raises ``DeviceDegradedError`` instead, and no mirror is kept; only an
    index placed on the CPU (``device="cpu"``) keeps the host path, whose
    mirror costs one float32 copy per live vector."""

    # every mutation flows through DeviceKnnIndex.add/remove, whose
    # serving generation hooks invalidate cached results — so the
    # serving result cache may front search_many (engine/index_node.py)
    supports_result_cache = True

    def __init__(
        self, dimensions: int, metric: str, reserved_space: int, mesh=None, device=None
    ):
        if mesh is None:
            backend = _ingest_backend()
            if backend is not None:
                mesh = backend.mesh
        self.knn = DeviceKnnIndex(
            dimensions, metric=metric, reserved_space=reserved_space, mesh=mesh,
            device=device,
        )
        self.metric = metric
        self.metadata: dict = {}
        # the host mirror, for a CPU index only (None on the card)
        self._host_vecs: Optional[dict] = (
            None if self.knn.device.type == "cuda" else {}
        )

    def add(self, key, value, metadata) -> None:
        vec = np.asarray(value, dtype=np.float32)
        self.knn.add(key, vec)
        if self._host_vecs is not None:
            self._host_vecs[key] = vec.reshape(-1)
        if metadata is not None:
            self.metadata[key] = metadata

    def remove(self, key) -> None:
        self.knn.remove(key)
        if self._host_vecs is not None:
            self._host_vecs.pop(key, None)
        self.metadata.pop(key, None)

    def _host_search(self, queries: np.ndarray, fetch: int) -> list:
        """Numpy brute force over the host mirror; same (key, score) row
        shape as DeviceKnnIndex.search_keys, higher-is-better scores."""
        keys = list(self._host_vecs.keys())
        mat = np.stack([self._host_vecs[k] for k in keys])
        if self.metric == "cos":
            qn = queries / (
                np.linalg.norm(queries, axis=1, keepdims=True) + 1e-30
            )
            mn = mat / (np.linalg.norm(mat, axis=1, keepdims=True) + 1e-30)
            scores = qn @ mn.T
        elif self.metric == "ip":
            scores = queries @ mat.T
        else:  # l2sq: negated squared distance so higher is better
            scores = -(
                (queries**2).sum(axis=1, keepdims=True)
                - 2.0 * queries @ mat.T
                + (mat**2).sum(axis=1)[None, :]
            )
        fetch = min(fetch, len(keys))
        order = np.argsort(-scores, axis=1)[:, :fetch]
        return [
            [(keys[j], float(scores[i, j])) for j in row]
            for i, row in enumerate(order)
        ]

    def search(self, value, k, metadata_filter):
        return self.search_many([value], [k], [metadata_filter])[0]

    def search_many(self, values, ks, filters):
        from pathway_tpu_torch.internals.device_probe import device_degraded

        if not values:
            return []
        if not len(self.knn):
            return [[] for _ in values]
        k_max = max(ks) if ks else 3
        # over-fetch when filtering so post-filter top-k stays full
        fetch = min(
            len(self.knn),
            max(k_max, k_max * 4 if any(f for f in filters) else k_max),
        )
        queries = np.stack([np.asarray(v, dtype=np.float32) for v in values])
        if device_degraded():
            if self._host_vecs is None:
                raise DeviceDegradedError(
                    "the device monitor holds the card degraded: the KNN "
                    "index lives there and is not searched on the host"
                )
            rows = self._host_search(queries, fetch)
        else:
            rows = self.knn.search_keys(queries, fetch)
        out = []
        for row, k, filt in zip(rows, ks, filters):
            if filt:
                row = [
                    (key, s)
                    for key, s in row
                    if evaluate_filter(filt, self.metadata.get(key))
                ]
            out.append(row[:k])
        return out


class _FusedKnnIndexImpl(IndexImpl):
    """Embed+search fused into one device dispatch per batch.

    When the embedder is a local sentence encoder, documents and queries
    arrive as raw text and the impl runs tokenize → encoder → similarity →
    top_k with one upload and one host copy per batch (ops/knn.py
    FusedEmbedSearch). Document embeddings are computed and written into
    the device index without leaving the card. This is the framework
    wiring of SURVEY §3.4's hot path."""

    # adds (sync or pipelined) and removes all land in DeviceKnnIndex,
    # whose serving generation hooks keep the result cache sound
    supports_result_cache = True

    def __init__(self, encoder, metric: str, reserved_space: int, mesh=None):
        from pathway_tpu_torch.ops.knn import DeviceKnnIndex, FusedEmbedSearch

        backend = None
        if mesh is None:
            # adopt the run's mesh backend: dp-sharded index + dp-grouped
            # packed ingest + tp-sharded encoder (ops/knn.FusedEmbedSearch)
            backend = _ingest_backend()
            if backend is not None:
                mesh = backend.mesh
        self._backend = backend
        # the index follows the encoder: FusedEmbedSearch needs both on one
        # device (under a mesh, its first)
        self.knn = DeviceKnnIndex(
            encoder.dimension, metric=metric, reserved_space=reserved_space,
            mesh=mesh, device=encoder.device,
        )
        self.fused = FusedEmbedSearch(
            encoder, self.knn, backend=backend, device=encoder.device
        )
        self.metadata: dict = {}
        self._pipeline = None
        self._pipeline_closed = False
        self._pipeline_broken = False

    def add(self, key, value, metadata) -> None:
        self.add_many([key], [value], [metadata])

    @staticmethod
    def _ingest_chunk() -> int:
        """Ingest chunking trades host/device overlap against per-dispatch
        overhead.  The default is one dispatch per batch on the classic
        path; PATHWAY_INGEST_CHUNK=4096 overlaps tokenization with the
        device's encode.  Read per call so the knob works after import;
        invalid/negative values mean 'off'."""
        try:
            return max(0, int(os.environ.get("PATHWAY_INGEST_CHUNK", "0")))
        except ValueError:
            return 0

    # -- async device pipeline wiring --------------------------------------

    def _use_pipeline(self) -> bool:
        from pathway_tpu_torch.internals.device_pipeline import pipeline_enabled
        from pathway_tpu_torch.internals.device_probe import device_degraded

        # a factory-attached mesh keeps the classic dispatch; the mesh
        # BACKEND path pipelines, one in-flight window per dp replica.
        # DEGRADED devices bypass the pipeline so in-flight work drains
        # and new batches take the synchronous path the monitor already
        # guards
        return (
            pipeline_enabled()
            and not self._pipeline_broken
            and (self.knn.mesh is None or self._backend is not None)
            and not device_degraded()
        )

    def _ensure_pipeline(self):
        if self._pipeline is None or self._pipeline_closed:
            self._pipeline_closed = False
            from pathway_tpu_torch.internals.device_pipeline import DevicePipeline

            self._pipeline = DevicePipeline(
                prepare=lambda item: self.fused.prepare_batch(*item),
                dispatch=self.fused.dispatch_batch,
                quiesce=self._quiesce_device,
                name="knn-ingest",
                replicas=self._backend.dp if self._backend else 1,
            )
        return self._pipeline

    def _quiesce_device(self) -> None:
        # one-element readback of each index buffer (each shard's block
        # under a mesh): it queues on its device's stream behind every
        # write to it, so its completion implies theirs (a CPU buffer has
        # nothing to wait for)
        from pathway_tpu_torch.internals.device_pipeline import _default_wait

        self.knn._flush()
        for buf in self.knn._device_buffers():
            _default_wait(buf)

    def _pipeline_step(self, n: int) -> int:
        # finer chunks than the monolithic sync default: prepare of chunk
        # i+1 overlaps device execution of chunk i (the whole point);
        # PATHWAY_INGEST_CHUNK still wins when set
        return self._ingest_chunk() or min(max(n, 1), 1024)

    def _disable_pipeline(self, exc) -> None:
        """Per-batch fallback, columnar-exchange style: disable the
        pipeline for this impl and replay every parked batch on the
        classic synchronous path (exactly once — parked batches never
        reached the device)."""
        self._pipeline_broken = True
        failed = self._pipeline.take_failed() if self._pipeline else []
        logging.getLogger(__name__).warning(
            "device pipeline disabled after %s: %s; replaying %d "
            "batch(es) synchronously",
            type(getattr(exc, "__cause__", None) or exc).__name__,
            exc,
            len(failed),
        )
        for keys_c, texts_c in failed:
            self.fused.embed_and_add(keys_c, texts_c)

    def _sync_pipeline(self, *, full: bool = False) -> None:
        """barrier (dispatched) or full drain (executed) of the ingest
        pipeline; pipeline failures downgrade to the sync replay path."""
        from pathway_tpu_torch.internals.device_pipeline import DevicePipelineError

        pipe = self._pipeline
        if pipe is None or self._pipeline_closed:
            return
        try:
            if full:
                pipe.drain()
            else:
                pipe.barrier()
        except DevicePipelineError as exc:
            self._disable_pipeline(exc)

    def drain(self) -> None:
        """Complete all in-flight pipeline batches and quiesce the device
        — the snapshot / rollback / failover / finish contract."""
        self._sync_pipeline(full=True)

    def close(self) -> None:
        """The run is over: stop the pipeline's threads, which would hold
        this index (and its device memory) for the life of the process.
        Its stats stay readable; a later batch starts a new pipeline."""
        if self._pipeline is not None and not self._pipeline_closed:
            self._pipeline.close()
            self._pipeline_closed = True

    def take_aux_spans(self):
        if self._pipeline is None:
            return []
        return self._pipeline.take_aux_spans()

    def add_many(self, keys, values, metas) -> None:
        from pathway_tpu_torch.internals.device_pipeline import DevicePipelineError

        texts = [v if isinstance(v, str) else str(v) for v in values]
        keys = list(keys)
        if _serving.ENABLED and keys:
            # the pipelined path defers the DeviceKnnIndex scatter (and
            # its generation hook) until dispatch; bump at SUBMIT so a
            # cache consult racing the pipeline can only over-invalidate,
            # never serve a result that predates this delta
            _serving.note_index_add(len(keys))
        if texts and self._use_pipeline():
            pipe = self._ensure_pipeline()
            step = self._pipeline_step(len(texts))
            chunks = [
                (keys[s : s + step], texts[s : s + step])
                for s in range(0, len(texts), step)
            ]
            for i, chunk in enumerate(chunks):
                try:
                    pipe.submit(chunk)
                except DevicePipelineError as exc:
                    self._disable_pipeline(exc)
                    for keys_c, texts_c in chunks[i:]:
                        self.fused.embed_and_add(keys_c, texts_c)
                    break
        elif texts:
            # classic synchronous path (PATHWAY_DEVICE_PIPELINE=0, mesh,
            # degraded device, or prior pipeline failure); finish any
            # still-pipelined work first so delta order is preserved
            self._sync_pipeline(full=True)
            step = self._ingest_chunk() or len(texts) or 1
            for s in range(0, len(texts), step):
                self.fused.embed_and_add(
                    keys[s : s + step], texts[s : s + step]
                )
        for key, meta in zip(keys, metas):
            if meta is not None:
                self.metadata[key] = meta

    def remove(self, key) -> None:
        # removes mutate the slot maps the dispatcher also writes — order
        # behind everything already submitted
        self._sync_pipeline()
        self.knn.remove(key)
        self.metadata.pop(key, None)

    def search(self, value, k, metadata_filter):
        return self.search_many([value], [k], [metadata_filter])[0]

    def search_many(self, values, ks, filters):
        # searches read the device buffer: a dispatch barrier suffices —
        # the card's stream orders the search behind the queued writes
        self._sync_pipeline()
        if not values:
            return []
        if len(self.knn) == 0:
            return [[] for _ in values]
        k_max = max(int(k) for k in ks) if ks else 3
        fetch = min(
            len(self.knn),
            k_max * 4 if any(f for f in filters) else k_max,
        )
        texts = [v if isinstance(v, str) else str(v) for v in values]
        rows = self.fused.search_texts(texts, fetch)
        out = []
        for row, k, filt in zip(rows, ks, filters):
            if filt:
                row = [
                    (key, s)
                    for key, s in row
                    if evaluate_filter(filt, self.metadata.get(key))
                ]
            out.append(row[: int(k)])
        return out


def _local_jax_encoder(embedder):
    """The fused path needs a device-resident encoder: a
    SentenceTransformerEmbedder-style object exposing `.encoder` with
    tokenizer/params. API-backed embedders (OpenAI etc.) return None and
    keep the UDF pre-embedding path. (The name is the JAX package's, so a
    reader finds the counterpart; the encoder here is the port's.)"""
    encoder = getattr(embedder, "encoder", None)
    if encoder is not None and hasattr(encoder, "lm") and hasattr(
        encoder, "tokenizer"
    ):
        return encoder
    return None


class BruteForceKnn(InnerIndex):
    """Exact KNN on the card (reference: nearest_neighbors.py
    BruteForceKnn:170; kernel: brute_force_knn_integration.rs → ops/knn.py).
    `device` places the vector impl's index (None: the CUDA card); `mesh`
    shards it over the mesh's first axis, on the mesh's devices."""

    def __init__(
        self,
        data_column,
        metadata_column=None,
        *,
        dimensions: int,
        reserved_space: int = 512,
        metric: BruteForceKnnMetricKind = BruteForceKnnMetricKind.COS,
        embedder=None,
        mesh=None,
        device=None,
    ):
        super().__init__(data_column, metadata_column)
        self.dimensions = dimensions
        self.reserved_space = reserved_space
        self.metric = metric
        self.embedder = embedder
        # mesh: shard the device index over the mesh's first axis
        # (sharded_knn_search); None = single-device buffer
        self.mesh = mesh
        # where the vector impl keeps its index (None: the CUDA card); the
        # fused impl follows its encoder's device instead
        self.device = device

    def _make_impl(self) -> IndexImpl:
        encoder = _local_jax_encoder(self.embedder)
        if encoder is not None:
            return _FusedKnnIndexImpl(
                encoder, self.metric.value, self.reserved_space,
                mesh=self.mesh,
            )
        return _KnnIndexImpl(
            self.dimensions, self.metric.value, self.reserved_space,
            mesh=self.mesh, device=self.device,
        )

    def _query_preprocess(self, query_column):
        if self.embedder is not None and _local_jax_encoder(self.embedder) is None:
            return self.embedder(query_column)
        return query_column

    def _data_preprocess(self, data_column):
        if self.embedder is not None and _local_jax_encoder(self.embedder) is None:
            return self.embedder(data_column)
        return data_column


class _ApproxIndexImpl(IndexImpl):
    """IndexImpl over an approximate structure (LSH / IVF) with exact
    candidate rerank + metadata filtering."""

    def __init__(self, inner):
        self.inner = inner
        self.metadata: dict = {}

    def add(self, key, value, metadata) -> None:
        self.inner.add(key, np.asarray(value, dtype=np.float32))
        if metadata is not None:
            self.metadata[key] = metadata

    def remove(self, key) -> None:
        self.inner.remove(key)
        self.metadata.pop(key, None)

    def search(self, value, k, metadata_filter):
        return self.search_many([value], [k], [metadata_filter])[0]

    def search_many(self, values, ks, filters):
        if not values:
            return []
        if len(self.inner) == 0:
            return [[] for _ in values]
        k_max = max(int(k) for k in ks) if ks else 3
        fetch = k_max * 4 if any(f for f in filters) else k_max
        queries = np.stack([np.asarray(v, dtype=np.float32) for v in values])
        rows = self.inner.search_many(queries, fetch)
        out = []
        for row, k, filt in zip(rows, ks, filters):
            if filt:
                row = [
                    (key, s)
                    for key, s in row
                    if evaluate_filter(filt, self.metadata.get(key))
                ]
            out.append(row[: int(k)])
        return out


class USearchKnn(BruteForceKnn):
    """Approximate KNN in the reference's USearchKnn slot
    (nearest_neighbors.py USearchKnn:65, usearch_integration.rs:20).

    Departure: instead of an HNSW graph walk, this is an IVF-flat index
    (host numpy, as in the JAX package) — k-means centroid probing
    (one [Q, C] matmul) + exact rerank of the probed lists. Parameter
    mapping: `expansion_search` bounds the probed-list count,
    `connectivity` the centroid budget."""

    def __init__(
        self,
        data_column,
        metadata_column=None,
        *,
        dimensions: int,
        reserved_space: int = 512,
        metric: USearchMetricKind = USearchMetricKind.COS,
        connectivity: int = 16,
        expansion_add: int = 128,
        expansion_search: int = 64,
        embedder=None,
    ):
        m = BruteForceKnnMetricKind(metric.value)
        super().__init__(
            data_column,
            metadata_column,
            dimensions=dimensions,
            reserved_space=reserved_space,
            metric=m,
            embedder=embedder,
        )
        self.connectivity = connectivity
        self.expansion_add = expansion_add
        self.expansion_search = expansion_search

    def _make_impl(self) -> IndexImpl:
        from pathway_tpu_torch.stdlib.indexing.approximate import IvfIndex

        return _ApproxIndexImpl(
            IvfIndex(
                self.dimensions,
                metric=self.metric.value,
                n_probes=max(1, self.expansion_search // 16),
                max_centroids=max(16, self.connectivity * 16),
                retrain_every=max(128, self.expansion_add * 8),
            )
        )

    def _query_preprocess(self, query_column):
        if self.embedder is not None:
            return self.embedder(query_column)
        return query_column

    _data_preprocess = _query_preprocess


class LshKnn(BruteForceKnn):
    """Locality-sensitive-hashing KNN (reference: nearest_neighbors.py
    LshKnn:262). n_or hash tables of n_and projections each; euclidean
    uses p-stable hashing with `bucket_length`, cosine sign-random
    projections. Candidates rerank exactly."""

    def __init__(
        self,
        data_column,
        metadata_column=None,
        *,
        dimensions: int,
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        distance_type: str = "euclidean",
        embedder=None,
        reserved_space: int = 512,
    ):
        metric = (
            BruteForceKnnMetricKind.COS
            if distance_type == "cosine"
            else BruteForceKnnMetricKind.L2SQ
        )
        super().__init__(
            data_column,
            metadata_column,
            dimensions=dimensions,
            reserved_space=reserved_space,
            metric=metric,
            embedder=embedder,
        )
        self.n_or = n_or
        self.n_and = n_and
        self.bucket_length = bucket_length

    def _make_impl(self) -> IndexImpl:
        from pathway_tpu_torch.stdlib.indexing.approximate import LshIndex

        return _ApproxIndexImpl(
            LshIndex(
                self.dimensions,
                metric=self.metric.value,
                n_or=self.n_or,
                n_and=self.n_and,
                bucket_length=self.bucket_length,
            )
        )

    def _query_preprocess(self, query_column):
        if self.embedder is not None:
            return self.embedder(query_column)
        return query_column

    _data_preprocess = _query_preprocess


class AbstractRetrieverFactory:
    """Base for index factories (reference: indexing/retrievers.py
    AbstractRetrieverFactory:7): subclasses provide build_inner_index;
    build_index wraps it in a DataIndex."""

    def build_inner_index(self, data_column, metadata_column=None):
        raise NotImplementedError

    def build_index(self, data_column, data_table, metadata_column=None):
        from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex

        return DataIndex(
            data_table, self.build_inner_index(data_column, metadata_column)
        )


@dataclass(kw_only=True)
class BruteForceKnnFactory(AbstractRetrieverFactory):
    """reference: nearest_neighbors.py BruteForceKnnFactory:407."""

    dimensions: int | None = None
    reserved_space: int = 512
    metric: BruteForceKnnMetricKind = BruteForceKnnMetricKind.COS
    embedder: Any = None
    mesh: Any = None
    device: Any = None

    def build_inner_index(self, data_column, metadata_column=None) -> InnerIndex:
        dimensions = self.dimensions
        if dimensions is None and self.embedder is not None:
            dimensions = self.embedder.get_embedding_dimension()
        return BruteForceKnn(
            data_column,
            metadata_column,
            dimensions=dimensions,
            reserved_space=self.reserved_space,
            metric=self.metric,
            embedder=self.embedder,
            mesh=self.mesh,
            device=self.device,
        )



@dataclass(kw_only=True)
class UsearchKnnFactory(AbstractRetrieverFactory):
    """reference: nearest_neighbors.py UsearchKnnFactory."""

    dimensions: int | None = None
    reserved_space: int = 512
    metric: USearchMetricKind = USearchMetricKind.COS
    connectivity: int = 16
    expansion_add: int = 128
    expansion_search: int = 64
    embedder: Any = None

    def build_inner_index(self, data_column, metadata_column=None) -> InnerIndex:
        dimensions = self.dimensions
        if dimensions is None and self.embedder is not None:
            dimensions = self.embedder.get_embedding_dimension()
        return USearchKnn(
            data_column,
            metadata_column,
            dimensions=dimensions,
            reserved_space=self.reserved_space,
            metric=self.metric,
            connectivity=self.connectivity,
            expansion_add=self.expansion_add,
            expansion_search=self.expansion_search,
            embedder=self.embedder,
        )



@dataclass(kw_only=True)
class LshKnnFactory(AbstractRetrieverFactory):
    dimensions: int | None = None
    n_or: int = 20
    n_and: int = 10
    bucket_length: float = 10.0
    distance_type: str = "euclidean"
    embedder: Any = None

    def build_inner_index(self, data_column, metadata_column=None) -> InnerIndex:
        return LshKnn(
            data_column,
            metadata_column,
            dimensions=self.dimensions,
            n_or=self.n_or,
            n_and=self.n_and,
            bucket_length=self.bucket_length,
            distance_type=self.distance_type,
            embedder=self.embedder,
        )




@dataclass(kw_only=True)
class DefaultKnnFactory(BruteForceKnnFactory):
    """The default KNN factory — brute force on the device (reference:
    nearest_neighbors.py DefaultKnnFactory:574, which also defaults to
    BruteForceKnn)."""
