"""Approximate KNN structures: LSH and IVF-flat (reference:
src/external_integration/usearch_integration.rs — usearch HNSW approximate
index; python/pathway/stdlib/indexing/nearest_neighbors.py LshKnn:262).

Two sub-linear indexes with exact rerank of the candidate set:

* `LshIndex` — sign-random-projection LSH for cosine/IP, p-stable
  (floor((a.x + b) / bucket_length)) for euclidean; `n_or` hash tables of
  `n_and` concatenated bits each, the reference LshKnn's parameters with
  the same meaning.
* `IvfIndex` — inverted-file flat index: k-means centroids over the
  corpus, queries probe the `n_probes` nearest lists, in place of HNSW:
  centroid scoring is one [Q, C] matmul and the probed lists rerank
  exactly.

Candidate rerank is exact, so recall degrades gracefully and never
produces phantom neighbors."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _scores(metric: str, vectors: np.ndarray, queries: np.ndarray):
    """similarity (higher better) between [N,d] and [Q,d] -> [Q,N]."""
    if metric == "cos":
        v = vectors / (np.linalg.norm(vectors, axis=1, keepdims=True) + 1e-30)
        q = queries / (np.linalg.norm(queries, axis=1, keepdims=True) + 1e-30)
        return q @ v.T
    if metric == "ip":
        return queries @ vectors.T
    if metric == "l2sq":
        sq_v = (vectors * vectors).sum(axis=1)
        sq_q = (queries * queries).sum(axis=1, keepdims=True)
        return 2.0 * (queries @ vectors.T) - sq_v[None, :] - sq_q
    raise ValueError(f"unknown metric {metric!r}")


class _BaseApproxIndex:
    def __init__(self, dimensions: int, metric: str):
        self.d = dimensions
        self.metric = metric
        self.vectors: Dict[Any, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.vectors)

    def add(self, key, vector) -> None:
        vector = np.asarray(vector, dtype=np.float32).reshape(-1)
        if vector.shape[0] != self.d:
            raise ValueError(
                f"vector dim {vector.shape[0]} != index dim {self.d}"
            )
        if key in self.vectors:
            self.remove(key)
        self.vectors[key] = vector
        self._insert(key, vector)

    def remove(self, key) -> None:
        vector = self.vectors.pop(key, None)
        if vector is not None:
            self._evict(key, vector)

    def _insert(self, key, vector) -> None:
        raise NotImplementedError

    def _evict(self, key, vector) -> None:
        raise NotImplementedError

    def _candidates(self, query: np.ndarray) -> List[Any]:
        raise NotImplementedError

    def search_many(
        self, queries: np.ndarray, k: int
    ) -> List[List[Tuple[Any, float]]]:
        queries = np.asarray(queries, dtype=np.float32)
        out: List[List[Tuple[Any, float]]] = []
        for q in queries:
            cand = self._candidates(q)
            if not cand:
                out.append([])
                continue
            mat = np.stack([self.vectors[c] for c in cand])
            scores = _scores(self.metric, mat, q[None, :])[0]
            top = np.argsort(-scores)[:k]
            out.append([(cand[i], float(scores[i])) for i in top])
        return out


class LshIndex(_BaseApproxIndex):
    def __init__(
        self,
        dimensions: int,
        *,
        metric: str = "cos",
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        seed: int = 0,
    ):
        super().__init__(dimensions, metric)
        self.n_or = n_or
        self.n_and = n_and
        self.bucket_length = float(bucket_length)
        rng = np.random.default_rng(seed)
        # [n_or, n_and, d] projection directions
        self.planes = rng.standard_normal(
            (n_or, n_and, dimensions)
        ).astype(np.float32)
        if metric == "l2sq":
            self.offsets = rng.uniform(
                0.0, self.bucket_length, size=(n_or, n_and)
            ).astype(np.float32)
        self.tables: List[Dict[tuple, set]] = [dict() for _ in range(n_or)]

    def _hashes(self, vector: np.ndarray) -> List[tuple]:
        proj = self.planes @ vector  # [n_or, n_and]
        if self.metric == "l2sq":
            buckets = np.floor(
                (proj + self.offsets) / self.bucket_length
            ).astype(np.int64)
            return [tuple(row) for row in buckets]
        return [tuple((row > 0).astype(np.int8)) for row in proj]

    def _insert(self, key, vector) -> None:
        for table, h in zip(self.tables, self._hashes(vector)):
            table.setdefault(h, set()).add(key)

    def _evict(self, key, vector) -> None:
        for table, h in zip(self.tables, self._hashes(vector)):
            bucket = table.get(h)
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del table[h]

    def _candidates(self, query: np.ndarray) -> List[Any]:
        seen: set = set()
        for table, h in zip(self.tables, self._hashes(query)):
            seen |= table.get(h, set())
        return list(seen)


class IvfIndex(_BaseApproxIndex):
    def __init__(
        self,
        dimensions: int,
        *,
        metric: str = "cos",
        n_probes: int = 4,
        retrain_every: int = 1024,
        max_centroids: int = 256,
        seed: int = 0,
    ):
        super().__init__(dimensions, metric)
        self.n_probes = n_probes
        self.retrain_every = retrain_every
        self.max_centroids = max_centroids
        self.seed = seed
        self.centroids: Optional[np.ndarray] = None
        self.lists: List[set] = []
        self.assignment: Dict[Any, int] = {}
        self._since_train = 0

    def _n_centroids(self) -> int:
        return int(min(self.max_centroids, max(1, np.sqrt(len(self.vectors)))))

    def _retrain(self) -> None:
        if not self.vectors:
            self.centroids, self.lists, self.assignment = None, [], {}
            return
        keys = list(self.vectors.keys())
        data = np.stack([self.vectors[k] for k in keys])
        n_c = self._n_centroids()
        if len(keys) <= n_c:
            self.centroids = data.copy()
        else:
            rng = np.random.default_rng(self.seed)
            centroids = data[rng.choice(len(keys), n_c, replace=False)]
            for _ in range(8):  # lloyd iterations; one matmul each
                assign = np.argmax(_scores(self.metric, centroids, data), 1)
                for c in range(n_c):
                    members = data[assign == c]
                    if len(members):
                        centroids[c] = members.mean(axis=0)
            self.centroids = centroids
        assign = np.argmax(_scores(self.metric, self.centroids, data), axis=1)
        self.lists = [set() for _ in range(len(self.centroids))]
        self.assignment = {}
        for key, c in zip(keys, assign):
            self.lists[int(c)].add(key)
            self.assignment[key] = int(c)
        self._since_train = 0

    def _insert(self, key, vector) -> None:
        self._since_train += 1
        if self.centroids is None or self._since_train >= self.retrain_every:
            self._retrain()
            return
        c = int(
            np.argmax(_scores(self.metric, self.centroids, vector[None, :]))
        )
        self.lists[c].add(key)
        self.assignment[key] = c

    def _evict(self, key, vector) -> None:
        c = self.assignment.pop(key, None)
        if c is not None and c < len(self.lists):
            self.lists[c].discard(key)

    def _candidates(self, query: np.ndarray) -> List[Any]:
        if self.centroids is None:
            return []
        scores = _scores(self.metric, self.centroids, query[None, :])[0]
        order = np.argsort(-scores)[: self.n_probes]
        cand: set = set()
        for c in order:
            cand |= self.lists[int(c)]
        return list(cand)
