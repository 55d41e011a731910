"""Columnar batch execution for flatten.

`VectorFlattenNode` keeps the exact emit contract of the classic
:class:`~pathway_tpu_torch.engine.operators.FlattenNode` — same derived
element keys, same output rows, same error logs — but splits each batch
into two passes:

* **extract** (row-wise python, unavoidable for object rows): the same
  Error/None/Json/str/sequence branches as the classic node produce the
  element list and output row tuples per parent,
* **derive + assemble** (columnar): every element key of the batch is
  computed in one vectorized numpy pass — the classic node's
  splitmix-style 128-bit finalizer rewritten over (hi, lo) u64 limb
  arrays (verified limb-exact against ``FlattenNode._derive_key`` by
  the test suite) — and the (key, row, diff) output triples are built
  in one native call (``value.triples_u128_batch``).

Pure-insert batches with no repeated parent key are provably already
consolidated (distinct (parent, position) pairs give distinct keys) and
skip the consolidation pass on emit.
"""

from __future__ import annotations

import os
from typing import Any, List

import numpy as np

from pathway_tpu_torch.engine.engine import Engine, Node
from pathway_tpu_torch.engine.operators import FlattenNode
from pathway_tpu_torch.engine.stream import Delta
from pathway_tpu_torch.engine.value import Error, flatten_triples_batch
from pathway_tpu_torch.internals import provenance as _provenance

# Flip to force the classic FlattenNode everywhere (tests / A-B benches).
VECTOR_FLATTEN_ENABLED = True

_M64 = (1 << 64) - 1

_MIX = FlattenNode._MIX
_MIX2 = FlattenNode._MIX2
_MIX_HI, _MIX_LO = _MIX >> 64, _MIX & _M64
_MIX2_HI, _MIX2_LO = _MIX2 >> 64, _MIX2 & _M64


def vector_flatten_supported() -> bool:
    """Build-time switch: module flag + env escape hatch."""
    return VECTOR_FLATTEN_ENABLED and not os.environ.get(
        "PATHWAY_DISABLE_VECTOR_FLATTEN"
    )


def _mulhi64(a: np.ndarray, b) -> np.ndarray:
    """High 64 bits of a u64 x u64 product, via 32-bit half products."""
    a0 = a & 0xFFFFFFFF
    a1 = a >> 32
    b = np.uint64(b) if not isinstance(b, np.ndarray) else b
    b0 = b & np.uint64(0xFFFFFFFF)
    b1 = b >> np.uint64(32)
    t = a0 * b0
    w = a1 * b0 + (t >> np.uint64(32))
    u = a0 * b1 + (w & np.uint64(0xFFFFFFFF))
    return a1 * b1 + (w >> np.uint64(32)) + (u >> np.uint64(32))


def _mul128(hi: np.ndarray, lo: np.ndarray, c: int):
    """(hi, lo) * c mod 2^128 for a 128-bit constant c."""
    c_hi, c_lo = np.uint64(c >> 64), np.uint64(c & _M64)
    res_lo = lo * c_lo
    res_hi = _mulhi64(lo, c_lo) + lo * c_hi + hi * c_lo
    return res_hi, res_lo


def derive_keys_u128(
    parent_hi: np.ndarray, parent_lo: np.ndarray, pos: np.ndarray
) -> bytes:
    """Vectorized ``FlattenNode._derive_key`` over parallel u64 limb
    arrays; returns the derived key values as n*16 little-endian bytes
    (the layout ``triples_u128_batch`` consumes)."""
    with np.errstate(over="ignore"):
        n = pos + np.uint64(1)
        m_lo = n * np.uint64(_MIX2_LO)
        m_hi = _mulhi64(n, _MIX2_LO) + n * np.uint64(_MIX2_HI)
        lo = parent_lo ^ m_lo
        hi = parent_hi ^ m_hi
        lo = lo ^ (hi >> np.uint64(3))  # x ^= x >> 67
        hi, lo = _mul128(hi, lo, _MIX)
        lo = lo ^ hi  # x ^= x >> 64
        hi, lo = _mul128(hi, lo, _MIX2)
        lo = lo ^ (hi >> np.uint64(3))  # x ^= x >> 67
    buf = np.empty((len(pos), 2), dtype="<u8")
    buf[:, 0] = lo
    buf[:, 1] = hi
    return buf.tobytes()


class VectorFlattenNode(FlattenNode):
    """Columnar flatten: row-wise element extraction, vectorized key
    derivation, fused output assembly."""

    name = "flatten"
    path = "columnar"

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        self.rows_processed += len(deltas)
        self.batches_processed += 1
        from pathway_tpu_torch.engine.value import Json

        idx = self.flat_idx
        # pass 1: extract elements per parent (classic branches)
        lineage_keys = [] if _provenance.ACTIVE else None
        parent_vals: List[int] = []
        parent_rows: List[tuple] = []
        counts: List[int] = []
        elems: List[Any] = []
        diffs: List[Any] = []
        pure_insert = True
        seen_parents = set()
        for key, values, diff in deltas:
            seq = values[idx]
            if isinstance(seq, Error):
                self.log_error("flatten: Error value")
                continue
            if seq is None:
                continue
            if isinstance(seq, Json):
                # only Json ARRAYS flatten; a dict would iterate raw str
                # keys under a Json-typed column (reference treats
                # non-array Json as an error row)
                if not isinstance(seq.value, list):
                    self.log_error(
                        f"flatten: Json value is not an array: {seq!r}"
                    )
                    continue
                elements: Any = [Json(v) for v in seq.value]
            elif isinstance(seq, str):
                elements = list(seq)
            else:
                try:
                    elements = list(seq)
                except TypeError:
                    self.log_error(f"flatten: not a sequence: {seq!r}")
                    continue
            m = len(elements)
            if not m:
                continue
            parent_vals.append(key.value)
            if lineage_keys is not None:
                lineage_keys.append(key)
            parent_rows.append(values)
            counts.append(m)
            elems.extend(elements)
            diffs.append(diff)
            if diff <= 0 or key in seen_parents:
                pure_insert = False
            seen_parents.add(key)
        if not elems:
            self.emit(time, [])
            return
        # pass 2: vectorized key derivation + fused triple assembly
        np_counts = np.asarray(counts, dtype=np.int64)
        total = int(np_counts.sum())
        starts = np.zeros(len(counts), dtype=np.int64)
        np.cumsum(np_counts[:-1], out=starts[1:])
        pos = (
            np.arange(total, dtype=np.int64) - np.repeat(starts, np_counts)
        ).astype(np.uint64)
        # limbs of value mod 2^128 — bitwise-exact vs the classic node's
        # `(key.value ^ m) & MASK` even for out-of-range values
        p_lo = np.fromiter(
            (v & _M64 for v in parent_vals), np.uint64, len(parent_vals)
        )
        p_hi = np.fromiter(
            ((v >> 64) & _M64 for v in parent_vals), np.uint64, len(parent_vals)
        )
        buf = derive_keys_u128(
            np.repeat(p_hi, np_counts), np.repeat(p_lo, np_counts), pos
        )
        out: List[Delta] = flatten_triples_batch(
            buf, parent_rows, counts, elems, idx, diffs
        )
        if lineage_keys is not None:
            # element key -> parent key pairs, classic FlattenNode parity
            pairs = []
            i = 0
            for p_idx, m in enumerate(counts):
                pk = lineage_keys[p_idx]
                d = diffs[p_idx]
                for _ in range(m):
                    pairs.append((out[i][0], pk, d))
                    i += 1
            _provenance.tracker().record_flatten(self, time, pairs)
        if pure_insert:
            # distinct (parent, position) pairs -> distinct derived keys:
            # nothing to cancel or sum, skip the consolidation pass
            self.emit_consolidated(time, out)
        else:
            self.emit(time, out)


def make_flatten_node(engine: Engine, input_: Node, flat_idx: int) -> FlattenNode:
    """Build-time selection mirroring `internals/groupbys.py`: columnar
    unless disabled. Flatten has no dtype gate — element extraction stays
    row-wise python, so every classic branch is supported."""
    cls = VectorFlattenNode if vector_flatten_supported() else FlattenNode
    return cls(engine, input_, flat_idx)
