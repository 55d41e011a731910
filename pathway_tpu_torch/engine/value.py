"""Engine value model: keys, pointers, Json, Error/Pending sentinels.

TPU-native rebuild of the reference's value layer (reference:
src/engine/value.rs:41-231). Keys are 128-bit hashes (blake2b-derived, the
stdlib equivalent of the reference's xxh3-128) so row identity is stable across
workers and restarts; the low SHARD_BITS bits select the data-parallel shard —
on TPU the shard maps to a mesh device / host worker.

`pw.Json` wraps arbitrary JSON values; expressions index into it and
extract typed scalars:

>>> import pathway_tpu_torch as pw
>>> t = pw.debug.table_from_rows(
...     pw.schema_from_types(data=pw.Json),
...     [(pw.Json({"k": [1, 2]}),)],
... )
>>> r = t.select(n=pw.this.data["k"][0].as_int())
>>> pw.debug.compute_and_print(r, include_id=False)
n
1
"""

from __future__ import annotations

import hashlib
import json as _json
import struct
from typing import Any, Iterable

import numpy as np

SHARD_BITS = 16
SHARD_MASK = (1 << SHARD_BITS) - 1
_KEY_MASK = (1 << 128) - 1


class Error:
    """Singleton-ish error value (reference: Value::Error). Errors propagate
    through expressions and reducers; `fill_error` replaces them."""

    __slots__ = ("trace",)
    _instance: "Error | None" = None

    def __new__(cls, trace: str | None = None):
        if trace is None and cls._instance is not None:
            return cls._instance
        obj = super().__new__(cls)
        obj.trace = trace
        if trace is None:
            cls._instance = obj
        return obj

    def __repr__(self) -> str:
        return "Error"

    def __bool__(self):
        raise ValueError("cannot convert Error to bool")


ERROR = Error()


class _Pending:
    """Placeholder for not-yet-computed fully-async UDF results
    (reference: Value::Pending)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Pending"


Pending = _Pending()


class Pointer:
    """A row id: 128-bit key (reference: Key(u128), value.rs:41).

    Optionally remembers the values it was derived from for debug printing.
    """

    __slots__ = ("value", "_origin", "_h")

    def __init__(self, value: int, origin: tuple | None = None):
        value &= _KEY_MASK
        self.value = value
        self._origin = origin
        # dict lookups keyed by Pointer dominate the engine's host hot
        # loop; hashing the 128-bit int once at construction beats
        # rehashing it on every lookup
        self._h = hash(value)

    def __eq__(self, other):
        return isinstance(other, Pointer) and self.value == other.value

    def __lt__(self, other):
        return self.value < other.value

    def __le__(self, other):
        return self.value <= other.value

    def __gt__(self, other):
        return self.value > other.value

    def __ge__(self, other):
        return self.value >= other.value

    def __hash__(self):
        return self._h

    def __reduce__(self):
        # exchange/persistence serialization: ship only the 128-bit value.
        # _origin is a debug-repr nicety that can triple message size (it
        # holds the values the key was derived from), and _h is recomputed
        # by __init__.
        return (Pointer, (self.value,))

    def __setstate__(self, state):
        # Pointers pickled before the _h slot existed restore via default
        # slots-state without running __init__ — recompute the hash cache
        slots = state[1] if isinstance(state, tuple) else state
        self.value = slots["value"]
        self._origin = slots.get("_origin")
        self._h = slots.get("_h", hash(self.value))

    def __repr__(self):
        if self._origin is not None and len(self._origin) == 1:
            return f"^{self._origin[0]}"
        return f"^{self.value:032X}"[:12]

    @property
    def shard(self) -> int:
        return self.value & SHARD_MASK

    def with_shard_of(self, other: "Pointer") -> "Pointer":
        return Pointer((self.value & ~SHARD_MASK) | (other.value & SHARD_MASK))


def _hash_bytes(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=16).digest(), "little")


def _serialize_for_hash(value: Any, out: list) -> None:
    if value is None:
        out.append(b"\x00N")
    elif isinstance(value, bool):
        out.append(b"\x01" + (b"\x01" if value else b"\x00"))
    elif isinstance(value, int):
        out.append(b"\x02" + value.to_bytes(16, "little", signed=True))
    elif isinstance(value, float):
        if value.is_integer() and abs(value) < 2**62:
            # ints and integral floats hash identically (reference HashInto
            # treats 1 == 1.0 for keying)
            out.append(b"\x02" + int(value).to_bytes(16, "little", signed=True))
        else:
            out.append(b"\x03" + struct.pack("<d", value))
    elif isinstance(value, str):
        b = value.encode()
        out.append(b"\x04" + len(b).to_bytes(8, "little") + b)
    elif isinstance(value, bytes):
        out.append(b"\x05" + len(value).to_bytes(8, "little") + value)
    elif isinstance(value, Pointer):
        out.append(b"\x06" + value.value.to_bytes(16, "little"))
    elif isinstance(value, (tuple, list)):
        out.append(b"\x07" + len(value).to_bytes(8, "little"))
        for v in value:
            _serialize_for_hash(v, out)
    elif isinstance(value, np.ndarray):
        out.append(b"\x08" + str(value.dtype).encode() + value.tobytes())
    elif isinstance(value, Json):
        out.append(b"\x09" + _json.dumps(value.value, sort_keys=True).encode())
    else:
        import datetime

        if isinstance(value, datetime.datetime):
            out.append(b"\x0a" + value.isoformat().encode())
        elif isinstance(value, datetime.timedelta):
            out.append(b"\x0b" + struct.pack("<d", value.total_seconds()))
        else:
            out.append(b"\x0c" + repr(value).encode())


def hash_values(*values: Any) -> int:
    out: list = []
    for v in values:
        _serialize_for_hash(v, out)
    return _hash_bytes(b"".join(out))


_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """Standard splitmix64 finalizer (bijective on 64-bit ints)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def seq_key(seed: int, counter: int) -> Pointer:
    """Auto-assigned connector row key: high 64 bits carry the source seed,
    low 64 bits are splitmix64 of (counter ^ seed-low) — bijective in
    `counter` for a fixed seed (collision-free within a source), uniformly
    mixed so the low shard bits balance across workers, and ~50x cheaper
    than the blake2b in ref_scalar.  Stable across runs: the seed derives
    from the source name and the counter is persisted subject state.  The
    batch variant (`seq_keys_batch`) computes the same keys vectorized."""
    lo = _splitmix64((counter ^ seed) & _M64)
    return Pointer(((seed >> 64) << 64) | lo)


def seq_keys_batch(seed: int, start_counter: int, n: int) -> list:
    """`[seq_key(seed, start_counter + 1 + i) for i in range(n)]`, with the
    64-bit mixing done in one numpy pass and the Pointer objects built in
    bulk by the native layer when available (tp_alloc + direct slot
    stores — the per-row key cost dominates bulk ingest otherwise)."""
    hi = (seed >> 64) << 64
    with np.errstate(over="ignore"):
        x = np.arange(
            start_counter + 1, start_counter + n + 1, dtype=np.uint64
        ) ^ np.uint64(seed & _M64)
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    fast = _fast_pointer_builder()
    if fast is not None:
        return fast(seed >> 64, x.astype("<u8", copy=False).tobytes())
    return [Pointer(hi | v) for v in x.tolist()]


_fast_pointers = None
_fast_pointers_checked = False


def _fast_pointer_builder():
    """Native bulk Pointer constructor, verified once against the python
    construction path before use (slot layout + hash + equality)."""
    global _fast_pointers, _fast_pointers_checked
    if _fast_pointers_checked:
        return _fast_pointers
    _fast_pointers_checked = True
    try:
        from pathway_tpu_torch import native

        ext = native.load_wire_ext()
        if ext is None:
            return None
        probe_hi = 0xDEAD
        probe_lo = 0xBEEF00112233
        (made,) = ext.make_seq_pointers(
            probe_hi, probe_lo.to_bytes(8, "little")
        )
        ref = Pointer((probe_hi << 64) | probe_lo)
        if (
            type(made) is Pointer
            and made == ref
            and hash(made) == hash(ref)
            and made.value == ref.value
            and made._origin is None
        ):
            _fast_pointers = ext.make_seq_pointers
    except Exception:  # noqa: BLE001 — python construction always works
        _fast_pointers = None
    return _fast_pointers


_fast_pairs = None
_fast_pairs_checked = False


def _fast_pair_builder():
    """Native bulk `ref_scalar(lk, rk)` (blake2b-128 over the serialized
    key pair), verified once against the python derivation before use."""
    global _fast_pairs, _fast_pairs_checked
    if _fast_pairs_checked:
        return _fast_pairs
    _fast_pairs_checked = True
    try:
        from pathway_tpu_torch import native

        ext = native.load_wire_ext()
        if ext is None or not hasattr(ext, "make_pair_pointers"):
            return None
        lk = Pointer(0xDEADBEEF00112233445566778899AABB)
        rk = Pointer(0x0102030405060708090A0B0C0D0E0F10)
        (made,) = ext.make_pair_pointers(
            lk.value.to_bytes(16, "little"), rk.value.to_bytes(16, "little")
        )
        ref = ref_scalar(lk, rk)
        if (
            type(made) is Pointer
            and made == ref
            and hash(made) == hash(ref)
            and made.value == ref.value
            and made._origin is None
        ):
            _fast_pairs = ext.make_pair_pointers
    except Exception:  # noqa: BLE001 — python derivation always works
        _fast_pairs = None
    return _fast_pairs


def pair_keys_batch(lvals: bytes, rvals: bytes) -> list:
    """`[ref_scalar(lk, rk) for lk, rk in pairs]` from concatenated
    16-byte little-endian key values — the columnar join's output-key
    kernel. Native when available; a tight hashlib loop otherwise (still
    several times cheaper than generic ref_scalar per pair)."""
    fast = _fast_pair_builder()
    if fast is not None:
        return fast(lvals, rvals)
    from hashlib import blake2b

    n = len(lvals) // 16
    out = []
    append = out.append
    for i in range(n):
        o = i * 16
        msg = b"\x06" + lvals[o : o + 16] + b"\x06" + rvals[o : o + 16]
        append(
            Pointer(
                int.from_bytes(
                    blake2b(msg, digest_size=16).digest(), "little"
                )
            )
        )
    return out


_fast_u128 = None
_fast_u128_checked = False


def _fast_u128_builder():
    """Native bulk Pointer constructor over varying 128-bit values
    (make_seq_pointers covers only a constant high limb), verified once."""
    global _fast_u128, _fast_u128_checked
    if _fast_u128_checked:
        return _fast_u128
    _fast_u128_checked = True
    try:
        from pathway_tpu_torch import native

        ext = native.load_wire_ext()
        if ext is None or not hasattr(ext, "make_pointers_u128"):
            return None
        probe = 0xFEDCBA9876543210FEDCBA9876543210
        (made,) = ext.make_pointers_u128(probe.to_bytes(16, "little"))
        ref = Pointer(probe)
        if (
            type(made) is Pointer
            and made == ref
            and hash(made) == hash(ref)
            and made.value == ref.value
            and made._origin is None
        ):
            _fast_u128 = ext.make_pointers_u128
    except Exception:  # noqa: BLE001
        _fast_u128 = None
    return _fast_u128


def pointers_u128_batch(vals: bytes) -> list:
    """`[Pointer(v) for v in 16-byte-LE records]` — bulk materialization
    of precomputed 128-bit key values (flatten's vectorized derive)."""
    fast = _fast_u128_builder()
    if fast is not None:
        return fast(vals)
    return [
        Pointer(int.from_bytes(vals[o : o + 16], "little"))
        for o in range(0, len(vals), 16)
    ]


_fast_join_triples = None
_fast_join_triples_checked = False


def _fast_join_triples_builder():
    """Native fused join-output kernel — pair key hash, output row tuple
    and delta triple in one C pass over the match columns. Verified once
    against the python derivation before use."""
    global _fast_join_triples, _fast_join_triples_checked
    if _fast_join_triples_checked:
        return _fast_join_triples
    _fast_join_triples_checked = True
    try:
        from pathway_tpu_torch import native

        ext = native.load_wire_ext()
        if ext is None or not hasattr(ext, "make_join_triples"):
            return None
        lk = Pointer(0xDEADBEEF00112233445566778899AABB)
        rk = Pointer(0x0102030405060708090A0B0C0D0E0F10)
        (made,) = ext.make_join_triples([lk], [rk], [(1, "x")], [(2.5,)], [1])
        ref_key = ref_scalar(lk, rk)
        key, row, diff = made
        if (
            type(key) is Pointer
            and key == ref_key
            and hash(key) == hash(ref_key)
            and key.value == ref_key.value
            and key._origin is None
            and row == (lk, rk, 1, "x", 2.5)
            and diff == 1
        ):
            _fast_join_triples = ext.make_join_triples
    except Exception:  # noqa: BLE001 — python derivation always works
        _fast_join_triples = None
    return _fast_join_triples


def join_triples_batch(lks: list, rks: list, lrows: list, rrows: list, diffs: list) -> list:
    """`[(ref_scalar(lk, rk), (lk, rk, *lrow, *rrow), d), ...]` over five
    parallel match columns — the columnar join's entire output assembly in
    one call (native when available)."""
    fast = _fast_join_triples_builder()
    if fast is not None:
        return fast(lks, rks, lrows, rrows, diffs)
    return [
        (ref_scalar(a, b), (a, b) + ar + br, d)
        for a, b, ar, br, d in zip(lks, rks, lrows, rrows, diffs)
    ]


_fast_pair_list = None
_fast_pair_list_checked = False


def _fast_pair_list_builder():
    global _fast_pair_list, _fast_pair_list_checked
    if _fast_pair_list_checked:
        return _fast_pair_list
    _fast_pair_list_checked = True
    try:
        from pathway_tpu_torch import native

        ext = native.load_wire_ext()
        if ext is None or not hasattr(ext, "make_pair_pointers_list"):
            return None
        lk = Pointer(0xDEADBEEF00112233445566778899AABB)
        rk = Pointer(0x0102030405060708090A0B0C0D0E0F10)
        (made,) = ext.make_pair_pointers_list([lk], [rk])
        ref = ref_scalar(lk, rk)
        if (
            type(made) is Pointer
            and made == ref
            and hash(made) == hash(ref)
            and made.value == ref.value
            and made._origin is None
        ):
            _fast_pair_list = ext.make_pair_pointers_list
    except Exception:  # noqa: BLE001
        _fast_pair_list = None
    return _fast_pair_list


def pair_keys_from_pointers(lks: list, rks: list) -> list:
    """`[ref_scalar(lk, rk) for ...]` from two Pointer lists (native reads
    the value slots directly; python fallback is exact by construction)."""
    fast = _fast_pair_list_builder()
    if fast is not None:
        return fast(lks, rks)
    return [ref_scalar(a, b) for a, b in zip(lks, rks)]


_fast_u128_triples = None
_fast_u128_triples_checked = False


def _fast_u128_triples_builder():
    global _fast_u128_triples, _fast_u128_triples_checked
    if _fast_u128_triples_checked:
        return _fast_u128_triples
    _fast_u128_triples_checked = True
    try:
        from pathway_tpu_torch import native

        ext = native.load_wire_ext()
        if ext is None or not hasattr(ext, "make_triples_u128"):
            return None
        probe = 0xFEDCBA9876543210FEDCBA9876543210
        (made,) = ext.make_triples_u128(
            probe.to_bytes(16, "little"), [("r",)], [-1]
        )
        key, row, diff = made
        ref = Pointer(probe)
        if (
            type(key) is Pointer
            and key == ref
            and hash(key) == hash(ref)
            and key.value == ref.value
            and key._origin is None
            and row == ("r",)
            and diff == -1
        ):
            _fast_u128_triples = ext.make_triples_u128
    except Exception:  # noqa: BLE001
        _fast_u128_triples = None
    return _fast_u128_triples


def triples_u128_batch(vals: bytes, rows: list, diffs: list) -> list:
    """`[(Pointer(v_i), rows[i], diffs[i]), ...]` from 16-byte-LE key
    records — the flatten path's bulk output assembly."""
    fast = _fast_u128_triples_builder()
    if fast is not None:
        return fast(vals, rows, diffs)
    return [
        (Pointer(int.from_bytes(vals[o : o + 16], "little")), rows[i], diffs[i])
        for i, o in enumerate(range(0, len(vals), 16))
    ]


_fast_flatten_triples = None
_fast_flatten_triples_checked = False


def _fast_flatten_triples_builder():
    global _fast_flatten_triples, _fast_flatten_triples_checked
    if _fast_flatten_triples_checked:
        return _fast_flatten_triples
    _fast_flatten_triples_checked = True
    try:
        from pathway_tpu_torch import native

        ext = native.load_wire_ext()
        if ext is None or not hasattr(ext, "flatten_triples"):
            return None
        v1 = 0xFEDCBA9876543210FEDCBA9876543210
        v2 = 0x00000000000000000000000000000007
        buf = v1.to_bytes(16, "little") + v2.to_bytes(16, "little")
        made = ext.flatten_triples(
            buf, [(1, "seq", 2.5)], [2], ["a", "b"], 1, [-1]
        )
        k1, k2 = Pointer(v1), Pointer(v2)
        if (
            len(made) == 2
            and type(made[0][0]) is Pointer
            and made[0][0] == k1
            and hash(made[0][0]) == hash(k1)
            and made[0][0].value == v1
            and made[0][0]._origin is None
            and made[0][1] == (1, "a", 2.5)
            and made[0][2] == -1
            and made[1][0] == k2
            and made[1][1] == (1, "b", 2.5)
            and made[1][2] == -1
        ):
            _fast_flatten_triples = ext.flatten_triples
    except Exception:  # noqa: BLE001
        _fast_flatten_triples = None
    return _fast_flatten_triples


def flatten_triples_batch(
    vals: bytes, parents: list, counts: list, elems: list, flat_idx: int, diffs: list
) -> list:
    """Fused flatten output assembly: per element, the derived-key
    Pointer (from 16-byte-LE `vals`), the parent row with the sequence
    column replaced by the element, and the delta triple."""
    fast = _fast_flatten_triples_builder()
    if fast is not None:
        return fast(vals, parents, counts, elems, flat_idx, diffs)
    out = []
    pos = 0
    for row, m, diff in zip(parents, counts, diffs):
        pre, post = row[:flat_idx], row[flat_idx + 1 :]
        for j in range(m):
            key = Pointer(int.from_bytes(vals[pos * 16 : pos * 16 + 16], "little"))
            out.append((key, pre + (elems[pos],) + post, diff))
            pos += 1
    return out


_fast_delta_side = None
_fast_delta_side_checked = False


def _fast_delta_side_probe(fn) -> bool:
    """Exercise every kernel branch (code alloc, match + triple build,
    Error skip, retraction) against the python-derived expectation."""
    jv_code: dict = {}
    left_rows: list = []
    right_rows: list = []
    lk = Pointer(0xDEADBEEF00112233445566778899AABB)
    rk = Pointer(0x0102030405060708090A0B0C0D0E0F10)
    rk2 = Pointer(0x00000000000000000000000000000042)
    out: list = []
    res = fn(jv_code, ["a"], [(lk, (1, "x"), 1)], left_rows, right_rows, 1, Error, out)
    if res != (0, 0) or out or jv_code != {"a": 0}:
        return False
    if left_rows != [{lk: (1, "x")}] or right_rows != [{}]:
        return False
    res = fn(
        jv_code,
        ["a", Error("boom"), "a"],
        [(rk, (2.5,), 1), (rk2, (9,), 1), (rk2, (3.5,), 1)],
        left_rows,
        right_rows,
        0,
        Error,
        out,
    )
    if res != (0, 1) or len(out) != 2:
        return False
    ref_key = ref_scalar(lk, rk)
    key, row, diff = out[0]
    if not (
        type(key) is Pointer
        and key == ref_key
        and hash(key) == hash(ref_key)
        and key.value == ref_key.value
        and key._origin is None
        and row == (lk, rk, 1, "x", 2.5)
        and diff == 1
    ):
        return False
    if out[1][1] != (lk, rk2, 1, "x", 3.5):
        return False
    if right_rows != [{rk: (2.5,), rk2: (3.5,)}]:
        return False
    out2: list = []
    res = fn(jv_code, ["a"], [(rk, (2.5,), -1)], left_rows, right_rows, 0, Error, out2)
    if res != (1, 0) or len(out2) != 1 or out2[0][2] != -1:
        return False
    return right_rows == [{rk2: (3.5,)}]


def join_delta_side_native():
    """The columnar join's fused delta-mode pass (or None): one C loop
    doing jv->code lookup, match expansion with triple construction and
    own-bucket updates in stream order. The pure-python equivalent lives
    in `vector_join.VectorJoinNode._delta_side_vec`."""
    global _fast_delta_side, _fast_delta_side_checked
    if _fast_delta_side_checked:
        return _fast_delta_side
    _fast_delta_side_checked = True
    try:
        from pathway_tpu_torch import native

        ext = native.load_wire_ext()
        if ext is None or not hasattr(ext, "join_delta_side"):
            return None
        if _fast_delta_side_probe(ext.join_delta_side):
            _fast_delta_side = ext.join_delta_side
    except Exception:  # noqa: BLE001 — python path always works
        _fast_delta_side = None
    return _fast_delta_side


_fast_shards = None
_fast_shards_checked = False


def shard_kernels():
    """Native exchange-routing kernels as a
    (pointer_shards, ref_shards, partition_deltas) triple, or None.
    Verified once against the python routing before use: bulk u16 shard
    codes from Pointer keys, ref_scalar(v).shard for scalar values (with
    an unresolved-index escape for types the kernel does not cover), and
    the single-pass delta partitioner."""
    global _fast_shards, _fast_shards_checked
    if _fast_shards_checked:
        return _fast_shards
    _fast_shards_checked = True
    try:
        from pathway_tpu_torch import native

        ext = native.load_wire_ext()
        if ext is None or not hasattr(ext, "partition_deltas"):
            return None
        keys = [Pointer(0xBEEF), Pointer(2**100 + 7), ref_scalar("probe")]
        if ext.pointer_shards(keys) != b"".join(
            k.shard.to_bytes(2, "little") for k in keys
        ):
            return None
        vals = [None, True, -3, 2.5, 4.0, "probe", b"probe", keys[2], (1, 2)]
        shards, unresolved = ext.ref_shards(vals)
        if list(unresolved) != [8]:
            return None
        for i, v in enumerate(vals[:-1]):
            want = v.shard if isinstance(v, Pointer) else ref_scalar(v).shard
            if int.from_bytes(shards[2 * i : 2 * i + 2], "little") != want:
                return None
        deltas = [(k, (i,), 1) for i, k in enumerate(keys)]
        want_parts: list = [[], []]
        for d, k in zip(deltas, keys):
            want_parts[k.shard % 2].append(d)
        codes = b"".join(k.shard.to_bytes(2, "little") for k in keys)
        if ext.partition_deltas(deltas, codes, 2) != want_parts:
            return None
        _fast_shards = (
            ext.pointer_shards,
            ext.ref_shards,
            ext.partition_deltas,
        )
    except Exception:  # noqa: BLE001 — python routing always works
        _fast_shards = None
    return _fast_shards


def seq_key_seed(*name_parts: Any) -> int:
    """Per-source seed for seq_key (one blake2b at source setup)."""
    return hash_values(*name_parts)


def ref_scalar(*values: Any, optional: bool = False, instance: Any = None) -> Pointer:
    """Build a Pointer from values (reference: Key::for_values). With
    `instance`, the low shard bits are taken from the instance's key so rows
    sharing an instance co-locate on a shard (Key::with_shard_of)."""
    if optional and any(v is None for v in values):
        return None  # type: ignore[return-value]
    key = Pointer(hash_values(*values), origin=tuple(values))
    if instance is not None:
        key = key.with_shard_of(ref_scalar(instance))
    return key


_seq_counter = [0]


def unsafe_make_pointer(value: int) -> Pointer:
    return Pointer(value)


def sequential_pointer() -> Pointer:
    _seq_counter[0] += 1
    return Pointer(hash_values("__auto__", _seq_counter[0]))


class Json:
    """Wrapper marking a value as a JSON document (reference:
    internals/json.py:31, Value::Json). Provides typed accessors."""

    __slots__ = ("value", "_hash")

    NULL: "Json"

    def __init__(self, value: Any = None):
        if isinstance(value, Json):
            value = value.value
        self.value = value
        self._hash: int | None = None

    def __eq__(self, other):
        if isinstance(other, Json):
            return self.value == other.value
        return NotImplemented

    def __hash__(self):
        # consolidation hashes every row it groups; serializing the doc
        # each time made json.dumps the engine's hottest function
        if self._hash is None:
            self._hash = hash(
                _json.dumps(self.value, sort_keys=True, default=str)
            )
        return self._hash

    def __getstate__(self):
        # never ship the cached hash across processes: str hashes are
        # per-interpreter (PYTHONHASHSEED), so a pickled _hash from worker A
        # would break hash/eq consistency on worker B
        return self.value

    def __setstate__(self, state):
        self.value = state
        self._hash = None

    def __repr__(self):
        return _json.dumps(self.value, default=str)

    def __str__(self):
        return _json.dumps(self.value, default=str)

    def __getitem__(self, item):
        v = self.value[item]
        return Json(v)

    def __iter__(self):
        if isinstance(self.value, dict):
            return iter(self.value)
        return (Json(v) for v in self.value)

    def __len__(self):
        return len(self.value)

    def __contains__(self, item):
        return item in self.value

    def __bool__(self):
        return bool(self.value)

    def get(self, key, default=None):
        if isinstance(self.value, dict):
            v = self.value.get(key, _MISSING)
            return Json(v) if v is not _MISSING else default
        if isinstance(self.value, list) and isinstance(key, int):
            if -len(self.value) <= key < len(self.value):
                return Json(self.value[key])
        return default

    def as_int(self) -> int | None:
        if isinstance(self.value, bool):
            return None
        return self.value if isinstance(self.value, int) else None

    def as_float(self) -> float | None:
        if isinstance(self.value, (int, float)) and not isinstance(self.value, bool):
            return float(self.value)
        return None

    def as_str(self) -> str | None:
        return self.value if isinstance(self.value, str) else None

    def as_bool(self) -> bool | None:
        return self.value if isinstance(self.value, bool) else None

    def as_list(self) -> list | None:
        return self.value if isinstance(self.value, list) else None

    def as_dict(self) -> dict | None:
        return self.value if isinstance(self.value, dict) else None

    @staticmethod
    def parse(s: str | bytes) -> "Json":
        return Json(_json.loads(s))

    @staticmethod
    def dumps(obj: Any) -> str:
        if isinstance(obj, Json):
            obj = obj.value
        return _json.dumps(obj, default=str)


Json.NULL = Json(None)
_MISSING = object()


class PyObjectWrapper:
    """Opaque python object carried through the dataflow
    (reference: Value::PyObjectWrapper, engine/py_object_wrapper.rs)."""

    __slots__ = ("value", "_serializer")

    def __init__(self, value: Any, *, serializer: Any = None):
        self.value = value
        self._serializer = serializer

    def __eq__(self, other):
        return isinstance(other, PyObjectWrapper) and self.value == other.value

    def __hash__(self):
        try:
            return hash(self.value)
        except TypeError:
            return hash(id(self.value))

    def __repr__(self):
        return f"PyObjectWrapper({self.value!r})"


def wrap_py_object(value: Any, *, serializer: Any = None) -> PyObjectWrapper:
    return PyObjectWrapper(value, serializer=serializer)


def values_equal(a: Any, b: Any) -> bool:
    """Deep equality that treats numpy arrays elementwise and NaN == NaN
    (needed for retraction matching in stateful operators)."""
    if a is b:
        return True
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        try:
            return bool(np.array_equal(a, b, equal_nan=True))
        except TypeError:
            return bool(np.array_equal(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (a != a and b != b)
    return a == b
