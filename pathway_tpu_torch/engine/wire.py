"""Typed binary wire codec for the exchange protocol.

Replaces the length-prefixed-pickle transport (the r3 design) with a
typed column encoding over the engine's closed value model — the analogue
of the reference's bincode transport over its `Value` enum (reference:
src/engine/dataflow/config.rs:74-83, value.rs Value). A pickle escape
remains ONLY for `PyObjectWrapper`-style opaque objects, exactly as the
reference serializes `Value::PyObjectWrapper` through Python pickling.

Frame layout (inside the existing 4-byte length prefix):

    message := msg_type(1B) body
      0x01 hello : u32 worker, str run_id
      0x02 data  : u32 channel, zz64 time, deltas
      0x03 punct : u32 channel, zz64 time
      0x04 coord : u64 round, value payload
      0x05 stamp : u32 channel, zz64 time, u32 origin, f64 send_wall
      0x06 qspan : u32 origin, uvarint len, JSON query-span payload
    deltas  := uvarint n, n x (key(16B LE) zz diff, uvarint ncols, values)
    value   := tag(1B) payload   (tags below)

All varints are LEB128; zz = zigzag varint. Malformed input raises
``WireError`` — the exchange surfaces it as a clean ``EngineError`` rather
than undefined behavior (pickle would execute arbitrary reduce payloads).

The native C++ twin (`native/wire_ext.cpp`) implements the identical
format for the hot tags; this module is the spec and the fallback, and
`encode_message`/`decode_message` below transparently prefer the native
codec when it built.
"""

from __future__ import annotations

import datetime as _dt
import struct
from typing import Any, List, Tuple

from pathway_tpu_torch.engine.value import ERROR, Error, Json, Pending, Pointer

class WireError(ValueError):
    pass


# value tags
T_NONE = 0
T_TRUE = 1
T_FALSE = 2
T_INT = 3  # zigzag varint (fits signed 64)
T_BIGINT = 4  # uvarint len + signed little-endian bytes
T_FLOAT = 5  # 8B double LE
T_STR = 6
T_BYTES = 7
T_POINTER = 8  # 16B LE u128
T_TUPLE = 9
T_LIST = 10
T_DICT = 11
T_JSON = 12
T_NDARRAY = 13  # dtype str, shape, raw buffer
T_ERROR = 14
T_PENDING = 15
T_DATETIME_NAIVE = 16  # zz days since year 1, uvarint microsecond-of-day
T_DATETIME_UTC = 17
T_TIMEDELTA = 18  # zz days, zz seconds, zz microseconds
T_DATE = 19  # zz ordinal
T_NPSCALAR = 20  # dtype str + raw bytes
T_PICKLE = 21  # opaque escape (PyObjectWrapper / exotic tzinfo)

MSG_HELLO = 0x01
MSG_DATA = 0x02
MSG_PUNCT = 0x03
MSG_COORD = 0x04
# tracing stamp: u32 channel, zz64 time, u32 origin worker, f64 send
# wall-time.  Deliberately a SEPARATE message so data frames stay
# byte-identical whether tracing samples an epoch or not (the exchange
# parity tests hash data frames; wall-times would break determinism).
# Python-codec only: the native twin predates it and must keep rejecting
# unknown types, so encode/decode route 0x05 around the ext explicitly.
MSG_STAMP = 0x05
# query-span shipment: u32 origin worker + uvarint-length JSON blob of
# per-query marks (internals/qtrace.py).  Like MSG_STAMP it is a
# diagnostics-only side channel: Python-codec only, never counted toward
# punctuation, rides the per-peer FIFO so spans for an epoch arrive
# before the punctuation that completes it.
MSG_QSPAN = 0x06
# lineage-edge shipment (internals/provenance.py): u32 origin worker +
# uvarint-length JSON blob of recorded backward-lineage edges, gathered
# on worker 0 so `explain` sees the whole mesh.  Same contract as
# MSG_QSPAN: Python-codec only, diagnostics-only, never counted toward
# punctuation.
MSG_LINEAGE = 0x07

_pack_d = struct.Struct("<d")
_pack_u32 = struct.Struct("<I")
_pack_u64 = struct.Struct("<Q")

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def _uvarint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zigzag(out: bytearray, n: int) -> None:
    if not _I64_MIN <= n <= _I64_MAX:
        raise WireError(f"zigzag value out of i64 range: {n}")
    _uvarint(out, (n << 1) ^ (n >> 63))


# A frame of repeated 2-byte nested container headers could otherwise
# drive unbounded decode recursion (Python RecursionError / C stack
# overflow in the native twin). No legitimate engine value nests anywhere
# near this deep.
MAX_DECODE_DEPTH = 128


class _Reader:
    __slots__ = ("buf", "pos", "end", "depth")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos
        self.end = len(buf)
        self.depth = 0

    def enter(self) -> None:
        self.depth += 1
        if self.depth > MAX_DECODE_DEPTH:
            raise WireError("frame nesting too deep")

    def take(self, n: int) -> bytes:
        p = self.pos
        q = p + n
        if q > self.end:
            raise WireError("truncated frame")
        self.pos = q
        return self.buf[p:q]

    def byte(self) -> int:
        p = self.pos
        if p >= self.end:
            raise WireError("truncated frame")
        self.pos = p + 1
        return self.buf[p]

    def uvarint(self) -> int:
        # strict u64: a tenth byte may only contribute bit 63, and an
        # eleventh byte is malformed — byte-for-byte the native decoder's
        # acceptance set, so fuzzed frames can't split the two decoders
        shift = 0
        acc = 0
        while True:
            b = self.byte()
            if shift == 63 and b & 0x7E:
                raise WireError("varint overflow")
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                return acc
            shift += 7
            if shift > 63:
                raise WireError("varint overflow")

    def zigzag(self) -> int:
        z = self.uvarint()
        return (z >> 1) ^ -(z & 1)


def _check_encode_depth(depth: int) -> None:
    # surface over-deep values at the PRODUCER with a clear error —
    # otherwise they would encode fine and kill the run at the receiving
    # peer as a spurious "malformed frame". Counted on container ENTRY
    # (like the decoder and the native encoder), so an empty container at
    # the limit is rejected identically everywhere.
    if depth >= MAX_DECODE_DEPTH:
        raise WireError(
            f"value nests deeper than {MAX_DECODE_DEPTH} containers; "
            "flatten it before sending"
        )


def encode_value(out: bytearray, v: Any, _depth: int = 0) -> None:
    t = type(v)
    if v is None:
        out.append(T_NONE)
    elif t is bool:
        out.append(T_TRUE if v else T_FALSE)
    elif t is int:
        if _I64_MIN <= v <= _I64_MAX:
            out.append(T_INT)
            _zigzag(out, v)
        else:
            out.append(T_BIGINT)
            raw = v.to_bytes((v.bit_length() + 8) // 8, "little", signed=True)
            _uvarint(out, len(raw))
            out += raw
    elif t is float:
        out.append(T_FLOAT)
        out += _pack_d.pack(v)
    elif t is str:
        out.append(T_STR)
        raw = v.encode("utf-8")
        _uvarint(out, len(raw))
        out += raw
    elif t is bytes:
        out.append(T_BYTES)
        _uvarint(out, len(v))
        out += v
    elif t is Pointer:
        out.append(T_POINTER)
        out += v.value.to_bytes(16, "little")
    elif t is tuple:
        _check_encode_depth(_depth)
        out.append(T_TUPLE)
        _uvarint(out, len(v))
        for x in v:
            encode_value(out, x, _depth + 1)
    elif t is list:
        _check_encode_depth(_depth)
        out.append(T_LIST)
        _uvarint(out, len(v))
        for x in v:
            encode_value(out, x, _depth + 1)
    elif t is dict:
        _check_encode_depth(_depth)
        out.append(T_DICT)
        _uvarint(out, len(v))
        for k, x in v.items():
            encode_value(out, k, _depth + 1)
            encode_value(out, x, _depth + 1)
    elif t is Json:
        _check_encode_depth(_depth)
        out.append(T_JSON)
        encode_value(out, v.value, _depth + 1)
    elif isinstance(v, Error):
        # trace payload survives the wire (0-length = the plain singleton)
        out.append(T_ERROR)
        trace = getattr(v, "trace", None)
        raw = trace.encode("utf-8") if isinstance(trace, str) else b""
        _uvarint(out, len(raw))
        out += raw
    elif v is Pending:
        out.append(T_PENDING)
    elif t is _dt.datetime:
        if v.tzinfo is None:
            out.append(T_DATETIME_NAIVE)
        elif v.tzinfo is _dt.timezone.utc:
            out.append(T_DATETIME_UTC)
        else:
            _encode_pickle(out, v)
            return
        _zigzag(out, v.toordinal())
        _uvarint(
            out,
            (v.hour * 3600 + v.minute * 60 + v.second) * 1_000_000
            + v.microsecond,
        )
    elif t is _dt.timedelta:
        out.append(T_TIMEDELTA)
        _zigzag(out, v.days)
        _zigzag(out, v.seconds)
        _zigzag(out, v.microseconds)
    elif t is _dt.date:
        out.append(T_DATE)
        _zigzag(out, v.toordinal())
    else:
        import numpy as np

        if isinstance(v, np.ndarray):
            if v.dtype.hasobject:
                # object arrays have no buffer form; tobytes() would emit
                # raw pointers — ship them through the opaque escape
                _encode_pickle(out, v)
                return
            out.append(T_NDARRAY)
            dts = v.dtype.str.encode("ascii")
            _uvarint(out, len(dts))
            out += dts
            _uvarint(out, v.ndim)
            for s in v.shape:
                _uvarint(out, s)
            raw = np.ascontiguousarray(v).tobytes()
            _uvarint(out, len(raw))
            out += raw
        elif isinstance(v, np.generic):
            out.append(T_NPSCALAR)
            dts = v.dtype.str.encode("ascii")
            _uvarint(out, len(dts))
            out += dts
            raw = v.tobytes()
            _uvarint(out, len(raw))
            out += raw
        elif isinstance(v, bool):
            out.append(T_TRUE if v else T_FALSE)
        elif isinstance(v, int):
            encode_value(out, int(v))
        elif isinstance(v, float):
            out.append(T_FLOAT)
            out += _pack_d.pack(float(v))
        elif isinstance(v, str):
            encode_value(out, str(v))
        else:
            # closed-model escape: PyObjectWrapper and anything unknown
            _encode_pickle(out, v)


def _encode_pickle(out: bytearray, v: Any) -> None:
    import pickle

    raw = pickle.dumps(v, protocol=pickle.HIGHEST_PROTOCOL)
    out.append(T_PICKLE)
    _uvarint(out, len(raw))
    out += raw


def decode_value(r: _Reader, _tag: int | None = None) -> Any:
    tag = r.byte() if _tag is None else _tag
    if tag == T_NONE:
        return None
    if tag == T_TRUE:
        return True
    if tag == T_FALSE:
        return False
    if tag == T_INT:
        return r.zigzag()
    if tag == T_BIGINT:
        return int.from_bytes(r.take(r.uvarint()), "little", signed=True)
    if tag == T_FLOAT:
        return _pack_d.unpack(r.take(8))[0]
    if tag == T_STR:
        try:
            return r.take(r.uvarint()).decode("utf-8")
        except UnicodeDecodeError as exc:
            raise WireError(f"bad utf-8 string: {exc}") from None
    if tag == T_BYTES:
        return r.take(r.uvarint())
    if tag == T_POINTER:
        return Pointer(int.from_bytes(r.take(16), "little"))
    if tag == T_TUPLE:
        r.enter()
        try:
            return tuple(decode_value(r) for _ in range(r.uvarint()))
        finally:
            r.depth -= 1
    if tag == T_LIST:
        r.enter()
        try:
            return [decode_value(r) for _ in range(r.uvarint())]
        finally:
            r.depth -= 1
    if tag == T_DICT:
        r.enter()
        try:
            return {
                decode_value(r): decode_value(r) for _ in range(r.uvarint())
            }
        except TypeError as exc:  # unhashable decoded key
            raise WireError(f"bad dict key in frame: {exc}") from None
        finally:
            r.depth -= 1
    if tag == T_JSON:
        r.enter()
        try:
            return Json(decode_value(r))
        finally:
            r.depth -= 1
    if tag == T_NDARRAY:
        import numpy as np

        try:
            dts = r.take(r.uvarint()).decode("ascii")
        except UnicodeDecodeError as exc:
            raise WireError(f"bad ndarray dtype: {exc}") from None
        shape = tuple(r.uvarint() for _ in range(r.uvarint()))
        raw = r.take(r.uvarint())
        try:
            return np.frombuffer(raw, dtype=np.dtype(dts)).reshape(shape).copy()
        except (TypeError, ValueError) as exc:
            raise WireError(f"bad ndarray: {exc}") from None
    if tag == T_ERROR:
        n = r.uvarint()
        if n == 0:
            return ERROR
        try:
            return Error(r.take(n).decode("utf-8"))
        except UnicodeDecodeError as exc:
            raise WireError(f"bad error trace: {exc}") from None
    if tag == T_PENDING:
        return Pending
    if tag in (T_DATETIME_NAIVE, T_DATETIME_UTC):
        ordinal = r.zigzag()
        micro = r.uvarint()
        try:
            d = _dt.datetime.fromordinal(ordinal)
        except (ValueError, OverflowError) as exc:
            raise WireError(f"bad datetime: {exc}") from None
        d = d + _dt.timedelta(microseconds=micro)
        if tag == T_DATETIME_UTC:
            d = d.replace(tzinfo=_dt.timezone.utc)
        return d
    if tag == T_TIMEDELTA:
        return _dt.timedelta(
            days=r.zigzag(), seconds=r.zigzag(), microseconds=r.zigzag()
        )
    if tag == T_DATE:
        try:
            return _dt.date.fromordinal(r.zigzag())
        except (ValueError, OverflowError) as exc:
            raise WireError(f"bad date: {exc}") from None
    if tag == T_NPSCALAR:
        import numpy as np

        try:
            dts = r.take(r.uvarint()).decode("ascii")
        except UnicodeDecodeError as exc:
            raise WireError(f"bad numpy scalar dtype: {exc}") from None
        raw = r.take(r.uvarint())
        try:
            return np.frombuffer(raw, dtype=np.dtype(dts))[0]
        except (TypeError, ValueError, IndexError) as exc:
            raise WireError(f"bad numpy scalar: {exc}") from None
    if tag == T_PICKLE:
        raw = r.take(r.uvarint())
        try:
            return _restricted_loads(raw)
        except WireError:
            raise
        except Exception as exc:  # noqa: BLE001
            raise WireError(f"bad opaque value: {exc}") from None
    raise WireError(f"unknown value tag {tag}")


# The pickle escape must not hand the network arbitrary code execution —
# the codec's whole point. Decoding is allowlist-restricted to the closed
# value model's constructors (engine values, numpy reconstruction,
# datetime/zoneinfo). PyObjectWrapper payloads holding classes outside
# the allowlist need PATHWAY_WIRE_UNSAFE_PICKLE=1 — an explicit operator
# opt-in for trusted meshes (the reference ships Value::PyObjectWrapper
# through pickle with the same trust assumption).
_PICKLE_ALLOWLIST = {
    ("pathway_tpu_torch.engine.value", "*"),  # the closed value model itself
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("datetime", "datetime"),
    ("datetime", "date"),
    ("datetime", "time"),
    ("datetime", "timedelta"),
    ("datetime", "timezone"),
    ("zoneinfo", "ZoneInfo"),
    ("builtins", "complex"),
    ("builtins", "frozenset"),
    ("builtins", "set"),
    ("builtins", "bytearray"),
    ("collections", "OrderedDict"),
}


def _safe_getattr(obj, name, *default):
    # Some stdlib reduce paths go through builtins.getattr. A permissive
    # shim would let a crafted payload walk to dangerous callables on
    # otherwise-allowlisted objects (e.g. ndarray.tofile → arbitrary file
    # write), so only the single known-legitimate pair is allowed: the
    # ZoneInfo pickle hook. Everything else is a wire error.
    import zoneinfo

    if obj is zoneinfo.ZoneInfo and name == "_unpickle":
        return zoneinfo.ZoneInfo._unpickle
    raise WireError(
        f"opaque value getattr({type(obj).__name__}, {name!r}) denied"
    )


def _restricted_loads(raw: bytes) -> Any:
    import io as _io
    import os
    import pickle

    if os.environ.get("PATHWAY_WIRE_UNSAFE_PICKLE") == "1":
        return pickle.loads(raw)

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if (module, name) == ("builtins", "getattr"):
                return _safe_getattr
            if (module, name) in _PICKLE_ALLOWLIST or (
                module,
                "*",
            ) in _PICKLE_ALLOWLIST:
                return super().find_class(module, name)
            raise WireError(
                f"opaque value references {module}.{name}, outside the "
                "wire allowlist; set PATHWAY_WIRE_UNSAFE_PICKLE=1 to ship "
                "arbitrary objects across a trusted worker mesh"
            )

    return _Unpickler(_io.BytesIO(raw)).load()


def encode_deltas(out: bytearray, deltas: List[Tuple]) -> None:
    _uvarint(out, len(deltas))
    for key, values, diff in deltas:
        out += key.value.to_bytes(16, "little")
        _zigzag(out, diff)
        _uvarint(out, len(values))
        for v in values:
            encode_value(out, v)


def decode_deltas(r: _Reader) -> List[Tuple]:
    n = r.uvarint()
    out = []
    append = out.append
    for _ in range(n):
        key = Pointer(int.from_bytes(r.take(16), "little"))
        diff = r.zigzag()
        ncols = r.uvarint()
        append((key, tuple(decode_value(r) for _ in range(ncols)), diff))
    return out


# -- messages ---------------------------------------------------------------


def py_encode_message(msg: tuple) -> bytes:
    kind = msg[0]
    out = bytearray()
    if kind == "hello":
        out.append(MSG_HELLO)
        out += _pack_u32.pack(msg[1])
        raw = str(msg[2]).encode("utf-8")
        _uvarint(out, len(raw))
        out += raw
    elif kind == "data":
        out.append(MSG_DATA)
        out += _pack_u32.pack(msg[1])
        _zigzag(out, msg[2])
        encode_deltas(out, msg[3])
    elif kind == "punct":
        out.append(MSG_PUNCT)
        out += _pack_u32.pack(msg[1])
        _zigzag(out, msg[2])
    elif kind == "coord":
        out.append(MSG_COORD)
        out += _pack_u64.pack(msg[1])
        encode_value(out, msg[2])
    elif kind == "stamp":
        out.append(MSG_STAMP)
        out += _pack_u32.pack(msg[1])
        _zigzag(out, msg[2])
        out += _pack_u32.pack(msg[3])
        out += _pack_d.pack(msg[4])
    elif kind == "qspan":
        import json as _json

        out.append(MSG_QSPAN)
        out += _pack_u32.pack(msg[1])
        raw = _json.dumps(msg[2], separators=(",", ":")).encode("utf-8")
        _uvarint(out, len(raw))
        out += raw
    elif kind == "lineage":
        import json as _json

        out.append(MSG_LINEAGE)
        out += _pack_u32.pack(msg[1])
        raw = _json.dumps(msg[2], separators=(",", ":")).encode("utf-8")
        _uvarint(out, len(raw))
        out += raw
    else:
        raise WireError(f"unknown message kind {kind!r}")
    return bytes(out)


def py_decode_message(blob: bytes) -> tuple:
    try:
        return _py_decode_message(blob)
    except RecursionError:
        # belt-and-braces next to the depth cap: interpreter recursion
        # limits must surface as a protocol error, not escape the
        # exchange's WireError handler
        raise WireError("frame nesting exhausted the decoder") from None


def _py_decode_message(blob: bytes) -> tuple:
    r = _Reader(blob)
    kind = r.byte()
    if kind == MSG_HELLO:
        worker = _pack_u32.unpack(r.take(4))[0]
        try:
            run_id = r.take(r.uvarint()).decode("utf-8")
        except UnicodeDecodeError as exc:
            raise WireError(f"bad run id: {exc}") from None
        msg = ("hello", worker, run_id)
    elif kind == MSG_DATA:
        channel = _pack_u32.unpack(r.take(4))[0]
        time = r.zigzag()
        msg = ("data", channel, time, decode_deltas(r))
    elif kind == MSG_PUNCT:
        channel = _pack_u32.unpack(r.take(4))[0]
        msg = ("punct", channel, r.zigzag())
    elif kind == MSG_COORD:
        round_no = _pack_u64.unpack(r.take(8))[0]
        msg = ("coord", round_no, decode_value(r))
    elif kind == MSG_STAMP:
        channel = _pack_u32.unpack(r.take(4))[0]
        time = r.zigzag()
        origin = _pack_u32.unpack(r.take(4))[0]
        wall = _pack_d.unpack(r.take(8))[0]
        msg = ("stamp", channel, time, origin, wall)
    elif kind == MSG_QSPAN:
        import json as _json

        origin = _pack_u32.unpack(r.take(4))[0]
        try:
            payload = _json.loads(r.take(r.uvarint()).decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as exc:
            raise WireError(f"bad qspan payload: {exc}") from None
        msg = ("qspan", origin, payload)
    elif kind == MSG_LINEAGE:
        import json as _json

        origin = _pack_u32.unpack(r.take(4))[0]
        try:
            payload = _json.loads(r.take(r.uvarint()).decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as exc:
            raise WireError(f"bad lineage payload: {exc}") from None
        msg = ("lineage", origin, payload)
    else:
        raise WireError(f"unknown message type {kind}")
    if r.pos != r.end:
        raise WireError(f"{r.end - r.pos} trailing bytes in frame")
    return msg


# -- native preference ------------------------------------------------------

_native = None


def _load_native():
    global _native
    if _native is None:
        from pathway_tpu_torch import native

        _native = native.load_wire_ext() or False
    return _native or None


def encode_message(msg: tuple) -> bytes:
    if msg[0] in ("stamp", "qspan", "lineage"):
        # newer than the native twin: pure-Python codec only
        return py_encode_message(msg)
    ext = _load_native()
    if ext is not None:
        return ext.encode_message(msg)
    return py_encode_message(msg)


def decode_message(blob: bytes) -> tuple:
    if blob and blob[0] in (MSG_STAMP, MSG_QSPAN, MSG_LINEAGE):
        return py_decode_message(blob)
    ext = _load_native()
    if ext is not None:
        try:
            return ext.decode_message(blob)
        except ValueError as exc:
            raise WireError(str(exc)) from None
        except RecursionError:
            raise WireError("frame nesting exhausted the decoder") from None
    return py_decode_message(blob)


_frame_len = struct.Struct("!I")


def encode_frame(msg: tuple) -> bytes:
    """The full length-prefixed wire frame for `msg` in one buffer — the
    native path reserves the 4-byte length slot up front and patches it
    after the body lands, avoiding the `pack(n) + blob` concat copy."""
    ext = None if msg[0] in ("stamp", "qspan", "lineage") else _load_native()
    if ext is not None and hasattr(ext, "encode_frame"):
        return ext.encode_frame(msg)
    blob = encode_message(msg)
    return _frame_len.pack(len(blob)) + blob
