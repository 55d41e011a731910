"""Minimal pure-python Avro Object Container File codec.

Supports the subset of Avro needed for spec-compliant Iceberg manifest /
manifest-list files (reference: src/connectors/data_lake/iceberg.rs writes
these through the iceberg-rust crate): null/boolean/int/long/float/double/
string/bytes primitives, records, unions, arrays and maps, with the
``null`` codec. Schema-driven generic encode/decode — field properties
such as Iceberg's ``field-id`` ride along untouched in the embedded
schema JSON.

Avro spec: https://avro.apache.org/docs/current/specification/ (binary
encoding + object container files). No third-party avro library ships in
this image, hence the self-contained implementation.
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Any, Dict, List, Tuple

_MAGIC = b"Obj\x01"


# -- binary primitives -----------------------------------------------------


def _zigzag_encode(n: int) -> bytes:
    z = (n << 1) ^ (n >> 63)  # arithmetic shift: -1 mask for negatives
    out = bytearray()
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag_decode(buf: io.BytesIO) -> int:
    shift = 0
    acc = 0
    while True:
        (b,) = buf.read(1)
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


def _write_bytes(out: bytearray, data: bytes) -> None:
    out += _zigzag_encode(len(data))
    out += data


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _zigzag_decode(buf)
    return buf.read(n)


# -- schema-driven generic encode/decode -----------------------------------


class _Types:
    """Resolves named-type references within one schema."""

    def __init__(self):
        self.named: Dict[str, Any] = {}

    def register(self, schema: Any) -> None:
        if isinstance(schema, dict) and schema.get("type") == "record":
            self.named[schema["name"]] = schema


def _encode(out: bytearray, schema: Any, value: Any, types: _Types) -> None:
    if isinstance(schema, str) and schema in types.named:
        schema = types.named[schema]
    if isinstance(schema, list):  # union
        for idx, branch in enumerate(schema):
            bname = branch if isinstance(branch, str) else branch.get("type")
            if value is None and bname == "null":
                out += _zigzag_encode(idx)
                return
            if value is not None and bname != "null":
                out += _zigzag_encode(idx)
                _encode(out, branch, value, types)
                return
        raise ValueError(f"value {value!r} fits no union branch {schema!r}")
    stype = schema if isinstance(schema, str) else schema["type"]
    if stype == "null":
        return
    if stype == "boolean":
        out.append(1 if value else 0)
    elif stype in ("int", "long"):
        out += _zigzag_encode(int(value))
    elif stype == "float":
        out += struct.pack("<f", float(value))
    elif stype == "double":
        out += struct.pack("<d", float(value))
    elif stype == "string":
        _write_bytes(out, str(value).encode("utf-8"))
    elif stype == "bytes":
        _write_bytes(out, bytes(value))
    elif stype == "record":
        types.register(schema)
        for field in schema["fields"]:
            fval = value.get(field["name"]) if isinstance(value, dict) else None
            if fval is None and "default" in field:
                fval = field["default"]
            _encode(out, field["type"], fval, types)
    elif stype == "array":
        items = list(value or [])
        if items:
            out += _zigzag_encode(len(items))
            for item in items:
                _encode(out, schema["items"], item, types)
        out += _zigzag_encode(0)
    elif stype == "map":
        entries = dict(value or {})
        if entries:
            out += _zigzag_encode(len(entries))
            for k, v in entries.items():
                _write_bytes(out, str(k).encode("utf-8"))
                _encode(out, schema["values"], v, types)
        out += _zigzag_encode(0)
    else:
        raise ValueError(f"unsupported Avro type {stype!r}")


def _decode(buf: io.BytesIO, schema: Any, types: _Types) -> Any:
    if isinstance(schema, str) and schema in types.named:
        schema = types.named[schema]
    if isinstance(schema, list):  # union
        idx = _zigzag_decode(buf)
        return _decode(buf, schema[idx], types)
    stype = schema if isinstance(schema, str) else schema["type"]
    if stype == "null":
        return None
    if stype == "boolean":
        return buf.read(1) != b"\x00"
    if stype in ("int", "long"):
        return _zigzag_decode(buf)
    if stype == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if stype == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if stype == "string":
        return _read_bytes(buf).decode("utf-8")
    if stype == "bytes":
        return _read_bytes(buf)
    if stype == "record":
        types.register(schema)
        return {
            field["name"]: _decode(buf, field["type"], types)
            for field in schema["fields"]
        }
    if stype == "array":
        items = []
        while True:
            n = _zigzag_decode(buf)
            if n == 0:
                break
            if n < 0:  # block with byte size prefix
                _zigzag_decode(buf)
                n = -n
            for _ in range(n):
                items.append(_decode(buf, schema["items"], types))
        return items
    if stype == "map":
        entries = {}
        while True:
            n = _zigzag_decode(buf)
            if n == 0:
                break
            if n < 0:
                _zigzag_decode(buf)
                n = -n
            for _ in range(n):
                k = _read_bytes(buf).decode("utf-8")
                entries[k] = _decode(buf, schema["values"], types)
        return entries
    raise ValueError(f"unsupported Avro type {stype!r}")


# -- object container files ------------------------------------------------


def write_ocf(
    path: str,
    schema: dict,
    records: List[dict],
    *,
    metadata: Dict[str, str] | None = None,
) -> None:
    """Write an Avro Object Container File with the null codec."""
    sync = os.urandom(16)
    out = bytearray()
    out += _MAGIC
    meta = {
        "avro.schema": json.dumps(schema),
        "avro.codec": "null",
        **(metadata or {}),
    }
    out += _zigzag_encode(len(meta))
    for k, v in meta.items():
        _write_bytes(out, k.encode("utf-8"))
        _write_bytes(out, v.encode("utf-8"))
    out += _zigzag_encode(0)
    out += sync
    if records:
        types = _Types()
        block = bytearray()
        for rec in records:
            _encode(block, schema, rec, types)
        out += _zigzag_encode(len(records))
        out += _zigzag_encode(len(block))
        out += block
        out += sync
    if hasattr(path, "write"):  # file-like sink (object-store lakes)
        path.write(bytes(out))
        return
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(bytes(out))
    os.rename(tmp, path)


def read_ocf(path) -> Tuple[dict, List[dict]]:
    """Read an Avro Object Container File (by path, bytes, or file-like);
    returns (schema, records)."""
    if isinstance(path, (bytes, bytearray)):
        buf = io.BytesIO(bytes(path))
        path = "<bytes>"
    elif hasattr(path, "read"):
        buf = io.BytesIO(path.read())
        path = "<stream>"
    else:
        with open(path, "rb") as fh:
            buf = io.BytesIO(fh.read())
    if buf.read(4) != _MAGIC:
        raise ValueError(f"{path}: not an Avro object container file")
    meta: Dict[str, bytes] = {}
    while True:
        n = _zigzag_decode(buf)
        if n == 0:
            break
        if n < 0:
            _zigzag_decode(buf)
            n = -n
        for _ in range(n):
            k = _read_bytes(buf).decode("utf-8")
            meta[k] = _read_bytes(buf)
    codec = meta.get("avro.codec", b"null").decode()
    if codec != "null":
        raise ValueError(f"{path}: unsupported Avro codec {codec!r}")
    schema = json.loads(meta["avro.schema"])
    sync = buf.read(16)
    types = _Types()
    records: List[dict] = []
    while True:
        head = buf.read(1)
        if not head:
            break
        buf.seek(-1, io.SEEK_CUR)
        count = _zigzag_decode(buf)
        size = _zigzag_decode(buf)
        block = io.BytesIO(buf.read(size))
        for _ in range(count):
            records.append(_decode(block, schema, types))
        if buf.read(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch")
    return schema, records
