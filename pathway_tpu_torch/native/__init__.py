"""Native (C++) host-side components, built on demand with g++ (the
port's own copy of pathway_tpu/native).

  * the batch tokenizer (tokenizer.cpp, loaded with ctypes) keeps
    tokenization from starving the card;
  * the wire codec extension (wire_ext.cpp, a CPython extension module)
    gives the engine its native fast paths: bulk Pointer construction,
    consolidation, the exchange's codec.

Builds go into ``pathway_tpu_torch/_build/native/`` keyed on the source
hash; without a compiler each falls back to its pure-Python version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_CACHE_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _compile(source_name: str, stem: str, flags: list) -> str:
    """Build native/<source_name> into the cache, keyed on the source hash
    (a temporary file renamed into place, so concurrent builders never see
    a partial library); returns the library's path."""
    source = os.path.join(_HERE, source_name)
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_CACHE_DIR, f"{stem}_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(_CACHE_DIR, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}.{threading.get_ident()}"
        subprocess.run(
            ["g++", *flags, "-shared", "-fPIC", "-std=c++17", source, "-o", tmp],
            check=True,
            capture_output=True,
            timeout=180,
        )
        os.replace(tmp, so_path)
    return so_path


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed or os.environ.get("PATHWAY_DISABLE_NATIVE"):
            return None
        try:
            lib = ctypes.CDLL(_compile("tokenizer.cpp", "pw_native", ["-O3"]))
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
        lib.tokenize_batch.restype = ctypes.c_int32
        lib.tokenize_batch.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return lib


def tokenize_batch_native(texts, vocab_size: int, seq_len: int):
    """Returns (ids, mask) int32 [n, seq_len] numpy arrays, or None when
    the native library is unavailable."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    encoded = [t.encode("utf-8", errors="replace") for t in texts]
    buffer = b"".join(encoded)
    offsets = np.zeros(len(texts) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    n = len(texts)
    ids = np.zeros((n, seq_len), dtype=np.int32)
    mask = np.zeros((n, seq_len), dtype=np.int32)
    lib.tokenize_batch(
        buffer,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        vocab_size,
        seq_len,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return ids, mask


# -- CPython extension modules ----------------------------------------------

_wire_ext = None
_wire_ext_failed = False


def load_wire_ext():
    """Build (if needed) and import the native wire codec extension
    (native/wire_ext.cpp); None when the toolchain is unavailable. The
    extension is registered with the engine's value classes so it can
    construct Pointers/Json and delegate rare types back to the python
    codec."""
    global _wire_ext, _wire_ext_failed
    if _wire_ext is not None:
        return _wire_ext
    if _wire_ext_failed or os.environ.get("PATHWAY_DISABLE_NATIVE"):
        return None
    try:
        import importlib.machinery
        import importlib.util
        import sysconfig

        so_path = _compile(
            "wire_ext.cpp", "pw_wire_ext", ["-O2", f"-I{sysconfig.get_path('include')}"]
        )
        loader = importlib.machinery.ExtensionFileLoader(
            "pw_wire_ext", so_path
        )
        spec = importlib.util.spec_from_loader("pw_wire_ext", loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)

        from pathway_tpu_torch.engine import value as _value
        from pathway_tpu_torch.engine import wire as _wire

        def encode_rare(v) -> bytes:
            out = bytearray()
            _wire.encode_value(out, v)
            return bytes(out)

        def decode_rare(tag: int, frame: bytes, offset: int):
            # zero-copy: read straight out of the whole frame at offset
            r = _wire._Reader(frame, offset)
            v = _wire.decode_value(r, _tag=tag)
            return v, r.pos - offset

        mod.register_types(
            _value.Pointer,
            _value.Json,
            _value.ERROR,
            _value.Error,
            _value.Pending,
            encode_rare,
            decode_rare,
            _wire.WireError,
        )
        _wire_ext = mod
        return mod
    except Exception:  # noqa: BLE001 — fall back to the python codec
        _wire_ext_failed = True
        return None
