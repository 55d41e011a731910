"""Native (C++) host-side batch tokenizer, built on demand with g++ and
loaded with ctypes (the port's own copy of pathway_tpu/native).

It keeps tokenization from starving the card. The build goes into
``pathway_tpu_torch/_build/native/`` keyed on the source hash; without a
compiler the tokenizer falls back to the pure-Python implementation.
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


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed or os.environ.get("PATHWAY_DISABLE_NATIVE"):
            return None
        source = os.path.join(_HERE, "tokenizer.cpp")
        try:
            with open(source, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
            so_path = os.path.join(_CACHE_DIR, f"pw_native_{digest}.so")
            if not os.path.exists(so_path):
                os.makedirs(_CACHE_DIR, exist_ok=True)
                tmp = so_path + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", source, "-o", tmp],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(so_path)
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
