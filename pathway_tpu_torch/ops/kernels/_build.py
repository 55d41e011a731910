"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` into an object, all
files at once in parallel, and the objects are linked into one shared
library with a plain C interface. No PyTorch header is compiled, so a
cold build takes tens of seconds. The library lands in ``pathway_tpu_torch/_build/``
under a name keyed on a hash of the sources and flags, and is built at
first use: ``python3 chip_smoke.py`` on a fresh checkout builds
everything. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "_build",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "pwt_knn_topk": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "pwt_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
}


def _sources() -> list[str]:
    return sorted(
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return found


def _digest(sources: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(nvcc: str, sources: list[str], so_path: str) -> None:
    work = f"{so_path}.tmp{os.getpid()}"
    os.makedirs(work, exist_ok=True)
    try:
        procs = []
        objects = []
        for src in sources:
            if not src.endswith(".cu"):
                continue
            obj = os.path.join(work, os.path.basename(src) + ".o")
            objects.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            procs.append(
                (src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
            )
        failures = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{os.path.basename(src)}:\n{out.decode(errors='replace')}")
        if failures:
            raise RuntimeError("nvcc failed\n" + "\n".join(failures))
        link = [nvcc, *NVCC_FLAGS, "-shared", *objects, "-o", os.path.join(work, "lib.so")]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + res.stdout.decode(errors="replace"))
        os.replace(os.path.join(work, "lib.so"), so_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        so_path = os.path.join(_BUILD_DIR, f"libpwt_kernels_{_digest(sources)}.so")
        t0 = time.perf_counter()
        if not os.path.exists(so_path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            _compile(_nvcc(), sources, so_path)
        lib = ctypes.CDLL(so_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pwt_error_string.argtypes = [ctypes.c_int]
        lib.pwt_error_string.restype = ctypes.c_char_p
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        text = load().pwt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")
