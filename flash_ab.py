#!/usr/bin/env python3
"""A/B of flash attention's CUDA sources on one card, in one process.

    python3 flash_ab.py VARIANTS.json ORDER

VARIANTS.json maps a name to ``[csrc_dir, [[old, new], ...]]``: the CUDA
sources of ``csrc_dir`` (this tree's ``pathway_tpu_torch/ops/kernels/csrc``,
or another tree's, e.g. a parent commit unpacked with ``git archive``),
with each ``old`` text of ``flash_attention.cu`` replaced by ``new``, so
that a variant which changes one constant needs no copy of the tree. The
flash sources of every variant are compiled at once (``nvcc -Xptxas -v``,
whose register and spill lines are printed per instance) into
``pathway_tpu_torch/_build/flash_ab/<name>/``, linked, and loaded side by
side. ORDER is a comma-separated list of names (repeat a name to run it
again, e.g. ``parent,change,change,parent``); each entry times the flash
wrapper of this tree on that variant's library, on the same seeded inputs,
with chip_smoke's ``median_ms`` after a two-second pause, and prints one
line of times and max |error| against the plain version. SDPA's times at
the same shapes come first. The variants must keep the C entry point
``pwt_flash_attention_fwd``'s signature.

Shapes: the encoder's [64, 12, 512, 32] (ragged keys) and ingest shape
[2048, 12, 64, 32]; the decoder prefill's [8, 32, 1024, 128] causal
(700-1024 live keys) and non-causal; [1, 16, 2048, 256] causal; a long
sequence, [1, 32, 8192, 128] non-causal (time only).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from pathway_tpu_torch.ops.kernels import _build, flash_attention  # noqa: E402
from pathway_tpu_torch.ops.kernels.flash_attention import reference_attention  # noqa: E402

SOURCES = ("flash_attention.cu", "flash_attention_f32.cu", "flash_attention_d256.cu", "errors.cu")


def build(variants: dict) -> dict:
    """name -> the loaded library of that variant's flash sources."""
    out = os.path.join(ROOT, "pathway_tpu_torch", "_build", "flash_ab")
    shutil.rmtree(out, ignore_errors=True)
    nvcc = _build._nvcc()
    procs = []
    for name, (csrc, subs) in variants.items():
        vdir = os.path.join(out, name)
        os.makedirs(vdir)
        for f in os.listdir(csrc):
            if not f.endswith((".cu", ".cuh")):
                continue
            with open(os.path.join(csrc, f)) as fh:
                text = fh.read()
            if f == "flash_attention.cu":
                for old, new in subs:
                    if old not in text:
                        raise ValueError(f"{name}: {old!r} not in flash_attention.cu")
                    text = text.replace(old, new)
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        for f in SOURCES:
            cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", os.path.join(vdir, f),
                   "-o", os.path.join(vdir, f + ".o")]
            procs.append((name, f, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT)))
    for name, f, proc in procs:
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            errors = "\n".join(line for line in text.splitlines() if "error" in line)
            raise RuntimeError(f"nvcc failed for {name} {f}:\n{errors}")
        if f == "flash_attention.cu":
            for m in re.finditer(r"flash_fwd_bf16ILi(\d+)E.*?\n\s*(\d+ bytes stack frame.*?spill "
                                 r"loads)\n.*?Used (\d+) registers", text, re.S):
                print(f"  ptxas {name} flash_fwd_bf16<{m.group(1)}>: {m.group(3)} registers, "
                      f"{m.group(2)}")
            for line in text.splitlines():
                if "Potential Performance Loss" in line:
                    print(f"  ptxas {name}: {line.strip()[:200]}")
    libs = {}
    for name in variants:
        vdir = os.path.join(out, name)
        so = os.path.join(vdir, "lib.so")
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared",
                        *(os.path.join(vdir, f + ".o") for f in SOURCES), "-o", so], check=True)
        lib = ctypes.CDLL(so)
        lib.pwt_flash_attention_fwd.argtypes = _build._SIGNATURES["pwt_flash_attention_fwd"]
        lib.pwt_flash_attention_fwd.restype = ctypes.c_int
        lib.pwt_error_string.argtypes = [ctypes.c_int]
        lib.pwt_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def shapes() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(5)

    def make(b, h, l, d, lo):
        q, k, v = (torch.randn((b, h, l, d), device="cuda", generator=gen).bfloat16()
                   for _ in range(3))
        lens = torch.randint(lo, l + 1, (b,), device="cuda", generator=gen)
        mask = (torch.arange(l, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
        return q, k, v, mask

    return {
        "d32": (make(64, 12, 512, 32, 1), False),
        "d32_ingest": (make(2048, 12, 64, 32, 64), False),
        "d128_causal": (make(8, 32, 1024, 128, 700), True),
        "d128": (make(8, 32, 1024, 128, 1024), False),
        "d256_causal": (make(1, 16, 2048, 256, 2048), True),
        "d128_long": (make(1, 32, 8192, 128, 8192), False),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device available", file=sys.stderr)
        return 1
    with open(sys.argv[1]) as fh:
        variants = json.load(fh)
    order = sys.argv[2].split(",")
    libs = build(variants)
    cases = shapes()
    refs = {key: reference_attention(q, k, v, m, q.shape[-1] ** -0.5, c).float()
            for key, ((q, k, v, m), c) in cases.items() if key not in ("d32_ingest", "d128_long")}
    print(cs.card_line())
    for key in ("d128_causal", "d128", "d128_long", "d256_causal"):
        (q, k, v, _), c = cases[key]
        sdpa = cs.median_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=c))
        print(f"  {key}: scaled_dot_product_attention {sdpa:.4f} ms", flush=True)
    results: dict = {}
    for turn, name in enumerate(order):
        _build._lib = libs[name]
        time.sleep(2.0)
        row = []
        for key, ((q, k, v, m), c) in cases.items():
            out = flash_attention(q, k, v, m, causal=c)
            torch.cuda.synchronize()
            err = (out.float() - refs[key]).abs().max().item() if key in refs else float("nan")
            ms = cs.median_ms(lambda: flash_attention(q, k, v, m, causal=c))
            results.setdefault(name, {}).setdefault(key, []).append(ms)
            row.append(f"{key} {ms:.4f} ms (err {err:.3g})")
        print(f"[{turn}] {name}: " + "; ".join(row), flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
