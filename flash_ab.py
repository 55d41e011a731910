#!/usr/bin/env python3
"""A/B of flash attention's CUDA sources on one card, in one process.

    python3 flash_ab.py VARIANTS.json ORDER [SHAPES]
    python3 flash_ab.py probes [SHAPES]

VARIANTS.json maps a name to ``[csrc_dir, [[old, new], ...]]``: the CUDA
sources of ``csrc_dir`` (this tree's ``pathway_tpu_torch/ops/kernels/csrc``,
or another tree's, e.g. a parent commit unpacked with ``git archive``),
with each ``old`` text replaced by ``new`` in every flash source that
holds it (``flash_attention.cu``, ``flash_attention_f32.cu``; at least one
must), so that a variant which changes one constant needs no copy of the
tree. The
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

``probes`` times this tree's sources beside ablations of the f32 kernel
(`F32_PROBES`): each leaves one part of its work out (the results are then
wrong, and printed as such), so the time it saves bounds that part's share
of the critical path; the f32 shapes by default.

Shapes (SHAPES, a comma-separated list of their keys, picks some; all by
default): bf16 at the encoder's [64, 12, 512, 32] (ragged keys) and ingest
shape [2048, 12, 64, 32]; the decoder prefill's [8, 32, 1024, 128] causal
(700-1024 live keys) and non-causal; [1, 16, 2048, 256] causal; a long
sequence, [1, 32, 8192, 128] non-causal (time only); and the f32
instances (`flash_fwd_tf32x3<D>`) at [64, 12, 512, 32] ragged and [1, 16,
2048, 256] causal, chip_smoke's `time_flash_f32` shapes, and at the decoder
prefill's [8, 32, 1024, 128] causal.
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

SOURCES = ("flash_attention.cu", "flash_attention_f32.cu", "errors.cu")
FLASH = SOURCES[:2]
CSRC = os.path.join(ROOT, "pathway_tpu_torch", "ops", "kernels", "csrc")

# ablations of flash_attention_f32.cu, [[old, new], ...] each (a probe whose
# text is not in the source raises)
_S_DOUBLE = ("        wgmma_tf32(sd, hi, dh, ks == 0 ? 0 : 1);\n"
             "        wgmma_tf32(sc, lo, dh, ks == 0 ? 0 : 1);\n")
_S_SINGLE = ("        wgmma_tf32(sc, hi, dh, ks == 0 ? 0 : 1);\n"
             "        wgmma_tf32(sc, lo, dh, 1);\n"
             "        wgmma_tf32(sc, hi, dl, 1);\n")
_PV_LO = ("            wgmma_tf32(acc, pl[kk], dh, 1);\n"
          "            wgmma_tf32(acc, ph[kk], dl, 1);\n")
F32_PROBES = {
    # S's products left out
    "no_s": [[_S_DOUBLE, ""], [_S_SINGLE, ""]],
    # P v's products left out
    "no_pv": [["            wgmma_tf32(acc, ph[kk], dh, 1);\n" + _PV_LO, ""]],
    # P v's lo passes and S's q_lo k_hi pass (and, below BN = 32, q_hi k_lo)
    "no_lo_passes": [[_PV_LO, ""],
                     ["        wgmma_tf32(sc, lo, dh, ks == 0 ? 0 : 1);\n", ""],
                     ["        wgmma_tf32(sc, lo, dh, 1);\n        wgmma_tf32(sc, hi, dl, 1);\n", ""]],
    # no exp on the special-function units (2^x taken as x)
    "no_exp": [['    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n', "    y = x;\n"]],
    # the producer neither loads nor stores after the first tile's loads
    "no_producer": [["        x.store_k(smem + S::K + s * 2 * S::KPLANE, tid);\n", ""],
                    ["        x.store_v(smem + S::V + s * 2 * S::VPLANE, tid);\n", ""],
                    ["            x.load_k(kb, mb, (j + 1) * BN, Lk, tid);\n"
                     "            x.load_v(vb, (j + 1) * BN, Lk, tid);\n", ""]],
}


def build(variants: dict) -> dict:
    """name -> the loaded library of that variant's flash sources."""
    out = os.path.join(ROOT, "pathway_tpu_torch", "_build", "flash_ab")
    shutil.rmtree(out, ignore_errors=True)
    nvcc = _build._nvcc()
    procs = []
    for name, (csrc, subs) in variants.items():
        vdir = os.path.join(out, name)
        os.makedirs(vdir)
        texts = {}
        for f in os.listdir(csrc):
            if f.endswith((".cu", ".cuh")):
                with open(os.path.join(csrc, f)) as fh:
                    texts[f] = fh.read()
        for old, new in subs:
            hits = [f for f in FLASH if old in texts[f]]
            if not hits:
                raise ValueError(f"{name}: {old!r} in no flash source")
            for f in hits:
                texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
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
        if f in FLASH:
            kernel, frame = None, ""
            for line in text.splitlines():
                m = re.search(r"Compiling entry function '.*?(flash_fwd_bf16|flash_fwd_tf32x3)"
                              r"ILi(\d+)E", line)
                if m:
                    kernel = f"{m.group(1)}<{m.group(2)}>"
                elif kernel and "bytes stack frame" in line:
                    frame = line.strip()
                elif kernel and "Used" in line:
                    used = re.search(r"Used (\d+) registers", line).group(1)
                    print(f"  ptxas {name} {kernel}: {used} registers, {frame}")
                    kernel, frame = None, ""
            for line in text.splitlines():
                if "Potential Performance Loss" in line:
                    m = re.search(r"(flash_fwd_bf16|flash_fwd_tf32x3)ILi(\d+)E", line)
                    where = f" in {m.group(1)}<{m.group(2)}>" if m else ""
                    print(f"  ptxas {name}{where}: {line.strip()[:160]}")
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

    def make(b, h, l, d, lo, dtype=torch.bfloat16):
        q, k, v = (torch.randn((b, h, l, d), device="cuda", generator=gen).to(dtype)
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
        "f32_d32": (make(64, 12, 512, 32, 1, torch.float32), False),
        "f32_d256_causal": (make(1, 16, 2048, 256, 2048, torch.float32), True),
        "f32_d128_causal": (make(8, 32, 1024, 128, 700, torch.float32), True),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # SDPA in f32 as chip_smoke times it
    if sys.argv[1] == "probes":
        variants = {"tree": [CSRC, []], **{name: [CSRC, subs] for name, subs in F32_PROBES.items()}}
        order = ["tree", *F32_PROBES, "tree"]
        keys = sys.argv[2] if len(sys.argv) > 2 else "f32_d32,f32_d256_causal,f32_d128_causal"
    else:
        with open(sys.argv[1]) as fh:
            variants = json.load(fh)
        order = sys.argv[2].split(",")
        keys = sys.argv[3] if len(sys.argv) > 3 else None
    libs = build(variants)
    cases = shapes()
    if keys:
        cases = {key: cases[key] for key in keys.split(",")}
    refs = {key: reference_attention(q, k, v, m, q.shape[-1] ** -0.5, c).float()
            for key, ((q, k, v, m), c) in cases.items() if key not in ("d32_ingest", "d128_long")}
    print(cs.card_line())
    for key in ("d128_causal", "d128", "d128_long", "d256_causal", "f32_d32", "f32_d256_causal",
                "f32_d128_causal"):
        if key not in cases:
            continue
        (q, k, v, m), c = cases[key]
        keep = m.bool()[:, None, None, :] if key == "f32_d32" else None  # its ragged keys
        sdpa = cs.median_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep, is_causal=c))
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
