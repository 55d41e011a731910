#!/usr/bin/env python3
"""Where the time goes on the port's main path: a torch.profiler trace.

    python3 trace_port.py                    # on the card, full MiniLM-L6 width
    python3 trace_port.py --device cpu --docs 64 --index-rows 4096   # rehearsal

For each phase of the retrieval data plane (packed ingest, classic ingest,
encode + DeviceKnnIndex.search_keys, FusedEmbedSearch.search_texts) it runs
the phase once to warm up, then once under torch.profiler, and prints one
JSON line: the wall time (host clock, ending in a synchronise), the host
time of the tokenize / pack step alone, the device's busy time (the union of
the CUDA kernels' intervals in the trace), the idle share
1 - busy / wall, and the five kernels with the most device time. On the CPU
the device numbers are null ("not measured"). Weights are random from a
seed, docs are bench.py-style; imports torch, numpy and pathway_tpu_torch.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_QUERIES = 32  # one query batch, as in chip_smoke.py
_WORDS = (
    "stream table engine incremental dataflow tensor shard mesh batch "
    "window join reduce filter index vector embed query latency commit "
    "snapshot worker collective gather scatter fuse compile kernel"
).split()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _busy_us(prof) -> tuple[float | None, list]:
    """Union of the CUDA kernel intervals, and the top kernels by time."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None, []
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return busy, [{"kernel": n[:80], "ms": us / 1e3} for n, us in top]


def trace(name: str, run, device: torch.device, host_ms: float | None = None) -> dict:
    from torch.profiler import ProfilerActivity, profile

    run()  # warm-up: allocator, cuBLAS handles, first launches
    _sync(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        _sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, top = _busy_us(prof) if device.type == "cuda" else (None, [])
    row = {
        "phase": name,
        "wall_ms": wall_us / 1e3,
        "host_prepare_ms": host_ms,
        "device_busy_ms": None if busy is None else busy / 1e3,
        "device_idle_share": None if busy is None else 1.0 - busy / wall_us,
        "top_kernels": top,
    }
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=4096, help="docs per ingest phase")
    ap.add_argument("--index-rows", type=int, default=1 << 20)
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("trace_port: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pathway_tpu_torch.models.minilm import SentenceEncoder
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex, FusedEmbedSearch

    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0], flush=True)
    rng = random.Random(SEED)
    docs = [" ".join(rng.choices(_WORDS, k=48)) + f" doc{i}" for i in range(args.docs)]
    encoder = SentenceEncoder("all-MiniLM-L6-v2", max_len=64, seed=SEED, device=device)
    index = DeviceKnnIndex(encoder.dimension, reserved_space=args.index_rows, device=device)
    fused = FusedEmbedSearch(encoder, index, device=device)
    chunk = min(2048, args.docs)
    spans = [range(s, min(s + chunk, args.docs)) for s in range(0, args.docs, chunk)]

    def host_ms(pack: bool) -> float:
        t0 = time.perf_counter()
        for keys in spans:
            fused.prepare_batch(keys, docs[keys.start : keys.stop], pack=pack)
        return (time.perf_counter() - t0) * 1e3

    def ingest_packed():
        for keys in spans:
            fused.dispatch_batch(fused.prepare_batch(keys, docs[keys.start : keys.stop])[0])

    def ingest_classic():
        for keys in spans:
            fused.embed_and_add(keys, docs[keys.start : keys.stop])

    trace("ingest_packed", ingest_packed, device, host_ms(True))
    trace("ingest_classic", ingest_classic, device, host_ms(False))
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    fill = args.index_rows - len(index)
    for s in range(0, fill, 1 << 17):
        n = min(1 << 17, fill - s)
        vecs = torch.randn((n, encoder.dimension), device=device, generator=gen)
        index.add_batch(range(args.docs + s, args.docs + s + n), vecs)
    _sync(device)
    texts = [docs[i % args.docs] for i in range(N_QUERIES)]
    trace("search_keys", lambda: index.search_keys(encoder.encode(texts), 6), device)
    trace("search_texts", lambda: fused.search_texts(texts, 6), device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
