#!/usr/bin/env python3
"""Where the time goes on the port's main path: a torch.profiler trace.

    python3 trace_port.py                    # on the card, full MiniLM-L6 width
    python3 trace_port.py --device cpu --docs 64 --index-rows 4096 --decoder tiny  # rehearsal

For each phase of the retrieval data plane (packed ingest, classic ingest,
encode + DeviceKnnIndex.search_keys, FusedEmbedSearch.search_texts, then
the knn_topk kernel alone at four (Q, k) shapes), and of the decoder
(ChatModel("mistral-7b", max_len=2048) at full width, 8 prompts of
700-1000 words as in chip_smoke.py: the prefill, then 8 KV-cached decode
steps at batch 8) it runs
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

    from pathway_tpu_torch.internals.profiler import exclusive

    run()  # warm-up: allocator, cuBLAS handles, first launches
    _sync(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # the process's one CUPTI session: held against /profile captures
    with exclusive(), profile(activities=activities) as prof:
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
    ap.add_argument("--decoder", choices=("mistral-7b", "tiny"), default="mistral-7b",
                    help="the decoder's geometry (tiny for a rehearsal)")
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
    # the knn_topk kernel alone over the same index: its query split, pass 1
    # and pass 2 (merge) as separate kernels, at the main path's shape and
    # at Q = 1 / k = 6, Q = 64 / k = 6 and Q = 64 / k = 128
    from pathway_tpu_torch.ops.kernels import knn_topk

    rows, live = index.device_buffer, index.device_valid
    for qn, k in ((N_QUERIES, 6), (1, 6), (64, 6), (64, 128)):
        q = torch.randn((qn, encoder.dimension), device=device, generator=gen)
        q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
        trace(f"knn_topk Q={qn} k={k}",
              lambda q=q, k=k: knn_topk(rows, live, q, k, metric="ip"), device)
    del encoder, index, fused, rows, live
    trace_decoder(args.decoder, device)
    return 0


def trace_decoder(model: str, device: torch.device) -> None:
    """The decoder's prefill (one generate_tokens call that makes one new
    token) and 8 decode steps on the cache the prefill wrote, the calls
    generate_tokens makes."""
    import gc

    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.models.decoder_lm import ChatModel

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    config = None
    if model == "tiny":
        config = dec.DecoderConfig(vocab_size=512, hidden=64, layers=2, q_heads=4, kv_heads=2,
                                   mlp_dim=128, max_len=1200, dtype="bfloat16")
    chat = ChatModel(model, config=config, max_len=2048, seed=SEED, device=device)
    cfg, params = chat.config, chat.params
    rng = random.Random(11)
    prompts = [" ".join(rng.choices(_WORDS, k=rng.randint(700, 1000))) for _ in range(8)]
    ids, mask = chat.encode_prompts(prompts, 32)
    b, l = ids.shape
    trace(f"decoder prefill [{b}, {l}]",
          lambda: dec.generate_tokens(params, cfg, ids, mask, max_new_tokens=1), device)
    ti, tm = torch.from_numpy(ids).long().to(device), torch.from_numpy(mask).long().to(device)
    lengths = tm.sum(1)
    kv_valid = torch.zeros((b, cfg.max_len), dtype=torch.int32, device=device)
    kv_valid[:, :l] = tm
    cache = dec.init_kv_cache(cfg, b, device)
    tok = torch.ones((b, 1), dtype=torch.long, device=device)
    with torch.no_grad():
        dec.decoder_forward(params, cfg, ti, tm, positions=tm.cumsum(1) - 1, kv_cache=cache,
                            kv_valid=kv_valid)

        def decode(steps=8):
            for t in range(steps):
                kv_valid[:, l + t] = 1
                dec.decoder_forward(params, cfg, tok, torch.ones_like(tok),
                                    positions=(lengths + t)[:, None], kv_cache=cache,
                                    kv_valid=kv_valid, slot_offset=l + t)

        trace(f"decoder decode, 8 steps at batch {b}", decode, device)


if __name__ == "__main__":
    sys.exit(main())
