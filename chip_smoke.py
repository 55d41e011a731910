#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each kernel against its plain PyTorch version on the card at the
main path's shapes, then drives the retrieval data plane at full MiniLM-L6
width with random weights from a seed:

  1. identify the card (nvidia-smi name and power limit, device properties);
  2. build the kernels (nvcc, sm_90a) and print the build time;
  3. knn_topk and flash_attention against their plain versions, with
     CUDA-event medians of kernel, plain and library-call times (knn_topk
     at the main path's Q = 32, k = 6 and at Q = 1 / k = 6, Q = 64 / k = 6,
     Q = 64 / k = 128; flash at the encoder's [64, 12, 512, 32] and, causal
     with a ragged mask, at the decoder prefill's [8, 32, 1024, 128]);
  4. main path: 16,384 bench-style docs ingested packed
     (FusedEmbedSearch.prepare_batch + dispatch_batch) and classic
     (embed_and_add), the index filled to 1,048,576 live rows on the device,
     32 doc texts retrieving their own key at rank 1 through
     DeviceKnnIndex.search_keys (knn_topk kernel) and
     FusedEmbedSearch.search_texts;
  5. long documents: SentenceEncoder(max_len=512) over 256 docs of L = 512,
     which takes the flash kernel, against the same encode without flash;
  6. the decoder at full Mistral-7B width (hidden 4096, 32 layers, 32 q /
     8 kv heads, MLP 14336, vocab 32000, bf16, random weights from a
     seeded generator on the card): ChatModel("mistral-7b", max_len=2048)
     generates 32 tokens for 8 prompts of 700-1000 words, whose prefill
     takes the flash kernel at head dim 128; prefill through flash against
     the dense path, KV-cached steps against recomputing the prefix, and
     prefill and decode rates against their bounds;
  7. the card's line, one `kernels` JSON line, then the `ok` JSON line.

Every check raises on failure, so a failed phase exits non-zero and prints
no `ok` line. Imports torch, numpy and pathway_tpu_torch only.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
# exp on the special-function units: 16 a clock per SM x 132 SMs x ~1.83 GHz
EXP_PER_S = 3.9e12

N_DOCS = 16384
N_CHUNKS = 8
N_INDEX = 1 << 20
DIM = 384
K = 6
N_QUERIES = 32
_WORDS = (
    "stream table engine incremental dataflow tensor shard mesh batch "
    "window join reduce filter index vector embed query latency commit "
    "snapshot worker collective gather scatter fuse compile kernel"
).split()


def log(*parts) -> None:
    print(*parts, flush=True)


def make_docs(n: int, rng: random.Random, words: int = 48) -> list[str]:
    """Bench-style docs (bench.py make_docs): `words` random words + an id."""
    return [" ".join(rng.choices(_WORDS, k=words)) + f" doc{i}" for i in range(n)]


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 15, inner: int = 10) -> float:
    """CUDA-event median over `reps` samples, after one warm-up, of the
    mean time of `inner` back-to-back calls of `fn`. With inner > 1 the
    host's launch work overlaps the card's, so a sample is device time;
    inner = 1 adds the host's time to reach the launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- phase 3: kernels against their plain versions ---------------------------


def knn_sets_agree(ks, ki, ps, pi, tie_tol: float = 1e-5) -> None:
    """Index sets equal, except where the plain k-th score and the swapped
    slots' scores lie within `tie_tol` (a near-tie that rounding decides)."""
    ks, ki, ps, pi = (t.cpu().numpy() for t in (ks, ki, ps, pi))
    for r in range(ki.shape[0]):
        a, b = set(ki[r].tolist()), set(pi[r].tolist())
        if a == b:
            continue
        kth = ps[r].min()
        only_kernel = [ks[r][list(ki[r]).index(i)] for i in a - b]
        only_plain = [ps[r][list(pi[r]).index(i)] for i in b - a]
        check(
            all(abs(s - kth) <= tie_tol for s in only_kernel + only_plain),
            f"knn_topk row {r}: index sets differ beyond near-ties",
        )


def check_knn(knn_topk, reference_knn_topk, gen) -> dict:
    x = torch.randn((N_INDEX, DIM), device="cuda", generator=gen)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    valid = torch.rand((N_INDEX,), device="cuda", generator=gen) >= 0.01
    max_err = 0.0
    for metric in ("cos", "ip", "l2sq"):
        for qn in (1, 32, 64):
            q = torch.randn((qn, DIM), device="cuda", generator=gen)
            q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
            for k in (6, 24, 128):
                ks, ki = knn_topk(x, valid, q, k, metric=metric)
                ps, pi = reference_knn_topk(x, valid, q, k, metric=metric)
                torch.cuda.synchronize()
                err = (ks.sort(dim=1).values - ps.sort(dim=1).values).abs().max().item()
                check(err <= 1e-4, f"knn_topk {metric} Q={qn} k={k}: score error {err}")
                check(bool(valid[ki.long()].all()), f"knn_topk {metric}: dead slot returned")
                knn_sets_agree(ks, ki, ps, pi)
                max_err = max(max_err, err)
                log(f"  knn_topk {metric:4s} Q={qn:2d} k={k:3d}: max |score err| {err:.3g}  ok")
    # times at the main path's search shape (Q = 32 queries, k = 6, cos,
    # which reaches the kernel as ip on normalised queries), then at one
    # query, at Q = 64 with the same k (the score cost) and at the kernel's
    # k limit (the selection cost). Three query draws, as many as earlier
    # versions of this script took, so that the flash phase's inputs from
    # `gen` stay the same.
    q, q1, q64 = (
        torch.randn((qn, DIM), device="cuda", generator=gen) for qn in (N_QUERIES, 1, 64)
    )
    shapes = []
    for qq, k in ((q, K), (q1, 6), (q64, 6), (q64, 128)):
        qq /= torch.linalg.vector_norm(qq, dim=1, keepdim=True)
        shapes.append(time_knn(knn_topk, reference_knn_topk, x, valid, qq, k))
    main = shapes[0]
    log(f"  the same, one call per sample (host time to the launch included): kernel "
        f"{median_ms(lambda: knn_topk(x, valid, q, K, metric='ip'), inner=1):.4f} ms, "
        f"torch.topk(q @ x.T) {median_ms(lambda: torch.topk(q @ x.T, K, dim=1), inner=1):.4f} ms")
    del x, valid
    return {
        "name": "knn_topk",
        "route": "cuda",
        "source": "pathway_tpu_torch/ops/kernels/csrc/knn_topk.cu",
        "replaces": "pathway_tpu/ops/kernels/knn_topk.py:21",
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shapes": shapes[1:],
    }


def time_knn(knn_topk, reference_knn_topk, x, valid, q, k) -> dict:
    """Kernel, plain and library-call times at one shape, and the bound:
    each input read once and each output written once at 3.35 TB/s,
    against the scores as the kernel computes them, three tf32 tensor-core
    passes (3xTF32) at 495 TFLOP/s."""
    qn = q.shape[0]
    ms = median_ms(lambda: knn_topk(x, valid, q, k, metric="ip"))
    plain_ms = median_ms(lambda: reference_knn_topk(x, valid, q, k, metric="ip"))
    library_ms = median_ms(lambda: torch.topk(q @ x.T, k, dim=1))
    nbytes = x.numel() * 4 + valid.numel() + q.numel() * 4 + qn * k * 8
    flops = 3 * 2.0 * qn * x.shape[0] * x.shape[1]
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / TF32_FLOPS * 1e3
    log(f"  knn_topk N={x.shape[0]} d={x.shape[1]} Q={qn} k={k}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, torch.topk(q @ x.T) {library_ms:.4f} ms, bound "
        f"{max(byte_ms, op_ms):.4f} ms (bytes {byte_ms:.4f}; 3 tf32 passes at 495 "
        f"TFLOP/s {op_ms:.4f})")
    return {
        "Q": qn,
        "k": k,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
    }


def live_rows_err(out, ref, mask) -> float:
    live = mask.sum(dim=1) > 0  # batch rows with at least one live key
    check(bool(torch.isfinite(out.float()).all()), "flash_attention: non-finite output")
    return (out.float()[live] - ref.float()[live]).abs().max().item()


def check_flash(flash_attention, reference_attention, gen) -> dict:
    import torch.nn.functional as F

    b, h, l, d = 64, 12, 512, 32
    q, k, v = (
        torch.randn((b, h, l, d), device="cuda", generator=gen).bfloat16() for _ in range(3)
    )
    lens = torch.randint(1, l + 1, (b,), device="cuda", generator=gen)
    lens[-4:] = 0  # fully masked rows, as encode_batch's pad rows
    mask = (torch.arange(l, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
    scale = d ** -0.5
    out = flash_attention(q, k, v, mask)
    ref = reference_attention(q, k, v, mask, scale, False)
    err = live_rows_err(out, ref, mask)
    check(err <= 2e-2, f"flash_attention bf16 [{b},{h},{l},{d}]: error {err}")
    log(f"  flash_attention bf16 [{b},{h},{l},{d}] ragged: max |err| on live rows {err:.3g}  ok")
    # causal in bf16 at the encoder's width, ragged keys
    qc, kc, vc, mc = q[:2], k[:2], v[:2], mask[:2]
    e = live_rows_err(
        flash_attention(qc, kc, vc, mc, causal=True),
        reference_attention(qc, kc, vc, mc, scale, True), mc,
    )
    check(e <= 2e-2, f"flash_attention bf16 causal [2,{h},{l},{d}]: error {e}")
    log(f"  flash_attention bf16 [2,{h},{l},{d}] causal: max |err| on live rows {e:.3g}  ok")
    err = max(err, e)
    # a small causal case and a non-causal one in f32
    qf, kf, vf = (
        torch.randn((2, 3, 300, d), device="cuda", generator=gen) for _ in range(3)
    )
    mf = torch.ones((2, 300), dtype=torch.int32, device="cuda")
    mf[1, 170:] = 0
    for causal in (True, False):
        e = live_rows_err(
            flash_attention(qf, kf, vf, mf, causal=causal),
            reference_attention(qf, kf, vf, mf, scale, causal), mf,
        )
        check(e <= 1e-4, f"flash_attention f32 causal={causal}: error {e}")
        log(f"  flash_attention f32 [2,3,300,{d}] causal={causal}: max |err| {e:.3g}  ok")
    ms = median_ms(lambda: flash_attention(q, k, v, mask))
    plain_ms = median_ms(lambda: reference_attention(q, k, v, mask, scale, False))
    keep = mask.bool()[:, None, None, :]
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep))
    nbytes = 4 * q.numel() * 2 + mask.numel() * 4
    flops = 4.0 * b * h * l * l * d
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    # one exp per score on the special-function units: 16 a clock per SM
    exp_floor_ms = b * h * l * l / EXP_PER_S * 1e3
    log(f"  flash_attention [{b},{h},{l},{d}] bf16: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms, "
        f"bound {max(byte_ms, op_ms):.4f} ms, exp floor {exp_floor_ms:.4f} ms")
    log(f"  the same, one call per sample (host time to the launch included): kernel "
        f"{median_ms(lambda: flash_attention(q, k, v, mask), inner=1):.4f} ms, "
        f"scaled_dot_product_attention "
        f"{median_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep), inner=1):.4f} ms")
    # the ingest shape (2048 docs at L = 64), where the encoder takes the
    # dense path (the plain version) because the flash gate is L > 256
    qs, ks, vs = (
        torch.randn((2048, h, 64, d), device="cuda", generator=gen).bfloat16() for _ in range(3)
    )
    ms_mask = torch.ones((2048, 64), dtype=torch.int32, device="cuda")
    log(f"  flash_attention [2048,{h},64,{d}] bf16 (ingest shape): kernel "
        f"{median_ms(lambda: flash_attention(qs, ks, vs, ms_mask)):.4f} ms, plain (the dense path) "
        f"{median_ms(lambda: reference_attention(qs, ks, vs, ms_mask, scale, False)):.4f} ms")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "pathway_tpu_torch/ops/kernels/csrc/flash_attention.cu",
        "replaces": "pathway_tpu/ops/kernels/flash_attention.py:25",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": library_ms,
    }


def check_flash_decoder_shape(flash_attention, reference_attention) -> dict:
    """Flash at the decoder prefill's head dim 128, bf16, causal, with a
    ragged key mask (rows of 700-1024 live keys), at Lq = 1024 and at
    Lq = 1000 (not a multiple of the 128-row block). Its own generator, so
    the draws of the other checks stay as they were."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h, d = 8, 32, 128
    scale = d ** -0.5
    err = 0.0
    for l in (1000, 1024):
        q, k, v = (
            torch.randn((b, h, l, d), device="cuda", generator=gen).bfloat16() for _ in range(3)
        )
        lens = torch.randint(700, l + 1, (b,), device="cuda", generator=gen)
        mask = (torch.arange(l, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
        e = live_rows_err(
            flash_attention(q, k, v, mask, causal=True),
            reference_attention(q, k, v, mask, scale, True), mask,
        )
        check(e <= 2e-2, f"flash_attention bf16 causal [{b},{h},{l},{d}]: error {e}")
        log(f"  flash_attention bf16 causal [{b},{h},{l},{d}] ragged (700-{l} live keys): "
            f"max |err| {e:.3g}  ok")
        err = max(err, e)
    ms = median_ms(lambda: flash_attention(q, k, v, mask, causal=True))
    plain_ms = median_ms(lambda: reference_attention(q, k, v, mask, scale, True))
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    # causal: a query row needs the keys at or before it, L (L + 1) / 2 pairs
    pairs = b * h * l * (l + 1) / 2
    nbytes = 4 * q.numel() * 2 + mask.numel() * 4
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, 4.0 * pairs * d / BF16_FLOPS * 1e3
    log(f"  flash_attention [{b},{h},{l},{d}] bf16 causal: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, scaled_dot_product_attention(is_causal) {library_ms:.4f} ms, "
        f"bound {max(byte_ms, op_ms):.4f} ms (bytes {byte_ms:.4f}, bf16 products {op_ms:.4f}), "
        f"exp floor {pairs / EXP_PER_S * 1e3:.4f} ms")
    return {
        "shape": [b, h, l, d],
        "causal": True,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": library_ms,
    }


# -- phases 4 and 5: the main path -------------------------------------------


def cosine_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)


def check_small_input_against_cpu(encoder, docs) -> None:
    """The card's encode of a few docs against the plain CPU path on the
    same weights."""
    from pathway_tpu_torch.models.transformer import TransformerLM
    from pathway_tpu_torch.models.tokenizer import encode_batch

    cpu_lm = TransformerLM(encoder.config, params=_cpu_tree(encoder.lm.params), device="cpu")
    ids, mask = encode_batch(encoder.tokenizer, docs, max_len=encoder.max_len)
    got = encoder.encode(docs)
    want = cpu_lm(ids, mask)[: len(docs)].numpy()
    cos = cosine_rows(got, want).min()
    check(got.shape == (len(docs), DIM) and np.isfinite(got).all(), "encode: bad output")
    check(cos >= 0.999, f"card encode vs CPU encode: min cosine {cos}")
    log(f"  card vs CPU encode of {len(docs)} docs: min cosine {cos:.6f}  ok")


def _cpu_tree(tree):
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu_tree(v) for v in tree]
    return tree.detach().cpu()


def run_main_path(docs) -> dict:
    from pathway_tpu_torch.models.minilm import SentenceEncoder
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex, FusedEmbedSearch

    encoder = SentenceEncoder("all-MiniLM-L6-v2", max_len=64, seed=0)
    check(encoder.config.hidden == DIM and encoder.config.layers == 6, "not MiniLM-L6")
    index = DeviceKnnIndex(encoder.dimension, metric="cos", reserved_space=N_DOCS)
    fused = FusedEmbedSearch(encoder, index)
    chunk = N_DOCS // N_CHUNKS
    # warm-up on a throwaway index (cuBLAS handles, allocator)
    warm = FusedEmbedSearch(encoder, DeviceKnnIndex(DIM, reserved_space=chunk))
    warm.dispatch_batch(warm.prepare_batch(range(chunk), docs[:chunk])[0])
    warm.embed_and_add(range(chunk), docs[:chunk])
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for s in range(0, N_DOCS, chunk):
        payload, _meta = fused.prepare_batch(range(s, s + chunk), docs[s : s + chunk])
        fused.dispatch_batch(payload)
    torch.cuda.synchronize()
    packed_rate = N_DOCS / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for s in range(0, N_DOCS, chunk):  # same keys: the classic vectors replace the packed
        fused.embed_and_add(range(s, s + chunk), docs[s : s + chunk])
    torch.cuda.synchronize()
    classic_rate = N_DOCS / (time.perf_counter() - t0)
    log(f"  ingest {N_DOCS} docs (max_len 64): packed {packed_rate:.1f} docs/s, "
        f"classic {classic_rate:.1f} docs/s")

    gen = torch.Generator(device="cuda").manual_seed(1)
    fill = N_INDEX - len(index)
    step = 1 << 17
    t0 = time.perf_counter()
    for s in range(0, fill, step):
        n = min(step, fill - s)
        vecs = torch.randn((n, DIM), device="cuda", generator=gen)
        index.add_batch(range(N_DOCS + s, N_DOCS + s + n), vecs)
    torch.cuda.synchronize()
    check(len(index) == N_INDEX and index.capacity == N_INDEX, "index not at 2^20 live rows")
    log(f"  filled the index to {len(index)} live rows in {time.perf_counter() - t0:.2f} s")

    picks = random.Random(7).sample(range(N_DOCS), N_QUERIES)
    texts = [docs[i] for i in picks]
    t0 = time.perf_counter()
    rows = index.search_keys(encoder.encode(texts), K)
    kernel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused_rows = fused.search_texts(texts, K)
    fused_s = time.perf_counter() - t0
    for name, got in (("search_keys", rows), ("search_texts", fused_rows)):
        hits = sum(1 for r, want in zip(got, picks) if r and r[0][0] == want)
        gap = min(r[0][1] - r[1][1] for r in got)
        check(hits == N_QUERIES, f"{name}: {hits}/{N_QUERIES} self-retrievals at rank 1")
        log(f"  {name} over {len(index)} rows: {hits}/{N_QUERIES} at rank 1, "
            f"min rank-1 margin {gap:.4g}  ok")
    log(f"  search wall: encode + search_keys {kernel_s * 1e3:.2f} ms, "
        f"search_texts {fused_s * 1e3:.2f} ms (32 queries, first call)")
    check_small_input_against_cpu(encoder, docs[:8])
    return {"packed_docs_per_s": packed_rate, "classic_docs_per_s": classic_rate}


def run_long_docs() -> None:
    from pathway_tpu_torch.models.minilm import SentenceEncoder
    from pathway_tpu_torch.models.tokenizer import encode_batch

    encoder = SentenceEncoder("all-MiniLM-L6-v2", max_len=512, seed=0)
    docs = make_docs(256, random.Random(3), words=520)
    batches = [docs[s : s + 64] for s in range(0, len(docs), 64)]
    t0 = time.perf_counter()
    vecs = [encoder.encode(batch) for batch in batches]
    wall = time.perf_counter() - t0
    worst = 1.0
    for batch, got in zip(batches, vecs):
        ids, mask = encode_batch(encoder.tokenizer, batch, max_len=512)
        check(ids.shape == (64, 512), f"long docs bucketed to {ids.shape}, not (64, 512)")
        dense = encoder.lm(ids, mask, use_flash=False)[: len(batch)].cpu().numpy()
        check(np.isfinite(got).all() and got.shape == (64, DIM), "long-doc encode: bad output")
        worst = min(worst, float(cosine_rows(got, dense).min()))
    check(worst >= 0.999, f"flash vs dense encode: min cosine {worst}")
    log(f"  {len(docs)} docs at L=512: {len(docs) / wall:.1f} docs/s; "
        f"flash vs dense per-row cosine >= {worst:.6f}  ok")


# -- phase 6: the decoder at full width ----------------------------------------


def make_prompts(n: int, rng: random.Random, lo: int, hi: int) -> list[str]:
    return [" ".join(rng.choices(_WORDS, k=rng.randint(lo, hi))) for _ in range(n)]


def logit_cosine(a, b) -> float:
    return torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1).min().item()


@contextlib.contextmanager
def decoder_attention(decoder_module, fn):
    """While active, the decoder calls `fn` where it calls its attention."""
    plain = decoder_module._attention
    decoder_module._attention = fn
    try:
        yield
    finally:
        decoder_module._attention = plain


def run_decoder(card: str, flash_attention) -> dict:
    from pathway_tpu_torch.models import decoder as decoder_module
    from pathway_tpu_torch.models.decoder import decoder_forward, generate_tokens, init_kv_cache
    from pathway_tpu_torch.models.decoder_lm import ChatModel
    from pathway_tpu_torch.ops.kernels.flash_attention import reference_attention

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chat = ChatModel("mistral-7b", max_len=2048, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, params = chat.config, chat.params
    check(
        (cfg.hidden, cfg.layers, cfg.q_heads, cfg.kv_heads, cfg.mlp_dim, cfg.vocab_size,
         cfg.dtype, cfg.head_dim) == (4096, 32, 32, 8, 14336, 32000, "bfloat16", 128),
        f"not MISTRAL_7B_DECODER: {cfg}",
    )
    n_params = sum(
        t.numel() for t in [params["embed"], params["ln_f"]]
        + [t for layer in params["layers"] for t in layer.values()]
    )
    weight_bytes = sum(
        t.numel() * t.element_size() for t in [params["embed"], params["ln_f"]]
        + [t for layer in params["layers"] for t in layer.values()]
    )
    log(f"  ChatModel('mistral-7b', max_len=2048): {n_params / 1e9:.3f} B parameters, "
        f"{weight_bytes / 1e9:.2f} GB, initialised on the card in {init_s:.2f} s")

    prompts = make_prompts(8, random.Random(11), 700, 1000)
    steps = 32
    flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = chat.generate(prompts, max_new_tokens=steps)
    first_s = time.perf_counter() - t0
    launches = flash_attention.launches
    check(len(outs) == 8 and all(isinstance(o, str) for o in outs), "generate: bad output")
    check(launches >= cfg.layers, f"generate launched flash {launches} times, not >= {cfg.layers}")
    ids, mask = chat.encode_prompts(prompts, steps)
    b, l = ids.shape
    check(l > 256, f"prompts of {l} tokens stay under the flash gate")
    log(f"  generate: 8 prompts of {int(mask.sum(1).min())}-{l} tokens, {steps} new tokens each, "
        f"first call {first_s:.2f} s; flash launches {launches}")

    # rates: prefill alone (one new token) and the whole loop, three runs each
    toks = None
    t_prefill, t_all = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        generate_tokens(params, cfg, ids, mask, max_new_tokens=1)  # ends in a copy to the host
        t_prefill.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        toks = generate_tokens(params, cfg, ids, mask, max_new_tokens=steps)
        t_all.append(time.perf_counter() - t0)
    t_pre, t_gen = float(np.median(t_prefill)), float(np.median(t_all))
    step_s = (t_gen - t_pre) / (steps - 1)
    live = int(mask.sum())
    prefill_rate = b * l / t_pre
    decode_rate = b / step_s
    prefill_bound = b * l * 2.0 * n_params / BF16_FLOPS
    kv_row_bytes = cfg.layers * 2 * cfg.kv_heads * cfg.head_dim * 2  # one slot, all layers
    mean_slots = l + (steps - 2) / 2  # slots read by the average decode step
    step_bound = (weight_bytes + b * mean_slots * kv_row_bytes) / HBM_BYTES_PER_S
    log(f"  prefill [{b}, {l}]: {t_pre * 1e3:.1f} ms, {prefill_rate:.1f} tokens/s computed "
        f"({live / t_pre:.1f} live), bound {prefill_bound * 1e3:.1f} ms "
        f"(2 x {n_params / 1e9:.3f} GFLOP a token at 989 TFLOP/s), {prefill_bound / t_pre:.3f} of it "
        f"[{card}]")
    log(f"  decode at batch {b}: {step_s * 1e3:.2f} ms a step, {decode_rate:.1f} tokens/s, bound "
        f"{step_bound * 1e3:.2f} ms a step ({weight_bytes / 1e9:.2f} GB of weights + "
        f"{b * mean_slots * kv_row_bytes / 1e9:.2f} GB of live KV at 3.35 TB/s), "
        f"{step_bound / step_s:.3f} of it [{card}]")

    # prefill through flash against the dense path, on the same inputs.
    # Per layer, on that layer's own q / k / v (the dense run's), the probe
    # below holds the kernel to a per-row cosine >= 0.999 to the plain
    # version, and each element to phase 3's bf16 tolerance plus two bf16
    # ulps of its value (|err| <= 2e-2 + 2^-6 |o|: the model's outputs
    # reach |o| ~ 8) of the same attention in f32. f32 is the yardstick
    # because the kernel keeps f32 scores while the plain version rounds
    # q k^T to bf16 before the softmax, as the JAX package's
    # `_reference_attention` does. End to end, the two paths' logits drift
    # apart through 32 bf16 layers of random weights as much as any two
    # roundings of attention do (the plain version with f32 attention
    # against the plain version gave 0.9974 on an H100; PERF.md), so the
    # logits are held to cosine >= 0.995 and printed beside that
    # yardstick.
    dev = params["embed"].device
    ti, tm = torch.from_numpy(ids).long().to(dev), torch.from_numpy(mask).long().to(dev)
    positions = tm.cumsum(1) - 1
    kv_valid = torch.zeros((b, cfg.max_len), dtype=torch.int32, device=dev)
    kv_valid[:, :l] = tm
    cache = init_kv_cache(cfg, b, dev)

    def prefill(use_flash=None):
        logits, _ = decoder_forward(params, cfg, ti, tm, positions=positions, kv_cache=cache,
                                    kv_valid=kv_valid, use_flash=use_flash)
        return logits[tm.bool()]

    # per layer: (the kernel's min row cosine to the plain output, its max
    # |err| against f32 attention, that error over its tolerance, the
    # plain output's max |err| against f32)
    per_layer = []

    def f32(q, k, v, m, causal, use_flash):
        scale = 1.0 / math.sqrt(q.shape[-1])
        return reference_attention(q.float(), k.float(), v.float(), m, scale, causal).to(q.dtype)

    def probe(q, k, v, m, causal, use_flash):
        want = reference_attention(q, k, v, m, 1.0 / math.sqrt(q.shape[-1]), causal)
        got = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), m, causal=causal)
        check(bool(torch.isfinite(got.float()).all()), "flash_attention: non-finite output")
        exact = f32(q, k, v, m, causal, False).float()
        err = (got.float() - exact).abs()
        per_layer.append((logit_cosine(got, want), err.max().item(),
                          (err / (2e-2 + 2.0 ** -6 * exact.abs())).max().item(),
                          (want.float() - exact).abs().max().item()))
        return want

    with torch.no_grad():
        flash_logits = prefill(use_flash=True)
        with decoder_attention(decoder_module, probe):
            dense_logits = prefill()
        with decoder_attention(decoder_module, f32):
            f32_logits = prefill()
        cos = logit_cosine(flash_logits, dense_logits)
        yardstick = logit_cosine(f32_logits, dense_logits)
        del flash_logits, dense_logits, f32_logits
    layer_cos = min(c for c, _, _, _ in per_layer)
    layer_err = max(e for _, e, _, _ in per_layer)
    layer_tol = max(r for _, _, r, _ in per_layer)
    plain_err = max(p for _, _, _, p in per_layer)
    check(len(per_layer) == cfg.layers, f"probed {len(per_layer)} layers, not {cfg.layers}")
    check(layer_cos >= 0.999 and layer_tol <= 1.0,
          f"prefill flash per layer: min row cosine to dense {layer_cos}, max |err| against f32 "
          f"attention {layer_err} ({layer_tol:.3f} of its tolerance)")
    log(f"  prefill flash at each of {len(per_layer)} layers, on its q / k / v: min row cosine to "
        f"dense {layer_cos:.6f}; max |err| against f32 attention {layer_err:.3g} ({layer_tol:.3f} "
        f"of 2e-2 + 2^-6 |o|; dense: {plain_err:.3g})  ok")
    check(cos >= 0.995, f"prefill flash vs dense: min per-position logit cosine {cos}")
    log(f"  prefill logits through flash vs dense: min per-position cosine {cos:.6f} over {live} "
        f"live positions (dense with f32 attention vs dense: {yardstick:.6f})  ok")

    # four KV-cached steps, teacher-forced on the generated tokens, against
    # recomputing the whole prefix; logits, not tokens (bf16 near-ties)
    forced = torch.from_numpy(toks[:, :4].astype(np.int64)).to(dev)
    lengths = tm.sum(1)
    with torch.no_grad():
        decoder_forward(params, cfg, ti, tm, positions=positions, kv_cache=cache,
                        kv_valid=kv_valid)
        cached = []
        for t in range(4):
            kv_valid[:, l + t] = 1
            logits, _ = decoder_forward(
                params, cfg, forced[:, t : t + 1], torch.ones_like(forced[:, :1]),
                positions=(lengths + t)[:, None], kv_cache=cache, kv_valid=kv_valid,
                slot_offset=l + t,
            )
            cached.append(logits[:, 0])
        del cache
        full = torch.zeros((b, l + 4), dtype=torch.long, device=dev)
        fmask = torch.zeros_like(full)
        rows = torch.arange(b, device=dev)
        full[:, :l] = ti
        for t in range(4):
            full[rows, lengths + t] = forced[:, t]
        fmask[torch.arange(l + 4, device=dev)[None, :] < (lengths + 4)[:, None]] = 1
        logits, _ = decoder_forward(params, cfg, full, fmask)
        cos = min(logit_cosine(cached[t], logits[rows, lengths + t]) for t in range(4))
        del logits, cached
    # the cached steps take dense attention over the cache, the recompute
    # takes flash: the same bf16 drift as above
    check(cos >= 0.995, f"KV-cached steps vs recompute: min cosine {cos}")
    log(f"  4 KV-cached steps vs recomputing the prefix: min logit cosine {cos:.6f}  ok")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory {peak / 2**30:.2f} GiB [{card}]")
    del chat, params
    return {
        "launches": launches,
        "init_s": init_s,
        "prefill_tokens_per_s": prefill_rate,
        "decode_tokens_per_s": decode_rate,
        "peak_bytes": peak,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "pathway_tpu_torch")):
        print("chip_smoke: pathway_tpu_torch/ not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pathway_tpu_torch.ops.kernels import _build, flash_attention, knn_topk
    from pathway_tpu_torch.ops.kernels.flash_attention import reference_attention
    from pathway_tpu_torch.ops.kernels.knn_topk import reference_knn_topk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    log("[1] card")
    card = card_line()
    log(card)
    props = torch.cuda.get_device_properties(0)
    log(f"  {props}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("[2] build")
    _build.load()
    log(f"  kernels built and loaded in {_build.build_seconds:.1f} s")

    log("[3] kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    knn_row = check_knn(knn_topk, reference_knn_topk, gen)
    flash_row = check_flash(flash_attention, reference_attention, gen)
    decoder_shape = check_flash_decoder_shape(flash_attention, reference_attention)

    log("[4] main path: ingest, 2^20-row index, retrieval")
    docs = make_docs(N_DOCS, random.Random(0))
    knn_topk.launches = 0
    flash_attention.launches = 0
    run_main_path(docs)
    knn_row["launches"] = knn_topk.launches
    check(knn_topk.launches > 0, "main path launched no knn_topk kernel")
    log(f"  knn_topk launches on the main path: {knn_topk.launches}")

    log("[5] long documents through flash")
    knn_topk.launches = 0
    flash_attention.launches = 0
    run_long_docs()
    flash_row["launches"] = flash_attention.launches
    check(flash_attention.launches > 0, "long-document path launched no flash kernel")
    log(f"  flash_attention launches on the long-document path: {flash_attention.launches}")

    log("[6] the decoder at full Mistral-7B width")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    decoder = run_decoder(card, flash_attention)
    decoder_shape["launches"] = decoder["launches"]
    flash_row["shapes"] = [decoder_shape]
    log(f"  flash_attention launches on the decoder path (generate): {decoder['launches']}")
    log(f"  decoder phase {time.perf_counter() - t_phase:.1f} s")
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    log("[7] summary")
    log(card)
    log(json.dumps({"kernels": [knn_row, flash_row]}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
