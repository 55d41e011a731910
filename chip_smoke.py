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
     CUDA-event medians of kernel, plain and library-call times;
  4. main path: 16,384 bench-style docs ingested packed
     (FusedEmbedSearch.prepare_batch + dispatch_batch) and classic
     (embed_and_add), the index filled to 1,048,576 live rows on the device,
     32 doc texts retrieving their own key at rank 1 through
     DeviceKnnIndex.search_keys (knn_topk kernel) and
     FusedEmbedSearch.search_texts;
  5. long documents: SentenceEncoder(max_len=512) over 256 docs of L = 512,
     which takes the flash kernel, against the same encode without flash;
  6. the card's line, one `kernels` JSON line, then the `ok` JSON line.

Every check raises on failure, so a failed phase exits non-zero and prints
no `ok` line. Imports torch, numpy and pathway_tpu_torch only.
"""

from __future__ import annotations

import json
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
BF16_FLOPS = 989e12

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


def median_ms(fn, reps: int = 15) -> float:
    """CUDA-event median of `fn` over `reps` launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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
    # times at the main path's search shape: Q = 32 queries, k = 6, cos
    # (which reaches the kernel as ip on normalised queries)
    q = torch.randn((N_QUERIES, DIM), device="cuda", generator=gen)
    q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
    ms = median_ms(lambda: knn_topk(x, valid, q, K, metric="ip"))
    plain_ms = median_ms(lambda: reference_knn_topk(x, valid, q, K, metric="ip"))
    library_ms = median_ms(lambda: torch.topk(q @ x.T, K, dim=1))
    nbytes = x.numel() * 4 + valid.numel() + q.numel() * 4 + N_QUERIES * K * 8
    flops = 2.0 * N_QUERIES * N_INDEX * DIM
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    log(f"  knn_topk N={N_INDEX} d={DIM} Q={N_QUERIES} k={K}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, torch.topk(q @ x.T) {library_ms:.4f} ms, "
        f"bound {max(byte_ms, op_ms):.4f} ms")
    for qn, k in ((1, 6), (64, 128)):
        qq = torch.randn((qn, DIM), device="cuda", generator=gen)
        log(f"  knn_topk Q={qn} k={k}: kernel "
            f"{median_ms(lambda: knn_topk(x, valid, qq, k, metric='ip')):.4f} ms, plain "
            f"{median_ms(lambda: reference_knn_topk(x, valid, qq, k, metric='ip')):.4f} ms")
    del x, valid
    return {
        "name": "knn_topk",
        "route": "cuda",
        "source": "pathway_tpu_torch/ops/kernels/csrc/knn_topk.cu",
        "replaces": "pathway_tpu/ops/kernels/knn_topk.py:21",
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": library_ms,
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
    log(f"  flash_attention [{b},{h},{l},{d}] bf16: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms, "
        f"bound {max(byte_ms, op_ms):.4f} ms")
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
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    log("[6] summary")
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
