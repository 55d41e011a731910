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
     with a ragged mask, at the decoder prefill's [8, 32, 1024, 128], and
     at head dim 256, [1, 16, 2048, 256] causal);
  4. main path: 16,384 bench-style docs ingested packed
     (FusedEmbedSearch.prepare_batch + dispatch_batch) and classic
     (embed_and_add), the index filled to 1,048,576 live rows on the device,
     32 doc texts retrieving their own key at rank 1 through
     DeviceKnnIndex.search_keys (knn_topk kernel) and
     FusedEmbedSearch.search_texts;
  5. long documents: SentenceEncoder(max_len=512) over 256 docs of L = 512,
     which takes the flash kernel, against the same encode without flash;
     then the same docs through an f32 MiniLM-L6 (dtype float32), whose
     flash calls take the f32 instance flash_fwd_tf32x3<32> (6 a batch),
     against its own dense f32 encode (row cosine >= 0.99999);
  6. the decoder at full Mistral-7B width (hidden 4096, 32 layers, 32 q /
     8 kv heads, MLP 14336, vocab 32000, bf16, random weights from a
     seeded generator on the card): ChatModel("mistral-7b", max_len=2048)
     generates 32 tokens for 8 prompts of 700-1000 words, whose prefill
     takes the flash kernel at head dim 128; prefill through flash against
     the dense path, KV-cached steps against recomputing the prefix, and
     prefill and decode rates against their bounds;
  7. pipelined ingest: the JAX package's async DevicePipeline, ported
     (pathway_tpu_torch/internals/device_pipeline.py), over
     FusedEmbedSearch.prepare_batch / dispatch_batch for the same 16,384
     docs, beside the classic embed_and_add path, each into its own
     2^20-row index; both indexes retrieve each of 32 docs at rank 1 and
     agree on the top 6;
  8. the framework path on the card's host: the wordcount pipeline of
     benchmarks/wordcount_bench.py through `pathway_tpu_torch` (fs json
     read -> groupby(word).reduce(count) -> pw.io.csv.write) over
     1,000,000 rows in 8 files, checked against collections.Counter, and a
     streaming table (`__time__` / `__diff__`) -> pw.io.subscribe checked
     against its expected additions and retractions;
  9. the retrieval framework path, run before phase 8 so that the
     wordcount's engine, which `pw.run` keeps alive, does not weigh on it:
     (a) bench.py's framework path through `pathway_tpu_torch`: 16,384
     docs in 8 jsonlines files (streaming, one commit per file) ->
     DocumentStore -> BruteForceKnnFactory(SentenceTransformerEmbedder(
     max_len=64)) at full MiniLM-L6 width -> retrieve_query on a python
     connector subject, every default on: docs/s embedded+indexed (one
     run after a warm-up), p50 / p90 of 32 sequential queries and qps at
     64 concurrent ones, the live-utilization window's bound state and
     stage sums at the end of the ingest and the health controller's
     actions, the answers checked against
     FusedEmbedSearch.search_texts on the same index; (b) DocumentStore
     over a pw.udf embedder of seeded unit vectors (65,536 docs, the
     vector index impl, knn_topk), against a numpy brute force;
 10. the Private-RAG server, run after 9 and before 8: (a) 16,384
     bench-style docs in 8 jsonlines files -> DocumentStore ->
     BruteForceKnnFactory(SentenceTransformerEmbedder(max_len=64)) at full
     MiniLM-L6 width, answered by BaseRAGQuestionAnswerer(HFPipelineChat(
     ChatModel("mistral-7b", max_len=1024), max_new_tokens=32)) and served
     by QASummaryRestServer on 127.0.0.1 through run_server(threaded=True),
     every default on; RAGClient waits for /v1/statistics to count every
     doc, then sends 8 sequential /v2/answer with return_context_docs, 8
     concurrent ones, /v2/summarize, /v1/retrieve at k = 6 and 16 for each
     query and /v2/list_documents; each answer's context docs against
     /v1/retrieve's, each sequential answer against generate() on its
     prompt, whose prefill (over 256 tokens) takes the flash kernel at head
     dim 128, and the kernel on each layer's q / k / v of those prefills
     (each sequential prompt at batch 1, the concurrent ones as one batch
     of 8) against the plain version, as in phase 6; (b) CrossEncoderReranker() at full width on the card over
     each query's 16 candidates, through the engine, against the same
     weights on the CPU, and rerank_topk_filter's kept docs on both sides;
 12. the stdlib path, run after 10 and before 8: (a) Nexmark Q5 (hot
     items: sliding windows of 10 s every 5 s, the most-bid auctions of
     each), Q7 (highest bid: tumbling 10 s windows joined back to the
     bids) and Q8 (new users: a window_join of persons and auctions over
     tumbling 10 s windows) through `pw.temporal`, over 600,000 events at
     Apache Beam's NexmarkConfiguration defaults in 8 jsonlines files read
     by pw.io.jsonlines (static), each query's final table equal to the
     same query in plain Python, events/s per query; (b) `pw.ml` on the
     card: KNNIndex(distance_type="euclidean") and ("cosine") over 65,536
     seeded vectors of width 384, 32 queries in one engine batch, k = 6,
     ids and scores against numpy's exact answer (knn_topk's l2sq and cos
     modes through _KnnIndexImpl), then knn_lsh_classifier_train's
     labels against a numpy majority vote;
 13. operability on the card, run after 14 and before 8: (a) phase 9a's
     configuration (16,384 docs, the fused index, full MiniLM-L6 width) under
     pw.run(analysis="warn", with_http_server=True): PWT601 and no ERROR
     finding, the capacity plan judged against the card's total memory, its
     index and encoder bytes against memtrack's live entries (as many as
     predicted; the earlier phases' engines and model caches are dropped
     first, and none of their registrations may be left), and
     torch.cuda.memory_allocated()'s growth beside memtrack's sum (the gap
     is the encoder's bf16 compute copy); (b) while 9b's UDF-embedder
     DocumentStore serves queries (knn_topk), `python -m
     pathway_tpu_torch.cli profile --url` captures 2 s through the job's
     /profile twice (the first sets CUPTI up before its window): each
     window must hold answered queries and each Chrome trace
     knn_block_topk (its top 5 kernels
     printed), `status --json` must carry the second capture under
     utilization.profiler.last and a memory key, and `top --once` prints a
     frame; (c) `cli analyze --json` on a script whose DocumentStore
     reserves 2^26 rows at d = 384 (~103 GB): PWT603 against the card's
     capacity with nothing allocated, and `cli profile --device`, whose
     trace must hold the calibration matmul's GEMM; (d) flash gradients of
     q, k and v through the kernel against the CPU path's at [2, 4, 256, 64]
     f32 and bf16, causal and not, ragged mask (GRAD_TOL), and one launch a
     call under no_grad;
 14. the declarative path, run after 12 and before 13 and 8: (a) the
     demo-question-answering template's app.yaml (`qa_app_yaml`) loaded by
     pw.load_yaml at full width: 4,096 plaintext documents of 300-450
     words -> fs.read(binary, with_metadata) -> Utf8Parser ->
     TokenCountSplitter(300, 450) -> SentenceTransformerEmbedder(max_len=
     512), whose chunks take flash at head dim 32 -> BruteForceKnnFactory
     -> DocumentStore -> BaseRAGQuestionAnswerer(HFPipelineChat over
     ChatModel.cached("mistral-7b", max_len=4096)), whose prefills take
     flash at head dim 128, served by its build_server / run_server: 8
     sequential and 8 concurrent /v2/answer and /v1/retrieve, each
     sequential answer against generate() on the prompt the app built,
     /v1/retrieve against the index's search_texts, flash launches by
     instance; (b) pw.sql over pw.io.sqlite.read: a GROUP BY ... HAVING,
     a JOIN ... USING and a RANK() OVER (PARTITION BY ... ORDER BY ...)
     over a 1,000,000-row fact table and a 1,000-row dimension table,
     each result against sqlite3 running the same SQL on the same file;
     (c) pw.demo.replay_csv at 10^6 rows/s through a groupby into
     pw.io.subscribe, against plain Python;
 15. training and the model-parallel core, run after 14 and before 13:
     (a) make_train_step (lr 1e-3) at MiniLM-L6 width (vocab 30522, hidden
     384, 6 layers, 12 heads, MLP 1536, bf16), causal with pooling none and
     max_len 512, as the JAX package's multichip check configures it, 5
     steps on 16 texts of 512 tokens: step 1's loss and every gradient leaf
     through flash against dense attention, 6 flash_fwd_bf16<32> launches a
     step, the loss falling; ms a step, tokens/s, the step's bound and the
     backward's attention recompute's share; (b) make_sharded_train_step
     over a (dp = 2, tp = 2) mesh laid on the one card (["cuda:0"] * 4): the
     loss and every gathered new param against the unsharded step on the
     same params and batch, 24 launches a step; (c)
     sequence_parallel_forward at Mistral-7B geometry (hidden 4096, 32
     layers, 32 heads of 128, MLP 14336, vocab 32000, f32 weights drawn on
     the card) over an sp = 4 mesh on the one card, [1, 4096] with a padded
     tail, ring and Ulysses against the unsharded forward (row cosine >=
     0.999), Ulysses taking flash_fwd_bf16<128> 128 times and ring none, the
     peak memory under 1.5x the params (replication copies nothing); (d)
     flash at those shapes against the plain version and
     scaled_dot_product_attention;
 16. the data-plane mesh, run after 15 and before 13, on meshes laid on
     the one card: (a) phase 9a's workload under pw.run(mesh="dp=2,tp=2")
     inside with_mesh(get_mesh((2, 2), ("dp", "tp"), devices=["cuda:0"] *
     4)): the backend active for the run only, the DevicePipeline's 2
     replicas holding every doc, each answer against 9a's unsharded one
     (near-ties aside; scores within 2e-2), docs/s and p50 / p90 beside
     9a's, knn_topk once a shard a query batch; (b) DeviceKnnIndex over a
     ("knn",) mesh of 2 positions at 2^20 live rows of width 384 beside the
     unsharded index of the same rows: the same slots, the same sets at k =
     6 for 32 queries, knn_topk launched twice a batch, device ms of both;
     (c) the 7B decoder tensor-parallel over tp = 2 (decoder_tp_split),
     phase 6's prompts and 32 greedy tokens: prefill and every step's
     logits against the unsharded decoder over the same tokens (row
     cosine >= 0.999), flash_fwd_bf16<128> 64 times a prefill, ms a step
     beside phase 6's, the peak memory; (d) SentenceEncoder(mesh=dp 2)
     over phase 5's docs at L = 512 against the unsharded encode (row
     cosine >= 0.9999), flash_fwd_bf16<32> 12 times an encode; (e)
     parallel/multichip_checks.run_all(4, devices=["cuda:0"] * 4); then
     flash at a tp position's [8, 16, L, 128] and a dp position's [32, 12,
     512, 32];
 11. the card's line, one `kernels` JSON line (launches_by_path per phase,
     "operability", "declarative", phase 15's and "mesh" included), then
     the `ok` JSON line.

Phase 3 holds every flash instance: flash_fwd_bf16<16|32|64|128|256>
(wgmma + TMA; the serial schedule up to 64, ping-pong at 128 and 256) and
flash_fwd_tf32x3<16|32|64|128|256> (f32: each product in three tf32
passes on the tensor cores). It also holds the
two shape repairs: DeviceKnnIndex at dimensions 2, 3 and 6 (rows padded to
16 bytes for the kernel) against the same index on the CPU, and flash at
head dims 24, 48 and 80 (zero-padded to the next kernel instance) against
the plain version; and the head-dim 256 instances (head dims 160 and 200
padded to them) against the plain version, timed at [1, 16, 2048, 256]
causal beside scaled_dot_product_attention. At D = 128 and 256 it prints
the products' share of the tensor cores' peak beside the times. It times
the f32 instances too, flash_fwd_tf32x3<32> at [64, 12, 512, 32] and <256>
at [1, 16, 2048, 256] causal, beside the plain version and
scaled_dot_product_attention in f32, with their bound at three tf32
passes and the CUDA cores' f32 bound beside it.

Every check raises on failure, so a failed phase exits non-zero and prints
no `ok` line. Imports torch, numpy and pathway_tpu_torch only.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import queue
import random
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter

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
    # a small causal case and a non-causal one in f32, at the encoder's D
    # and at 16, the f32 instance that no model of this script reaches
    mf = torch.ones((2, 300), dtype=torch.int32, device="cuda")
    mf[1, 170:] = 0
    for df in (d, 16):
        qf, kf, vf = (
            torch.randn((2, 3, 300, df), device="cuda", generator=gen) for _ in range(3)
        )
        for causal in (True, False):
            e = live_rows_err(
                flash_attention(qf, kf, vf, mf, causal=causal),
                reference_attention(qf, kf, vf, mf, df ** -0.5, causal), mf,
            )
            check(e <= 1e-4, f"flash_attention f32 D={df} causal={causal}: error {e}")
            log(f"  flash_attention f32 [2,3,300,{df}] causal={causal}: max |err| {e:.3g}  ok")
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
        "instances": ["flash_fwd_bf16<16|32|64|128|256>", "flash_fwd_tf32x3<16|32|64|128|256>"],
        # the row's own times are bf16<32>'s; each f32 shape names its source
        "source": "pathway_tpu_torch/ops/kernels/csrc/flash_attention.cu",
        "sources": ["pathway_tpu_torch/ops/kernels/csrc/flash_attention.cu",
                    "pathway_tpu_torch/ops/kernels/csrc/flash_attention_f32.cu"],
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
    log(f"  flash_attention [{b},{h},{l},{d}] bf16 causal (flash_fwd_bf16<128>, ping-pong): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention(is_causal) "
        f"{library_ms:.4f} ms, bound {max(byte_ms, op_ms):.4f} ms (bytes {byte_ms:.4f}, bf16 "
        f"products {op_ms:.4f}), exp floor {pairs / EXP_PER_S * 1e3:.4f} ms; the products' share "
        f"of the tensor cores' peak {op_ms / ms:.3f} (SDPA {op_ms / library_ms:.3f})")
    return {
        "shape": [b, h, l, d],
        "causal": True,
        "max_abs_err": err,
        "ms": ms,
        "tensor_core_share": op_ms / ms,
        "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": library_ms,
    }


def check_padded_shapes(knn_topk, flash_attention, reference_attention) -> None:
    """The two shape repairs on the card. DeviceKnnIndex at dimensions 2,
    3 and 6, whose buffer rows are padded to 4 columns for the kernel's
    16-byte TMA rows, against the same index on the CPU (the plain
    version), scores atol 1e-4 plus rtol 1e-5; and flash at head dims 24,
    48 and 80, zero-padded to 32, 64 and 128, against the plain version at
    the true head dim (bf16 2e-2, f32 1e-4 on rows with a live key)."""
    from pathway_tpu_torch.ops.kernels.flash_attention import padded_head_dim
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    rng = np.random.default_rng(6)
    errs = []
    for d in (2, 3, 6):
        for metric in ("cos", "ip", "l2sq"):
            data = rng.standard_normal((5000, d)).astype(np.float32)
            queries = data[:32] + 0.01 * rng.standard_normal((32, d)).astype(np.float32)
            on_card = DeviceKnnIndex(d, metric=metric, reserved_space=8192)
            on_cpu = DeviceKnnIndex(d, metric=metric, reserved_space=8192, device="cpu")
            for idx, vecs in ((on_card, torch.from_numpy(data).cuda()), (on_cpu, data)):
                idx.add_batch(range(len(data)), vecs)
                idx.remove(17)
            before = knn_topk.launches
            got, _, _ = on_card.search(queries, K)
            check(knn_topk.launches == before + 1, f"index d={d}: knn_topk not launched")
            want, _, _ = on_cpu.search(queries, K)
            err = float(np.abs(np.sort(got, 1) - np.sort(want, 1)).max())
            check(err <= 1e-4 + 1e-5 * float(np.abs(want).max()),
                  f"DeviceKnnIndex d={d} {metric}: score error {err}")
            check(tuple(on_card.device_buffer.shape) == (8192, d),
                  f"DeviceKnnIndex d={d}: device_buffer is not [capacity, d]")
            errs.append(err)
        log(f"  DeviceKnnIndex d={d} (rows padded to {-(-d // 4) * 4} columns), 5000 rows, "
            f"Q=32, k={K}, cos / ip / l2sq on the card vs the CPU index: max |score err| "
            f"{max(errs[-3:]):.3g}  ok")
    gen = torch.Generator(device="cuda").manual_seed(7)
    for d in (24, 48, 80):
        for dtype, causal, tol in ((torch.bfloat16, False, 2e-2), (torch.bfloat16, True, 2e-2),
                                   (torch.float32, True, 1e-4)):
            q, k, v = (
                torch.randn((4, 8, 512, d), device="cuda", generator=gen).to(dtype)
                for _ in range(3)
            )
            lens = torch.randint(1, 513, (4,), device="cuda", generator=gen)
            mask = (torch.arange(512, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
            before = flash_attention.launches
            out = flash_attention(q, k, v, mask, causal=causal)
            check(flash_attention.launches == before + 1, f"flash D={d}: kernel not launched")
            check(out.shape == q.shape and out.is_contiguous(), f"flash D={d}: bad output")
            e = live_rows_err(out, reference_attention(q, k, v, mask, d ** -0.5, causal), mask)
            check(e <= tol, f"flash_attention D={d} {dtype} causal={causal}: error {e}")
            errs.append(e)
        log(f"  flash_attention D={d} (the D={padded_head_dim(d)} kernel) [4,8,512,{d}] vs plain: "
            f"max |err| on live rows bf16 {max(errs[-3:-1]):.3g}, f32 causal {errs[-1]:.3g}  ok")


def check_flash_d256(flash_attention, reference_attention) -> dict:
    """Flash at head dim 256 (bf16: flash_fwd_bf16<256>, wgmma + TMA with
    the ping-pong schedule; f32: flash_fwd_tf32x3<256>) and at 160 and
    200 through the padding, against the plain version on rows with a live
    key (bf16 2e-2, f32 1e-4, the other instances' tolerances), then its
    time at gemma-7b's attention geometry [1, 16, 2048, 256] causal bf16
    beside scaled_dot_product_attention(is_causal=True), the bound and the
    products' share of the tensor cores' peak. Its own generator, so the
    draws of the other checks stay as they were."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(9)
    cases = [
        (2, 4, 300, 300, 256, torch.bfloat16, True),
        (2, 4, 300, 300, 256, torch.bfloat16, False),
        (2, 2, 1, 77, 256, torch.bfloat16, False),
        (2, 4, 300, 300, 160, torch.bfloat16, True),
        (2, 4, 300, 300, 200, torch.bfloat16, False),
        (2, 3, 130, 301, 256, torch.float32, True),
    ]
    err = 0.0
    for b, h, lq, lk, d, dtype, causal in cases:
        q, k, v = (
            torch.randn((b, h, n, d), device="cuda", generator=gen).to(dtype) for n in (lq, lk, lk)
        )
        lens = torch.randint(1, lk + 1, (b,), device="cuda", generator=gen)
        mask = (torch.arange(lk, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
        before = flash_attention.launches
        out = flash_attention(q, k, v, mask, causal=causal)
        check(flash_attention.launches == before + 1, f"flash D={d}: kernel not launched")
        check(out.shape == q.shape and out.is_contiguous(), f"flash D={d}: bad output")
        e = live_rows_err(out, reference_attention(q, k, v, mask, d ** -0.5, causal), mask)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        check(e <= tol, f"flash_attention [{b},{h},{lq}/{lk},{d}] {dtype} causal={causal}: "
                        f"error {e}")
        kernel = "flash_fwd_tf32x3<256>" if dtype == torch.float32 else "flash_fwd_bf16<256>"
        log(f"  flash_attention D={d} ({kernel}) [{b},{h},{lq}/{lk},{d}] "
            f"{str(dtype).split('.')[-1]} causal={causal}: max |err| on live rows {e:.3g}  ok")
        if dtype == torch.bfloat16:
            err = max(err, e)
    b, h, l, d = 1, 16, 2048, 256
    q, k, v = (torch.randn((b, h, l, d), device="cuda", generator=gen).bfloat16() for _ in range(3))
    mask = torch.ones((b, l), dtype=torch.int32, device="cuda")
    scale = d ** -0.5
    e = live_rows_err(flash_attention(q, k, v, mask, causal=True),
                      reference_attention(q, k, v, mask, scale, True), mask)
    check(e <= 2e-2, f"flash_attention [{b},{h},{l},{d}] bf16 causal: error {e}")
    err = max(err, e)
    ms = median_ms(lambda: flash_attention(q, k, v, mask, causal=True))
    plain_ms = median_ms(lambda: reference_attention(q, k, v, mask, scale, True))
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    pairs = b * h * l * (l + 1) / 2
    nbytes = 4 * q.numel() * 2 + mask.numel() * 4
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, 4.0 * pairs * d / BF16_FLOPS * 1e3
    log(f"  flash_attention [{b},{h},{l},{d}] bf16 causal (gemma-7b's attention, "
        f"flash_fwd_bf16<256>, ping-pong): max |err| {e:.3g}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, scaled_dot_product_attention(is_causal) {library_ms:.4f} ms, bound "
        f"{max(byte_ms, op_ms):.4f} ms (bytes {byte_ms:.4f}, bf16 products {op_ms:.4f}); the "
        f"products' share of the tensor cores' peak {op_ms / ms:.3f} (SDPA "
        f"{op_ms / library_ms:.3f})")
    return {
        "shape": [b, h, l, d],
        "causal": True,
        "max_abs_err": err,
        "ms": ms,
        "tensor_core_share": op_ms / ms,
        "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": library_ms,
    }


def time_flash_f32(flash_attention, reference_attention) -> list:
    """The f32 instance's times (flash_fwd_tf32x3<D>, each product in
    three tf32 passes on the tensor cores), CUDA-event medians beside the
    plain version and scaled_dot_product_attention in f32 (TF32 is off in
    this script): at the encoder's [64, 12, 512, 32] with every key live,
    as phase 5's f32 encode calls it (its 520-word docs fill L = 512), and
    at [1, 16, 2048, 256] causal. The bound is the larger of the bytes at
    3.35 TB/s and the products that these inputs need (every pair, or L (L
    + 1) / 2 a head when causal), three tf32 passes at 495 TFLOP/s (an
    effective 165); the CUDA cores' f32 bound (67 TFLOP/s), the units of
    the designs it replaced, is printed beside it. Each shape is first
    held to the plain version (f32 1e-4 on rows with a live key), the
    encoder's on a ragged mask with 1 to 512 live keys a row. Its own
    generator."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for b, h, l, d, causal in ((64, 12, 512, 32, False), (1, 16, 2048, 256, True)):
        kernel = f"flash_fwd_tf32x3<{d}>"
        q, k, v = (torch.randn((b, h, l, d), device="cuda", generator=gen) for _ in range(3))
        mask = torch.ones((b, l), dtype=torch.int32, device="cuda")
        if causal:
            checked = mask
        else:
            lens = torch.randint(1, l + 1, (b,), device="cuda", generator=gen)
            checked = (torch.arange(l, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
        scale = d ** -0.5
        e = live_rows_err(flash_attention(q, k, v, checked, causal=causal),
                          reference_attention(q, k, v, checked, scale, causal), checked)
        check(e <= 1e-4, f"flash_attention f32 [{b},{h},{l},{d}] causal={causal}: error {e}")
        if not causal:  # and on the timed inputs, every key live
            e = max(e, live_rows_err(flash_attention(q, k, v, mask),
                                     reference_attention(q, k, v, mask, scale, False), mask))
            check(e <= 1e-4, f"flash_attention f32 [{b},{h},{l},{d}] all keys live: error {e}")
        ms = median_ms(lambda: flash_attention(q, k, v, mask, causal=causal))
        plain_ms = median_ms(lambda: reference_attention(q, k, v, mask, scale, causal))
        if causal:
            library_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
            pairs = b * h * l * (l + 1) / 2
        else:
            keep = mask.bool()[:, None, None, :]
            library_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep))
            pairs = b * h * l * l
        nbytes = 4 * q.numel() * 4 + mask.numel() * 4
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = 3 * 4.0 * pairs * d / TF32_FLOPS * 1e3  # three tf32 passes
        f32_ms = 4.0 * pairs * d / F32_FLOPS * 1e3
        bound_ms = max(byte_ms, op_ms)
        log(f"  flash_attention [{b},{h},{l},{d}] f32 causal={causal}"
            f"{'' if causal else ', timed with every key live'} ({kernel}): max |err| "
            f"{e:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention "
            f"f32 {library_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes {byte_ms:.4f}, products in "
            f"three tf32 passes at 495 TFLOP/s {op_ms:.4f}; on the f32 CUDA cores at 67 TFLOP/s "
            f"{f32_ms:.4f}); share of the bound {bound_ms / ms:.3f} (SDPA {bound_ms / library_ms:.3f})")
        rows.append({
            "instance": kernel,
            "source": "pathway_tpu_torch/ops/kernels/csrc/flash_attention_f32.cu",
            "shape": [b, h, l, d],
            "dtype": "float32",
            "causal": causal,
            "max_abs_err": e,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "bound_share": bound_ms / ms,
            "f32_cuda_core_bound_ms": max(byte_ms, f32_ms),
            "library_ms": library_ms,
            "launches": 0,  # phase 5's f32 encode fills in the first
        })
    return rows


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


def run_long_docs(flash_attention) -> dict:
    """Phase 5: 256 docs at L = 512 through MiniLM-L6 in bf16 (flash
    bf16<32>), each batch against the same encode without flash; then the
    same docs through an f32 MiniLM-L6 (TransformerConfig.dtype float32,
    the same seed), whose flash calls take flash_fwd_tf32x3<32>: 6 launches
    a batch of 64, each row's cosine against its dense f32 encode >=
    0.99999, docs/s beside the bf16 encode's. The cosine shows that the
    encode runs through the kernel soundly; it cannot tell three tf32
    passes from one (one pass errs ~1.5e-3 in the attention, ~1e-6 in the
    pooled cosine). The kernel's f32 accuracy is held in phase 3, at 1e-4
    at this shape (time_flash_f32). The largest |difference| of the
    embeddings is logged. Returns the f32 launches."""
    import dataclasses

    from pathway_tpu_torch.models.minilm import SentenceEncoder
    from pathway_tpu_torch.models.tokenizer import encode_batch
    from pathway_tpu_torch.models.transformer import MINILM_L6

    docs = make_docs(256, random.Random(3), words=520)
    batches = [docs[s : s + 64] for s in range(0, len(docs), 64)]
    rates = {}
    f32_launches = 0
    for dtype, floor in (("bfloat16", 0.999), ("float32", 0.99999)):
        encoder = SentenceEncoder(
            "all-MiniLM-L6-v2", config=dataclasses.replace(MINILM_L6, dtype=dtype), max_len=512,
            seed=0,
        )
        before = flash_attention.launches_by_instance.get("f32<32>", 0)
        t0 = time.perf_counter()
        vecs = [encoder.encode(batch) for batch in batches]
        rates[dtype] = len(docs) / (time.perf_counter() - t0)
        launched = flash_attention.launches_by_instance.get("f32<32>", 0) - before
        worst, diff = 1.0, 0.0
        for batch, got in zip(batches, vecs):
            ids, mask = encode_batch(encoder.tokenizer, batch, max_len=512)
            check(ids.shape == (64, 512), f"long docs bucketed to {ids.shape}, not (64, 512)")
            dense = encoder.lm(ids, mask, use_flash=False)[: len(batch)].cpu().numpy()
            check(np.isfinite(got).all() and got.shape == (64, DIM), "long-doc encode: bad output")
            worst = min(worst, float(cosine_rows(got, dense).min()))
            diff = max(diff, float(np.abs(got - dense).max()))
        check(worst >= floor, f"{dtype} flash vs dense encode: min cosine {worst}")
        if dtype == "float32":
            check(launched == 6 * len(batches),
                  f"f32 encode: flash f32<32> launched {launched} times, not {6 * len(batches)}")
            f32_launches = launched
        log(f"  {len(docs)} docs at L=512, {dtype}: {rates[dtype]:.1f} docs/s; flash vs dense "
            f"per-row cosine >= {worst:.7f}, max |diff| {diff:.3g}; flash f32<32> launches "
            f"{launched}  ok")
        del encoder
    log(f"  the f32 encode at {rates['float32'] / rates['bfloat16']:.3f}x the bf16 encode's docs/s")
    return {"f32_launches": f32_launches, "docs_per_s": rates}


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


def f32_attention(q, k, v, m, causal, use_flash):
    """The plain attention in f32, in the decoder's attention signature."""
    from pathway_tpu_torch.ops.kernels.flash_attention import reference_attention

    scale = 1.0 / math.sqrt(q.shape[-1])
    return reference_attention(q.float(), k.float(), v.float(), m, scale, causal).to(q.dtype)


def flash_probe(flash_attention, per_layer: list):
    """A stand-in for the decoder's attention: on each layer's own q / k /
    v it runs the kernel and the plain version, appends to `per_layer`
    (the kernel's min row cosine to the plain output, its max |err|
    against f32 attention, that error over its tolerance 2e-2 + 2^-6 |o|,
    the plain output's max |err| against f32) and returns the plain
    output. Held by `check_probed_layers`."""
    from pathway_tpu_torch.ops.kernels.flash_attention import reference_attention

    def probe(q, k, v, m, causal, use_flash):
        want = reference_attention(q, k, v, m, 1.0 / math.sqrt(q.shape[-1]), causal)
        got = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), m, causal=causal)
        check(bool(torch.isfinite(got.float()).all()), "flash_attention: non-finite output")
        exact = f32_attention(q, k, v, m, causal, False).float()
        err = (got.float() - exact).abs()
        per_layer.append((logit_cosine(got, want), err.max().item(),
                          (err / (2e-2 + 2.0 ** -6 * exact.abs())).max().item(),
                          (want.float() - exact).abs().max().item()))
        return want

    return probe


def check_probed_layers(per_layer: list, n_layers: int, what: str) -> tuple:
    """Every probed layer within the kernel's tolerance: row cosine >= 0.999
    to the plain version and |err| <= 2e-2 + 2^-6 |o| against f32.
    Returns (min cosine, max |err|, max share of the tolerance, the plain
    version's max |err|)."""
    check(len(per_layer) == n_layers, f"{what}: probed {len(per_layer)} layers, not {n_layers}")
    layer_cos = min(c for c, _, _, _ in per_layer)
    layer_err = max(e for _, e, _, _ in per_layer)
    layer_tol = max(r for _, _, r, _ in per_layer)
    plain_err = max(p for _, _, _, p in per_layer)
    check(layer_cos >= 0.999 and layer_tol <= 1.0,
          f"{what}: flash per layer: min row cosine to dense {layer_cos}, max |err| against f32 "
          f"attention {layer_err} ({layer_tol:.3f} of its tolerance)")
    return layer_cos, layer_err, layer_tol, plain_err


def run_decoder(card: str, flash_attention) -> dict:
    from pathway_tpu_torch.models import decoder as decoder_module
    from pathway_tpu_torch.models.decoder import decoder_forward, generate_tokens, init_kv_cache
    from pathway_tpu_torch.models.decoder_lm import ChatModel

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

    per_layer = []
    with torch.no_grad():
        flash_logits = prefill(use_flash=True)
        with decoder_attention(decoder_module, flash_probe(flash_attention, per_layer)):
            dense_logits = prefill()
        with decoder_attention(decoder_module, f32_attention):
            f32_logits = prefill()
        cos = logit_cosine(flash_logits, dense_logits)
        yardstick = logit_cosine(f32_logits, dense_logits)
        del flash_logits, dense_logits, f32_logits
    layer_cos, layer_err, layer_tol, plain_err = check_probed_layers(
        per_layer, cfg.layers, "prefill")
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


# -- phase 7: pipelined ingest on the card --------------------------------------


def _fill_to_index_size(index, seed: int) -> None:
    """Random rows from a seeded generator on the card up to N_INDEX live
    rows (the same rows for the same seed)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fill = N_INDEX - len(index)
    step = 1 << 17
    for s in range(0, fill, step):
        n = min(step, fill - s)
        vecs = torch.randn((n, DIM), device="cuda", generator=gen)
        index.add_batch(range(N_DOCS + s, N_DOCS + s + n), vecs)
    check(len(index) == N_INDEX and index.capacity == N_INDEX, "index not at 2^20 live rows")


def run_pipelined_ingest(card: str, docs) -> dict:
    """The same docs through the async DevicePipeline (worker-thread
    tokenize + pack, double-buffered dispatch) and through the classic
    synchronous embed_and_add, each into its own index, as bench.py
    measures them. Both are then filled to 2^20 rows with the same random
    rows and searched with the same 32 doc embeddings."""
    from pathway_tpu_torch.internals.device_pipeline import DevicePipeline
    from pathway_tpu_torch.models.minilm import SentenceEncoder
    from pathway_tpu_torch.ops.kernels import flash_attention, knn_topk
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex, FusedEmbedSearch

    encoder = SentenceEncoder("all-MiniLM-L6-v2", max_len=64, seed=0)
    chunk = N_DOCS // N_CHUNKS

    def fresh():
        index = DeviceKnnIndex(encoder.dimension, metric="cos", reserved_space=N_DOCS)
        return index, FusedEmbedSearch(encoder, index)

    classic_index, classic = fresh()
    classic.embed_and_add(range(chunk), docs[:chunk])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, N_DOCS, chunk):
        classic.embed_and_add(range(s, s + chunk), docs[s : s + chunk])
    torch.cuda.synchronize()
    classic_rate = N_DOCS / (time.perf_counter() - t0)

    pipe_index, fused = fresh()
    pipe = DevicePipeline(
        prepare=lambda item: fused.prepare_batch(*item),
        dispatch=fused.dispatch_batch,
        quiesce=torch.cuda.synchronize,
        name="chip-smoke-ingest",
    )
    try:
        pipe.submit((range(chunk), docs[:chunk]))  # warm-up
        pipe.drain()
        pipe.take_aux_spans()  # the warm-up's
        t0 = time.perf_counter()
        for s in range(0, N_DOCS, chunk):
            pipe.submit((range(s, s + chunk), docs[s : s + chunk]))
        pipe.drain()
        pipe_rate = N_DOCS / (time.perf_counter() - t0)
        stats = pipe.stats()
        # where the pipelined run's time went: host seconds per stage, summed
        # over batches (prep runs on two threads, so its sum can exceed the wall)
        spent: Counter = Counter()
        for kind, _start, dur, _rows in pipe.take_aux_spans():
            spent[kind] += dur
    finally:
        pipe.close()
    check(stats["submitted"] == stats["dispatched"] == N_CHUNKS + 1 and not pipe.take_failed(),
          f"pipeline: {stats}")
    check(len(pipe_index) == len(classic_index) == N_DOCS, "pipelined / classic index sizes")
    ingest_launches = {"knn_topk": knn_topk.launches, "flash_attention": flash_attention.launches}
    log(f"  ingest {N_DOCS} docs (max_len 64): DevicePipeline {pipe_rate:.1f} docs/s "
        f"(packed slabs, pad_waste_ratio {stats['pad_waste_ratio']:.4f}), classic embed_and_add "
        f"{classic_rate:.1f} docs/s [{card}]")
    log("  DevicePipeline stage sums over the timed run (host s): " + ", ".join(
        f"{kind.split(':')[1]} {spent[kind]:.4f}"
        for kind in ("pipeline:prep", "pipeline:dispatch", "pipeline:wait", "pipeline:device",
                     "pipeline:drain")
    ) + f"; wall {N_DOCS / pipe_rate:.4f}")

    # the two ingest routes embed the same docs in bf16, packed and padded:
    # their vectors agree to a rounding, not bit for bit
    pipe_rows, classic_rows = (
        idx.device_buffer[[idx._slot_of_key[k] for k in range(N_DOCS)]]
        for idx in (pipe_index, classic_index)
    )
    cos = torch.nn.functional.cosine_similarity(pipe_rows, classic_rows, dim=1)
    check(float(cos.min()) >= 0.99, f"pipelined vs classic doc vectors: min cosine {cos.min()}")
    for index in (pipe_index, classic_index):
        _fill_to_index_size(index, seed=2)
    picks = random.Random(7).sample(range(N_DOCS), N_QUERIES)
    queries = encoder.encode([docs[i] for i in picks])
    got = pipe_index.search_keys(queries, K)
    want = classic_index.search_keys(queries, K)
    # a swap in the top-k is a near-tie when its scores lie within twice the
    # largest score drift between the two routes' doc vectors (over every
    # query and doc), plus the kernel's f32 rounding
    qn = torch.nn.functional.normalize(torch.as_tensor(queries, device="cuda").float(), dim=1)
    drift = float((qn @ (torch.nn.functional.normalize(pipe_rows.float(), dim=1)
                         - torch.nn.functional.normalize(classic_rows.float(), dim=1)).T).abs().max())
    tie_tol = 2 * drift + 1e-5
    exact = 0
    for r, (g, w, pick) in enumerate(zip(got, want, picks)):
        check(g[0][0] == pick and w[0][0] == pick, f"query {r}: not its own doc at rank 1")
        gk, wk = {k for k, _ in g}, {k for k, _ in w}
        kth = min(w[-1][1], g[-1][1])
        swapped = [s for k, s in g if k not in wk] + [s for k, s in w if k not in gk]
        check(all(abs(s - kth) <= tie_tol for s in swapped),
              f"query {r}: top-{K} keys differ beyond near-ties: {g} vs {w}")
        exact += [k for k, _ in g] == [k for k, _ in w]
    log(f"  over {N_INDEX} rows: {N_QUERIES}/{N_QUERIES} self-retrievals at rank 1 in both; "
        f"top-{K} keys equal in {exact}/{N_QUERIES} rows in order, the rest within near-ties "
        f"of {tie_tol:.3g} (pipelined vs classic doc vectors: min cosine {float(cos.min()):.6f}, "
        f"largest score drift {drift:.3g})  ok")
    return {"pipelined_docs_per_s": pipe_rate, "classic_docs_per_s": classic_rate,
            "pad_waste_ratio": stats["pad_waste_ratio"], "ingest_launches": ingest_launches}


# -- phase 9: the retrieval framework path -------------------------------------

N_UDF_DOCS = 65536


class _PhaseThread(threading.Thread):
    """A daemon thread that keeps the exception its target raised."""

    def __init__(self, target, args):
        super().__init__(daemon=True)
        self._fn, self._args, self.error = target, args, None

    def run(self) -> None:
        try:
            self._fn(*self._args)
        except BaseException as exc:  # noqa: BLE001 — re-raised by _get
            self.error = exc


def _get(q: queue.Queue, runner: _PhaseThread, timeout: float = 300.0):
    """q.get that fails at once if the engine's thread died."""
    deadline = time.perf_counter() + timeout
    while True:
        try:
            return q.get(timeout=0.5)
        except queue.Empty:
            if runner.error is not None:
                raise RuntimeError("the framework pipeline failed") from runner.error
            check(runner.is_alive(), "the framework pipeline stopped without an answer")
            check(time.perf_counter() < deadline, f"no answer within {timeout} s")


def _serve_store(pw, store, query_q, resp_q, count_q, run_kwargs=None) -> None:
    """retrieve_query on queries from a python connector subject fed by
    `query_q` (None closes it), answers into `resp_q` and the ingested doc
    count into `count_q`, each with its time; then pw.run."""
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore

    class QuerySubject(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            while True:
                item = query_q.get()
                if item is None:
                    return
                self.next(**item)
                self.commit()

    queries = pw.io.python.read(QuerySubject(), schema=DocumentStore.RetrieveQuerySchema)
    clock = time.perf_counter  # the callbacks' `time` argument shadows the module

    def on_result(key, row, time, is_addition):  # noqa: A002
        if is_addition:
            resp_q.put((clock(), row["result"]))

    pw.io.subscribe(store.retrieve_query(queries), on_change=on_result)

    # ingest progress from the engine itself: no device sync mid-ingest
    def on_count(key, row, time, is_addition):  # noqa: A002
        if is_addition:
            count_q.put((clock(), row["c"]))

    pw.io.subscribe(store.chunked_docs.groupby().reduce(c=pw.reducers.count()), on_change=on_count)
    pw.run(autocommit_duration_ms=25, monitoring_level=pw.MonitoringLevel.NONE,
           **(run_kwargs or {}))


def _retrieval_pipeline(docs_path: str, n_docs: int, query_q, resp_q, count_q, device,
                        run_kwargs=None) -> None:
    """bench.py's run_pipeline through pathway_tpu_torch: jsonlines files
    (streaming, one commit per file) -> DocumentStore over
    BruteForceKnnFactory(SentenceTransformerEmbedder) -> retrieve_query on
    queries from a python connector subject."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    pw.G.clear()
    docs = pw.io.jsonlines.read(
        docs_path,
        schema=pw.schema_from_types(data=str),
        mode="streaming",
        batch_per_file=True,
        refresh_interval=3600.0,  # every file exists up front
    )
    embedder = SentenceTransformerEmbedder(max_len=64, device=device)
    factory = BruteForceKnnFactory(
        dimensions=embedder.get_embedding_dimension(), embedder=embedder, reserved_space=n_docs
    )
    store = DocumentStore(docs, retriever_factory=factory)
    _serve_store(pw, store, query_q, resp_q, count_q, run_kwargs)


def _ask(query_q, resp_q, runner, text: str):
    query_q.put({"query": text, "k": K, "metadata_filter": None, "filepath_globpattern": None})
    return _get(resp_q, runner, timeout=120.0)


def _drive_retrieval(docs, docs_path: str, device, run_kwargs=None) -> dict:
    """bench.py's _drive: one streaming run. docs/s is the docs over the
    time from the engine's start to the answer of a probe query for the
    last doc; then 32 sequential queries, each its own engine batch, and
    64 concurrent ones. run_kwargs go to pw.run."""
    from pathway_tpu_torch.internals import mesh_backend, utilization
    from pathway_tpu_torch.internals import runner as pw_runner

    query_q: queue.Queue = queue.Queue()
    resp_q: queue.Queue = queue.Queue()
    count_q: queue.Queue = queue.Queue()
    t_start = time.perf_counter()
    runner = _PhaseThread(
        _retrieval_pipeline, (docs_path, len(docs), query_q, resp_q, count_q, device, run_kwargs)
    )
    runner.start()
    while True:
        t_counted, count = _get(count_q, runner)
        if count >= len(docs):
            break
    t_ingested, result = _ask(query_q, resp_q, runner, docs[-1])
    window = utilization.tracker().snapshot()  # the ingest's bound state
    backend = mesh_backend.active_backend()  # the run's, while it runs
    top = result.value[0] if result.value else None
    check(top is not None and top["text"] == docs[-1],
          f"the probe query for the last doc found {top} at rank 1")
    queries = make_docs(N_QUERIES, random.Random(11))
    lat, answers = [], []
    for q in queries:
        tq = time.perf_counter()
        t_resp, res = _ask(query_q, resp_q, runner, q)
        lat.append((t_resp - tq) * 1000)
        answers.append(res.value)
    # the health controller as the sequential queries left it
    from pathway_tpu_torch.internals import health

    throttle = {k: health.controller().status()[k] for k in ("throttle_delay_s", "backpressure_scale")}
    n_concurrent = 64
    tq0 = time.perf_counter()
    for q in make_docs(n_concurrent, random.Random(17)):
        query_q.put({"query": q, "k": K, "metadata_filter": None, "filepath_globpattern": None})
    last = tq0
    for _ in range(n_concurrent):
        last, _ = _get(resp_q, runner, timeout=120.0)
    qps = n_concurrent / max(last - tq0, 1e-9)
    query_q.put(None)  # closes the query subject
    engine = pw_runner.last_engine()  # the docs source streams on: stop it
    engine.terminate_flag.set()
    runner.join(timeout=60)
    check(not runner.is_alive() and runner.error is None, f"pipeline end: {runner.error!r}")
    return {"docs_per_s": len(docs) / (t_ingested - t_start),
            "counted_s": t_counted - t_start, "probe_s": t_ingested - t_counted,
            "p50_ms": float(np.percentile(lat, 50)), "p90_ms": float(np.percentile(lat, 90)),
            "qps_64": qps, "queries": queries, "answers": answers, "engine": engine,
            "window": window, "backend": backend, "throttle": throttle}


def _direct_query_ms(impl, queries) -> float:
    """p50 ms of the index's own search_texts, one query a call, outside
    the engine (each call ends in its host copy)."""
    impl.fused.search_texts(queries[:1], K)
    times = []
    for q in queries:
        t0 = time.perf_counter()
        impl.fused.search_texts([q], K)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(times, 50))


def _index_node(engine):
    from pathway_tpu_torch.engine.index_node import ExternalIndexNode

    (node,) = [n for n in engine.nodes if isinstance(n, ExternalIndexNode)]
    return node


def _write_docs(docs, tmp: str) -> str:
    """bench.py's input: {"data": doc} json lines in N_CHUNKS files."""
    docs_path = os.path.join(tmp, "docs")
    os.makedirs(docs_path)
    per_file = len(docs) // N_CHUNKS
    for f in range(N_CHUNKS):
        with open(os.path.join(docs_path, f"docs_{f:03d}.jsonl"), "w") as fh:
            for d in docs[f * per_file : (f + 1) * per_file]:
                fh.write(json.dumps({"data": d}) + "\n")
    return docs_path


def rankings_agree(got_rows, want_rows, k: int, what: str) -> tuple:
    """Two routes' top-k answers, each a list per query of (text, score):
    the same top-k, but for swaps that are near-ties, whose scores lie
    within twice the largest score drift between the two routes (over
    every doc both returned), plus f32 rounding, of the k-th score.
    Returns (answers equal in order, drift, the near-tie tolerance)."""
    drift, exact = 0.0, 0
    for got, want in zip(got_rows, want_rows):
        check(len(got) == len(want) == k, f"{what}: {len(got)} / {len(want)} answers, k = {k}")
        want_score = dict(want)
        drift = max([drift] + [abs(s - want_score[t]) for t, s in got if t in want_score])
    tie_tol = 2 * drift + 1e-5
    for r, (got, want) in enumerate(zip(got_rows, want_rows)):
        gk, wk = {t for t, _ in got}, {t for t, _ in want}
        kth = min(got[-1][1], want[-1][1])
        swapped = [s for t, s in got if t not in wk] + [s for t, s in want if t not in gk]
        check(all(abs(s - kth) <= tie_tol for s in swapped),
              f"query {r}: top-{k} differs from {what} beyond near-ties: {got} vs {want}")
        exact += [t for t, _ in got] == [t for t, _ in want]
    return exact, drift, tie_tol


def agrees_with_search_texts(answers, direct, node, k: int) -> tuple:
    """The engine's answers (lists of {"text", "score"}) against
    FusedEmbedSearch.search_texts on the same index ((key, score) lists;
    `node` maps a key to its text), by `rankings_agree`."""
    text_of = {key: row[0] for key, row in node.data_rows.items()}
    return rankings_agree(
        [[(d["text"], d["score"]) for d in ans] for ans in answers],
        [[(text_of[key], score) for key, score in row] for row in direct],
        k, "search_texts",
    )


def run_framework_retrieval(card: str, n_docs: int = N_DOCS, device=None) -> dict:
    """9a: bench.py's framework path through pathway_tpu_torch, every
    default on: a warm-up run, bench.py's collect-and-freeze, then the
    measured run with the live-utilization window scoped to it (as
    bench.py scopes its measured phases), so its bound state and the
    health controller's actions read this run alone. Its answers are
    checked against FusedEmbedSearch.search_texts on its index."""
    from pathway_tpu_torch.internals import health, utilization
    from pathway_tpu_torch.internals import runner as pw_runner
    from pathway_tpu_torch.internals.device_probe import device_degraded
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import _FusedKnnIndexImpl

    docs = make_docs(n_docs, random.Random(7))
    with tempfile.TemporaryDirectory() as tmp:
        docs_path = _write_docs(docs, tmp)
        warm = _drive_retrieval(docs, docs_path, device)
        del warm
        pw_runner._last_engine = None
        # as bench.py: the warm-up's dead objects collected once and the
        # survivors kept out of later collections
        gc.collect()
        gc.freeze()
        try:
            utilization.reset_window()
            actions = dict(health.controller().status()["actions"])
            facts = _drive_retrieval(docs, docs_path, device)
            after = health.controller().status()["actions"]
            throttles = after["throttle"] - actions["throttle"]
            relaxes = after["relax"] - actions["relax"]
        finally:
            gc.unfreeze()
    node = _index_node(facts["engine"])
    impl = node.index
    check(isinstance(impl, _FusedKnnIndexImpl), f"the index impl is {type(impl).__name__}")
    check(len(impl.knn) == n_docs, f"{len(impl.knn)} rows in the index, {n_docs} docs")
    stats = impl._pipeline.stats() if impl._pipeline is not None else {}
    check(stats.get("dispatched", 0) > 0 and not impl._pipeline_broken,
          f"the DevicePipeline ran no batch: {stats}")
    check(not device_degraded(), "the device monitor reports the card degraded")

    # the engine's answers, one query per batch, against one 32-query
    # search_texts on the same index
    exact, drift, tie_tol = agrees_with_search_texts(
        facts["answers"], impl.fused.search_texts(facts["queries"], K), node, K)
    direct_ms = _direct_query_ms(impl, facts["queries"])
    win = facts["window"]
    spans = win["span_seconds"]
    log(f"  fs jsonlines ({N_CHUNKS} files, streaming) -> DocumentStore -> BruteForceKnnFactory("
        f"SentenceTransformerEmbedder(max_len=64)) -> retrieve_query, {n_docs} docs, k = {K}, "
        f"every default on: docs/s embedded+indexed {facts['docs_per_s']:.1f} (all docs through "
        f"the DocumentStore at {facts['counted_s']:.3f} s, the probe query's answer "
        f"{facts['probe_s']:.3f} s later); serving p50 {facts['p50_ms']:.2f} ms, p90 "
        f"{facts['p90_ms']:.2f} ms over {N_QUERIES} sequential queries, {facts['qps_64']:.1f} qps "
        f"at 64 concurrent clients [{card}]")
    log(f"  the ingest's utilization window at the probe's answer: {win['bound_state']} over "
        f"{win['window_s']:.3f} s, {win['dispatches']} dispatches; host s prep {spans['prep']:.3f}, "
        f"dispatch {spans['dispatch']:.3f}, wait {spans['wait']:.3f}, device {spans['device']:.3f}; "
        f"health controller in the run: {throttles} throttle, {relaxes} relax actions")
    log(f"  probe query: the last doc at rank 1; DevicePipeline {stats['dispatched']} batches, "
        f"pad_waste_ratio {stats['pad_waste_ratio']:.4f}; device_degraded() False; "
        f"{N_QUERIES} sequential answers against one search_texts batch: top-{K} equal in order "
        f"in {exact}/{N_QUERIES}, the rest within near-ties of {tie_tol:.3g} (largest score "
        f"drift {drift:.3g})  ok")
    log(f"  the index's search_texts alone, one query a call: p50 {direct_ms:.2f} ms [{card}]")
    summary = {"docs_per_s": facts["docs_per_s"], "p50_ms": facts["p50_ms"],
               "direct_p50_ms": direct_ms,
               "p90_ms": facts["p90_ms"], "queries": facts["queries"],
               "answers": [[(d["text"], d["score"]) for d in ans] for ans in facts["answers"]]}
    # the last run's engine stays referenced by `last_engine()`; drop it so
    # the next phases do not run beside its state
    del facts, node, impl
    pw_runner._last_engine = None
    gc.collect()
    return summary


def run_udf_docstore(card: str, n_docs: int = N_UDF_DOCS, device=None) -> dict:
    """9b: DocumentStore over a UDF embedder (the `_KnnIndexImpl` path,
    knn_topk through DeviceKnnIndex.search_keys): seeded unit vectors of
    width 384, 32 self-retrievals, top-6 against a numpy brute force."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore

    vecs = np.random.default_rng(0).standard_normal((n_docs, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    texts = [f"udf doc {i}" for i in range(n_docs)]

    @pw.udf(max_batch_size=4096, deterministic=True, return_type=np.ndarray)
    def embed(batch: list) -> list:
        return [vecs[int(t.rsplit(" ", 1)[1])] for t in batch]

    picks = random.Random(3).sample(range(n_docs), N_QUERIES)
    pw.G.clear()
    t0 = time.perf_counter()
    docs = pw.debug.table_from_rows(pw.schema_from_types(data=str), [(t,) for t in texts])
    factory = BruteForceKnnFactory(
        dimensions=DIM, embedder=embed, reserved_space=n_docs, device=device
    )
    store = DocumentStore(docs, retriever_factory=factory)
    queries = pw.debug.table_from_rows(
        DocumentStore.RetrieveQuerySchema, [(texts[i], K, None, None) for i in picks]
    )
    answers = {}

    def on_result(key, row, time, is_addition):  # noqa: A002
        if is_addition:
            answers[key] = row["result"].value

    pw.io.subscribe(store.retrieve_query(queries), on_change=on_result)
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    pw.G.clear()
    elapsed = time.perf_counter() - t0
    check(len(answers) == N_QUERIES, f"{len(answers)} answers for {N_QUERIES} queries")
    by_text = {}
    for ans in answers.values():
        check(len(ans) == K, f"{len(ans)} answers, k = {K}")
        by_text[ans[0]["text"]] = ans
    err, exact = 0.0, 0
    for i in picks:
        ans = by_text.get(texts[i])
        check(ans is not None, f"query {texts[i]!r} did not find its own doc at rank 1")
        ids = [int(d["text"].rsplit(" ", 1)[1]) for d in ans]
        row = vecs[i] @ vecs.T  # the numpy brute force on the same vectors
        want = np.argsort(-row)[:K]
        err = max([err] + [abs(d["score"] - float(row[j])) for d, j in zip(ans, ids)])
        kth = float(row[want[-1]])
        swapped = [float(row[j]) for j in set(ids) ^ set(int(w) for w in want)]
        check(all(abs(s - kth) <= 1e-5 for s in swapped),
              f"query {i}: top-{K} {ids} vs numpy {list(want)} beyond near-ties")
        exact += ids == [int(w) for w in want]
    check(err <= 1e-5, f"scores against numpy: max abs err {err:.3g}")
    log(f"  DocumentStore over a pw.udf embedder (seeded unit vectors, d = {DIM}), {n_docs} docs, "
        f"{N_QUERIES} queries in one batch: {N_QUERIES}/{N_QUERIES} self-retrievals at rank 1, "
        f"top-{K} equal to numpy's in order in {exact}/{N_QUERIES}, max score error {err:.3g}; "
        f"ingest + query {elapsed:.2f} s  ok [{card}]")
    return {"seconds": elapsed, "max_score_err": err}


# -- phase 10: the Private-RAG server --------------------------------------------

RAG_QUERIES = 8
RAG_NEW_TOKENS = 32
RAG_TOPK = 6  # BaseRAGQuestionAnswerer's search_topk
RERANK_CANDIDATES = 16
RERANK_KEEP = 4
# card against CPU cross-encoder scores, both in bf16: scores are of order
# 0.03 (the head's 0.02 scale over a pooled vector of order 1), and a bf16
# rounding of the pooled vector (2^-8 relative) moves one by ~1e-4, so two
# roundings' worth of drift through 4 layers is held to 1e-3
RERANK_ATOL = 1e-3


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rag_prompts(queries, docs_per_query) -> list[str]:
    """The text HFPipelineChat generates from for each /v2/answer:
    prompt_qa over the docs, wrapped by prompt_chat_single_qa, through the
    engine as BaseRAGQuestionAnswerer.answer_query builds it."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.runner import run_tables
    from pathway_tpu_torch.xpacks.llm.llms import _messages_to_prompt, prompt_chat_single_qa
    from pathway_tpu_torch.xpacks.llm.prompts import prompt_qa

    pw.G.clear()
    t = pw.debug.table_from_rows(
        pw.schema_from_types(i=int, q=str, docs=pw.Json),
        [(i, q, pw.Json(d)) for i, (q, d) in enumerate(zip(queries, docs_per_query))],
    )
    (cap,) = run_tables(t.select(i=pw.this.i, m=prompt_chat_single_qa(prompt_qa(pw.this.q, pw.this.docs))))
    pw.G.clear()
    by_i = {row[0]: _messages_to_prompt(row[1]) for row in cap.state.rows.values()}
    return [by_i[i] for i in range(len(queries))]


def _wait_until_served(client, server, t0: float, n_docs: int, probe: str, limit_s: float) -> dict:
    """Poll a QA server (its engine's thread `server`, started at `t0`)
    until /v1/statistics counts `n_docs` and /v1/retrieve finds the probe
    doc at rank 1; the seconds to each."""
    deadline = t0 + limit_s
    count, shown = None, t0
    while True:  # the routes register once the engine runs
        check(server.is_alive(), "the QA server's engine stopped")
        try:
            count = client.statistics()["file_count"]
            if count == n_docs:
                break
        except OSError:  # not yet listening, or 404 before the routes
            pass
        now = time.perf_counter()
        check(now < deadline, f"the store did not count {n_docs} docs in {limit_s} s (last count {count})")
        if now - shown > 30:  # a slow ingest shows its progress
            log(f"  {now - t0:.0f} s after the start: /v1/statistics counts {count} of {n_docs} docs")
            shown = now
        time.sleep(0.05)
    counted_s = time.perf_counter() - t0
    top = client.retrieve(probe, k=1)
    check(top and top[0]["text"] == probe, f"the probe for the last doc found {top}")
    return {"counted_s": counted_s, "ready_s": time.perf_counter() - t0}


def _ask_answers(client, queries, concurrent) -> dict:
    """/v2/answer with return_context_docs for each of `queries` in turn
    (their latencies in ms), then for all of `concurrent` at once."""
    answers, lat = [], []
    for q in queries:
        tq = time.perf_counter()
        answers.append(client.answer(q, return_context_docs=True))
        lat.append((time.perf_counter() - tq) * 1000)
    results: list = [None] * len(concurrent)

    def one(i: int) -> None:
        results[i] = client.answer(concurrent[i], return_context_docs=True)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(concurrent))]
    tq = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    concurrent_s = time.perf_counter() - tq
    check(all(not t.is_alive() for t in threads), "a concurrent answer did not return")
    return {"answers": answers, "lat_ms": lat, "concurrent_s": concurrent_s, "concurrent": results}


def _serve_rag(docs_path: str, n_docs: int, generator, queries, concurrent, probe: str,
               autocommit_ms: float | None = None) -> dict:
    """QASummaryRestServer over DocumentStore + HFPipelineChat on a free
    port, driven by RAGClient; every request must answer 200 (RAGClient
    raises on any other status). `autocommit_ms` None serves through
    `run_server(threaded=True)`; a number runs the same graph through
    `pw.run(autocommit_duration_ms=...)` on a thread instead (what
    `run_server` does at the default of 100 ms), to compare commit
    cadences."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import health, utilization
    from pathway_tpu_torch.internals import runner as pw_runner
    from pathway_tpu_torch.ops.kernels import flash_attention, knn_topk
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.llms import HFPipelineChat
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer, RAGClient

    pw.G.clear()
    docs = pw.io.jsonlines.read(
        docs_path,
        schema=pw.schema_from_types(data=str),
        mode="streaming",
        batch_per_file=True,
        refresh_interval=3600.0,  # every file exists up front
    )
    embedder = SentenceTransformerEmbedder(max_len=64)
    factory = BruteForceKnnFactory(
        dimensions=embedder.get_embedding_dimension(), embedder=embedder, reserved_space=n_docs
    )
    store = DocumentStore(docs, retriever_factory=factory)
    rag = BaseRAGQuestionAnswerer(
        HFPipelineChat(generator=generator, max_new_tokens=RAG_NEW_TOKENS), store
    )
    port = _free_port()
    rag.build_server("127.0.0.1", port)
    client = RAGClient("127.0.0.1", port, timeout=300)
    # the window scoped to this run, as 9a scopes its measured run: the
    # dispatches of the phases before it do not pace this ingest
    utilization.reset_window()
    actions = dict(health.controller().status()["actions"])
    t0 = time.perf_counter()
    if autocommit_ms is None:
        server = rag.run_server(threaded=True)
    else:
        server = threading.Thread(target=pw.run, daemon=True,
                                  kwargs={"autocommit_duration_ms": autocommit_ms})
        server.start()
    out: dict = {}
    try:
        out.update(_wait_until_served(client, server, t0, n_docs, probe, 300.0))
        out["window"] = utilization.tracker().snapshot()  # the ingest's bound state
        after = health.controller().status()["actions"]
        out["throttles"] = after["throttle"] - actions["throttle"]
        out["relaxes"] = after["relax"] - actions["relax"]
        utilization.reset_window()  # the ingest's dispatches do not pace the requests
        out.update(_ask_answers(client, queries, concurrent))
        tq = time.perf_counter()
        out["summary"] = client.summarize(queries[:3])
        out["summary_s"] = time.perf_counter() - tq
        out["retrieve"] = [client.retrieve(q, k=RAG_TOPK) for q in queries]
        out["candidates"] = [client.retrieve(q, k=RERANK_CANDIDATES) for q in queries]
        out["listing"] = client.list_documents()
        out["requests"] = 3 + 3 * len(queries) + len(concurrent)  # after the readiness polls
        # the kernels the served requests launched, before any check below
        out["flash_launches"] = flash_attention.launches
        out["knn_launches"] = knn_topk.launches
    finally:
        engine = pw_runner.last_engine()
        if engine is not None:
            engine.terminate_flag.set()
        server.join(timeout=60)
        pw.G.clear()
        pw_runner._last_engine = None
    check(not server.is_alive(), "the QA server's engine did not stop")
    return out


def _rerank(queries, candidates) -> dict:
    """10b: CrossEncoderReranker on the card and on the CPU (the same
    seeded weights) over each query's candidates, through the engine,
    then rerank_topk_filter; the card's scores and kept docs against the
    CPU's."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.runner import run_tables
    from pathway_tpu_torch.ops.kernels import flash_attention
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker, rerank_topk_filter

    rerankers = {"card": CrossEncoderReranker(), "cpu": CrossEncoderReranker(device="cpu")}
    check(rerankers["card"].model.device.type == "cuda", "the reranker is not on the card")
    rows = [(q, d["text"]) for q, cands in zip(queries, candidates) for d in cands]
    out = {}
    for side, reranker in rerankers.items():
        pw.G.clear()
        pairs = pw.debug.table_from_rows(pw.schema_from_types(q=str, doc=str), rows)
        scored = pairs.select(q=pw.this.q, doc=pw.this.doc, s=reranker(pw.this.doc, pw.this.q))
        grouped = scored.groupby(pw.this.q).reduce(
            q=pw.this.q, docs=pw.reducers.tuple(pw.this.doc), scores=pw.reducers.tuple(pw.this.s)
        )
        kept = grouped.select(q=pw.this.q, kept=rerank_topk_filter(pw.this.docs, pw.this.scores, RERANK_KEEP))
        before = flash_attention.launches
        t0 = time.perf_counter()
        cap_scored, cap_kept = run_tables(scored, kept)
        out[side + "_s"] = time.perf_counter() - t0
        out[side + "_flash"] = flash_attention.launches - before
        pw.G.clear()
        out[side] = (
            {(r[0], r[1]): r[2] for r in cap_scored.state.rows.values()},
            {r[0]: r[1] for r in cap_kept.state.rows.values()},
        )
    (card_scores, card_kept), (cpu_scores, cpu_kept) = out["card"], out["cpu"]
    check(len(card_scores) == len(rows) == len(cpu_scores), f"{len(card_scores)} scores, {len(rows)} pairs")
    err = max(abs(card_scores[k] - cpu_scores[k]) for k in cpu_scores)
    check(err <= RERANK_ATOL, f"card vs CPU cross-encoder scores: max abs err {err:.3g} > {RERANK_ATOL}")
    # a kept doc may differ only by a near-tie: both its scores within twice
    # the largest card / CPU drift of the K-th kept score
    tie_tol = 2 * err + 1e-6
    exact = 0
    for q in queries:
        (cd, cs), (pd, ps) = card_kept[q], cpu_kept[q]
        check(len(cd) == len(pd) == RERANK_KEEP, f"kept {len(cd)} / {len(pd)} docs")
        kth = min(cs[-1], ps[-1])
        swapped = set(cd) ^ set(pd)
        check(all(abs(cpu_scores[(q, d)] - kth) <= tie_tol for d in swapped),
              f"query {q!r}: kept {cd} on the card, {pd} on the CPU, beyond near-ties")
        exact += list(cd) == list(pd)
    out.update(max_abs_err=err, exact=exact, pairs=len(rows))
    return out


def probe_served_prefills(flash_attention, generator, prompts, batch, what: str) -> dict:
    """flash at the served prefills' shapes, on each layer's own q / k / v,
    held to phase 6's per-layer tolerance (`flash_probe`): each sequential
    prompt at batch 1, as it was served, and the concurrent prompts as one
    ragged batch, the largest the micro-batcher forms. Its launches come
    after the served run's were read."""
    from pathway_tpu_torch.models import decoder as decoder_module
    from pathway_tpu_torch.models.decoder import generate_tokens

    per_layer: list = []
    probed = [[p] for p in prompts] + [batch]
    with torch.no_grad(), decoder_attention(decoder_module, flash_probe(flash_attention, per_layer)):
        for group in probed:
            ids, mask = generator.encode_prompts(group, RAG_NEW_TOKENS)
            check(int(mask.sum(1).min()) > 256, f"a probed prompt of {mask.sum(1)} tokens")
            generate_tokens(generator.params, generator.config, ids, mask, max_new_tokens=1)
    cos, err, tol, plain_err = check_probed_layers(
        per_layer, len(probed) * generator.config.layers, what)
    cfg = generator.config
    return {"layers": len(per_layer), "n_prompts": len(prompts), "cos": cos, "err": err,
            "tol": tol, "plain_err": plain_err,
            "batch_shape": [len(batch), cfg.q_heads, int(ids.shape[1]), cfg.head_dim]}


def log_probed_prefills(probe: dict, generator, lengths) -> None:
    cfg = generator.config
    log(f"  flash at the served prefills, each layer on its q / k / v ({probe['layers']} layers: "
        f"{probe['n_prompts']} prompts at [1, {cfg.q_heads}, {min(lengths)}-{max(lengths)}, "
        f"{cfg.head_dim}], the concurrent ones at {probe['batch_shape']}, causal, bf16): min "
        f"row cosine to dense {probe['cos']:.6f}; max |err| against f32 attention "
        f"{probe['err']:.3g} ({probe['tol']:.3f} of 2e-2 + 2^-6 |o|; dense: "
        f"{probe['plain_err']:.3g})  ok")


def run_rag_server(card: str, n_docs: int = N_DOCS, autocommit_ms: float | None = None) -> dict:
    """10a: the Private-RAG server at full width, every default on, and
    10b: the cross-encoder at full width, on the card against the CPU.
    `autocommit_ms`: see `_serve_rag`."""
    from pathway_tpu_torch.models.decoder_lm import ChatModel
    from pathway_tpu_torch.ops.kernels import flash_attention

    t_phase = time.perf_counter()
    docs = make_docs(n_docs, random.Random(13))
    queries = make_prompts(RAG_QUERIES, random.Random(19), 8, 16)
    concurrent = make_prompts(RAG_QUERIES, random.Random(23), 8, 16)
    generator = ChatModel("mistral-7b", max_len=1024, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        docs_path = _write_docs(docs, tmp)
        served = _serve_rag(docs_path, n_docs, generator, queries, concurrent, docs[-1],
                            autocommit_ms)
    served_s = time.perf_counter() - t_phase

    # each answer's context is /v1/retrieve's top 6 for its query, and its
    # reply is generate() on the prompt built from that context, batch 1
    answers = served["answers"]
    exact_docs = 0
    for q, ans, ret in zip(queries, answers, served["retrieve"]):
        ctx = ans["context_docs"]
        check([d["text"] for d in ctx] == [d["text"] for d in ret] and len(ctx) == RAG_TOPK,
              f"query {q!r}: context docs differ from /v1/retrieve's top {RAG_TOPK}")
        check(all(abs(a["score"] - b["score"]) <= 1e-5 for a, b in zip(ctx, ret)),
              f"query {q!r}: context doc scores differ from /v1/retrieve's")
        exact_docs += ctx == ret
    prompts = _rag_prompts(queries, [a["context_docs"] for a in answers])
    lengths = [int(generator.encode_prompts([p], RAG_NEW_TOKENS)[1].sum()) for p in prompts]
    check(min(lengths) > 256, f"RAG prompts of {lengths} tokens stay under the flash gate")
    check(max(lengths) <= generator.max_len - RAG_NEW_TOKENS, f"prompts of {lengths} tokens were cut")
    for q, p, ans in zip(queries, prompts, answers):
        direct = generator.generate([p], max_new_tokens=RAG_NEW_TOKENS)[0]
        check(isinstance(ans["response"], str) and ans["response"] == direct,
              f"query {q!r}: the served answer differs from generate() on its prompt")
    check(all(isinstance(r, dict) and isinstance(r.get("response"), str) and r["response"]
              and len(r.get("context_docs", ())) == RAG_TOPK
              for r in served["concurrent"]), f"concurrent answers: {served['concurrent']}")

    batch = _rag_prompts(concurrent, [r["context_docs"] for r in served["concurrent"]])
    probe = probe_served_prefills(flash_attention, generator, prompts, batch, "RAG prefills")
    check(isinstance(served["summary"], dict) and isinstance(served["summary"].get("response"), str),
          f"summarize: {served['summary']}")
    check(len(served["listing"]) == n_docs, f"list_documents: {len(served['listing'])} entries")
    check(all(len(c) == RERANK_CANDIDATES for c in served["candidates"]), "retrieve at k = 16")
    check(served["flash_launches"] > 0, "the RAG server's prefills launched no flash kernel")
    lat = served["lat_ms"]
    log(f"  QASummaryRestServer on 127.0.0.1 (aiohttp), {n_docs} docs in {N_CHUNKS} jsonlines files "
        f"-> DocumentStore -> BruteForceKnnFactory(SentenceTransformerEmbedder(max_len=64)), "
        f"BaseRAGQuestionAnswerer(HFPipelineChat(ChatModel('mistral-7b', max_len=1024), "
        f"max_new_tokens={RAG_NEW_TOKENS})), every default on"
        f"{'' if autocommit_ms is None else f' but pw.run(autocommit_duration_ms={autocommit_ms})'}: "
        f"store ready {served['ready_s']:.3f} s after run_server (every doc counted at "
        f"{served['counted_s']:.3f} s) [{card}]")
    win = served["window"]
    log(f"  the ingest's utilization window at readiness: {win['bound_state']} over "
        f"{win['window_s']:.3f} s, {win['dispatches']} dispatches; health controller in the "
        f"ingest: {served['throttles']} throttle, {served['relaxes']} relax actions; the window "
        f"reset before the requests")
    log(f"  {RAG_QUERIES} sequential /v2/answer (k = {RAG_TOPK}, prompts of {min(lengths)}-"
        f"{max(lengths)} tokens): p50 {np.percentile(lat, 50):.1f} ms, p90 "
        f"{np.percentile(lat, 90):.1f} ms (n = {len(lat)}: between the two slowest), max "
        f"{max(lat):.1f} ms; {RAG_QUERIES} concurrent in {served['concurrent_s']:.3f} s "
        f"wall; /v2/summarize {served['summary_s']:.3f} s; {served['requests']} requests after the store was ready, all 200; "
        f"flash_attention launches {served['flash_launches']}, knn_topk {served['knn_launches']} [{card}]")
    log(f"  every answer's context_docs = /v1/retrieve's top {RAG_TOPK} (texts in order, scores within "
        f"1e-5; equal whole in {exact_docs}/{RAG_QUERIES}); every sequential answer = "
        f"generate([prompt], max_new_tokens={RAG_NEW_TOKENS}) on its prompt_qa + "
        f"prompt_chat_single_qa prompt  ok")
    log_probed_prefills(probe, generator, lengths)
    served_launches = {"flash_attention": served["flash_launches"], "knn_topk": served["knn_launches"]}
    del generator, served["answers"]
    gc.collect()
    torch.cuda.empty_cache()

    rr = _rerank(queries, served["candidates"])
    check(rr["card_flash"] == 0, f"the cross-encoder (L <= 256) launched flash {rr['card_flash']} times")
    log(f"  CrossEncoderReranker() (4 layers, hidden 384, cls pooling, bf16) over {rr['pairs']} pairs "
        f"({RAG_QUERIES} queries x /v1/retrieve's {RERANK_CANDIDATES} candidates), through the "
        f"engine: card {rr['card_s']:.3f} s, CPU {rr['cpu_s']:.3f} s; card vs CPU scores max abs err "
        f"{rr['max_abs_err']:.3g} (<= {RERANK_ATOL}); rerank_topk_filter(..., {RERANK_KEEP}) kept the "
        f"same docs in order for {rr['exact']}/{RAG_QUERIES} queries, the rest within near-ties; "
        f"flash launches 0 (L <= 256)  ok [{card}]")
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 10 wall {phase_s:.1f} s (10a served {served_s:.1f} s)")
    return {"launches": served_launches, "p50_ms": float(np.percentile(lat, 50)),
            "phase_s": phase_s}


# -- phase 12: the stdlib path on the card ------------------------------------------

# Nexmark at Apache Beam's NexmarkConfiguration defaults: person : auction :
# bid = 1 : 3 : 46 in every 50 events, 10,000 events/s of event time (one
# event each 0.1 ms), windowSizeSec 10 and windowPeriodSec 5. 600,000
# events (60 s of event time): at 1,000,000 the phase took 87 s on the host
# of an NVIDIA H100 machine (PERF.md), over the minute it is given
N_NEXMARK_EVENTS = 600_000
NEXMARK_WINDOW_MS = 10_000
NEXMARK_PERIOD_MS = 5_000


def nexmark_events(n: int, seed: int = 0) -> dict:
    """`n` Nexmark events from numpy.random.default_rng(seed) as column
    arrays: kind (0 person, 1 auction, 2 bid), t (event time, ms), id
    (person or auction id), seller (auction's), auction, bidder and price
    (bid's). A new auction's seller is one of the 20 newest persons, a
    bid's auction one of the 200 newest auctions, its bidder any person so
    far."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n, dtype=np.int64)
    slot = idx % 50
    kind = np.where(slot == 0, 0, np.where(slot < 4, 1, 2))
    t = idx // 10  # 10,000 events/s
    last_pid = 1000 + idx // 50  # the newest person at each event
    last_aid = 1000 + (idx // 50) * 3 + np.minimum(slot, 3) - 1  # the newest auction
    ident = np.where(kind == 0, last_pid, np.where(kind == 1, last_aid, 0))
    seller = np.where(kind == 1, np.maximum(1000, last_pid - rng.integers(0, 20, n)), 0)
    auction = np.where(kind == 2, np.maximum(1000, last_aid - rng.integers(0, 200, n)), 0)
    bidder = np.where(kind == 2, 1000 + rng.integers(0, 1 << 62, n) % (last_pid - 999), 0)
    price = np.where(kind == 2, rng.integers(100, 100_000, n), 0)
    return {"kind": kind, "t": t, "eid": ident, "seller": seller, "auction": auction,
            "bidder": bidder, "price": price}


def write_nexmark(directory: str, ev: dict, n_files: int = N_CHUNKS) -> None:
    """The events as jsonlines, in time order over `n_files` files."""
    names = ("person", "auction", "bid")
    n = len(ev["t"])
    per_file = -(-n // n_files)
    cols = [ev[c].tolist() for c in ("kind", "t", "eid", "seller", "auction", "bidder", "price")]
    for f in range(n_files):
        lo, hi = f * per_file, min(n, (f + 1) * per_file)
        with open(os.path.join(directory, f"events_{f:03d}.jsonl"), "w") as fh:
            fh.write("\n".join(
                json.dumps({"kind": names[k], "t": t, "eid": i, "seller": s, "auction": a,
                            "bidder": b, "price": p})
                for k, t, i, s, a, b, p in zip(*(c[lo:hi] for c in cols))
            ))


def nexmark_plain(ev: dict) -> dict:
    """Q5, Q7 and Q8 in plain Python over the same events (dicts)."""
    kind, t = ev["kind"].tolist(), ev["t"].tolist()
    ident, seller = ev["eid"].tolist(), ev["seller"].tolist()
    auction, bidder, price = ev["auction"].tolist(), ev["bidder"].tolist(), ev["price"].tolist()
    w, h = NEXMARK_WINDOW_MS, NEXMARK_PERIOD_MS
    counts: Counter = Counter()
    top_price: dict = {}
    persons: dict = {}
    auctions_by_window: dict = {}
    for i in range(len(t)):
        if kind[i] == 2:
            for start in ((t[i] // h) * h - h, (t[i] // h) * h):  # the two sliding windows
                counts[(start, auction[i])] += 1
            start = (t[i] // w) * w
            top_price[start] = max(top_price.get(start, -1), price[i])
        elif kind[i] == 0:
            persons[ident[i]] = (t[i] // w) * w
        else:
            auctions_by_window.setdefault((t[i] // w) * w, []).append((ident[i], seller[i]))
    most: dict = {}
    for (start, _a), c in counts.items():
        most[start] = max(most.get(start, 0), c)
    q5 = Counter((s, a, c) for (s, a), c in counts.items() if c == most[s])
    q7 = Counter(
        ((t[i] // w) * w, auction[i], bidder[i], price[i])
        for i in range(len(t)) if kind[i] == 2 and price[i] == top_price[(t[i] // w) * w]
    )
    q8 = Counter(
        (s, a) for start, rows in auctions_by_window.items() for a, s in rows
        if persons.get(s) == start
    )
    return {"q5": q5, "q7": q7, "q8": q8}


def _nexmark_query(pw, events_dir: str, query: str):
    class Event(pw.Schema):
        kind: str
        t: int
        eid: int
        seller: int
        auction: int
        bidder: int
        price: int

    ev = pw.io.jsonlines.read(events_dir, schema=Event, mode="static")
    bids = ev.filter(ev.kind == "bid")
    if query == "q5":  # hot items: the most-bid auctions of each sliding window
        counts = pw.temporal.windowby(
            bids, bids.t,
            window=pw.temporal.sliding(hop=NEXMARK_PERIOD_MS, duration=NEXMARK_WINDOW_MS),
            instance=bids.auction,
        ).reduce(start=pw.this._pw_window_start, auction=pw.this._pw_instance,
                 n=pw.reducers.count())
        most = counts.groupby(counts.start).reduce(counts.start, m=pw.reducers.max(counts.n))
        return counts.join(most, counts.start == most.start, counts.n == most.m).select(
            start=counts.start, auction=counts.auction, n=counts.n
        )
    if query == "q7":  # highest bid of each tumbling window, joined back to the bids
        top = pw.temporal.windowby(
            bids, bids.t, window=pw.temporal.tumbling(duration=NEXMARK_WINDOW_MS)
        ).reduce(start=pw.this._pw_window_start, p=pw.reducers.max(pw.this.price))
        keyed = bids.with_columns(start=pw.this.t // NEXMARK_WINDOW_MS * NEXMARK_WINDOW_MS)
        return keyed.join(top, keyed.start == top.start, keyed.price == top.p).select(
            start=keyed.start, auction=keyed.auction, bidder=keyed.bidder, price=keyed.price
        )
    # q8, new users: persons who opened an auction in the window they joined
    persons = ev.filter(ev.kind == "person")
    auctions = ev.filter(ev.kind == "auction")
    return persons.window_join(
        auctions, persons.t, auctions.t, pw.temporal.tumbling(duration=NEXMARK_WINDOW_MS),
        persons.eid == auctions.seller,
    ).select(person=pw.left.eid, auction=pw.right.eid)


def run_nexmark(card: str, n_events: int = N_NEXMARK_EVENTS) -> dict:
    """12a: Nexmark Q5, Q7 and Q8 through pathway_tpu_torch's temporal
    stdlib (fs jsonlines, static), each in its own run over the same
    events, each final table equal to the plain-Python answer."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import runner as pw_runner

    ev = nexmark_events(n_events)
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_nexmark(tmp, ev)
        want = nexmark_plain(ev)
        log(f"  {n_events} Nexmark events (persons {int((ev['kind'] == 0).sum())}, auctions "
            f"{int((ev['kind'] == 1).sum())}, bids {int((ev['kind'] == 2).sum())}; "
            f"{ev['t'][-1] / 1000:.1f} s of event time) in {N_CHUNKS} jsonlines files and the "
            f"plain-Python answers in {time.perf_counter() - t0:.1f} s")
        for query in ("q5", "q7", "q8"):
            got: Counter = Counter()

            def on_change(key, row, time, is_addition, got=got):  # noqa: A002
                got[tuple(row.values())] += 1 if is_addition else -1

            pw.G.clear()
            t0 = time.perf_counter()
            pw.io.subscribe(_nexmark_query(pw, tmp, query), on_change=on_change)
            pw.run(monitoring_level=pw.MonitoringLevel.NONE)
            wall = time.perf_counter() - t0
            pw.G.clear()
            got = +got
            check(got == want[query], f"Nexmark {query}: {sum(got.values())} rows, the plain "
                  f"answer {sum(want[query].values())}; {len(got - want[query])} rows not in it")
            rates[query] = n_events / wall
            log(f"  Nexmark {query.upper()}: {sum(got.values())} result rows equal to the "
                f"plain-Python answer; {wall:.2f} s, {rates[query]:.1f} events/s  ok [{card}]")
    # the last run's engine, which `last_engine()` keeps, holds every
    # event's state: drop it, as 9a drops its own, before the next phases
    pw_runner._last_engine = None
    gc.collect()
    return rates


N_ML_ROWS = 65536
N_ML_LABELS = 64


def ml_vectors(n: int, d: int, n_labels: int, n_queries: int, seed: int = 0):
    """Clustered vectors with varying norms, their labels, and queries near
    the label centers (so each query's neighbours agree on a label)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_labels, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    labels = rng.integers(0, n_labels, n)
    x = centers[labels] + 0.6 * rng.standard_normal((n, d)) / math.sqrt(d)
    x *= rng.uniform(0.5, 1.5, (n, 1))
    qlab = rng.integers(0, n_labels, n_queries)
    q = centers[qlab] + 0.3 * rng.standard_normal((n_queries, d)) / math.sqrt(d)
    return x.astype(np.float32), labels, q.astype(np.float32)


def run_stdlib_ml(card: str, n_rows: int = N_ML_ROWS, device=None) -> dict:
    """12b: pw.ml on the card. KNNIndex (euclidean: knn_topk's l2sq;
    cosine: cos) over `n_rows` seeded vectors of width 384, 32 queries in
    one engine batch, k = 6, ids and scores against numpy's exact answer in
    float64; then knn_lsh_classifier_train against a numpy majority vote."""
    import pathway_tpu_torch as pw

    x, labels, q = ml_vectors(n_rows, DIM, N_ML_LABELS, N_QUERIES)
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    # the exact scores: negated squared distance (higher is better), cosine
    exact_of = {
        "euclidean": -((q64 ** 2).sum(1)[:, None] - 2 * q64 @ x64.T + (x64 ** 2).sum(1)[None, :]),
        "cosine": (q64 / np.linalg.norm(q64, axis=1, keepdims=True))
        @ (x64 / np.linalg.norm(x64, axis=1, keepdims=True)).T,
    }
    t_all = time.perf_counter()
    out = {}
    for distance_type in ("euclidean", "cosine"):
        pw.G.clear()
        t0 = time.perf_counter()
        data = pw.debug.table_from_rows(
            pw.schema_from_types(data=np.ndarray, label=int, idx=int),
            [(x[i], int(labels[i]), i) for i in range(n_rows)],
        )
        queries = pw.debug.table_from_rows(
            pw.schema_from_types(data=np.ndarray, qi=int), [(q[i], i) for i in range(len(q))]
        )
        index = pw.ml.index.KNNIndex(
            data.data, data, n_dimensions=DIM, distance_type=distance_type, device=device
        )
        found = {}

        def on_change(key, row, time, is_addition):  # noqa: A002
            if is_addition:
                found[row["qi"]] = (row["idx"], row["_pw_index_reply_score"])

        pw.io.subscribe(index.get_nearest_items(queries.data, k=K), on_change=on_change)
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        pw.G.clear()
        wall = time.perf_counter() - t0
        check(sorted(found) == list(range(len(q))), f"KNNIndex {distance_type}: answers for "
              f"{len(found)} of {len(q)} queries")
        exact = exact_of[distance_type]
        want_ids = np.argsort(-exact, axis=1)[:, :K]
        got_ids = np.array([found[i][0] for i in range(len(q))])
        got_scores = np.array([found[i][1] for i in range(len(q))], dtype=np.float64)
        err = float(np.abs(got_scores - np.take_along_axis(exact, got_ids, 1)).max())
        check(err <= 1e-4, f"KNNIndex {distance_type}: score error against numpy {err:.3g}")
        want_scores = np.take_along_axis(exact, want_ids, 1)
        knn_sets_agree(torch.from_numpy(got_scores), torch.from_numpy(got_ids),
                       torch.from_numpy(want_scores), torch.from_numpy(want_ids))
        exact_rows = int((got_ids == want_ids).all(1).sum())
        log(f"  pw.ml KNNIndex(distance_type={distance_type!r}) over {n_rows} rows, d = {DIM}, "
            f"{len(q)} queries in one batch, k = {K}: ids equal to numpy's in order in "
            f"{exact_rows}/{len(q)}, the rest within near-ties; max score error {err:.3g}; "
            f"{wall:.2f} s  ok [{card}]")
        out[distance_type] = {"max_score_err": err, "seconds": wall}

    # the KNN classifier: a numpy majority vote over the same 6 neighbours
    from pathway_tpu_torch.internals import health

    throttles = health.controller().status()["actions"]["throttle"]
    pw.G.clear()
    t0 = time.perf_counter()
    data = pw.debug.table_from_rows(
        pw.schema_from_types(data=np.ndarray, label=int),
        [(x[i], int(labels[i])) for i in range(n_rows)],
    )
    queries = pw.debug.table_from_rows(
        pw.schema_from_types(data=np.ndarray, qi=int), [(q[i], i) for i in range(len(q))]
    )
    classify = pw.ml.classifiers.knn_lsh_classifier_train(
        data, type="euclidean", d=DIM, device=device
    )
    labelled = classify(queries, k=K)  # keyed by the queries' keys
    labelled = labelled.select(labelled.predicted_label, qi=queries.restrict(labelled).qi)
    by_query = {}

    def on_label(key, row, time, is_addition):  # noqa: A002
        if is_addition:
            by_query[row["qi"]] = row["predicted_label"]

    pw.io.subscribe(labelled, on_change=on_label)
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    pw.G.clear()
    predicted = [by_query.get(i) for i in range(len(q))]
    votes = []
    for row in np.argsort(-exact_of["euclidean"], axis=1)[:, :K]:
        (label, n), *rest = Counter(labels[row].tolist()).most_common()
        check(not rest or rest[0][1] < n, "a numpy majority vote is tied: pick another seed")
        votes.append(label)
    check(predicted == votes,
          f"knn_lsh_classifier_train: {predicted} against numpy's {votes}")
    wall = time.perf_counter() - t0
    throttles = health.controller().status()["actions"]["throttle"] - throttles
    log(f"  pw.ml knn_lsh_classifier_train(d={DIM}) + classify(k={K}) over {n_rows} rows: "
        f"{len(predicted)} labels equal to a numpy majority vote; {wall:.2f} s ({throttles} "
        f"health-controller throttle actions); phase 12b {time.perf_counter() - t_all:.1f} s  "
        f"ok [{card}]")
    return out


# -- phase 13: operability on the card -------------------------------------------

# 13c's index: 2^26 rows of 384 f32 columns and a valid flag, 2^26 x 1,537 B
# (~103 GB), more than an 80 GB card holds
N_OVERSIZED_ROWS = 1 << 26
MONITORING_URL = "http://127.0.0.1:20000"  # pw.run(with_http_server=True), worker 0
# gradients of q, k and v through flash (the kernel's forward, the plain
# version's recomputed backward) against the CPU path's, as a share of
# max(1, the largest |gradient|): f32 1e-4 (f32 rounding of two sums in
# another order); bf16 3e-2 (the backward's products round to bf16, 2^-8
# relative, on both sides, summed over up to 256 keys in another order)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _collect_earlier_phases() -> dict:
    """Drop what earlier phases left alive and collect: the last engine,
    the parse graph and the model caches of SentenceEncoder / ChatModel /
    CrossEncoderModel.cached. A finished run holds nothing else: its
    index closes its DevicePipeline at the run's end, and its streaming
    readers let go of the run and return. Returns memtrack's live
    (entries, bytes) of the index and the encoder that survive it."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import runner as pw_runner
    from pathway_tpu_torch.models import cross_encoder, decoder_lm, minilm

    pw_runner._last_engine = None
    pw.G.clear()
    for module in (minilm, decoder_lm, cross_encoder):
        module._model_cache.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {c: _live(c) for c in ("knn_index", "encoder_params")}


def _tensors(tree):
    """The tensors of a nested dict / list tree."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _live(component: str) -> tuple:
    """memtrack's live (entries, bytes) of one component."""
    from pathway_tpu_torch.internals import memtrack

    entries = memtrack.tracker().entries(component)
    return len(entries), sum(e["nbytes"] for e in entries)


def _cli(args, timeout: float = 180.0) -> tuple:
    """`python -m pathway_tpu_torch.cli ARGS` from this checkout: (exit
    code, stdout, stderr)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "pathway_tpu_torch.cli", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout,
    )
    return res.returncode, res.stdout, res.stderr


def _trace_kernels(path: str) -> list:
    """The CUDA kernel events of a Chrome trace written by torch.profiler.
    Fails if there are none, naming the trace's event categories."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    cats = sorted({str(e.get("cat")) for e in events})
    check(bool(kernels), f"{path}: no CUDA kernel event among {len(events)} ({cats})")
    return kernels


def _top_kernels(kernels: list, n: int = 5) -> list:
    by_name: dict = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [{"kernel": name[:90], "ms": us / 1e3} for name, us in top]


def _stop_pipeline(query_q, runner) -> None:
    from pathway_tpu_torch.internals import runner as pw_runner

    query_q.put(None)  # closes the query subject
    pw_runner.last_engine().terminate_flag.set()  # the docs source streams on
    runner.join(timeout=60)
    check(not runner.is_alive() and runner.error is None, f"pipeline end: {runner.error!r}")


def run_capacity_parity(card: str, n_docs: int = N_DOCS, device=None) -> dict:
    """13a: phase 9a's configuration (fs jsonlines -> DocumentStore over
    BruteForceKnnFactory(SentenceTransformerEmbedder(max_len=64)) at full
    MiniLM-L6 width, reserved_space = the doc count) under
    pw.run(analysis="warn", with_http_server=True): the analyzer's capacity
    plan against the card's total memory and against memtrack's live bytes
    of the index and the encoder, with as many live entries as predicted
    (else PWT699's comparison would skip), and the allocator's growth over
    the build beside memtrack's sum (the gap is the encoder's bf16 compute
    copy, which memtrack does not count)."""
    from pathway_tpu_torch.analysis.capacity import CAPACITY_PARITY_TOLERANCE
    from pathway_tpu_torch.internals import memtrack
    from pathway_tpu_torch.internals import runner as pw_runner

    check(memtrack.ENABLED, "memtrack is disabled (PATHWAY_MEMTRACK=0)")
    on_card = device is None or torch.device(device).type == "cuda"
    left = _collect_earlier_phases()
    # the counts below must match the plan's, so nothing of the earlier
    # phases' finished runs may still be registered
    check(all(n == 0 for n, _ in left.values()),
          f"finished runs of earlier phases still hold device memory: knn_index "
          f"{left['knn_index'][0]} ({left['knn_index'][1]:.0f} B), encoder_params "
          f"{left['encoder_params'][0]} ({left['encoder_params'][1]:.0f} B)")
    log("  earlier phases' runs, their engines and model caches dropped: no knn_index or "
        "encoder_params registration left  ok")
    docs = make_docs(n_docs, random.Random(7))
    t0 = time.perf_counter()
    # cuBLAS keeps a workspace per (handle, stream) in the caching
    # allocator; the earlier phases' are dropped so that the growth below
    # holds only this run's, and clearing them again after shows their share
    clear_workspaces = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if on_card and clear_workspaces is not None:
        clear_workspaces()
    allocated0 = torch.cuda.memory_allocated() if on_card else 0
    query_q: queue.Queue = queue.Queue()
    resp_q: queue.Queue = queue.Queue()
    count_q: queue.Queue = queue.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        runner = _PhaseThread(
            _retrieval_pipeline,
            (_write_docs(docs, tmp), n_docs, query_q, resp_q, count_q, device,
             {"analysis": "warn", "with_http_server": True}),
        )
        runner.start()
        while _get(count_q, runner)[1] < n_docs:
            pass
        _, result = _ask(query_q, resp_q, runner, docs[-1])
        check(bool(result.value) and result.value[0]["text"] == docs[-1],
              "the probe query did not find the last doc at rank 1")
        grown = workspaces = None
        if on_card:
            torch.cuda.synchronize()
            grown = torch.cuda.memory_allocated() - allocated0
            if clear_workspaces is not None:
                clear_workspaces()
                workspaces = allocated0 + grown - torch.cuda.memory_allocated()
        live = {c: _live(c) for c in ("knn_index", "encoder_params")}
        engine = pw_runner.last_engine()
        analysis = engine.analysis
        lm = _index_node(engine).index.fused.encoder.lm
        compute_copy = sum(
            t.numel() * t.element_size()
            for t in _tensors(lm.compute_params()["layers"]) if t.dtype != torch.float32
        )
        _stop_pipeline(query_q, runner)
    del engine, lm
    pw_runner._last_engine = None
    gc.collect()
    check(analysis is not None, "pw.run(analysis='warn') attached no analysis to the engine")
    findings = [(f["code"], f["severity"]) for f in analysis["findings"]]
    check("PWT601" in {c for c, _ in findings}, f"no PWT601 capacity plan: {findings}")
    check(not [c for c, s in findings if s == "error"], f"ERROR findings: {findings}")
    cap = analysis["capacity"]
    if on_card:
        total = torch.cuda.get_device_properties(0).total_memory
        check(cap["hbm_capacity_bytes"] == total,
              f"capacity {cap['hbm_capacity_bytes']} is not the card's {total} B")
    (row,) = cap["indexes"]
    want = {"knn_index": (1, row["index_bytes"]), "encoder_params": (1, row["param_bytes"])}
    for component, (n_pred, pred) in want.items():
        n_live, got = live[component]
        check(n_live == n_pred, f"{component}: {n_live} live entries for {n_pred} predicted, so "
                                "PWT699's comparison would skip")
        drift = abs(pred - got) / got
        check(drift <= CAPACITY_PARITY_TOLERANCE,
              f"{component}: predicted {pred} B, live {got} B ({100 * drift:.2f} % drift)")
    tracked = live["knn_index"][1] + live["encoder_params"][1]
    seconds = time.perf_counter() - t0
    log(f"  pw.run(analysis='warn', with_http_server=True) over 9a's configuration ({n_docs} docs, "
        f"MiniLM-L6, max_len 64, reserved_space {n_docs}): findings {sorted(set(findings))}; "
        f"hbm_capacity_bytes {cap['hbm_capacity_bytes']} (the card's total memory)")
    log(f"  capacity plan against memtrack's live entries (1 index, 1 encoder, as predicted): "
        f"knn_index predicted {row['index_bytes']} B ({row['predicted_rows']} rows), live "
        f"{live['knn_index'][1]} B; encoder_params predicted {row['param_bytes']} B, live "
        f"{live['encoder_params'][1]} B  ok")
    gap = None if grown is None else grown - tracked
    rest = None if gap is None or workspaces is None else gap - compute_copy - workspaces
    log(f"  torch.cuda.memory_allocated() grew {grown} B over the build and ingest, memtrack "
        f"holds {tracked:.0f} B: {gap} B more on the card, not in memtrack: the encoder's bf16 "
        f"compute copy of its matmul weights {compute_copy} B, cuBLAS workspaces {workspaces} B, "
        f"the rest {rest} B; phase 13a {seconds:.1f} s [{card}]")
    return {"index_bytes": row["index_bytes"], "param_bytes": row["param_bytes"],
            "live": live, "allocated_growth": grown, "compute_copy": compute_copy,
            "cublas_workspaces": workspaces}


def _udf_serving_pipeline(vecs, query_q, resp_q, count_q, device) -> None:
    """9b's DocumentStore over a pw.udf embedder of seeded unit vectors
    (the vector impl: knn_topk), serving queries on a python connector
    subject under pw.run(with_http_server=True)."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore

    @pw.udf(max_batch_size=4096, deterministic=True, return_type=np.ndarray)
    def embed(batch: list) -> list:
        return [vecs[int(t.rsplit(" ", 1)[1])] for t in batch]

    pw.G.clear()
    docs = pw.debug.table_from_rows(
        pw.schema_from_types(data=str), [(f"udf doc {i}",) for i in range(len(vecs))]
    )
    factory = BruteForceKnnFactory(
        dimensions=vecs.shape[1], embedder=embed, reserved_space=len(vecs), device=device
    )
    store = DocumentStore(docs, retriever_factory=factory)
    _serve_store(pw, store, query_q, resp_q, count_q, {"with_http_server": True})


def run_profile_while_serving(card: str, n_docs: int = N_UDF_DOCS, device=None,
                              seconds: float = 2.0) -> dict:
    """13b: while 9b's UDF-embedder DocumentStore serves queries (knn_topk
    on the card), `pathway-tpu-torch profile --url` asks the job's
    /profile twice for a `seconds` capture with queries running: the
    first sets CUPTI up before its window, the second starts at once, and
    each window must hold answered queries and each Chrome trace
    knn_block_topk. Then `status --json` must carry the second capture
    under utilization.profiler.last (the repaired /status) and a memory
    key, and `top --once` prints one frame."""
    from pathway_tpu_torch.internals import profiler, utilization

    on_card = device is None or torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    # the window scoped to this run, as 9a and 10 scope theirs: 13a's
    # ingest does not pace these queries
    utilization.reset_window()
    vecs = np.random.default_rng(0).standard_normal((n_docs, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    query_q: queue.Queue = queue.Queue()
    resp_q: queue.Queue = queue.Queue()
    count_q: queue.Queue = queue.Queue()
    runner = _PhaseThread(_udf_serving_pipeline, (vecs, query_q, resp_q, count_q, device))
    runner.start()
    while _get(count_q, runner)[1] < n_docs:
        pass
    _, result = _ask(query_q, resp_q, runner, "udf doc 17")
    check(bool(result.value) and result.value[0]["text"] == "udf doc 17",
          "the probe query did not find its own doc at rank 1")
    stop = threading.Event()
    answered: list = []  # wall-clock times, as the capture's own

    def feed() -> None:
        i = 0
        while not stop.is_set():
            text = f"udf doc {(i * 7919) % n_docs}"
            _, res = _ask(query_q, resp_q, runner, text)
            check(res.value[0]["text"] == text, f"{text!r} not at rank 1 under the profiler")
            answered.append(time.time())
            i += 1

    feeder = _PhaseThread(feed, ())
    feeder.start()
    deadline = time.perf_counter() + 120
    while len(answered) < 32:
        check(feeder.error is None and feeder.is_alive(), f"query feeder: {feeder.error!r}")
        check(time.perf_counter() < deadline, "no 32 answers within 120 s")
        time.sleep(0.01)
    captures = []
    with tempfile.TemporaryDirectory() as tmp:
        # the job's first capture sets CUPTI up before its window opens;
        # the second starts at once. Each must hold the job's searches
        for i in range(2):
            t_call = time.perf_counter()
            rc, out, err = _cli(["profile", "--url", MONITORING_URL, "--seconds", str(seconds),
                                 "--out", os.path.join(tmp, f"capture{i}")])
            call_s = time.perf_counter() - t_call
            check(feeder.error is None and feeder.is_alive(), f"query feeder: {feeder.error!r}")
            check(rc == 0, f"cli profile --url (capture {i + 1}) exited {rc}: {err.strip()}")
            capture = profiler.last_capture()
            check(capture is not None and "error" not in capture, f"capture {i + 1}: {capture}")
            check(capture["trace_file"] in out, f"cli profile printed {out!r}")
            window = (capture["started_at"], capture["started_at"] + capture["seconds"])
            in_window = sum(window[0] <= t <= window[1] for t in answered)
            size = os.path.getsize(capture["trace_file"])
            kernels = knn = []
            if on_card:
                kernels = _trace_kernels(capture["trace_file"])
                knn = [e for e in kernels if "knn_block_topk" in e["name"]]
            log(f"  capture {i + 1}: cli profile --url over /profile?seconds={seconds:g} while 9b's "
                f"DocumentStore ({n_docs} docs, d = {DIM}) served: CUPTI set-up "
                f"{capture.get('setup_seconds', 0.0):.3f} s before the window, the call "
                f"{call_s:.1f} s; {in_window} queries answered in the window, trace {size} B with "
                f"{len(kernels)} CUDA kernel events, {len(knn)} of them knn_block_topk "
                f"({len(knn) / max(in_window, 1):.2f} a query); top kernels by device time: "
                f"{json.dumps(_top_kernels(kernels))}")
            check(in_window > 0, f"capture {i + 1}: no query was answered inside its window")
            check(not on_card or bool(knn), f"capture {i + 1}: the /profile trace holds no "
                                            "knn_block_topk kernel")
            captures.append({"setup_seconds": capture.get("setup_seconds"), "trace_bytes": size,
                             "kernel_events": len(kernels), "knn_events": len(knn),
                             "queries_in_window": in_window,
                             "top_kernels": _top_kernels(kernels)})
        stop.set()
        feeder.join(timeout=60)
        check(not feeder.is_alive() and feeder.error is None, f"query feeder: {feeder.error!r}")
        check((captures[0]["setup_seconds"] is not None) == on_card
              and captures[1]["setup_seconds"] is None,
              f"CUPTI set-up: {[c['setup_seconds'] for c in captures]}")
        rc, out, err = _cli(["status", "--url", f"{MONITORING_URL}/status", "--json"])
        check(rc == 0, f"cli status exited {rc}: {err.strip()}")
        status = json.loads(out)
        check(status["utilization"]["profiler"]["last"] == json.loads(json.dumps(capture)),
              "/status's utilization.profiler.last is not the second capture")
        check("memory" in status, "/status has no memory key")
        rc, frame, err = _cli(["top", "--url", f"{MONITORING_URL}/status", "--once"])
        check(rc == 0 and frame.startswith("pathway-tpu-torch top"), f"cli top: {rc} {err.strip()}")
    _stop_pipeline(query_q, runner)
    from pathway_tpu_torch.internals import runner as pw_runner

    pw_runner._last_engine = None
    gc.collect()
    log(f"  {'both captures hold knn_block_topk  ok; ' if on_card else ''}cli status --json: "
        "utilization.profiler.last is the second capture, memory key present  ok; cli top --once:")
    for line in frame.rstrip().splitlines():
        log(f"    {line}")
    log(f"  phase 13b {time.perf_counter() - t0:.1f} s [{card}]")
    return {"captures": captures}


_OVERSIZED_SCRIPT = """
import numpy as np

import pathway_tpu_torch as pw
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnFactory
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore


@pw.udf(max_batch_size=4096, deterministic=True, return_type=np.ndarray)
def embed(batch: list) -> list:
    return [np.ones({dim}, dtype=np.float32) for _ in batch]


docs = pw.io.jsonlines.read({docs!r}, schema=pw.schema_from_types(data=str), mode="streaming")
factory = BruteForceKnnFactory(dimensions={dim}, embedder=embed, reserved_space={rows})
store = DocumentStore(docs, retriever_factory=factory)
queries = pw.debug.table_from_rows(DocumentStore.RetrieveQuerySchema, [("q", 6, None, None)])
pw.io.subscribe(store.retrieve_query(queries), on_change=lambda *a, **k: None)
pw.run()
"""


def run_cli_on_card(card: str, on_card: bool = True, seconds: float = 2.0) -> dict:
    """13c: `pathway-tpu-torch analyze --json` on a script whose
    DocumentStore reserves more index rows than the card holds (PWT603
    against the card's own total memory), run in this process so that the
    allocator can show it built nothing; then `profile --device`, whose
    Chrome trace must hold the calibration matmul's bf16 GEMM kernel."""
    from pathway_tpu_torch.cli import main as cli_main
    from pathway_tpu_torch.internals import runner as pw_runner

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "oversized.py")
        with open(script, "w") as f:
            f.write(_OVERSIZED_SCRIPT.format(dim=DIM, rows=N_OVERSIZED_ROWS,
                                             docs=os.path.join(tmp, "docs")))
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            allocated0 = torch.cuda.memory_allocated()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["analyze", script, "--json"])
        check(rc == 0, f"cli analyze exited {rc}")
        if on_card:
            torch.cuda.synchronize()
            check(torch.cuda.memory_allocated() == allocated0
                  and torch.cuda.max_memory_allocated() == allocated0,
                  "cli analyze allocated on the card")
        payload = json.loads(buf.getvalue())
        pwt603 = [f for f in payload["findings"] if f["code"] == "PWT603"]
        check(len(pwt603) == 1 and pwt603[0]["severity"] == "error",
              f"no PWT603 ERROR: {[f['code'] for f in payload['findings']]}")
        (row,) = payload["capacity"]["indexes"]
        check(row["index_bytes"] == N_OVERSIZED_ROWS * (4 * DIM + 1),
              f"predicted {row['index_bytes']} B for {N_OVERSIZED_ROWS} rows at d = {DIM}")
        capacity = payload["capacity"]["hbm_capacity_bytes"]
        if on_card:
            total = torch.cuda.get_device_properties(0).total_memory
            check(capacity == total and pwt603[0]["details"]["hbm_capacity_bytes"] == total,
                  f"PWT603 judged against {capacity} B, not the card's {total} B")
        log(f"  cli analyze --json, a DocumentStore reserving {N_OVERSIZED_ROWS} rows at d = {DIM}: "
            f"PWT603 ({pwt603[0]['message'][:120]}...); predicted {row['index_bytes']} B against "
            f"the card's {capacity} B; nothing allocated on the card (memory_allocated and its "
            f"peak unchanged)  ok")
        pw_runner._last_engine = None
        if not on_card:
            return {"pwt603": pwt603[0]["details"]}
        out_dir = os.path.join(tmp, "device")
        rc, out, err = _cli(["profile", "--device", "--seconds", str(seconds), "--out", out_dir])
        check(rc == 0, f"cli profile --device exited {rc}: {err.strip()}")
        traces = [os.path.join(out_dir, f) for f in os.listdir(out_dir) if f.endswith(".json")]
        check(len(traces) == 1, f"cli profile --device wrote {traces}")
        kernels = _trace_kernels(traces[0])
        gemms = [e["name"] for e in kernels
                 if any(w in e["name"].lower() for w in ("gemm", "xmma", "nvjet", "cutlass"))]
        check(bool(gemms), f"the --device trace holds no GEMM kernel: {_top_kernels(kernels)}")
        bf16 = [n for n in gemms if "bf16" in n.lower()]
        size = os.path.getsize(traces[0])
    log(f"  cli profile --device --seconds {seconds:g}: trace {size} B, {len(kernels)} kernel "
        f"events, {len(gemms)} GEMM kernels ({len(bf16)} named bf16), e.g. {gemms[0][:100]}; top "
        f"kernels: {json.dumps(_top_kernels(kernels))}  ok; phase 13c "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    return {"pwt603": pwt603[0]["details"], "gemm_kernels": len(gemms), "trace_bytes": size}


def check_flash_gradients(flash_attention, reference_attention) -> dict:
    """13d: the flash repair on the card. Gradients of q, k and v through
    the kernel (the card's forward inside its autograd function, whose
    backward recomputes the plain version) against the CPU path's at
    [2, 4, 256, 64], f32 and bf16, causal and not, with a ragged mask: the
    forward at phase 3's tolerances on rows with a live key, the gradients
    at GRAD_TOL. Under no_grad the wrapper launches exactly what it did
    (one kernel a call, no autograd record); with grad the backward adds
    no launch. Its own generator."""
    gen = torch.Generator().manual_seed(21)
    b, h, l, d = 2, 4, 256, 64
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            q, k, v, g = (torch.randn((b, h, l, d), generator=gen) for _ in range(4))
            lens = torch.randint(1, l + 1, (b,), generator=gen)
            mask = (torch.arange(l)[None, :] < lens[:, None]).to(torch.int32)
            leaves = {}
            for where in ("cuda", "cpu"):
                ts = [t.to(where, dtype).requires_grad_() for t in (q, k, v)]
                before = flash_attention.launches
                out = flash_attention(*ts, mask.to(where), causal=causal)
                if where == "cuda":
                    check(flash_attention.launches == before + 1, "flash forward: no launch")
                    check(out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__,
                          f"flash output on the card has grad_fn {out.grad_fn}")
                (out.float() * g.to(where)).sum().backward()
                if where == "cuda":
                    check(flash_attention.launches == before + 1, "flash backward launched a kernel")
                leaves[where] = (out.detach().float().cpu(), [t.grad.float().cpu() for t in ts])
            fwd = live_rows_err(leaves["cuda"][0], leaves["cpu"][0], mask)
            check(fwd <= (2e-2 if dtype == torch.bfloat16 else 1e-4),
                  f"flash forward {dtype} causal={causal}: error {fwd}")
            errs = []
            for name, got, want in zip("qkv", leaves["cuda"][1], leaves["cpu"][1]):
                e = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
                check(e <= GRAD_TOL[dtype], f"d{name} {dtype} causal={causal}: error {e}")
                errs.append(e)
            key = f"{str(dtype).split('.')[-1]}, causal={causal}"
            worst[key] = {"forward": fwd, "grad": max(errs)}
            log(f"  flash [{b},{h},{l},{d}] {key}, ragged mask: forward max |err| {fwd:.3g}; "
                f"dq / dk / dv error (share of max(1, |grad|)) "
                f"{' / '.join(f'{e:.3g}' for e in errs)} (tolerance {GRAD_TOL[dtype]:g})  ok")
    q = torch.randn((b, h, l, d), generator=gen).cuda().bfloat16().requires_grad_()
    before = flash_attention.launches
    with torch.no_grad():
        out = flash_attention(q, q, q)
    check(flash_attention.launches == before + 1 and out.grad_fn is None,
          "flash under no_grad: not one plain launch")
    log("  under torch.no_grad(): one launch a call and no autograd record, as before the "
        "repair  ok")
    return worst


# -- phase 14: the declarative path ---------------------------------------------

# 14a: a team's document folder, one plaintext file a document
N_QA_DOCS = 4096
QA_WORDS = (300, 450)  # words a document; the splitter's min / max tokens
# the decoder's cache: 6 context docs of up to 450 words and the template
# fit whole, and the prefill (over 256 tokens) takes flash at head dim 128
QA_DECODER_LEN = 4096
# 14b: a fact table and its dimension table
N_SQL_ROWS = 1_000_000
N_SQL_USERS = 1000
N_SQL_CATEGORIES = 40
# pw.sql against sqlite3: exact for integers and strings, floats to 1e-9
# relative (SUM and AVG add 25,000 amounts in another order)
SQL_REL = 1e-9
SQL_QUERIES = {
    "group_by_having": (
        "SELECT category, SUM(amount) AS total, COUNT(*) AS n, AVG(amount) AS mean "
        "FROM sales GROUP BY category HAVING COUNT(*) > 100"
    ),
    "join_using": "SELECT region, tier, category, amount FROM sales JOIN users USING (user)",
    "rank_over_partition": (
        "SELECT user, ts, amount, RANK() OVER (PARTITION BY user ORDER BY amount DESC) AS r "
        "FROM sales"
    ),
}
# 14c
N_REPLAY_ROWS = 20_000
REPLAY_RATE = 1e6  # rows/s asked of pw.demo.replay_csv: it sleeps 1 / rate a row


def _yaml_args(args: dict, indent: int) -> str:
    return "".join(f"{' ' * indent}{k}: {v}\n" for k, v in args.items())


def qa_app_yaml(docs_dir: str, port: int, *, embedder: dict, generator: dict,
                reserved_space: int, dimensions: int, splitter: tuple = QA_WORDS,
                search_topk: int = RAG_TOPK, max_new_tokens: int = RAG_NEW_TOKENS) -> str:
    """The demo-question-answering template's app.yaml (Pathway's LLM app:
    fs sources, parser, splitter, embedder, BruteForceKnnFactory,
    DocumentStore, BaseRAGQuestionAnswerer, host and port), with the
    port's local models in place of the template's hosted ones:
    SentenceTransformerEmbedder(**embedder) and HFPipelineChat over
    ChatModel.cached(**generator). A `device` entry in either dict places
    that model; tests/test_torch_yaml.py loads the same text at a small
    size in both packages."""
    return (
        "$sources:\n"
        "  - !pw.io.fs.read\n"
        f"    path: {json.dumps(docs_dir)}\n"
        "    format: binary\n"
        "    with_metadata: true\n"
        "\n"
        "$parser: !pw.xpacks.llm.parsers.Utf8Parser\n"
        "\n"
        "$splitter: !pw.xpacks.llm.splitters.TokenCountSplitter\n"
        f"  min_tokens: {splitter[0]}\n"
        f"  max_tokens: {splitter[1]}\n"
        "\n"
        "$embedder: !pw.xpacks.llm.embedders.SentenceTransformerEmbedder\n"
        + _yaml_args(embedder, 2)
        + "\n"
        "$retriever_factory: !pw.stdlib.indexing.BruteForceKnnFactory\n"
        f"  reserved_space: {reserved_space}\n"
        "  embedder: $embedder\n"
        f"  dimensions: {dimensions}\n"
        "\n"
        "$llm: !pw.xpacks.llm.llms.HFPipelineChat\n"
        f"  model: {generator['model']}\n"
        f"  max_new_tokens: {max_new_tokens}\n"
        "  generator: !pw.models.decoder_lm.ChatModel.cached\n"
        + _yaml_args(generator, 4)
        + "\n"
        "$document_store: !pw.xpacks.llm.document_store.DocumentStore\n"
        "  docs: $sources\n"
        "  parser: $parser\n"
        "  splitter: $splitter\n"
        "  retriever_factory: $retriever_factory\n"
        "\n"
        "question_answerer: !pw.xpacks.llm.question_answering.BaseRAGQuestionAnswerer\n"
        "  llm: $llm\n"
        "  indexer: $document_store\n"
        f"  search_topk: {search_topk}\n"
        "\n"
        "host: 127.0.0.1\n"
        f"port: {port}\n"
    )


def write_text_docs(docs, directory: str) -> None:
    """One plaintext file a document, as a document folder holds them."""
    os.makedirs(directory)
    for i, d in enumerate(docs):
        with open(os.path.join(directory, f"doc_{i:05d}.txt"), "w") as fh:
            fh.write(d)


def qa_docs(n: int, rng: random.Random, words: tuple = QA_WORDS) -> list[str]:
    """Documents of words[0]..words[1] random words and an id."""
    return [" ".join(rng.choices(_WORDS, k=rng.randint(*words))) + f" doc{i}" for i in range(n)]


def serve_declared_app(config: dict, n_docs: int, queries, concurrent, probe: str,
                       retrieve_k: int = RAG_TOPK) -> dict:
    """The app that load_yaml built, served as its template's app.py
    serves it: question_answerer.build_server(host, port), then
    run_server(threaded=True); driven by RAGClient. Waits for
    /v1/statistics to count every doc and the probe to find its doc, then
    sends the sequential and the concurrent /v2/answer (with
    return_context_docs) and /v1/retrieve for each sequential query. The
    index's search_texts answers the same queries before the engine
    stops."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import runner as pw_runner
    from pathway_tpu_torch.ops.kernels import flash_attention, knn_topk
    from pathway_tpu_torch.xpacks.llm.question_answering import RAGClient

    qa = config["question_answerer"]
    qa.build_server(config["host"], config["port"])
    client = RAGClient(config["host"], config["port"], timeout=300)
    t0 = time.perf_counter()
    server = qa.run_server(threaded=True)
    out: dict = {}
    try:
        out.update(_wait_until_served(client, server, t0, n_docs, probe, 600.0))
        out.update(_ask_answers(client, queries, concurrent))
        out["retrieve"] = [client.retrieve(q, k=retrieve_k) for q in queries]
        # the kernels the served requests launched, before any check
        out["flash_launches"] = dict(flash_attention.launches_by_instance)
        out["knn_launches"] = knn_topk.launches
        from pathway_tpu_torch.engine.index_node import ExternalIndexNode

        # one index node for each route that searches (answer, retrieve, ...)
        nodes = [n for n in pw_runner.last_engine().nodes if isinstance(n, ExternalIndexNode)]
        # each searching route (/v1/pw_ai_answer, /v2/answer, /v1/retrieve)
        # builds an index of its own over the same chunks, as in the JAX
        # package; they hold the same rows from the same encoder
        check(all(len(n.index.knn) == len(nodes[0].index.knn) > 0 for n in nodes),
              f"index rows: {[len(n.index.knn) for n in nodes]}")
        # each index ingested through its DevicePipeline, which an error on
        # the card (e.g. out of memory) would have disabled
        stats = [n.index._pipeline.stats() if n.index._pipeline is not None else {}
                 for n in nodes]
        check(all(not n.index._pipeline_broken for n in nodes)
              and all(st.get("dispatched", 0) > 0 for st in stats),
              f"an index's DevicePipeline broke or ran no batch: {stats}")
        out["index_nodes"] = len(nodes)
        out["dispatches"] = [st["dispatched"] for st in stats]
        out["direct"] = nodes[0].index.fused.search_texts(list(queries), retrieve_k)
        out["node"] = nodes[0]
    finally:
        engine = pw_runner.last_engine()
        if engine is not None:
            engine.terminate_flag.set()
        server.join(timeout=60)
        pw.G.clear()
    check(not server.is_alive(), "the app's engine did not stop")
    return out


def run_declarative_app(card: str, n_docs: int = N_QA_DOCS, device=None) -> dict:
    """14a: the demo-question-answering template declared in YAML
    (qa_app_yaml) at full width on the card, loaded by pw.load_yaml and
    served over REST. Each sequential answer against generate() on the
    prompt the app built, each answer's context against /v1/retrieve,
    /v1/retrieve against the index's search_texts; flash at D = 32 (the
    encoder over chunks of 300-450 tokens) and D = 128 (the prefills).
    `device="cpu"` rehearses the phase with the manifest's `device: cpu`
    lines, the tiny decoder, documents of 20-30 words and k = 2."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import utilization
    from pathway_tpu_torch.models import decoder_lm
    from pathway_tpu_torch.ops.kernels import flash_attention, knn_topk

    on_card = device is None
    words, topk = (QA_WORDS, RAG_TOPK) if on_card else ((20, 30), 2)
    embedder_args = {"model": "all-MiniLM-L6-v2", "max_len": 512}
    generator_args = ({"model": "mistral-7b", "max_len": QA_DECODER_LEN} if on_card
                      else {"model": "tiny-decoder", "max_len": 128})
    if not on_card:
        embedder_args["device"] = generator_args["device"] = device
    t_phase = time.perf_counter()
    _collect_earlier_phases()  # the engines and models of the phases before
    docs = qa_docs(n_docs, random.Random(31), words)
    queries = make_prompts(RAG_QUERIES, random.Random(37), 8, 16)
    concurrent = make_prompts(RAG_QUERIES, random.Random(41), 8, 16)
    cached_before = len(decoder_lm._model_cache)
    with tempfile.TemporaryDirectory() as tmp:
        docs_dir = os.path.join(tmp, "documents")
        write_text_docs(docs, docs_dir)
        text = qa_app_yaml(docs_dir, _free_port(), embedder=embedder_args,
                           generator=generator_args, reserved_space=n_docs, dimensions=DIM,
                           splitter=words, search_topk=topk)
        t_load = time.perf_counter()
        config = pw.load_yaml(text)
        load_s = time.perf_counter() - t_load
        qa = config["question_answerer"]
        generator = qa.llm.generator
        embedder = qa.indexer.retriever_factory.embedder
        want = "cuda" if on_card else device
        check(generator.device.type == want and embedder.encoder.device.type == want,
              f"the manifest's models are not on {want}")
        check(len(decoder_lm._model_cache) == cached_before + 1,
              "the manifest's ChatModel.cached did not build a model of its own")
        check(not on_card or (generator.config.hidden == 4096 and generator.config.layers == 32),
              "the manifest's decoder is not at full width")
        check(embedder.encoder.config.hidden == DIM and embedder.encoder.max_len == 512,
              "the manifest's encoder is not MiniLM-L6 at max_len 512")
        knn_topk.launches = 0
        flash_attention.launches = 0
        flash_attention.launches_by_instance = {}
        # the window scoped to this run, as 9a, 10 and 13b scope theirs
        utilization.reset_window()
        served = serve_declared_app(config, n_docs, queries, concurrent, docs[-1], topk)
    launches = {"flash_attention": sum(served["flash_launches"].values()),
                "knn_topk": served["knn_launches"], "by_instance": served["flash_launches"]}
    served_s = time.perf_counter() - t_phase

    for q, ans, ret in zip(queries, served["answers"], served["retrieve"]):
        ctx = ans["context_docs"]
        check([d["text"] for d in ctx] == [d["text"] for d in ret] and len(ctx) == topk,
              f"query {q!r}: context docs differ from /v1/retrieve's top {topk}")
    exact, drift, tie_tol = agrees_with_search_texts(
        served["retrieve"], served["direct"], served["node"], topk)
    prompts = _rag_prompts(queries, [a["context_docs"] for a in served["answers"]])
    lengths = [int(generator.encode_prompts([p], RAG_NEW_TOKENS)[1].sum()) for p in prompts]
    check(max(lengths) <= generator.max_len - RAG_NEW_TOKENS, f"prompts of {lengths} tokens were cut")
    for q, p, ans in zip(queries, prompts, served["answers"]):
        direct = generator.generate([p], max_new_tokens=RAG_NEW_TOKENS)[0]
        check(isinstance(ans["response"], str) and ans["response"] == direct,
              f"query {q!r}: the served answer differs from generate() on its prompt")
    # (the tiny decoder's replies decode to '': at its init it repeats the
    # prompt's reserved last token)
    check(all(isinstance(r, dict) and isinstance(r.get("response"), str)
              and (r["response"] or not on_card) and len(r.get("context_docs", ())) == topk
              for r in served["concurrent"]), f"concurrent answers: {served['concurrent']}")
    by_instance = launches["by_instance"]
    if on_card:
        check(by_instance.get("bf16<32>", 0) > 0,
              f"the encoder launched no flash at D = 32: {by_instance}")
        check(by_instance.get("bf16<128>", 0) > 0,
              f"the prefills launched no flash at D = 128: {by_instance}")
        # the kernel at the lengths these prompts reach (phase 6 holds it
        # at 700-1,000 words, phase 3 at L = 1024)
        batch = _rag_prompts(concurrent, [r["context_docs"] for r in served["concurrent"]])
        probe = probe_served_prefills(flash_attention, generator, prompts, batch,
                                      "the app's prefills")
    lat = served["lat_ms"]
    log(f"  pw.load_yaml (PyYAML) of the demo-question-answering app.yaml in {load_s:.1f} s (it "
        f"builds ChatModel.cached({generator_args}) anew, random weights, and MiniLM-L6 at max_len "
        f"512): {n_docs} plaintext docs of {words[0]}-{words[1]} words -> fs.read(binary, "
        f"with_metadata) -> Utf8Parser -> TokenCountSplitter({words[0]}, {words[1]}) -> "
        f"SentenceTransformerEmbedder -> BruteForceKnnFactory -> DocumentStore -> "
        f"BaseRAGQuestionAnswerer(HFPipelineChat({generator_args['model']})), build_server + "
        f"run_server(threaded=True): store ready {served['ready_s']:.3f} s (every doc counted at "
        f"{served['counted_s']:.3f} s), {n_docs / served['ready_s']:.1f} docs/s indexed [{card}]")
    log(f"  {RAG_QUERIES} sequential /v2/answer (k = {topk}, prompts of {min(lengths)}-"
        f"{max(lengths)} tokens): p50 {np.percentile(lat, 50):.1f} ms, p90 "
        f"{np.percentile(lat, 90):.1f} ms (n = {len(lat)}), max {max(lat):.1f} ms; "
        f"{RAG_QUERIES} concurrent in {served['concurrent_s']:.3f} s wall; {served['index_nodes']} "
        f"index nodes (one for each searching route, each over every chunk; DevicePipeline "
        f"batches {served['dispatches']}); flash launches by "
        f"instance {json.dumps(by_instance, sort_keys=True)}, knn_topk {launches['knn_topk']} [{card}]")
    log(f"  every answer's context_docs = /v1/retrieve's top {topk}; /v1/retrieve against "
        f"search_texts on the index: top-{topk} equal in order in {exact}/{len(queries)}, the "
        f"rest within near-ties of {tie_tol:.3g} (largest score drift {drift:.3g}); every "
        f"sequential answer = generate([prompt], max_new_tokens={RAG_NEW_TOKENS})  ok")
    if on_card:
        log_probed_prefills(probe, generator, lengths)
    del config, qa, generator, embedder, served
    _collect_earlier_phases()
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 14a wall {phase_s:.1f} s (served {served_s:.1f} s)")
    return {"launches": launches, "p50_ms": float(np.percentile(lat, 50)), "phase_s": phase_s}


def make_sales_db(path: str, n_sales: int, n_users: int, n_categories: int, seed: int = 0) -> None:
    """The fact table `sales (id INTEGER PRIMARY KEY, user TEXT, category
    TEXT, amount REAL, ts INTEGER)` and the dimension table `users (user
    TEXT PRIMARY KEY, region TEXT, tier INTEGER)`, drawn by numpy's
    generator from `seed`."""
    import sqlite3

    rng = np.random.default_rng(seed)
    users = [f"u{i:05d}" for i in range(n_users)]
    cats = [f"c{i:02d}" for i in range(n_categories)]
    u = rng.integers(0, n_users, n_sales).tolist()
    c = rng.integers(0, n_categories, n_sales).tolist()
    amount = np.round(rng.random(n_sales) * 1000.0, 2).tolist()
    ts = rng.integers(0, 10**9, n_sales).tolist()
    con = sqlite3.connect(path)
    con.execute(
        "CREATE TABLE sales (id INTEGER PRIMARY KEY, user TEXT, category TEXT, "
        "amount REAL, ts INTEGER)"
    )
    con.execute("CREATE TABLE users (user TEXT PRIMARY KEY, region TEXT, tier INTEGER)")
    con.executemany(
        "INSERT INTO sales VALUES (?, ?, ?, ?, ?)",
        zip(range(1, n_sales + 1), (users[i] for i in u), (cats[i] for i in c), amount, ts),
    )
    con.executemany(
        "INSERT INTO users VALUES (?, ?, ?)",
        ((users[i], f"r{i % 7}", i % 3) for i in range(n_users)),
    )
    con.commit()
    con.close()


def sqlite_tables(pw, path: str) -> dict:
    """`sales` and `users` read by pw.io.sqlite.read in static mode."""

    class Sales(pw.Schema, primary_key=["id"]):
        id: int
        user: str
        category: str
        amount: float
        ts: int

    class Users(pw.Schema, primary_key=["user"]):
        user: str
        region: str
        tier: int

    return {
        "sales": pw.io.sqlite.read(path, "sales", Sales, mode="static"),
        "users": pw.io.sqlite.read(path, "users", Users, mode="static"),
    }


def rows_agree(got, want, rel: float = SQL_REL) -> bool:
    """Two sorted row lists: equal, floats within `rel` relative."""
    def same(a, b) -> bool:
        if isinstance(a, float) or isinstance(b, float):
            return math.isclose(a, b, rel_tol=rel, abs_tol=0.0)
        return type(a) is type(b) and a == b

    return len(got) == len(want) and all(
        len(g) == len(w) and all(map(same, g, w)) for g, w in zip(got, want))


def run_sql_on_sqlite(card: str, n_rows: int = N_SQL_ROWS) -> dict:
    """14b: pw.sql over pw.io.sqlite.read: a GROUP BY ... HAVING, a
    JOIN ... USING and a RANK() OVER (PARTITION BY ... ORDER BY ...) over
    the same two tables in one run, each result against sqlite3 running
    the same SQL on the same file."""
    import sqlite3

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.runner import run_tables

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sales.db")
        t0 = time.perf_counter()
        make_sales_db(path, n_rows, N_SQL_USERS, N_SQL_CATEGORIES)
        made_s = time.perf_counter() - t0
        pw.G.clear()
        tables = sqlite_tables(pw, path)
        results = [pw.sql(q, **tables) for q in SQL_QUERIES.values()]
        t0 = time.perf_counter()
        caps = run_tables(*results)
        run_s = time.perf_counter() - t0
        pw.G.clear()
        con = sqlite3.connect(path)
        for (name, q), cap in zip(SQL_QUERIES.items(), caps):
            t1 = time.perf_counter()
            want = sorted(con.execute(q).fetchall())
            ref_s = time.perf_counter() - t1
            got = sorted(cap.state.rows.values())
            check(rows_agree(got, want), f"{name}: pw.sql's {len(got)} rows differ from sqlite3's "
                                         f"{len(want)} ({got[:2]} vs {want[:2]})")
            log(f"  {name}: {len(got)} rows = sqlite3's (sqlite3 took {ref_s:.2f} s)  ok")
        con.close()
    log(f"  pw.io.sqlite.read(static) of {n_rows} sales rows and {N_SQL_USERS} users -> pw.sql "
        f"({', '.join(SQL_QUERIES)}) in one run: {run_s:.2f} s, {n_rows / run_s:.1f} rows/s "
        f"(the file written in {made_s:.1f} s) [{card}]")
    return {"rows_per_s": n_rows / run_s}


def run_demo_replay(card: str, n_rows: int = N_REPLAY_ROWS) -> dict:
    """14c: pw.demo.replay_csv at REPLAY_RATE rows/s -> groupby(key)
    .reduce(count, sum) -> pw.io.subscribe, the final groups against
    plain Python."""
    import csv

    import pathway_tpu_torch as pw

    rng = random.Random(43)
    rows = [(f"k{rng.randrange(64)}", rng.randrange(1000)) for _ in range(n_rows)]
    want: dict = {}
    for k, v in rows:
        n, s = want.get(k, (0, 0))
        want[k] = (n + 1, s + v)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "replay.csv")
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["key", "value"])
            w.writerows(rows)
        pw.G.clear()
        t = pw.demo.replay_csv(path, schema=pw.schema_from_types(key=str, value=int),
                               input_rate=REPLAY_RATE)
        groups = t.groupby(pw.this.key).reduce(
            key=pw.this.key, n=pw.reducers.count(), total=pw.reducers.sum(pw.this.value))
        state: dict = {}

        def on_change(key, row, time, is_addition):  # noqa: A002
            if is_addition:
                state[row["key"]] = (row["n"], row["total"])
            elif state.get(row["key"]) == (row["n"], row["total"]):
                del state[row["key"]]

        pw.io.subscribe(groups, on_change=on_change)
        t0 = time.perf_counter()
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        elapsed = time.perf_counter() - t0
        pw.G.clear()
    check(state == want, f"replay groups: {len(state)} of {len(want)} equal "
                         f"{sum(state.get(k) == v for k, v in want.items())}")
    log(f"  pw.demo.replay_csv({n_rows} rows, input_rate={REPLAY_RATE:g}) -> groupby(key).reduce("
        f"count, sum) -> subscribe: {elapsed:.2f} s, {n_rows / elapsed:.1f} rows/s, "
        f"{len(want)} groups = plain Python  ok [{card}]")
    return {"rows_per_s": n_rows / elapsed}


# -- phase 15: training and the model-parallel core -------------------------------

# 15a / 15b: MiniLM-L6's widths, causal, pooling none, as the JAX package's
# multichip training check configures its model; 16 texts of 512 tokens
TRAIN_ROWS, TRAIN_LEN, TRAIN_STEPS, TRAIN_LR = 16, 512, 5, 1e-3
# 15c: the 7B geometry's full context over an sp axis of 4 on the one card;
# the last SP_PAD positions are padding
SP_LEN, SP, SP_PAD = 4096, 4, 333
# step 1 through flash against the same step with dense attention: the two
# differ only in the rounding of the attention forward's bf16 output
# (phase 3: 2e-2 on unit inputs), carried through 6 bf16 layers. The loss
# within 2e-3 relative; each gradient leaf within 0.1 of its largest |g|
# (a bias gradient sums 8,192 tokens' terms with much cancellation;
# tests/test_torch_training.py holds the port against the JAX package at
# the same bf16 tolerance)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 2e-3, 0.1
# the sharded step's new params against the unsharded step's: each leaf's
# difference within 0.1 of the unsharded update's largest |value| (the row
# shards' partial products round to bf16 before their psum, as the
# gradients above), plus f32 rounding of the leaf (1e-6 of its largest)
SHARD_UPDATE_TOL = 0.1
SP_COSINE = 0.999


def _train_config():
    import dataclasses

    from pathway_tpu_torch.models.transformer import MINILM_L6

    return dataclasses.replace(MINILM_L6, causal=True, pooling="none", max_len=TRAIN_LEN)


def _train_inputs(config, seed: int = 13):
    """Seeded weights drawn on the card and the batch: ids, an all-live
    mask and next-token labels."""
    from pathway_tpu_torch.models.transformer import init_params

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(gen, config)
    ids = torch.randint(0, config.vocab_size, (TRAIN_ROWS, TRAIN_LEN), device="cuda", generator=gen)
    mask = torch.ones_like(ids, dtype=torch.int32)
    return params, ids, mask, torch.roll(ids, -1, dims=1)


def train_step_bound(config, rows: int, length: int) -> dict:
    """The least time of one training step on the card: forward and
    backward are 3x the forward's products. bf16: the layers' dense
    products, 2 H (4 H + 2 MLP) a token a layer, and causal attention,
    4 D a (query, key) pair with key <= query, at 989 TFLOP/s; f32: the
    tied logits, 2 H V a token, at 67 TFLOP/s (no TF32)."""
    h, layers = config.hidden, config.layers
    tokens = rows * length
    dense = 2 * tokens * h * (4 * h + 2 * config.mlp_dim) * layers
    attn = 4 * rows * config.heads * (length * (length + 1) / 2) * config.head_dim * layers
    bf16_ms = 3 * (dense + attn) / BF16_FLOPS * 1e3
    f32_ms = 3 * 2 * tokens * h * config.vocab_size / F32_FLOPS * 1e3
    return {"bf16_ms": bf16_ms, "f32_ms": f32_ms, "bound_ms": bf16_ms + f32_ms}


def _leaf_errors(got, want) -> float:
    """The largest, over leaves, of max |got - want| / max |want|."""
    from pathway_tpu_torch.models.transformer import _leaves

    worst = 0.0
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        scale = b.float().abs().max().item()
        worst = max(worst, (a.float() - b.float()).abs().max().item() / max(scale, 1e-30))
    return worst


def _step_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def run_train_step(card: str, flash_attention, reference_attention) -> dict:
    """15a: make_train_step at MiniLM-L6 width on the card, 5 steps on one
    batch; step 1's loss and gradients against dense attention's."""
    from pathway_tpu_torch.models.training import loss_and_grads, make_train_step

    config = _train_config()
    params, ids, mask, labels = _train_inputs(config)
    flash_attention.launches_by_instance = {}
    loss_f, grads_f = loss_and_grads(params, config, ids, mask, labels)
    check(flash_attention.launches_by_instance == {"bf16<32>": config.layers},
          f"15a: a step through flash launched {flash_attention.launches_by_instance}")
    loss_d, grads_d = loss_and_grads(params, config, ids, mask, labels, use_flash=False)
    loss_err = abs(float(loss_f) - float(loss_d)) / abs(float(loss_d))
    grad_err = _leaf_errors(grads_f, grads_d)
    check(loss_err <= TRAIN_LOSS_TOL, f"15a: step 1's loss through flash {float(loss_f)} against "
          f"dense attention's {float(loss_d)}")
    check(grad_err <= TRAIN_GRAD_TOL, f"15a: a gradient through flash is off by {grad_err} of its "
          f"leaf's largest")
    log(f"  step 1 through flash against dense attention: loss {float(loss_f):.6f} / "
        f"{float(loss_d):.6f} (rel err {loss_err:.3g}, tol {TRAIN_LOSS_TOL}), gradients within "
        f"{grad_err:.4f} of their leaf's largest |g| (tol {TRAIN_GRAD_TOL}) over "
        f"{len(list(_tensors(grads_f)))} leaves  ok")
    del grads_f, grads_d

    step = make_train_step(config, TRAIN_LR)
    losses, times = [], []
    flash_attention.launches = 0
    flash_attention.launches_by_instance = {}
    for _ in range(TRAIN_STEPS):
        out = {}
        times.append(_step_ms(lambda: out.update(loss=step(params, ids, mask, labels)[1])))
        losses.append(float(out["loss"]))
    launches = flash_attention.launches
    check(flash_attention.launches_by_instance == {"bf16<32>": config.layers * TRAIN_STEPS},
          f"15a: {TRAIN_STEPS} steps launched {flash_attention.launches_by_instance}")
    check(all(math.isfinite(x) for x in losses), f"15a: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"15a: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    ms = float(np.median(times))
    bound = train_step_bound(config, TRAIN_ROWS, TRAIN_LEN)

    # the backward's attention recompute (reference_attention, differentiated;
    # the JAX package's design), timed alone at one layer's shape
    gen = torch.Generator(device="cuda").manual_seed(14)
    shape = (TRAIN_ROWS, config.heads, TRAIN_LEN, config.head_dim)
    q, k, v, g = (torch.randn(shape, device="cuda", generator=gen).bfloat16() for _ in range(4))
    scale = config.head_dim ** -0.5

    def recompute():
        inputs = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.autograd.grad(reference_attention(*inputs, mask, scale, True), inputs, g)

    recompute_ms = median_ms(recompute, reps=5, inner=3)
    share = config.layers * recompute_ms / ms
    tokens = TRAIN_ROWS * TRAIN_LEN
    log(f"  {TRAIN_STEPS} steps of make_train_step(lr={TRAIN_LR}) on [{TRAIN_ROWS}, {TRAIN_LEN}]: "
        f"losses {[round(x, 6) for x in losses]}; {ms:.3f} ms a step (median; steps "
        f"{[round(t, 3) for t in times]}), {tokens / ms * 1e3:,.0f} tokens/s; bound "
        f"{bound['bound_ms']:.3f} ms (bf16 products {bound['bf16_ms']:.3f}, f32 logits "
        f"{bound['f32_ms']:.3f}), {bound['bound_ms'] / ms:.3f} of it; the backward's attention "
        f"recompute {recompute_ms:.3f} ms a layer, {share:.3f} of the step; flash launches "
        f"{launches} ({config.layers} a step, bf16<32>) [{card}]")
    return {"launches": launches, "ms": ms, "losses": losses, "recompute_share": share, **bound}


def run_sharded_train_step(card: str, flash_attention, unsharded_ms: float) -> dict:
    """15b: make_sharded_train_step over a (dp = 2, tp = 2) mesh laid on the
    one card, against the unsharded step on the same params and batch."""
    from pathway_tpu_torch.models.training import make_sharded_train_step, make_train_step
    from pathway_tpu_torch.models.transformer import _leaves, _rebuild, tp_gather
    from pathway_tpu_torch.parallel import get_mesh

    config = _train_config()
    params, ids, mask, labels = _train_inputs(config)
    mesh = get_mesh((2, 2), ("dp", "tp"), devices=["cuda:0"] * 4)
    shard_launches = 2 * 2 * config.layers
    step, place_params, place_batch = make_sharded_train_step(mesh, config, TRAIN_LR)
    shards = place_params(params)  # a copy: `params` stays as drawn
    batch = place_batch(ids, mask, labels)
    flash_attention.launches = 0
    flash_attention.launches_by_instance = {}
    shards, loss = step(shards, *batch)
    launches = flash_attention.launches
    check(flash_attention.launches_by_instance == {"bf16<32>": shard_launches},
          f"15b: a sharded step launched {flash_attention.launches_by_instance}")
    gathered = tp_gather(shards, config, mesh)
    gathered = _rebuild(gathered, (p.clone() for p in _leaves(gathered)))

    reference = _rebuild(params, (p.clone() for p in _leaves(params)))
    reference, loss_u = make_train_step(config, TRAIN_LR)(reference, ids, mask, labels)
    loss_err = abs(float(loss) - float(loss_u)) / abs(float(loss_u))
    check(loss.device == mesh.devices.flat[0], f"15b: the loss is on {loss.device}")
    check(loss_err <= TRAIN_LOSS_TOL,
          f"15b: the sharded loss {float(loss)} against the unsharded {float(loss_u)}")
    worst = 0.0
    for new, want, old in zip(_leaves(gathered), _leaves(reference), _leaves(params), strict=True):
        err = (new - want).abs().max().item()
        allowed = (SHARD_UPDATE_TOL * (want - old).abs().max().item()
                   + 1e-6 * old.abs().max().item())
        check(err <= allowed, f"15b: a new param is off by {err} (allowed {allowed})")
        worst = max(worst, err / allowed)
    log(f"  the sharded step against the unsharded: loss {float(loss):.6f} / {float(loss_u):.6f} "
        f"(rel err {loss_err:.3g}), every new param within {worst:.3f} of its tolerance "
        f"({SHARD_UPDATE_TOL} of the update's largest)  ok")
    del gathered, reference

    times = []
    flash_attention.launches = 0
    flash_attention.launches_by_instance = {}
    for _ in range(TRAIN_STEPS):
        times.append(_step_ms(lambda: step(shards, *batch)))
    check(flash_attention.launches_by_instance == {"bf16<32>": shard_launches * TRAIN_STEPS},
          f"15b: {TRAIN_STEPS} sharded steps launched {flash_attention.launches_by_instance}")
    launches += flash_attention.launches
    ms = float(np.median(times))
    log(f"  make_sharded_train_step over {mesh.shape} on one card: {ms:.3f} ms a step (median of "
        f"{TRAIN_STEPS}; 15a's unsharded step {unsharded_ms:.3f} ms, {ms / unsharded_ms:.2f}x); "
        f"flash launches {launches} over {TRAIN_STEPS + 1} steps ({shard_launches} a step, bf16<32> at "
        f"[{TRAIN_ROWS // 2}, {config.heads // 2}, {TRAIN_LEN}, {config.head_dim}]) [{card}]")
    return {"launches": launches, "ms": ms}


def _row_cosines(a, b):
    a, b = a.float(), b.float()
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1) + 1e-12)


def run_sequence_parallel(card: str, flash_attention) -> dict:
    """15c: sequence_parallel_forward at Mistral-7B geometry over an sp = 4
    mesh laid on the one card, ring and Ulysses, against the unsharded
    forward, all under no_grad."""
    from pathway_tpu_torch.models.long_context import sequence_parallel_forward
    from pathway_tpu_torch.models.transformer import MISTRAL_7B, _leaves, forward, init_params
    from pathway_tpu_torch.parallel import get_mesh

    config = MISTRAL_7B
    before = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(15)
    t0 = time.perf_counter()
    params = init_params(gen, config)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    ids = torch.randint(0, config.vocab_size, (1, SP_LEN), device="cuda", generator=gen)
    mask = torch.ones_like(ids, dtype=torch.int32)
    mask[:, SP_LEN - SP_PAD:] = 0
    mesh = get_mesh((SP,), ("sp",), devices=["cuda:0"] * SP)
    runs = {
        "unsharded": lambda: forward(params, config, ids, mask),
        "ring": lambda: sequence_parallel_forward(params, config, ids, mask, mesh, attn="ring"),
        "ulysses": lambda: sequence_parallel_forward(params, config, ids, mask, mesh, attn="ulysses"),
    }
    want_launches = {"unsharded": {"bf16<128>": config.layers}, "ring": {},
                     "ulysses": {"bf16<128>": config.layers * SP}}
    torch.cuda.reset_peak_memory_stats()
    outs, launches = {}, {}
    with torch.no_grad():
        for name, fn in runs.items():
            flash_attention.launches_by_instance = {}
            outs[name] = fn()
            torch.cuda.synchronize()
            launches[name] = dict(flash_attention.launches_by_instance)
            check(launches[name] == want_launches[name], f"15c: {name} launched {launches[name]}")
            check(outs[name].shape == (1, SP_LEN, config.vocab_size)
                  and bool(torch.isfinite(outs[name]).all()), f"15c: {name}: bad logits")
    peak = torch.cuda.max_memory_allocated()
    check(peak < 1.5 * param_bytes, f"15c: peak memory {peak} B against the params' {param_bytes} B: "
          f"replication copied")
    for name in ("ring", "ulysses"):
        cos = _row_cosines(outs[name][0], outs["unsharded"][0])
        err = (outs[name] - outs["unsharded"]).abs().max().item()
        check(cos.min().item() >= SP_COSINE, f"15c: {name} row cosine {cos.min().item()}")
        log(f"  {name} over sp = {SP} against the unsharded forward: {SP_LEN} rows, min cosine "
            f"{cos.min().item():.6f} (>= {SP_COSINE}), max |err| {err:.4g}, flash {launches[name]}  ok")
    outs.clear()
    with torch.no_grad():
        ms = {name: median_ms(fn, reps=3, inner=1) for name, fn in runs.items()}
    log(f"  Mistral-7B geometry (f32 params {param_bytes / 1e9:.2f} GB, drawn on the card in "
        f"{init_s:.2f} s; {before / 1e9:.2f} GB allocated before), [1, {SP_LEN}] with "
        f"{SP_PAD} padded: peak {peak / 1e9:.2f} GB, {peak / param_bytes:.3f}x the params; "
        + ", ".join(f"{name} {t:.1f} ms ({SP_LEN / t * 1e3:,.0f} tokens/s)" for name, t in ms.items())
        + f" [{card}]")
    return {"launches": launches, "ms": ms, "peak_bytes": peak, "param_bytes": param_bytes}


def time_flash_training_shapes(flash_attention, reference_attention) -> list:
    """Flash at phase 15's shapes, causal: the trainer's [16, 12, 512, 32],
    a tp shard's [8, 6, 512, 32], a Ulysses position's [1, 8, 4096, 128]
    and the unsharded 7B's [1, 32, 4096, 128] (the last two with 15c's
    padded tail)."""
    return time_flash_shapes(
        flash_attention, reference_attention,
        [(16, 12, 512, 32, True, 0), (8, 6, 512, 32, True, 0),
         (1, 8, SP_LEN, 128, True, SP_PAD), (1, 32, SP_LEN, 128, True, SP_PAD)],
        seed=151,
    )


def time_flash_shapes(flash_attention, reference_attention, shapes, seed: int,
                      rel: float = 0.0) -> list:
    """Flash in bf16 at each (b, h, l, d, causal, padded tail) of `shapes`
    against the plain version (each element on live rows within phase 3's
    2e-2 plus `rel` of its value: 2^-6, two bf16 ulps, is phase 6's
    per-layer rule, for outputs that reach |o| >= 4, where one ulp is
    2^-5) and scaled_dot_product_attention, with its bound: q, k, v read
    and the output written once at 3.35 TB/s, or the bf16 products of the
    pairs it must score (L (L + 1) / 2 a head when causal) at 989
    TFLOP/s."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for b, h, l, d, causal, pad in shapes:
        q, k, v = (torch.randn((b, h, l, d), device="cuda", generator=gen).bfloat16() for _ in range(3))
        mask = torch.ones((b, l), dtype=torch.int32, device="cuda")
        if pad:
            mask[:, l - pad:] = 0
        scale = d ** -0.5
        out = flash_attention(q, k, v, mask, causal=causal)
        ref = reference_attention(q, k, v, mask, scale, causal)
        err = live_rows_err(out, ref, mask)
        live = mask.sum(dim=1) > 0
        share = ((out.float() - ref.float()).abs()[live]
                 / (2e-2 + rel * ref.float().abs()[live])).max().item()
        check(share <= 1.0, f"flash_attention bf16 causal={causal} [{b},{h},{l},{d}]: error {err} "
                            f"({share:.3f} of 2e-2 + {rel} |o|)")
        ms = median_ms(lambda: flash_attention(q, k, v, mask, causal=causal))
        plain_ms = median_ms(lambda: reference_attention(q, k, v, mask, scale, causal), reps=5, inner=3)
        keep = None if causal else mask.bool()[:, None, None, :]
        library_ms = median_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep, is_causal=causal))
        pairs = b * h * l * ((l + 1) / 2 if causal else l)
        nbytes = 4 * q.numel() * 2 + mask.numel() * 4
        byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, 4.0 * pairs * d / BF16_FLOPS * 1e3
        log(f"  flash_attention [{b},{h},{l},{d}] bf16 causal={causal} (flash_fwd_bf16<{d}>): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention "
            f"{library_ms:.4f} ms, bound {max(byte_ms, op_ms):.4f} ms (bytes {byte_ms:.4f}, bf16 "
            f"products {op_ms:.4f}), max |err| {err:.3g}  ok")
        rows.append({
            "shape": [b, h, l, d], "causal": causal, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations", "library_ms": library_ms,
        })
    return rows


# -- phase 16: the data-plane mesh ------------------------------------------------

# 16a: the JAX package's tolerance for its tp encoder against the
# single-device one (tests/test_multichip.py), for the scores
MESH_SCORE_TOL = 2e-2
# 16c / 16d: row cosines against the unsharded model. The tp prefill's
# last-position logits within 0.999. Its decode steps within phase 6's
# bound for two KV-cached routes of this 7B (0.995): the unsharded
# decoder over the tp run's tokens sums the row shards' products in
# another order, and 32 bf16 layers of random weights spread any such
# reordering (phase 6: f32 attention against bf16 attention, 0.9974)
TP_LOGIT_COSINE = 0.999
TP_STEP_COSINE = 0.995
DP_ENCODE_COSINE = 0.9999


def _mesh_on_card(shape, names, device=None):
    """A mesh over the one card (or `device`), each position the same
    device."""
    from pathway_tpu_torch.parallel.mesh import get_mesh

    return get_mesh(shape, names, devices=[device or "cuda:0"] * int(np.prod(shape)))


def run_mesh_framework(card: str, base: dict, n_docs: int = N_DOCS, device=None) -> dict:
    """16a: phase 9a's workload under pw.run(mesh="dp=2,tp=2") inside
    with_mesh of a (dp = 2, tp = 2) mesh laid on the one card: a warm-up
    run and a measured one. The backend is active during the run and gone
    after it, the pipeline has 2 replicas whose rows sum to the docs, the
    probe doc is found at rank 1, and each of the 32 queries' top-6
    equals 9a's unsharded answer (`base`) but for near-ties, with every
    score within MESH_SCORE_TOL of 9a's."""
    from pathway_tpu_torch.analysis.mesh import MeshSpec
    from pathway_tpu_torch.internals import health, mesh_backend
    from pathway_tpu_torch.internals import runner as pw_runner
    from pathway_tpu_torch.parallel.mesh import with_mesh
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import _FusedKnnIndexImpl

    docs = make_docs(n_docs, random.Random(7))
    mesh = _mesh_on_card((2, 2), ("dp", "tp"), device)
    run_kwargs = {"mesh": "dp=2,tp=2"}
    with tempfile.TemporaryDirectory() as tmp, with_mesh(mesh):
        docs_path = _write_docs(docs, tmp)
        warm = _drive_retrieval(docs, docs_path, device, run_kwargs)
        del warm
        pw_runner._last_engine = None
        gc.collect()
        actions = dict(health.controller().status()["actions"])
        facts = _drive_retrieval(docs, docs_path, device, run_kwargs)
        after = health.controller().status()["actions"]
    backend = facts["backend"]
    check(backend is not None and (backend.dp, backend.tp) == (2, 2) and backend.mesh is mesh,
          f"the mesh backend during the run: {backend}")
    check(mesh_backend.active_backend() is None, "the mesh backend outlived its run")
    impl = _index_node(facts["engine"]).index
    check(isinstance(impl, _FusedKnnIndexImpl) and impl.knn.mesh is mesh,
          "the run's index did not adopt the mesh")
    check(len(impl.knn) == n_docs and len(impl.knn._blocks) == 2, f"{len(impl.knn)} rows")
    pipe = impl._pipeline
    per_replica = [r["rows"] for r in pipe.replica_stats()]
    check(pipe.replicas == 2 and sum(per_replica) == n_docs,
          f"pipeline replicas {pipe.replicas}, rows {per_replica}")
    got = [[(d["text"], d["score"]) for d in ans] for ans in facts["answers"]]
    check(facts["queries"] == base["queries"], "16a asked other queries than 9a")
    exact, drift, tie_tol = rankings_agree(got, base["answers"], K, "9a's unsharded answer")
    check(drift <= MESH_SCORE_TOL, f"scores drift {drift} from 9a's")
    # the same backend's query path alone, outside the engine
    with with_mesh(mesh):
        mesh_backend.activate(MeshSpec.parse("dp=2,tp=2"))
        try:
            direct_ms = _direct_query_ms(impl, facts["queries"])
        finally:
            mesh_backend.deactivate()
    win = facts["window"]
    log(f"  pw.run(mesh='dp=2,tp=2') over ['cuda:0'] * 4, 9a's workload ({n_docs} docs, k = {K}): "
        f"docs/s {facts['docs_per_s']:.1f} (9a {base['docs_per_s']:.1f}); p50 "
        f"{facts['p50_ms']:.2f} ms, p90 {facts['p90_ms']:.2f} ms (9a {base['p50_ms']:.2f} / "
        f"{base['p90_ms']:.2f}), {facts['qps_64']:.1f} qps at 64 concurrent [{card}]")
    log(f"  backend dp 2 x tp 2 active for the run and gone after it; pipeline replicas 2, rows "
        f"{per_replica}; probe doc at rank 1; against 9a's unsharded answers: top-{K} equal in "
        f"order in {exact}/{N_QUERIES}, the rest within near-ties of {tie_tol:.3g}, largest "
        f"score drift {drift:.3g} (tol {MESH_SCORE_TOL})  ok")
    log(f"  the ingest's utilization window at the probe's answer: {win['bound_state']}; health "
        f"controller in the run: {after['throttle'] - actions['throttle']} throttle, "
        f"{after['relax'] - actions['relax']} relax actions; after the sequential queries the "
        f"ingest throttle {facts['throttle']['throttle_delay_s']} s a tick, backpressure scale "
        f"{facts['throttle']['backpressure_scale']}; the index's search_texts alone, one query "
        f"a call: p50 "
        f"{direct_ms:.2f} ms (9a's {base['direct_p50_ms']:.2f}) [{card}]")
    summary = {"docs_per_s": facts["docs_per_s"], "p50_ms": facts["p50_ms"],
               "p90_ms": facts["p90_ms"], "exact": exact, "drift": drift, "direct_p50_ms": direct_ms}
    del facts, impl, pipe
    pw_runner._last_engine = None
    gc.collect()
    return summary


def run_sharded_index(card: str, knn_topk, reference_knn_topk, n_rows: int = N_INDEX) -> dict:
    """16b: DeviceKnnIndex over a ("knn",) mesh of 2 positions on the one
    card, filled with phase 4's 2^20 live rows of width 384 (two shards
    of 2^19), beside the unsharded index of the same rows: 32 queries
    (index rows with noise), k = 6, through search_keys. The same slot of
    every key, each query's own row at rank 1, the sets equal the
    unsharded index's under knn_sets_agree, knn_topk launched once a
    shard."""
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    mesh = _mesh_on_card((2,), ("knn",))
    plain = DeviceKnnIndex(DIM, metric="cos", reserved_space=n_rows)
    sharded = DeviceKnnIndex(DIM, metric="cos", reserved_space=n_rows, mesh=mesh)
    gen = torch.Generator(device="cuda").manual_seed(1)
    step = min(1 << 17, n_rows)
    for s in range(0, n_rows, step):
        vecs = torch.randn((step, DIM), device="cuda", generator=gen)
        plain.add_batch(range(s, s + step), vecs)
        sharded.add_batch(range(s, s + step), vecs)
    torch.cuda.synchronize()
    half = n_rows // 2
    check(len(sharded) == n_rows and sharded.capacity == n_rows
          and [tuple(b.shape) for b in sharded._blocks] == [(half, DIM)] * 2,
          "the sharded index is not two shards of 2^19 live rows")
    check(sharded._slot_of_key == plain._slot_of_key, "the sharded index placed keys elsewhere")
    picks = random.Random(7).sample(range(n_rows), N_QUERIES)
    at = torch.tensor([plain._slot_of_key[p] for p in picks], device="cuda")
    queries = plain._blocks[0][at] + 0.01 * torch.randn((N_QUERIES, DIM), device="cuda", generator=gen)
    knn_topk.launches = 0
    t0 = time.perf_counter()
    rows = sharded.search_keys(queries, K)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = knn_topk.launches
    check(launches == 2, f"the sharded search launched knn_topk {launches} times, not once a shard")
    t0 = time.perf_counter()
    plain_rows = plain.search_keys(queries, K)
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    hits = sum(1 for r, want in zip(rows, picks) if r and r[0][0] == want)
    check(hits == N_QUERIES, f"sharded search: {hits}/{N_QUERIES} own rows at rank 1")
    ss, si, _ = sharded.search(queries, K)
    ps, pi, _ = plain.search(queries, K)
    knn_sets_agree(*(torch.from_numpy(np.asarray(a)) for a in (ss, si, ps, pi)))
    err = float(np.abs(np.sort(ss, 1) - np.sort(ps, 1)).max())
    check(err <= 1e-4, f"sharded scores differ from the unsharded by {err}")
    check(plain_rows and all(r[0][0] == w for r, w in zip(plain_rows, picks)), "unsharded rank 1")
    padded = torch.nn.functional.normalize(queries, dim=1).contiguous()
    sharded_ms = median_ms(lambda: sharded._top_k(padded, K))
    plain_ms = median_ms(lambda: plain._top_k(padded, K))
    log(f"  DeviceKnnIndex over ('knn',) x 2 on the card, {n_rows} live rows of width {DIM} (two "
        f"shards of {half}), {N_QUERIES} queries, k = {K}: {hits}/{N_QUERIES} own rows at rank 1, "
        f"sets equal the unsharded index's (max |score err| {err:.3g}), knn_topk {launches} "
        f"launches a batch  ok")
    log(f"  search_keys wall {wall_ms:.2f} ms sharded, {plain_wall_ms:.2f} ms unsharded (first "
        f"calls); device {sharded_ms:.4f} ms sharded (2 kernels of 2^19 rows + the merge), "
        f"{plain_ms:.4f} ms unsharded (1 kernel of 2^20) [{card}]")
    shape = time_knn(knn_topk, reference_knn_topk, sharded._blocks[0], sharded._valid_blocks[0],
                     padded, K)
    shape.update({"N": half, "launches": launches, "path": "mesh (16b, a shard)"})
    del plain, sharded, queries, padded
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "shape": shape, "sharded_ms": sharded_ms, "plain_ms": plain_ms}


def _gathered(logits):
    """A tp run's vocab slices of the logits side by side, or a tree's
    logits as they are."""
    return torch.cat(logits, dim=-1) if isinstance(logits, list) else logits


def _teacher_forced(params, cfg, ti, tm, toks) -> list:
    """Each step's logits [B, V] (f32) of a KV-cached run that feeds the
    tokens `toks` [B, T]: the prefill's last live position, then T - 1
    decode steps. params: a tree or a list of tp trees."""
    from pathway_tpu_torch.models.decoder import decoder_forward, init_kv_cache

    b, l = ti.shape
    tp = len(params) if isinstance(params, list) else 1
    trees = params if isinstance(params, list) else [params]
    caches = [init_kv_cache(cfg, b, tree["ln_f"].device, tp=tp) for tree in trees]
    cache = caches if isinstance(params, list) else caches[0]
    kv_valid = torch.zeros((b, cfg.max_len), dtype=torch.int32, device=ti.device)
    kv_valid[:, :l] = tm
    lengths = tm.sum(1)
    rows = torch.arange(b, device=ti.device)
    ones = torch.ones((b, 1), dtype=torch.long, device=ti.device)
    out = []
    with torch.no_grad():
        logits, _ = decoder_forward(params, cfg, ti, tm, positions=tm.cumsum(1) - 1,
                                    kv_cache=cache, kv_valid=kv_valid)
        out.append(_gathered(logits)[rows, lengths - 1])
        for t in range(toks.shape[1] - 1):
            kv_valid[:, l + t] = 1
            logits, _ = decoder_forward(params, cfg, toks[:, t : t + 1], ones,
                                        positions=(lengths + t)[:, None], kv_cache=cache,
                                        kv_valid=kv_valid, slot_offset=l + t)
            out.append(_gathered(logits)[:, 0])
    return out


def run_tp_decode(card: str, flash_attention, base_step_ms: float) -> dict:
    """16c: the 7B decoder tensor-parallel over tp = 2 on ["cuda:0"] * 2,
    phase 6's 8 prompts and 32 new tokens, greedy. The prefill's
    last-position logits against the unsharded decoder's (row cosine >=
    TP_LOGIT_COSINE) and its first token (equal, or a near-tie that the
    logits' difference decides); the unsharded decoder_forward over the
    tokens the sharded run generated, each step's logits against the
    sharded run's (cosine >= TP_STEP_COSINE); flash_fwd_bf16<128> 64
    times a prefill (32 layers x 2 positions); ms a decode step beside
    phase 6's, and the peak memory."""
    from pathway_tpu_torch.models.decoder import decoder_tp_split, generate_tokens
    from pathway_tpu_torch.models.decoder_lm import ChatModel

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    chat = ChatModel("mistral-7b", max_len=2048, seed=0)
    cfg, params = chat.config, chat.params
    shards = decoder_tp_split(params, cfg, _mesh_on_card((2,), ("tp",)))
    check(tuple(shards[0]["layers"][0]["wk"].shape) == (cfg.hidden, cfg.kv_heads // 2 * cfg.head_dim),
          "the tp shard does not hold half of the kv heads")
    prompts = make_prompts(8, random.Random(11), 700, 1000)
    steps = 32
    ids, mask = chat.encode_prompts(prompts, steps)
    dev = params["embed"].device
    ti, tm = torch.from_numpy(ids).long().to(dev), torch.from_numpy(mask).long().to(dev)
    b, l = ti.shape
    flash_attention.launches = 0
    toks = generate_tokens(shards, cfg, ids, mask, max_new_tokens=steps)
    launches = flash_attention.launches
    check(launches == 2 * cfg.layers,
          f"the tp prefill launched flash {launches} times, not {2 * cfg.layers}")
    forced = torch.from_numpy(toks.astype(np.int64)).to(dev)
    sharded = _teacher_forced(shards, cfg, ti, tm, forced)
    unsharded = _teacher_forced(params, cfg, ti, tm, forced)
    prefill_cos = logit_cosine(sharded[0], unsharded[0])
    check(prefill_cos >= TP_LOGIT_COSINE, f"tp prefill logits: min row cosine {prefill_cos}")
    # the first token: the unsharded argmax, or a near-tie within the
    # largest difference between the two runs' logits
    diff = (sharded[0] - unsharded[0]).abs().max().item()
    first = unsharded[0].argmax(-1)
    picked = unsharded[0].gather(1, forced[:, :1])[:, 0]
    exact = int((forced[:, 0] == first).sum())
    check(bool(((forced[:, 0] == first) | (unsharded[0].max(-1).values - picked <= 2 * diff)).all()),
          f"tp first tokens {forced[:, 0].tolist()} against unsharded {first.tolist()}")
    step_cosines = [logit_cosine(a, c) for a, c in zip(sharded, unsharded)]
    step_cos = min(step_cosines)
    check(step_cos >= TP_STEP_COSINE, f"tp decode steps: min logit cosine {step_cos}")
    del sharded, unsharded
    t_prefill, t_all = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        generate_tokens(shards, cfg, ids, mask, max_new_tokens=1)
        t_prefill.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        generate_tokens(shards, cfg, ids, mask, max_new_tokens=steps)
        t_all.append(time.perf_counter() - t0)
    t_pre, t_gen = float(np.median(t_prefill)), float(np.median(t_all))
    step_ms = (t_gen - t_pre) / (steps - 1) * 1e3
    peak = torch.cuda.max_memory_allocated()
    log(f"  7B decoder over tp = 2 on ['cuda:0'] * 2: 8 prompts of {int(mask.sum(1).min())}-{l} "
        f"tokens, {steps} new tokens; prefill last-position logits against the unsharded: min "
        f"row cosine {prefill_cos:.6f}; first tokens equal in {exact}/{b} (max |logit diff| "
        f"{diff:.3g}); the unsharded decoder over the tp run's tokens, each step's logits: min "
        f"cosine {step_cos:.6f}, median {float(np.median(step_cosines)):.6f} (tol "
        f"{TP_STEP_COSINE}); flash_fwd_bf16<128> {launches} a prefill  ok")
    log(f"  tp prefill {t_pre * 1e3:.1f} ms, decode {step_ms:.2f} ms a step at batch {b} (phase 6 "
        f"unsharded {base_step_ms:.2f}); peak device memory {peak / 2**30:.2f} GiB (the shards "
        f"are views of the 7B's weights) [{card}]")
    del chat, params, shards, forced
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "l": l, "step_ms": step_ms, "prefill_ms": t_pre * 1e3,
            "peak_bytes": peak}


def run_dp_encoder(card: str, flash_attention) -> dict:
    """16d: SentenceEncoder(mesh=dp 2 on ["cuda:0"] * 2) over phase 5's
    256 docs at L = 512, in batches of 64 (32 rows a dp position), against
    the unsharded encode of the same weights: row cosine >=
    DP_ENCODE_COSINE, flash_fwd_bf16<32> 6 layers x 2 positions an
    encode."""
    from pathway_tpu_torch.models.minilm import SentenceEncoder

    mesh = _mesh_on_card((2,), ("dp",))
    sharded = SentenceEncoder("all-MiniLM-L6-v2", max_len=512, seed=0, mesh=mesh)
    plain = SentenceEncoder("all-MiniLM-L6-v2", max_len=512, seed=0)
    docs = make_docs(256, random.Random(3), words=520)
    batches = [docs[s : s + 64] for s in range(0, len(docs), 64)]
    sharded.encode(batches[0])  # warm-up
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    got = [sharded.encode(batch) for batch in batches]
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    check(launches == len(batches) * 6 * 2,
          f"the dp encodes launched flash {launches} times, not {len(batches) * 12}")
    t0 = time.perf_counter()
    want = [plain.encode(batch) for batch in batches]
    plain_wall = time.perf_counter() - t0
    cos = min(float(cosine_rows(g, w).min()) for g, w in zip(got, want))
    check(all(np.isfinite(g).all() and g.shape == (64, DIM) for g in got), "dp encode: bad output")
    check(cos >= DP_ENCODE_COSINE, f"dp encode vs unsharded: min row cosine {cos}")
    log(f"  SentenceEncoder(mesh=dp 2 on ['cuda:0'] * 2), {len(docs)} docs at L = 512: "
        f"{len(docs) / wall:.1f} docs/s (unsharded {len(docs) / plain_wall:.1f}); min row cosine "
        f"to the unsharded encode {cos:.7f}; flash_fwd_bf16<32> {launches} launches "
        f"({launches // len(batches)} an encode)  ok [{card}]")
    del sharded, plain
    gc.collect()
    return {"launches": launches}


def run_multichip_checks(card: str, knn_topk) -> dict:
    """16e: the JAX package's four multichip checks, ported, over four
    positions of the one card; the retrieval parity is exact (`==`)."""
    from pathway_tpu_torch.parallel import multichip_checks

    knn_topk.launches = 0
    t0 = time.perf_counter()
    facts = multichip_checks.run_all(4, devices=["cuda:0"] * 4)
    launches = knn_topk.launches
    check(launches > 0, "the sharded retrieval check launched no knn_topk")
    log(f"  multichip_checks.run_all(4, devices=['cuda:0'] * 4): {json.dumps(facts)}; the sharded "
        f"retrieval equals the dense one (==); knn_topk {launches} launches; "
        f"{time.perf_counter() - t0:.1f} s  ok [{card}]")
    return {"launches": launches}


# -- phase 8: the framework path on the card's host ------------------------------


def _wordcount_input(directory: str, n_rows: int, n_files: int = 8, vocab: int = 10_000) -> Counter:
    """benchmarks/wordcount_bench.py's input: {"word": ...} json lines from
    random.Random(7) over `vocab` words, in `n_files` files."""
    rng = random.Random(7)
    words = [f"word{i}" for i in range(vocab)]
    per_file = -(-n_rows // n_files)
    counts: Counter = Counter()
    for f in range(n_files):
        chosen = [rng.choice(words) for _ in range(min(per_file, n_rows - f * per_file))]
        counts.update(chosen)
        with open(os.path.join(directory, f"in_{f}.jsonl"), "w") as fh:
            fh.write("\n".join(json.dumps({"word": w}) for w in chosen))
    return counts


# a stream with retractions, its per-group sums, and the sums' expected
# (group, sum, time, is_addition) deltas
_STREAM = """
    id | g | v | __time__ | __diff__
    1  | a | 1 | 2        | 1
    2  | b | 2 | 2        | 1
    3  | a | 3 | 4        | 1
    1  | a | 1 | 6        | -1
    4  | b | 5 | 6        | 1
    2  | b | 2 | 8        | -1
"""
_STREAM_SUMS = [
    ("a", 1, 2, True), ("b", 2, 2, True),
    ("a", 1, 4, False), ("a", 4, 4, True),
    ("a", 4, 6, False), ("a", 3, 6, True), ("b", 2, 6, False), ("b", 7, 6, True),
    ("b", 7, 8, False), ("b", 5, 8, True),
]


def run_framework(card: str) -> dict:
    import pathway_tpu_torch as pw
    from pathway_tpu_torch import native

    # the engine's keys and rows go through the native wire codec (g++ at
    # its first use); without it the engine takes the Python codec, so the
    # rate below is printed only for the native one
    t0 = time.perf_counter()
    codec = native.load_wire_ext()
    check(codec is not None, "the engine's native wire codec did not build or load")
    log(f"  native wire codec {codec.__name__} built and loaded in {time.perf_counter() - t0:.2f} s")

    n_rows = 1_000_000
    with tempfile.TemporaryDirectory() as tmp:
        in_dir = os.path.join(tmp, "input")
        os.makedirs(in_dir)
        expected = _wordcount_input(in_dir, n_rows)
        out_path = os.path.join(tmp, "out.csv")

        class InputSchema(pw.Schema):
            word: str

        def wordcount(src: str, dst: str) -> float:
            pw.G.clear()
            t0 = time.perf_counter()
            words = pw.io.fs.read(path=src, schema=InputSchema, format="json", mode="static")
            result = words.groupby(words.word).reduce(words.word, count=pw.reducers.count())
            pw.io.csv.write(result, dst)
            pw.run(monitoring_level=pw.MonitoringLevel.NONE)
            pw.G.clear()
            return time.perf_counter() - t0

        def counted(path: str) -> Counter:
            got: Counter = Counter()
            with open(path) as fh:
                header = fh.readline().strip().split(",")
                check(header == ["word", "count", "time", "diff"], f"wordcount csv header {header}")
                for line in fh:
                    word, count, _time, diff = line.strip().split(",")
                    check(diff == "1", f"static wordcount retracted a row: {line!r}")
                    got[word] += int(count)
            return got

        # the same pipeline twice in this process: the first run pays what a
        # process pays once (lazy imports, the first large heap), the second not
        first = wordcount(in_dir, out_path)
        check(counted(out_path) == expected, "first wordcount csv differs from collections.Counter")
        elapsed = wordcount(in_dir, out_path)
        got = counted(out_path)
    check(got == expected, "wordcount csv differs from collections.Counter of the input")
    log(f"  wordcount (fs json read -> groupby(word).reduce(count) -> csv write), {n_rows} rows in "
        f"8 files, {len(got)} words, native codec: first run in the process {n_rows / first:.1f} "
        f"rows/s ({first:.2f} s), second {n_rows / elapsed:.1f} rows/s ({elapsed:.2f} s), each "
        f"equal to collections.Counter  ok [{card}]")

    pw.G.clear()
    t = pw.debug.table_from_markdown(_STREAM)
    sums = t.groupby(pw.this.g).reduce(pw.this.g, s=pw.reducers.sum(pw.this.v))
    events = []
    pw.io.subscribe(
        sums,
        on_change=lambda key, row, time, is_addition: events.append(
            (row["g"], row["s"], time, is_addition)
        ),
    )
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    pw.G.clear()
    check(sorted(events, key=repr) == sorted(_STREAM_SUMS, key=repr),
          f"streaming sums: {events}")
    check([e[2] for e in events] == sorted(e[2] for e in events), "deltas out of time order")
    log(f"  streaming table (__time__ / __diff__, 2 retractions) -> groupby sum -> subscribe: "
        f"{len(events)} deltas, the expected additions and retractions  ok")
    return {"wordcount_rows_per_s": n_rows / elapsed, "wordcount_first_rows_per_s": n_rows / first}


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
    check_padded_shapes(knn_topk, flash_attention, reference_attention)
    d256_shape = check_flash_d256(flash_attention, reference_attention)
    f32_shapes = time_flash_f32(flash_attention, reference_attention)

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
    flash_attention.launches_by_instance = {}
    long_docs = run_long_docs(flash_attention)
    flash_row["launches"] = flash_attention.launches
    f32_shapes[0]["launches"] = long_docs["f32_launches"]
    check(flash_attention.launches > 0, "long-document path launched no flash kernel")
    log(f"  flash_attention launches on the long-document path: {flash_attention.launches} "
        f"(bf16<32> and, in the f32 encode, f32<32> {long_docs['f32_launches']})")

    log("[6] the decoder at full Mistral-7B width")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    decoder = run_decoder(card, flash_attention)
    decoder_shape["launches"] = decoder["launches"]
    flash_row["shapes"] = [decoder_shape, d256_shape, *f32_shapes]
    log(f"  flash_attention launches on the decoder path (generate): {decoder['launches']}")
    log(f"  decoder phase {time.perf_counter() - t_phase:.1f} s")

    log("[7] pipelined ingest on the card")
    gc.collect()
    torch.cuda.empty_cache()
    knn_topk.launches = 0
    flash_attention.launches = 0
    ingest = run_pipelined_ingest(card, docs)["ingest_launches"]
    search_knn = knn_topk.launches - ingest["knn_topk"]
    check(search_knn > 0, "the searches of the pipelined index launched no knn_topk kernel")
    knn_row["launches_by_path"] = {"main": knn_row["launches"],
                                   "pipelined_ingest": ingest["knn_topk"],
                                   "pipelined_index_search": search_knn}
    flash_row["launches_by_path"] = {"long_docs": flash_row["launches"],
                                     "decoder": decoder["launches"],
                                     "pipelined_ingest": ingest["flash_attention"]}
    log(f"  launches on the two ingest runs: knn_topk {ingest['knn_topk']} (ingest adds rows, it "
        f"does not search), flash_attention {ingest['flash_attention']} (L = 64, under the flash "
        f"gate); on the searches of the two indexes: knn_topk {search_knn}")

    # phase 9 runs before phase 8: `pw.run` keeps its last engine alive
    # (`last_engine()`), and the wordcount's 1,000,000-row engine is not to
    # weigh on the retrieval path
    log("[9a] the retrieval framework path (bench.py's), before phase 8")
    gc.collect()
    torch.cuda.empty_cache()
    knn_topk.launches = 0
    flash_attention.launches = 0
    base_9a = run_framework_retrieval(card)
    retrieval_launches = {"knn_topk": knn_topk.launches, "flash_attention": flash_attention.launches}
    log(f"  launches on the framework retrieval path: knn_topk {knn_topk.launches} (the fused "
        f"search is dense similarity + top-k, as the JAX package's), flash_attention "
        f"{flash_attention.launches} (L = 64, under the flash gate)")

    log("[9b] DocumentStore over a UDF embedder: the vector index impl")
    gc.collect()
    torch.cuda.empty_cache()
    knn_topk.launches = 0
    flash_attention.launches = 0
    run_udf_docstore(card)
    check(knn_topk.launches >= 1, "the UDF-embedder DocumentStore launched no knn_topk kernel")
    knn_row["launches_by_path"]["framework_retrieval"] = retrieval_launches["knn_topk"]
    knn_row["launches_by_path"]["udf_docstore"] = knn_topk.launches
    flash_row["launches_by_path"]["framework_retrieval"] = retrieval_launches["flash_attention"]
    flash_row["launches_by_path"]["udf_docstore"] = flash_attention.launches
    log(f"  launches on the UDF-embedder DocumentStore: knn_topk {knn_topk.launches}, "
        f"flash_attention {flash_attention.launches}")

    log("[10] the Private-RAG server (QASummaryRestServer), before phase 8")
    gc.collect()
    torch.cuda.empty_cache()
    knn_topk.launches = 0
    flash_attention.launches = 0
    rag = run_rag_server(card)["launches"]
    knn_row["launches_by_path"]["rag_server"] = rag["knn_topk"]
    flash_row["launches_by_path"]["rag_server"] = rag["flash_attention"]
    log(f"  launches on the RAG server path: flash_attention {rag['flash_attention']} (the 7B "
        f"prefills, L > 256, D = 128), knn_topk {rag['knn_topk']} (the fused search is dense "
        f"similarity + top-k, as the JAX package's)")

    log("[12] the stdlib path: pw.temporal over Nexmark, pw.ml on the card, before phase 8")
    gc.collect()
    torch.cuda.empty_cache()
    knn_topk.launches = 0
    flash_attention.launches = 0
    t_phase = time.perf_counter()
    run_nexmark(card)
    temporal_launches = {"knn_topk": knn_topk.launches, "flash_attention": flash_attention.launches}
    check(knn_topk.launches == 0 and flash_attention.launches == 0,
          "the temporal stdlib launched a kernel")
    log(f"  phase 12a {time.perf_counter() - t_phase:.1f} s; kernel launches: 0 (host only)")
    gc.collect()
    knn_topk.launches = 0
    flash_attention.launches = 0
    run_stdlib_ml(card)
    check(knn_topk.launches > 0, "pw.ml's KNNIndex launched no knn_topk kernel")
    knn_row["launches_by_path"]["stdlib_temporal"] = temporal_launches["knn_topk"]
    knn_row["launches_by_path"]["stdlib_ml"] = knn_topk.launches
    flash_row["launches_by_path"]["stdlib_temporal"] = temporal_launches["flash_attention"]
    flash_row["launches_by_path"]["stdlib_ml"] = flash_attention.launches
    log(f"  launches on the pw.ml path: knn_topk {knn_topk.launches} (KNNIndex l2sq and cos, "
        f"the classifier's index), flash_attention {flash_attention.launches}; phase 12 "
        f"{time.perf_counter() - t_phase:.1f} s")

    # phase 14 runs after 12 and before 13 and 8
    log("[14a] the demo-question-answering app declared in YAML, served on the card, before phase 8")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    declarative = run_declarative_app(card)["launches"]
    knn_row["launches_by_path"]["declarative"] = declarative["knn_topk"]
    flash_row["launches_by_path"]["declarative"] = declarative["flash_attention"]
    flash_row["declarative_by_instance"] = declarative["by_instance"]
    log(f"  launches on the declarative app's path: flash_attention {declarative['flash_attention']} "
        f"({json.dumps(declarative['by_instance'], sort_keys=True)}: the encoder over chunks of "
        f"300-450 tokens at D = 32, the 7B prefills at D = 128), knn_topk {declarative['knn_topk']} "
        f"(the fused search is dense similarity + top-k)")
    for name, fn in (("[14b] pw.sql over the sqlite connector", run_sql_on_sqlite),
                     ("[14c] pw.demo.replay_csv through a groupby", run_demo_replay)):
        log(name)
        knn_topk.launches = 0
        flash_attention.launches = 0
        fn(card)
        check(knn_topk.launches == 0 and flash_attention.launches == 0, f"{name} launched a kernel")
    log(f"  phase 14 {time.perf_counter() - t_phase:.1f} s; 14b and 14c launched no kernel (host only)")

    # phase 15 runs after 14 and before 13, so 13a's check that earlier
    # phases let go of what they held covers it too
    log("[15] training and the model-parallel core, before phase 13")
    _collect_earlier_phases()
    t_phase = time.perf_counter()
    log("[15a] make_train_step at MiniLM-L6 width")
    knn_topk.launches = 0
    train = run_train_step(card, flash_attention, reference_attention)
    log("[15b] make_sharded_train_step over a (dp = 2, tp = 2) mesh")
    sharded = run_sharded_train_step(card, flash_attention, train["ms"])
    log("[15c] ring and Ulysses sequence parallelism at Mistral-7B geometry, sp = 4")
    gc.collect()
    torch.cuda.empty_cache()
    seq = run_sequence_parallel(card, flash_attention)
    check(knn_topk.launches == 0, "phase 15 launched knn_topk")
    log("[15d] flash at phase 15's shapes")
    train_shapes = time_flash_training_shapes(flash_attention, reference_attention)
    for row, launches in zip(train_shapes, (train["launches"], sharded["launches"],
                                            seq["launches"]["ulysses"]["bf16<128>"],
                                            seq["launches"]["unsharded"]["bf16<128>"])):
        row["launches"] = launches
    flash_row["shapes"] += train_shapes
    for path, n in (("training", train["launches"]), ("sharded_training", sharded["launches"]),
                    ("sequence_parallel_ulysses", seq["launches"]["ulysses"]["bf16<128>"]),
                    ("sequence_parallel_ring", 0)):
        flash_row["launches_by_path"][path] = n
        knn_row["launches_by_path"][path] = 0
    log(f"  phase 15 {time.perf_counter() - t_phase:.1f} s")

    # phase 16 runs after 15 and before 13, so 13a's check that earlier
    # phases let go of what they held covers it too
    log("[16] the data-plane mesh on the card, before phase 13")
    _collect_earlier_phases()
    t_phase = time.perf_counter()
    log("[16a] 9a's workload under pw.run(mesh='dp=2,tp=2')")
    knn_topk.launches = 0
    flash_attention.launches = 0
    run_mesh_framework(card, base_9a)
    mesh_knn = {"16a": knn_topk.launches}
    mesh_flash = {"16a": flash_attention.launches}
    check(knn_topk.launches > 0, "the mesh framework path launched no knn_topk")
    log(f"  launches on 16a: knn_topk {knn_topk.launches} (one a shard a query batch), "
        f"flash_attention {flash_attention.launches} (L = 64, under the flash gate)")
    _collect_earlier_phases()
    log("[16b] the sharded index at 2^20 rows, two shards")
    flash_attention.launches = 0
    index16 = run_sharded_index(card, knn_topk, reference_knn_topk)
    mesh_knn["16b"], mesh_flash["16b"] = index16["launches"], flash_attention.launches
    log("[16c] tensor-parallel decode at full Mistral-7B width, tp = 2")
    knn_topk.launches = 0
    tp16 = run_tp_decode(card, flash_attention, 8 / decoder["decode_tokens_per_s"] * 1e3)
    mesh_knn["16c"], mesh_flash["16c"] = knn_topk.launches, tp16["launches"]
    log("[16d] SentenceEncoder(mesh=dp 2) at L = 512")
    knn_topk.launches = 0
    dp16 = run_dp_encoder(card, flash_attention)
    mesh_knn["16d"], mesh_flash["16d"] = knn_topk.launches, dp16["launches"]
    log("[16e] the multichip checks over four positions of the card")
    flash_attention.launches = 0
    checks16 = run_multichip_checks(card, knn_topk)
    mesh_knn["16e"], mesh_flash["16e"] = checks16["launches"], flash_attention.launches
    _collect_earlier_phases()
    knn_row["shapes"].append(index16["shape"])
    mesh_shapes = time_flash_shapes(
        flash_attention, reference_attention,
        [(8, 16, tp16["l"], 128, True, 0), (32, 12, 512, 32, False, 0)], seed=161, rel=2.0 ** -6)
    for row, n, path in zip(mesh_shapes, (tp16["launches"], dp16["launches"]),
                            ("mesh (16c, a tp position's prefill)", "mesh (16d, a dp position)")):
        row.update({"launches": n, "path": path})
    flash_row["shapes"] += mesh_shapes
    knn_row["launches_by_path"]["mesh"] = sum(mesh_knn.values())
    flash_row["launches_by_path"]["mesh"] = sum(mesh_flash.values())
    knn_row["mesh_by_phase"], flash_row["mesh_by_phase"] = mesh_knn, mesh_flash
    log(f"  launches on the mesh paths: knn_topk {json.dumps(mesh_knn)}, flash_attention "
        f"{json.dumps(mesh_flash)}; phase 16 {time.perf_counter() - t_phase:.1f} s")

    # phase 13 runs after 14 and 15 and before 8, as 9 does: the wordcount's
    # engine is not to weigh on it
    log("[13] operability on the card: the capacity plan, the profiler, the cli, before phase 8")
    knn_topk.launches = 0
    flash_attention.launches = 0
    t_phase = time.perf_counter()
    run_capacity_parity(card)
    run_profile_while_serving(card)
    run_cli_on_card(card)
    check(knn_topk.launches > 0, "the DocumentStore served under /profile launched no knn_topk")
    knn_row["launches_by_path"]["operability"] = knn_topk.launches
    flash_row["launches_by_path"]["operability"] = flash_attention.launches
    log(f"  launches on the operability path: knn_topk {knn_topk.launches} (13b's searches), "
        f"flash_attention {flash_attention.launches} (L = 64, under the flash gate)")
    log("[13d] flash gradients on the card against the CPU path")
    flash_row["gradients"] = check_flash_gradients(flash_attention, reference_attention)
    log(f"  phase 13 {time.perf_counter() - t_phase:.1f} s")

    log("[8] the framework path on the card's host")
    gc.collect()
    torch.cuda.empty_cache()
    knn_topk.launches = 0
    flash_attention.launches = 0
    run_framework(card)
    check(knn_topk.launches == 0 and flash_attention.launches == 0,
          "the host framework path launched a kernel")
    log("  kernel launches on the framework path: 0 (host only)")
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    log("[11] summary")
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
