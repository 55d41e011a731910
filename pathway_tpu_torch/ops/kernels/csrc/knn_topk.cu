// Streaming KNN similarity + top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pathway_tpu/ops/kernels/knn_topk.py
// (`_block_kernel`, launched by `_make_knn`): scores of Q queries against
// an [N, D] f32 index, dead slots pushed down by an additive -1e30, and the
// global top-k per query, without ever writing the [Q, N] score matrix.
//
// What bounds it on this card: the index is read once. At N = 2^20,
// D = 384 that is 1.6 GB, ~0.48 ms at 3.35 TB/s. The scores are 2 Q N D
// operations: at Q = 64 that is 52 GFLOP, 0.77 ms on the f32 CUDA cores
// (67 TFLOP/s), so they run on the tensor cores, in three tf32 passes
// (155 GFLOP at 495 TFLOP/s, 0.31 ms), which keeps every Q <= 64 bound by
// the bytes. The TPU design walks N in order through one large VMEM
// block; here Q is tiny and N is large, so N is split over the SMs:
//
//   knn_split_queries: each query q = q_hi + q_lo, q_hi = q rounded to
//     tf32 (cvt.rna), q_lo = q - q_hi rounded again, written once per call
//     as [groups, 2, QT, D] with zero rows for the queries past Q.
//   knn_block_topk (pass 1): each block owns a contiguous run of 128-row
//     tiles and a group of QT <= 64 queries; one 288-thread block per SM.
//     Warp-specialised:
//     - one producer warp streams the index by TMA (2-D tensor map, boxes
//       of 128 rows x 32 f32, 128-byte swizzle, zeros past N and D) through
//       a ring of as many stages as fit beside the lists (8 at QT <= 32
//       with k <= 32, 4 at QT = 64 with k = 128), each with the queries'
//       hi and lo boxes of the same 32 columns (from L2) and the tile's
//       `valid` bytes. "Full" and "empty" mbarriers per stage, as in
//       flash_attention.cu.
//     - two consumer warpgroups of 64 rows each compute the tile's scores
//       on the tensor cores to f32 accuracy ("3xTF32"): each thread loads
//       its A fragment of the index rows from shared memory and splits x
//       into x_hi + x_lo in registers; per k-step of 8 columns, wgmma
//       m64n(2 QT)k8 tf32 gives x_hi [q_hi | q_lo] and m64nQTk8 gives
//       x_lo q_hi: two independent accumulator chains, which the tensor
//       cores overlap, where one chain of dependent small-N products
//       waits on each product's latency. B is the queries' boxes as
//       stored (K-major). The dropped x_lo q_lo term is ~2^-22 of each
//       product. l2sq's ||x||^2 is an f32 FFMA sum over the same fragments.
//     - selection is batched (Johnson, Douze, Jegou, arXiv:1702.08734,
//       here in shared memory): at a tile's end each score is compared in
//       registers with its query's threshold (the kp-th entry of the
//       query's sorted list, loaded once per round); survivors go in
//       parallel (shared atomicAdd on the query's count) into a candidate
//       buffer of CAP slots. A warp folds a buffer that holds
//       max(min(kp, CAP), CAP / 2) or more (bitonic sort in registers,
//       then a bitonic merge into the list), which raises the threshold.
//       Scores that find a full buffer wait for the next round. A block's
//       first tile goes straight through the sort.
//     Each block writes its [QT, kp] lists: [groups, blocks, QT, kp].
//   knn_merge (pass 2): one block per query folds the per-block lists into
//     the global top-k, its 16 warps folding disjoint lists in parallel
//     before the block folds theirs.
//
// Order is (score descending, slot ascending), so ties resolve to the
// lower slot and the result is deterministic.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int TR = 128;            // index rows per tile, 64 per consumer warpgroup
constexpr int DK = 32;             // f32 columns per stage: one 128-byte swizzled row
constexpr int MAX_STAGES = 8;      // stages in the ring, as many as fit
constexpr int SMEM_MAX = 232448;   // shared memory a block can opt in to
constexpr int CAP = 64;            // candidate slots per query
constexpr int CONSUMERS = 256;     // two warpgroups
constexpr int THREADS = CONSUMERS + 32;
constexpr int MERGE_WARPS = 16;    // pass-2 warps per query
constexpr int MERGE_THREADS = 32 * MERGE_WARPS;
constexpr float NEG_INF = -1e30f;  // additive dead-slot penalty (JAX NEG_INF)
constexpr int X_BYTES = TR * DK * 4;

__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
    return as > bs || (as == bs && ai < bi);
}

// Merge the sorted (descending) list b[0..blen), blen <= kp (entries past
// blen read as absent), into the sorted list t[0..kp), keeping the best kp
// of the union: t[i] = max(t[i], b[kp-1-i]) is bitonic and holds the best
// kp; a bitonic merge sorts it again. Run by the 32 lanes of one warp;
// ends synchronised.
__device__ void merge_topk(float* ts, int* ti, const float* bs, const int* bi, int kp, int blen,
                           int lane) {
    for (int i = lane; i < kp; i += 32) {
        const int j = kp - 1 - i;
        if (j < blen && better(bs[j], bi[j], ts[i], ti[i])) {
            ts[i] = bs[j];
            ti[i] = bi[j];
        }
    }
    __syncwarp();
    const int half = kp >> 1;
    for (int stride = half; stride > 0; stride >>= 1) {
        for (int i = lane; i < half; i += 32) {
            const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
            const int hi = lo + stride;
            if (better(ts[hi], ti[hi], ts[lo], ti[lo])) {
                const float a = ts[lo];
                const int ai = ti[lo];
                ts[lo] = ts[hi]; ti[lo] = ti[hi];
                ts[hi] = a; ti[hi] = ai;
            }
        }
        __syncwarp();
    }
}

// one compare-exchange of a bitonic network across lanes `stride` apart:
// keeps the better of the pair if `keep_better`, else the worse
__device__ __forceinline__ void exchange_lanes(float& v, int& id, int stride, bool keep_better) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, stride);
    const int oi = __shfl_xor_sync(0xffffffffu, id, stride);
    if (better(ov, oi, v, id) == keep_better) {
        v = ov;
        id = oi;
    }
}

// Fold the m <= CAP candidates b[0..m) of one query into its sorted list
// t[0..kp): the warp sorts them best first (bitonic, element e * 32 + lane
// in register e of the lane), writes them back, and merges the best
// min(kp, CAP) into the list.
__device__ void fold_candidates(float* ts, int* ti, float* bs, int* bi, int m, int kp,
                                int lane) {
    constexpr int E = CAP / 32;
    float v[E];
    int id[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = e * 32 + lane;
        v[e] = i < m ? bs[i] : -INFINITY;
        id[e] = i < m ? bi[i] : INT_MAX;
    }
#pragma unroll
    for (int size = 2; size <= CAP; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            if (stride >= 32) {
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const int f = e ^ (stride / 32);
                    if (f > e) {
                        const bool fwd = ((e * 32 + lane) & size) == 0;
                        if (better(v[f], id[f], v[e], id[e]) == fwd) {
                            const float a = v[e];
                            const int ai = id[e];
                            v[e] = v[f]; id[e] = id[f];
                            v[f] = a; id[f] = ai;
                        }
                    }
                }
            } else {
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const bool fwd = ((e * 32 + lane) & size) == 0;
                    const bool lower = (lane & stride) == 0;
                    exchange_lanes(v[e], id[e], stride, fwd == lower);
                }
            }
        }
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < E; ++e) {
        bs[e * 32 + lane] = v[e];
        bi[e * 32 + lane] = id[e];
    }
    __syncwarp();
    merge_topk(ts, ti, bs, bi, kp, min(kp, CAP), lane);
}

// the two consumer warpgroups only (named barrier 1; the producer warp
// has left by then)
__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// consumer_sync that also returns whether `pred` held on any consumer thread
__device__ __forceinline__ bool consumer_sync_or(bool pred) {
    int any;
    asm volatile(
        "{\n.reg .pred p, q;\n"
        "setp.ne.b32 p, %1, 0;\n"
        "bar.red.or.pred q, 1, %2, p;\n"
        "selp.s32 %0, 1, 0, q;\n}\n"
        : "=r"(any)
        : "r"((int)pred), "n"(CONSUMERS)
        : "memory");
    return any != 0;
}

// x rounded to tf32 (ties away from zero), as the b32 the tensor cores read
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// d (+)= A B, m64nNk8 tf32 with N = 2 x the registers of d: A [64 x 8]
// from registers, B [8 x N] K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[4], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Shared memory of one pass-1 block, byte offsets from a 1024-byte aligned
// base (every TMA box starts on a whole swizzle atom): the ring's index
// boxes, query hi and lo boxes and valid bytes, then the kp-sized lists,
// the candidate buffers and counts, then the mbarriers (full, empty).
template <int QT>
struct Smem {
    static constexpr int Q_BYTES = QT * DK * 4;
    int nst, kp;  // ring stages, list length
    __host__ __device__ int q() const { return nst * X_BYTES; }  // per stage: hi rows, lo rows
    __host__ __device__ int valid() const { return q() + nst * 2 * Q_BYTES; }
    __host__ __device__ int lists() const { return valid() + nst * TR; }
    __host__ __device__ int bars() const { return lists() + 8 * QT * kp + 8 * QT * CAP + 4 * QT; }
    size_t alloc() const { return bars() + 16 * nst + 1024; }  // + alignment slack
};

// the deepest ring that fits beside the lists
template <int QT>
int ring_stages(int kp) {
    int nst = MAX_STAGES;
    while (nst > 2 && Smem<QT>{nst, kp}.alloc() > SMEM_MAX) --nst;
    return nst;
}

// qs: [groups, 2, QT, d], the queries' tf32 hi parts, then their lo parts;
// zeros for the rows past nq
__global__ void knn_split_queries(const float* __restrict__ queries, int nq, int d, int qt,
                                  int groups, float* __restrict__ qs) {
    const size_t total = (size_t)groups * qt * d;
    for (size_t p = blockIdx.x * (size_t)blockDim.x + threadIdx.x; p < total;
         p += (size_t)gridDim.x * blockDim.x) {
        const int row = (int)(p / d);  // query index, past nq in the last group
        const int c = (int)(p - (size_t)row * d);
        const float x = row < nq ? queries[p] : 0.f;
        const uint32_t hi = tf32_rna(x);
        const uint32_t lo = tf32_rna(x - __uint_as_float(hi));
        const int g = row / qt;
        const size_t base = ((size_t)(2 * g) * qt + (row - g * qt)) * d + c;
        qs[base] = __uint_as_float(hi);
        qs[base + (size_t)qt * d] = __uint_as_float(lo);
    }
}

// grid: (blocks, query groups of QT); block: two consumer warpgroups, then
// one producer warp. tm_x: the index [n, d]; tm_q: knn_split_queries's
// output as [groups * 2 * QT, d]; both with boxes of 32 columns; nst: ring
// stages. Lane (g = lane / 4, t = lane % 4) of warp w of consumer
// warpgroup wg holds tile rows 64 wg + 16 w + g and that + 8, queries
// 8 j + 2 t and 8 j + 2 t + 1 (accumulator registers 4 j .. 4 j + 3).
template <int QT, bool L2>
__global__ void __launch_bounds__(THREADS, 1)
knn_block_topk(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_q,
               const uint8_t* __restrict__ valid, int n, int d, int nq, int kp, int nst,
               int tiles_per_block, float* __restrict__ cand_s, int* __restrict__ cand_i) {
    constexpr int Q_BYTES = Smem<QT>::Q_BYTES;
    const Smem<QT> S{nst, kp};
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    const float* sx = reinterpret_cast<const float*>(smem);
    uint8_t* svalid = smem + S.valid();
    float* Ls = reinterpret_cast<float*>(smem + S.lists());  // [QT][kp] sorted lists
    int* Li = reinterpret_cast<int*>(Ls + QT * kp);
    float* Bs = reinterpret_cast<float*>(Li + QT * kp);     // [QT][CAP] candidates
    int* Bi = reinterpret_cast<int*>(Bs + QT * CAP);
    int* cnt = Bi + QT * CAP;                               // [QT] candidates held
    const uint32_t bar_full = smem_u32(smem + S.bars());
    const uint32_t bar_empty = bar_full + 8 * nst;

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int group = blockIdx.y;
    const int q0 = group * QT;
    const int nd = (d + DK - 1) / DK;
    const int ntiles = (n + TR - 1) / TR;
    const int t_begin = blockIdx.x * tiles_per_block;
    const int stages = max(0, min(ntiles, t_begin + tiles_per_block) - t_begin) * nd;

    if (tid == 0) {
        for (int s = 0; s < nst; ++s) {
            mbar_init(bar_full + 8 * s, 32);               // every producer lane
            mbar_init(bar_empty + 8 * s, CONSUMERS / 32);  // every consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    for (int p = tid; p < QT * kp; p += THREADS) {
        Ls[p] = -INFINITY;
        Li[p] = INT_MAX;
    }
    for (int p = tid; p < QT; p += THREADS) cnt[p] = 0;
    __syncthreads();

    if (warp == CONSUMERS / 32) {
        // producer: stage s is (tile t_begin + s / nd, columns (s % nd) DK ..)
        for (int s = 0, slot = 0, phase = 0; s < stages; ++s) {
            if (s >= nst) mbar_wait(bar_empty + 8 * slot, phase ^ 1);
            const int row0 = (t_begin + s / nd) * TR;
            const int c0 = (s % nd) * DK;
            if (c0 == 0) {
                for (int r = lane; r < TR; r += 32) {
                    svalid[slot * TR + r] = row0 + r < n ? valid[row0 + r] : 0;
                }
            }
            const uint32_t full = bar_full + 8 * slot;
            const uint32_t qbox = smem_u32(smem + S.q() + slot * 2 * Q_BYTES);
            if (lane == 0) {
                mbar_arrive_expect_tx(full, X_BYTES + 2 * Q_BYTES);
                tma_load_2d(smem_u32(smem + slot * X_BYTES), &tm_x, full, c0, row0);
                tma_load_2d(qbox, &tm_q, full, c0, 2 * group * QT);
                tma_load_2d(qbox + Q_BYTES, &tm_q, full, c0, (2 * group + 1) * QT);
            } else {
                mbar_arrive(full);
            }
            if (++slot == nst) {
                slot = 0;
                phase ^= 1;
            }
        }
        return;
    }

    const int g = lane >> 2;
    const int t = lane & 3;
    const int rl = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // tile rows rl and rl + 8
    // a buffer this full is folded: half of it at least, so that a fold
    // takes in many candidates, and kp at least, so that a fold raises the
    // threshold
    const int trig = max(min(kp, CAP), CAP / 2);

    // two independent accumulator chains, so that the tensor cores
    // overlap them: x_hi [q_hi | q_lo] (queries 0..QT-1 of the hi parts,
    // then of the lo parts) and x_lo q_hi
    float acc[QT] = {};
    float acc_lo[QT / 2] = {};
    float sq[2] = {0.f, 0.f};
    int live[2] = {0, 0};
    for (int s = 0, slot = 0, phase = 0; s < stages; ++s) {
        const int col = s % nd;
        mbar_wait(bar_full + 8 * slot, phase);
        if (col == 0) {
            live[0] = svalid[slot * TR + rl];
            live[1] = svalid[slot * TR + rl + 8];
            sq[0] = sq[1] = 0.f;
        }
        // A fragments of the 4 k-steps: rows rl, rl + 8, columns 8 ks + t and
        // 8 ks + t + 4, in the 128-byte swizzle (16-byte chunk c of row r at
        // chunk c ^ (r % 8), and rl % 8 == g), split into tf32 hi and lo
        const float* xa = sx + slot * (TR * DK) + rl * DK;
        const float* xb = xa + 8 * DK;
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            const int c0 = (((2 * ks) ^ g) << 2) + t;
            const int c1 = (((2 * ks + 1) ^ g) << 2) + t;
            const float x[4] = {xa[c0], xb[c0], xa[c1], xb[c1]};
            if (L2) {
                sq[0] = fmaf(x[0], x[0], fmaf(x[2], x[2], sq[0]));
                sq[1] = fmaf(x[1], x[1], fmaf(x[3], x[3], sq[1]));
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                ahi[ks][i] = tf32_rna(x[i]);
                alo[ks][i] = tf32_rna(x[i] - __uint_as_float(ahi[ks][i]));
            }
        }
        // the queries' hi box, then their lo box: 2 QT rows of 128 bytes,
        // 8-row groups 1024 bytes apart; a k-step of 8 columns starts 32
        // bytes further. The first product of a tile overwrites.
        const uint64_t dq = smem_desc<128>(smem + S.q() + slot * 2 * Q_BYTES, 16, 1024);
        fence_regs(acc);
        fence_regs(acc_lo);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            wgmma_tf32(acc, ahi[ks], dq + 2 * ks, col + ks);
            wgmma_tf32(acc_lo, alo[ks], dq + 2 * ks, col + ks);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(acc_lo);
        if (lane == 0) mbar_arrive(bar_empty + 8 * slot);  // this warp is done with the stage
        if (++slot == nst) {
            slot = 0;
            phase ^= 1;
        }
        if (col != nd - 1) continue;

        // tile done: scores against the thresholds, survivors into the
        // candidate buffers, full buffers folded, until no score waits
        const int row0 = (t_begin + s / nd) * TR;
        if (L2) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], 1);
                sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], 2);
            }
        }
        float sc[QT / 2];
        uint32_t pending = 0;
#pragma unroll
        for (int j = 0; j < QT / 2; ++j) {
            const int h = (j >> 1) & 1;  // row rl + 8 h
            const int q = 8 * (j >> 2) + 2 * t + (j & 1);
            const float dot = (acc[j] + acc[j + QT / 2]) + acc_lo[j];
            const float v = L2 ? 2.f * dot - sq[h] : dot;  // -||q||^2 is rank-invariant
            sc[j] = v + (live[h] ? 0.f : NEG_INF);
            if (row0 + rl + 8 * h < n && q0 + q < nq) pending |= 1u << j;
        }
        const bool last = s == stages - 1;
        for (;;) {
            // this thread's QT / 4 queries' thresholds, in registers
            float ts[QT / 4];
            int ti[QT / 4];
#pragma unroll
            for (int u = 0; u < QT / 4; ++u) {
                const int q = 8 * (u >> 1) + 2 * t + (u & 1);
                ts[u] = Ls[q * kp + kp - 1];
                ti[u] = Li[q * kp + kp - 1];
            }
#pragma unroll
            for (int j = 0; j < QT / 2; ++j) {
                const int u = ((j >> 2) << 1) | (j & 1);
                const int id = row0 + rl + 8 * ((j >> 1) & 1);
                if (!better(sc[j], id, ts[u], ti[u])) pending &= ~(1u << j);
            }
#pragma unroll
            for (int j = 0; j < QT / 2; ++j) {
                if (!(pending & (1u << j))) continue;
                const int q = 8 * (j >> 2) + 2 * t + (j & 1);
                const int slot_q = atomicAdd(&cnt[q], 1);
                if (slot_q < CAP) {
                    Bs[q * CAP + slot_q] = sc[j];
                    Bi[q * CAP + slot_q] = row0 + rl + 8 * ((j >> 1) & 1);
                    pending &= ~(1u << j);
                }
            }
            consumer_sync();
            for (int q = warp; q < QT; q += CONSUMERS / 32) {
                const int c = cnt[q];
                if (c >= trig || (last && c > 0)) {
                    fold_candidates(Ls + q * kp, Li + q * kp, Bs + q * CAP, Bi + q * CAP,
                                    min(c, CAP), kp, lane);
                    if (lane == 0) cnt[q] = 0;
                }
            }
            if (!consumer_sync_or(pending != 0)) break;  // a waiting score sees the new lists
        }
    }
    consumer_sync();
    const size_t base = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * QT * kp;
    for (int p = tid; p < QT * kp; p += CONSUMERS) {
        cand_s[base + p] = Ls[p];
        cand_i[base + p] = Li[p];
    }
}

// grid: (nq). Folds the query's per-block lists into its global top-k:
// each warp folds every MERGE_WARPS-th list into a list of its own (the
// warps' loads overlap), then the warps' lists fold pairwise in a tree.
__global__ void __launch_bounds__(MERGE_THREADS)
knn_merge(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
          int nblocks, int qt, int kp, int k, float* __restrict__ out_s,
          int* __restrict__ out_i) {
    extern __shared__ __align__(16) float msmem[];  // per warp: T and B lists
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    float* Ts = msmem + warp * 4 * kp;
    int* Ti = reinterpret_cast<int*>(Ts + kp);
    float* Bs = reinterpret_cast<float*>(Ti + kp);
    int* Bi = reinterpret_cast<int*>(Bs + kp);
    const int q = blockIdx.x;
    const int group = q / qt;
    const int qq = q % qt;
    for (int p = lane; p < kp; p += 32) {
        Ts[p] = -INFINITY;
        Ti[p] = INT_MAX;
    }
    __syncwarp();
    for (int b = warp; b < nblocks; b += MERGE_WARPS) {
        const size_t base = (((size_t)group * nblocks + b) * qt + qq) * kp;
        for (int p = lane; p < kp; p += 32) {
            Bs[p] = cand_s[base + p];
            Bi[p] = cand_i[base + p];
        }
        __syncwarp();
        merge_topk(Ts, Ti, Bs, Bi, kp, kp, lane);
    }
    __syncthreads();
    for (int step = 1; step < MERGE_WARPS; step <<= 1) {  // a tree of warp folds
        if ((warp & (2 * step - 1)) == 0) {
            const float* os = msmem + (warp + step) * 4 * kp;
            merge_topk(Ts, Ti, os, reinterpret_cast<const int*>(os + kp), kp, kp, lane);
        }
        __syncthreads();
    }
    for (int p = threadIdx.x; p < k; p += MERGE_THREADS) {
        out_s[(size_t)q * k + p] = msmem[p];
        out_i[(size_t)q * k + p] = reinterpret_cast<const int*>(msmem + kp)[p];
    }
}

// a [rows, d] f32 array as a 2-D tensor map with boxes of `box_rows` rows
// x 32 columns, 128-byte swizzle; rows past `rows` and columns past d read
// as zeros
bool make_map(CUtensorMap* map, const void* base, long long rows, int d, int box_rows) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
    const cuuint32_t box[2] = {(cuuint32_t)DK, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                  strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// pass 1: one block per SM and query group (the ring takes more than half
// of an SM's shared memory, so a second block never fits)
template <int QT, bool L2>
cudaError_t launch_block(const void* index, const uint8_t* valid, const float* qsplit, int n,
                         int d, int nq, int kp, int tiles_per_block, int nblocks,
                         float* cand_s, int* cand_i, cudaStream_t stream) {
    const int groups = (nq + QT - 1) / QT;
    CUtensorMap tx, tq;
    if (!make_map(&tx, index, n, d, TR) || !make_map(&tq, qsplit, 2LL * groups * QT, d, QT)) {
        return cudaErrorInvalidValue;
    }
    const Smem<QT> layout{ring_stages<QT>(kp), kp};
    const cudaError_t err = cudaFuncSetAttribute(
        knn_block_topk<QT, L2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)layout.alloc());
    if (err != cudaSuccess) return err;
    knn_block_topk<QT, L2><<<dim3(nblocks, groups), THREADS, layout.alloc(), stream>>>(
        tx, tq, valid, n, d, nq, kp, layout.nst, tiles_per_block, cand_s, cand_i);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch and outputs are allocated by the caller:
//   qsplit f32:              [ceil(nq/qt), 2, qt, d]
//   cand_s f32 / cand_i i32: [ceil(nq/qt), nblocks, qt, kp]
//   out_s f32 / out_i i32:   [nq, k]
// qt in {8, 16, 32, 64}; kp a power of two in [k, 128]; metric_l2 selects
// 2 q.x - ||x||^2 over the plain inner product. d % 4 == 0 and index
// 16-byte aligned (TMA).
int pwt_knn_topk(const void* index, const void* valid, const void* queries,
                 int n, int d, int nq, int k, int kp, int qt, int metric_l2,
                 int tiles_per_block, int nblocks, void* qsplit, void* cand_s,
                 void* cand_i, void* out_s, void* out_i, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int groups = (nq + qt - 1) / qt;
    const size_t total = (size_t)groups * qt * d;
    const int split_blocks = total >= 1024 * 256 ? 1024 : (int)((total + 255) / 256);
    float* qs = static_cast<float*>(qsplit);
    knn_split_queries<<<split_blocks, 256, 0, st>>>(static_cast<const float*>(queries), nq, d,
                                                    qt, groups, qs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const uint8_t* v = static_cast<const uint8_t*>(valid);
    float* cs = static_cast<float*>(cand_s);
    int* ci = static_cast<int*>(cand_i);
#define PWT_KNN_CASE(QTV)                                                              \
    case QTV:                                                                          \
        err = metric_l2 ? launch_block<QTV, true>(index, v, qs, n, d, nq, kp,          \
                                                  tiles_per_block, nblocks, cs, ci, st) \
                        : launch_block<QTV, false>(index, v, qs, n, d, nq, kp,         \
                                                   tiles_per_block, nblocks, cs, ci, st); \
        break;
    switch (qt) {
        PWT_KNN_CASE(8)
        PWT_KNN_CASE(16)
        PWT_KNN_CASE(32)
        PWT_KNN_CASE(64)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef PWT_KNN_CASE
    if (err != cudaSuccess) return (int)err;
    const size_t msmem = (sizeof(float) + sizeof(int)) * 2 * (size_t)kp * MERGE_WARPS;
    knn_merge<<<nq, MERGE_THREADS, msmem, st>>>(cs, ci, nblocks, qt, kp, k,
                                                static_cast<float*>(out_s),
                                                static_cast<int*>(out_i));
    return (int)cudaGetLastError();
}

}  // extern "C"
