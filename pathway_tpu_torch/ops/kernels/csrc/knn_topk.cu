// Streaming KNN similarity + top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pathway_tpu/ops/kernels/knn_topk.py
// (`_block_kernel`, launched by `_make_knn`): scores of Q queries against
// an [N, D] f32 index, dead slots pushed down by an additive -1e30, and the
// global top-k per query, without ever writing the [Q, N] score matrix.
//
// What bounds it on this card: the index is read once. At N = 2^20,
// D = 384 that is 1.6 GB, ~0.48 ms at 3.35 TB/s; for Q = 64 the f32 FMAs
// (2*Q*N*D = 52 GFLOP, ~0.77 ms at 67 TFLOP/s without tensor cores) bound
// it instead. The TPU design walks N in order through one large VMEM
// block; here Q is tiny and N is large, so the parallelism comes from
// splitting N over many blocks:
//
//   pass 1 (knn_block_topk): each block owns a contiguous run of 128-row
//     tiles and a group of up to 64 queries. The index and query tiles
//     stream through shared memory in 32-column stages with cp.async,
//     double-buffered so the next stage's loads overlap this stage's
//     FMAs. Each warp owns QT/8 queries and each lane 4 rows of the tile,
//     so a warp ends a tile with its queries' 128 scores in registers; it
//     keeps a sorted top-KP list per query in shared memory and inserts
//     only the scores that beat the list's last entry (a warp ballot
//     finds them), which after the first tiles is rare. Each block
//     writes its [QT, KP] lists: [blocks, Q, KP] candidates in all, a few
//     MB against the 1.6 GB index.
//   pass 2 (knn_merge): one block per query folds the per-block lists into
//     the global top-k (max-trick + bitonic merge of sorted lists), its 16
//     warps folding disjoint lists in parallel before the block folds
//     theirs.
//
// Order is (score descending, slot ascending), so ties resolve to the
// lower slot and the result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int TR = 128;            // index rows per tile
constexpr int DK = 32;             // feature columns per shared-memory stage
constexpr int THREADS = 256;       // pass-1 block size
constexpr int MERGE_WARPS = 16;    // pass-2 warps per query
constexpr int MERGE_THREADS = 32 * MERGE_WARPS;
constexpr int XS_STRIDE = DK + 4;  // shared-memory row stride (floats)
constexpr float NEG_INF = -1e30f;  // additive dead-slot penalty (JAX NEG_INF)

__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
    return as > bs || (as == bs && ai < bi);
}

template <bool WARP>
__device__ __forceinline__ void group_sync() {
    if (WARP) __syncwarp(); else __syncthreads();
}

// Merge the sorted (descending) lists b[row][0..kp) (row stride bstride)
// into the sorted lists t[row][0..kp) (row stride kp), keeping the best kp
// of each union: t[i] = max(t[i], b[kp-1-i]) is bitonic and holds the best
// kp; a bitonic merge sorts it again. Run by `nt` threads of one warp
// (WARP) or of the whole block, thread `t` of them. Ends synchronised.
template <bool WARP>
__device__ void merge_topk_rows(float* ts, int* ti, const float* bs, const int* bi,
                                int rows, int kp, int bstride, int t, int nt) {
    for (int p = t; p < rows * kp; p += nt) {
        const int row = p / kp;
        const int i = p - row * kp;
        const float b = bs[row * bstride + kp - 1 - i];
        const int bidx = bi[row * bstride + kp - 1 - i];
        if (better(b, bidx, ts[p], ti[p])) {
            ts[p] = b;
            ti[p] = bidx;
        }
    }
    group_sync<WARP>();
    const int half = kp >> 1;
    const int pairs = rows * half;
    for (int stride = half; stride > 0; stride >>= 1) {
        for (int p = t; p < pairs; p += nt) {
            const int row = p / half;
            const int i = p - row * half;
            const int lo = (i / stride) * 2 * stride + (i % stride);
            const int hi = lo + stride;
            float* rs = ts + row * kp;
            int* ri = ti + row * kp;
            if (better(rs[hi], ri[hi], rs[lo], ri[lo])) {
                const float a = rs[lo];
                const int ai = ri[lo];
                rs[lo] = rs[hi]; ri[lo] = ri[hi];
                rs[hi] = a; ri[hi] = ai;
            }
        }
        group_sync<WARP>();
    }
}

// Insert (v, vi) into the sorted (descending) list t[0..kp), kp <= 128,
// dropping its last entry; the whole warp calls it with the same value.
__device__ void warp_insert(float* ts, int* ti, int kp, float v, int vi, int lane) {
    int ahead = 0;  // entries that stay in front of the new one
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int p = lane + 32 * j;
        if (p < kp) ahead += better(ts[p], ti[p], v, vi);
    }
    ahead = __reduce_add_sync(0xffffffffu, ahead);
    float nv[4];
    int ni[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int p = lane + 32 * j;
        nv[j] = v;
        ni[j] = vi;
        if (p < kp && p > ahead) {
            nv[j] = ts[p - 1];
            ni[j] = ti[p - 1];
        }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int p = lane + 32 * j;
        if (p < kp && p >= ahead) {
            ts[p] = nv[j];
            ti[p] = ni[j];
        }
    }
    __syncwarp();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
    const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int bytes = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(saddr), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::);
}

size_t block_smem_bytes(int qt, int kp) {
    return sizeof(float) * 2 * (size_t)(TR + qt) * XS_STRIDE
         + (sizeof(float) + sizeof(int)) * (size_t)qt * kp;
}

// grid: (blocks, query groups of QT). cand_*: [groups, blocks, QT, kp].
template <int QT, bool L2>
__global__ void __launch_bounds__(THREADS)
knn_block_topk(const float* __restrict__ index, const uint8_t* __restrict__ valid,
               const float* __restrict__ queries, int n, int d, int nq, int kp,
               int tiles_per_block, float* __restrict__ cand_s,
               int* __restrict__ cand_i) {
    constexpr int QM = QT / 8;  // queries per warp
    extern __shared__ __align__(16) float smem[];
    float* Xs = smem;                              // [2][TR][XS_STRIDE] index stages
    float* Qs = Xs + 2 * TR * XS_STRIDE;           // [2][QT][XS_STRIDE] query stages
    float* Ts = Qs + 2 * QT * XS_STRIDE;           // [QT][kp] running top lists
    int* Ti = reinterpret_cast<int*>(Ts + QT * kp);

    const int tid = threadIdx.x;
    const int lane = tid & 31;  // rows lane + 32 i of the tile
    const int warp = tid >> 5;  // queries warp*QM .. warp*QM+QM-1 of the group
    const int q0 = blockIdx.y * QT;
    const int nd = (d + DK - 1) / DK;
    const int ntiles = (n + TR - 1) / TR;
    const int t_begin = blockIdx.x * tiles_per_block;
    const int stages = max(0, min(ntiles, t_begin + tiles_per_block) - t_begin) * nd;

    for (int p = tid; p < QT * kp; p += THREADS) {
        Ts[p] = -INFINITY;
        Ti[p] = INT_MAX;
    }

    // stage s = (tile t_begin + s / nd, columns (s % nd) * DK ..): cp.async
    // copies of the index tile and the query tile into buffer s & 1
    auto load_stage = [&](int s) {
        const int row0 = (t_begin + s / nd) * TR;
        const int d0 = (s % nd) * DK;
        float* xs = Xs + (s & 1) * TR * XS_STRIDE;
        float* qs = Qs + (s & 1) * QT * XS_STRIDE;
        for (int f = tid; f < TR * (DK / 4); f += THREADS) {
            const int r = f / (DK / 4);
            const int c = (f % (DK / 4)) * 4;
            const bool in = row0 + r < n && d0 + c < d;
            cp_async16(xs + r * XS_STRIDE + c,
                       in ? index + (size_t)(row0 + r) * d + d0 + c : index, in);
        }
        for (int f = tid; f < QT * (DK / 4); f += THREADS) {
            const int qq = f / (DK / 4);
            const int c = (f % (DK / 4)) * 4;
            const bool in = q0 + qq < nq && d0 + c < d;
            cp_async16(qs + qq * XS_STRIDE + c,
                       in ? queries + (size_t)(q0 + qq) * d + d0 + c : queries, in);
        }
    };

    float acc[QM][4];
    float sq[4];
    if (stages > 0) load_stage(0);
    cp_async_commit();
    for (int s = 0; s < stages; ++s) {
        if (s + 1 < stages) load_stage(s + 1);  // overlaps this stage's math
        cp_async_commit();
        cp_async_wait_one();
        __syncthreads();
        if (s % nd == 0) {
#pragma unroll
            for (int m = 0; m < QM; ++m) {
                acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
            }
            sq[0] = sq[1] = sq[2] = sq[3] = 0.f;
        }
        const float* xs = Xs + (s & 1) * TR * XS_STRIDE;
        const float* qs = Qs + (s & 1) * QT * XS_STRIDE;
#pragma unroll 2
        for (int c = 0; c < DK; c += 4) {
            float4 x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                x[i] = *reinterpret_cast<const float4*>(xs + (lane + 32 * i) * XS_STRIDE + c);
            }
#pragma unroll
            for (int m = 0; m < QM; ++m) {
                const float4 qv =
                    *reinterpret_cast<const float4*>(qs + (warp * QM + m) * XS_STRIDE + c);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    acc[m][i] = fmaf(qv.x, x[i].x, acc[m][i]);
                    acc[m][i] = fmaf(qv.y, x[i].y, acc[m][i]);
                    acc[m][i] = fmaf(qv.z, x[i].z, acc[m][i]);
                    acc[m][i] = fmaf(qv.w, x[i].w, acc[m][i]);
                }
            }
            if (L2) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    sq[i] = fmaf(x[i].x, x[i].x, sq[i]);
                    sq[i] = fmaf(x[i].y, x[i].y, sq[i]);
                    sq[i] = fmaf(x[i].z, x[i].z, sq[i]);
                    sq[i] = fmaf(x[i].w, x[i].w, sq[i]);
                }
            }
        }
        __syncthreads();  // buffer s & 1 is free for stage s + 2
        if (s % nd != nd - 1) continue;

        // tile done: each warp folds its queries' 128 scores into their
        // top lists. Only scores that beat the current kp-th best are
        // inserted, one at a time; after the first tiles that is rare.
        const int row0 = (t_begin + s / nd) * TR;
        float sc[4];
        int id[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = row0 + lane + 32 * i;
            id[i] = row < n ? row : INT_MAX;
            sc[i] = row < n ? (valid[row] ? 0.f : NEG_INF) : -INFINITY;
        }
#pragma unroll
        for (int m = 0; m < QM; ++m) {
            float* ts = Ts + (warp * QM + m) * kp;
            int* ti = Ti + (warp * QM + m) * kp;
            float thr = ts[kp - 1];
            int thr_i = ti[kp - 1];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float v = L2 ? 2.f * acc[m][i] - sq[i] : acc[m][i];  // -||q||^2 is rank-invariant
                v = id[i] == INT_MAX ? -INFINITY : v + sc[i];
                unsigned ballot = __ballot_sync(0xffffffffu, better(v, id[i], thr, thr_i));
                while (ballot) {
                    const int src = __ffs(ballot) - 1;
                    ballot &= ballot - 1;
                    const float bv = __shfl_sync(0xffffffffu, v, src);
                    const int bi = __shfl_sync(0xffffffffu, id[i], src);
                    if (better(bv, bi, thr, thr_i)) {
                        warp_insert(ts, ti, kp, bv, bi, lane);
                        thr = ts[kp - 1];
                        thr_i = ti[kp - 1];
                    }
                }
            }
        }
    }
    __syncthreads();
    const size_t base = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * QT * kp;
    for (int p = tid; p < QT * kp; p += THREADS) {
        cand_s[base + p] = Ts[p];
        cand_i[base + p] = Ti[p];
    }
}

// grid: (nq). Folds the query's per-block lists into its global top-k:
// each warp folds every MERGE_WARPS-th list into a list of its own (the
// warps' loads overlap), then the block folds the warps' lists together.
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
        merge_topk_rows<true>(Ts, Ti, Bs, Bi, 1, kp, kp, lane, 32);
    }
    __syncthreads();
    float* T0s = msmem;
    int* T0i = reinterpret_cast<int*>(T0s + kp);
    for (int w = 1; w < MERGE_WARPS; ++w) {
        const float* ws = msmem + w * 4 * kp;
        merge_topk_rows<false>(T0s, T0i, ws, reinterpret_cast<const int*>(ws + kp), 1, kp,
                               kp, threadIdx.x, MERGE_THREADS);
    }
    for (int p = threadIdx.x; p < k; p += MERGE_THREADS) {
        out_s[(size_t)q * k + p] = T0s[p];
        out_i[(size_t)q * k + p] = T0i[p];
    }
}

template <int QT, bool L2>
cudaError_t launch_block(const float* index, const uint8_t* valid, const float* queries,
                         int n, int d, int nq, int kp, int tiles_per_block,
                         int nblocks, float* cand_s, int* cand_i, cudaStream_t stream) {
    const size_t smem = block_smem_bytes(QT, kp);
    cudaError_t err = cudaFuncSetAttribute(knn_block_topk<QT, L2>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(nblocks, (nq + QT - 1) / QT);
    knn_block_topk<QT, L2><<<grid, THREADS, smem, stream>>>(
        index, valid, queries, n, d, nq, kp, tiles_per_block, cand_s, cand_i);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch and outputs are allocated by the caller:
//   cand_s f32 / cand_i i32: [ceil(nq/qt), nblocks, qt, kp]
//   out_s f32 / out_i i32:   [nq, k]
// qt in {8, 16, 32, 64}; kp a power of two in [k, 128]; metric_l2 selects
// 2 q.x - ||x||^2 over the plain inner product. d % 4 == 0.
int pwt_knn_topk(const void* index, const void* valid, const void* queries,
                 int n, int d, int nq, int k, int kp, int qt, int metric_l2,
                 int tiles_per_block, int nblocks, void* cand_s, void* cand_i,
                 void* out_s, void* out_i, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* x = static_cast<const float*>(index);
    const uint8_t* v = static_cast<const uint8_t*>(valid);
    const float* qs = static_cast<const float*>(queries);
    float* cs = static_cast<float*>(cand_s);
    int* ci = static_cast<int*>(cand_i);
    cudaError_t err;
#define PWT_KNN_CASE(QTV)                                                        \
    case QTV:                                                                    \
        err = metric_l2                                                          \
            ? launch_block<QTV, true>(x, v, qs, n, d, nq, kp, tiles_per_block,  \
                                      nblocks, cs, ci, st)                       \
            : launch_block<QTV, false>(x, v, qs, n, d, nq, kp, tiles_per_block, \
                                       nblocks, cs, ci, st);                     \
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
