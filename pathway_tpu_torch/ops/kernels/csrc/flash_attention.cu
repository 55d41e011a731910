// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pathway_tpu/ops/kernels/flash_attention.py
// (`_kernel`, launched by `_flash_fwd`): online-softmax attention over
// [B, H, L, D] with f32 running max, normaliser and accumulator, a kv
// padding mask applied as an additive -1e30, an optional causal mask, and
// a zero denominator replaced by 1. The [L, L] score matrix never reaches
// device memory.
//
// What bounds it on this card: at the encoder's shapes (D = 32, L <= 512)
// attention does 4*B*H*L*L*D FLOPs against 4*B*H*L*D*2 bytes of q, k, v
// and o, about 128 FLOPs per byte at L = 512, so the bf16 bound is close
// to balanced between memory and tensor cores, and in practice the
// softmax (one exp per score on the special-function units) and the
// register traffic around the products decide. Two kernels:
//
//   flash_fwd_bf16 (bf16, the encoder's path): tensor cores through
//     mma.sync m16n8k16 (bf16 in, f32 accumulate). A block owns 64 query
//     rows of one (batch, head), 16 per warp; q stays in registers as mma
//     A fragments for the whole kv loop. Per 64-key tile staged in shared
//     memory (k as loaded, v transposed so the PV B fragments are 32-bit
//     reads), S = q k^T lands in registers in the mma C layout, the
//     online softmax runs on those registers (row max across the 4 lanes
//     that share a row by shuffles), and P, rounded to bf16, is fed back as
//     the A operand of P v without touching shared memory. Head dim stays
//     at its real size (no padding to 128 lanes as on the TPU).
//   flash_fwd_f32 (f32): the simple design, one thread per query row on
//     the CUDA cores with q, the accumulator and the softmax state in
//     registers, 32-key tiles in shared memory read as broadcasts. It
//     serves f32 callers (tests, f32 configs), not the bf16 encoder.
//
// The sequential kv grid axis of the TPU kernel becomes the loop over kv
// tiles inside a block. Keys past the end of the sequence take no part;
// keys that the kv mask drops get -1e30 added and causally hidden keys are
// set to -1e30, so a row with no live key averages v over its keys as the
// reference does (finite, never read by pooling).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;  // JAX NEG_INF

// ---- f32: one thread per query row ---------------------------------------

constexpr int BQ = 128;  // query rows per block, one per thread
constexpr int BK = 32;   // keys per shared-memory tile

// grid: (B*H, ceil(Lq / BQ)); block: BQ threads.
template <int D>
__global__ void __launch_bounds__(BQ)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int32_t* __restrict__ kv_mask,
              float* __restrict__ o, int H, int Lq, int Lk, float sm_scale, int causal) {
    __shared__ float Ks[BK][D];
    __shared__ float Vs[BK][D];
    __shared__ float Ms[BK];

    const int bh = blockIdx.x;
    const int b = bh / H;
    const int qi = blockIdx.y * BQ + threadIdx.x;
    const bool active = qi < Lq;

    float qr[D];
    float acc[D];
    const float* qrow = q + ((size_t)bh * Lq + (active ? qi : 0)) * D;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
        qr[dd] = active ? qrow[dd] : 0.f;
        acc[dd] = 0.f;
    }
    float m = NEG_INF;
    float l = 0.f;

    const float* kb = k + (size_t)bh * Lk * D;
    const float* vb = v + (size_t)bh * Lk * D;
    const int32_t* mb = kv_mask + (size_t)b * Lk;
    // causal: keys after the block's last query row are masked for every
    // row of the block, and add exactly 0 to any row with a live key
    const int kend = causal ? min(Lk, (int)(blockIdx.y + 1) * BQ) : Lk;

    for (int k0 = 0; k0 < kend; k0 += BK) {
        __syncthreads();  // previous tile fully consumed
        for (int e = threadIdx.x; e < BK * D; e += BQ) {
            const int j = e / D;
            const int dd = e - j * D;
            const int kj = k0 + j;
            Ks[j][dd] = kj < Lk ? kb[(size_t)kj * D + dd] : 0.f;
            Vs[j][dd] = kj < Lk ? vb[(size_t)kj * D + dd] : 0.f;
        }
        for (int j = threadIdx.x; j < BK; j += BQ) {
            const int kj = k0 + j;
            Ms[j] = kj < Lk ? (1.f - (float)mb[kj]) * NEG_INF : 0.f;
        }
        __syncthreads();

        float s[BK];
        float m_new = m;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            float dot = 0.f;
#pragma unroll
            for (int dd = 0; dd < D; ++dd) dot = fmaf(qr[dd], Ks[j][dd], dot);
            const int kj = k0 + j;
            float sj;
            if (kj >= Lk) {
                sj = -INFINITY;  // not a key at all
            } else if (causal && kj > qi) {
                sj = NEG_INF;
            } else {
                sj = dot * sm_scale + Ms[j];
            }
            s[j] = sj;
            m_new = fmaxf(m_new, sj);
        }
        const float alpha = expf(m - m_new);
        l *= alpha;
#pragma unroll
        for (int dd = 0; dd < D; ++dd) acc[dd] *= alpha;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            const float p = expf(s[j] - m_new);
            l += p;
#pragma unroll
            for (int dd = 0; dd < D; ++dd) acc[dd] = fmaf(p, Vs[j][dd], acc[dd]);
        }
        m = m_new;
    }

    if (active) {
        const float denom = l == 0.f ? 1.f : l;
        float* orow = o + ((size_t)bh * Lq + qi) * D;
#pragma unroll
        for (int dd = 0; dd < D; ++dd) orow[dd] = acc[dd] / denom;
    }
}

// ---- bf16: tensor cores (mma.sync m16n8k16) -------------------------------

constexpr int TQ = 64;   // query rows per block: 4 warps x 16
constexpr int TK = 64;   // keys per shared-memory tile
constexpr int TC_THREADS = 128;

// D += A B for one m16n8k16 tile: A 16x16 bf16 (row), B 16x8 bf16 (col),
// D 16x8 f32. Lane (g = lane / 4, t = lane % 4) holds A rows g, g + 8 at
// columns 2t, 2t + 1 (+8); B column g at rows 2t, 2t + 1 (+8); D rows g,
// g + 8 at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// grid: (B*H, ceil(Lq / TQ)); block: TC_THREADS. All row starts of q, k, v
// and o are 16-byte aligned (D % 8 == 0, base pointers checked by the
// wrapper).
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ kv_mask,
               __nv_bfloat16* __restrict__ o, int H, int Lq, int Lk, float sm_scale,
               int causal) {
    constexpr int KS = D / 16;      // k-steps of q k^T
    constexpr int DT = D / 8;       // n-tiles of the output
    constexpr int NT = TK / 8;      // n-tiles of the scores
    constexpr int CH = D / 8;       // 16-byte chunks per k / v row
    constexpr int KSTR = D + 8;     // Ks row stride (bf16): conflict-free B reads
    constexpr int VSTR = TK + 8;    // Vt row stride (bf16)
    __shared__ __align__(16) __nv_bfloat16 Ks[TK * KSTR];  // [key][d]
    __shared__ __align__(16) __nv_bfloat16 Vt[D * VSTR];   // [d][key]
    __shared__ float Ms[TK];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int bh = blockIdx.x;
    const int b = bh / H;
    const int row0 = blockIdx.y * TQ + warp * 16 + g;  // this lane's rows: row0, row0 + 8

    // q as A fragments, kept in registers for the whole kv loop
    const __nv_bfloat16* qb = q + (size_t)bh * Lq * D;
    uint32_t qa[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int row = row0 + 8 * (r & 1);
            const int col = ks * 16 + 2 * t + (r >> 1) * 8;
            qa[ks][r] = row < Lq ? ld32(qb + (size_t)row * D + col) : 0u;
        }
    }

    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};  // this lane's partial row sums
    float acc[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

    const __nv_bfloat16* kb = k + (size_t)bh * Lk * D;
    const __nv_bfloat16* vb = v + (size_t)bh * Lk * D;
    const int32_t* mb = kv_mask + (size_t)b * Lk;
    const int kend = causal ? min(Lk, (int)(blockIdx.y + 1) * TQ) : Lk;

    for (int k0 = 0; k0 < kend; k0 += TK) {
        __syncthreads();  // previous tile fully consumed
        // neighbouring lanes take neighbouring keys: the transposed v
        // stores then hit distinct shared-memory words
        for (int e = threadIdx.x; e < TK * CH; e += TC_THREADS) {
            const int j = e % TK;
            const int c = (e / TK) * 8;
            uint4 kv = make_uint4(0u, 0u, 0u, 0u);
            uint4 vv = make_uint4(0u, 0u, 0u, 0u);
            if (k0 + j < Lk) {
                kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + j) * D + c);
                vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + j) * D + c);
            }
            *reinterpret_cast<uint4*>(Ks + j * KSTR + c) = kv;
            const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
            for (int u = 0; u < 8; ++u) Vt[(c + u) * VSTR + j] = ve[u];
        }
        for (int j = threadIdx.x; j < TK; j += TC_THREADS) {
            const int kj = k0 + j;
            Ms[j] = kj < Lk ? (1.f - (float)mb[kj]) * NEG_INF : -INFINITY;
        }
        __syncthreads();

        // S = q k^T, [16 rows x 64 keys] per warp in mma C layout
        float s[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                const __nv_bfloat16* kr = Ks + (nt * 8 + g) * KSTR + ks * 16 + 2 * t;
                mma_bf16(s[nt], qa[ks], ld32(kr), ld32(kr + 8));
            }
        }
        // scale, mask, running max (the 4 lanes of a row share it)
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int jj = nt * 8 + 2 * t + (e & 1);
                const int kj = k0 + jj;
                float val = s[nt][e] * sm_scale + Ms[jj];  // -inf past the end
                if (causal && kj > row0 + 8 * (e >> 1) && kj < Lk) val = NEG_INF;
                s[nt][e] = val;
                mx[e >> 1] = fmaxf(mx[e >> 1], val);
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            const float alpha = expf(m[i] - mx[i]);
            m[i] = mx[i];
            l[i] *= alpha;
#pragma unroll
            for (int dt = 0; dt < DT; ++dt) {
                acc[dt][2 * i] *= alpha;
                acc[dt][2 * i + 1] *= alpha;
            }
        }
        // P = exp(S - m) as bf16 A fragments (C layout of two neighbouring
        // n-tiles = A layout of one 16-key step), then acc += P v
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
            float p[8];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int e = 0; e < 4; ++e) p[4 * h + e] = expf(s[2 * kk + h][e] - m[e >> 1]);
            }
            l[0] += p[0] + p[1] + p[4] + p[5];
            l[1] += p[2] + p[3] + p[6] + p[7];
            const uint32_t pa[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                                    pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])};
#pragma unroll
            for (int dt = 0; dt < DT; ++dt) {
                const __nv_bfloat16* vr = Vt + (dt * 8 + g) * VSTR + kk * 16 + 2 * t;
                mma_bf16(acc[dt], pa, ld32(vr), ld32(vr + 8));
            }
        }
    }

    __nv_bfloat16* ob = o + (size_t)bh * Lq * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
        const int row = row0 + 8 * i;
        if (row < Lq) {
#pragma unroll
            for (int dt = 0; dt < DT; ++dt) {
                *reinterpret_cast<uint32_t*>(ob + (size_t)row * D + dt * 8 + 2 * t) =
                    pack_bf16(acc[dt][2 * i] * inv, acc[dt][2 * i + 1] * inv);
            }
        }
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_mask,
                   void* o, int B, int H, int Lq, int Lk, float sm_scale, int causal,
                   int is_bf16, cudaStream_t stream) {
    const int32_t* mask = static_cast<const int32_t*>(kv_mask);
    if (is_bf16) {
        dim3 grid(B * H, (Lq + TQ - 1) / TQ);
        flash_fwd_bf16<D><<<grid, TC_THREADS, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(o), H,
            Lq, Lk, sm_scale, causal);
    } else {
        dim3 grid(B * H, (Lq + BQ - 1) / BQ);
        flash_fwd_f32<D><<<grid, BQ, 0, stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), mask, static_cast<float*>(o), H, Lq, Lk,
            sm_scale, causal);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: [B, H, Lq, D], k / v: [B, H, Lk, D], all contiguous, f32 or bf16
// (is_bf16; bf16 pointers 16-byte aligned); kv_mask: [B, Lk] int32
// (1 = live key); o: like q. D in {16, 32, 64}.
int pwt_flash_attention_fwd(const void* q, const void* k, const void* v,
                            const void* kv_mask, void* o, int B, int H, int Lq,
                            int Lk, int D, float sm_scale, int causal, int is_bf16,
                            void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return (int)launch<16>(q, k, v, kv_mask, o, B, H, Lq, Lk, sm_scale, causal, is_bf16, st);
        case 32: return (int)launch<32>(q, k, v, kv_mask, o, B, H, Lq, Lk, sm_scale, causal, is_bf16, st);
        case 64: return (int)launch<64>(q, k, v, kv_mask, o, B, H, Lq, Lk, sm_scale, causal, is_bf16, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
