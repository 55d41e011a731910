// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pathway_tpu/ops/kernels/flash_attention.py
// (`_kernel`, launched by `_flash_fwd`): online-softmax attention over
// [B, H, L, D] with f32 running max, normaliser and accumulator, a kv
// padding mask applied as an additive -1e30, an optional causal mask, and
// a zero denominator replaced by 1. The [L, L] score matrix never reaches
// device memory.
//
// What bounds it on this card, at the encoder's long-document shape
// [64, 12, 512, 32] bf16: the bytes of q, k, v and o take 0.030 ms at
// 3.35 TB/s; the 4 B H L^2 D products 0.026 ms at 989 TFLOP/s; the one
// exp per score (B H L^2 = 201 M) about 0.052 ms on the special-function
// units (16 a clock per SM). So the exp unit and the instructions around
// each score decide, not memory or the tensor cores. Two kernels:
//
//   flash_fwd_bf16 (bf16, the encoder's path). A block owns 128 query rows
//     of one (batch, head): two consumer warpgroups of 64 rows (wgmma takes
//     M = 64) and one producer warp.
//     - Bytes: the producer loads q once and each 64-key tile of k and v
//       by TMA into a ring of STAGES stages, one "full" mbarrier per stage
//       that the consumers wait on and one "empty" mbarrier that each
//       consumer warp arrives on when done, so copies run ahead of the
//       math. Tensor maps are 3-D [B H, L, D]: rows past L read as zeros,
//       never as the next head's. 128 query rows per block halve the L2
//       re-reads of k and v against 64, and the q tiles of one head are
//       neighbouring blocks, so its k and v come from HBM once.
//     - Tensor cores: S = q k^T is wgmma m64n64k16 with both operands in
//       shared memory, K-major as stored ([row][d]); O += P v is wgmma
//       m64nDk16 with P from registers and v's tile as stored ([key][d]),
//       which is MN-major for this product (the transposed-B flag), so v
//       is never transposed by hand. The swizzle is the row width (32, 64
//       or 128 bytes for D = 16, 32, 64) in both the tensor maps and the
//       wgmma descriptors. At D = 128 (the decoder's heads, 256-byte rows)
//       each tile is loaded as two 64-column boxes into two 128-byte
//       swizzled parts (Split): the k-steps of S walk part 0, then part 1,
//       and P v at N = 128 reads both parts of v through the descriptor's
//       leading byte offset.
//     - Exp unit: the softmax runs on the accumulator registers in log2
//       units: scale and mask are one FFMA per score (s * scale * log2(e)
//       plus the stage's mask addend, written to shared memory once per
//       tile by the producer), the row max is shuffled across the 4 lanes
//       of a row, and each score takes one ex2 (exp2f's instruction). P,
//       rounded to bf16, goes straight from the score registers into the
//       A operand of P v (the accumulator layout of two neighbouring
//       8-column blocks is the A layout of one 16-key step).
//   flash_fwd_f32 (f32, in flash_attention_f32.cu): the simple design, one
//     thread per query row on the CUDA cores. It serves f32 callers (tests,
//     f32 configs), not the bf16 encoder or decoder.
//
// The sequential kv grid axis of the TPU kernel becomes the loop over kv
// tiles inside a block. Keys past the end of the sequence take no part;
// keys that the kv mask drops get -1e30 added and causally hidden keys are
// set to -1e30 (times log2(e) in the bf16 kernel), so a row with no live
// key averages v over its keys as the reference does (finite, never read
// by pooling).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;  // JAX NEG_INF

// ---- bf16: wgmma, TMA ring, exp2 softmax -----------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF_LOG2 = NEG_INF * LOG2E;  // a masked score in log2 units
constexpr int WG_ROWS = 64;  // query rows per consumer warpgroup (wgmma M)
constexpr int NWG = 2;       // consumer warpgroups per block
constexpr int BM = NWG * WG_ROWS;  // query rows per block
constexpr int BN = 64;       // keys per kv tile
constexpr int STAGES = 3;    // kv tiles in the ring

// Column split of a q / k / v tile. The 128-byte swizzle is the widest, so
// a row wider than 128 bytes (D = 128, 256 bytes) is loaded as NH boxes of
// CW columns, each into a [rows][CW] part of its own: a tile is stored as
// [NH][rows][CW], swizzled by the part's row width CW * 2 bytes. At D <= 64
// NH = 1 and the part is the whole tile.
template <int D>
struct Split {
    static constexpr int CW = D > 64 ? 64 : D;  // columns of one part
    static constexpr int NH = D / CW;            // parts of a row
    static constexpr uint32_t ROW = CW * 2;      // bytes of a row of one part
};

// Shared memory of one block, byte offsets from a 1024-byte aligned base
// (every tile and every part starts on a whole swizzle atom): q, the k and
// v rings, the mask addends of each stage, then the mbarriers (full[STAGES],
// empty[STAGES], q). D = 128 takes 32 KB for q and 96 KB for the ring, so
// one block fits on an SM.
template <int D>
struct Smem {
    static constexpr int Q = 0;
    static constexpr int K = Q + BM * D * 2;
    static constexpr int V = K + STAGES * BN * D * 2;
    static constexpr int MASK = V + STAGES * BN * D * 2;
    static constexpr int BAR = MASK + STAGES * BN * 4;
    static constexpr int ALLOC = BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

// d (+)= A B, m64n64k16: A [64 x 16] and B [16 x 64] both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64n16k16: A [64 x 16] from registers, B [16 x 16] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n32k16: A [64 x 16] from registers, B [16 x 32] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n64k16: A [64 x 16] from registers, B [16 x 64] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n128k16: A [64 x 16] from registers, B [16 x 128] MN-major in
// shared memory (two 64-column swizzle atoms, the leading byte offset apart)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x as one ex2 on the special-function unit: exp2f's instruction, with
// results below 2^-126 flushed to zero
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// two floats as one bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// grid: B * H * q_tiles blocks, the q tiles of one (batch, head) adjacent
// so that its k and v stay in L2; block: NWG consumer warpgroups, then one
// producer warp. Rows past Lq read as zeros and are never stored. Lane (g = lane / 4, t = lane % 4) of warp w of a consumer
// warpgroup holds the accumulator rows 16 w + g and 16 w + g + 8 at
// columns 8 n + 2 t and 8 n + 2 t + 1 (registers 4 n .. 4 n + 3).
// Two blocks share an SM up to D = 64 (at most 113 registers a thread); at
// D = 128 the accumulator alone takes 64 registers and the shared memory
// allows one block, so the compiler may use up to 224.
template <int D>
__global__ void __launch_bounds__(NWG * 128 + 32, D > 64 ? 1 : 2)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const int32_t* __restrict__ kv_mask,
               __nv_bfloat16* __restrict__ o, int H, int Lq, int Lk, int q_tiles,
               float scale_log2, int causal) {
    using S = Smem<D>;
    using P = Split<D>;
    constexpr uint32_t ROW = D * 2;  // bytes of one q / k / v row
    constexpr int CW = P::CW;
    constexpr uint32_t PROW = P::ROW;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + S::Q);
    __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem + S::K);
    __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem + S::V);
    float* smask = reinterpret_cast<float*>(smem + S::MASK);
    const uint32_t bar_full = smem_u32(smem + S::BAR);
    const uint32_t bar_empty = bar_full + 8 * STAGES;
    const uint32_t bar_q = bar_empty + 8 * STAGES;

    const int bh = blockIdx.x / q_tiles;
    const int q0 = (blockIdx.x - bh * q_tiles) * BM;
    // causal: keys after the block's last query row are masked for every
    // row of the block, and add exactly 0 to any row with a live key
    const int kend = causal ? min(Lk, q0 + BM) : Lk;
    const int n_tiles = (kend + BN - 1) / BN;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(bar_full + 8 * s, 32);        // every producer lane
            mbar_init(bar_empty + 8 * s, NWG * 4);  // every consumer warp
        }
        mbar_init(bar_q, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp == NWG * 4) {
        // producer: q once, then per kv tile its k and v (TMA) and its mask
        // addends in log2 units, up to STAGES tiles ahead of the consumers
        const int32_t* mb = kv_mask + (size_t)(bh / H) * Lk;
        if (lane == 0) {
            mbar_arrive_expect_tx(bar_q, BM * ROW);
#pragma unroll
            for (int h = 0; h < P::NH; ++h)
                tma_load_3d(smem_u32(sq + h * BM * CW), &tm_q, bar_q, h * CW, q0, bh);
        }
        for (int j = 0; j < n_tiles; ++j) {
            const int s = j % STAGES;
            if (j >= STAGES) mbar_wait(bar_empty + 8 * s, (j / STAGES - 1) & 1);
            const int k0 = j * BN;
            for (int c = lane; c < BN; c += 32) {
                const int key = k0 + c;
                smask[s * BN + c] = key < Lk ? (1.f - (float)mb[key]) * NEG_INF_LOG2 : -INFINITY;
            }
            if (lane == 0) {
                mbar_arrive_expect_tx(bar_full + 8 * s, 2 * BN * ROW);
#pragma unroll
                for (int h = 0; h < P::NH; ++h) {
                    const int part = s * BN * D + h * BN * CW;
                    tma_load_3d(smem_u32(sk + part), &tm_k, bar_full + 8 * s, h * CW, k0, bh);
                    tma_load_3d(smem_u32(sv + part), &tm_v, bar_full + 8 * s, h * CW, k0, bh);
                }
            } else {
                mbar_arrive(bar_full + 8 * s);
            }
        }
        return;
    }

    // consumer warpgroup wg: query rows q0 + 64 wg .. q0 + 64 wg + 63
    const int wg = warp >> 2;
    const int t = lane & 3;
    const int warp_row0 = q0 + wg * WG_ROWS + (warp & 3) * 16;
    const int row_a = warp_row0 + (lane >> 2);  // and row_a + 8
    // K-major operands (q, k): 8-row groups PROW * 8 bytes apart; a k-step
    // of 16 columns starts 32 bytes further into the swizzled rows of its
    // part, and the k-steps of part h read part h's rows
    constexpr int KS = CW / 16;  // k-steps in one part
    uint64_t dq[P::NH];
#pragma unroll
    for (int h = 0; h < P::NH; ++h)
        dq[h] = smem_desc<PROW>(sq + h * BM * CW + wg * WG_ROWS * CW, 16, 8 * PROW);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // finite after the first tile
    float l[2] = {0.f, 0.f};              // this lane's partial row sums
    mbar_wait(bar_q, 0);

    for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const int k0 = j * BN;
        mbar_wait(bar_full + 8 * s, (j / STAGES) & 1);

        // S = q k^T, [64 x BN] per warpgroup
        float sc[BN / 2];
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < P::NH; ++h) {
            const uint64_t dk = smem_desc<PROW>(sk + s * BN * D + h * BN * CW, 16, 8 * PROW);
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) wgmma_ss(sc, dq[h] + 2 * ks, dk + 2 * ks, h * KS + ks);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scale and mask: one FFMA per score, in log2 units
        const float2* madd = reinterpret_cast<const float2*>(smask + s * BN);
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
            const float2 a = madd[4 * n + t];
            sc[4 * n + 0] = fmaf(sc[4 * n + 0], scale_log2, a.x);
            sc[4 * n + 1] = fmaf(sc[4 * n + 1], scale_log2, a.y);
            sc[4 * n + 2] = fmaf(sc[4 * n + 2], scale_log2, a.x);
            sc[4 * n + 3] = fmaf(sc[4 * n + 3], scale_log2, a.y);
        }
        if (causal && k0 + BN - 1 > warp_row0) {
#pragma unroll
            for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int key = k0 + 8 * n + 2 * t + (e & 1);
                    if (key > row_a + 8 * (e >> 1) && key < Lk) sc[4 * n + e] = NEG_INF_LOG2;
                }
            }
        }
        // running max over the row (its 4 lanes share it), rescale
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
            mx[0] = fmaxf(mx[0], fmaxf(sc[4 * n + 0], sc[4 * n + 1]));
            mx[1] = fmaxf(mx[1], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
        }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            alpha[i] = exp2_ftz(m[i] - mx[i]);
            m[i] = mx[i];
            l[i] *= alpha[i];
        }
        // P = 2^(S - m) as bf16 A fragments: accumulator blocks 2 kk and
        // 2 kk + 1 are the A fragment of key step kk
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
            float p[8];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    p[4 * h + e] = exp2_ftz(sc[4 * (2 * kk + h) + e] - m[e >> 1]);
            }
            l[0] += (p[0] + p[1]) + (p[4] + p[5]);
            l[1] += (p[2] + p[3]) + (p[6] + p[7]);
            pa[kk][0] = pack_bf16(p[0], p[1]);
            pa[kk][1] = pack_bf16(p[2], p[3]);
            pa[kk][2] = pack_bf16(p[4], p[5]);
            pa[kk][3] = pack_bf16(p[6], p[7]);
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
            acc[4 * n + 0] *= alpha[0];
            acc[4 * n + 1] *= alpha[0];
            acc[4 * n + 2] *= alpha[1];
            acc[4 * n + 3] *= alpha[1];
        }

        // O += P v. v's tile is [key][d] as stored: MN-major for this
        // product, 8-key groups PROW * 8 bytes apart, a k-step of 16 keys
        // 16 rows further; at D = 128 the second 64 columns are the next
        // part, BN * PROW bytes on (the leading byte offset; with one part
        // it is never read)
        constexpr uint32_t LBO = P::NH > 1 ? BN * PROW : 8 * PROW;
        const uint64_t dv = smem_desc<PROW>(sv + s * BN * D, LBO, 8 * PROW);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(acc, pa[kk], dv + ((16 * PROW) >> 4) * kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
    }

    __nv_bfloat16* ob = o + (size_t)bh * Lq * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
        const int row = row_a + 8 * i;
        if (row < Lq) {
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
                *reinterpret_cast<uint32_t*>(ob + (size_t)row * D + 8 * n + 2 * t) =
                    pack_bf16(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
            }
        }
    }
}

// [B H, L, D] bf16 as a 3-D tensor map with boxes of `rows` rows and one
// part's columns (Split<D>::CW), swizzled by the part's row width; rows past
// L read as zeros
template <int D>
bool make_map(CUtensorMap* map, const void* base, int bh, int L, int rows) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    constexpr int CW = Split<D>::CW;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)bh};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
    const cuuint32_t box[3] = {(cuuint32_t)CW, (cuuint32_t)rows, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUtensorMapSwizzle swizzle = CW == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : CW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                  strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const int32_t* mask,
                        void* o, int B, int H, int Lq, int Lk, float sm_scale, int causal,
                        cudaStream_t stream) {
    CUtensorMap tq, tk, tv;
    if (!make_map<D>(&tq, q, B * H, Lq, BM) || !make_map<D>(&tk, k, B * H, Lk, BN) ||
        !make_map<D>(&tv, v, B * H, Lk, BN)) {
        return cudaErrorInvalidValue;
    }
    constexpr int smem = Smem<D>::ALLOC;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
    }
    const int q_tiles = (Lq + BM - 1) / BM;
    flash_fwd_bf16<D><<<B * H * q_tiles, NWG * 128 + 32, smem, stream>>>(
        tq, tk, tv, mask, static_cast<__nv_bfloat16*>(o), H, Lq, Lk, q_tiles, sm_scale * LOG2E,
        causal);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// flash_attention_f32.cu: the f32 inputs' kernel, built as a source of its
// own so that nvcc compiles the two files at once
int pwt_flash_attention_f32_fwd(const void* q, const void* k, const void* v, const void* kv_mask,
                                void* o, int B, int H, int Lq, int Lk, int D, float sm_scale,
                                int causal, void* stream);

// q: [B, H, Lq, D], k / v: [B, H, Lk, D], all contiguous, f32 or bf16
// (is_bf16; bf16 pointers 16-byte aligned); kv_mask: [B, Lk] int32
// (1 = live key); o: like q. D in {16, 32, 64, 128}.
int pwt_flash_attention_fwd(const void* q, const void* k, const void* v,
                            const void* kv_mask, void* o, int B, int H, int Lq,
                            int Lk, int D, float sm_scale, int causal, int is_bf16,
                            void* stream) {
    if (!is_bf16) {
        return pwt_flash_attention_f32_fwd(q, k, v, kv_mask, o, B, H, Lq, Lk, D, sm_scale,
                                           causal, stream);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* mask = static_cast<const int32_t*>(kv_mask);
    switch (D) {
        case 16: return (int)launch_bf16<16>(q, k, v, mask, o, B, H, Lq, Lk, sm_scale, causal, st);
        case 32: return (int)launch_bf16<32>(q, k, v, mask, o, B, H, Lq, Lk, sm_scale, causal, st);
        case 64: return (int)launch_bf16<64>(q, k, v, mask, o, B, H, Lq, Lk, sm_scale, causal, st);
        case 128: return (int)launch_bf16<128>(q, k, v, mask, o, B, H, Lq, Lk, sm_scale, causal, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
