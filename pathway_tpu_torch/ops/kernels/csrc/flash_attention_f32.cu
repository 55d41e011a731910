// Flash attention forward for f32 inputs on Hopper's tensor cores (sm_90a),
// to f32 accuracy: every product runs in three tf32 passes ("3xTF32").
//
// Replaces, for f32 inputs at every head dim (16, 32, 64, 128, 256; the
// wrapper pads the others), the Pallas TPU kernel
// pathway_tpu/ops/kernels/flash_attention.py (`_kernel`): online-softmax
// attention over [B, H, L, D] with f32 running max, normaliser and
// accumulator, a kv padding mask applied as an additive -1e30, an optional
// causal mask, and a zero denominator replaced by 1. It replaces the
// port's earlier CUDA-core designs too (one thread a query row, one warp a
// row at D = 256), which gave each FMA a shared-memory operand.
//
// What bounds it on this card (H100 SXM data sheet at 700 W: 495 TFLOP/s
// tf32, 3.35 TB/s, 16 exps a clock per SM): tf32 keeps 10 mantissa bits,
// so each f32 operand x is split as x_hi = x rounded to tf32 by cvt.rna's
// rule and x_lo = x - x_hi, and a product a b is a_hi b_hi + a_lo b_hi +
// a_hi b_lo (the dropped a_lo b_lo is ~2^-22 of it), as in knn_topk.cu:
// three passes, an effective 165 TFLOP/s. At the encoder's [64, 12, 512,
// 32] that is 0.156 ms of products against 0.052 ms of exps and 0.015 ms
// of bytes; at [1, 16, 2048, 256] causal 0.208 ms. So the tensor cores
// bound it, and the design keeps the split off their path:
//
//   - A block owns NWG x 64 query rows of one (batch, head): NWG consumer
//     warpgroups (wgmma takes M = 64) and one producer warpgroup.
//   - tf32 wgmma reads B from shared memory K-major only (the transpose
//     flags exist for 16-bit types), and for P v the keys are K while v is
//     stored [key][d]. So the producer warpgroup loads each kv tile from
//     device memory itself (the next tile's loads in flight while it waits
//     for the consumers), splits it, and writes four planes into a ring of
//     stages: k_hi and k_lo as stored ([key][d]) and v^T_hi and v^T_lo
//     ([d][key]), in 32-column parts of 128-byte rows with the 128-byte
//     swizzle, the layout the wgmma descriptors read. Its stores reach
//     wgmma through fence.proxy.async and the stage's "full" mbarriers;
//     the consumers release k and v of a stage on "empty" mbarriers of
//     their own, so a stage's k is refilled while its v is still read.
//   - The split is three instructions an element: x_hi as two integer
//     operations on x's bits (cvt.rna.tf32.f32 compiles to four or five,
//     testing for inf and NaN), and x_lo = x - x_hi as it stands, its 13
//     low bits ignored by the tensor cores.
//   - S = q k^T: A = q from registers, its hi and lo fragments split once
//     a block at D <= 32; above, raw q stays in shared memory (rows padded
//     by 4 floats, so the fragment reads hit 32 banks) and is split two
//     k-steps at a time, the next group's fragments read while this group's
//     products run. A k-step is q_hi k_hi, q_lo k_hi and q_hi k_lo, or, at
//     32-key tiles, where m64n32k8 products on one accumulator wait on each
//     other, q_hi [k_hi | k_lo] as one m64n64k8 (k_hi and k_lo rows side by
//     side in each part) beside q_lo k_hi.
//   - The softmax runs on the accumulator registers in log2 units, as the
//     bf16 kernel's: one FFMA per score for scale and mask, one ex2 per
//     score, the row max shuffled across the 4 lanes of a row.
//   - O += P v: A = P from registers, split into hi and lo. The accumulator
//     gives a lane keys 2t and 2t + 1 of each 8-key group, where the tf32
//     A fragment wants keys t and t + 4; P v sums over the keys, so instead
//     of moving P across lanes the producer stores each 8-key group of v^T
//     in the order 0 2 4 6 1 3 5 7, and a lane's accumulator registers are
//     its A fragment as they stand. Three wgmma m64nDk8 a k-step.
//   - Each warpgroup runs S, its softmax, then P v, each waited for; the
//     other warpgroup's products and the producer's work overlap them.
//     (Starting a tile's S beside the last tile's P v gained nothing at D =
//     32 and lost at 128, where the registers it holds serialize the
//     products.) D = 256 takes one consumer warpgroup a block: raw q (65
//     KB) and one 32-key stage of k and of v^T with their lo planes (128
//     KB) fill the 227 KB, so the producer refills k while P v runs and v
//     while S does.
//
// The sequential kv grid axis of the TPU kernel becomes the loop over kv
// tiles inside a block; under causal masking a block stops at the tile of
// its last query row, and each (batch, head) runs its q tiles last first.
// Keys past the end of the sequence take no part (zeros in the planes and a
// -inf addend); keys that the kv mask drops get -1e30 log2(e) added and
// causally hidden keys are set to it, so a row with no live key stays
// finite (it averages v over the keys its block reads).

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;  // JAX NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF_LOG2 = NEG_INF * LOG2E;  // a masked score in log2 units
constexpr int WG_ROWS = 64;                      // query rows per consumer warpgroup
constexpr int ROW = 128;                         // bytes of a plane row: 32 f32, one swizzle atom

// The instance at head dim D
template <int D>
struct Cfg {
    static constexpr int NWG = D == 256 ? 1 : 2;        // consumer warpgroups
    static constexpr int BM = NWG * WG_ROWS;            // query rows per block
    static constexpr int THREADS = (NWG + 1) * 128;     // and the producer warpgroup
    static constexpr int BN = D >= 128 ? 32 : 64;       // keys per kv tile
    static constexpr int ST = D == 256 ? 1 : (D >= 64 ? 2 : 3);  // stages of the ring
    static constexpr bool Q_REGS = D <= 32;    // q's hi / lo fragments kept in registers
    static constexpr int KS = D / 8;           // k-steps of S
    static constexpr int KC = 2;               // k-steps a wgmma group when q is re-read
    static constexpr int QS = D + 4;           // floats a row of raw q in shared memory
    // at BN = 32, S's k_hi and k_lo rows lie one after the other in each
    // part, so that q_hi [k_hi | k_lo] is one m64n64k8 a k-step beside
    // q_lo k_hi, in place of three m64n32k8 on one accumulator
    static constexpr bool S_DOUBLE = BN == 32;
    // with three warpgroups ptxas sizes the kernel at 168 registers a
    // thread; the producer, which holds a kv tile, drops to 136 and the
    // consumers rise to 184: 2 x 128 x (184 - 168) = 128 x (168 - 136).
    // With two, every thread may hold 255.
    static constexpr bool SPLIT_REGS = NWG == 2;
};

constexpr int PRODUCER_REGS = 136;
constexpr int CONSUMER_REGS = 184;

// Shared memory of one block, byte offsets from a 1024-byte aligned base:
// per stage the k_hi and k_lo planes ([part][key][32 d], 128-byte rows,
// swizzled; at S_DOUBLE [part][hi keys, lo keys][32 d]), then per stage
// the v^T_hi and v^T_lo planes ([part][d][32 keys]), raw q ([NWG][64][QS]),
// the mask addends ([ST][BN]) and the mbarriers full_k, empty_k, full_v,
// empty_v ([ST] each).
template <int D>
struct Smem {
    using C = Cfg<D>;
    static constexpr int NPK = (D + 31) / 32;  // parts of a k row (D = 16 fills half of one)
    static constexpr int NPV = C::BN / 32;     // parts of a v^T row
    static constexpr int KPLANE = NPK * C::BN * ROW;
    // k_hi row r of part p at p * KPART + r * ROW, its k_lo row KLO further
    static constexpr int KPART = (C::S_DOUBLE ? 2 : 1) * C::BN * ROW;
    static constexpr int KLO = C::S_DOUBLE ? C::BN * ROW : KPLANE;
    static constexpr int VPLANE = NPV * D * ROW;
    static constexpr int K = 0;
    static constexpr int V = K + C::ST * 2 * KPLANE;
    static constexpr int Q = V + C::ST * 2 * VPLANE;
    static constexpr int MASK = Q + C::NWG * WG_ROWS * C::QS * 4;
    static constexpr int BAR = MASK + C::ST * C::BN * 4;
    static constexpr int ALLOC = BAR + 4 * C::ST * 8 + 1024;  // + alignment slack
    static_assert(ALLOC <= 232448, "over the 227 KB a block may use");
};

template <int ST>
__device__ __forceinline__ uint32_t bar_at(uint32_t bars, int which, int s) {
    return bars + 8 * (which * ST + s);  // which: 0 full_k, 1 empty_k, 2 full_v, 3 empty_v
}

// 2^x as one ex2 on the special-function unit, results below 2^-126 flushed
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// x = hi + lo for the three tf32 passes: hi is x rounded to tf32 by
// cvt.rna's rule (10 mantissa bits, ties away from zero), as two integer
// operations on the bits of a finite x (cvt.rna.tf32.f32 compiles to
// four or five, checking for inf and NaN); lo = x - hi exactly, whose low
// 13 bits the tensor cores ignore (so lo reaches them truncated to tf32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
}

__device__ __forceinline__ float4 load4(const float* p, bool ok) {
    return ok ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// byte offset of the 16-byte chunk `chunk` (0..7) of row `r` in a part of
// 128-byte rows with the 128-byte swizzle (chunk c of row r at c ^ (r % 8))
__device__ __forceinline__ uint32_t swz(int r, int chunk) {
    return r * ROW + ((chunk ^ (r & 7)) << 4);
}

// ---- the producer warpgroup ----

// One kv tile as the producer holds it between its loads and its
// stores. k: float4 e of the tile is row e / (D / 4), columns 4 (e % (D /
// 4)) ..; eight neighbouring threads read a row's 128 bytes and write the
// 8 chunks of one swizzled row. v: an item is the 4 columns 4 d4 .. of the
// keys 8 kk + e + {0, 2, 4, 6}, the (kk, e) pairs of one d4 on
// neighbouring threads.
template <int D>
struct KvTile {
    static constexpr int BN = Cfg<D>::BN;
    static constexpr int C4 = D / 4;
    static constexpr int KPER = BN * C4 / 128;  // float4s of k a thread
    static constexpr int PE = BN / 4;           // (kk, e) pairs of a tile
    static constexpr int ITEMS = C4 * PE;
    static constexpr int VPER = (ITEMS + 127) / 128;  // items of v a thread
    static_assert(KPER * 128 == BN * C4, "whole float4s a thread");
    float4 k[KPER];
    float4 v[VPER][4];
    float madd;  // this thread's key's mask addend (threads below BN)

    // tile k0's k (zeros past Lk) and the mask addend in log2 units: 0
    // live, -1e30 log2(e) masked, -inf past Lk
    __device__ __forceinline__ void load_k(const float* kb, const int32_t* mb, int k0, int Lk,
                                           int tid) {
#pragma unroll
        for (int i = 0; i < KPER; ++i) {
            const int e = tid + 128 * i;
            const int r = e / C4;
            k[i] = load4(kb + (size_t)(k0 + r) * D + 4 * (e % C4), k0 + r < Lk);
        }
        const int key = k0 + tid;
        madd = key < Lk ? (tid < BN ? (1.f - (float)__ldg(mb + key)) * NEG_INF_LOG2 : 0.f)
                        : -INFINITY;
    }

    __device__ __forceinline__ void load_v(const float* vb, int k0, int Lk, int tid) {
#pragma unroll
        for (int i = 0; i < VPER; ++i) {
            const int it = tid + 128 * i;
            const int pe = it % PE;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int key = k0 + 8 * (pe >> 1) + (pe & 1) + 2 * u;
                v[i][u] = load4(vb + (size_t)key * D + 4 * (it / PE), it < ITEMS && key < Lk);
            }
        }
    }

    // k, split, into the stage's k_hi and k_lo planes
    __device__ __forceinline__ void store_k(uint8_t* planes, int tid) const {
#pragma unroll
        for (int i = 0; i < KPER; ++i) {
            const int e = tid + 128 * i;
            const int r = e / C4;
            const int c4 = e % C4;
            const uint32_t off = (c4 / 8) * Smem<D>::KPART + swz(r, c4 % 8);
            uint4 hi, lo;
            split4(k[i], hi, lo);
            *reinterpret_cast<uint4*>(planes + off) = hi;
            *reinterpret_cast<uint4*>(planes + Smem<D>::KLO + off) = lo;
        }
    }

    // v, transposed in registers and split, into the stage's v^T_hi and
    // v^T_lo planes: each column d of an item becomes the 4 keys at
    // positions 8 kk + 4 e .. of row d, so an 8-key group holds its keys in
    // the order 0 2 4 6 1 3 5 7 (the P fragment's order, see the header)
    __device__ __forceinline__ void store_v(uint8_t* planes, int tid) const {
#pragma unroll
        for (int i = 0; i < VPER; ++i) {
            const int it = tid + 128 * i;
            if (it >= ITEMS) continue;
            const int pe = it % PE;
            const int d4 = it / PE;
            const int kk = pe >> 1;
            const int chunk = 2 * (kk & 3) + (pe & 1);  // 16-byte chunk within the 32-key part
            const uint32_t part = (kk >> 2) * (D * ROW);
            const float4 cols[4] = {
                make_float4(v[i][0].x, v[i][1].x, v[i][2].x, v[i][3].x),
                make_float4(v[i][0].y, v[i][1].y, v[i][2].y, v[i][3].y),
                make_float4(v[i][0].z, v[i][1].z, v[i][2].z, v[i][3].z),
                make_float4(v[i][0].w, v[i][1].w, v[i][2].w, v[i][3].w),
            };
#pragma unroll
            for (int dd = 0; dd < 4; ++dd) {
                const uint32_t off = part + swz(4 * d4 + dd, chunk);
                uint4 hi, lo;
                split4(cols[dd], hi, lo);
                *reinterpret_cast<uint4*>(planes + off) = hi;
                *reinterpret_cast<uint4*>(planes + Smem<D>::VPLANE + off) = lo;
            }
        }
    }
};

// every kv tile of the block into the ring: a tile's k (with its mask
// addends), then its v, each once the consumers have released the
// stage's k or v. The next tile's loads are issued as soon as this tile's
// registers are stored, so they land while the producer waits for the
// consumers.
template <int D>
__device__ void produce(uint8_t* smem, const float* kb, const float* vb, const int32_t* mb,
                        int Lk, int n_tiles, int tid) {
    using C = Cfg<D>;
    using S = Smem<D>;
    constexpr int ST = C::ST;
    constexpr int BN = C::BN;
    const uint32_t bars = smem_u32(smem + S::BAR);
    float* smask = reinterpret_cast<float*>(smem + S::MASK);
    KvTile<D> x;
    if (n_tiles > 0) {
        x.load_k(kb, mb, 0, Lk, tid);
        x.load_v(vb, 0, Lk, tid);
    }
    for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        const uint32_t parity = ((j / ST) - 1) & 1;  // of the release that frees stage s
        if (j >= ST) mbar_wait(bar_at<ST>(bars, 1, s), parity);
        x.store_k(smem + S::K + s * 2 * S::KPLANE, tid);
        if (tid < BN) smask[s * BN + tid] = x.madd;
        fence_proxy_async();
        mbar_arrive(bar_at<ST>(bars, 0, s));
        if (j >= ST) mbar_wait(bar_at<ST>(bars, 3, s), parity);
        x.store_v(smem + S::V + s * 2 * S::VPLANE, tid);
        fence_proxy_async();
        mbar_arrive(bar_at<ST>(bars, 2, s));
        if (j + 1 < n_tiles) {
            x.load_k(kb, mb, (j + 1) * BN, Lk, tid);
            x.load_v(vb, (j + 1) * BN, Lk, tid);
        }
    }
}

// ---- the consumer warpgroups ----

// Lane (g = lane / 4, t = lane % 4) of warp w of a consumer warpgroup holds
// the accumulator rows 16 w + g and 16 w + g + 8 at columns 8 n + 2 t and
// 8 n + 2 t + 1 (registers 4 n .. 4 n + 3), and the A fragment of a k-step
// (8 columns): (16 w + g, t), (16 w + g + 8, t), (16 w + g, t + 4),
// (16 w + g + 8, t + 4).

// the hi and lo A fragments of q for k-step ks of the warpgroup's
// columns, from raw q in shared memory (rows of QS floats)
template <int D>
__device__ __forceinline__ void q_frag(const float* sq, int ra, int t, int ks, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
    constexpr int QS = Cfg<D>::QS;
    const int c = 8 * ks + t;
    const float x[4] = {sq[ra * QS + c], sq[(ra + 8) * QS + c], sq[ra * QS + c + 4],
                        sq[(ra + 8) * QS + c + 4]};
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// wgmma descriptor of a plane part's 128-byte swizzled rows: 8-row groups
// 1024 bytes apart; a k-step of 8 f32 starts 32 bytes further
__device__ __forceinline__ uint64_t plane_desc(const uint8_t* p) {
    return smem_desc<ROW>(p, 16, 8 * ROW);
}

// the three passes of k-step ks of S = q k^T (the first k-step
// overwrites): into sc alone, or at S_DOUBLE q_hi [k_hi | k_lo] into sd
// (its first BN / 2 registers the k_hi columns, the rest the k_lo ones)
// and q_lo k_hi into sc; kp the stage's k planes
template <int D>
__device__ __forceinline__ void s_step(float (&sc)[Cfg<D>::BN / 2],
                                       float (&sd)[Cfg<D>::S_DOUBLE ? Cfg<D>::BN : 1],
                                       const uint32_t (&hi)[4], const uint32_t (&lo)[4],
                                       const uint8_t* kp, int ks) {
    using S = Smem<D>;
    const uint64_t dh = plane_desc(kp + (ks / 4) * S::KPART + (ks % 4) * 32);
    if constexpr (Cfg<D>::S_DOUBLE) {
        wgmma_tf32(sd, hi, dh, ks == 0 ? 0 : 1);
        wgmma_tf32(sc, lo, dh, ks == 0 ? 0 : 1);
    } else {
        const uint64_t dl = plane_desc(kp + S::KLO + (ks / 4) * S::KPART + (ks % 4) * 32);
        wgmma_tf32(sc, hi, dh, ks == 0 ? 0 : 1);
        wgmma_tf32(sc, lo, dh, 1);
        wgmma_tf32(sc, hi, dl, 1);
    }
}

// A tile's scores in log2 units: one FFMA per score (s * scale * log2(e)
// plus the stage's mask addend), then causally hidden keys set to -1e30
// log2(e); keys past Lk keep their -inf addend
template <int BN>
__device__ __forceinline__ void scale_and_mask(float (&sc)[BN / 2], const float* smask_s,
                                               float scale_log2, int causal, int k0,
                                               int warp_row0, int row_a, int t, int Lk) {
    const float2* madd = reinterpret_cast<const float2*>(smask_s);
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
}

// one consumer warpgroup: its 64 rows' q into shared memory, then per kv
// tile S, its softmax and P v, each waited for; then its rows, divided by
// their row sums (a zero sum becomes 1), stored from registers
template <int D>
__device__ void consume(uint8_t* smem, const float* qb, float* ob, int q0, int Lq, int Lk,
                        int n_tiles, float scale_log2, int causal, int wg, int warp, int lane) {
    using C = Cfg<D>;
    using S = Smem<D>;
    constexpr int ST = C::ST;
    constexpr int BN = C::BN;
    constexpr int KS = C::KS;
    const uint32_t bars = smem_u32(smem + S::BAR);
    const float* smask = reinterpret_cast<const float*>(smem + S::MASK);
    const int g = lane >> 2;
    const int t = lane & 3;
    const int ra = (warp & 3) * 16 + g;  // rows ra and ra + 8 of the warpgroup's 64
    const int wrow0 = q0 + wg * WG_ROWS;
    const int warp_row0 = wrow0 + (warp & 3) * 16;
    const int row_a = wrow0 + ra;

    float* sq = reinterpret_cast<float*>(smem + S::Q) + wg * WG_ROWS * C::QS;
    for (int e = threadIdx.x & 127; e < WG_ROWS * D / 4; e += 128) {
        const int r = e / (D / 4);
        const int c = 4 * (e % (D / 4));
        *reinterpret_cast<float4*>(sq + r * C::QS + c) =
            load4(qb + (size_t)(wrow0 + r) * D + c, wrow0 + r < Lq);
    }
    named_bar_sync(1 + wg, 128);
    // at D <= 32 the whole of q's fragments, split once (D registers)
    uint32_t qh[C::Q_REGS ? KS : 1][4], ql[C::Q_REGS ? KS : 1][4];
    if constexpr (C::Q_REGS) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) q_frag<D>(sq, ra, t, ks, qh[ks], ql[ks]);
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // finite after the first tile
    float l[2] = {0.f, 0.f};              // this lane's partial row sums

    for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        const uint32_t parity = (j / ST) & 1;

        // S = q k^T into sc (and sd at S_DOUBLE); when q is re-read, the
        // next group's fragments are read and split while this group runs,
        // before waiting for the group before it (at most two groups in
        // flight, three groups' fragments held)
        const uint8_t* kp = smem + S::K + s * 2 * S::KPLANE;
        float sc[BN / 2];
        float sd[C::S_DOUBLE ? BN : 1];
        mbar_wait(bar_at<ST>(bars, 0, s), parity);
        if constexpr (C::Q_REGS) {
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) s_step<D>(sc, sd, qh[ks], ql[ks], kp, ks);
            wgmma_commit();
        } else {
            constexpr int NC = KS / C::KC;
            uint32_t fh[3][C::KC][4], fl[3][C::KC][4];
#pragma unroll
            for (int i = 0; i < C::KC; ++i) q_frag<D>(sq, ra, t, i, fh[0][i], fl[0][i]);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                wgmma_fence();
#pragma unroll
                for (int i = 0; i < C::KC; ++i)
                    s_step<D>(sc, sd, fh[c % 3][i], fl[c % 3][i], kp, c * C::KC + i);
                wgmma_commit();
                if (c + 1 < NC) {
#pragma unroll
                    for (int i = 0; i < C::KC; ++i)
                        q_frag<D>(sq, ra, t, (c + 1) * C::KC + i, fh[(c + 1) % 3][i],
                                  fl[(c + 1) % 3][i]);
                    wgmma_wait<1>();
                }
            }
        }
        wgmma_wait_all();
        fence_regs(sc);
        if constexpr (C::S_DOUBLE) {
            fence_regs(sd);
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) sc[i] += sd[i] + sd[i + BN / 2];
        }

        // the softmax: masked, k's stage released, the running max, alpha
        // and l updated, then P = 2^(S - m)
        scale_and_mask<BN>(sc, smask + s * BN, scale_log2, causal, j * BN, warp_row0, row_a, t, Lk);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_at<ST>(bars, 1, s));  // this warp is done with k
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
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
            sc[i] = exp2_ftz(sc[i] - m[(i >> 1) & 1]);
            l[(i >> 1) & 1] += sc[i];
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
            acc[4 * n + 0] *= alpha[0];
            acc[4 * n + 1] *= alpha[0];
            acc[4 * n + 2] *= alpha[1];
            acc[4 * n + 3] *= alpha[1];
        }
        // P split into the A fragments of P v: key-step kk's fragment is
        // (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1) of the 8-key
        // group kk, which v^T holds in the order 0 2 4 6 1 3 5 7
        uint32_t ph[BN / 8][4], pl[BN / 8][4];
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) {
            split_tf32(sc[4 * kk + 0], ph[kk][0], pl[kk][0]);
            split_tf32(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
            split_tf32(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
            split_tf32(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
        }

        // O += P v, three passes a key-step
        const uint8_t* vh = smem + S::V + s * 2 * S::VPLANE;
        mbar_wait(bar_at<ST>(bars, 2, s), parity);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) {
            const uint32_t off = (kk / 4) * (D * ROW) + (kk % 4) * 32;
            const uint64_t dh = plane_desc(vh + off);
            const uint64_t dl = plane_desc(vh + S::VPLANE + off);
            wgmma_tf32(acc, ph[kk], dh, 1);
            wgmma_tf32(acc, pl[kk], dh, 1);
            wgmma_tf32(acc, ph[kk], dl, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_at<ST>(bars, 3, s));  // and with v
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
        const int row = row_a + 8 * i;
        if (row < Lq) {
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
                *reinterpret_cast<float2*>(ob + (size_t)row * D + 8 * n + 2 * t) =
                    make_float2(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
            }
        }
    }
}

// grid: B * H * q_tiles blocks, the q tiles of one (batch, head) as
// neighbouring blocks so that its k and v stay in L2; block: NWG consumer
// warpgroups, then the producer warpgroup. Rows past Lq read as zeros and
// are never stored. One block an SM.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int32_t* __restrict__ kv_mask,
                 float* __restrict__ o, int H, int Lq, int Lk, int q_tiles, float scale_log2,
                 int causal) {
    using C = Cfg<D>;
    using S = Smem<D>;
    constexpr int ST = C::ST;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    const int bh = blockIdx.x / q_tiles;
    int qt = blockIdx.x - bh * q_tiles;
    if (causal) qt = q_tiles - 1 - qt;  // the most key tiles first
    const int q0 = qt * C::BM;
    // causal: keys after the block's last query row are masked for every
    // row of the block, and add exactly 0 to any row with a live key
    const int kend = causal ? min(Lk, q0 + min(C::BM, Lq - q0)) : Lk;
    const int n_tiles = (kend + C::BN - 1) / C::BN;
    const uint32_t bars = smem_u32(smem + S::BAR);
    if (threadIdx.x == 0) {
        for (int s = 0; s < ST; ++s) {
            mbar_init(bar_at<ST>(bars, 0, s), 128);         // every producer thread
            mbar_init(bar_at<ST>(bars, 1, s), C::NWG * 4);  // every consumer warp
            mbar_init(bar_at<ST>(bars, 2, s), 128);
            mbar_init(bar_at<ST>(bars, 3, s), C::NWG * 4);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const size_t kv_off = (size_t)bh * Lk * D;
    if (warp >= C::NWG * 4) {
        if constexpr (C::SPLIT_REGS) setmaxnreg_dec<PRODUCER_REGS>();
        produce<D>(smem, k + kv_off, v + kv_off, kv_mask + (size_t)(bh / H) * Lk, Lk, n_tiles,
                   threadIdx.x - C::NWG * 128);
    } else {
        if constexpr (C::SPLIT_REGS) setmaxnreg_inc<CONSUMER_REGS>();
        const size_t q_off = (size_t)bh * Lq * D;
        consume<D>(smem, q + q_off, o + q_off, q0, Lq, Lk, n_tiles, scale_log2, causal,
                   warp >> 2, warp, threadIdx.x & 31);
    }
}

template <int D>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const int32_t* mask,
                       float* o, int B, int H, int Lq, int Lk, float sm_scale, int causal,
                       cudaStream_t stream) {
    constexpr int smem = Smem<D>::ALLOC;
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tf32x3<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int q_tiles = (Lq + Cfg<D>::BM - 1) / Cfg<D>::BM;
    flash_fwd_tf32x3<D><<<B * H * q_tiles, Cfg<D>::THREADS, smem, stream>>>(
        q, k, v, mask, o, H, Lq, Lk, q_tiles, sm_scale * LOG2E, causal);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 q: [B, H, Lq, D], k / v: [B, H, Lk, D], all contiguous and 16-byte
// aligned; kv_mask: [B, Lk] int32 (1 = live key); o: like q. D in {16, 32,
// 64, 128, 256}.
int pwt_flash_attention_f32_fwd(const void* q, const void* k, const void* v, const void* kv_mask,
                                void* o, int B, int H, int Lq, int Lk, int D, float sm_scale,
                                int causal, void* stream) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const int32_t* mask = static_cast<const int32_t*>(kv_mask);
    float* of = static_cast<float*>(o);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return (int)launch_f32<16>(qf, kf, vf, mask, of, B, H, Lq, Lk, sm_scale, causal, st);
        case 32: return (int)launch_f32<32>(qf, kf, vf, mask, of, B, H, Lq, Lk, sm_scale, causal, st);
        case 64: return (int)launch_f32<64>(qf, kf, vf, mask, of, B, H, Lq, Lk, sm_scale, causal, st);
        case 128: return (int)launch_f32<128>(qf, kf, vf, mask, of, B, H, Lq, Lk, sm_scale, causal, st);
        case 256: return (int)launch_f32<256>(qf, kf, vf, mask, of, B, H, Lq, Lk, sm_scale, causal, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
