// Flash attention forward at head dim 256 for f32 inputs: the simple
// design that flash_attention_f32.cu calls for D = 256 (the wrapper pads any
// head dim in 129..256 to it). bf16 inputs at D = 256 take the tensor-core
// kernel, flash_fwd_bf16<256> in flash_attention.cu.
//
// Replaces, at head dims above 128 in f32, the Pallas TPU kernel
// pathway_tpu/ops/kernels/flash_attention.py (`_kernel`): online-softmax
// attention over [B, H, L, D] with f32 running max, normaliser and
// accumulator, a kv padding mask applied as an additive -1e30, an optional
// causal mask (hidden keys set to -1e30), and a zero denominator replaced
// by 1; keys past the end of the sequence take no part, so a row with no
// live key averages v over its keys as the reference does.
//
// What bounds it on this card: f32 products run on the CUDA cores (67
// TFLOP/s, H100 SXM data sheet at 700 W), where the tensor cores would take
// f32 only as TF32, which f32 callers (the tests' 1e-4) do not accept. The
// f32 kernel of flash_attention_f32.cu keeps a row in one thread, which at
// D = 256 would hold 512 floats of q and accumulator a thread. Here one warp
// owns one query row: each lane holds D / 32 = 8 neighbouring columns of q
// and of the accumulator in registers, a score is the lanes' partial dot
// products summed by a butterfly of shuffles (so every lane holds every
// score of the tile), and the exps and the P v update run on the CUDA
// cores. ROWS query rows of one (batch, head) share each 32-key tile of k
// and v, stored in shared memory (64 KB a tile pair), read as 16-byte
// vectors along a row: no bank conflicts. Each warp reads the whole tile
// pair from shared memory for its one row, so shared-memory bandwidth and
// the shuffle chains, not the products, set its time. It serves f32
// callers (tests, f32 configs) only.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;  // JAX NEG_INF
constexpr int BK = 32;             // keys per shared-memory tile
constexpr int ROWS = 16;           // query rows (warps) per block
constexpr int NT = ROWS * 32;      // threads per block
constexpr int PER_LANE = 8;        // columns a lane owns (D / 32 at D = 256)

// 8 neighbouring floats from global or shared memory (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float out[PER_LANE]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float v[PER_LANE]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// grid: (B*H, ceil(Lq / ROWS)); block: NT threads; dynamic shared memory:
// k and v tiles [BK][D] of T, then BK f32 mask addends.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int32_t* __restrict__ kv_mask, T* __restrict__ o, int H, int Lq, int Lk,
               float sm_scale, int causal) {
    static_assert(D == 32 * PER_LANE, "one warp of 32 lanes owns a row of D columns");
    extern __shared__ __align__(16) unsigned char smem[];
    T* Ks = reinterpret_cast<T*>(smem);
    T* Vs = Ks + BK * D;
    float* Ms = reinterpret_cast<float*>(Vs + BK * D);

    const int bh = blockIdx.x;
    const int b = bh / H;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int qi = blockIdx.y * ROWS + warp;
    const bool active = qi < Lq;
    const int col = lane * PER_LANE;

    float qr[PER_LANE];
    float acc[PER_LANE];
    if (active) {
        load8(q + ((size_t)bh * Lq + qi) * D + col, qr);
    } else {
#pragma unroll
        for (int c = 0; c < PER_LANE; ++c) qr[c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < PER_LANE; ++c) acc[c] = 0.f;
    float m = NEG_INF;
    float l = 0.f;

    const T* kb = k + (size_t)bh * Lk * D;
    const T* vb = v + (size_t)bh * Lk * D;
    const int32_t* mb = kv_mask + (size_t)b * Lk;
    // causal: keys after the block's last query row are hidden from every
    // row of the block and add exactly 0 to any row with a live key
    const int kend = causal ? min(Lk, (int)(blockIdx.y + 1) * ROWS) : Lk;
    // 16-byte chunks of one row of k or v
    constexpr int CPR = D * (int)sizeof(T) / 16;

    for (int k0 = 0; k0 < kend; k0 += BK) {
        __syncthreads();  // the previous tile is fully consumed
        for (int e = threadIdx.x; e < BK * CPR; e += NT) {
            const int j = e / CPR;
            const int c = e - j * CPR;
            const int kj = k0 + j;
            uint4 kv = make_uint4(0u, 0u, 0u, 0u);
            uint4 vv = kv;
            if (kj < Lk) {
                kv = reinterpret_cast<const uint4*>(kb + (size_t)kj * D)[c];
                vv = reinterpret_cast<const uint4*>(vb + (size_t)kj * D)[c];
            }
            reinterpret_cast<uint4*>(Ks + j * D)[c] = kv;
            reinterpret_cast<uint4*>(Vs + j * D)[c] = vv;
        }
        if (threadIdx.x < BK) {
            const int kj = k0 + threadIdx.x;
            Ms[threadIdx.x] = kj < Lk ? (1.f - (float)mb[kj]) * NEG_INF : 0.f;
        }
        __syncthreads();
        if (!active) continue;  // warp-uniform; the barriers above stay shared

        // the tile's scores, each summed across the warp: every lane holds all
        float s[BK];
        float m_new = m;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            float kr[PER_LANE];
            load8(Ks + j * D + col, kr);
            float dot = 0.f;
#pragma unroll
            for (int c = 0; c < PER_LANE; ++c) dot = fmaf(qr[c], kr[c], dot);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
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
        for (int c = 0; c < PER_LANE; ++c) acc[c] *= alpha;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            const float p = expf(s[j] - m_new);
            l += p;
            float vr[PER_LANE];
            load8(Vs + j * D + col, vr);
#pragma unroll
            for (int c = 0; c < PER_LANE; ++c) acc[c] = fmaf(p, vr[c], acc[c]);
        }
        m = m_new;
    }

    if (active) {
        const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
        for (int c = 0; c < PER_LANE; ++c) acc[c] *= inv;
        store8(o + ((size_t)bh * Lq + qi) * D + col, acc);
    }
}

cudaError_t launch_rows(const float* q, const float* k, const float* v, const int32_t* mask,
                        float* o, int B, int H, int Lq, int Lk, float sm_scale, int causal,
                        cudaStream_t stream) {
    constexpr int D = 256;
    constexpr int smem = 2 * BK * D * (int)sizeof(float) + BK * (int)sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_rows<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(B * H, (Lq + ROWS - 1) / ROWS);
    flash_fwd_rows<float, D><<<grid, NT, smem, stream>>>(q, k, v, mask, o, H, Lq, Lk, sm_scale,
                                                         causal);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 q: [B, H, Lq, 256], k / v: [B, H, Lk, 256], all contiguous and
// 16-byte aligned; kv_mask: [B, Lk] int32 (1 = live key); o: like q.
int pwt_flash_attention_d256_fwd(const void* q, const void* k, const void* v,
                                 const void* kv_mask, void* o, int B, int H, int Lq, int Lk,
                                 float sm_scale, int causal, void* stream) {
    return (int)launch_rows(static_cast<const float*>(q), static_cast<const float*>(k),
                            static_cast<const float*>(v), static_cast<const int32_t*>(kv_mask),
                            static_cast<float*>(o), B, H, Lq, Lk, sm_scale, causal,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
