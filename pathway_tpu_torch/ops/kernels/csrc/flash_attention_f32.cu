// Flash attention forward for f32 inputs: the simple design beside the
// bf16 tensor-core kernel of flash_attention.cu, which calls it.
//
// Replaces, for f32 inputs, the Pallas TPU kernel
// pathway_tpu/ops/kernels/flash_attention.py (`_kernel`): online-softmax
// attention over [B, H, L, D] with f32 running max, normaliser and
// accumulator, a kv padding mask applied as an additive -1e30, an optional
// causal mask, and a zero denominator replaced by 1. One thread per query
// row on the CUDA cores, with q, the accumulator and the softmax state in
// registers and 32-key tiles of k and v in shared memory read as
// broadcasts. It serves f32 callers (tests, f32 configs), not the bf16
// encoder or decoder, so it is kept simple rather than fast: at D = 128 a
// thread's q row and accumulator (256 floats) do not fit in registers and
// part of them spills. It is a source of its own so that nvcc builds it
// beside flash_attention.cu, not after it.

#include <cuda_runtime.h>
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

template <int D>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const int32_t* mask,
                       float* o, int B, int H, int Lq, int Lk, float sm_scale, int causal,
                       cudaStream_t stream) {
    dim3 grid(B * H, (Lq + BQ - 1) / BQ);
    flash_fwd_f32<D><<<grid, BQ, 0, stream>>>(q, k, v, mask, o, H, Lq, Lk, sm_scale, causal);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// flash_attention_d256.cu: the f32 kernel at D = 256
int pwt_flash_attention_d256_fwd(const void* q, const void* k, const void* v,
                                 const void* kv_mask, void* o, int B, int H, int Lq, int Lk,
                                 float sm_scale, int causal, void* stream);

// f32 q: [B, H, Lq, D], k / v: [B, H, Lk, D], all contiguous; kv_mask:
// [B, Lk] int32 (1 = live key); o: like q. D in {16, 32, 64, 128, 256}.
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
        case 256:
            return pwt_flash_attention_d256_fwd(q, k, v, kv_mask, o, B, H, Lq, Lk, sm_scale,
                                                causal, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
