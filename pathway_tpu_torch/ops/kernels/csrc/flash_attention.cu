// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pathway_tpu/ops/kernels/flash_attention.py
// (`_kernel`, launched by `_flash_fwd`): online-softmax attention over
// [B, H, L, D] with f32 running max, normaliser and accumulator, a kv
// padding mask applied as an additive -1e30, an optional causal mask, and
// a zero denominator replaced by 1. The [L, L] score matrix never reaches
// device memory.
//
// What bounds each bf16 instance on this card (H100 SXM data-sheet peaks
// at 700 W: 3.35 TB/s, 989 TFLOP/s bf16, 16 exps a clock per SM):
//
//   D = 16, 32, 64 (the encoders; [64, 12, 512, 32]): the bytes of q, k,
//     v and o take 0.030 ms, the 4 B H L^2 D products 0.026 ms, the one
//     exp per score (201 M) about 0.052 ms. So the exp unit and the
//     instructions around each score decide, not memory or the tensor
//     cores: the serial schedule below, two blocks an SM.
//   D = 128 (the decoder's prefill; [8, 32, 1024, 128] causal): bytes
//     0.080 ms against products 0.070 ms, so both must run near their
//     rates at once, and the tensor cores must not wait while a warpgroup
//     does its softmax: the ping-pong schedule below, with 128-key tiles
//     (half the barrier waits and row-max shuffles a key of 64-key tiles,
//     and S's A operand, q, read from shared memory once for twice the
//     keys).
//   D = 256 (heads of 129..256, padded; [1, 16, 2048, 256] causal):
//     products 0.035 ms against bytes 0.020 ms, so the tensor cores
//     decide. A 128-row q tile and a 64-key k / v tile pair take 64 KB
//     each, so the ring holds two stages (192 KB in all), and the
//     accumulator alone takes 128 registers a thread: the ping-pong
//     schedule, 64-key tiles.
//
// Common to every bf16 instance (flash_fwd_bf16<D>): a block owns 128
// query rows of one (batch, head): two consumer warpgroups of 64 rows
// (wgmma takes M = 64) and a producer.
//   - Bytes: the producer loads q once and each tile
//     of k and v by TMA into a ring of Sched<D>::STAGES stages, with
//     mbarriers that the consumers wait on ("full") and arrive on when
//     done ("empty"), so copies run ahead of the math. Tensor maps are 3-D
//     [B H, L, D]: rows past L read as zeros, never as the next head's.
//   - Tensor cores: S = q k^T is wgmma m64nBNk16 with both operands in
//     shared memory, K-major as stored ([row][d]); O += P v is wgmma
//     m64nDk16 with P from registers and v's tile as stored ([key][d]),
//     which is MN-major for this product (the transposed-B flag), so v is
//     never transposed by hand. The swizzle is the row
//     width (32, 64 or 128 bytes for D = 16, 32, 64) in both the tensor
//     maps and the wgmma descriptors. At D = 128 and 256 (256- and 512-byte
//     rows) each tile is loaded as NH = 2 or 4 64-column boxes into
//     128-byte swizzled parts (Split): the k-steps of S walk the parts in
//     turn, and P v at N = D reads every part of v through the
//     descriptor's leading byte offset (the parts lie BN * 128 bytes
//     apart).
//   - Exp unit: the softmax runs on the accumulator registers in log2
//     units: scale and mask are one FFMA per score (s * scale * log2(e)
//     plus the stage's mask addend, written to shared memory once per tile
//     by the producer), the row max is shuffled across the 4 lanes of a
//     row, and each score takes one ex2 (exp2f's instruction). P, rounded
//     to bf16, goes from the score registers into the A operand of P v
//     (the accumulator layout of two neighbouring 8-column blocks is the A
//     layout of one 16-key step).
//
// The two schedules:
//   serial (D <= 64): each warpgroup runs S, its softmax, then P v, each
//     waited for before the next, over one full / empty mbarrier pair a
//     stage, and stores its rows from registers. Two blocks share an SM,
//     so one block's products overlap the other's exps.
//   ping-pong (D = 128, 256; one block an SM):
//     - inside a warpgroup, the products run ahead of the softmax: tile
//       j's S and tile j-1's P v start together, and the warpgroup waits
//       for the older group only (S_j) before tile j's softmax, so the
//       exps run while P v does;
//     - between the two warpgroups, two named barriers hand the turn to
//       start products back and forth, so one warpgroup's products run
//       while the other does its softmax;
//     - k and v have mbarriers of their own: a stage's k is released once
//       its scores are masked and v once P v has read it, and the producer
//       loads tile j + 1's k before tile j's v, so S never waits on a v;
//     - under causal masking a warpgroup stops at the tile of its own last
//       row (at D = 256 warpgroup 0 takes one 64-key tile fewer than
//       warpgroup 1 where the block's rows reach that far), and each (batch,
//       head) runs its q tiles last tile first, so the blocks with the most
//       key tiles start early and light ones fill the tail;
//     - the output goes through shared memory (q's region) and leaves by
//       TMA in whole rows, where the serial schedule's 4-byte stores from
//       the accumulator layout would write 16 bytes a row at a time;
//     - the block is three warpgroups, the third the producer's. ptxas
//       sizes a wgmma kernel's registers by whole warpgroups (168 a thread
//       at three), so the producer warpgroup drops to 24 and the consumers
//       rise to 240 (setmaxnreg): 2 x 128 x (240 - 168) = 128 x (168 -
//       24). Its first warp loads; the other three only give registers back.
//
//   flash_fwd_tf32x3<D> (f32 inputs, every head dim, in
//     flash_attention_f32.cu): the tensor cores too, each product in three
//     tf32 passes to f32 accuracy, which bounds it at an effective 165
//     TFLOP/s. tf32 wgmma reads B K-major only, so a producer warpgroup
//     loads each kv tile itself, splits it into hi and lo and writes v
//     transposed; it serves f32 configs (TransformerConfig.dtype =
//     "float32"), the tests, and the f32 gradients' forward.
//
// The sequential kv grid axis of the TPU kernel becomes the loop over kv
// tiles inside a block. Keys past the end of the sequence take no part;
// keys that the kv mask drops get -1e30 added and causally hidden keys are
// set to -1e30 (times log2(e) in the bf16 kernel), so a row with no live
// key stays finite (it averages v over the keys its block reads; never
// read by pooling).

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
constexpr int CONSUMERS = NWG * 128;  // threads of the consumer warpgroups

// The schedule of the instance at head dim D (see the header)
template <int D>
struct Sched {
    static constexpr bool PINGPONG = D >= 128;
    static constexpr int BN = D == 128 ? 128 : 64;   // keys per kv tile
    static constexpr int STAGES = D >= 128 ? 2 : 3;  // kv tiles in the ring
    // the consumer warpgroups, then the producer: one warp (serial), or a
    // whole warpgroup whose registers setmaxnreg can hand on (ping-pong;
    // ptxas sizes a wgmma kernel's registers by whole warpgroups, 168 a
    // thread at three, so a lone producer warp would free too few)
    static constexpr int THREADS = CONSUMERS + (PINGPONG ? 128 : 32);
    static constexpr int PRODUCER_REGS = 24;
    static constexpr int CONSUMER_REGS = 240;  // 2 x 128 x (240 - 168) = 128 x (168 - 24)
};

// Column split of a q / k / v tile. The 128-byte swizzle is the widest, so
// a row wider than 128 bytes (D = 128 or 256) is loaded as NH boxes of CW
// columns, each into a [rows][CW] part of its own: a tile is stored as
// [NH][rows][CW], swizzled by the part's row width CW * 2 bytes. At D <= 64
// NH = 1 and the part is the whole tile.
template <int D>
struct Split {
    static constexpr int CW = D > 64 ? 64 : D;  // columns of one part
    static constexpr int NH = D / CW;            // parts of a row
    static constexpr uint32_t ROW = CW * 2;      // bytes of a row of one part
};

// Shared memory of one block, byte offsets from a 1024-byte aligned base
// (every tile and every part starts on a whole swizzle atom): q (then, in
// the ping-pong schedule, the output's staging), the k and v rings, the
// mask addends of each stage, then the mbarriers:
// full[ST], empty[ST] and q, which the serial schedule uses for whole
// tiles and the ping-pong one for k, then full_v[ST] and empty_v[ST].
// D = 128 takes 32 KB for q and 128 KB for the ring, D = 256 64 KB and
// 128 KB.
template <int D>
struct Smem {
    static constexpr int ST = Sched<D>::STAGES;
    static constexpr int BN = Sched<D>::BN;
    static constexpr int Q = 0;
    static constexpr int K = Q + BM * D * 2;
    static constexpr int V = K + ST * BN * D * 2;
    static constexpr int MASK = V + ST * BN * D * 2;
    static constexpr int BAR = MASK + ST * BN * 4;
    static constexpr int ALLOC = BAR + (4 * ST + 1) * 8 + 1024;  // + alignment slack
    static_assert(ALLOC <= 232448, "over the 227 KB a block may use");
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

// d (+)= A B, m64n128k16: A [64 x 16] and B [16 x 128] both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
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
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64nNk16 for N = 16 .. 256: A [64 x 16] from registers, B [16 x N]
// MN-major in shared memory (v in P v, as stored [key][d])

// m64n16k16
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

// m64n32k16
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

// m64n64k16
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

// m64n128k16 (B as two 64-column swizzle atoms, the leading byte offset apart)
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

// m64n256k16 (B as four 64-column swizzle atoms, the leading byte offset apart)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
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

// What a block works on, shared by its producer and its consumers.
struct Block {
    __nv_bfloat16* sq;
    __nv_bfloat16* sk;
    __nv_bfloat16* sv;
    float* smask;
    uint32_t bar_full, bar_empty, bar_q, bar_full_v, bar_empty_v;
    int bh, q0;
    int n_tiles;  // kv tiles the producer loads
    int active;   // consumer warpgroups with a query row below Lq
};

// Lane (g = lane / 4, t = lane % 4) of warp w of a consumer warpgroup holds
// the accumulator rows 16 w + g and 16 w + g + 8 at columns 8 n + 2 t and
// 8 n + 2 t + 1 (registers 4 n .. 4 n + 3).

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

// The running max over the row (its 4 lanes share it) after this tile,
// the factor alpha that rescales the state kept so far, and l rescaled
template <int BN>
__device__ __forceinline__ void online_max(const float (&sc)[BN / 2], float (&m)[2],
                                           float (&l)[2], float (&alpha)[2]) {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * n + 0], sc[4 * n + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = exp2_ftz(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= alpha[i];
    }
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], const float (&alpha)[2]) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
        acc[4 * n + 0] *= alpha[0];
        acc[4 * n + 1] *= alpha[0];
        acc[4 * n + 2] *= alpha[1];
        acc[4 * n + 3] *= alpha[1];
    }
}

// wgmma descriptors. K-major operands (q, k): 8-row groups ROW * 8 bytes
// apart; a k-step of 16 columns starts 32 bytes further into the swizzled
// rows of its part, and part h of a tile of `rows` rows lies h * rows * CW
// * 2 bytes (16-byte units in a descriptor) after part 0. v's tile is
// [key][d] as stored: MN-major for P v, 8-key groups ROW * 8 bytes apart, a
// k-step of 16 keys 16 rows further; at D = 128 and 256 the next 64
// columns are the next part, BN * ROW bytes on (the leading byte offset;
// with one part it is never read). A stage lies BN * D * 2 bytes after the
// one before.
template <int D>
struct Desc {
    using P = Split<D>;
    static constexpr int BN = Sched<D>::BN;
    static constexpr uint64_t STAGE = (BN * D * 2) >> 4;
    static __device__ __forceinline__ uint64_t kmajor(const __nv_bfloat16* p) {
        return smem_desc<P::ROW>(p, 16, 8 * P::ROW);
    }
    static __device__ __forceinline__ uint64_t v(const __nv_bfloat16* p) {
        return smem_desc<P::ROW>(p, P::NH > 1 ? BN * P::ROW : 8 * P::ROW, 8 * P::ROW);
    }
};

// S = q k^T, [64 x BN] per warpgroup: dq is part 0 of the warpgroup's q
// rows, dk part 0 of the stage's k
template <int D>
__device__ __forceinline__ void start_s(float (&sc)[Sched<D>::BN / 2], uint64_t dq, uint64_t dk) {
    using P = Split<D>;
    constexpr int BN = Sched<D>::BN;
    constexpr int KS = P::CW / 16;  // k-steps in one part
#pragma unroll
    for (int h = 0; h < P::NH; ++h) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
            wgmma_ss(sc, dq + ((h * BM * P::CW * 2) >> 4) + 2 * ks,
                     dk + ((h * BN * P::CW * 2) >> 4) + 2 * ks, h * KS + ks);
    }
}

// O += P v, dv the stage's v
template <int D>
__device__ __forceinline__ void start_pv(float (&acc)[D / 2],
                                        const uint32_t (&pa)[Sched<D>::BN / 16][4], uint64_t dv) {
    constexpr int BN = Sched<D>::BN;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(acc, pa[kk], dv + ((16 * Split<D>::ROW) >> 4) * kk);
}

// The stage's mask addends in log2 units: 0 for a live key, -1e30 log2(e)
// for a masked one, -inf past Lk (no part at all)
template <int BN>
__device__ __forceinline__ void write_mask(float* smask_s, const int32_t* mb, int k0, int Lk,
                                           int lane) {
    for (int c = lane; c < BN; c += 32) {
        const int key = k0 + c;
        smask_s[c] = key < Lk ? (1.f - (float)mb[key]) * NEG_INF_LOG2 : -INFINITY;
    }
}

// The output rows of this lane, divided by their row sums (a zero sum
// becomes 1); rows past Lq are not stored
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], float (&l)[2],
                                           __nv_bfloat16* ob, int row_a, int t, int Lq) {
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

// The same through shared memory: the warpgroup's 64 rows of the q region
// (free once its last S has completed) take
// the rounded rows in the tensor map's swizzled part layout, then one
// thread stores them by TMA, which drops rows past Lq, and waits until the
// store has read them (the block's shared memory must outlive the read)
template <int D>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 2], float (&l)[2], const Block& b,
                                           const CUtensorMap* tm_o, int wg, int warp, int lane) {
    using P = Split<D>;
    const int t = lane & 3;
    const int r0 = (warp & 3) * 16 + (lane >> 2);  // rows r0 and r0 + 8 of the warpgroup's 64
    const uint32_t base = smem_u32(b.sq + wg * WG_ROWS * P::CW);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
        const int r = r0 + 8 * i;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
            const int col = 8 * n + 2 * t;
            const uint32_t off = (col / P::CW) * BM * P::ROW +
                                 swizzle<P::ROW>(r * P::ROW + (col % P::CW) * 2);
            const uint32_t v = pack_bf16(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
            asm volatile("st.shared.b32 [%0], %1;" ::"r"(base + off), "r"(v) : "memory");
        }
    }
    fence_proxy_async();
    named_bar_sync(3 + wg, 128);
    if ((threadIdx.x & 127) == 0) {
#pragma unroll
        for (int h = 0; h < P::NH; ++h)
            tma_store_3d(tm_o, base + h * BM * P::ROW, h * P::CW, b.q0 + wg * WG_ROWS, b.bh);
        tma_store_commit();
        tma_store_wait_read();
    }
}

// ---- the serial schedule (D <= 64) ----

// producer: q once, then per kv tile its k and v (TMA) and its mask
// addends, up to STAGES tiles ahead of the consumers
template <int D>
__device__ __forceinline__ void produce_serial(const Block& b, const CUtensorMap* tm_q,
                                               const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                               const int32_t* mb, int Lk, int lane) {
    using P = Split<D>;
    constexpr int ST = Sched<D>::STAGES;
    constexpr int BN = Sched<D>::BN;
    if (lane == 0) {
        mbar_arrive_expect_tx(b.bar_q, BM * D * 2);
#pragma unroll
        for (int h = 0; h < P::NH; ++h)
            tma_load_3d(smem_u32(b.sq + h * BM * P::CW), tm_q, b.bar_q, h * P::CW, b.q0, b.bh);
    }
    for (int j = 0; j < b.n_tiles; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(b.bar_empty + 8 * s, (j / ST - 1) & 1);
        const int k0 = j * BN;
        write_mask<BN>(b.smask + s * BN, mb, k0, Lk, lane);
        if (lane == 0) {
            mbar_arrive_expect_tx(b.bar_full + 8 * s, 2 * BN * D * 2);
#pragma unroll
            for (int h = 0; h < P::NH; ++h) {
                const int part = s * BN * D + h * BN * P::CW;
                tma_load_3d(smem_u32(b.sk + part), tm_k, b.bar_full + 8 * s, h * P::CW, k0, b.bh);
                tma_load_3d(smem_u32(b.sv + part), tm_v, b.bar_full + 8 * s, h * P::CW, k0, b.bh);
            }
        } else {
            mbar_arrive(b.bar_full + 8 * s);
        }
    }
}

// consumer warpgroup: S, its softmax, then P v, each waited for
template <int D>
__device__ __forceinline__ void consume_serial(const Block& b, __nv_bfloat16* o, int Lq, int Lk,
                                               float scale_log2, int causal, int warp, int lane) {
    constexpr int ST = Sched<D>::STAGES;
    constexpr int BN = Sched<D>::BN;
    constexpr uint64_t STAGE = Desc<D>::STAGE;
    const int wg = warp >> 2;
    const int t = lane & 3;
    const int warp_row0 = b.q0 + wg * WG_ROWS + (warp & 3) * 16;
    const int row_a = warp_row0 + (lane >> 2);  // and row_a + 8
    const uint64_t dq = Desc<D>::kmajor(b.sq + wg * WG_ROWS * Split<D>::CW);
    const uint64_t dk = Desc<D>::kmajor(b.sk);
    const uint64_t dv = Desc<D>::v(b.sv);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // finite after the first tile
    float l[2] = {0.f, 0.f};              // this lane's partial row sums
    mbar_wait(b.bar_q, 0);

    for (int j = 0; j < b.n_tiles; ++j) {
        const int s = j % ST;
        const int k0 = j * BN;
        mbar_wait(b.bar_full + 8 * s, (j / ST) & 1);

        float sc[BN / 2];
        wgmma_fence();
        start_s<D>(sc, dq, dk + s * STAGE);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        scale_and_mask<BN>(sc, b.smask + s * BN, scale_log2, causal, k0, warp_row0, row_a, t, Lk);
        float alpha[2];
        online_max<BN>(sc, m, l, alpha);
        // P = 2^(S - m) as bf16 A fragments: accumulator blocks 2 kk and
        // 2 kk + 1 are the A fragment of key step kk
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
            float p[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) p[e] = exp2_ftz(sc[8 * kk + e] - m[(e >> 1) & 1]);
            l[0] += (p[0] + p[1]) + (p[4] + p[5]);
            l[1] += (p[2] + p[3]) + (p[6] + p[7]);
            pa[kk][0] = pack_bf16(p[0], p[1]);
            pa[kk][1] = pack_bf16(p[2], p[3]);
            pa[kk][2] = pack_bf16(p[4], p[5]);
            pa[kk][3] = pack_bf16(p[6], p[7]);
        }
        rescale<D>(acc, alpha);

        fence_regs(acc);
        wgmma_fence();
        start_pv<D>(acc, pa, dv + s * STAGE);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(b.bar_empty + 8 * s);  // this warp is done with stage s
    }
    store_rows<D>(acc, l, o + (size_t)b.bh * Lq * D, row_a, t, Lq);
}

// ---- the ping-pong schedule (D = 128, 256) ----

// producer: q once, then tile 0's k, then for each tile j the k of tile
// j + 1 (with its mask addends) before the v of tile j, each into its
// stage once the consumers have released it
template <int D>
__device__ __forceinline__ void produce_split(const Block& b, const CUtensorMap* tm_q,
                                              const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                              const int32_t* mb, int Lk, int lane) {
    using P = Split<D>;
    constexpr int ST = Sched<D>::STAGES;
    constexpr int BN = Sched<D>::BN;
    if (lane == 0) {
        mbar_arrive_expect_tx(b.bar_q, BM * D * 2);
#pragma unroll
        for (int h = 0; h < P::NH; ++h)
            tma_load_3d(smem_u32(b.sq + h * BM * P::CW), tm_q, b.bar_q, h * P::CW, b.q0, b.bh);
    }
    auto load_k = [&](int j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(b.bar_empty + 8 * s, (j / ST - 1) & 1);
        write_mask<BN>(b.smask + s * BN, mb, j * BN, Lk, lane);
        if (lane == 0) {
            mbar_arrive_expect_tx(b.bar_full + 8 * s, BN * D * 2);
#pragma unroll
            for (int h = 0; h < P::NH; ++h)
                tma_load_3d(smem_u32(b.sk + s * BN * D + h * BN * P::CW), tm_k, b.bar_full + 8 * s,
                            h * P::CW, j * BN, b.bh);
        } else {
            mbar_arrive(b.bar_full + 8 * s);
        }
    };
    auto load_v = [&](int j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(b.bar_empty_v + 8 * s, (j / ST - 1) & 1);
        if (lane == 0) {
            mbar_arrive_expect_tx(b.bar_full_v + 8 * s, BN * D * 2);
#pragma unroll
            for (int h = 0; h < P::NH; ++h)
                tma_load_3d(smem_u32(b.sv + s * BN * D + h * BN * P::CW), tm_v,
                            b.bar_full_v + 8 * s, h * P::CW, j * BN, b.bh);
        }
    };
    load_k(0);
    for (int j = 0; j < b.n_tiles; ++j) {
        if (j + 1 < b.n_tiles) load_k(j + 1);
        load_v(j);
    }
}

// consumer warpgroup wg (0 or 1). Turn j (0 <= j <= n_tiles) starts tile
// j's S and tile j - 1's P v at once; then tile j's softmax runs while P v
// does. Every warpgroup takes n_tiles + 1 turns, in strict alternation
// over the named barriers 1 (warpgroup 0's) and 2 (warpgroup 1's):
// warpgroup 1 opens warpgroup 0's first turn and does not arrive after its
// last, so each barrier sees as many arrivals as waits. The first turn
// (S only), the middle ones and the last (P v only) are written out apart,
// so that no wgmma, fence or wait sits under a condition of its own (ptxas
// serializes the products otherwise); a turn past the warpgroup's own
// tiles only passes the turn on.
template <int D>
__device__ __forceinline__ void consume_pingpong(const Block& b, const CUtensorMap* tm_o, int Lk,
                                                 float scale_log2, int causal, int warp,
                                                 int lane) {
    static_assert(NWG == 2, "the turns alternate between two warpgroups");
    constexpr int ST = Sched<D>::STAGES;
    constexpr int BN = Sched<D>::BN;
    constexpr uint64_t STAGE = Desc<D>::STAGE;
    const int wg = warp >> 2;
    const int t = lane & 3;
    const int warp_row0 = b.q0 + wg * WG_ROWS + (warp & 3) * 16;
    const int row_a = warp_row0 + (lane >> 2);  // and row_a + 8
    // this warpgroup's tiles: under causal masking the keys after its last
    // row add exactly 0 to any of its rows with a live key, so warpgroup 0
    // stops a tile before warpgroup 1 where the block's rows reach past
    // that tile; the block's last tile is never refilled, so no load waits
    // on the empty arrivals that warpgroup 0 leaves out. None for a
    // warpgroup whose rows all lie past Lq.
    const int kend = causal ? min(Lk, b.q0 + (wg + 1) * WG_ROWS) : Lk;
    const int n = wg < b.active ? (kend + BN - 1) / BN : 0;
    const uint64_t dq = Desc<D>::kmajor(b.sq + wg * WG_ROWS * Split<D>::CW);
    const uint64_t dk = Desc<D>::kmajor(b.sk);
    const uint64_t dv = Desc<D>::v(b.sv);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // finite after the first tile
    float l[2] = {0.f, 0.f};              // this lane's partial row sums
    float alpha[2];
    float sc[BN / 2];
    uint32_t pa[BN / 16][4];  // P of the tile before, the A operand of P v

    auto turn_sync = [&]() { named_bar_sync(1 + wg, CONSUMERS); };
    auto turn_pass = [&](int j) {
        if (wg == 0 || j < b.n_tiles) named_bar_arrive(2 - wg, CONSUMERS);
    };
    // tile j's scores, once S has landed: masked, k's stage released, the
    // running max and l updated, then 2^(S - m) in place
    auto softmax = [&](int j) {
        const int s = j % ST;
        fence_regs(sc);
        scale_and_mask<BN>(sc, b.smask + s * BN, scale_log2, causal, j * BN, warp_row0, row_a, t, Lk);
        if (lane == 0) mbar_arrive(b.bar_empty + 8 * s);  // this warp is done with k of stage s
        online_max<BN>(sc, m, l, alpha);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
            sc[i] = exp2_ftz(sc[i] - m[(i >> 1) & 1]);
            l[(i >> 1) & 1] += sc[i];
        }
    };
    // P as bf16 A fragments: accumulator blocks 2 kk and 2 kk + 1 are the
    // A fragment of key step kk
    auto pack_p = [&]() {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
            for (int r = 0; r < 4; ++r)
                pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        }
    };
    // once tile j's P v has completed: its registers pinned, v's stage released
    auto pv_done = [&](int j) {
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) fence_regs(pa[kk]);
        if (lane == 0) mbar_arrive(b.bar_empty_v + 8 * (j % ST));
    };

    if (wg == 1) named_bar_arrive(1, CONSUMERS);
    int j = 0;
    if (n > 0) {
        mbar_wait(b.bar_q, 0);
        mbar_wait(b.bar_full, 0);
        turn_sync();
        wgmma_fence();
        start_s<D>(sc, dq, dk);
        wgmma_commit();
        turn_pass(0);
        wgmma_wait_all();
        softmax(0);
        pack_p();
        for (j = 1; j < n; ++j) {
            const int s = j % ST;
            const int sp = (j - 1) % ST;
            mbar_wait(b.bar_full + 8 * s, (j / ST) & 1);
            mbar_wait(b.bar_full_v + 8 * sp, ((j - 1) / ST) & 1);
            turn_sync();
            wgmma_fence();
            start_s<D>(sc, dq, dk + s * STAGE);
            wgmma_commit();
            start_pv<D>(acc, pa, dv + sp * STAGE);
            wgmma_commit();
            turn_pass(j);
            wgmma_wait<1>();  // S of tile j; P v of tile j - 1 runs on
            softmax(j);
            wgmma_wait_all();
            pv_done(j - 1);
            rescale<D>(acc, alpha);
            pack_p();
        }
        mbar_wait(b.bar_full_v + 8 * ((n - 1) % ST), ((n - 1) / ST) & 1);
        turn_sync();
        wgmma_fence();
        start_pv<D>(acc, pa, dv + ((n - 1) % ST) * STAGE);
        wgmma_commit();
        turn_pass(n);
        wgmma_wait_all();
        pv_done(n - 1);
        j = n + 1;
    }
    for (; j <= b.n_tiles; ++j) {
        turn_sync();
        turn_pass(j);
    }
    if (wg < b.active) store_tile<D>(acc, l, b, tm_o, wg, warp, lane);
}

// grid: B * H * q_tiles blocks, the q tiles of one (batch, head) as
// neighbouring blocks so that its k and v stay in L2; block: NWG consumer
// warpgroups, then the producer. Rows past Lq read as zeros and are never
// stored. The serial schedule's two blocks share an SM (at most 113
// registers a thread); the ping-pong schedule takes a whole SM.
template <int D>
__global__ void __launch_bounds__(Sched<D>::THREADS, D > 64 ? 1 : 2)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
               const int32_t* __restrict__ kv_mask, __nv_bfloat16* __restrict__ o, int H,
               int Lq, int Lk, int q_tiles, float scale_log2, int causal) {
    using S = Smem<D>;
    constexpr int ST = Sched<D>::STAGES;
    constexpr int BN = Sched<D>::BN;
    constexpr bool PINGPONG = Sched<D>::PINGPONG;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    Block b;
    b.sq = reinterpret_cast<__nv_bfloat16*>(smem + S::Q);
    b.sk = reinterpret_cast<__nv_bfloat16*>(smem + S::K);
    b.sv = reinterpret_cast<__nv_bfloat16*>(smem + S::V);
    b.smask = reinterpret_cast<float*>(smem + S::MASK);
    b.bar_full = smem_u32(smem + S::BAR);
    b.bar_empty = b.bar_full + 8 * ST;
    b.bar_q = b.bar_empty + 8 * ST;
    b.bar_full_v = b.bar_q + 8;
    b.bar_empty_v = b.bar_full_v + 8 * ST;

    b.bh = blockIdx.x / q_tiles;
    int qt = blockIdx.x - b.bh * q_tiles;
    if (PINGPONG) qt = q_tiles - 1 - qt;  // the most key tiles first
    b.q0 = qt * BM;
    b.active = PINGPONG ? min(NWG, (Lq - b.q0 + WG_ROWS - 1) / WG_ROWS) : NWG;
    // causal: keys after the last query row of the last working warpgroup
    // are masked for every row of the block, and add exactly 0 to any row
    // with a live key
    const int kend = causal ? min(Lk, b.q0 + b.active * WG_ROWS) : Lk;
    b.n_tiles = (kend + BN - 1) / BN;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        for (int s = 0; s < ST; ++s) {
            mbar_init(b.bar_full + 8 * s, 32);               // every producer lane
            mbar_init(b.bar_empty + 8 * s, b.active * 4);    // every working consumer warp
            mbar_init(b.bar_full_v + 8 * s, 1);              // the producer's lane 0
            mbar_init(b.bar_empty_v + 8 * s, b.active * 4);
        }
        mbar_init(b.bar_q, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp >= NWG * 4) {
        const int32_t* mb = kv_mask + (size_t)(b.bh / H) * Lk;
        if constexpr (PINGPONG) {
            // the producer warpgroup's first warp loads; the other three
            // only give their registers back
            setmaxnreg_dec<Sched<D>::PRODUCER_REGS>();
            if (warp == NWG * 4) produce_split<D>(b, &tm_q, &tm_k, &tm_v, mb, Lk, lane);
        } else {
            produce_serial<D>(b, &tm_q, &tm_k, &tm_v, mb, Lk, lane);
        }
    } else {
        if constexpr (PINGPONG) {
            setmaxnreg_inc<Sched<D>::CONSUMER_REGS>();
            consume_pingpong<D>(b, &tm_o, Lk, scale_log2, causal, warp, lane);
        } else {
            consume_serial<D>(b, o, Lq, Lk, scale_log2, causal, warp, lane);
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
    constexpr int BN = Sched<D>::BN;
    CUtensorMap tq, tk, tv, to;
    if (!make_map<D>(&tq, q, B * H, Lq, BM) || !make_map<D>(&tk, k, B * H, Lk, BN) ||
        !make_map<D>(&tv, v, B * H, Lk, BN) || !make_map<D>(&to, o, B * H, Lq, WG_ROWS)) {
        return cudaErrorInvalidValue;
    }
    constexpr int smem = Smem<D>::ALLOC;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
    }
    const int q_tiles = (Lq + BM - 1) / BM;
    flash_fwd_bf16<D><<<B * H * q_tiles, Sched<D>::THREADS, smem, stream>>>(
        tq, tk, tv, to, mask, static_cast<__nv_bfloat16*>(o), H,
        Lq, Lk, q_tiles, sm_scale * LOG2E, causal);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// flash_attention_f32.cu: the f32 inputs' kernel, built as a source of its
// own so that nvcc compiles the files at once
int pwt_flash_attention_f32_fwd(const void* q, const void* k, const void* v, const void* kv_mask,
                                void* o, int B, int H, int Lq, int Lk, int D, float sm_scale,
                                int causal, void* stream);

// q: [B, H, Lq, D], k / v: [B, H, Lk, D], all contiguous, f32 or bf16
// (is_bf16; bf16 pointers 16-byte aligned); kv_mask: [B, Lk] int32
// (1 = live key); o: like q. D in {16, 32, 64, 128, 256}.
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
        case 256: return (int)launch_bf16<256>(q, k, v, mask, o, B, H, Lq, Lk, sm_scale, causal, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
