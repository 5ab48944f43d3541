// The bf16 attention forward on Hopper's warpgroup MMA (wgmma) fed by the
// Tensor Memory Accelerator (TMA), for sm_90a: one device routine that K1
// (csrc/attention_fwd.cu) and K2 (csrc/attention_hg_fwd.cu) each wrap in a
// kernel of their own, the "mma" variant of both for head_dim 16, 32, 64
// and 128. It replaces the forward Pallas kernels of
// clip_event_tpu/ops/attention_pallas.py (`_fwd_kernel` and
// `_hg_fwd_kernel`) in bf16; the contract is theirs:
//
//   qkv  [B, S, 3W]  bf16, contiguous, 16-byte aligned; q lanes [0, W),
//                    k [W, 2W), v [2W, 3W), head h at [h*D, (h+1)*D)
//   bias [S, S]      fp32 additive mask (may hold -inf), or null
//   out  [B, S, W]   softmax(q . k^T * scale + bias) . v per head, bf16
//   lse  [B, H, S]   fp32 or null: m * ln 2 + log l of each row
//
// What bounds it. At the path shapes (D = 64; S = 50, 77 through K1, 197
// and 257 through K2) the work is 4*B*H*S^2*D flops against B*S*4W bf16
// elements moved, under the card's 295 flops a byte: the memory rate
// bounds it (0.0402 ms at ViT-L/14's B = 64, 0.1085 ms at the B/32 train
// step's text call). Behind the bytes come the exponentials (16 a clock on
// an SM) and the tensor cores, each near the bytes' time at S = 257 once
// the 64-row padding is counted; what the design must avoid is latency:
//
//   * A unit of work is one (batch item, head). Its K and V rows pass
//     through a ring of 64-row chunk slots in shared memory: K and V of a
//     chunk come by two TMA loads from a 3-D tensor map over qkv seen as
//     [B, S, 3W] (boxes of D lanes x 64 rows x 1 item), so rows past S
//     within an item arrive as zeros (never the next item's rows, never
//     stale: 0 x NaN would poison the products). Where a head's chunks fit
//     the ring (`resident`: S <= 64 * slots, every path shape) each chunk
//     is loaded once and every 64-row query tile of the head walks all of
//     them, so qkv is read once; a longer head is walked once a pass of
//     kConsumers tiles (`streaming`), the chunks released as they are used.
//   * Persistent blocks, one an SM, each walk the units b * H + h =
//     blockIdx.x, + gridDim.x, ... in that fixed order. A producer
//     warpgroup gives its registers to the consumers (setmaxnreg); of it,
//     one thread keeps the K / V ring full (the next heads' chunks load
//     while this one computes), another each consumer warpgroup's two Q
//     buffers. Each unit's arithmetic is the same whichever block takes
//     it: the result does not depend on the grid.
//   * kConsumers warpgroups of 128 threads (three at D <= 64, two at
//     D = 128) own 64 query rows each; the tiles of a resident head are
//     dealt round them, rotated by the unit, so the ragged last tile (1
//     row at S = 257, 13 at S = 77) costs one warpgroup's math, not a
//     block's K / V load. Three warpgroups at 160 registers (the most an
//     SM quadrant's 16,384 give three consumer warps beside a producer
//     warp of 24) keep the tensor cores and the exponential units busy
//     where two at 240 could not.
//   * S = Q . K^T is wgmma.mma_async m64n64k16 bf16 -> fp32 with Q and K
//     read K-major from shared memory through descriptors in the swizzle
//     the TMA wrote (128-byte rows at D >= 64; 64 and 32 at D = 32, 16; a
//     D = 128 row is two 128-byte atoms). Scale * log2 e, the fp32 bias and
//     -inf past S act on the accumulator registers; the online softmax
//     reduces each row over the 4 threads that hold it and exponentiates
//     on the special-function unit; a row that has seen only -inf keeps
//     m = -inf and takes its exponent against 0, so -inf - (-inf) never
//     forms. 8-key groups wholly past S skip the exponentials.
//   * P is rounded to bf16 in registers, where the accumulator layout is
//     the A operand's, and O += P . V is wgmma m64nDk16 with P from
//     registers and V read MN-major from shared memory (the transpose bit).
//     The row sum l adds the unrounded fp32 p (the contract of
//     `mma_rounding=True`).
//   * In a warpgroup the scores of chunk j and O += P_{j-1} . V_{j-1} are
//     issued together, and chunk j's softmax runs while the second product
//     finishes. Every product is one shape (a whole 64-key chunk, all four
//     16-key steps of P . V): ptxas serializes wgmma, each waiting for the
//     last, when products of several widths share an accumulator or sit
//     in code the compiler cannot prove uniform (hence the warp index by
//     shuffle, and no per-warp skip of rows past S). A head of two
//     chunks (S = 65..128, K1's S = 77) at D <= 64 takes its rows' max
//     over chunk 1 first, so that P rounds against its row's max over
//     every key as the rounding plain version's one pass rounds it
//     (holding both chunks' scores spilled at the 128 registers a thread
//     of 512 has). The softmax's arithmetic (exp2f, the sums' order, the
//     rescale) is the mma.sync kernels' before it: with the tensor cores
//     summing as they did, the outputs are their bits (`chip_smoke.py
//     --old-csrc` reads the difference), which the bf16 train steps' 1e-3
//     gates against the rounding plain step sit close to.
//   * O / l, rounded to bf16, is written into the tile's own (spent) Q
//     buffer in the TMA's swizzle and stored by one TMA store a 64-lane
//     box, which drops rows past S; lse = m * ln 2 + log l straight from
//     the registers.
//
// Barriers: every load completes on an mbarrier (full), every buffer is
// handed back on another (empty). Phases are tracked by counting: the
// n-th fill of a slot completes phase n, whose parity a waiter passes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace wg {

// shared with the mma.sync kernels
using mma::kLn2;
using mma::kLog2e;
using mma::kMaxDevices;
using mma::pack_bf16;
using mma::quad_max;
using mma::quad_sum;
using mma::smem_u32;

constexpr int kRows = 64;             // rows of a tile: a TMA box, wgmma's M, a key chunk
constexpr int kQStages = 2;           // Q buffers a consumer warpgroup
constexpr int kMaxSlots = 32;         // K / V chunk slots at most
constexpr int kBarrierBytes = 1024;   // the mbarriers' region, first in shared memory
// Q buffers, the staged bias and the K / V ring: the 227 KB a block may
// have, less the barriers and 1 KB to align the tiles to the 128-byte
// swizzle's 1024-byte period
constexpr int kTilesBudget = 232448 - 2 * 1024;
constexpr int kBiasStageMax = 65536;  // a bias of at most this many bytes (S <= 128) is staged
constexpr long long kWaitTrapCycles = 1ll << 32;  // a lost barrier traps (~2 s) instead of hanging

// Sizes at head_dim D. A tile is 64 rows of D bf16 in kAtoms swizzle atoms
// of 64 rows x kRowBytes (the TMA box and the wgmma descriptor's layout).
// Three consumer warpgroups at D <= 64; two at D = 128, whose output
// accumulators take twice the registers.
template <int D>
struct Geo {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "the wgmma forward takes head_dim 16, 32, 64, 128");
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kAtoms = D * 2 / kRowBytes;
  static constexpr int kBoxLanes = kRowBytes / 2;
  static constexpr int kAtomBytes = kRows * kRowBytes;
  static constexpr int kTileBytes = kAtoms * kAtomBytes;
  static constexpr int kConsumers = D <= 64 ? 3 : 2;  // warpgroups
  static constexpr int kThreads = 128 * kConsumers + 128;  // + the producer warpgroup
  // registers a consumer thread takes from the producer's (setmaxnreg): an
  // SM quadrant's 16,384 hold kConsumers warps of these and one of 24
  static constexpr int kConsumerRegs = kConsumers >= 3 ? 160 : 240;
  static constexpr int kQBytes = kConsumers * kQStages * kTileBytes;
  static constexpr int kSmemBytes = 1024 + kBarrierBytes + kTilesBudget;
  // the descriptor's layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kSwizzleMask = kRowBytes / 16 - 1;  // 16-byte chunks a row, less one
  static_assert(8 * (2 * kMaxSlots + 2 * kConsumers * kQStages) <= kBarrierBytes, "the barriers fit");
};

// The kernel's one parameter, passed by value (__grid_constant__), so that a
// CUDA-graph capture records the tensor maps with the launch.
struct FwdParams {
  CUtensorMap qkv;     // [B, S, 3W] bf16 in boxes of kBoxLanes x 64 rows x 1 item
  CUtensorMap out;     // [B, S, W] bf16, the same boxes
  const float* bias;   // [S, S] fp32 or null
  float* lse;          // [B, H, S] fp32 or null
  int S, H, units;     // units = B * H
  int slots;           // K / V chunk slots of the ring
  int bias_bytes;      // shared memory of the staged bias; 0: read from global memory
  float scale_log2e;
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitTrapCycles) __trap();
  }
}

// One box of a 3-D tensor map into shared memory; `bar` counts its bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box from shared memory into a 3-D tensor map; elements past the
// tensor's bounds are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// until the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
// until the committed stores are done
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// generic-proxy writes to shared memory, ordered before the async proxy's
// (TMA) accesses
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier over one warpgroup's 128 threads (ids 1.. : 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// 2^x on the special-function unit (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// until at most N of the committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), layout type (the swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// d[64 x 64] (+)= a[64 x 16] . b[64 x 16]^T: A and B K-major bf16 in shared memory
// (descriptors), fp32 accumulators; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 16] += a[64 x 16] . b[16 x 16]: A bf16 in registers (the accumulator
// fragment layout), B MN-major bf16 in shared memory (transposed read)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 32] += a[64 x 16] . b[16 x 32]: A bf16 in registers (the accumulator
// fragment layout), B MN-major bf16 in shared memory (transposed read)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 64] += a[64 x 16] . b[16 x 64]: A bf16 in registers (the accumulator
// fragment layout), B MN-major bf16 in shared memory (transposed read)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] += a[64 x 16] . b[16 x 128]: A bf16 in registers (the accumulator
// fragment layout), B MN-major bf16 in shared memory (transposed read)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n16(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n32(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n64(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n128(d, a, b);
}

// K-major operand (Q as A, a K chunk as B) of a tile at `tile`: 8-row
// groups kRowBytes x 8 apart (the stride byte offset), the leading offset
// unused. k-step kk (16 wide) is kmajor_step(kk) further (16-byte units,
// added to the descriptor's address field): 32 bytes a step within an
// atom's rows, then the next atom.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile) {
  using G = Geo<D>;
  return make_desc(tile, 16, 8 * G::kRowBytes, G::kLayout);
}
template <int D>
__host__ __device__ constexpr uint64_t kmajor_step(int kk) {
  return ((kk / (Geo<D>::kRowBytes / 32)) * Geo<D>::kAtomBytes + (kk % (Geo<D>::kRowBytes / 32)) * 32) >> 4;
}

// MN-major operand (a V chunk as B of P . V): 8-row groups kRowBytes x 8
// apart (stride byte offset), the D lanes' atoms kAtomBytes apart (leading
// byte offset); k-step kk (16 keys) is 16 rows down, mnmajor_step(kk).
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile) {
  using G = Geo<D>;
  return make_desc(tile, G::kAtomBytes, 8 * G::kRowBytes, G::kLayout);
}
template <int D>
__host__ __device__ constexpr uint64_t mnmajor_step(int kk) {
  return (kk * 16 * Geo<D>::kRowBytes) >> 4;
}

// Byte offset of (row, 16-byte chunk c of the row) in a tile, as the TMA's
// swizzle lays it: the chunk index XOR the row's place in the pattern.
template <int D>
__device__ __forceinline__ uint32_t swizzled(int row, int c) {
  using G = Geo<D>;
  constexpr int kChunks = G::kRowBytes / 16;
  const int atom = c / kChunks, cc = c % kChunks;
  const int x = ((row * G::kRowBytes) >> 7) & G::kSwizzleMask;
  return atom * G::kAtomBytes + row * G::kRowBytes + ((cc ^ x) << 4);
}

// The shared memory of a block, from a 1024-byte aligned base: the
// barriers, Q buffers [kConsumers][kQStages], the staged bias (bias_bytes,
// a multiple of 1 KB), the K / V ring [slots][K, V].
template <int D>
struct Smem {
  using G = Geo<D>;
  uint32_t base;
  int bias_bytes;
  __device__ __forceinline__ uint32_t kv_full(int slot) const { return base + 8 * slot; }
  __device__ __forceinline__ uint32_t kv_empty(int slot) const { return base + 8 * (kMaxSlots + slot); }
  __device__ __forceinline__ uint32_t q_full(int w, int buf) const {
    return base + 8 * (2 * kMaxSlots + w * kQStages + buf);
  }
  __device__ __forceinline__ uint32_t q_empty(int w, int buf) const {
    return base + 8 * (2 * kMaxSlots + (G::kConsumers + w) * kQStages + buf);
  }
  __device__ __forceinline__ uint32_t q(int w, int buf) const {
    return base + kBarrierBytes + (w * kQStages + buf) * G::kTileBytes;
  }
  __device__ __forceinline__ uint32_t bias() const { return base + kBarrierBytes + G::kQBytes; }
  __device__ __forceinline__ uint32_t k(int slot) const {
    return bias() + bias_bytes + slot * 2 * G::kTileBytes;
  }
  __device__ __forceinline__ uint32_t v(int slot) const { return k(slot) + G::kTileBytes; }
};

// How a head is walked: nq query tiles and nk key chunks of 64 rows; a
// resident head (nk <= slots) in one pass whose tiles are dealt round the
// warpgroups, rotated by the unit; a longer one in ceil(nq / kConsumers)
// passes of one tile a warpgroup, its chunks loaded again each pass.
template <int D>
struct Walk {
  using G = Geo<D>;
  int nq, nk, passes;
  bool resident;
  __device__ __forceinline__ Walk(int S, int slots) {
    nq = nk = (S + kRows - 1) / kRows;
    resident = nk <= slots;
    passes = resident ? 1 : (nq + G::kConsumers - 1) / G::kConsumers;
  }
  // The tiles of `pass` of the block's i-th unit that warpgroup w takes:
  // first, first + step, ... below end (none where first >= end).
  __device__ __forceinline__ void tiles(int i, int pass, int w, int& first, int& end, int& step) const {
    if (resident) {
      first = ((w - i) % G::kConsumers + G::kConsumers) % G::kConsumers;
      end = nq;
      step = G::kConsumers;
    } else {
      first = pass * G::kConsumers + w;
      end = first + 1 < nq ? first + 1 : nq;
      step = 1;
    }
  }
  // the warpgroup that takes tile t (in order of the pass's tiles)
  __device__ __forceinline__ int owner(int i, int t) const {
    return resident ? (i + t) % G::kConsumers : t % G::kConsumers;
  }
};

// S = Q . K^T of a tile and a 64-key chunk into s (issued and committed,
// not waited for). Keys past S are zero rows of K (the TMA's bounds):
// their scores are masked after, and a chunk's width is one shape, so
// ptxas keeps the products in flight (products of several widths on one
// accumulator made it serialize them)
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t qtile, uint32_t ktile) {
  const uint64_t dq = kmajor_desc<D>(qtile), dk = kmajor_desc<D>(ktile);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(s, dq + kmajor_step<D>(kk), dk + kmajor_step<D>(kk), kk > 0);
  wgmma_commit();
}

// Chunk j's scores in place in units of log2: s * scale_log2e + bias * log2
// e, -inf for keys past S (valid: the chunk's keys below S); m: each row's
// max over this thread's 16 values. kFull: every key of the chunk lies
// below S. brow0, brow1: the bias rows of rows r[0], r[1] at the chunk's
// first key, or null.
template <bool kFull>
__device__ __forceinline__ void to_log2(float (&s)[32], float (&m)[2], const float* brow0, const float* brow1, int t4,
                                        int valid, float scale_log2e) {
  float mx[2][4];  // four partial maxima a row, then a tree
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jj + 2 * t4 + e;
        float v = s[4 * jj + 2 * hh + e] * scale_log2e;
        if (brow0 != nullptr && (kFull || c < valid)) v = fmaf((hh ? brow1 : brow0)[c], kLog2e, v);
        if (!kFull && c >= valid) v = -INFINITY;
        s[4 * jj + 2 * hh + e] = v;
      }
      const float pair = fmaxf(s[4 * jj + 2 * hh], s[4 * jj + 2 * hh + 1]);
      mx[hh][jj & 3] = jj < 4 ? pair : fmaxf(mx[hh][jj & 3], pair);
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) m[hh] = fmaxf(fmaxf(mx[hh][0], mx[hh][1]), fmaxf(mx[hh][2], mx[hh][3]));
}

// The online softmax of one chunk's scores, in place: s becomes p =
// 2^(s * scale_log2e + bias * log2 e - m) with m the rows' running max,
// and keys past S (valid: the chunk's keys below S) get -inf, then p = 0;
// returns each row's correction factor for O and l in corr. kFull: every
// key of the chunk lies below S. brow0, brow1: the bias rows of rows r[0],
// r[1] at the chunk's first key, or null. A row's max is taken in
// partials; p and corr are exp2f's, and the chunk's p add up in key order,
// one 8-key group after another: from l * corr where `carry` (the sum of
// a one-pass softmax over every key, continued), else from 0, then
// l = fma(l, corr, that sum) (the online walk's). These are the arithmetic of
// the mma.sync kernels before, one pass in K1 and a walk of 64-key tiles
// in K2, whose bits these kernels give.
template <bool kFull>
__device__ __forceinline__ void softmax_chunk(float (&s)[32], float (&m_run)[2], float (&l_run)[2], float (&corr)[2],
                                              const float* brow0, const float* brow1, int t4, int valid,
                                              float scale_log2e, bool carry) {
  float m_thread[2];
  to_log2<kFull>(s, m_thread, brow0, brow1, t4, valid, scale_log2e);
  float m_safe[2], sum[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float m_new = fmaxf(m_run[hh], quad_max(m_thread[hh]));
    m_safe[hh] = m_new == -INFINITY ? 0.f : m_new;
    corr[hh] = exp2f(m_run[hh] - m_safe[hh]);  // 0 while m_run is -inf, 1 while the max holds
    m_run[hh] = m_new;
    sum[hh] = carry ? l_run[hh] * corr[hh] : 0.f;
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    if (kFull || 8 * jj < valid) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float p0 = exp2f(s[4 * jj + 2 * hh] - m_safe[hh]);
        const float p1 = exp2f(s[4 * jj + 2 * hh + 1] - m_safe[hh]);
        s[4 * jj + 2 * hh] = p0;
        s[4 * jj + 2 * hh + 1] = p1;
        sum[hh] += p0 + p1;
      }
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) s[4 * jj + x] = 0.f;
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l_run[hh] = carry ? sum[hh] : fmaf(l_run[hh], corr[hh], sum[hh]);
}

// softmax_chunk of chunk j (valid: its keys below S)
__device__ __forceinline__ void softmax_of(float (&s)[32], float (&m_run)[2], float (&l_run)[2], float (&corr)[2],
                                           const float* brow0, const float* brow1, int t4, int j, int S,
                                           float scale_log2e, bool carry) {
  const int valid = S - j * kRows;
  const float* b0 = brow0 == nullptr ? nullptr : brow0 + j * kRows;
  const float* b1 = brow1 == nullptr ? nullptr : brow1 + j * kRows;
  if (valid >= kRows) {
    softmax_chunk<true>(s, m_run, l_run, corr, b0, b1, t4, valid, scale_log2e, carry);
  } else {
    softmax_chunk<false>(s, m_run, l_run, corr, b0, b1, t4, valid, scale_log2e, carry);
  }
}

// m_run takes the rows' max over chunk j's scores (s, spent)
__device__ __forceinline__ void chunk_max(float (&s)[32], float (&m_run)[2], const float* brow0, const float* brow1,
                                          int t4, int j, int S, float scale_log2e) {
  const int valid = S - j * kRows;
  const float* b0 = brow0 == nullptr ? nullptr : brow0 + j * kRows;
  const float* b1 = brow1 == nullptr ? nullptr : brow1 + j * kRows;
  float m[2];
  if (valid >= kRows)
    to_log2<true>(s, m, b0, b1, t4, valid, scale_log2e);
  else
    to_log2<false>(s, m, b0, b1, t4, valid, scale_log2e);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) m_run[hh] = fmaxf(m_run[hh], quad_max(m[hh]));
}

// O += P . V of a 64-key chunk (issued and committed, not waited for): P
// in bf16 registers, 16 keys a k-step. Every step runs, those wholly past
// S too (P is 0 there and V's rows are zeros), for the reason of
// issue_scores
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], uint32_t (&pa)[4][4], uint32_t vtile) {
  const uint64_t dv = mnmajor_desc<D>(vtile);
  fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, pa[kk], dv + mnmajor_step<D>(kk));
  wgmma_commit();
}

// O and l take chunk j's correction; P_j to bf16 for the next O += P . V
template <int D>
__device__ __forceinline__ void rescale_pack(float (&o)[D / 2], uint32_t (&pa)[4][4], const float (&s)[32],
                                             const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[4 * n] *= corr[0];
    o[4 * n + 1] *= corr[0];
    o[4 * n + 2] *= corr[1];
    o[4 * n + 3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

// The routine: one block, persistent, of kConsumers warpgroups and a
// producer warpgroup (see the top of this file).
template <int D, bool HAS_BIAS>
__device__ __forceinline__ void attend_fwd(const FwdParams& p) {
  using G = Geo<D>;
  constexpr int C = G::kConsumers;
  extern __shared__ __align__(16) uint8_t wg_smem[];
  uint8_t* base = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  const Smem<D> sm{smem_u32(base), p.bias_bytes};
  const int S = p.S, H = p.H, W = H * D;
  const Walk<D> walk(S, p.slots);
  // the warp's index, known to the compiler to be the same across the warp
  // (a branch on it does not diverge, so no wgmma is serialized behind one)
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0), lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.slots; ++s) {
      mbar_init(sm.kv_full(s), 1);       // the producer's expect_tx
      mbar_init(sm.kv_empty(s), 4 * C);  // lane 0 of every consumer warp
    }
    for (int w = 0; w < C; ++w)
      for (int b = 0; b < kQStages; ++b) {
        mbar_init(sm.q_full(w, b), 1);
        mbar_init(sm.q_empty(w, b), 1);  // the warpgroup's first thread
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // a bias of S <= 128 is read from shared memory, copied once a block
  float* bias_sm = reinterpret_cast<float*>(base + (sm.bias() - sm.base));
  if (HAS_BIAS && p.bias_bytes > 0)
    for (int x = threadIdx.x; x < S * S; x += blockDim.x) bias_sm[x] = p.bias[x];
  __syncthreads();

  if (warp >= 4 * C) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (lane == 0 && warp == 4 * C) {
      // ---- producer: the K / V ring, chunk after chunk, head after head
      int pos = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const int b = u / H, h = u - b * H;
        for (int pass = 0; pass < walk.passes; ++pass)
          for (int j = 0; j < walk.nk; ++j, ++pos) {
            const int slot = pos % p.slots, n = pos / p.slots;
            if (n > 0) mbar_wait(sm.kv_empty(slot), (n - 1) & 1);
            mbar_expect_tx(sm.kv_full(slot), 2 * G::kTileBytes);
#pragma unroll
            for (int a = 0; a < G::kAtoms; ++a) {
              tma_load_3d(sm.k(slot) + a * G::kAtomBytes, &p.qkv, sm.kv_full(slot), W + h * D + a * G::kBoxLanes,
                          j * kRows, b);
              tma_load_3d(sm.v(slot) + a * G::kAtomBytes, &p.qkv, sm.kv_full(slot),
                          2 * W + h * D + a * G::kBoxLanes, j * kRows, b);
            }
          }
      }
    } else if (lane == 0 && warp == 4 * C + 1) {
      // ---- producer: each consumer warpgroup's Q buffers, in the order
      // of the tiles
      int taken[C];
#pragma unroll
      for (int w = 0; w < C; ++w) taken[w] = 0;
      int i = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++i) {
        const int b = u / H, h = u - b * H;
        for (int pass = 0; pass < walk.passes; ++pass) {
          const int t0 = walk.resident ? 0 : pass * C;
          const int t1 = walk.resident ? walk.nq : min(walk.nq, t0 + C);
          for (int t = t0; t < t1; ++t) {
            const int w = walk.owner(i, t);
            int k = 0;
#pragma unroll
            for (int x = 0; x < C; ++x)
              if (x == w) k = taken[x]++;
            const int buf = k % kQStages, n = k / kQStages;
            if (n > 0) mbar_wait(sm.q_empty(w, buf), (n - 1) & 1);
            mbar_expect_tx(sm.q_full(w, buf), G::kTileBytes);
#pragma unroll
            for (int a = 0; a < G::kAtoms; ++a)
              tma_load_3d(sm.q(w, buf) + a * G::kAtomBytes, &p.qkv, sm.q_full(w, buf), h * D + a * G::kBoxLanes,
                          t * kRows, b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::kConsumerRegs));
    // ---- consumers: warpgroup w. Thread (warp wi, lane = 4 g + t4) holds
    // rows 16 wi + g (h = 0) and + 8 (h = 1) of a tile, columns
    // 8 j + 2 t4 + e of each accumulator: acc[4 j + 2 h + e]
    const int w = warp >> 2, wi = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const bool leader = (threadIdx.x & 127) == 0;  // issues the warpgroup's stores
    const float* bias = !HAS_BIAS ? nullptr : p.bias_bytes > 0 ? bias_sm : p.bias;
    int pos = 0, qk = 0;
    bool pending = false;  // a store from the last tile's Q buffer may still read it
    int i = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++i) {
      const int b = u / H, h = u - b * H;
      for (int pass = 0; pass < walk.passes; ++pass, pos += walk.nk) {
        int first, end, step;
        walk.tiles(i, pass, w, first, end, step);
        if (first >= end) {
          // no tile of this pass: hand the chunks back once they have come
          if (lane == 0)
            for (int j = 0; j < walk.nk; ++j) {
              const int slot = (pos + j) % p.slots;
              mbar_wait(sm.kv_full(slot), ((pos + j) / p.slots) & 1);
              mbar_arrive(sm.kv_empty(slot));
            }
          __syncwarp();
          continue;
        }
        for (int t = first; t < end; t += step, ++qk) {
          const bool last = t + step >= end;  // this warpgroup's last tile of the pass
          const int buf = qk % kQStages;
          const uint32_t qtile = sm.q(w, buf);
          const int row0 = t * kRows + 16 * wi;  // this warp's first row
          const int r[2] = {row0 + g, row0 + g + 8};
          // the bias rows (clamped below S: rows past S are computed, on
          // Q's zero rows, and neither stored nor given an lse)
          const float* brow0 = bias == nullptr ? nullptr : bias + (size_t)min(r[0], S - 1) * S;
          const float* brow1 = bias == nullptr ? nullptr : bias + (size_t)min(r[1], S - 1) * S;
          float o[D / 2];
#pragma unroll
          for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
          float m_run[2] = {-INFINITY, -INFINITY};
          float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
          uint32_t pa[4][4];
          float s[32], corr[2];

          // The chunks: the scores of chunk j and O += P_{j-1} . V_{j-1}
          // issued together; chunk j's softmax runs here while the second
          // product finishes on the tensor cores
          mbar_wait(sm.q_full(w, buf), (qk / kQStages) & 1);
          const bool one_pass = D <= 64 && walk.nk == 2;
          if (one_pass) {
            // S = 65..128 (K1's S = 77): the rows' max over chunk 1 first
            // (its scores issued once more in the walk), so that chunk 0's
            // P rounds against its row's max over every key, as one pass
            // over the keys rounds it (the rounding plain version's); the
            // walk then finds chunk 1's max already taken (corr = 1). Not
            // at D = 128 (no path shape), where the pass spilled.
            const int slot = (pos + 1) % p.slots;
            mbar_wait(sm.kv_full(slot), ((pos + 1) / p.slots) & 1);
            issue_scores<D>(s, qtile, sm.k(slot));
            wgmma_wait<0>();
            fence_regs(s);
            chunk_max(s, m_run, brow0, brow1, t4, 1, S, p.scale_log2e);
          }
          mbar_wait(sm.kv_full(pos % p.slots), (pos / p.slots) & 1);
          issue_scores<D>(s, qtile, sm.k(pos % p.slots));
          wgmma_wait<0>();
          fence_regs(s);
          if (pending) {
            // the last tile's store has had this tile's first products to
            // read its buffer: hand it back for the next Q
            if (leader) {
              bulk_wait_read();
              mbar_arrive(sm.q_empty(w, (qk + kQStages - 1) % kQStages));
            }
            pending = false;
          }
          softmax_of(s, m_run, l_run, corr, brow0, brow1, t4, 0, S, p.scale_log2e, one_pass);
          rescale_pack<D>(o, pa, s, corr);
          for (int j = 1; j < walk.nk; ++j) {
            const int slot = (pos + j) % p.slots, prev = (pos + j - 1) % p.slots;
            mbar_wait(sm.kv_full(slot), ((pos + j) / p.slots) & 1);
            issue_scores<D>(s, qtile, sm.k(slot));
            issue_pv<D>(o, pa, sm.v(prev));
            wgmma_wait<1>();  // the scores
            fence_regs(s);
            softmax_of(s, m_run, l_run, corr, brow0, brow1, t4, j, S, p.scale_log2e, one_pass);
            wgmma_wait<0>();  // O += P_{j-1} . V_{j-1}: its chunk and P's registers are free
            fence_regs(o);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
            if (last && lane == 0) mbar_arrive(sm.kv_empty(prev));
            rescale_pack<D>(o, pa, s, corr);
          }
          const int final_slot = (pos + walk.nk - 1) % p.slots;
          issue_pv<D>(o, pa, sm.v(final_slot));
          wgmma_wait<0>();
          fence_regs(o);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
          if (last && lane == 0) mbar_arrive(sm.kv_empty(final_slot));

          // O / l in bf16 into the spent Q buffer, in the TMA's swizzle;
          // one store a 64-lane box; lse from the registers
          uint8_t* qgen = base + (qtile - sm.base);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float l = quad_sum(l_run[hh]);
            const float inv = l > 0.f ? 1.f / l : 0.f;
            if (p.lse != nullptr && t4 == 0 && r[hh] < S)
              p.lse[((size_t)b * H + h) * S + r[hh]] = l > 0.f ? m_run[hh] * kLn2 + logf(l) : 0.f;
            const int row = 16 * wi + g + 8 * hh;
#pragma unroll
            for (int n = 0; n < D / 8; ++n)
              *reinterpret_cast<uint32_t*>(qgen + swizzled<D>(row, n) + 4 * t4) =
                  pack_bf16(o[4 * n + 2 * hh] * inv, o[4 * n + 2 * hh + 1] * inv);
          }
          fence_proxy_async();
          warpgroup_sync(1 + w);
          if (leader) {
#pragma unroll
            for (int a = 0; a < G::kAtoms; ++a)
              tma_store_3d(&p.out, qtile + a * G::kAtomBytes, h * D + a * G::kBoxLanes, t * kRows, b);
            bulk_commit();
          }
          pending = true;
        }
      }
    }
    if (leader) bulk_wait();
  }
}

// ---------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, looked up through the
// runtime, so the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// [B, S, lanes] bf16 rows read (or written) in boxes of kBoxLanes x 64 rows
// x 1 item in the swizzle of D's rows; rows past S within an item read as
// zeros and are not written. TMA needs the base 16-byte aligned and each
// stride a multiple of 16 bytes.
template <int D>
inline bool make_map(CUtensorMap* map, const void* ptr, int lanes, int S, int B) {
  using G = Geo<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15) || (lanes * 2) % 16) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)lanes, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)lanes * 2, (cuuint64_t)S * lanes * 2};
  const cuuint32_t box[3] = {(cuuint32_t)G::kBoxLanes, (cuuint32_t)kRows, 1u};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  const CUtensorMapSwizzle swizzle = G::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : G::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the current device's SM count, read once a device
inline int sm_count() {
  static int counts[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 0 && dev < kMaxDevices && counts[dev] > 0) return counts[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev >= 0 && dev < kMaxDevices) counts[dev] = n;
  return n;
}

// Encode the maps and launch `kernel` (an instantiation of a kernel that
// calls attend_fwd<D, HAS_BIAS>): min(B * H, SMs) persistent blocks.
// `smem_allowed` is the instantiation's own table of devices whose shared
// memory limit it has raised. Returns a CUDA error code.
template <int D, typename Kernel>
int launch_fwd(Kernel kernel, bool (&smem_allowed)[kMaxDevices], const void* qkv, const float* bias, void* out,
               float* lse, int B, int S, int H, float scale, cudaStream_t stream) {
  using G = Geo<D>;
  const int e = mma::allow_smem_once(kernel, G::kSmemBytes, smem_allowed);
  if (e) return e;
  const long long units = (long long)B * H;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  FwdParams p;
  const int W = H * D;
  if (!make_map<D>(&p.qkv, qkv, 3 * W, S, B) || !make_map<D>(&p.out, out, W, S, B))
    return (int)cudaErrorInvalidValue;
  p.bias = bias;
  p.lse = lse;
  p.S = S;
  p.H = H;
  p.units = (int)units;
  const long long bias_bytes = bias == nullptr ? 0 : (long long)S * S * 4;
  p.bias_bytes = bias_bytes <= kBiasStageMax ? (int)(bias_bytes + 1023) / 1024 * 1024 : 0;
  p.slots = (kTilesBudget - G::kQBytes - p.bias_bytes) / (2 * G::kTileBytes);
  if (p.slots > kMaxSlots) p.slots = kMaxSlots;
  p.scale_log2e = scale * kLog2e;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = units < sms ? (int)units : sms;
  kernel<<<grid, G::kThreads, G::kSmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace wg
