// W8A8 quantized GEMM for the int8 inference path, K5, for sm_90a.
//
// Replaces the Pallas kernel of clip_event_tpu/ops/quant_pallas.py::
// quantized_matmul (_kernel). Same contract:
//
//   x      [M, K]  fp32 or bf16 activations
//   q      [K, N]  int8 weight, per-output-channel symmetric, stored K-major:
//                  the kernel reads it as the contiguous [N, K] buffer it is
//                  a transposed view of (ops/quant.py keeps every weight so)
//   scale  [N]     fp32 weight column scales
//   bias   [N]     fp32, optional
//   y      [M, N]  in x's dtype:
//     y = (rowquant(x) . q) * (row_scale (x) col_scale) + bias
//
// Row quantisation, as `ops.quant.quantized_linear` does it:
//   s = max(absmax_k |x[m, k]| / 127, 1e-12)   (dynamic), or the static
//       per-tensor scale of offline calibration (one fp32 on the device)
//   x_q = clip(round_half_even(x / s), -127, 127)
// Products are s8 x s8 into int32 accumulators; the epilogue converts the
// int32 sum to fp32 (round to nearest), multiplies by the fp32 product
// (s * col_scale), adds the bias, and rounds to x's dtype, each step one
// IEEE rounding as in the plain version (no contraction into an FMA). The
// int32 sums are exact in any order, so the result is the plain version's
// bit for bit.
//
// Two launches per call:
//   1. quant_rows_kernel: P = 32..256 threads a row, the least whose 8
//      16-byte pieces each hold the row (a warp a row up to K = 1024 fp32,
//      2048 bf16). Each thread loads its pieces once into registers, all of
//      them in flight together; then the row's abs-max (skipped in static
//      mode), and x_q written from the registers into a [M, Kp] int8
//      scratch whose columns K..Kp-1 are zeros (Kp = K rounded up to the
//      GEMM's 128-byte k tile), and the row's scale into a [M] fp32
//      scratch. Rows that are not 16-byte aligned go element by element.
//   2. int8_gemm_wgmma_kernel: 128 x 128 output tiles, two consumer
//      warpgroups and one producer warp a block, two persistent blocks an
//      SM, each walking its share of the tiles. One producer thread keeps a
//      ring of three stages filled by TMA: the activation tile [128 rows,
//      128 k bytes] of the scratch and the weight tile [128 columns, 128 k
//      bytes] of the K-major weight, both in the 128-byte swizzle that
//      wgmma reads, behind a full and an empty mbarrier a stage; it runs on
//      into the next tile while the consumers write the last one out. TMA
//      fills whatever lies past M, N or K with zeros, so the ragged edges
//      need no code of their own. The consumer warpgroups, each 64 rows of
//      the tile, issue wgmma.mma_async m64n128k32 s32.s8.s8 from shared
//      memory (four a stage) into 64 int32 accumulators a thread. The
//      producer is one warp, not a warpgroup, and no setmaxnreg moves
//      registers: ptxas compiles the whole kernel at its entry count (80 a
//      thread for two blocks of three warpgroups an SM, too few for the
//      wgmma, which asks for 90), so a block is 288 threads and the cap 112
//      a thread. The epilogue rescales in registers and stores from them:
//      fp32 pairs, whose warp stores fill whole 32-byte sectors; bf16 after
//      a 4 x 4 word transpose within each quad of threads, 16 contiguous
//      bytes a thread; element by element at a ragged edge.
//
// Why two launches: the TPU kernel keeps a [TM, K] row block resident in
// VMEM while it quantises it. A block here has 227 KB of shared memory,
// and 128 fp32 rows of K = 4096 are 2 MB, so the row's abs-max must be
// known before the k loop reaches it; the row pass costs one extra read of
// x and a write and read of the int8 copy (a quarter of x's fp32 bytes).
//
// What bounds it on the card: at the ViT-L/14 vision shapes (M = 64 * 257
// rows, K, N = 1024..4096) the product is 2*M*N*K = 35-138 G int8
// operations, 17-70 us at the 1,979 TOPS dense int8 peak; the bytes that
// must move (x read, y written, q) are 136-340 MB in fp32, 40-100 us at
// 3.35 TB/s, most of them the output's, so fp32 calls are bound by bytes
// and the larger bf16 ones by operations. What holds this design back:
// each 128 x 128 x 128 stage brings 32 KB of tiles from L2 for 4.2 M int8
// operations (128 a byte), and a tile of K = 1024 has only 8 of them to
// spread its prologue and epilogue over (PERF.md has the rates).
// Two blocks an SM run one block's epilogue under the other's products.
// Tried on the card and dropped, each slower: 2 x 1 to 2 x 2 clusters
// that TMA-multicast the shared tiles (at every path shape), one wgmma
// group kept in flight across stages, and 128 x 256 tiles with one
// persistent block an SM, whose epilogue then runs under no products
// (except at K = 4096).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output rows a block: two consumer warpgroups of 64
constexpr int kBN = 128;  // output columns a block: one m64n128 wgmma wide
constexpr int kBK = 128;  // k bytes a stage: the 128-byte swizzle's span
constexpr int kStages = 3;
constexpr int kConsumers = 2;  // warpgroups
constexpr int kGemmThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr int kBlocksPerSM = 2;  // one block's epilogue under the other's products
constexpr int kTileBytes = 128 * kBK;  // one operand's tile: 128 rows of kBK bytes
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kAccRegs = kBN / 2;  // int32 accumulators a thread (m64n128)
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
constexpr int kRowThreads = 256;  // a row-pass block: 256 / P rows of P threads
constexpr int kRowPieces = 8;     // 16-byte pieces of x a row-pass thread holds
constexpr long long kWaitTrapCycles = 1ll << 32;  // a lost barrier traps (~2 s) instead of hanging

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------- row pass

// 16 bytes of x: 4 fp32 or 8 bf16
__device__ __forceinline__ void unpack16(const uint4& t, float (&v)[4]) {
  v[0] = __uint_as_float(t.x); v[1] = __uint_as_float(t.y);
  v[2] = __uint_as_float(t.z); v[3] = __uint_as_float(t.w);
}
__device__ __forceinline__ void unpack16(const uint4& t, float (&v)[8]) {
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(h);
    v[2 * i + 1] = __high2float(h);
  }
}

__device__ __forceinline__ uint32_t quant1(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));  // half to even
  return (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
}

// The row's scale: the static one, or max(abs-max / 127, 1e-12) over the
// partial abs-maxes of the P threads of a row (P / 32 warps; every thread
// of the block calls this, as it holds a barrier).
template <int P>
__device__ __forceinline__ float row_scale_of(float amax, const float* static_scale) {
  if (static_scale != nullptr) return *static_scale;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if constexpr (P > 32) {
    __shared__ float warp_max[kRowThreads / 32];
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
    __syncthreads();
    const int first = (threadIdx.x / P) * (P / 32);
    amax = warp_max[first];
#pragma unroll
    for (int w = 1; w < P / 32; ++w) amax = fmaxf(amax, warp_max[first + w]);
  }
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
}

// P threads a row, kRowThreads / P rows a block (the host picks the least P
// whose threads hold the row in kRowPieces 16-byte pieces each). Where the
// row's start is 16-byte aligned and its length a multiple of 16 bytes
// (`vec`), each thread loads its pieces once into registers, as they are,
// and quantises and stores them (4 or 8 int8 in one store) after the row's
// abs-max: x is read once, with every load of the row in flight together.
// Otherwise element by element, x read twice. Columns K..Kp-1 get zeros.
template <typename T, int P>
__global__ void __launch_bounds__(kRowThreads)
quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ static_scale,
                  int8_t* __restrict__ xq, float* __restrict__ row_scale, int M, int K, int Kp,
                  int vec) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x % P;
  const int m = blockIdx.x * (kRowThreads / P) + threadIdx.x / P;
  const bool live = m < M;  // a dead row's threads still reach the barrier
  const T* xr = x + (size_t)m * K;
  int8_t* out = xq + (size_t)m * Kp;
  float s;
  if (vec) {
    const int pieces = live ? K / V : 0;
    uint4 raw[kRowPieces];
    float amax = 0.f;
#pragma unroll
    for (int c = 0; c < kRowPieces; ++c)
      if (c * P + lane < pieces) raw[c] = reinterpret_cast<const uint4*>(xr)[c * P + lane];
#pragma unroll
    for (int c = 0; c < kRowPieces; ++c) {
      if (c * P + lane < pieces) {
        float v[V];
        unpack16(raw[c], v);
#pragma unroll
        for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(v[e]));
      }
    }
    s = row_scale_of<P>(amax, static_scale);
#pragma unroll
    for (int c = 0; c < kRowPieces; ++c) {
      const int i = c * P + lane;
      if (i < pieces) {
        float v[V];
        unpack16(raw[c], v);
        uint32_t w[V / 4];
#pragma unroll
        for (int j = 0; j < V / 4; ++j)
          w[j] = quant1(v[4 * j], s) | quant1(v[4 * j + 1], s) << 8 | quant1(v[4 * j + 2], s) << 16 |
                 quant1(v[4 * j + 3], s) << 24;
        if constexpr (V == 4) {
          *reinterpret_cast<uint32_t*>(out + i * V) = w[0];
        } else {
          *reinterpret_cast<uint2*>(out + i * V) = make_uint2(w[0], w[1]);
        }
      }
    }
  } else {
    float amax = 0.f;
    if (live && static_scale == nullptr)
      for (int k = lane; k < K; k += P) amax = fmaxf(amax, fabsf(to_float(xr[k])));
    s = row_scale_of<P>(amax, static_scale);
    if (live)
      for (int k = lane; k < K; k += P) out[k] = (int8_t)quant1(to_float(xr[k]), s);
  }
  if (!live) return;
  if (lane == 0) row_scale[m] = s;
  for (int k = K + lane; k < Kp; k += P) out[k] = 0;
}

// ---------------------------------------------------------------- GEMM

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
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

// One box of a 2-D tensor map into shared memory; `bar` counts its bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (stride byte offset), the leading
// offset unused by this layout; the tile starts 1024-byte aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[64 x 128] += a[64 x 32] . b[128 x 32]^T, s8 operands from shared memory
// (scale-d 1: the accumulators start at zero)
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[kAccRegs], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Two neighbouring fp32 outputs of a row, columns n and n + 1 (both: n + 1 < N)
__device__ __forceinline__ void store_pair(float* y, size_t at, bool both, bool aligned, float a, float b) {
  if (both && aligned) {
    *reinterpret_cast<float2*>(y + at) = make_float2(a, b);
  } else {
    y[at] = a;
    if (both) y[at + 1] = b;
  }
}

// v[h][e] = acc * (row scale h * column scale n + e) + bias, in IEEE steps
// (no FMA), for the accumulators of n8 block j: acc[4 j + 2 h + e]
__device__ __forceinline__ void rescale(const int (&acc)[kAccRegs], int j, const float (&rs)[2],
                                        const float* __restrict__ col_scale, const float* __restrict__ bias,
                                        int n, int N, float (&v)[2][2]) {
  float cs[2], bi[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    cs[e] = n + e < N ? col_scale[n + e] : 0.f;
    bi[e] = bias != nullptr && n + e < N ? bias[n + e] : 0.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      v[h][e] = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), __fmul_rn(rs[h], cs[e]));
      if (bias != nullptr) v[h][e] = __fadd_rn(v[h][e], bi[e]);
    }
}

// w[i] for a runtime i in 0..3, by selects (no local memory)
__device__ __forceinline__ uint32_t pick4(const uint32_t (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// Persistent: block b takes tiles b, b + gridDim.x, ... (columns fastest,
// so the blocks in flight share their activation rows and the weight in
// L2). The producer walks the same tiles and runs ahead into the next
// tile's stages while the consumers write the last one out.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads, kBlocksPerSM)
int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                       const float* __restrict__ row_scale, const float* __restrict__ col_scale,
                       const float* __restrict__ bias, T* __restrict__ y, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle needs 1024-byte aligned tiles
  const uint32_t full = ring + kStages * kStageBytes;  // full[s] = full + 8 s
  const uint32_t empty = full + 8 * kStages;           // empty[s] = empty + 8 s
  const int nk = (K + kBK - 1) / kBK;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = (M + kBM - 1) / kBM * tiles_n;
  const int wg = threadIdx.x >> 7;  // kConsumers: the producer warp

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(empty + 8 * s, 4 * kConsumers);    // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int s = 0;
  uint32_t phase = 0;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full, tile after tile
    if (threadIdx.x == kConsumers * 128) {
      int loads = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
        for (int kt = 0; kt < nk; ++kt, ++loads) {
          if (loads >= kStages) mbar_wait(empty + 8 * s, phase ^ 1);  // its last round released
          const uint32_t dst = ring + s * kStageBytes;
          mbar_expect_tx(full + 8 * s, kStageBytes);
          tma_load_2d(dst, &map_a, full + 8 * s, kt * kBK, m0);
          tma_load_2d(dst + kTileBytes, &map_b, full + 8 * s, kt * kBK, n0);
          if (++s == kStages) { s = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg multiplies rows [64 wg, 64 wg + 64) of each
  // tile. Thread t = 32 w + l of the warpgroup holds rows 16 w + l / 4
  // (h = 0) and + 8 (h = 1), columns 8 j + 2 (l % 4) + e: acc[4 j + 2 h + e]
  const int t = threadIdx.x & 127, l = t & 31;
  const int r_lo = 16 * (t >> 5) + (l >> 2);
  const bool pairs = (N & 1) == 0 && (reinterpret_cast<uintptr_t>(y) & (2 * sizeof(T) - 1)) == 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
    int acc[kAccRegs];
#pragma unroll
    for (int i = 0; i < kAccRegs; ++i) acc[i] = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full + 8 * s, phase);
      const uint32_t a = ring + s * kStageBytes + wg * 64 * kBK;
      const uint64_t da = sw128_desc(a), db = sw128_desc(ring + s * kStageBytes + kTileBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)  // 32 k bytes a wgmma: +2 in the descriptor's 16-byte units
        wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait_all();
      if (l == 0) mbar_arrive(empty + 8 * s);
      if (++s == kStages) { s = 0; phase ^= 1; }
    }
#pragma unroll
    for (int i = 0; i < kAccRegs; ++i) asm volatile("" : "+r"(acc[i])::"memory");

    // ---- epilogue: rescale in registers and store straight from them, so
    // the ring stays the producer's for the next tile
    const int mb = m0 + 64 * wg + r_lo;
    float rs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) rs[h] = mb + 8 * h < M ? row_scale[mb + 8 * h] : 0.f;
    if constexpr (sizeof(T) == 4) {
      // fp32: each warp store fills whole 32-byte sectors of 8 rows
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (l & 3);
        if (n >= N) continue;
        const bool both = n + 1 < N;
        float v[2][2];
        rescale(acc, j, rs, col_scale, bias, n, N, v);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (mb + 8 * h < M) store_pair(y, (size_t)(mb + 8 * h) * N + n, both, pairs, v[h][0], v[h][1]);
      }
    } else {
      // bf16: the quad of threads that holds rows (r, r + 8) x columns
      // 8 j .. 8 j + 15 swaps words (a 4 x 4 transpose) so that each holds
      // 16 contiguous bytes of one row: word k = 2 h + jj of thread q is
      // columns 8 (j + jj) + 2 q, + 1 of row h; thread q gets word q of
      // every thread, row q / 2, columns 8 (j + q % 2) .. + 7
      const int q = l & 3;
      const bool vec8 = (N & 7) == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
#pragma unroll
      for (int j = 0; j < kBN / 8; j += 2) {
        uint32_t w[4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float v[2][2];
          rescale(acc, j + jj, rs, col_scale, bias, n0 + 8 * (j + jj) + 2 * q, N, v);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162 p2;
            p2.x = __float2bfloat16_rn(v[h][0]);
            p2.y = __float2bfloat16_rn(v[h][1]);
            w[2 * h + jj] = *reinterpret_cast<uint32_t*>(&p2);
          }
        }
        uint32_t o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = w[k];  // o[q] = w[q] stays
#pragma unroll
        for (int r = 1; r < 4; ++r) {
          const int give = q ^ r;  // the partner q ^ r wants my word q ^ r
          const uint32_t got = __shfl_xor_sync(0xffffffffu, pick4(w, give), r);
#pragma unroll
          for (int k = 0; k < 4; ++k) o[k] = k == give ? got : o[k];
        }
        const int m = mb + 8 * (q >> 1), n = n0 + 8 * (j + (q & 1));
        if (m >= M || n >= N) continue;
        __nv_bfloat16* dst = y + (size_t)m * N + n;
        if (vec8 && n + 8 <= N) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (n + e < N) dst[e] = __ushort_as_bfloat16((unsigned short)(o[e >> 1] >> (16 * (e & 1))));
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, looked up through the
// runtime, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                     : nullptr;
  }();
  return fn;
}

// [rows, cols] int8 with a row stride of `ld` bytes, read in boxes of 128
// rows x kBK bytes in the 128-byte swizzle; boxes past the edges read zeros.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int ld) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, 128u};
  const cuuint32_t elem[2] = {1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int gemm_setup() {
  // once a process: the dynamic shared memory above 48 KB
  static const int code = (int)cudaFuncSetAttribute(
      int8_gemm_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  return code;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return count;
  }();
  return n;
}

template <typename T, int P>
void launch_rows_p(const void* x, const void* static_scale, void* xq, void* row_scale, int M, int K, int Kp,
                   int vec, cudaStream_t stream) {
  quant_rows_kernel<T, P><<<(M + kRowThreads / P - 1) / (kRowThreads / P), kRowThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(static_scale), static_cast<int8_t*>(xq),
      static_cast<float*>(row_scale), M, K, Kp, vec);
}

// P: the least of 32, 64, 128, 256 threads a row whose kRowPieces 16-byte
// pieces each hold the row (K up to 1024, ..., 8192 fp32); longer or
// unaligned rows go element by element, 256 threads a row.
template <typename T>
int launch_rows(const void* x, const void* static_scale, void* xq, void* row_scale, int M, int K, int Kp,
                cudaStream_t stream) {
  const int bytes = K * (int)sizeof(T);
  const int vec = aligned16(x) && bytes % 16 == 0 && bytes <= kRowThreads * kRowPieces * 16;
  const int per_thread = kRowPieces * 16;
  if (vec && bytes <= 32 * per_thread)
    launch_rows_p<T, 32>(x, static_scale, xq, row_scale, M, K, Kp, vec, stream);
  else if (vec && bytes <= 64 * per_thread)
    launch_rows_p<T, 64>(x, static_scale, xq, row_scale, M, K, Kp, vec, stream);
  else if (vec && bytes <= 128 * per_thread)
    launch_rows_p<T, 128>(x, static_scale, xq, row_scale, M, K, Kp, vec, stream);
  else
    launch_rows_p<T, 256>(x, static_scale, xq, row_scale, M, K, Kp, vec, stream);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gemm(const void* xq, int lda, const void* row_scale, const void* q, int ldq, const void* col_scale,
                const void* bias, void* y, int M, int K, int N, cudaStream_t stream) {
  const int e = gemm_setup<T>();
  if (e != 0) return e;
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, xq, M, K, lda) || !make_map(&map_b, q, N, K, ldq)) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int slots = kBlocksPerSM * sm_count();
  if (slots <= 0) return (int)cudaErrorInvalidDevice;
  int8_gemm_wgmma_kernel<T><<<(int)(tiles < slots ? tiles : slots), kGemmThreads, kSmemBytes, stream>>>(
      map_a, map_b, static_cast<const float*>(row_scale), static_cast<const float*>(col_scale),
      static_cast<const float*>(bias), static_cast<T*>(y), M, N, K);
  return (int)cudaGetLastError();
}

bool valid_rows(int M, int K, int Kp, int dtype) {
  return M >= 1 && K >= 1 && Kp >= K && Kp % kBK == 0 && Kp - K < kBK && (dtype == 0 || dtype == 1);
}

// TMA reads rows at 16-byte aligned addresses
bool valid_gemm(const void* xq, int lda, const void* q, int ldq, int M, int K, int N, int dtype) {
  return M >= 1 && K >= 1 && N >= 1 && lda >= K && lda % 16 == 0 && ldq >= K && ldq % 16 == 0 &&
         aligned16(xq) && aligned16(q) && (dtype == 0 || dtype == 1);
}

}  // namespace

// The GEMM alone (launch 2 of clip_quant_matmul) on pre-quantised rows:
// xq [M, K] int8 with a row stride of lda bytes (the row pass's [M, Kp]
// scratch, or any rows whose stride and start are 16-byte aligned);
// row_scale [M] fp32; q the K-major weight, [N, K] int8 with a row stride
// of ldq bytes (16-byte aligned, as xq); col_scale [N] fp32; bias [N] fp32
// or null; y [M, N] (dtype 0 fp32, 1 bf16). Returns cudaGetLastError().
extern "C" int clip_quant_gemm(const void* xq, int lda, const void* row_scale, const void* q, int ldq,
                               const void* col_scale, const void* bias, void* y, int M, int K, int N,
                               int dtype, void* stream) {
  if (!valid_gemm(xq, lda, q, ldq, M, K, N, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_gemm<float>(xq, lda, row_scale, q, ldq, col_scale, bias, y, M, K, N, s)
                    : launch_gemm<__nv_bfloat16>(xq, lda, row_scale, q, ldq, col_scale, bias, y, M, K, N, s);
}

// y = (rowquant(x) . q) * (row_scale (x) col_scale) + bias, two launches.
// x [M, K] (dtype 0 fp32, 1 bf16); static_scale: one fp32 on the device, or
// null for dynamic per-row scales; xq [M, Kp] int8 and row_scale [M] fp32
// are scratch the caller allocates (Kp = K rounded up to 128); q, ldq,
// col_scale, bias and y as for clip_quant_gemm. Returns cudaGetLastError()
// after the launches.
extern "C" int clip_quant_matmul(const void* x, const void* static_scale, void* xq, void* row_scale,
                                 const void* q, int ldq, const void* col_scale, const void* bias, void* y,
                                 int M, int K, int N, int Kp, int dtype, void* stream) {
  if (!valid_rows(M, K, Kp, dtype) || !valid_gemm(xq, Kp, q, ldq, M, K, N, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = dtype == 0 ? launch_rows<float>(x, static_scale, xq, row_scale, M, K, Kp, s)
                     : launch_rows<__nv_bfloat16>(x, static_scale, xq, row_scale, M, K, Kp, s);
  if (e != 0) return e;
  return dtype == 0
             ? launch_gemm<float>(xq, Kp, row_scale, q, ldq, col_scale, bias, y, M, K, N, s)
             : launch_gemm<__nv_bfloat16>(xq, Kp, row_scale, q, ldq, col_scale, bias, y, M, K, N, s);
}

// The row pass alone (launch 1 of clip_quant_matmul), for checking the int8
// payload and the row scales against the plain version.
extern "C" int clip_quant_rows(const void* x, const void* static_scale, void* xq, void* row_scale, int M,
                               int K, int Kp, int dtype, void* stream) {
  if (!valid_rows(M, K, Kp, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_rows<float>(x, static_scale, xq, row_scale, M, K, Kp, s)
                    : launch_rows<__nv_bfloat16>(x, static_scale, xq, row_scale, M, K, Kp, s);
}

// How many GEMM blocks an SM holds at once (the design wants kBlocksPerSM),
// or a negative CUDA error code.
extern "C" int clip_quant_gemm_blocks_per_sm(int dtype) {
  const int e = dtype == 0 ? gemm_setup<float>() : gemm_setup<__nv_bfloat16>();
  if (e != 0) return -e;
  int blocks = 0;
  const cudaError_t r =
      dtype == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, int8_gemm_wgmma_kernel<float>,
                                                                 kGemmThreads, kSmemBytes)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, int8_gemm_wgmma_kernel<__nv_bfloat16>, kGemmThreads, kSmemBytes);
  return r == cudaSuccess ? blocks : -(int)r;
}

// The GEMM's dynamic shared memory a block (the ring, its barriers and the
// alignment slack; ptxas reports only static shared memory).
extern "C" int clip_quant_gemm_smem_bytes() { return kSmemBytes; }

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
