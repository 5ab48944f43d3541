// LayerNorm -> packed QKV projection -> multi-head attention in one kernel
// (K6, forward only), for sm_90a.
//
// Replaces the Pallas megakernel of
// clip_event_tpu/ops/attention_pallas.py::fused_ln_qkv_attention
// (_mega_fwd_kernel). Same contract and the same roundings:
//
//   x      [B, S, W]  fp32 or bf16 (the I/O type T), contiguous
//   gamma, beta [W]   in T (the wrapper casts them, as the JAX wrapper does)
//   w      [W, 3W]    in T, input-major: q columns [0, W), k [W, 2W),
//                     v [2W, 3W), head h at [h*D, (h+1)*D) within each
//   wb     [3W]       in T
//   bias   [S, S]     fp32 additive mask, or null (no mask: nothing is read)
//   out    [B, S, W]  in T
//
//   ln  = ((x - mean) * rsqrt(var + eps)) * gamma + beta   in fp32,
//         rounded to T
//   qkv = ln . w + wb   accumulated in fp32 and NOT rounded to T
//   out = softmax(q * scale . k^T + bias) . v per head, the probabilities
//         kept in fp32, rounded to T at the end
//
// What bounds it: operations, at the tensor cores' rates. The projection
// is 2*B*S*W*3W flops and the core 4*B*H*S^2*D against x, out and the
// weight moved once: hundreds of flops a byte. In bf16 that is the bf16
// rate (0.1035 ms at the component bench's text shape, B=768 S=77 W=512
// H=8, on the NVIDIA H100 80GB HBM3); in fp32 the TF32 rate at three
// products a term (split TF32, 0.620 ms there). Neither ln nor the
// [B, S, 3W] projection ever reaches device memory. What bounds this
// design first is the weight: one block an item reads the head's weight
// columns once an item, B * 3W^2 * sizeof(T) through L2 a call (1.2 GB at
// text bf16, 0.9 GB at vision, twice that in fp32): the weight's only reuse
// is the item's R rows.
//
// Three hand-written variants, chosen by dtype and head_dim alone in the
// Python wrapper (`ops.attention.mega_variant`, K1's rule) and passed in:
//
// "mma" (bf16) and "tf32x3" (fp32), D in {16, 32, 64}: the tensor cores.
//   * One block an item, the heads in a loop, so the LayerNorm's row
//     statistics are taken once an item (one warp a row, mean then the
//     centred variance, as the plain version).
//   * The projection of a head, [R = 16*ceil(S/16) rows, 3D columns], by
//     mma.sync: bf16 m16n8k16 with fp32 accumulators (bf16 x bf16 products
//     are exact: the contract holds up to summation order), or in fp32
//     split TF32 (attention_mma.cuh: x = hi + lo, lo.hi' + hi.lo' +
//     hi.hi'). 8 warps, each 3 n-tiles (24 columns) of every
//     (8 / (D/8))-th m-tile: 24 columns x 5 m-tiles at S = 77, D = 64.
//   * Two layouts of the A operand, chosen by the wrapper
//     (`ops.attention.mega_layout`; the same byte count below):
//     "resident" (bf16, where it fits): the item's x rows land once by
//     cp.async, are normalized and rounded in place, and stay as the A
//     operand of every head (row stride W + 8: conflict-free ldmatrix);
//     only the head's weight columns stream, 64 k-rows a stage.
//     "stream" (fp32, and bf16 where resident does not fit): x and the
//     weight stream together in k-tiles (64 columns bf16, 32 fp32); each x
//     tile is normalized in shared memory once a head, with the statistics
//     kept.
//   * Weight tiles [k][3D] (the head's q, k and v columns side by side, row
//     stride 3D + 8) by 16-byte cp.async into a ring of as many stages as
//     fit (`tc_stages`, up to 6), across heads too.
//   * q, k, v (+ wb) leave the accumulators as fp32 into tiles of stride
//     D + 4 (never rounded), and K1's tf32x3 forward core
//     (`mma::attend_rows_tf32x3`) runs on them, one warp a 16-row query
//     tile; O / l rounded to T once, staged in the warp's own q rows,
//     16-byte stores.
//   * Resident items of R <= 80 (both component-bench shapes) run split
//     (`split_warps`): 16 warps, 8 of them on the projection of head h + 1
//     while 8 run the core of head h (the core's latency, K1's tile walk
//     on one 16-row tile a warp, would otherwise add to the projection's);
//     named barriers hand the q, k, v tiles over. 128 registers a thread.
//     Other shapes run 8 warps that do everything in turn (up to 255
//     registers).
//   * Shared memory (`tc_smem_bytes`): q, k, v 3*R*(D+4)*4 + the ring +
//     row statistics; resident adds R*(W+8)*2. Text bf16 (S=77, W=512):
//     225,920 B resident, three stages; vision (S=50, W=768) 228,864;
//     fp32 stream 214,400 / 226,816; every accepted shape fits with two
//     stages or more: one block an SM.
//   * L2 traffic: the weight once an item (above); x once an item
//     (resident) or once a head (stream: H * B*S*W*sizeof(T)).
//
// "simt" (other head dims: D % 4 == 0, D <= 64): the first, CUDA-core kernel.
//   One block per (item, head) computes the row statistics, forms the
//   head's q, k and v in three passes over 32-column tiles of x
//   (normalized on the way into shared memory) and of its weight columns
//   with fp32 FMAs, and runs a warp-per-query-row core.
//
// Limits, checked by the Python wrapper too: S <= 128, D <= 64, D % 4 == 0;
// the tensor-core variants D in {16, 32, 64} and 16-byte-aligned x, w,
// gamma, beta and out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

// layout { the shared memory of every launch, for the host and the
// device alike (tests/test_torch_k6_k3_layout.py builds this region with
// the host's C++ compiler and holds it against ops.attention.mega_smem_bytes)
constexpr int kMaxS = 128;
constexpr int kMaxD = 64;
constexpr long long kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kQPad = 4;        // fp32 padding of a q, k, v tile row (mma::kPadF)
// weight k-rows (and stream x columns) a stage: 64 in bf16 (four k-steps of
// 16 between barriers), 32 in fp32 (four of 8)
__host__ __device__ __forceinline__ int tile_k(int elt) { return elt == 2 ? 64 : 32; }
constexpr int kMaxStages = 6;   // stages of the ring, as many as fit up to this
constexpr int kWarps = 8;       // warps a block, every variant
constexpr int kTileK = 32;      // simt: input columns per tile
constexpr int kRowStep = 16;    // simt: thread rows of the product's grid

enum Layout { kResident = 0, kStream = 1 };

// rows of a head's tiles: S rounded up to the 16 of an m-tile
__host__ __device__ __forceinline__ int tile_rows(int S) { return (S + 15) / 16 * 16; }

// Elements of one ring stage: the weight tile [tile_k][3D + 8], and in the
// stream layout the x tile [R][tile_k + 16 bytes] before it.
__host__ __device__ __forceinline__ size_t stage_elems(int R, int D, int elt, int layout) {
  const size_t w = (size_t)tile_k(elt) * (3 * D + 8);
  return layout == kResident ? w : w + (size_t)R * (tile_k(elt) + 16 / elt);
}

// Bytes of everything but the ring, in the kernel's order: q, k, v fp32
// tiles, (the ring,) the resident A rows, mean and rstd.
__host__ __device__ __forceinline__ size_t tc_fixed_bytes(int S, int W, int D, int elt, int layout) {
  const int R = tile_rows(S);
  size_t bytes = (size_t)3 * R * (D + kQPad) * 4 + (size_t)2 * R * 4;
  if (layout == kResident) bytes += (size_t)R * (W + 8) * elt;
  return bytes;
}

// Stages of the ring: as many as fit beside the rest, up to kMaxStages; 0
// where two do not fit.
__host__ __device__ __forceinline__ int tc_stages(int S, int W, int D, int elt, int layout) {
  const size_t fixed = tc_fixed_bytes(S, W, D, elt, layout);
  const size_t stage = stage_elems(tile_rows(S), D, elt, layout) * elt;
  if (fixed + 2 * stage > (size_t)kMaxSmem) return 0;
  const size_t fit = ((size_t)kMaxSmem - fixed) / stage;
  return fit < (size_t)kMaxStages ? (int)fit : kMaxStages;
}

// Dynamic shared memory of a tensor-core launch (0 where it does not fit).
__host__ __device__ __forceinline__ size_t tc_smem_bytes(int S, int W, int D, int elt, int layout) {
  const int stages = tc_stages(S, W, D, elt, layout);
  return stages ? tc_fixed_bytes(S, W, D, elt, layout) +
                      stages * stage_elems(tile_rows(S), D, elt, layout) * elt
                : 0;
}

__host__ __device__ __forceinline__ int key_stride(int D) { return D | 1; }
// rows of the simt kernel's transposed x tile, padded to the thread grid,
// plus one so that the 32 lanes of a warp storing one row's 32 columns hit
// 32 banks
__host__ __device__ __forceinline__ int tile_stride(int S) {
  return (S + kRowStep - 1) / kRowStep * kRowStep + 1;
}

__host__ __device__ __forceinline__ size_t simt_smem_bytes(int S, int D) {
  return ((size_t)kTileK * D + (size_t)kTileK * tile_stride(S) + 2 * (size_t)S * D +
          (size_t)S * key_stride(D) + (size_t)kWarps * S + 2 * (size_t)S) * sizeof(float);
}

// Resident items of at most this many tile rows run the split kernel: 8
// warps on the projection of the next head while 8 run the attention core
// (in 128 registers a thread; the stream layout's tile pass does not fit
// beside them).
constexpr int kSplitMaxRows = 80;
__host__ __device__ __forceinline__ bool split_warps(int S, int layout) {
  return layout == kResident && tile_rows(S) <= kSplitMaxRows;
}

// Bytes of dynamic shared memory a launch takes, or 0 for a combination the
// kernel does not take. dtype: 0 = fp32, 1 = bf16; variant: 0 = "simt", 1 =
// "mma" (bf16), 2 = "tf32x3" (fp32); layout (the tensor-core variants): 0 =
// resident (bf16 only), 1 = stream.
inline long long smem_bytes(int S, int H, int D, int dtype, int variant, int layout) {
  if (S < 1 || S > kMaxS || H < 1 || D < 1 || D > kMaxD || D % 4 || (dtype != 0 && dtype != 1))
    return 0;
  if (variant == 0) return (long long)simt_smem_bytes(S, D);
  if (variant != (dtype == 1 ? 1 : 2) || (D != 16 && D != 32 && D != 64)) return 0;
  if (layout != kStream && !(layout == kResident && dtype == 1)) return 0;
  return (long long)tc_smem_bytes(S, H * D, D, dtype == 1 ? 2 : 4, layout);
}
// } layout

constexpr int kThreads = kWarps * 32;
constexpr int kRowSlots = kMaxS / kRowStep;  // simt: result rows a thread owns
constexpr int kKeySlots = kMaxS / 32;        // simt: logits each lane holds
static_assert(kQPad == mma::kPadF, "the q, k, v tiles are attention_mma.cuh's fp32 tiles");

// What a tensor-core launch runs: bit 0 the projection's products, bit 1
// the attention core; bit 2 set skips the ring's copies (the products then
// read stale tiles). Both and the copies, unless a diagnostic build
// (`chip_smoke.py --k6-split`) times one part without the others.
#ifndef LN_QKV_ATTENTION_PHASES
#define LN_QKV_ATTENTION_PHASES 3
#endif
constexpr bool kRunProjection = LN_QKV_ATTENTION_PHASES & 1;
constexpr bool kRunCore = LN_QKV_ATTENTION_PHASES & 2;
constexpr bool kRunCopies = !(LN_QKV_ATTENTION_PHASES & 4);

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }


template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------- tensor cores

// cp.async.wait_group with a count known at run time (the ring's stages)
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: mma::cp_async_wait<0>(); break;
    case 1: mma::cp_async_wait<1>(); break;
    case 2: mma::cp_async_wait<2>(); break;
    case 3: mma::cp_async_wait<3>(); break;
    case 4: mma::cp_async_wait<4>(); break;
    default: mma::cp_async_wait<5>(); break;
  }
}

__device__ __forceinline__ float ln_value(float xv, float mean, float rstd, float g, float b) {
  // the plain version's roundings: no fused multiply-add
  return __fadd_rn(__fmul_rn(__fmul_rn(xv - mean, rstd), g), b);
}

// 16 bytes of one row in shared memory normalized and rounded in place
// (gamma and beta 16-byte aligned in device memory, read through L1)
__device__ __forceinline__ void normalize16(float* p, const float* g, const float* b, float mean,
                                            float rstd) {
  float4 v = *reinterpret_cast<float4*>(p);
  const float4 gv = *reinterpret_cast<const float4*>(g);
  const float4 bv = *reinterpret_cast<const float4*>(b);
  v.x = ln_value(v.x, mean, rstd, gv.x, bv.x);
  v.y = ln_value(v.y, mean, rstd, gv.y, bv.y);
  v.z = ln_value(v.z, mean, rstd, gv.z, bv.z);
  v.w = ln_value(v.w, mean, rstd, gv.w, bv.w);
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void normalize16(__nv_bfloat16* p, const __nv_bfloat16* g,
                                            const __nv_bfloat16* b, float mean, float rstd) {
  uint4 v = *reinterpret_cast<uint4*>(p);
  const uint4 gv = *reinterpret_cast<const uint4*>(g);
  const uint4 bv = *reinterpret_cast<const uint4*>(b);
  uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
  const uint32_t* gw = reinterpret_cast<const uint32_t*>(&gv);
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(&bv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vw + i));
    const float2 g2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gw + i));
    const float2 b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bw + i));
    const __nv_bfloat162 r = __floats2bfloat162_rn(ln_value(x2.x, mean, rstd, g2.x, b2.x),
                                                   ln_value(x2.y, mean, rstd, g2.y, b2.y));
    vw[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
  *reinterpret_cast<uint4*>(p) = v;
}

// named barriers of the split kernel (0 is __syncthreads)
constexpr int kBarProjection = 1;  // the projection warps' own barrier
constexpr int kBarFull = 2;        // q, k, v of a head written: the core may start
constexpr int kBarEmpty = 3;       // the core done with q, k, v: they may be rewritten
// the split kernel's 16 warps: 8 on the projection, 8 on the core (a
// 16-row query tile each): 128 registers a thread (an SM sub-partition's
// 16,384 for its 4 warps)
constexpr int kSplitThreads = 2 * kThreads;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// SPLIT (resident, R <= 80, `split_warps`): 16 warps. Warps 0-7 run the
// projection of head h + 1 (and the ring's copies) while warps 8-15 run the
// attention core of head h over the one set of q, k, v tiles, handed over
// by the named barriers kBarFull and kBarEmpty; 128 registers a thread.
// Otherwise 8 warps run everything in turn.
template <typename T, int D, bool HAS_BIAS, bool RESIDENT, bool SPLIT>
__global__ void __launch_bounds__(SPLIT ? kSplitThreads : kThreads, 1)
ln_qkv_attention_kernel_tc(const T* __restrict__ x, const T* __restrict__ gamma,
                           const T* __restrict__ beta, const T* __restrict__ w,
                           const T* __restrict__ wb, const float* __restrict__ bias,
                           T* __restrict__ out, int S, int H, float scale_log2e, float eps) {
  using namespace mma;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(kBf16 || !RESIDENT, "the resident layout is bf16's");
  constexpr int kElt = sizeof(T);
  constexpr int kVec = 16 / kElt;               // elements a 16-byte copy moves
  constexpr int kKStep = kBf16 ? 16 : 8;        // k of one mma
  constexpr int kTK = kBf16 ? 64 : 32;          // tile_k
  constexpr int kWStride = 3 * D + 8;           // weight tile row stride
  constexpr int kXStride = kTK + kVec;          // stream x tile row stride
  constexpr int kQStride = D + kPadF;
  constexpr int kNG = D / 8;                    // projection warp columns: 3 n-tiles each
  constexpr int kMG = kWarps / kNG;             // projection warp rows
  constexpr int kMaxRows = SPLIT ? kSplitMaxRows : kMaxS;
  constexpr int kMaxMT = (kMaxRows / 16 + kMG - 1) / kMG;  // m-tiles a projection warp owns
  constexpr int kBlockThreads = SPLIT ? kSplitThreads : kThreads;
  static_assert(kNG * kMG == kWarps, "D in {16, 32, 64}");

  const int W = H * D;
  const int R = tile_rows(S);
  const int MT = R / 16;
  const int layout = RESIDENT ? kResident : kStream;
  const int stage = (int)stage_elems(R, D, kElt, layout);
  const int stages = tc_stages(S, W, D, kElt, layout);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [R][D+4]
  float* sK = sQ + R * kQStride;                   // [R][D+4]
  float* sV = sK + R * kQStride;                   // [R][D+4]
  T* ring = reinterpret_cast<T*>(sV + R * kQStride);  // `stages` stages
  T* sA = ring + stages * stage;                   // resident: [R][W+8]
  float* mean_s = reinterpret_cast<float*>(RESIDENT ? sA + (size_t)R * (W + 8) : sA);
  float* rstd_s = mean_s + R;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.x;
  const T* xb = x + (size_t)b * S * W;
  const int KT = (W + kTK - 1) / kTK;  // k-tiles a head; tile t = h * KT + kt
  const int tiles = H * KT;
  // warps 0-7 run the projection (and, unless SPLIT, the core after it)
  const bool projection_warp = warp < kWarps;

  // the copies of tile t (head t / KT, k-tile t % KT) into stage t % stages
  // by the projection warps, one commit group a tile (an empty one past the
  // last tile, so that the count of groups in flight stays the same)
  auto issue = [&](int t) {
    if (!kRunCopies || t >= tiles) {
      cp_async_commit();
      return;
    }
    const int h = t / KT;
    const int k0 = (t - h * KT) * kTK;
    T* st = ring + (t % stages) * stage;
    T* wt = RESIDENT ? st : st + R * kXStride;
    constexpr int kSegChunks = D / kVec;
    constexpr int kRowChunks = 3 * kSegChunks;
    for (int idx = tid; idx < kTK * kRowChunks; idx += kThreads) {
      const int r = idx / kRowChunks;
      const int c = idx - r * kRowChunks;
      const int seg = c / kSegChunks;
      const int col = (c - seg * kSegChunks) * kVec;
      const bool ok = k0 + r < W;
      cp_async16(wt + r * kWStride + seg * D + col,
                 w + (size_t)(ok ? k0 + r : 0) * 3 * W + seg * W + h * D + col, ok);
    }
    if constexpr (!RESIDENT) {
      constexpr int kXChunks = kTK / kVec;
      for (int idx = tid; idx < R * kXChunks; idx += kThreads) {
        const int r = idx / kXChunks;
        const int col = (idx - r * kXChunks) * kVec;
        const bool ok = r < S && k0 + col < W;
        cp_async16(st + r * kXStride + col, xb + (ok ? (size_t)r * W + k0 + col : 0), ok);
      }
    }
    cp_async_commit();
  };

  if constexpr (RESIDENT) {
    const int chunks = W / kVec;
    for (int idx = tid; idx < R * chunks; idx += kBlockThreads) {
      const int r = idx / chunks;
      const int col = (idx - r * chunks) * kVec;
      const bool ok = r < S;
      cp_async16(sA + (size_t)r * (W + 8) + col, xb + (ok ? (size_t)r * W + col : 0), ok);
    }
    cp_async_commit();
  }
  if (projection_warp) {
    for (int t = 0; t + 1 < stages; ++t) issue(t);
    if constexpr (RESIDENT) cp_async_wait_dyn(stages - 1);  // x has landed
  } else if constexpr (RESIDENT) {
    cp_async_wait<0>();
  }
  if constexpr (RESIDENT) __syncthreads();

  // ---- row statistics, once an item: mean, then the centred variance
  for (int r = warp; r < R; r += kBlockThreads / 32) {
    float mean = 0.f, rstd = 0.f;
    if (r < S) {
      const T* xr = RESIDENT ? sA + (size_t)r * (W + 8) : xb + (size_t)r * W;
      float total = 0.f, sq = 0.f;
      for (int c = lane; c < W; c += 32) total += to_float(xr[c]);
      mean = warp_sum(total) / (float)W;
      for (int c = lane; c < W; c += 32) {
        const float d = to_float(xr[c]) - mean;
        sq = fmaf(d, d, sq);
      }
      rstd = rsqrtf(warp_sum(sq) / (float)W + eps);
    }
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
  }
  __syncthreads();
  if constexpr (RESIDENT) {
    // normalize and round the item's rows in place, 16 bytes a step; the
    // rows past S stay zero
    const int chunks = W / kVec;
    for (int idx = tid; idx < S * chunks; idx += kBlockThreads) {
      const int r = idx / chunks;
      const int c = (idx - r * chunks) * kVec;
      normalize16(sA + (size_t)r * (W + 8) + c, gamma + c, beta + c, mean_s[r], rstd_s[r]);
    }
    if constexpr (SPLIT) __syncthreads();  // (unsplit: the first tile's barrier)
  }

  // ---- the attention core of head h, one warp a 16-row query tile, by
  // `nwarps` warps from `first`
  auto core = [&](int h, int first, int nwarps) {
    for (int qt = warp - first; kRunCore && qt < MT; qt += nwarps) {
      float o[D / 8][4], m_run[2], l[2];
      attend_rows_tf32x3<D, HAS_BIAS>(sQ, sK, sV, bias, S, qt * 16, scale_log2e, lane, o, m_run, l);
      const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f;
      const float inv1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
      T* dst = out + ((size_t)b * S + qt * 16) * W + h * D;
      // staged in the warp's own (spent) q rows
      if constexpr (kBf16)
        store_rows<D>(reinterpret_cast<__nv_bfloat16*>(sQ + qt * 16 * kQStride), o, inv0, inv1, dst,
                      (size_t)W, S - qt * 16, lane);
      else
        store_rows_f32<D>(sQ + qt * 16 * kQStride, o, inv0, inv1, dst, (size_t)W, S - qt * 16, lane);
    }
  };

  if (SPLIT && !projection_warp) {
    // the core warps: the handover of every head's q, k, v
    bar_arrive(kBarEmpty, kSplitThreads);
    for (int h = 0; h < H; ++h) {
      bar_sync(kBarFull, kSplitThreads);
      core(h, kWarps, kWarps);
      bar_arrive(kBarEmpty, kSplitThreads);
    }
    return;
  }

  const int ng = warp % kNG;  // n-tiles 3 ng .. 3 ng + 2 of the head's 3D / 8
  const int mg = warp / kNG;  // m-tiles mg, mg + kMG, ...
  for (int h = 0; h < H; ++h) {
    // the accumulators live through the head's k-tiles only, not through
    // its attention core
    float acc[kMaxMT][3][4];
#pragma unroll
    for (int i = 0; i < kMaxMT; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      const int t = h * KT + kt;
      const int k0 = kt * kTK;
      cp_async_wait_dyn(stages - 2);
      // tile t has landed; every projection warp is done with tile t - 1's stage
      if constexpr (SPLIT)
        bar_sync(kBarProjection, kThreads);
      else
        __syncthreads();
      issue(t + stages - 1);
      T* st = ring + (t % stages) * stage;
      const T* wt = RESIDENT ? st : st + R * kXStride;
      const T* at = RESIDENT ? sA : st;
      const int astride = RESIDENT ? W + 8 : kXStride;
      const int acol = RESIDENT ? k0 : 0;
      if constexpr (!RESIDENT) {
        // normalize and round this x tile in place (rows past S stay zero)
        constexpr int kChunks = kTK / kVec;
        for (int idx = tid; idx < S * kChunks; idx += kThreads) {
          const int r = idx / kChunks;
          const int c = (idx - r * kChunks) * kVec;
          if (k0 + c < W)
            normalize16(st + r * kXStride + c, gamma + k0 + c, beta + k0 + c, mean_s[r], rstd_s[r]);
        }
        __syncthreads();
      }
      const int ksteps = min(kTK, W - k0) / kKStep;
#pragma unroll
      for (int ks = 0; ks < kTK / kKStep; ++ks) {
        if (kRunProjection && ks < ksteps) {
          if constexpr (kBf16) {
            // every fragment of the k-step first, then its products, so
            // that one wait covers all the loads
            uint32_t b01[4], b2[2], a[kMaxMT][4];
            load_b_kn(b01, wt, kWStride, ks * 16, ng * 24, lane);
            load_b_kn1(b2, wt, kWStride, ks * 16, ng * 24 + 16, lane);
#pragma unroll
            for (int i = 0; i < kMaxMT; ++i)
              if (mg + i * kMG < MT) load_a(a[i], at, astride, (mg + i * kMG) * 16, acol + ks * 16, lane);
#pragma unroll
            for (int i = 0; i < kMaxMT; ++i) {
              if (mg + i * kMG < MT) {
                mma_bf16(acc[i][0], a[i], b01[0], b01[1]);
                mma_bf16(acc[i][1], a[i], b01[2], b01[3]);
                mma_bf16(acc[i][2], a[i], b2[0], b2[1]);
              }
            }
          } else {
            // B of the natural k labels (rows k + t and k + t + 4, column
            // n + g): a row stride of 8 or 24 (mod 32) words keeps the
            // scalar loads on distinct banks
            uint32_t bh[3][2], bl[3][2];
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const float* p = reinterpret_cast<const float*>(wt) + (ks * 8 + t4) * kWStride +
                               (ng * 3 + j) * 8 + g;
              split_tf32(p[0], bh[j][0], bl[j][0]);
              split_tf32(p[4 * kWStride], bh[j][1], bl[j][1]);
            }
#pragma unroll
            for (int i = 0; i < kMaxMT; ++i) {
              const int mt = mg + i * kMG;
              if (mt < MT) {
                uint32_t xa[4], ah[4], al[4];
                load_a_f32(xa, reinterpret_cast<const float*>(at), astride, mt * 16, acol + ks * 8, lane);
                split_frag(xa, ah, al);
                // lo.hi', hi.lo', hi.hi': the three n-tiles side by side
#pragma unroll
                for (int j = 0; j < 3; ++j) mma_tf32(acc[i][j], al, bh[j][0], bh[j][1]);
#pragma unroll
                for (int j = 0; j < 3; ++j) mma_tf32(acc[i][j], ah, bl[j][0], bl[j][1]);
#pragma unroll
                for (int j = 0; j < 3; ++j) mma_tf32(acc[i][j], ah, bh[j][0], bh[j][1]);
              }
            }
          }
        }
      }
    }

    // ---- the head's q, k, v (+ wb) into fp32 tiles, never rounded, once
    // the core is done with the last head's
    if constexpr (SPLIT) bar_sync(kBarEmpty, kSplitThreads);
#pragma unroll
    for (int i = 0; i < kMaxMT; ++i) {
      const int mt = mg + i * kMG;
      if (mt < MT) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int col = (ng * 3 + j) * 8 + 2 * t4;  // of the head's 3D
          const int seg = col / D;
          const int d = col - seg * D;
          const T* bp = wb + seg * W + h * D + d;
          const float b0 = to_float(bp[0]), b1 = to_float(bp[1]);
          float* dst = (seg == 0 ? sQ : seg == 1 ? sK : sV) + (mt * 16 + g) * kQStride + d;
          *reinterpret_cast<float2*>(dst) = make_float2(acc[i][j][0] + b0, acc[i][j][1] + b1);
          *reinterpret_cast<float2*>(dst + 8 * kQStride) =
              make_float2(acc[i][j][2] + b0, acc[i][j][3] + b1);
        }
      }
    }
    if constexpr (SPLIT) {
      bar_arrive(kBarFull, kSplitThreads);
    } else {
      __syncthreads();
      core(h, 0, kWarps);
    }
  }
  // the last head's core is done before the block ends (kBarEmpty's last
  // arrival)
  if constexpr (SPLIT) bar_sync(kBarEmpty, kSplitThreads);
}

template <typename T, int D, bool HAS_BIAS, bool RESIDENT, bool SPLIT>
int launch_tc(const void* x, const void* gamma, const void* beta, const void* w, const void* wb,
              const float* bias, void* out, int B, int S, int H, float scale, float eps,
              cudaStream_t stream) {
  static bool smem_allowed[mma::kMaxDevices] = {};
  auto kernel = ln_qkv_attention_kernel_tc<T, D, HAS_BIAS, RESIDENT, SPLIT>;
  const int e = mma::allow_smem_once(kernel, (size_t)kMaxSmem, smem_allowed);
  if (e) return e;
  const size_t smem = tc_smem_bytes(S, H * D, D, sizeof(T), RESIDENT ? kResident : kStream);
  kernel<<<B, SPLIT ? kSplitThreads : kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<const T*>(w), static_cast<const T*>(wb), bias, static_cast<T*>(out), S, H,
      scale * mma::kLog2e, eps);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool RESIDENT, bool SPLIT>
int launch_tc_b(const void* x, const void* gamma, const void* beta, const void* w, const void* wb,
                const float* bias, void* out, int B, int S, int H, float scale, float eps,
                cudaStream_t s) {
  if (bias) return launch_tc<T, D, true, RESIDENT, SPLIT>(x, gamma, beta, w, wb, bias, out, B, S, H, scale, eps, s);
  return launch_tc<T, D, false, RESIDENT, SPLIT>(x, gamma, beta, w, wb, bias, out, B, S, H, scale, eps, s);
}

template <typename T, int D>
int launch_tc_d(const void* x, const void* gamma, const void* beta, const void* w, const void* wb,
                const float* bias, void* out, int B, int S, int H, float scale, float eps, int layout,
                cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (split_warps(S, layout))
      return launch_tc_b<T, D, true, true>(x, gamma, beta, w, wb, bias, out, B, S, H, scale, eps, s);
    if (layout == kResident)
      return launch_tc_b<T, D, true, false>(x, gamma, beta, w, wb, bias, out, B, S, H, scale, eps, s);
  }
  return launch_tc_b<T, D, false, false>(x, gamma, beta, w, wb, bias, out, B, S, H, scale, eps, s);
}

template <typename T>
int launch_tc_any(const void* x, const void* gamma, const void* beta, const void* w, const void* wb,
                  const float* bias, void* out, int B, int S, int H, int D, float scale, float eps,
                  int layout, cudaStream_t s) {
  switch (D) {
    case 16: return launch_tc_d<T, 16>(x, gamma, beta, w, wb, bias, out, B, S, H, scale, eps, layout, s);
    case 32: return launch_tc_d<T, 32>(x, gamma, beta, w, wb, bias, out, B, S, H, scale, eps, layout, s);
    default: return launch_tc_d<T, 64>(x, gamma, beta, w, wb, bias, out, B, S, H, scale, eps, layout, s);
  }
}

// ---------------------------------------------------------------- simt

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_qkv_attention_kernel_simt(const T* __restrict__ x, const T* __restrict__ gamma,
                        const T* __restrict__ beta, const T* __restrict__ w,
                        const T* __restrict__ wb, const float* __restrict__ bias,
                        T* __restrict__ out, int S, int H, int D, float scale, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int W = H * D;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int SP = tile_stride(S);
  const int ks_stride = key_stride(D);
  float* ws = smem;                     // [kTileK, D]   weight tile
  float* xs = ws + kTileK * D;          // [kTileK, SP]  normalized x tile, transposed
  float* qs = xs + kTileK * SP;         // [S, D]        q * scale
  float* ks = qs + S * D;               // [S, D|1]
  float* vs = ks + S * ks_stride;       // [S, D]
  float* ps = vs + S * D;               // [kWarps, S]   one probability row per warp
  float* mean_s = ps + kWarps * S;      // [S]
  float* rstd_s = mean_s + S;           // [S]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* xb = x + (size_t)b * S * W;

  // ---- row statistics: mean, then the variance of the centred values
  for (int r = warp; r < S; r += kWarps) {
    const T* xr = xb + (size_t)r * W;
    float total = 0.f;
    for (int c = lane; c < W; c += 32) total += to_float(xr[c]);
    const float mean = warp_sum(total) / (float)W;
    float sq = 0.f;
    for (int c = lane; c < W; c += 32) {
      const float d = to_float(xr[c]) - mean;
      sq = fmaf(d, d, sq);
    }
    const float var = warp_sum(sq) / (float)W;
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rsqrtf(var + eps);
    }
  }
  __syncthreads();

  // ---- q, k, v = ln . w[:, head's columns] + wb, one pass each
  const int tx = threadIdx.x % kRowStep;  // columns 4*tx .. 4*tx + 3
  const int ty = threadIdx.x / kRowStep;  // rows ty, ty + 16, ...
  const int slots = (S + kRowStep - 1) / kRowStep;
  const bool has_cols = 4 * tx < D;
  for (int pass = 0; pass < 3; ++pass) {
    float acc[kRowSlots][4];
#pragma unroll
    for (int i = 0; i < kRowSlots; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const T* wcol = w + (size_t)pass * W + h * D;  // row stride 3W

    for (int k0 = 0; k0 < W; k0 += kTileK) {
      __syncthreads();  // the previous tile is consumed
      for (int idx = threadIdx.x; idx < kTileK * (SP - 1); idx += kThreads) {
        const int kk = idx % kTileK;
        const int r = idx / kTileK;
        const int k = k0 + kk;
        float v = 0.f;
        if (r < S && k < W) {
          const float n = __fmul_rn(to_float(xb[(size_t)r * W + k]) - mean_s[r], rstd_s[r]);
          v = to_float(from_float<T>(
              __fadd_rn(__fmul_rn(n, to_float(gamma[k])), to_float(beta[k]))));
        }
        xs[kk * SP + r] = v;
      }
      for (int idx = threadIdx.x; idx < kTileK * D; idx += kThreads) {
        const int kk = idx / D;
        const int c = idx - kk * D;
        const int k = k0 + kk;
        ws[idx] = k < W ? to_float(wcol[(size_t)k * 3 * W + c]) : 0.f;
      }
      __syncthreads();
      if (has_cols) {
#pragma unroll 8
        for (int kk = 0; kk < kTileK; ++kk) {
          const float4 bv = *reinterpret_cast<const float4*>(ws + kk * D + 4 * tx);
          const float* col = xs + kk * SP + ty;
#pragma unroll
          for (int i = 0; i < kRowSlots; ++i) {
            if (i < slots) {
              const float a = col[i * kRowStep];
              acc[i][0] = fmaf(a, bv.x, acc[i][0]);
              acc[i][1] = fmaf(a, bv.y, acc[i][1]);
              acc[i][2] = fmaf(a, bv.z, acc[i][2]);
              acc[i][3] = fmaf(a, bv.w, acc[i][3]);
            }
          }
        }
      }
    }

    if (has_cols) {
      float add[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) add[j] = to_float(wb[(size_t)pass * W + h * D + 4 * tx + j]);
#pragma unroll
      for (int i = 0; i < kRowSlots; ++i) {
        const int r = ty + i * kRowStep;
        if (i < slots && r < S) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float v = acc[i][j] + add[j];
            const int c = 4 * tx + j;
            if (pass == 0) qs[r * D + c] = v * scale;
            else if (pass == 1) ks[r * ks_stride + c] = v;
            else vs[r * D + c] = v;
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- the attention core, one warp per query row (csrc/attention_fwd.cu)
  float* p = ps + warp * S;
  for (int i = warp; i < S; i += kWarps) {
    const float* q = qs + i * D;
    float lg[kKeySlots];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kKeySlots; ++t) {
      const int j = lane + 32 * t;
      float s = -INFINITY;
      if (j < S) {
        const float* kr = ks + j * ks_stride;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(q[d], kr[d], a);
        s = bias ? a + bias[i * S + j] : a;
      }
      lg[t] = s;
      m = fmaxf(m, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));

    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kKeySlots; ++t) {
      const int j = lane + 32 * t;
      const float e = j < S ? expf(lg[t] - m) : 0.f;
      lg[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < kKeySlots; ++t) {
      const int j = lane + 32 * t;
      if (j < S) p[j] = lg[t] / sum;
    }
    __syncwarp();

    T* orow = out + ((size_t)b * S + i) * W + h * D;
    for (int d = lane; d < D; d += 32) {
      float a = 0.f;
      for (int j = 0; j < S; ++j) a = fmaf(p[j], vs[j * D + d], a);
      orow[d] = from_float<T>(a);
    }
    __syncwarp();  // p is rewritten for the warp's next row
  }
}

template <typename T>
int launch_simt(const void* x, const void* gamma, const void* beta, const void* w, const void* wb,
           const float* bias, void* out, int B, int S, int H, int D, float scale, float eps,
           cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(S, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_qkv_attention_kernel_simt<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ln_qkv_attention_kernel_simt<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<const T*>(w), static_cast<const T*>(wb), bias, static_cast<T*>(out), S, H, D,
      scale, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a launch of these arguments takes, or 0
// for a combination the kernel does not take (`smem_bytes`).
extern "C" long long clip_ln_qkv_attention_smem_bytes(int S, int H, int D, int dtype, int variant,
                                                      int layout) {
  return smem_bytes(S, H, D, dtype, variant, layout);
}

// dtype: 0 = fp32, 1 = bf16; variant and layout as `smem_bytes`: the Python
// wrapper's choice (`mega_variant`, `mega_layout`), checked here. Returns
// cudaGetLastError() after the launch.
extern "C" int clip_ln_qkv_attention(const void* x, const void* gamma, const void* beta,
                                     const void* w, const void* wb, const void* bias, void* out,
                                     int B, int S, int H, int D, float scale, float eps, int dtype,
                                     int variant, int layout, void* stream) {
  if (B < 1 || smem_bytes(S, H, D, dtype, variant, layout) == 0)
    return (int)cudaErrorInvalidValue;
  const float* bias_f = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    if (dtype == 0)
      return launch_simt<float>(x, gamma, beta, w, wb, bias_f, out, B, S, H, D, scale, eps, s);
    return launch_simt<__nv_bfloat16>(x, gamma, beta, w, wb, bias_f, out, B, S, H, D, scale, eps, s);
  }
  if (dtype == 0)
    return launch_tc_any<float>(x, gamma, beta, w, wb, bias_f, out, B, S, H, D, scale, eps, layout, s);
  return launch_tc_any<__nv_bfloat16>(x, gamma, beta, w, wb, bias_f, out, B, S, H, D, scale, eps,
                                      layout, s);
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
