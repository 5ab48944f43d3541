// Multi-head attention forward over the packed QKV projection for any
// sequence length (the head-grid kernel, K2), for sm_90a.
//
// Replaces the forward Pallas kernel of
// clip_event_tpu/ops/attention_pallas.py::fused_attention_qkv_headgrid
// (_hg_fwd_kernel, launched by _hg_fwd). Same contract as K1:
//
//   qkv  [B, S, 3W]  fp32 or bf16, contiguous; q lanes [0, W), k [W, 2W),
//                    v [2W, 3W), head h at [h*D, (h+1)*D) within each
//   bias [S, S]      fp32 additive mask (may hold -inf), or null
//   out  [B, S, W]   softmax(q . k^T * scale + bias) . v per head, heads
//                    concatenated along the lanes, in qkv's dtype
//   lse  [B, H, S]   fp32, optional (tensor-core variants only): each row's
//                    log-sum-exp of its scaled, biased scores, natural log;
//                    the backward reads it instead of recomputing the
//                    softmax statistics
//
// Why a second kernel beside K1. K1 (attention_fwd.cu) stages a head's
// whole K and V in shared memory, which stops at S = 128; the ViT-B/16 and
// ViT-L/14 vision towers have S = 197 and 257. The TPU kernel answered its
// VMEM limit by taking one 128-lane head group per program. On Hopper the
// answer is a FlashAttention-style walk: one block per (batch item, head,
// tile of 64 query rows), K and V passing through shared memory 64 keys at
// a time under an online softmax, so shared memory is bounded whatever S
// is. q, k and v are read by stride straight out of the packed rows and
// the output is written to the head's D lanes: nothing is split,
// transposed or copied on the host.
//
// What bounds it. At the vision shapes (S=197 W=768 H=12, S=257 W=1024
// H=16, D=64) the work is 4*B*H*S^2*D flops against B*S*4W elements moved,
// ~2*S/3 flops per element. In bf16 on the tensor cores (989 TFLOP/s) that
// is under the card's 295 flops per byte: the bound is the memory rate,
// 0.0402 ms at ViT-L/14's B=64 on the NVIDIA H100 80GB HBM3. fp32 work to
// fp32 accuracy is bound by the operation rate: three TF32 products a term
// (495 TFLOP/s / 3 = 165), or 67 TFLOP/s on the CUDA cores; 0.1049 ms at
// that shape by the first.
//
// Three hand-written variants, chosen by dtype and head_dim alone before
// anything launches (`clip_attention_hg_variant`; the Python wrapper's
// `headgrid_variant` mirrors it). None gives way to another.
//
// "mma": bf16 with D in {16, 32, 64, 128}, on the tensor cores:
// Hopper's warpgroup MMA (wgmma) fed by TMA, the device routine
// `wg::attend_fwd` of attention_wgmma.cuh, which K1 wraps too (the design
// and what it does about the bound are there). Where the kernel it
// replaced ran one block a 64-row query tile and re-read the head's K and
// V for each (5 times at S = 257, for one row of work in the fifth), a
// head's K and V now pass through shared memory once: persistent blocks,
// one an SM, walk the B * H heads, a producer thread loads each head's
// 64-key chunks by TMA into a ring of slots (eleven at D = 64: two heads at
// S = 257) while three consumer warpgroups walk every query tile of the
// head against them under an online softmax. A head longer than the ring
// (S > 704 at D = 64, 320 at D = 128) is walked in passes of one tile a
// warpgroup, its chunks loaded again each pass.
//
// "tf32x3": fp32 with D in {16, 32, 64, 128}, on the tensor cores in split
// TF32 (mma.sync.m16n8k8 tf32, three products a term; helpers and the
// error argument in attention_mma.cuh), held to the same 1e-5 as the fp32
// plain version. One block of 4 warps per (batch item, head, 64-row query
// tile), each warp owning 16 query rows for the whole walk, with the
// output accumulator, running max and running sum in registers; K and V
// pass through a two-stage cp.async ring of 64-key fp32 tiles (rows
// padded to D + 4 floats, 85 KB a block at D = 64, so two blocks share an
// SM; 165 KB at D = 128, one block an SM); scores stay fp32 in the
// accumulators, where scale, bias and the -inf masks of keys past S are
// applied, with the online softmax over the 4 lanes that share a row;
// tile rows past S are zero-filled by cp.async (src-size 0), never stale.
// In split TF32:
//   * Q's hi and lo fragments are split once and held at D <= 64; at
//     D = 128 they are reloaded and split per k-step of each key tile.
//   * K's fragments come by ldmatrix and are split per use; scores stay
//     fp32 in the accumulators, where scale, bias and the -inf masks are
//     applied, so nothing infinite is split.
//   * Each 8-key tile of P is split in registers into the A operand of
//     P.V over relabelled keys; V's B fragments by scalar shared loads.
//   * O / l in fp32, staged in the warp's own Q rows, 16-byte stores.
//   * __launch_bounds__ names a least of one block an SM: with the block
//     size alone ptxas spilled registers to reach an occupancy step (128 or
//     168 registers) that shared memory rules out anyway.
//
// "simt": bf16 and fp32 with another head_dim (1, 2, 4 or 8). Every
// product and sum is fp32 on the CUDA cores out of shared memory (a
// broadcast q or p value and one K or V value per FMA), q scaled before
// the dot product. It is limited by shared-memory loads.
//
// Limits, checked by the Python wrapper too: D <= 128; any S >= 1; the mma
// and tf32x3 variants need 16-byte-aligned qkv and out, and the mma
// variant's TMA a row pitch (6W bytes) that is a multiple of 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"
#include "attention_wgmma.cuh"

namespace {

// ---------------------------------------------------------------- mma

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(wg::Geo<D>::kThreads, 1)
attention_hg_fwd_kernel_wgmma(const __grid_constant__ wg::FwdParams p) {
  wg::attend_fwd<D, HAS_BIAS>(p);
}

template <int D>
int launch_wgmma(const void* qkv, const float* bias, void* out, float* lse, int B, int S, int H, float scale,
                 cudaStream_t stream) {
  static bool smem_allowed[2][wg::kMaxDevices] = {};
  if (bias != nullptr)
    return wg::launch_fwd<D>(attention_hg_fwd_kernel_wgmma<D, true>, smem_allowed[1], qkv, bias, out, lse, B, S,
                             H, scale, stream);
  return wg::launch_fwd<D>(attention_hg_fwd_kernel_wgmma<D, false>, smem_allowed[0], qkv, bias, out, lse, B, S, H,
                           scale, stream);
}

// ---------------------------------------------------------------- tf32x3

template <int D>
constexpr size_t fwd_tf32x3_smem_bytes() {
  // Q tile + two stages of K and V tiles, fp32
  return (size_t)5 * mma::kTile * (D + mma::kPadF) * sizeof(float);
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(mma::kThreads, 1)
attention_hg_fwd_kernel_tf32x3(const float* __restrict__ qkv, const float* __restrict__ bias,
                               float* __restrict__ out, float* __restrict__ lse, int S, int H,
                               float scale_log2e) {
  using namespace mma;
  constexpr int kStride = D + kPadF;
  constexpr int kSteps = D / 8;      // k-steps of 8 over the head dim
  constexpr int kKeyTiles = kTile / 8;  // 8-key n-tiles of a key tile
  constexpr bool kHold = D <= 64;    // Q's split fragments stay in registers
  constexpr int kHeld = kHold ? kSteps : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [64][D+4]
  float* sK = sQ + kTile * kStride;                // [2][64][D+4]
  float* sV = sK + 2 * kTile * kStride;            // [2][64][D+4]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int W = H * D;
  const int q_tiles = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x / q_tiles;
  const int i0 = (blockIdx.x - bh * q_tiles) * kTile;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row = 3 * (size_t)W;
  const float* base = qkv + (size_t)b * S * row + h * D;
  const int nq = min(kTile, S - i0);
  const int k_tiles = q_tiles;

  load_tile_f32<D>(sQ, base + (size_t)i0 * row, row, nq, tid);
  load_tile_f32<D>(sK, base + W, row, min(kTile, S), tid);
  load_tile_f32<D>(sV, base + 2 * W, row, min(kTile, S), tid);
  cp_async_commit();

  const bool active = warp * 16 < nq;
  const int row_g = i0 + warp * 16 + g;
  uint32_t qh[kHeld][4], ql[kHeld][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      const int stage = (kt + 1) & 1;
      const int j1 = (kt + 1) * kTile;
      load_tile_f32<D>(sK + stage * kTile * kStride, base + (size_t)j1 * row + W, row,
                       min(kTile, S - j1), tid);
      load_tile_f32<D>(sV + stage * kTile * kStride, base + (size_t)j1 * row + 2 * W, row,
                       min(kTile, S - j1), tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      if constexpr (kHold) {
        if (kt == 0) {
#pragma unroll
          for (int ks = 0; ks < kSteps; ++ks) {
            uint32_t x[4];
            load_a_f32(x, sQ, kStride, warp * 16, ks * 8, lane);
            split_frag(x, qh[ks], ql[ks]);
          }
        }
      }
      const float* ks_tile = sK + (kt & 1) * kTile * kStride;
      const float* vs_tile = sV + (kt & 1) * kTile * kStride;
      const int j0 = kt * kTile;
      const int nk = min(kTile, S - j0);
      // one key tile; `full` (a compile-time bool) drops the guards that
      // skip key pairs and tiles past S, so that a full tile's products
      // share one basic block and interleave; only the last tile is partial
      auto key_tile = [&](auto full) {
        constexpr bool kFull = decltype(full)::value;
        // scores of 16 rows x 64 keys, fp32
        float s[kKeyTiles][4];
#pragma unroll
        for (int n = 0; n < kKeyTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          uint32_t ah[4], al[4];
          if constexpr (kHold) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ah[i] = qh[ks % kHeld][i];
              al[i] = ql[ks % kHeld][i];
            }
          } else {
            uint32_t x[4];
            load_a_f32(x, sQ, kStride, warp * 16, ks * 8, lane);
            split_frag(x, ah, al);
          }
#pragma unroll
          for (int p = 0; p < kKeyTiles / 2; ++p) {
            if (kFull || p * 16 < nk) {
              uint32_t x[4], fh[4], fl[4];
              load_b_nk_f32(x, ks_tile, kStride, p * 16, ks * 8, lane);
              split_frag(x, fh, fl);
              mma_tf32x3_x2(s[2 * p], s[2 * p + 1], ah, al, fh, fl);
            }
          }
        }

        // scale, bias, the key tail's mask, in units of log2 (on the
        // accumulators: nothing infinite is ever split)
#pragma unroll
        for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j0 + n * 8 + 2 * t4 + (e & 1);
            float v = s[n][e] * scale_log2e;
            if constexpr (HAS_BIAS) {
              const int r = row_g + 8 * (e >> 1);
              if (r < S && col < S) v += bias[(size_t)r * S + col] * kLog2e;
            }
            if (!kFull && col >= S) v = -INFINITY;
            s[n][e] = v;
          }
        }

        // online softmax per row (rows row_g and row_g + 8), as the mma variant
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
          mx = quad_max(mx);
          const float m_new = fmaxf(m_run[r], mx);
          const float m_safe = m_new == -INFINITY ? 0.f : m_new;
          const float corr = exp2f(m_run[r] - m_safe);
          m_run[r] = m_new;
          float psum = 0.f;
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n) {
            const float p0 = exp2f(s[n][2 * r] - m_safe);
            const float p1 = exp2f(s[n][2 * r + 1] - m_safe);
            s[n][2 * r] = p0;
            s[n][2 * r + 1] = p1;
            psum += p0 + p1;
          }
          l_run[r] = l_run[r] * corr + psum;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            o[n][2 * r] *= corr;
            o[n][2 * r + 1] *= corr;
          }
        }

        // O += P . V: each 8-key tile of P, split in registers, is an A
        // operand over relabelled keys; V's B fragments by scalar loads
#pragma unroll
        for (int n = 0; n < kKeyTiles; ++n) {
          if (kFull || n * 8 < nk) {
            uint32_t ph[4], pl[4];
            split_acc(s[n], ph, pl);
#pragma unroll
            for (int dn = 0; dn < D / 8; dn += 2) {
              uint32_t vh[2], vl[2], wh[2], wl[2];
              load_b_kn_f32(vh, vl, vs_tile, kStride, n * 8, dn * 8, lane);
              load_b_kn_f32(wh, wl, vs_tile, kStride, n * 8, dn * 8 + 8, lane);
              mma_tf32x3_2(o[dn], ph, pl, vh[0], vh[1], vl[0], vl[1], o[dn + 1], ph, pl, wh[0], wh[1],
                           wl[0], wl[1]);
            }
          }
        }
      };
      if (nk == kTile)
        key_tile(std::true_type());
      else
        key_tile(std::false_type());
    }
    __syncthreads();
  }

  if (active) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_run[r]);
      inv[r] = l > 0.f ? 1.f / l : 0.f;
      const int ri = row_g + 8 * r;
      if (lse != nullptr && t4 == 0 && ri < S)
        lse[(size_t)bh * S + ri] = l > 0.f ? m_run[r] * kLn2 + logf(l) : 0.f;
    }
    store_rows_f32<D>(sQ + warp * 16 * kStride, o, inv[0], inv[1],
                      out + ((size_t)b * S + i0 + warp * 16) * W + h * D, (size_t)W,
                      nq - warp * 16, lane);
  }
}

template <int D, bool HAS_BIAS>
int launch_tf32x3(const void* qkv, const float* bias, void* out, float* lse, int B, int S, int H,
                  float scale, cudaStream_t stream) {
  static bool smem_allowed[mma::kMaxDevices] = {};
  auto kernel = attention_hg_fwd_kernel_tf32x3<D, HAS_BIAS>;
  constexpr size_t smem = fwd_tf32x3_smem_bytes<D>();
  const int e = mma::allow_smem_once(kernel, smem, smem_allowed);
  if (e) return e;
  const long long blocks = (long long)B * H * ((S + mma::kTile - 1) / mma::kTile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, mma::kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), bias, static_cast<float*>(out), lse, S, H, scale * mma::kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tf32x3_d(const void* qkv, const float* bias, void* out, float* lse, int B, int S, int H,
                    float scale, cudaStream_t stream) {
  if (bias != nullptr) return launch_tf32x3<D, true>(qkv, bias, out, lse, B, S, H, scale, stream);
  return launch_tf32x3<D, false>(qkv, bias, out, lse, B, S, H, scale, stream);
}

// ---------------------------------------------------------------- simt


constexpr int kWarps = 8;
constexpr int kQTile = 64;  // query rows per block
constexpr int kKTile = 64;  // keys per shared-memory tile
constexpr int kKeySlots = kKTile / 32;
constexpr int kMaxD = 128;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Row stride of the staged K tile. Odd, so the 32 lanes of a warp, each
// reading column d of a different key row, hit 32 different banks.
__host__ __device__ __forceinline__ int key_stride(int D) { return D | 1; }

__host__ __device__ __forceinline__ size_t smem_floats(int D) {
  return (size_t)kKTile * key_stride(D)  // K tile
         + (size_t)kKTile * D            // V tile
         + (size_t)kQTile * D            // scaled q rows
         + (size_t)kQTile * D            // unnormalized output rows
         + 2 * (size_t)kQTile            // running max and sum per row
         + (size_t)kWarps * kKTile;      // one probability row per warp
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_hg_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                        T* __restrict__ out, int S, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int W = H * D;
  const int tiles = (S + kQTile - 1) / kQTile;
  const int bh = blockIdx.x / tiles;
  const int i0 = (blockIdx.x - bh * tiles) * kQTile;
  const int b = bh / H;
  const int h = bh - b * H;
  const int ks_stride = key_stride(D);
  float* ks = smem;                     // [kKTile, D|1]
  float* vs = ks + kKTile * ks_stride;  // [kKTile, D]
  float* qs = vs + kKTile * D;          // [kQTile, D]
  float* acc = qs + kQTile * D;         // [kQTile, D]
  float* ms = acc + kQTile * D;         // [kQTile]
  float* ls = ms + kQTile;              // [kQTile]
  float* ps = ls + kQTile;              // [kWarps, kKTile]

  const size_t row = 3 * (size_t)W;  // packed rows are 3W apart, not W
  const T* base = qkv + (size_t)b * S * row + h * D;
  const int nq = min(kQTile, S - i0);

  for (int idx = threadIdx.x; idx < nq * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    qs[idx] = to_float(base[(size_t)(i0 + r) * row + d]) * scale;
    acc[idx] = 0.f;
  }
  for (int r = threadIdx.x; r < kQTile; r += blockDim.x) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = ps + warp * kKTile;

  for (int j0 = 0; j0 < S; j0 += kKTile) {
    const int nk = min(kKTile, S - j0);
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int idx = threadIdx.x; idx < nk * D; idx += blockDim.x) {
      const int j = idx / D;
      const int d = idx - j * D;
      const T* r = base + (size_t)(j0 + j) * row + d;
      ks[j * ks_stride + d] = to_float(r[W]);
      vs[j * D + d] = to_float(r[2 * W]);
    }
    __syncthreads();

    for (int r = warp; r < nq; r += kWarps) {
      const int i = i0 + r;
      const float* q = qs + r * D;
      float s[kKeySlots];
      float tmax = -INFINITY;
#pragma unroll
      for (int t = 0; t < kKeySlots; ++t) {
        const int j = lane + 32 * t;
        float v = -INFINITY;
        if (j < nk) {
          const float* kr = ks + j * ks_stride;
          float a = 0.f;
          for (int d = 0; d < D; ++d) a = fmaf(q[d], kr[d], a);
          v = bias ? a + bias[(size_t)i * S + j0 + j] : a;
        }
        s[t] = v;
        tmax = fmaxf(tmax, v);
      }
      tmax = warp_max(tmax);
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, tmax);
      if (m_new == -INFINITY) continue;  // warp-uniform: no unmasked key yet
      const float corr = expf(m_old - m_new);  // 0 while m_old is -inf
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < kKeySlots; ++t) {
        const int j = lane + 32 * t;
        const float e = j < nk ? expf(s[t] - m_new) : 0.f;
        if (j < nk) p[j] = e;
        psum += e;
      }
      psum = warp_sum(psum);
      __syncwarp();  // p is complete; every lane has read ms[r]

      float* o = acc + r * D;
      for (int d = lane; d < D; d += 32) {
        float a = o[d] * corr;
        for (int j = 0; j < nk; ++j) a = fmaf(p[j], vs[j * D + d], a);
        o[d] = a;
      }
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = ls[r] * corr + psum;
      }
      __syncwarp();  // p is rewritten for the warp's next row
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nq * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    out[((size_t)b * S + i0 + r) * W + h * D + d] = from_float<T>(acc[idx] / ls[r]);
  }
}

template <typename T>
int launch(const void* qkv, const float* bias, void* out, int B, int S, int H, int D,
           float scale, cudaStream_t stream) {
  // one kernel serves every D: allow the most it can ask for, once
  static bool smem_allowed[mma::kMaxDevices] = {};
  const int e = mma::allow_smem_once(attention_hg_fwd_kernel<T>, smem_floats(kMaxD) * sizeof(float),
                                     smem_allowed);
  if (e) return e;
  const size_t smem = smem_floats(D) * sizeof(float);
  const int tiles = (S + kQTile - 1) / kQTile;
  const long long blocks = (long long)B * H * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  attention_hg_fwd_kernel<T><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), bias, static_cast<T*>(out), S, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The variant that takes (dtype, D): 1 = "mma" (bf16 on the tensor cores,
// wgmma), 2 = "tf32x3" (fp32 on the tensor cores, split TF32), 0 = "simt"
// (the CUDA cores). dtype: 0 = fp32, 1 = bf16.
extern "C" int clip_attention_hg_variant(int dtype, int D) {
  if (D != 16 && D != 32 && D != 64 && D != 128) return 0;
  return dtype == 1 ? 1 : dtype == 0 ? 2 : 0;
}

// dtype: 0 = fp32, 1 = bf16. `lse` may be null; the CUDA-core variant does
// not write it. Returns cudaGetLastError() after the launch.
extern "C" int clip_attention_hg_fwd(const void* qkv, const void* bias, void* out, void* lse, int B,
                                     int S, int H, int D, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > kMaxD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* bias_f = static_cast<const float*>(bias);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (clip_attention_hg_variant(dtype, D)) {
    case 1:
      switch (D) {
        case 16: return launch_wgmma<16>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
        case 32: return launch_wgmma<32>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
        case 64: return launch_wgmma<64>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
        default: return launch_wgmma<128>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
      }
    case 2:
      switch (D) {
        case 16: return launch_tf32x3_d<16>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
        case 32: return launch_tf32x3_d<32>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
        case 64: return launch_tf32x3_d<64>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
        default: return launch_tf32x3_d<128>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
      }
    default:
      break;
  }
  if (dtype == 0) return launch<float>(qkv, bias_f, out, B, S, H, D, scale, s);
  return launch<__nv_bfloat16>(qkv, bias_f, out, B, S, H, D, scale, s);
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
