// Multi-head attention backward over the packed QKV projection for any
// sequence length (the head-grid kernel, K2), for sm_90a.
//
// Replaces the backward Pallas kernel of
// clip_event_tpu/ops/attention_pallas.py::fused_attention_qkv_headgrid
// (_hg_bwd_kernel, launched by _hg_bwd). Same contract:
//
//   qkv   [B, S, 3W]  fp32 or bf16, contiguous; q lanes [0, W), k [W, 2W),
//                     v [2W, 3W), head h at [h*D, (h+1)*D) within each
//   bias  [S, S]      fp32 additive mask (may hold -inf), or null; it gets
//                     no gradient
//   do    [B, S, W]   the output's cotangent, qkv's dtype
//   dqkv  [B, S, 3W]  written once in qkv's dtype: dq at lanes h*D, dk at
//                     W + h*D, dv at 2W + h*D, the layout of the TPU
//                     wrapper's concatenate([dq, dk, dv], -1)
//   stats [3, B, H, S] fp32 scratch: each query row's softmax max m, sum l
//                     and delta = rowsum(dO o O) (= rowsum(dP o P))
//
// The math is _hg_bwd_kernel's, every product and sum in fp32:
//   P  = softmax(q*scale . k^T + bias)     (recomputed, never stored)
//   dV = P^T . dO        dP = dO . V^T      dS = P o (dP - delta)
//   dQ = dS . K * scale  dK = dS^T . Q * scale
//
// Design. K1's backward (attention_bwd.cu) stages whole [S, D] tiles and
// stops at S = 128; here every pass walks the other side in tiles, as
// FlashAttention-2 does, so shared memory stays bounded whatever S is. Two
// launches:
//   1. dq pass: one block per (b, h, tile of 64 query rows) holds its
//      scaled q rows and dO rows. A first walk over K/V tiles runs the
//      forward's online softmax to get each row's m, l and output O (fp32,
//      never stored), and delta = dO . O. A second walk recomputes each
//      tile's P from m and l, forms dP and dS, and adds dS . K to the row's
//      dQ. The row's m, l and delta go to `stats`.
//   2. dkv pass: one block per (b, h, tile of 32 key rows) holds its K and
//      V rows and walks Q/dO tiles of 64 rows with their stats, recomputing
//      each column of P bitwise as pass 1 does (same operands, same order),
//      and adds P^T . dO to dV and dS^T . q*scale to dK.
// Each (b, h) owns its dq/dk/dv slices and each block its rows of them, so
// there are no atomics and the result is deterministic. q, k, v and dO are
// read by stride straight out of the packed rows; nothing is split,
// transposed or copied on the host.
//
// What bounds it: at the vision training shapes (S=197 W=768 H=12, S=257
// W=1024 H=16, D=64) the work is 10*B*H*S^2*D flops (12 with the forward
// recomputed in pass 1) against B*S*7W elements moved, so on the fp32 CUDA
// cores it is the operation rate and in bf16 the memory rate. This simple
// first version runs the products on the CUDA cores out of shared memory,
// so it is limited by shared-memory loads, far above either floor.
//
// Limits, checked by the Python wrapper too: D <= 128; any S >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kQTile = 64;   // query rows per dq block, and per dkv walk tile
constexpr int kKTile = 64;   // keys per dq walk tile
constexpr int kKRows = 32;   // key rows per dkv block
constexpr int kSlots = 2;    // 64 / 32: tile columns each lane holds
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

// Row stride of a tile whose rows the lanes of a warp read in parallel
// (one row per lane). Odd, so the 32 lanes hit 32 different banks.
__host__ __device__ __forceinline__ int tile_stride(int D) { return D | 1; }

__host__ __device__ __forceinline__ size_t dq_smem_floats(int D) {
  return 2 * (size_t)kKTile * tile_stride(D)  // K and V tiles
         + 3 * (size_t)kQTile * D             // scaled q, dO, O-then-dQ rows
         + 3 * (size_t)kQTile                 // m, l, delta per row
         + (size_t)kWarps * kKTile;           // one P (then dS) row per warp
}

__host__ __device__ __forceinline__ size_t dkv_smem_floats(int D) {
  return 2 * (size_t)kQTile * tile_stride(D)  // scaled q and dO tiles
         + 4 * (size_t)kKRows * D             // own K, V rows; dK, dV sums
         + 3 * (size_t)kQTile                 // m, l, delta of the q tile
         + 2 * (size_t)kWarps * kQTile;       // one P and one dS column per warp
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_hg_bwd_dq_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                           const T* __restrict__ dout, T* __restrict__ dqkv,
                           float* __restrict__ stats, int B, int S, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int W = H * D;
  const int tiles = (S + kQTile - 1) / kQTile;
  const int bh = blockIdx.x / tiles;
  const int i0 = (blockIdx.x - bh * tiles) * kQTile;
  const int b = bh / H;
  const int h = bh - b * H;
  const int st = tile_stride(D);
  float* ks = smem;                // [kKTile, D|1]
  float* vs = ks + kKTile * st;    // [kKTile, D|1]
  float* qs = vs + kKTile * st;    // [kQTile, D]  q * scale
  float* gs = qs + kQTile * D;     // [kQTile, D]  dO
  float* acc = gs + kQTile * D;    // [kQTile, D]  O (walk 1), then dQ (walk 2)
  float* ms = acc + kQTile * D;    // [kQTile]
  float* ls = ms + kQTile;         // [kQTile]
  float* dls = ls + kQTile;        // [kQTile]
  float* ps = dls + kQTile;        // [kWarps, kKTile]

  const size_t row = 3 * (size_t)W;
  const T* base = qkv + (size_t)b * S * row + h * D;
  const T* gbase = dout + (size_t)b * S * W + h * D;
  const int nq = min(kQTile, S - i0);
  for (int idx = threadIdx.x; idx < nq * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    qs[idx] = to_float(base[(size_t)(i0 + r) * row + d]) * scale;
    gs[idx] = to_float(gbase[(size_t)(i0 + r) * W + d]);
    acc[idx] = 0.f;
  }
  for (int r = threadIdx.x; r < kQTile; r += blockDim.x) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = ps + warp * kKTile;

  // ---- walk 1: the forward's online softmax → m, l, O per row
  for (int j0 = 0; j0 < S; j0 += kKTile) {
    const int nk = min(kKTile, S - j0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * D; idx += blockDim.x) {
      const int j = idx / D;
      const int d = idx - j * D;
      const T* r = base + (size_t)(j0 + j) * row + d;
      ks[j * st + d] = to_float(r[W]);
      vs[j * st + d] = to_float(r[2 * W]);
    }
    __syncthreads();
    for (int r = warp; r < nq; r += kWarps) {
      const int i = i0 + r;
      const float* q = qs + r * D;
      float s[kSlots];
      float tmax = -INFINITY;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int j = lane + 32 * t;
        float v = -INFINITY;
        if (j < nk) {
          const float* kr = ks + j * st;
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
      if (m_new == -INFINITY) continue;
      const float corr = expf(m_old - m_new);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int j = lane + 32 * t;
        const float e = j < nk ? expf(s[t] - m_new) : 0.f;
        if (j < nk) p[j] = e;
        psum += e;
      }
      psum = warp_sum(psum);
      __syncwarp();
      float* o = acc + r * D;
      for (int d = lane; d < D; d += 32) {
        float a = o[d] * corr;
        for (int j = 0; j < nk; ++j) a = fmaf(p[j], vs[j * st + d], a);
        o[d] = a;
      }
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = ls[r] * corr + psum;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // delta = dO . O per row; the row's O sums become its dQ sums
  for (int r = warp; r < nq; r += kWarps) {
    const float l = ls[r];
    float part = 0.f;
    for (int d = lane; d < D; d += 32) {
      part = fmaf(gs[r * D + d], acc[r * D + d] / l, part);
      acc[r * D + d] = 0.f;
    }
    part = warp_sum(part);
    if (lane == 0) dls[r] = part;
  }

  // ---- walk 2: P from m and l, dP, dS; dQ += dS . K
  for (int j0 = 0; j0 < S; j0 += kKTile) {
    const int nk = min(kKTile, S - j0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * D; idx += blockDim.x) {
      const int j = idx / D;
      const int d = idx - j * D;
      const T* r = base + (size_t)(j0 + j) * row + d;
      ks[j * st + d] = to_float(r[W]);
      vs[j * st + d] = to_float(r[2 * W]);
    }
    __syncthreads();
    for (int r = warp; r < nq; r += kWarps) {
      const int i = i0 + r;
      const float* q = qs + r * D;
      const float* g = gs + r * D;
      const float m = ms[r], l = ls[r], delta = dls[r];
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int j = lane + 32 * t;
        if (j < nk) {
          const float* kr = ks + j * st;
          const float* vr = vs + j * st;
          float a = 0.f, e = 0.f;
          for (int d = 0; d < D; ++d) a = fmaf(q[d], kr[d], a);
          const float sv = bias ? a + bias[(size_t)i * S + j0 + j] : a;
          for (int d = 0; d < D; ++d) e = fmaf(g[d], vr[d], e);
          const float pij = expf(sv - m) / l;
          p[j] = pij * (e - delta);
        }
      }
      __syncwarp();
      float* dq = acc + r * D;
      for (int d = lane; d < D; d += 32) {
        float a = dq[d];
        for (int j = 0; j < nk; ++j) a = fmaf(p[j], ks[j * st + d], a);
        dq[d] = a;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nq * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    dqkv[((size_t)b * S + i0 + r) * row + h * D + d] = from_float<T>(acc[idx] * scale);
  }
  const size_t bhs = (size_t)B * H * S;
  float* m_out = stats + (size_t)bh * S + i0;
  for (int r = threadIdx.x; r < nq; r += blockDim.x) {
    m_out[r] = ms[r];
    m_out[bhs + r] = ls[r];
    m_out[2 * bhs + r] = dls[r];
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_hg_bwd_dkv_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                            const T* __restrict__ dout, T* __restrict__ dqkv,
                            const float* __restrict__ stats, int B, int S, int H, int D,
                            float scale) {
  extern __shared__ float smem[];
  const int W = H * D;
  const int tiles = (S + kKRows - 1) / kKRows;
  const int bh = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - bh * tiles) * kKRows;
  const int b = bh / H;
  const int h = bh - b * H;
  const int st = tile_stride(D);
  float* qs = smem;                // [kQTile, D|1]  q * scale
  float* gs = qs + kQTile * st;    // [kQTile, D|1]  dO
  float* kr = gs + kQTile * st;    // [kKRows, D]    own k rows
  float* vr = kr + kKRows * D;     // [kKRows, D]    own v rows
  float* dk = vr + kKRows * D;     // [kKRows, D]
  float* dv = dk + kKRows * D;     // [kKRows, D]
  float* ms = dv + kKRows * D;     // [kQTile]
  float* ls = ms + kQTile;         // [kQTile]
  float* dls = ls + kQTile;        // [kQTile]
  float* pw = dls + kQTile;        // [kWarps, kQTile]
  float* dw = pw + kWarps * kQTile;  // [kWarps, kQTile]

  const size_t row = 3 * (size_t)W;
  const T* base = qkv + (size_t)b * S * row + h * D;
  const T* gbase = dout + (size_t)b * S * W + h * D;
  const int nk = min(kKRows, S - j0);
  for (int idx = threadIdx.x; idx < nk * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    const T* src = base + (size_t)(j0 + r) * row + d;
    kr[idx] = to_float(src[W]);
    vr[idx] = to_float(src[2 * W]);
    dk[idx] = 0.f;
    dv[idx] = 0.f;
  }
  const size_t bhs = (size_t)B * H * S;
  const float* m_in = stats + (size_t)bh * S;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = pw + warp * kQTile;
  float* dsc = dw + warp * kQTile;

  for (int i0 = 0; i0 < S; i0 += kQTile) {
    const int nq = min(kQTile, S - i0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nq * D; idx += blockDim.x) {
      const int i = idx / D;
      const int d = idx - i * D;
      qs[i * st + d] = to_float(base[(size_t)(i0 + i) * row + d]) * scale;
      gs[i * st + d] = to_float(gbase[(size_t)(i0 + i) * W + d]);
    }
    for (int i = threadIdx.x; i < nq; i += blockDim.x) {
      ms[i] = m_in[i0 + i];
      ls[i] = m_in[bhs + i0 + i];
      dls[i] = m_in[2 * bhs + i0 + i];
    }
    __syncthreads();

    for (int r = warp; r < nk; r += kWarps) {
      const int j = j0 + r;
      const float* k = kr + r * D;
      const float* v = vr + r * D;
      // column j of P and dS for query rows lane, lane+32 of the tile
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int i = lane + 32 * t;
        if (i < nq) {
          const float* qrow = qs + i * st;
          const float* grow = gs + i * st;
          float a = 0.f, e = 0.f;
          for (int d = 0; d < D; ++d) a = fmaf(qrow[d], k[d], a);
          const float sv = bias ? a + bias[(size_t)(i0 + i) * S + j] : a;
          for (int d = 0; d < D; ++d) e = fmaf(grow[d], v[d], e);
          const float pij = expf(sv - ms[i]) / ls[i];
          p[i] = pij;
          dsc[i] = pij * (e - dls[i]);
        }
      }
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float ak = dk[r * D + d], av = dv[r * D + d];
        for (int i = 0; i < nq; ++i) {
          ak = fmaf(dsc[i], qs[i * st + d], ak);
          av = fmaf(p[i], gs[i * st + d], av);
        }
        dk[r * D + d] = ak;
        dv[r * D + d] = av;
      }
      __syncwarp();  // P and dS are rewritten for the warp's next key row
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nk * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    T* dst = dqkv + ((size_t)b * S + j0 + r) * row + h * D + d;
    dst[W] = from_float<T>(dk[idx]);  // q was staged pre-scaled
    dst[2 * W] = from_float<T>(dv[idx]);
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)bytes);
}

template <typename T>
int launch(const void* qkv, const float* bias, const void* dout, void* dqkv, float* stats,
           int B, int S, int H, int D, float scale, cudaStream_t stream) {
  const size_t smem_dq = dq_smem_floats(D) * sizeof(float);
  const size_t smem_dkv = dkv_smem_floats(D) * sizeof(float);
  int e = allow_smem(attention_hg_bwd_dq_kernel<T>, smem_dq);
  if (e) return e;
  e = allow_smem(attention_hg_bwd_dkv_kernel<T>, smem_dkv);
  if (e) return e;
  const long long dq_blocks = (long long)B * H * ((S + kQTile - 1) / kQTile);
  const long long dkv_blocks = (long long)B * H * ((S + kKRows - 1) / kKRows);
  if (dkv_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const T* q = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  T* dq = static_cast<T*>(dqkv);
  attention_hg_bwd_dq_kernel<T><<<(unsigned)dq_blocks, kWarps * 32, smem_dq, stream>>>(
      q, bias, g, dq, stats, B, S, H, D, scale);
  e = (int)cudaGetLastError();
  if (e) return e;
  attention_hg_bwd_dkv_kernel<T><<<(unsigned)dkv_blocks, kWarps * 32, smem_dkv, stream>>>(
      q, bias, g, dq, stats, B, S, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Launches the dq pass, then the dkv pass, on
// `stream`; returns the first launch error, or 0.
extern "C" int clip_attention_hg_bwd(const void* qkv, const void* bias, const void* dout,
                                     void* dqkv, void* stats, int B, int S, int H, int D,
                                     float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > kMaxD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* bias_f = static_cast<const float*>(bias);
  float* stats_f = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(qkv, bias_f, dout, dqkv, stats_f, B, S, H, D, scale, s);
  return launch<__nv_bfloat16>(qkv, bias_f, dout, dqkv, stats_f, B, S, H, D, scale, s);
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
