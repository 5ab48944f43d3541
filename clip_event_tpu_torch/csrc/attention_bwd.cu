// Multi-head attention backward over the packed QKV projection, for sm_90a.
//
// Replaces the backward Pallas kernel of
// clip_event_tpu/ops/attention_pallas.py::fused_attention_qkv
// (_bwd_kernel, launched by _fused_qkv_bwd). Same contract:
//
//   qkv   [B, S, 3W]  fp32 or bf16, contiguous; q lanes [0, W), k [W, 2W),
//                     v [2W, 3W), head h at [h*D, (h+1)*D) within each
//   bias  [S, S]      fp32 additive mask, or null (it gets no gradient)
//   do    [B, S, W]   the output's cotangent, qkv's dtype
//   dqkv  [B, S, 3W]  written once, packed like qkv, in qkv's dtype
//   stats [3, B, H, S] fp32 scratch: the softmax row max m, row sum l and
//                     delta = rowsum(dP o P) of every query row
//
// The math is _bwd_kernel's, every product and sum in fp32:
//   P  = softmax(q*scale . k^T + bias)     (recomputed, never stored)
//   dV = P^T . dO        dP = dO . V^T      dS = P o (dP - rowsum(dP o P))
//   dQ = dS . K * scale  dK = dS^T . Q * scale
//
// Design. One (batch item, head) needs q, k, v and dO staged to form dQ and
// dK/dV together; at S = D = 128 in fp32 that is 4*128*129*4 B = 264 KB,
// more than the 227 KB a block may use. So the work is split in two
// launches, as FlashAttention-2 splits its backward, each staging two of
// the four [S, D] tiles:
//   1. dq pass: one block per (b, h) stages K and V. Each warp takes query
//      rows: it recomputes that row of P with the forward's exact
//      arithmetic, forms dP and dS for the row in registers, writes the dQ
//      row, and saves the row's m, l and delta to `stats`.
//   2. dkv pass: one block per (b, h) stages Q (pre-scaled) and dO, plus
//      the stats. Each warp takes key rows j: it recomputes column j of P
//      from m and l (bitwise the values of pass 1), forms dS for the
//      column, and writes the dK and dV rows.
// Each (b, h) owns its whole dq/dk/dv slice, so there are no atomics and the
// result is deterministic. q, k, v and dO are read by stride straight out
// of the packed rows; nothing is split, transposed or copied on the host.
//
// What bounds it: at the training shapes (text S=77 D=64, vision S=50
// D=64) the work is 10*B*H*S^2*D flops against B*S*7W elements moved, a
// few flops per byte, so the memory rate is the card's floor. This simple
// first version runs the inner products on the CUDA cores out of shared
// memory (one shared load per operand per FMA), so it is limited by
// shared-memory loads, far above that floor.
//
// Limits, checked by the Python wrapper too: S <= 128, D <= 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxS = 128;
constexpr int kMaxD = 128;
constexpr int kSlots = kMaxS / 32;  // rows of P (or columns) each lane holds

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

// Row stride of a staged [S, D] tile. Odd, so the 32 lanes of a warp, each
// reading column d of a different row, hit 32 different banks.
__host__ __device__ __forceinline__ int tile_stride(int D) { return D | 1; }

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                        const T* __restrict__ dout, T* __restrict__ dqkv,
                        float* __restrict__ stats, int S, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int W = H * D;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int st = tile_stride(D);
  float* ks = smem;              // [S, D|1]
  float* vs = ks + S * st;       // [S, D|1]
  float* qs = vs + S * st;       // [kWarps, D]  one scaled q row per warp
  float* gs = qs + kWarps * D;   // [kWarps, D]  one dO row per warp
  float* ds = gs + kWarps * D;   // [kWarps, S]  one dS row per warp

  const size_t row = 3 * (size_t)W;  // packed rows are 3W apart, not W
  const T* base = qkv + (size_t)b * S * row + h * D;
  for (int idx = threadIdx.x; idx < S * D; idx += blockDim.x) {
    const int j = idx / D;
    const int d = idx - j * D;
    const T* r = base + (size_t)j * row + d;
    ks[j * st + d] = to_float(r[W]);
    vs[j * st + d] = to_float(r[2 * W]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* q = qs + warp * D;
  float* g = gs + warp * D;
  float* dsr = ds + warp * S;
  const size_t bhs = (size_t)gridDim.x * S;  // B*H*S
  float* m_out = stats + (size_t)blockIdx.x * S;
  float* l_out = m_out + bhs;
  float* delta_out = l_out + bhs;

  for (int i = warp; i < S; i += kWarps) {
    const T* qrow = base + (size_t)i * row;
    const T* grow = dout + ((size_t)b * S + i) * W + h * D;
    for (int d = lane; d < D; d += 32) {
      q[d] = to_float(qrow[d]) * scale;
      g[d] = to_float(grow[d]);
    }
    __syncwarp();

    // logits and dP for keys lane, lane+32, ...; the padding slots hold
    // -inf (logit) and 0 (dP), so they drop out of every reduction
    float lg[kSlots], dp[kSlots];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int j = lane + 32 * t;
      float s = -INFINITY, e = 0.f;
      if (j < S) {
        const float* kr = ks + j * st;
        const float* vr = vs + j * st;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(q[d], kr[d], acc);
        s = bias ? acc + bias[i * S + j] : acc;
        for (int d = 0; d < D; ++d) e = fmaf(g[d], vr[d], e);
      }
      lg[t] = s;
      dp[t] = e;
      m = fmaxf(m, s);
    }
    m = warp_max(m);

    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const float e = lane + 32 * t < S ? expf(lg[t] - m) : 0.f;
      lg[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);

    float delta = 0.f;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      lg[t] = lg[t] / sum;  // P, exactly as the forward forms it
      delta = fmaf(lg[t], dp[t], delta);
    }
    delta = warp_sum(delta);
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int j = lane + 32 * t;
      if (j < S) dsr[j] = lg[t] * (dp[t] - delta);
    }
    __syncwarp();

    T* dq = dqkv + ((size_t)b * S + i) * row + h * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(dsr[j], ks[j * st + d], acc);
      dq[d] = from_float<T>(acc * scale);
    }
    if (lane == 0) {
      m_out[i] = m;
      l_out[i] = sum;
      delta_out[i] = delta;
    }
    __syncwarp();  // q, g and dS are rewritten for the warp's next row
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dkv_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                         const T* __restrict__ dout, T* __restrict__ dqkv,
                         const float* __restrict__ stats, int S, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int W = H * D;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int st = tile_stride(D);
  float* qs = smem;              // [S, D|1]  q * scale
  float* gs = qs + S * st;       // [S, D|1]  dO
  float* ms = gs + S * st;       // [S]       row max
  float* ls = ms + S;            // [S]       row sum
  float* dls = ls + S;           // [S]       delta
  float* kw = dls + S;           // [kWarps, D]  one k row per warp
  float* vw = kw + kWarps * D;   // [kWarps, D]  one v row per warp
  float* pw = vw + kWarps * D;   // [kWarps, S]  one column of P per warp
  float* dw = pw + kWarps * S;   // [kWarps, S]  one column of dS per warp

  const size_t row = 3 * (size_t)W;
  const T* base = qkv + (size_t)b * S * row + h * D;
  const T* gbase = dout + (size_t)b * S * W + h * D;
  for (int idx = threadIdx.x; idx < S * D; idx += blockDim.x) {
    const int i = idx / D;
    const int d = idx - i * D;
    qs[i * st + d] = to_float(base[(size_t)i * row + d]) * scale;
    gs[i * st + d] = to_float(gbase[(size_t)i * W + d]);
  }
  const size_t bhs = (size_t)gridDim.x * S;
  const float* m_in = stats + (size_t)blockIdx.x * S;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    ms[i] = m_in[i];
    ls[i] = m_in[bhs + i];
    dls[i] = m_in[2 * bhs + i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* k = kw + warp * D;
  float* v = vw + warp * D;
  float* p = pw + warp * S;
  float* dsc = dw + warp * S;

  for (int j = warp; j < S; j += kWarps) {
    const T* krow = base + (size_t)j * row + W;
    for (int d = lane; d < D; d += 32) {
      k[d] = to_float(krow[d]);
      v[d] = to_float(krow[W + d]);
    }
    __syncwarp();

    // column j of P and dS for query rows lane, lane+32, ...
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int i = lane + 32 * t;
      if (i < S) {
        const float* qr = qs + i * st;
        const float* gr = gs + i * st;
        float acc = 0.f, e = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], k[d], acc);
        const float s = bias ? acc + bias[i * S + j] : acc;
        const float pij = expf(s - ms[i]) / ls[i];
        for (int d = 0; d < D; ++d) e = fmaf(gr[d], v[d], e);
        p[i] = pij;
        dsc[i] = pij * (e - dls[i]);
      }
    }
    __syncwarp();

    T* dk = dqkv + ((size_t)b * S + j) * row + W + h * D;
    for (int d = lane; d < D; d += 32) {
      float acc_k = 0.f, acc_v = 0.f;
      for (int i = 0; i < S; ++i) {
        acc_k = fmaf(dsc[i], qs[i * st + d], acc_k);
        acc_v = fmaf(p[i], gs[i * st + d], acc_v);
      }
      dk[d] = from_float<T>(acc_k);  // q was staged pre-scaled
      dk[W + d] = from_float<T>(acc_v);
    }
    __syncwarp();  // k, v, P and dS are rewritten for the warp's next column
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
  const int st = tile_stride(D);
  const size_t smem_dq =
      ((size_t)2 * S * st + (size_t)2 * kWarps * D + (size_t)kWarps * S) * sizeof(float);
  const size_t smem_dkv =
      ((size_t)2 * S * st + (size_t)3 * S + (size_t)2 * kWarps * (D + S)) * sizeof(float);
  int e = allow_smem(attention_bwd_dq_kernel<T>, smem_dq);
  if (e) return e;
  e = allow_smem(attention_bwd_dkv_kernel<T>, smem_dkv);
  if (e) return e;
  const T* q = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  T* dq = static_cast<T*>(dqkv);
  attention_bwd_dq_kernel<T><<<B * H, kWarps * 32, smem_dq, stream>>>(
      q, bias, g, dq, stats, S, H, D, scale);
  e = (int)cudaGetLastError();
  if (e) return e;
  attention_bwd_dkv_kernel<T><<<B * H, kWarps * 32, smem_dkv, stream>>>(
      q, bias, g, dq, stats, S, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Launches the dq pass, then the dkv pass, on
// `stream`; returns the first launch error, or 0.
extern "C" int clip_attention_bwd(const void* qkv, const void* bias, const void* dout,
                                  void* dqkv, void* stats, int B, int S, int H, int D,
                                  float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || S > kMaxS || H < 1 || D < 1 || D > kMaxD || (dtype != 0 && dtype != 1))
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
