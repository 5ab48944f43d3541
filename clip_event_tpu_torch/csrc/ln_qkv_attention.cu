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
// What bounds it: operations. The projection is 2*B*S*W*3W flops against
// x, out and the weight moved once, hundreds of flops per byte. One block
// per (batch item, head) computes the row statistics of the item's S rows
// (one warp per row), then forms the head's q, k and v [S, D] in three
// passes over the W input columns: each pass streams 32-column tiles of x
// (normalized and rounded on the way into shared memory, stored transposed)
// and of the head's D weight columns (out of L2, which holds the whole
// weight) and multiplies them in registers, each thread owning up to 8 rows
// x 4 columns of the result. q (scaled), k and v stay in shared memory as
// fp32 and the attention core of csrc/attention_fwd.cu runs on them, one
// warp per query row. Neither ln nor the [B, S, 3W] projection ever reaches
// device memory. The LayerNorm is recomputed by each of the item's H
// blocks. It is the simple first version: the product runs on the CUDA
// cores in fp32 (bf16 operands are exact there), so its floor is the fp32
// rate, far from the tensor cores' bf16 rate the bound is stated against.
//
// Limits, checked by the Python wrapper too: S <= 128, D <= 64, D % 4 == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 128;
constexpr int kMaxD = 64;
constexpr int kTileK = 32;             // input columns per tile
constexpr int kRowStep = 16;           // thread rows of the product's grid
constexpr int kRowSlots = kMaxS / kRowStep;  // result rows a thread owns
constexpr int kKeySlots = kMaxS / 32;  // logits each lane holds

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

__host__ __device__ __forceinline__ int key_stride(int D) { return D | 1; }
// rows of the transposed x tile, padded to the thread grid, plus one so
// that the 32 lanes of a warp storing one row's 32 columns hit 32 banks
__host__ __device__ __forceinline__ int tile_stride(int S) {
  return (S + kRowStep - 1) / kRowStep * kRowStep + 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_qkv_attention_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
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
int launch(const void* x, const void* gamma, const void* beta, const void* w, const void* wb,
           const float* bias, void* out, int B, int S, int H, int D, float scale, float eps,
           cudaStream_t stream) {
  const size_t floats = (size_t)kTileK * D + (size_t)kTileK * tile_stride(S) + 2 * (size_t)S * D +
                        (size_t)S * key_stride(D) + (size_t)kWarps * S + 2 * (size_t)S;
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_qkv_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ln_qkv_attention_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<const T*>(w), static_cast<const T*>(wb), bias, static_cast<T*>(out), S, H, D,
      scale, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int clip_ln_qkv_attention(const void* x, const void* gamma, const void* beta,
                                     const void* w, const void* wb, const void* bias, void* out,
                                     int B, int S, int H, int D, float scale, float eps, int dtype,
                                     void* stream) {
  if (B < 1 || S < 1 || S > kMaxS || H < 1 || D < 1 || D > kMaxD || D % 4 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* bias_f = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, gamma, beta, w, wb, bias_f, out, B, S, H, D, scale, eps, s);
  return launch<__nv_bfloat16>(x, gamma, beta, w, wb, bias_f, out, B, S, H, D, scale, eps, s);
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
