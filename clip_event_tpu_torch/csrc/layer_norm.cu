// Fused LayerNorm forward, alone (K4a) and with the residual add folded in
// (K4b), for sm_90a.
//
// Replaces the forward Pallas kernels of clip_event_tpu/ops/ln_pallas.py:
// _ln_fwd_kernel (layer_norm_pallas) and _add_ln_fwd_kernel
// (add_layer_norm_pallas). Same contract:
//
//   x      [N, W]  fp32 or bf16, contiguous (the wrapper flattens [..., W])
//   delta  [N, W]  same type, or null. With it the row is x + delta, rounded
//                  to the I/O type first, written out as `sum`, and the
//                  LayerNorm reads that rounded value
//   gamma, beta [W] fp32
//   y      [N, W]  ((r - mean) * rsqrt(var + eps)) * gamma + beta in the I/O
//                  type; mean, then the variance of the centred values, all
//                  in fp32 (_stats)
//
// What bounds it: no reuse and a handful of flops per element, so the
// card's memory rate is the floor: each input row read once, each output
// row written once. The design does exactly that: one warp per row, the row
// parked in shared memory as fp32 between the three passes (sum, centred
// squares, normalize), so the statistics cost no second trip to device
// memory. Each lane moves 4 neighbouring elements at a time (16 bytes in
// fp32, 8 in bf16) where W is a multiple of 4, one at a time otherwise, and
// reads back from shared memory only what it wrote itself, so the warp
// needs no barrier.
//
// Limits, checked by the Python wrapper too: 1 <= W <= 3072.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rows per block
constexpr int kMaxW = 3072;

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

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&a);
  t.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One element of the normalize pass. The products and the sum are rounded
// one by one, as the plain version's separate multiply and add are.
__device__ __forceinline__ float normalize(float x, float mean, float rstd, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(x - mean, rstd), g), b);
}

// W4: the leading columns moved 4 at a time (W when W % 4 == 0 and every
// pointer is 16-byte aligned, else 0); the rest go one at a time.
template <typename T, bool ADD>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      T* __restrict__ sum_out, T* __restrict__ y, int N, int W, int W4,
                      float eps) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= N) return;  // no block-wide barrier below
  float* xs = smem + (size_t)warp * W;
  const size_t off = (size_t)row * W;
  const T* xr = x + off;

  float total = 0.f;
  for (int c = lane * 4; c < W4; c += 128) {
    float v[4];
    load4(xr + c, v);
    if (ADD) {
      float d[4];
      load4(delta + off + c, d);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = to_float(from_float<T>(v[i] + d[i]));
      store4(sum_out + off + c, v);
    }
    store4(xs + c, v);
    total += (v[0] + v[1]) + (v[2] + v[3]);
  }
  for (int c = W4 + lane; c < W; c += 32) {
    float v = to_float(xr[c]);
    if (ADD) {
      const T s = from_float<T>(v + to_float(delta[off + c]));
      sum_out[off + c] = s;
      v = to_float(s);
    }
    xs[c] = v;
    total += v;
  }
  const float mean = warp_sum(total) / (float)W;

  float sq = 0.f;
  for (int c = lane * 4; c < W4; c += 128) {
    float v[4];
    load4(xs + c, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float d = v[i] - mean;
      sq = fmaf(d, d, sq);
    }
  }
  for (int c = W4 + lane; c < W; c += 32) {
    const float d = xs[c] - mean;
    sq = fmaf(d, d, sq);
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)W + eps);

  T* yr = y + off;
  for (int c = lane * 4; c < W4; c += 128) {
    float v[4], g[4], b[4];
    load4(xs + c, v);
    load4(gamma + c, g);
    load4(beta + c, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = normalize(v[i], mean, rstd, g[i], b[i]);
    store4(yr + c, v);
  }
  for (int c = W4 + lane; c < W; c += 32)
    yr[c] = from_float<T>(normalize(xs[c], mean, rstd, gamma[c], beta[c]));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, bool ADD>
int launch(const void* x, const void* delta, const float* gamma, const float* beta, void* sum_out,
           void* y, int N, int W, float eps, cudaStream_t stream) {
  const bool vec = W % 4 == 0 && aligned16(x) && aligned16(y) && aligned16(gamma) &&
                   aligned16(beta) && (!ADD || (aligned16(delta) && aligned16(sum_out)));
  const size_t smem = (size_t)kWarps * W * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        layer_norm_fwd_kernel<T, ADD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + kWarps - 1) / kWarps;
  layer_norm_fwd_kernel<T, ADD><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta), gamma, beta,
      static_cast<T*>(sum_out), static_cast<T*>(y), N, W, vec ? W : 0, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// delta and sum_out both null: K4a. Both given: K4b. dtype: 0 = fp32,
// 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int clip_layer_norm_fwd(const void* x, const void* delta, const void* gamma,
                                   const void* beta, void* sum_out, void* y, int N, int W,
                                   float eps, int dtype, void* stream) {
  if (N < 1 || W < 1 || W > kMaxW || (dtype != 0 && dtype != 1) ||
      ((delta == nullptr) != (sum_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool add = delta != nullptr;
  if (dtype == 0) {
    if (add) return launch<float, true>(x, delta, g, b, sum_out, y, N, W, eps, s);
    return launch<float, false>(x, delta, g, b, sum_out, y, N, W, eps, s);
  }
  if (add) return launch<__nv_bfloat16, true>(x, delta, g, b, sum_out, y, N, W, eps, s);
  return launch<__nv_bfloat16, false>(x, delta, g, b, sum_out, y, N, W, eps, s);
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
