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
// row written once. One warp takes a row; the statistics need the whole row
// before the first output, so the row has to stay on chip between the three
// passes (sum, centred squares, normalize). Where the width allows
// (layer_norm.cuh: every CLIP preset's) the row stays in the lane's
// registers: every load of the row is issued before the first reduction,
// 16 bytes a lane, and nothing touches shared memory or waits at a barrier.
// One row a warp: at these widths a row needs 16-40 registers of data a
// lane, so an SM keeps 28-64 warps and as many rows in flight, which is
// what hides the load latency. Any other width, or a misaligned view, takes
// the generic kernel, which parks the row in shared memory as fp32.
//
// Limits, checked by the Python wrapper too: 1 <= W <= 3072.

#include "layer_norm.cuh"

namespace {

using namespace ln;

// Both kernels take 1 / W from the host: a division on the card carries a
// slow-path call whose registers can spill (div_w in layer_norm.cuh).
static_assert(kWarps * kMaxW * sizeof(float) <= 48 * 1024,
              "the generic kernel's rows fit the default shared memory");

// One element of the normalize pass. The products and the sum are rounded
// one by one, as the plain version's separate multiply and add are.
__device__ __forceinline__ float normalize(float x, float mean, float rstd, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(x - mean, rstd), g), b);
}

// The register path: lane l holds the row's 16-byte vectors i * 32 + l,
// i < NV (S slots of 8 elements: NV = S in bf16, 2 S in fp32).
template <typename T, bool ADD, int S>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_fwd_reg_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          T* __restrict__ sum_out, T* __restrict__ y, int N, int W, float inv_w,
                          float eps) {
  constexpr int E = Vec<T>::E;
  constexpr int NV = S * 8 / E;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= N) return;  // no barrier below
  const int nv = W / E;
  const size_t off = (size_t)row * W;

  uint4 raw[NV];
  uint4 raw_d[ADD ? NV : 1];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int k = i * 32 + lane;
    if (k < nv) {
      raw[i] = load16(x + off + (size_t)k * E);
      if constexpr (ADD) raw_d[i] = load16(delta + off + (size_t)k * E);
    }
  }

  float v[NV][E];
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int k = i * 32 + lane;
#pragma unroll
    for (int e = 0; e < E; ++e) v[i][e] = 0.f;
    if (k < nv) {
      Vec<T>::unpack(raw[i], v[i]);
      if constexpr (ADD) {
        float d[E];
        Vec<T>::unpack(raw_d[i], d);
#pragma unroll
        for (int e = 0; e < E; ++e) v[i][e] = round_to<T>(v[i][e] + d[e]);
        store16(sum_out + off + (size_t)k * E, Vec<T>::pack(v[i]));
      }
    }
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < E; e += 2) part += v[i][e] + v[i][e + 1];
    total += part;
  }
  const float mean = div_w(warp_sum(total), (float)W, inv_w);

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i * 32 + lane < nv) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = v[i][e] - mean;
        sq = fmaf(d, d, sq);
      }
    }
  }
  const float rstd = rsqrtf(div_w(warp_sum(sq), (float)W, inv_w) + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int k = i * 32 + lane;
    if (k < nv) {
      float g[E], b[E];
      load_f32<E>(gamma + k * E, g);
      load_f32<E>(beta + k * E, b);
#pragma unroll
      for (int e = 0; e < E; ++e) v[i][e] = normalize(v[i][e], mean, rstd, g[e], b[e]);
      store16(y + off + (size_t)k * E, Vec<T>::pack(v[i]));
    }
  }
}

// The generic path. W4: the leading columns moved 4 at a time (W when
// W % 4 == 0 and every pointer is 16-byte aligned, else 0); the rest go one
// at a time. A lane reads back from shared memory only what it wrote
// itself, so the warp needs no barrier.
template <typename T, bool ADD>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      T* __restrict__ sum_out, T* __restrict__ y, int N, int W, int W4,
                      float inv_w, float eps) {
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
      for (int i = 0; i < 4; ++i) v[i] = round_to<T>(v[i] + d[i]);
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
  const float mean = div_w(warp_sum(total), (float)W, inv_w);

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
  const float rstd = rsqrtf(div_w(warp_sum(sq), (float)W, inv_w) + eps);

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

template <typename T, bool ADD, int S>
int launch_reg(const T* x, const T* delta, const float* gamma, const float* beta, T* sum_out,
               T* y, int N, int W, float eps, cudaStream_t stream) {
  if (slots(W) != S) {
    if constexpr (S < kMaxSlots) {
      return launch_reg<T, ADD, S + 1>(x, delta, gamma, beta, sum_out, y, N, W, eps, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (N + kWarps - 1) / kWarps;
  layer_norm_fwd_reg_kernel<T, ADD, S><<<blocks, kWarps * 32, 0, stream>>>(
      x, delta, gamma, beta, sum_out, y, N, W, 1.f / (float)W, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool ADD>
int launch(const void* xv, const void* deltav, const float* gamma, const float* beta,
           void* sumv, void* yv, int N, int W, float eps, int path, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* delta = static_cast<const T*>(deltav);
  T* sum_out = static_cast<T*>(sumv);
  T* y = static_cast<T*>(yv);
  const bool aligned = aligned16(x) && aligned16(y) && aligned16(gamma) && aligned16(beta) &&
                       (!ADD || (aligned16(delta) && aligned16(sum_out)));
  if (path == kRegisters) {
    // the caller's rule (ops/ln.py: register_path); refused, never rerouted
    if (W % 8 != 0 || W > kRegMaxW || !aligned) return (int)cudaErrorInvalidValue;
    return launch_reg<T, ADD, 1>(x, delta, gamma, beta, sum_out, y, N, W, eps, stream);
  }
  const int blocks = (N + kWarps - 1) / kWarps;
  const size_t smem = (size_t)kWarps * W * sizeof(float);
  layer_norm_fwd_kernel<T, ADD><<<blocks, kWarps * 32, smem, stream>>>(
      x, delta, gamma, beta, sum_out, y, N, W, (W % 4 == 0 && aligned) ? W : 0, 1.f / (float)W, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// delta and sum_out both null: K4a. Both given: K4b. dtype: 0 = fp32,
// 1 = bf16. path: 1 = registers (ln::kRegisters), 0 = generic. Returns
// cudaGetLastError() after the launch.
extern "C" int clip_layer_norm_fwd(const void* x, const void* delta, const void* gamma,
                                   const void* beta, void* sum_out, void* y, int N, int W,
                                   float eps, int dtype, int path, void* stream) {
  if (N < 1 || W < 1 || W > kMaxW || (dtype != 0 && dtype != 1) ||
      (path != kGeneric && path != kRegisters) || ((delta == nullptr) != (sum_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool add = delta != nullptr;
  if (dtype == 0) {
    if (add) return launch<float, true>(x, delta, g, b, sum_out, y, N, W, eps, path, s);
    return launch<float, false>(x, delta, g, b, sum_out, y, N, W, eps, path, s);
  }
  if (add) return launch<__nv_bfloat16, true>(x, delta, g, b, sum_out, y, N, W, eps, path, s);
  return launch<__nv_bfloat16, false>(x, delta, g, b, sum_out, y, N, W, eps, path, s);
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
