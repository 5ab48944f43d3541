// Fused LayerNorm backward (K4c), for sm_90a.
//
// Replaces the backward Pallas kernel of clip_event_tpu/ops/ln_pallas.py:
// _ln_bwd_kernel, launched by _ln_bwd_call for both custom VJPs (_ln_bwd of
// layer_norm_pallas, _add_ln_bwd of add_layer_norm_pallas). Same contract:
//
//   x      [N, W]  the saved input of the LayerNorm (for the add + LN
//                  kernel: the sum), fp32 or bf16, contiguous
//   gamma  [W]     fp32
//   dy     [N, W]  the cotangent of y, in x's type
//   dx_out [N, W]  the cotangent of the add + LN kernel's sum, or null
//   dx     [N, W]  (g - mean(g) - xhat * mean(g * xhat)) * rstd with
//                  g = dy * gamma, in x's type; with dx_out it is rounded to
//                  x's type and then added to dx_out in that type (the
//                  roundings of _add_ln_bwd, which adds outside its kernel)
//   dgamma, dbeta [W] fp32: sum over rows of dy * xhat, and of dy
//
// The statistics are recomputed from x in fp32 (mean, then the variance of
// the centred values), never saved.
//
// What bounds it: bytes. x, dy (and dx_out) are read once and dx written
// once; the flops are a few per element. The TPU kernel adds dgamma and
// dbeta into one output block across a sequential grid. Blocks on this card
// run at once, so here a few hundred blocks each loop over their share of
// the rows, one warp per row, and every warp keeps its own [2, W] column
// sums in shared memory (a lane only ever touches its own columns: no
// atomics, no barrier inside the loop). At the end the block adds its
// warps' sums in warp order and writes one [2, W] partial to an fp32
// scratch; a second launch adds the partials in block order. The result is
// the same from run to run. A row is parked in shared memory between the
// passes (x, then xhat and g), so device memory sees each element once.
//
// Limits, checked by the Python wrapper too: 1 <= W <= 3072 (4 warps x 4
// fp32 rows of shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxW = 3072;
constexpr int kReduceCols = 32;    // columns per block of the reduction
constexpr int kReduceSlices = 8;   // partial ranges summed side by side

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

// The element's share of pass 3: xhat and g = dy * gamma parked for pass 4,
// the column sums updated, the row sums s1 += g, s2 += g * xhat.
__device__ __forceinline__ void accumulate(float x, float dy, float gamma, float mean, float rstd,
                                           float& xhat, float& g, float& dg, float& db,
                                           float& s1, float& s2) {
  xhat = __fmul_rn(x - mean, rstd);
  g = __fmul_rn(dy, gamma);
  dg = __fadd_rn(dg, __fmul_rn(dy, xhat));
  db += dy;
  s1 += g;
  s2 = __fadd_rn(s2, __fmul_rn(g, xhat));
}

// One element of pass 4. With ADD the LayerNorm's dx is rounded to the I/O
// type before it meets dx_out, and their sum is rounded again.
template <typename T, bool ADD>
__device__ __forceinline__ float finish(float g, float xhat, float m1, float m2, float rstd,
                                        float dx_out) {
  const float dx = __fmul_rn(g - m1 - __fmul_rn(xhat, m2), rstd);
  if (!ADD) return dx;
  return dx_out + to_float(from_float<T>(dx));
}

// W4: the leading columns moved 4 at a time (W when W % 4 == 0 and every
// pointer is 16-byte aligned, else 0); the rest go one at a time.
template <typename T, bool ADD>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const T* __restrict__ dy, const T* __restrict__ dx_out,
                      T* __restrict__ dx, float* __restrict__ partial, int N, int W, int W4,
                      float eps) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* xs = smem + (size_t)warp * 4 * W;  // x, then xhat
  float* gs = xs + W;                       // dy * gamma
  float* dgs = gs + W;                      // this warp's column sums of dy * xhat
  float* dbs = dgs + W;                     // ... and of dy
  for (int c = lane; c < W; c += 32) {
    dgs[c] = 0.f;
    dbs[c] = 0.f;
  }
  // a lane clears columns lane, lane + 32, ... and later updates 4 * lane ..
  __syncwarp();

  const float inv_w = 1.f / (float)W;
  for (int row = blockIdx.x * kWarps + warp; row < N; row += gridDim.x * kWarps) {
    const size_t off = (size_t)row * W;
    const T* xr = x + off;
    const T* dyr = dy + off;

    float total = 0.f;
    for (int c = lane * 4; c < W4; c += 128) {
      float v[4];
      load4(xr + c, v);
      store4(xs + c, v);
      total += (v[0] + v[1]) + (v[2] + v[3]);
    }
    for (int c = W4 + lane; c < W; c += 32) {
      const float v = to_float(xr[c]);
      xs[c] = v;
      total += v;
    }
    const float mean = warp_sum(total) * inv_w;

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
    const float rstd = rsqrtf(warp_sum(sq) * inv_w + eps);

    float s1 = 0.f, s2 = 0.f;
    for (int c = lane * 4; c < W4; c += 128) {
      float v[4], d[4], gm[4], dg[4], db[4], xh[4], g[4];
      load4(xs + c, v);
      load4(dyr + c, d);
      load4(gamma + c, gm);
      load4(dgs + c, dg);
      load4(dbs + c, db);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        accumulate(v[i], d[i], gm[i], mean, rstd, xh[i], g[i], dg[i], db[i], s1, s2);
      store4(xs + c, xh);
      store4(gs + c, g);
      store4(dgs + c, dg);
      store4(dbs + c, db);
    }
    for (int c = W4 + lane; c < W; c += 32) {
      float xh, g;
      accumulate(xs[c], to_float(dyr[c]), gamma[c], mean, rstd, xh, g, dgs[c], dbs[c], s1, s2);
      xs[c] = xh;
      gs[c] = g;
    }
    const float m1 = warp_sum(s1) * inv_w;
    const float m2 = warp_sum(s2) * inv_w;

    T* dxr = dx + off;
    for (int c = lane * 4; c < W4; c += 128) {
      float xh[4], g[4], o[4] = {0.f, 0.f, 0.f, 0.f};
      load4(xs + c, xh);
      load4(gs + c, g);
      if (ADD) load4(dx_out + off + c, o);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = finish<T, ADD>(g[i], xh[i], m1, m2, rstd, o[i]);
      store4(dxr + c, o);
    }
    for (int c = W4 + lane; c < W; c += 32) {
      const float o = ADD ? to_float(dx_out[off + c]) : 0.f;
      dxr[c] = from_float<T>(finish<T, ADD>(gs[c], xs[c], m1, m2, rstd, o));
    }
  }

  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * 2 * W;
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    float dg = 0.f, db = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      dg += smem[(size_t)w * 4 * W + 2 * W + c];
      db += smem[(size_t)w * 4 * W + 3 * W + c];
    }
    out[c] = dg;
    out[W + c] = db;
  }
}

// partial [G, 2W] -> out [2W] (dgamma, then dbeta), summed over the G blocks
// in a fixed order: thread (slice, col) adds blocks slice, slice + 8, ...,
// then the first row of threads adds the 8 slices in order.
__global__ void __launch_bounds__(kReduceCols * kReduceSlices)
layer_norm_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dgamma,
                             float* __restrict__ dbeta, int G, int W) {
  __shared__ float part[kReduceSlices][kReduceCols];
  const int tx = threadIdx.x % kReduceCols;
  const int slice = threadIdx.x / kReduceCols;
  const int col = blockIdx.x * kReduceCols + tx;  // over [0, 2W)
  float acc = 0.f;
  if (col < 2 * W)
    for (int g = slice; g < G; g += kReduceSlices) acc += partial[(size_t)g * 2 * W + col];
  part[slice][tx] = acc;
  __syncthreads();
  if (slice == 0 && col < 2 * W) {
    float total = 0.f;
#pragma unroll
    for (int s = 0; s < kReduceSlices; ++s) total += part[s][tx];
    if (col < W) dgamma[col] = total;
    else dbeta[col - W] = total;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, bool ADD>
int launch(const void* x, const float* gamma, const void* dy, const void* dx_out, void* dx,
           float* partial, float* dgamma, float* dbeta, int N, int W, int G, float eps,
           cudaStream_t stream) {
  const bool vec = W % 4 == 0 && aligned16(x) && aligned16(dy) && aligned16(dx) &&
                   aligned16(gamma) && (!ADD || aligned16(dx_out));
  const size_t smem = (size_t)kWarps * 4 * W * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        layer_norm_bwd_kernel<T, ADD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  layer_norm_bwd_kernel<T, ADD><<<G, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), gamma, static_cast<const T*>(dy), static_cast<const T*>(dx_out),
      static_cast<T*>(dx), partial, N, W, vec ? W : 0, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int blocks = (2 * W + kReduceCols - 1) / kReduceCols;
  layer_norm_bwd_reduce_kernel<<<blocks, kReduceCols * kReduceSlices, 0, stream>>>(
      partial, dgamma, dbeta, G, W);
  return (int)cudaGetLastError();
}

}  // namespace

// G: the row pass's blocks; partial: [G, 2, W] fp32 scratch. dtype: 0 =
// fp32, 1 = bf16. Returns the first CUDA error of the two launches, or 0.
extern "C" int clip_layer_norm_bwd(const void* x, const void* gamma, const void* dy,
                                   const void* dx_out, void* dx, void* partial, void* dgamma,
                                   void* dbeta, int N, int W, int G, float eps, int dtype,
                                   void* stream) {
  if (N < 1 || W < 1 || W > kMaxW || G < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gamma);
  float* p = static_cast<float*>(partial);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool add = dx_out != nullptr;
  if (dtype == 0) {
    if (add) return launch<float, true>(x, g, dy, dx_out, dx, p, dg, db, N, W, G, eps, s);
    return launch<float, false>(x, g, dy, dx_out, dx, p, dg, db, N, W, G, eps, s);
  }
  if (add) return launch<__nv_bfloat16, true>(x, g, dy, dx_out, dx, p, dg, db, N, W, G, eps, s);
  return launch<__nv_bfloat16, false>(x, g, dy, dx_out, dx, p, dg, db, N, W, G, eps, s);
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
