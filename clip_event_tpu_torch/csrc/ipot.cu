// Batched IPOT solver (inexact proximal-point optimal transport) for the
// OT graph-alignment loss, K3, for sm_90a.
//
// Replaces the Pallas kernel of clip_event_tpu/ops/ot_pallas.py::ipot_pallas
// (_ipot_kernel). Same contract and arithmetic, all fp32:
//
//   cost  [B, M, N]  cosine cost between M text entities and N image objects
//   x_pad [B, M]     nonzero at padded entities, 0 at real ones (bytes:
//                    the wrapper's bool masks as they are)
//   y_pad [B, N]     nonzero at padded objects (bytes)
//   x_len [B], y_len [B]  node counts (clamped by the caller in safe mode)
//   plan  [B, N, M]  the transport plan T, transposed as the reference
//                    returns it; 0 at every padded (n, m)
//
//   A = exp(-C^T / beta) at real pairs, 0 at pads;  T = 1 at real pairs
//   sigma = 1 / x_len at real entities, 0 at pads
//   repeat `iterations` times:
//     Q = A o T
//     repeat k times:
//       delta_n = 1 / (y_len * sum_m Q[n, m] sigma_m + 1e4 * y_pad_n)
//       sigma_m = 1 / (x_len * sum_n delta_n Q[n, m] + 1e4 * x_pad_m)
//     T = delta o Q o sigma
//
// A row with zero real nodes divides by zero as the reference does; its
// plan entries are all pads and are written as 0 by a select, as
// `ops.ot.ipot`'s final `where` does (the TPU kernel multiplies by the keep
// mask instead, which turns that row's inf * 0 into NaN). `safe` mode
// handles such rows outside the kernel.
//
// What bounds it: latency. At the finetune_ot shape (B=64, M=16 entities,
// N=7 objects) the whole solve is 50 * 7*M*N flops and ~2*M*N*4 bytes an
// item: 0.00004 ms at the card's fp32 rate (the roofline,
// `chip_smoke.py::ipot_bound_ms`). What sets the floor is the chain of 50 * k
// dependent updates: each is a reduction over m for every n (5 shuffle
// levels in a warp), a reciprocal, a broadcast (one more shuffle), a sum
// over n (N dependent FMAs) and a reciprocal, about 250-350 cycles, so 50
// updates and a launch take about 0.01 ms (the latency floor beside the
// roofline in the same function). The
// TPU kernel exists to make the solve one launch instead of ~50 chained loop
// bodies; this one does the same. Two hand-written variants, chosen by
// shape in the Python wrapper (`ops.ot.ipot_variant`) and passed in:
//
// "warp" (M <= 32, N <= kWarpMaxObjects): one warp an item, kWarpItems
// items a block. Lane m holds its entity's column of A and of T (Q written
// over T) for every object in registers (N_MAX = 8, 16 or 32 of each, by
// template), and the y pads as a bit mask. The N sums over the lanes for
// delta_n are reduced and scattered at once (`reduce_scatter`: at each
// butterfly level a lane keeps half of its values and swaps the other
// half, 7 shuffles for N_MAX = 8 then 2 more, 31 for 32), so each lane
// ends with one sum and takes one reciprocal; the N deltas are then
// broadcast to every lane (N independent shuffles), and sigma_m is a sum
// over n in the lane's own registers. No shared memory and no barrier. The
// sums are taken in the block variant's order (one term a lane, the same
// butterfly tree; n in order), so its plan is the block variant's bit for
// bit.
//
// "block" (larger graphs, M, N <= 128): one block of 128 threads an item
// keeps A and T (Q written over T) in shared memory through all
// `iterations * k` updates. The matvec over m is one warp per row n with a
// warp reduction; the one over n is one thread per column m, reading the
// rows of Q in order (consecutive threads, consecutive addresses); five
// barriers an update. Device memory is read once (the cost) and written
// once (the plan) in both variants.
//
// Limits, checked by the Python wrapper too: M, N <= 128 (2 * 128 * 128 * 4
// bytes of shared memory, within the 227 KB a block may use); the warp
// variant M <= 32, N <= 32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNodes = 128;
constexpr float kMaskBig = 1e4f;  // MASK_BIG of the reference
constexpr int kWarpMaxEntities = 32;  // the warp variant: one lane an entity
constexpr int kWarpMaxObjects = 32;   // and N_MAX registers of A and T a lane
constexpr int kWarpItems = 4;         // items (warps) a block of the warp variant

enum Variant { kBlock = 0, kWarp = 1 };

__host__ __device__ __forceinline__ size_t smem_floats(int M, int N) {
  return 2 * (size_t)N * M       // A and T (Q is written over T)
         + 3 * (size_t)M         // sigma, x_pad, d_q scratch
         + 2 * (size_t)N;        // delta, y_pad
}

__global__ void __launch_bounds__(kThreads)
ipot_kernel_block(const float* __restrict__ cost, const unsigned char* __restrict__ x_pad,
            const unsigned char* __restrict__ y_pad, const float* __restrict__ x_len,
            const float* __restrict__ y_len, float* __restrict__ plan, int M, int N,
            float beta, int iterations, int k) {
  extern __shared__ float smem[];
  float* A = smem;              // [N, M]
  float* T = A + N * M;         // [N, M]
  float* sigma = T + N * M;     // [M]
  float* xp = sigma + M;        // [M]
  float* dq = xp + M;           // [M]
  float* delta = dq + M;        // [N]
  float* yp = delta + N;        // [N]

  const int b = blockIdx.x;
  const float* c = cost + (size_t)b * M * N;
  const float xl = x_len[b];
  const float yl = y_len[b];
  for (int m = threadIdx.x; m < M; m += kThreads) {
    xp[m] = x_pad[(size_t)b * M + m] ? 1.f : 0.f;
    sigma[m] = xp[m] != 0.f ? 0.f : 1.f / xl;
  }
  for (int n = threadIdx.x; n < N; n += kThreads) yp[n] = y_pad[(size_t)b * N + n] ? 1.f : 0.f;
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * M; idx += kThreads) {
    const int n = idx / M;
    const int m = idx - n * M;
    const bool pad = xp[m] != 0.f || yp[n] != 0.f;
    A[idx] = pad ? 0.f : expf(-c[m * N + n] / beta);
    T[idx] = pad ? 0.f : 1.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int it = 0; it < iterations; ++it) {
    for (int idx = threadIdx.x; idx < N * M; idx += kThreads) T[idx] = A[idx] * T[idx];  // Q
    __syncthreads();
    for (int inner = 0; inner < k; ++inner) {
      // delta_n = 1 / (y_len * (Q sigma)_n + y_mask_n): one warp per row
      for (int n = warp; n < N; n += kWarps) {
        float part = 0.f;
        for (int m = lane; m < M; m += 32) part = fmaf(T[n * M + m], sigma[m], part);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0) delta[n] = 1.f / (yl * part + (yp[n] != 0.f ? kMaskBig : 0.f));
      }
      __syncthreads();
      // sigma_m = 1 / (x_len * (delta Q)_m + x_mask_m): one thread per column
      for (int m = threadIdx.x; m < M; m += kThreads) {
        float s = 0.f;
        for (int n = 0; n < N; ++n) s = fmaf(delta[n], T[n * M + m], s);
        dq[m] = s;
      }
      __syncthreads();
      for (int m = threadIdx.x; m < M; m += kThreads)
        sigma[m] = 1.f / (xl * dq[m] + (xp[m] != 0.f ? kMaskBig : 0.f));
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < N * M; idx += kThreads) {
      const int n = idx / M;
      const int m = idx - n * M;
      T[idx] = delta[n] * T[idx] * sigma[m];
    }
    __syncthreads();
  }

  float* out = plan + (size_t)b * N * M;
  for (int idx = threadIdx.x; idx < N * M; idx += kThreads) {
    const int n = idx / M;
    const int m = idx - n * M;
    out[idx] = (xp[m] != 0.f || yp[n] != 0.f) ? 0.f : T[idx];
  }
}

// The lane of a warp that ends `reduce_scatter` holding the sum of
// value n: the halving levels (16, 8, ... while more than one value is
// left) give the value's bits from the highest, each to the level's lane bit.
template <int N_MAX>
__device__ __forceinline__ int scatter_lane(int n) {
  int lane = 0;
#pragma unroll
  for (int o = 16, half = N_MAX / 2; half >= 1; o >>= 1, half >>= 1)
    if (n & half) lane |= o;
  return lane;
}

// v[0..N_MAX) of every lane summed over the warp's 32 lanes, each sum left
// in v[0] of the lanes `scatter_lane` names (N_MAX a power of 2 <= 32): at
// each of the first log2(N_MAX) butterfly levels a lane keeps half of its
// values and hands the other half to its partner, then the levels left
// sum v[0] alone. Each value's sum is the butterfly all-reduce's, term for
// term (a + b = b + a): 31 shuffles for 32 values instead of 160. Level O
// with CNT values left, unrolled at compile time.
template <int O, int CNT, int N_MAX>
__device__ __forceinline__ void reduce_scatter(float (&v)[N_MAX], int lane) {
  if constexpr (O > 0) {
    if constexpr (CNT > 1) {
      constexpr int kHalf = CNT / 2;
      const bool upper = lane & O;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float keep = upper ? v[i + kHalf] : v[i];
        const float give = upper ? v[i] : v[i + kHalf];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, give, O);
      }
      reduce_scatter<O / 2, kHalf, N_MAX>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      reduce_scatter<O / 2, 1, N_MAX>(v, lane);
    }
  }
}

// the value whose sum `reduce_scatter` leaves in this lane
template <int N_MAX>
__device__ __forceinline__ int scatter_value(int lane) {
  int n = 0;
#pragma unroll
  for (int o = 16, half = N_MAX / 2; half >= 1; o >>= 1, half >>= 1)
    if (lane & o) n |= half;
  return n;
}

template <int N_MAX>
__global__ void __launch_bounds__(kWarpItems * 32)
ipot_kernel_warp(const float* __restrict__ cost, const unsigned char* __restrict__ x_pad,
                 const unsigned char* __restrict__ y_pad, const float* __restrict__ x_len,
                 const float* __restrict__ y_len, float* __restrict__ plan, int B, int M, int N,
                 float beta, int iterations, int k) {
  const int b = blockIdx.x * kWarpItems + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp: nothing below waits on another warp
  const int m = threadIdx.x & 31;
  const bool lane_m = m < M;
  const bool x_padded = lane_m && x_pad[(size_t)b * M + m];
  const float xl = x_len[b];
  const float yl = y_len[b];
  const float xm = x_padded ? kMaskBig : 0.f;
  unsigned y_bits = 0;  // bit n: object n is padded
  for (int n = 0; n < N; ++n) y_bits |= (y_pad[(size_t)b * N + n] ? 1u : 0u) << n;
  // the object whose delta this lane computes, and its mask
  const int my_n = scatter_value<N_MAX>(m);
  const float my_ym = ((y_bits >> my_n) & 1u) ? kMaskBig : 0.f;

  float A[N_MAX], T[N_MAX], delta[N_MAX];
  const float* c = cost + ((size_t)b * M + (lane_m ? m : 0)) * N;
#pragma unroll
  for (int n = 0; n < N_MAX; ++n) {
    const bool real = n < N && lane_m && !x_padded && !((y_bits >> n) & 1u);
    A[n] = real ? expf(-c[n] / beta) : 0.f;
    T[n] = real ? 1.f : 0.f;
  }
  float sigma = lane_m && !x_padded ? 1.f / xl : 0.f;

  for (int it = 0; it < iterations; ++it) {
#pragma unroll
    for (int n = 0; n < N_MAX; ++n) T[n] = A[n] * T[n];  // Q
    for (int inner = 0; inner < k; ++inner) {
      // delta_n = 1 / (y_len * (Q sigma)_n + y_mask_n): the N sums over the
      // lanes scattered one to a lane, one reciprocal a lane, then every
      // delta broadcast to every lane. Each product is rounded on its own,
      // as the block variant's fmaf(q, sigma, 0): no contraction into a sum
#pragma unroll
      for (int n = 0; n < N_MAX; ++n) delta[n] = __fmul_rn(T[n], sigma);
      reduce_scatter<16, N_MAX, N_MAX>(delta, m);
      const float mine = 1.f / (yl * delta[0] + my_ym);
#pragma unroll
      for (int n = 0; n < N_MAX; ++n)
        delta[n] = __shfl_sync(0xffffffffu, mine, scatter_lane<N_MAX>(n));
      // sigma_m = 1 / (x_len * (delta Q)_m + x_mask_m), in the lane's
      // registers, n in order
      float s = 0.f;
#pragma unroll
      for (int n = 0; n < N_MAX; ++n)
        if (n < N) s = fmaf(delta[n], T[n], s);
      sigma = lane_m ? 1.f / (xl * s + xm) : 0.f;
    }
#pragma unroll
    for (int n = 0; n < N_MAX; ++n) T[n] = delta[n] * T[n] * sigma;
  }

  if (!lane_m) return;
  float* out = plan + (size_t)b * N * M + m;
#pragma unroll
  for (int n = 0; n < N_MAX; ++n)
    if (n < N) out[(size_t)n * M] = (x_padded || ((y_bits >> n) & 1u)) ? 0.f : T[n];
}

template <int N_MAX>
int launch_warp(const void* cost, const void* x_pad, const void* y_pad, const void* x_len,
                const void* y_len, void* plan, int B, int M, int N, float beta, int iterations, int k,
                cudaStream_t stream) {
  const int blocks = (B + kWarpItems - 1) / kWarpItems;
  ipot_kernel_warp<N_MAX><<<blocks, kWarpItems * 32, 0, stream>>>(
      static_cast<const float*>(cost), static_cast<const unsigned char*>(x_pad),
      static_cast<const unsigned char*>(y_pad), static_cast<const float*>(x_len),
      static_cast<const float*>(y_len), static_cast<float*>(plan), B, M, N, beta, iterations, k);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 = "block", 1 = "warp" (M <= 32, N <= 32): the Python
// wrapper's choice (`ops.ot.ipot_variant`), checked here. Returns
// cudaGetLastError() after the launch.
extern "C" int clip_ipot(const void* cost, const void* x_pad, const void* y_pad,
                         const void* x_len, const void* y_len, void* plan, int B, int M, int N,
                         float beta, int iterations, int k, int variant, void* stream) {
  if (B < 1 || M < 1 || N < 1 || M > kMaxNodes || N > kMaxNodes || iterations < 0 || k < 1 ||
      (variant != kBlock && variant != kWarp) ||
      (variant == kWarp && (M > kWarpMaxEntities || N > kWarpMaxObjects)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kWarp) {
    if (N <= 8) return launch_warp<8>(cost, x_pad, y_pad, x_len, y_len, plan, B, M, N, beta, iterations, k, s);
    if (N <= 16) return launch_warp<16>(cost, x_pad, y_pad, x_len, y_len, plan, B, M, N, beta, iterations, k, s);
    return launch_warp<32>(cost, x_pad, y_pad, x_len, y_len, plan, B, M, N, beta, iterations, k, s);
  }
  const size_t smem = smem_floats(M, N) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(ipot_kernel_block, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ipot_kernel_block<<<B, kThreads, smem, s>>>(
      static_cast<const float*>(cost), static_cast<const unsigned char*>(x_pad),
      static_cast<const unsigned char*>(y_pad), static_cast<const float*>(x_len),
      static_cast<const float*>(y_len), static_cast<float*>(plan), M, N, beta, iterations, k);
  return (int)cudaGetLastError();
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
