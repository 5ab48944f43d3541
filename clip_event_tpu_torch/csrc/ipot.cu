// Batched IPOT solver (inexact proximal-point optimal transport) for the
// OT graph-alignment loss, K3, for sm_90a.
//
// Replaces the Pallas kernel of clip_event_tpu/ops/ot_pallas.py::ipot_pallas
// (_ipot_kernel). Same contract and arithmetic, all fp32:
//
//   cost  [B, M, N]  cosine cost between M text entities and N image objects
//   x_pad [B, M]     1 at padded entities, 0 at real ones (fp32)
//   y_pad [B, N]     1 at padded objects
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
// What bounds it: at the finetune_ot shape (B=64, M=16 entities, N=7
// objects) the whole solve is 50 * 4*M*N flops and ~2*M*N*4 bytes per item,
// microseconds of work at either peak rate, so what sets the floor is the
// latency of one launch plus the 50 dependent steps, each a few
// synchronised block-wide rounds. The TPU kernel exists to make the solve
// one launch instead of ~50 chained loop bodies; this one does the same:
// one block per batch item keeps A and T (with Q written over T) for its
// item in shared memory through all `iterations * k` updates. The matvec
// over m is one warp per row n with a warp reduction; the one over n is
// one thread per column m, reading the rows of Q in order (consecutive
// threads, consecutive addresses). Device memory is read once (the cost)
// and written once (the plan).
//
// Limits, checked by the Python wrapper too: M, N <= 128 (2 * 128 * 128 * 4
// bytes of shared memory, within the 227 KB a block may use).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNodes = 128;
constexpr float kMaskBig = 1e4f;  // MASK_BIG of the reference

__host__ __device__ __forceinline__ size_t smem_floats(int M, int N) {
  return 2 * (size_t)N * M       // A and T (Q is written over T)
         + 3 * (size_t)M         // sigma, x_pad, d_q scratch
         + 2 * (size_t)N;        // delta, y_pad
}

__global__ void __launch_bounds__(kThreads)
ipot_kernel(const float* __restrict__ cost, const float* __restrict__ x_pad,
            const float* __restrict__ y_pad, const float* __restrict__ x_len,
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
    xp[m] = x_pad[(size_t)b * M + m];
    sigma[m] = xp[m] != 0.f ? 0.f : 1.f / xl;
  }
  for (int n = threadIdx.x; n < N; n += kThreads) yp[n] = y_pad[(size_t)b * N + n];
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

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int clip_ipot(const void* cost, const void* x_pad, const void* y_pad,
                         const void* x_len, const void* y_len, void* plan, int B, int M, int N,
                         float beta, int iterations, int k, void* stream) {
  if (B < 1 || M < 1 || N < 1 || M > kMaxNodes || N > kMaxNodes || iterations < 0 || k < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(M, N) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(ipot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ipot_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const float*>(x_pad),
      static_cast<const float*>(y_pad), static_cast<const float*>(x_len),
      static_cast<const float*>(y_len), static_cast<float*>(plan), M, N, beta, iterations, k);
  return (int)cudaGetLastError();
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
