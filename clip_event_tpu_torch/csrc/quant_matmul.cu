// W8A8 quantized GEMM for the int8 inference path, K5, for sm_90a.
//
// Replaces the Pallas kernel of clip_event_tpu/ops/quant_pallas.py::
// quantized_matmul (_kernel). Same contract:
//
//   x      [M, K]  fp32 or bf16 activations
//   q      [K, N]  int8 weight, per-output-channel symmetric
//   scale  [N]     fp32 weight column scales
//   bias   [N]     fp32, optional
//   y      [M, N]  in x's dtype:
//     y = (rowquant(x) . q) * (row_scale (x) col_scale) + bias
//
// Row quantisation, as `ops.quant.quantized_linear` does it:
//   s = max(absmax_k |x[m, k]| / 127, 1e-12)   (dynamic), or the static
//       per-tensor scale of offline calibration (one fp32 on the device)
//   x_q = clip(round_half_even(x / s), -127, 127)
// Products are s8 x s8 into int32 accumulators; the epilogue converts the
// int32 sum to fp32 (round to nearest), multiplies by the fp32 product
// (s * col_scale), adds the bias, and rounds to x's dtype, each step one
// IEEE rounding as in the plain version (no contraction into an FMA).
//
// Two launches per call:
//   1. quant_rows_kernel: one block per row. Abs-max over the row (skipped
//      in static mode), then x_q written into a [M, Kp] int8 scratch whose
//      columns K..Kp-1 are zeros (Kp = K rounded up to the GEMM's 64-deep
//      tile, so the GEMM never masks K on the activation side; zero
//      products are exact) and the row's scale into a [M] fp32 scratch.
//   2. int8_gemm_kernel: 128 x 128 output tiles, 8 warps each holding a
//      64 x 32 piece as 4 x 4 mma.sync m16n8k32 s8 tiles of int32
//      accumulators. The k loop stages a 128 x 64 activation tile and a
//      64 x 128 weight tile in shared memory; the next tiles are loaded
//      into registers while the current ones are multiplied. The weight is
//      [K, N] (n contiguous) and the MMA wants each column's k values
//      together, so each thread transposes 4 x 4 byte blocks in registers
//      (__byte_perm) on the way into shared memory. Rows past M, columns
//      past N and weight rows past K are loaded as zeros and never stored.
//
// Why two launches: the TPU kernel keeps a [TM, K] row block resident in
// VMEM while it quantises it. A block here has 227 KB of shared memory,
// and 128 fp32 rows of K = 4096 are 2 MB, so the row's abs-max must be
// known before the k loop reaches it; the row pass costs one extra read of
// x and a write and read of the int8 copy (a quarter of x's fp32 bytes).
//
// What bounds it on the card: at the ViT-L/14 vision shapes (M = 64 * 257
// rows, K, N = 1024..4096) the product is 2*M*N*K = 35-138 G int8
// operations, 17-70 us at the 1,979 TOPS dense int8 peak; the bytes that
// must move (x read, y written, q) are 136-340 MB in fp32, 40-100 us at
// 3.35 TB/s, so fp32 calls are bytes bound and the larger bf16 ones
// operations bound. This version runs at 5-6x that bound (PERF.md):
// mma.sync from a single-buffered shared tile reaches only part of the int8
// peak, whose full rate needs wgmma with TMA-fed tiles, and the row pass
// reads x once more. It is the simple version that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kStride = kBK + 16;  // bytes per shared row: conflict-free fragment reads
constexpr int kThreads = 256;
constexpr int kRowThreads = 256;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------- row pass

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ static_scale,
                  int8_t* __restrict__ xq, float* __restrict__ row_scale, int K, int Kp) {
  __shared__ float warp_max[kRowThreads / 32];
  __shared__ float s_shared;
  const int m = blockIdx.x;
  const T* xr = x + (size_t)m * K;
  float s;
  if (static_scale != nullptr) {
    s = *static_scale;
  } else {
    float amax = 0.f;
    for (int k = threadIdx.x; k < K; k += kRowThreads) amax = fmaxf(amax, fabsf(to_float(xr[k])));
    for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
    __syncthreads();
    if (threadIdx.x == 0) {
      float a = warp_max[0];
      for (int w = 1; w < kRowThreads / 32; ++w) a = fmaxf(a, warp_max[w]);
      s_shared = fmaxf(__fdiv_rn(a, 127.f), 1e-12f);
    }
    __syncthreads();
    s = s_shared;
  }
  if (threadIdx.x == 0) row_scale[m] = s;
  int8_t* out = xq + (size_t)m * Kp;
  for (int k = threadIdx.x; k < Kp; k += kRowThreads) {
    int v = 0;
    if (k < K) {
      const float r = rintf(__fdiv_rn(to_float(xr[k]), s));  // half to even
      v = (int)fminf(fmaxf(r, -127.f), 127.f);
    }
    out[k] = (int8_t)v;
  }
}

// ---------------------------------------------------------------- GEMM

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4 bytes q[k, n .. n+3], zeros past K or N
__device__ __forceinline__ uint32_t load_q4(const int8_t* __restrict__ q, int k, int n, int K,
                                            int N, bool vec) {
  if (k >= K) return 0u;
  const int8_t* p = q + (size_t)k * N + n;
  if (vec && n + 3 < N) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < N) v |= (uint32_t)(uint8_t)p[j] << (8 * j);
  return v;
}

struct Tiles {
  uint4 a[2];      // two 16-byte pieces of the activation tile
  uint32_t b[2][4];  // two 4 x 4 byte blocks of the weight tile, row by row
};

__device__ __forceinline__ void load_tiles(Tiles& t, const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ q, int m0, int n0, int k0,
                                           int M, int N, int K, int Kp, bool vec) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads;  // 512 pieces: 128 rows x 4
    const int r = idx >> 2, c = (idx & 3) * 16;
    const int m = m0 + r;
    t.a[i] = m < M ? *reinterpret_cast<const uint4*>(xq + (size_t)m * Kp + k0 + c)
                   : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // 512 blocks of 4 x 4: a warp covers 8 column blocks x 4 row blocks,
    // so each load instruction reads four full 32-byte sectors
    const int idx = threadIdx.x + i * kThreads;
    const int nb = (idx & 7) | ((idx >> 5) & 3) << 3;  // 0..31
    const int kb = ((idx >> 3) & 3) | (idx >> 7) << 2;  // 0..15
#pragma unroll
    for (int r = 0; r < 4; ++r) t.b[i][r] = load_q4(q, k0 + 4 * kb + r, n0 + 4 * nb, K, N, vec);
  }
}

__device__ __forceinline__ void store_tiles(const Tiles& t, int8_t* As, int8_t* Bs) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 2, c = (idx & 3) * 16;
    *reinterpret_cast<uint4*>(As + r * kStride + c) = t.a[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int nb = (idx & 7) | ((idx >> 5) & 3) << 3;
    const int kb = ((idx >> 3) & 3) | (idx >> 7) << 2;
    const uint32_t* v = t.b[i];
    // transpose the 4 x 4 bytes: word j holds column n = 4nb + j, k = 4kb .. 4kb+3
    const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140);  // n0: k0 k1, n1: k0 k1
    const uint32_t lo23 = __byte_perm(v[2], v[3], 0x5140);
    const uint32_t hi01 = __byte_perm(v[0], v[1], 0x7362);  // n2, n3 of rows 0, 1
    const uint32_t hi23 = __byte_perm(v[2], v[3], 0x7362);
    const uint32_t col[4] = {
        __byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
        __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(Bs + (4 * nb + j) * kStride + 4 * kb) = col[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ row_scale,
                 const int8_t* __restrict__ q, const float* __restrict__ col_scale,
                 const float* __restrict__ bias, T* __restrict__ y, int M, int N, int K, int Kp,
                 int vec) {
  __shared__ __align__(16) int8_t As[kBM * kStride];
  __shared__ __align__(16) int8_t Bs[kBN * kStride];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  Tiles t;
  load_tiles(t, xq, q, m0, n0, 0, M, N, K, Kp, vec != 0);
  for (int k0 = 0; k0 < Kp; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    store_tiles(t, As, Bs);
    __syncthreads();
    if (k0 + kBK < Kp) load_tiles(t, xq, q, m0, n0, k0 + kBK, M, N, K, Kp, vec != 0);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* base = As + (wm + 16 * i + g) * kStride + kk + 4 * tq;
        a[i][0] = *reinterpret_cast<const uint32_t*>(base);
        a[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
        a[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* base = Bs + (wn + 8 * j + g) * kStride + kk + 4 * tq;
        b[j][0] = *reinterpret_cast<const uint32_t*>(base);
        b[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }

  // epilogue: c0, c1 at (row g, cols 2tq, 2tq+1); c2, c3 at row g + 8
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
      const float rs = row_scale[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + 8 * j + 2 * tq + e;
          if (n >= N) continue;
          float v = __fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), __fmul_rn(rs, col_scale[n]));
          if (bias != nullptr) v = __fadd_rn(v, bias[n]);
          y[(size_t)m * N + n] = from_float<T>(v);
        }
      }
    }
  }
}

template <typename T>
int launch_rows(const void* x, const void* static_scale, void* xq, void* row_scale, int M, int K,
                int Kp, cudaStream_t stream) {
  quant_rows_kernel<T><<<M, kRowThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(static_scale),
      static_cast<int8_t*>(xq), static_cast<float*>(row_scale), K, Kp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* static_scale, void* xq, void* row_scale, const void* q,
           const void* col_scale, const void* bias, void* y, int M, int K, int N, int Kp, int vec,
           cudaStream_t stream) {
  const int e = launch_rows<T>(x, static_scale, xq, row_scale, M, K, Kp, stream);
  if (e != 0) return e;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(row_scale),
      static_cast<const int8_t*>(q), static_cast<const float*>(col_scale),
      static_cast<const float*>(bias), static_cast<T*>(y), M, N, K, Kp, vec);
  return (int)cudaGetLastError();
}

bool valid(int M, int K, int N, int Kp) {
  return M >= 1 && K >= 1 && N >= 1 && Kp >= K && Kp % kBK == 0 && Kp - K < kBK;
}

}  // namespace

// y = (rowquant(x) . q) * (row_scale (x) col_scale) + bias, two launches.
// x [M, K] (dtype 0 fp32, 1 bf16); static_scale: one fp32 on the device, or
// null for dynamic per-row scales; xq [M, Kp] int8 and row_scale [M] fp32
// are scratch the caller allocates (Kp = K rounded up to 64); q [K, N]
// int8; col_scale [N] fp32; bias [N] fp32 or null; y [M, N] in x's dtype.
// vec: 1 when q's rows may be read 4 bytes at a time (N % 4 == 0 and q
// 4-byte aligned). Returns cudaGetLastError() after the launches.
extern "C" int clip_quant_matmul(const void* x, const void* static_scale, void* xq,
                                 void* row_scale, const void* q, const void* col_scale,
                                 const void* bias, void* y, int M, int K, int N, int Kp,
                                 int dtype, int vec, void* stream) {
  if (!valid(M, K, N, Kp) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch<float>(x, static_scale, xq, row_scale, q, col_scale, bias, y, M, K, N, Kp, vec, s)
             : launch<__nv_bfloat16>(x, static_scale, xq, row_scale, q, col_scale, bias, y, M, K, N,
                                     Kp, vec, s);
}

// The row pass alone (launch 1 of clip_quant_matmul), for checking the int8
// payload and the row scales against the plain version.
extern "C" int clip_quant_rows(const void* x, const void* static_scale, void* xq, void* row_scale,
                               int M, int K, int Kp, int dtype, void* stream) {
  if (!valid(M, K, 1, Kp) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_rows<float>(x, static_scale, xq, row_scale, M, K, Kp, s)
                    : launch_rows<__nv_bfloat16>(x, static_scale, xq, row_scale, M, K, Kp, s);
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
