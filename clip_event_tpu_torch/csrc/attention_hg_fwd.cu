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
//   out  [B, S, W]   softmax(q*scale . k^T + bias) . v per head, heads
//                    concatenated along the lanes, in qkv's dtype
//
// Every product and sum is fp32; q is scaled before the dot product.
//
// Why a second kernel. K1 (attention_fwd.cu) stages a head's whole K and V
// in shared memory, which stops at S = 128; the ViT-B/16 and ViT-L/14
// vision towers have S = 197 and 257. The TPU kernel answered its VMEM
// limit by taking one 128-lane head group per program. On Hopper the limit
// is the 227 KB of shared memory a block may use, and the answer is a
// FlashAttention-style walk: one block per (batch item, head, tile of 64
// query rows) holds its scaled q rows, and K and V pass through shared
// memory 64 keys at a time. Each query row keeps a running max m, a running
// sum l and an unnormalized output row in fp32; when a tile raises the max,
// l and the output row are scaled by exp(m_old - m_new) before the tile's
// terms are added, and the row is divided by l at the end. Shared memory is
// then bounded by the tile sizes whatever S is. A tile in which a row has
// only masked keys (-inf) and no earlier unmasked key leaves the row as it
// was. q, k and v are read by stride straight out of the packed rows and
// the output is written to the head's D lanes: nothing is split, transposed
// or copied on the host.
//
// What bounds it: at the vision shapes (S=197 W=768 H=12, S=257 W=1024
// H=16, D=64) the work is 4*B*H*S^2*D flops against B*S*4W elements moved,
// ~2*S/3 flops per element, which on the card's fp32 CUDA cores is the
// operation rate (67 TFLOP/s), and in bf16 on the tensor cores the memory
// rate. This simple first version runs the inner products on the CUDA
// cores out of shared memory (a broadcast q or p value and one K or V value
// per FMA), so it is limited by shared-memory loads, well above either
// floor; tensor-core tiles (mma.sync / wgmma) are later work.
//
// Limits, checked by the Python wrapper too: D <= 128; any S >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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
  const size_t smem = smem_floats(D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_hg_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (S + kQTile - 1) / kQTile;
  const long long blocks = (long long)B * H * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  attention_hg_fwd_kernel<T><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), bias, static_cast<T*>(out), S, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int clip_attention_hg_fwd(const void* qkv, const void* bias, void* out, int B, int S,
                                     int H, int D, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > kMaxD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* bias_f = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(qkv, bias_f, out, B, S, H, D, scale, s);
  return launch<__nv_bfloat16>(qkv, bias_f, out, B, S, H, D, scale, s);
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
