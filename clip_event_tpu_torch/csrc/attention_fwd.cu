// Multi-head attention forward over the packed QKV projection, for sm_90a.
//
// Replaces the forward Pallas kernel of
// clip_event_tpu/ops/attention_pallas.py::fused_attention_qkv
// (_fwd_kernel, launched by _fused_qkv_fwd). Same contract:
//
//   qkv  [B, S, 3W]  fp32 or bf16, contiguous; q lanes [0, W), k [W, 2W),
//                    v [2W, 3W), head h at [h*D, (h+1)*D) within each
//   bias [S, S]      fp32 additive mask, or null
//   out  [B, S, W]   softmax(q*scale . k^T + bias) . v per head, heads
//                    concatenated along the lanes, in qkv's dtype
//
// The softmax runs in fp32 and q is scaled before the dot product, as in
// _probs. Every product and sum accumulates in fp32.
//
// What bounds it: at the serving shapes (text S=77 W=512 H=8, ViT-B/32
// vision S=50 W=768 H=12) the work is 4*B*H*S^2*D flops against
// B*S*4W elements moved, a few flops per byte, so the card's memory rate is
// the floor. This design reads qkv exactly once: one block per
// (batch item, head) stages that head's K and V rows in shared memory as
// fp32, read by stride straight out of the packed rows (no split, transpose
// or copy on the host), and each warp takes one query row at a time through
// logits, max, exp, sum and P.V, writing its slice of the output row. The
// logits and probabilities never leave shared memory and registers. It is
// the simple first version: the inner products run on the CUDA cores out of
// shared memory, so at these sizes it is limited by shared-memory loads,
// not by device memory.
//
// Limits, checked by the Python wrapper too: S <= 128, D <= 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxS = 128;
constexpr int kMaxD = 128;
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

// Row stride of the staged K tile. Odd, so the 32 lanes of a warp, each
// reading column d of a different key row, hit 32 different banks.
__host__ __device__ __forceinline__ int key_stride(int D) { return D | 1; }

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                     T* __restrict__ out, int S, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int W = H * D;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int ks_stride = key_stride(D);
  float* ks = smem;                   // [S, D|1]
  float* vs = ks + S * ks_stride;     // [S, D]
  float* qs = vs + S * D;             // [kWarps, D]  one scaled q row per warp
  float* ps = qs + kWarps * D;        // [kWarps, S]  one probability row per warp

  const size_t row = 3 * (size_t)W;  // packed rows are 3W apart, not W
  const T* base = qkv + (size_t)b * S * row + h * D;

  for (int idx = threadIdx.x; idx < S * D; idx += blockDim.x) {
    const int j = idx / D;
    const int d = idx - j * D;
    const T* r = base + (size_t)j * row + d;
    ks[j * ks_stride + d] = to_float(r[W]);
    vs[j * D + d] = to_float(r[2 * W]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* q = qs + warp * D;
  float* p = ps + warp * S;

  for (int i = warp; i < S; i += kWarps) {
    const T* qrow = base + (size_t)i * row;
    for (int d = lane; d < D; d += 32) q[d] = to_float(qrow[d]) * scale;
    __syncwarp();

    // logits for keys lane, lane+32, ...; the padding slots hold -inf
    float lg[kKeySlots];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kKeySlots; ++t) {
      const int j = lane + 32 * t;
      float s = -INFINITY;
      if (j < S) {
        const float* kr = ks + j * ks_stride;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(q[d], kr[d], acc);
        s = bias ? acc + bias[i * S + j] : acc;
      }
      lg[t] = s;
      m = fmaxf(m, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));

    // a masked key (-inf) gets exactly 0; the row max is finite as long as
    // the row has one unmasked key (the causal diagonal is 0)
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kKeySlots; ++t) {
      const int j = lane + 32 * t;
      const float e = j < S ? expf(lg[t] - m) : 0.f;
      lg[t] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int t = 0; t < kKeySlots; ++t) {
      const int j = lane + 32 * t;
      if (j < S) p[j] = lg[t] / sum;
    }
    __syncwarp();

    T* orow = out + ((size_t)b * S + i) * W + h * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(p[j], vs[j * D + d], acc);
      orow[d] = from_float<T>(acc);
    }
    __syncwarp();  // q and p are rewritten for the warp's next row
  }
}

template <typename T>
int launch(const void* qkv, const float* bias, void* out, int B, int S, int H, int D,
           float scale, cudaStream_t stream) {
  const size_t smem =
      ((size_t)S * key_stride(D) + (size_t)S * D + (size_t)kWarps * (D + S)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  attention_fwd_kernel<T><<<B * H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), bias, static_cast<T*>(out), S, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int clip_attention_fwd(const void* qkv, const void* bias, void* out, int B, int S,
                                  int H, int D, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || S > kMaxS || H < 1 || D < 1 || D > kMaxD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* bias_f = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(qkv, bias_f, out, B, S, H, D, scale, s);
  return launch<__nv_bfloat16>(qkv, bias_f, out, B, S, H, D, scale, s);
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
