// Multi-head attention forward over the packed QKV projection, for sm_90a
// (K1).
//
// Replaces the forward Pallas kernel of
// clip_event_tpu/ops/attention_pallas.py::fused_attention_qkv
// (_fwd_kernel, launched by _fused_qkv_fwd). Same contract:
//
//   qkv  [B, S, 3W]  fp32 or bf16, contiguous; q lanes [0, W), k [W, 2W),
//                    v [2W, 3W), head h at [h*D, (h+1)*D) within each
//   bias [S, S]      fp32 additive mask (may hold -inf), or null
//   out  [B, S, W]   softmax(q*scale . k^T + bias) . v per head, heads
//                    concatenated along the lanes, in qkv's dtype
//   lse  [B, H, S]   fp32, optional (tensor-core variants only): each row's
//                    log-sum-exp of its scaled, biased scores, natural log;
//                    the backward reads it instead of recomputing the
//                    softmax statistics
//
// What bounds it: at the path shapes (text S=77 W=512 H=8, ViT-B/32 vision
// S=50 W=768 H=12, D=64) the work is 4*B*H*S^2*D flops against B*S*4W
// elements moved, ~2*S/3 flops per element. In bf16 on the tensor cores
// that is far under the card's 295 flops per byte: the bound is the memory
// rate (0.1085 ms at the B/32 train step's text call, B=1152, on the NVIDIA
// H100 80GB HBM3). In fp32 the bytes double (0.2169 ms there), which is
// still more than the operations take at fp32 accuracy on the tensor cores
// (three TF32 products a term at 495 TFLOP/s: 0.0848 ms).
//
// Three hand-written variants, chosen by dtype and head_dim alone before
// anything launches (`clip_attention_variant`, K2's rule; the Python
// wrapper's `k1_variant` is the same function as K2's `headgrid_variant`).
// None gives way to another.
//
// "mma": bf16 with D in {16, 32, 64, 128}, on the tensor cores:
// Hopper's warpgroup MMA (wgmma) fed by TMA, the device routine
// `wg::attend_fwd` of attention_wgmma.cuh, which K2 wraps too (the design
// and what it does about the bound are there). For K1's short sequences:
//   * Every head is resident: S <= 128 is at most two 64-key chunks, loaded
//     once by TMA, and the query tiles of a head (one at S <= 64, two at
//     S = 77) are dealt to the block's three consumer warpgroups, rotated
//     by the head, so the 13-row tile at S = 77 costs one warpgroup's
//     masked math.
//   * Persistent blocks, one an SM, walk the B * H heads; a producer
//     thread keeps the ring's chunks (eleven slots at D = 64: five heads
//     at S = 77) loading while the consumers compute, where the mma.sync
//     kernel before it copied, then computed, then stored, one head a
//     block.
//   * P is rounded to bf16 before P.V; the row sum l adds the unrounded
//     fp32 p; lse = m * ln 2 + log l. Rows and keys past S are zeros from
//     the TMA's bounds, and masked.
//
// "tf32x3": fp32 with D in {16, 32, 64, 128}, on the tensor cores in split
// TF32 (mma.sync.m16n8k8 tf32, three products a term, lo.hi' + hi.lo' +
// hi.hi'; helpers and the error argument in attention_mma.cuh), held to
// the same 1e-5 as the fp32 plain version. One block per (b, h), ceil(S/16)
// warps of 16 query rows, the whole head staged once by cp.async in fp32
// tiles of D + 4 floats a row: 65 KB at S = 77, D = 64. Each warp's core is `mma::attend_rows_tf32x3` (attention_mma.cuh,
// shared with K6, csrc/ln_qkv_attention.cu). What differs:
//   * A walk over 32-key chunks with K2's online softmax, not one pass:
//     the loop body stays small, and a chunk's 4 score tiles (16
//     registers, not the one-pass's 64) leave room for three blocks an SM
//     at S = 77. A full chunk runs a copy without the key-tail guards, so
//     its products interleave; only the last chunk is partial.
//   * Q's fragments are reloaded and split per k-step (held, they would
//     take 64 registers at D = 64); K's come by ldmatrix and are split per
//     use; scale, bias and the -inf masks on the accumulators, so nothing
//     infinite is split.
//   * Each 8-key tile of P, split in registers, is the A operand of P.V
//     over relabelled keys; V's B fragments by scalar shared loads.
//   * O / l in fp32, staged in the warp's own Q rows, 16-byte stores.
//
// "simt": bf16 and fp32 with another head_dim, on the CUDA cores. One
// block per (batch item, head) stages that head's K and V rows in shared
// memory as fp32, read by stride straight out of the packed rows, and each
// warp takes one query row at a time through logits, max, exp, sum and
// P.V, writing its slice of the output row. The softmax runs in fp32 and q
// is scaled before the dot product, as in _probs; every product and sum
// accumulates in fp32 on the CUDA cores out of shared memory, so it is
// limited by shared-memory loads.
//
// Limits, checked by the Python wrapper too: S <= 128, D <= 128; the mma
// and tf32x3 variants need 16-byte-aligned qkv and out, and the mma
// variant's TMA a row pitch (6W bytes) that is a multiple of 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"
#include "attention_wgmma.cuh"

namespace {

constexpr int kMaxS = 128;
constexpr int kMaxD = 128;

// ---------------------------------------------------------------- mma

constexpr int kMmaWarps = kMaxS / 16;  // the tf32x3 variant's most warps a block: 16 query rows each

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(wg::Geo<D>::kThreads, 1)
attention_fwd_kernel_wgmma(const __grid_constant__ wg::FwdParams p) {
  wg::attend_fwd<D, HAS_BIAS>(p);
}

template <int D>
int launch_wgmma(const void* qkv, const float* bias, void* out, float* lse, int B, int S, int H, float scale,
                 cudaStream_t stream) {
  static bool smem_allowed[2][wg::kMaxDevices] = {};
  if (bias != nullptr)
    return wg::launch_fwd<D>(attention_fwd_kernel_wgmma<D, true>, smem_allowed[1], qkv, bias, out, lse, B, S, H,
                             scale, stream);
  return wg::launch_fwd<D>(attention_fwd_kernel_wgmma<D, false>, smem_allowed[0], qkv, bias, out, lse, B, S, H,
                           scale, stream);
}

// ---------------------------------------------------------------- tf32x3

template <int D>
constexpr size_t fwd_tf32x3_smem_bytes(int rows) {
  // Q, K and V fp32 tiles of `rows` padded rows
  return (size_t)3 * rows * (D + mma::kPadF) * sizeof(float);
}

// Two blocks of 256 threads an SM at least: 128 registers a thread at D <= 64,
// which also lets three blocks of 5 warps share an SM at S = 77 (4 warps of
// 128 registers fill a sub-partition's 16,384). With the block size alone
// ptxas spends registers on hoisted bias loads until one block of 5 warps
// fills an SM.
template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kMmaWarps * 32, D <= 64 ? 2 : 1)
attention_fwd_kernel_tf32x3(const float* __restrict__ qkv, const float* __restrict__ bias,
                            float* __restrict__ out, float* __restrict__ lse, int S, int H,
                            float scale_log2e) {
  using namespace mma;
  constexpr int kStride = D + kPadF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = blockDim.x / 2;  // 16 per warp: S rounded up to 16
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [rows][D+4]
  float* sK = sQ + rows * kStride;                 // [rows][D+4]
  float* sV = sK + rows * kStride;                 // [rows][D+4]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int W = H * D;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row = 3 * (size_t)W;
  const float* base = qkv + (size_t)b * S * row + h * D;

  load_rows_f32<D>(sQ, base, row, rows, S, tid, blockDim.x);
  load_rows_f32<D>(sK, base + W, row, rows, S, tid, blockDim.x);
  load_rows_f32<D>(sV, base + 2 * W, row, rows, S, tid, blockDim.x);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float o[D / 8][4], m_run[2], l[2];
  attend_rows_tf32x3<D, HAS_BIAS>(sQ, sK, sV, bias, S, warp * 16, scale_log2e, lane, o, m_run, l);
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int ri = warp * 16 + g + 8 * r;
    if (lse != nullptr && t4 == 0 && ri < S)
      lse[(size_t)bh * S + ri] = l[r] > 0.f ? m_run[r] * kLn2 + logf(l[r]) : 0.f;
  }
  store_rows_f32<D>(sQ + warp * 16 * kStride, o, inv[0], inv[1],
                    out + ((size_t)b * S + warp * 16) * W + h * D, (size_t)W, S - warp * 16, lane);
}

template <int D, bool HAS_BIAS>
int launch_tf32x3(const void* qkv, const float* bias, void* out, float* lse, int B, int S, int H,
                  float scale, cudaStream_t stream) {
  static bool smem_allowed[mma::kMaxDevices] = {};
  auto kernel = attention_fwd_kernel_tf32x3<D, HAS_BIAS>;
  const int e = mma::allow_smem_once(kernel, fwd_tf32x3_smem_bytes<D>(16 * kMmaWarps), smem_allowed);
  if (e) return e;
  const long long blocks = (long long)B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int warps = (S + 15) / 16;
  kernel<<<(unsigned)blocks, warps * 32, fwd_tf32x3_smem_bytes<D>(16 * warps), stream>>>(
      static_cast<const float*>(qkv), bias, static_cast<float*>(out), lse, S, H, scale * mma::kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tf32x3_d(const void* qkv, const float* bias, void* out, float* lse, int B, int S, int H,
                    float scale, cudaStream_t stream) {
  if (bias != nullptr) return launch_tf32x3<D, true>(qkv, bias, out, lse, B, S, H, scale, stream);
  return launch_tf32x3<D, false>(qkv, bias, out, lse, B, S, H, scale, stream);
}

// ---------------------------------------------------------------- simt

constexpr int kWarps = 8;
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

// The variant that takes (dtype, D), K2's rule: 1 = "mma" (bf16 on the
// tensor cores, wgmma), 2 = "tf32x3" (fp32 on the tensor cores, split
// TF32), 0 = "simt" (the CUDA cores). dtype: 0 = fp32, 1 = bf16.
extern "C" int clip_attention_variant(int dtype, int D) {
  if (D != 16 && D != 32 && D != 64 && D != 128) return 0;
  return dtype == 1 ? 1 : dtype == 0 ? 2 : 0;
}

// dtype: 0 = fp32, 1 = bf16. `lse` may be null; the CUDA-core variant does
// not write it. Returns cudaGetLastError() after the launch.
extern "C" int clip_attention_fwd(const void* qkv, const void* bias, void* out, void* lse, int B,
                                  int S, int H, int D, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || S > kMaxS || H < 1 || D < 1 || D > kMaxD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* bias_f = static_cast<const float*>(bias);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (clip_attention_variant(dtype, D)) {
    case 1:
      switch (D) {
        case 16: return launch_wgmma<16>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
        case 32: return launch_wgmma<32>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
        case 64: return launch_wgmma<64>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
        default: return launch_wgmma<128>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
      }
    case 2:
      switch (D) {
        case 16: return launch_tf32x3_d<16>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
        case 32: return launch_tf32x3_d<32>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
        case 64: return launch_tf32x3_d<64>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
        default: return launch_tf32x3_d<128>(qkv, bias_f, out, lse_f, B, S, H, scale, s);
      }
    default:
      if (dtype == 0) return launch<float>(qkv, bias_f, out, B, S, H, D, scale, s);
      return launch<__nv_bfloat16>(qkv, bias_f, out, B, S, H, D, scale, s);
  }
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
