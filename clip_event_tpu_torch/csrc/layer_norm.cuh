// What the fused LayerNorm kernels (layer_norm.cu: K4a, K4b;
// layer_norm_bwd.cu: K4c) share: the widths they take, the two paths'
// geometry, the conversions between the I/O type and fp32, the vector moves
// and the warp reduction.
//
// Two paths, picked by the caller from the width and the pointers' alignment:
//
//   registers  W % 8 == 0, W <= kRegMaxW and every pointer 16-byte aligned
//              (every CLIP preset's width: 512, 640, 768, 1024, 1280). A
//              lane holds its columns of the row in registers, as 16-byte
//              vectors (8 bf16 or 4 fp32): S = ceil(W / 256) slots of 8
//              elements each, a compile-time count. Lane l's vector i is the
//              row's vector i * 32 + l, so a warp's load is 512 contiguous
//              bytes; the last slot is partly empty where W / 8 is no
//              multiple of 32 (W = 640).
//   generic    any other width up to kMaxW, or a misaligned view: the row is
//              parked in shared memory as fp32, 4 elements at a time where
//              W % 4 == 0 and the pointers allow it, else one at a time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ln {

constexpr int kWarps = 4;      // warps a block, one row at a time each
constexpr int kMaxW = 3072;    // widest row the generic path takes
constexpr int kRegMaxW = 1280; // widest row the register path takes
constexpr int kMaxSlots = kRegMaxW / 256;

// path codes of the C entry points
constexpr int kGeneric = 0;
constexpr int kRegisters = 1;

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

// x rounded to the I/O type and read back as fp32
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// ---- 16-byte vectors of the register path, kept as raw bits

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static float2 pair(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
  __device__ __forceinline__ static uint32_t word(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static void unpack(const uint4& r, float (&v)[8]) {
    float2 t;
    t = pair(r.x); v[0] = t.x; v[1] = t.y;
    t = pair(r.y); v[2] = t.x; v[3] = t.y;
    t = pair(r.z); v[4] = t.x; v[5] = t.y;
    t = pair(r.w); v[6] = t.x; v[7] = t.y;
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[8]) {
    return make_uint4(word(v[0], v[1]), word(v[2], v[3]), word(v[4], v[5]), word(v[6], v[7]));
  }
};

__device__ __forceinline__ uint4 load16(const void* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ void store16(void* p, const uint4& v) { *reinterpret_cast<uint4*>(p) = v; }

// E consecutive fp32 values of gamma or beta (E = 4 or 8), 16 bytes a load
template <int E>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[E]) {
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
  }
}

// ---- 4-element moves of the generic path (16 bytes in fp32, 8 in bf16)

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = Vec<__nv_bfloat16>::pair(t.x);
  const float2 b = Vec<__nv_bfloat16>::pair(t.y);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(Vec<__nv_bfloat16>::word(v[0], v[1]), Vec<__nv_bfloat16>::word(v[2], v[3]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a / w as a division rounds it, from the host's rounded 1 / w: one
// correction step (the fast path of IEEE division, without its slow-path
// call, which costs registers), so a row of equal values has exactly their
// value as its mean
__device__ __forceinline__ float div_w(float a, float w, float inv_w) {
  const float q = a * inv_w;
  return fmaf(fmaf(-q, w, a), inv_w, q);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// S, the register path's slots a lane, for width W
inline int slots(int W) { return (W + 255) / 256; }

}  // namespace ln
