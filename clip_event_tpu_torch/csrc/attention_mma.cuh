// Tensor-core building blocks of the attention kernels, for sm_90a: bf16
// tiles in shared memory, asynchronous 16-byte copies into them, ldmatrix
// loads of mma.sync fragments, the m16n8k16 bf16 product with an fp32
// accumulator, and the register-only turn of an accumulator tile into the
// A operand of the next product; the same for fp32 tiles and split-TF32
// m16n8k8 products (below).
//
// Tile layout. A tile is ROWS rows of D bf16 values, row-major, with a row
// stride of D + 8 elements. The 16 bytes of padding move each row by 4
// banks, so the eight 16-byte rows one ldmatrix phase reads lie in eight
// different bank groups: no conflicts for D = 16, 32, 64 and 128, plain or
// transposed. Every row starts on a 16-byte boundary, which cp.async and
// ldmatrix need.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row):  a0 = (g, 2t..2t+1)      a1 = (g + 8, 2t..2t+1)
//                      a2 = (g, 2t+8..2t+9)    a3 = (g + 8, 2t+8..2t+9)
//   B (16 x 8, col):   b0 = (k 2t..2t+1, n g)  b1 = (k 2t+8..2t+9, n g)
//   C (16 x 8, fp32):  c0 = (g, 2t) c1 = (g, 2t+1) c2 = (g+8, 2t) c3 = (g+8, 2t+1)
// Two neighbouring C tiles (columns n0..n0+7 and n0+8..n0+15) hold exactly
// the elements of one A tile over k = n0..n0+15: `pack_a` rounds them to
// bf16 in place, so P and dS never pass through shared memory.
//
// Split-TF32 ("3xTF32", the `_f32` / `tf32` helpers at the end): fp32
// tiles (row stride D + 4 floats) feed mma.sync.m16n8k8 tf32 products.
// Each fp32 operand x is split as hi = tf32(x), lo = tf32(x - hi), both by
// cvt.rna, and a.b is summed as lo.hi' + hi.lo' + hi.hi' into fp32
// accumulators: every tf32 x tf32 product is exact, and what is dropped
// (lo.lo', the roundings of lo) is about 2^-22 of |a||b| a term, against
// fp32 FMA's 2^-24 (CUTLASS's OpMultiplyAddFastF32). Only finite values
// are split: -inf - (-inf) would be NaN, so masks and scales are applied
// on the accumulators.
//   A (16 x 8, row):  a0 = (g, t)  a1 = (g + 8, t)  a2 = (g, t + 4)  a3 = (g + 8, t + 4)
//   B (8 x 8, col):   b0 = (k t, n g)  b1 = (k t + 4, n g)
//   C (16 x 8, fp32): as above.
// Q, K, V and dO rows come as A, or as B of X^T, by ldmatrix: .b16 on fp32
// rows hands each lane one 32-bit word, (row g, word t) of each 8 x 4-word
// matrix. An accumulator tile (P, dS) becomes an A operand without a
// shuffle: the products sum over its columns, so its k positions are
// relabelled, t -> column 2t and t + 4 -> column 2t + 1 (a0 = c0, a1 = c2,
// a2 = c1, a3 = c3), and the B operand of X row-major as [k][n] is read
// with the same labels, rows k0 + 2t and k0 + 2t + 1 of column n0 + g, by
// scalar loads (ldmatrix.trans moves 16-bit elements only). With a row
// stride of D + 4 floats both reads are free of bank conflicts: ldmatrix's
// eight 16-byte rows start 4 banks apart, and the scalar loads of lane
// (g, t) fall on bank 8t + g.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace mma {

constexpr int kPad = 8;            // bf16 elements of padding per tile row
constexpr int kTile = 64;          // rows of a tile (queries or keys)
constexpr int kThreads = 128;      // 4 warps, 16 tile rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when `valid` is false
// (src-size 0 reads nothing, but the address must still be mapped).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, valid_rows) of a strided global matrix (row pitch `pitch`
// elements, D elements wide) into a padded tile of kTile rows; the rows
// past valid_rows are zero-filled (valid_rows >= 1).
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t pitch, int valid_rows, int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kStride = D + kPad;
  static_assert((kTile * kChunks) % kThreads == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * kStride + c * 8, src + (size_t)(ok ? r : 0) * pitch + c * 8, ok);
  }
}

// A tile of 16 rows for each warp of the block (blockDim.x / 2 rows in
// all), from rows [0, valid_rows) of a strided global matrix; the rows past
// valid_rows are zero-filled. Every thread copies D / 16 chunks.
template <int D>
__device__ __forceinline__ void load_warp_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               size_t pitch, int valid_rows, int tid, int nthreads) {
  constexpr int kChunks = D / 8;
  constexpr int kStride = D + kPad;
#pragma unroll
  for (int it = 0; it < D / 16; ++it) {
    const int idx = tid + it * nthreads;
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * kStride + c * 8, src + (size_t)(ok ? r : 0) * pitch + c * 8, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The A fragment of rows [row0, row0 + 16), columns [col0, col0 + 16) of a
// row-major tile with row stride `stride`.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int stride,
                                       int row0, int col0, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * stride + col0 + 8 * (lane >> 4));
}

// B fragments of X^T for two n-tiles, where the tile holds X row-major as
// [n][k] (K for q.k^T, V for dO.v^T, Q for k.q^T): n in [n0, n0 + 16), k in
// [k0, k0 + 16). b[0], b[1] feed the n-tile n0..n0+7; b[2], b[3] the next.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* tile, int stride,
                                          int n0, int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + 8 * (lane >> 4)) * stride + k0 + 8 * ((lane >> 3) & 1));
}

// B fragments of X for two n-tiles, where the tile holds X row-major as
// [k][n] (V for p.v, K for dS.k, dO for p^T.dO, Q for dS^T.q): k in
// [k0, k0 + 16), n in [n0, n0 + 16). b[0], b[1] feed n0..n0+7; b[2], b[3]
// the next n-tile.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* tile, int stride,
                                          int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * stride + n0 + 8 * (lane >> 4));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// `load_b_kn` for one n-tile: k in [k0, k0 + 16), n in [n0, n0 + 8) (lanes
// 0-15 give the addresses)
__device__ __forceinline__ void load_b_kn1(uint32_t (&b)[2], const __nv_bfloat16* tile, int stride,
                                           int k0, int n0, int lane) {
  ldmatrix_x2_trans(b, tile + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * stride + n0);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two neighbouring accumulator tiles, rounded to bf16, as one A fragment.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Sum / max over the 4 lanes that share an accumulator row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

// A backward score -> P, in units of log2: exp2(s * scale*log2e +
// bias*log2e - lse*log2e) for a key below S, else 0. The bias is read only
// inside the S x S square.
template <bool HAS_BIAS>
__device__ __forceinline__ float prob(float s, float scale_log2e, const float* __restrict__ bias,
                                      int qrow, int kcol, int S, float lse2) {
  float v = s * scale_log2e;
  if constexpr (HAS_BIAS) {
    if (qrow < S && kcol < S) v += bias[(size_t)qrow * S + kcol] * kLog2e;
  }
  return kcol < S ? exp2f(v - lse2) : 0.f;
}

// delta = rowsum(dO o O) of row `ri` (0 past S), in fp32: the 4 lanes of a
// quad (t4 = lane % 4) take D / 4 columns each and every lane of the quad
// gets the sum. dout and out point at the head's lanes of row 0, W apart.
template <int D>
__device__ __forceinline__ float row_delta(const __nv_bfloat16* dout, const __nv_bfloat16* out,
                                           int W, int ri, int S, int t4) {
  float part = 0.f;
  if (ri < S) {
    const __nv_bfloat162* gp =
        reinterpret_cast<const __nv_bfloat162*>(dout + (size_t)ri * W + t4 * (D / 4));
    const __nv_bfloat162* op =
        reinterpret_cast<const __nv_bfloat162*>(out + (size_t)ri * W + t4 * (D / 4));
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const float2 gv = __bfloat1622float2(gp[c]);
      const float2 ov = __bfloat1622float2(op[c]);
      part = fmaf(gv.x, ov.x, part);
      part = fmaf(gv.y, ov.y, part);
    }
  }
  return quad_sum(part);
}

// A warp's 16 x D fp32 accumulator rows, times `f`, rounded to bf16 and
// written straight from registers (4 bytes a lane) to dst[(row0 + r) *
// pitch + c] for the rows below `valid_rows`: for a result whose warp owns
// no spare tile rows to stage it in.
template <int D>
__device__ __forceinline__ void store_frag_rows(const float (&acc)[D / 8][4], float f,
                                                __nv_bfloat16* dst, size_t pitch, int valid_rows,
                                                int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    if (g < valid_rows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)g * pitch + nt * 8 + 2 * t) =
          pack_bf16(acc[nt][0] * f, acc[nt][1] * f);
    if (g + 8 < valid_rows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(g + 8) * pitch + nt * 8 + 2 * t) =
          pack_bf16(acc[nt][2] * f, acc[nt][3] * f);
  }
}

// A warp's 16 x D fp32 accumulator rows, times `factor` per row pair,
// rounded to bf16 into the warp's own 16 rows of a tile, then written with
// 16-byte stores to dst[(row0 + r) * pitch + c] for the rows below
// `valid_rows`. The caller owns those tile rows (only this warp reads them).
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* tile_rows, const float (&acc)[D / 8][4],
                                           float f0, float f1, __nv_bfloat16* dst, size_t pitch,
                                           int valid_rows, int lane) {
  constexpr int kStride = D + kPad;
  constexpr int kChunks = D / 8;
  const int g = lane >> 2;
  const int t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(tile_rows + g * kStride + nt * 8 + 2 * t) =
        pack_bf16(acc[nt][0] * f0, acc[nt][1] * f0);
    *reinterpret_cast<uint32_t*>(tile_rows + (g + 8) * kStride + nt * 8 + 2 * t) =
        pack_bf16(acc[nt][2] * f1, acc[nt][3] * f1);
  }
  __syncwarp();
  static_assert((16 * kChunks) % 32 == 0, "every lane stores the same number of chunks");
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int idx = lane + it * 32;
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    if (r < valid_rows)
      *reinterpret_cast<int4*>(dst + (size_t)r * pitch + c * 8) =
          *reinterpret_cast<const int4*>(tile_rows + r * kStride + c * 8);
  }
}

// ---------------------------------------------------------------- tf32

constexpr int kPadF = 4;  // fp32 elements of padding per fp32 tile row

// Rows [0, valid_rows) of a strided fp32 global matrix (row pitch `pitch`
// floats, D wide) into a padded fp32 tile of kTile rows (row stride
// D + kPadF); the rows past valid_rows are zero-filled (valid_rows >= 1).
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, size_t pitch,
                                              int valid_rows, int tid) {
  constexpr int kChunks = D / 4;
  constexpr int kStride = D + kPadF;
  static_assert((kTile * kChunks) % kThreads == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * kStride + c * 4, src + (size_t)(ok ? r : 0) * pitch + c * 4, ok);
  }
}

// Rows [0, valid_rows) of a strided fp32 global matrix into `rows` padded
// rows of an fp32 tile (row stride D + kPadF), zero-filled past
// valid_rows, by `nthreads` threads: K1's whole-head tiles (16 rows for
// each warp of the block, or every row of the head) and its 64-row tiles.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, size_t pitch, int rows,
                                              int valid_rows, int tid, int nthreads) {
  constexpr int kChunks = D / 4;
  constexpr int kStride = D + kPadF;
  for (int idx = tid; idx < rows * kChunks; idx += nthreads) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * kStride + c * 4, src + (size_t)(ok ? r : 0) * pitch + c * 4, ok);
  }
}

// fp32 -> tf32, round to nearest, ties away from zero; the low 13 bits
// of the result are 0
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// hi = tf32(x), lo = tf32(x - hi); x - hi is exact in fp32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// the split of every word of a fragment that holds fp32 bit patterns
__device__ __forceinline__ void split_frag(const uint32_t (&x)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// An accumulator tile as the split A fragment of its relabelled columns
// (a0 = c0, a1 = c2, a2 = c1, a3 = c3): B must come from `load_b_kn_f32`.
__device__ __forceinline__ void split_acc(const float (&c)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// The A fragment of rows [row0, row0 + 16), columns [col0, col0 + 8) of a
// row-major fp32 tile with row stride `stride` (unsplit fp32 bits).
__device__ __forceinline__ void load_a_f32(uint32_t (&a)[4], const float* tile, int stride, int row0,
                                           int col0, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * stride + col0 + 4 * (lane >> 4));
}

// B fragments of X^T for two n-tiles, where the fp32 tile holds X
// row-major as [n][k]: n in [n0, n0 + 16), k in [k0, k0 + 8). b[0], b[1]
// feed the n-tile n0..n0+7; b[2], b[3] the next (unsplit fp32 bits).
__device__ __forceinline__ void load_b_nk_f32(uint32_t (&b)[4], const float* tile, int stride, int n0,
                                              int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + 8 * (lane >> 4)) * stride + k0 + 4 * ((lane >> 3) & 1));
}

// The split B fragment of X for one n-tile, where the fp32 tile holds X
// row-major as [k][n], k in [k0, k0 + 8) relabelled as `split_acc` does:
// lane (g, t) reads rows k0 + 2t and k0 + 2t + 1 of column n0 + g.
__device__ __forceinline__ void load_b_kn_f32(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* tile,
                                              int stride, int k0, int n0, int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * stride + n0 + (lane >> 2);
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[stride], hi[1], lo[1]);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c0 += a0.b0 and c1 += a1.b1 in split TF32, each as lo.hi' + hi.lo'
// (the small terms first) + hi.hi', the two sums' products side by side so
// that no product waits on the one before it (b: the hi and lo words of
// one n-tile's B fragment)
__device__ __forceinline__ void mma_tf32x3_2(float (&c0)[4], const uint32_t (&a0hi)[4],
                                             const uint32_t (&a0lo)[4], uint32_t b0h0, uint32_t b0h1,
                                             uint32_t b0l0, uint32_t b0l1, float (&c1)[4],
                                             const uint32_t (&a1hi)[4], const uint32_t (&a1lo)[4],
                                             uint32_t b1h0, uint32_t b1h1, uint32_t b1l0,
                                             uint32_t b1l1) {
  mma_tf32(c0, a0lo, b0h0, b0h1);
  mma_tf32(c1, a1lo, b1h0, b1h1);
  mma_tf32(c0, a0hi, b0l0, b0l1);
  mma_tf32(c1, a1hi, b1l0, b1l1);
  mma_tf32(c0, a0hi, b0h0, b0h1);
  mma_tf32(c1, a1hi, b1h0, b1h1);
}

// c0 += a.b and c1 += a.b' for the two n-tiles of one split B pair
// (`load_b_nk_f32`), interleaved as `mma_tf32x3_2`
__device__ __forceinline__ void mma_tf32x3_x2(float (&c0)[4], float (&c1)[4], const uint32_t (&ahi)[4],
                                              const uint32_t (&alo)[4], const uint32_t (&bhi)[4],
                                              const uint32_t (&blo)[4]) {
  mma_tf32x3_2(c0, ahi, alo, bhi[0], bhi[1], blo[0], blo[1], c1, ahi, alo, bhi[2], bhi[3], blo[2],
               blo[3]);
}

constexpr int kKeyChunkF = 32;  // keys a chunk of the tf32x3 forward's walk

// The tf32x3 attention forward of one warp's 16 query rows [q0, q0 + 16)
// against keys [0, S) of fp32 tiles sQ, sK, sV (row stride D + kPadF,
// rows past S zero): K1's "tf32x3" core (csrc/attention_fwd.cu), also
// K6's (csrc/ln_qkv_attention.cu). Leaves the unnormalized O in `o`, each
// row's running max in units of log2 in `m_run` and its full row sum in
// `l` (rows q0 + g and q0 + g + 8).
//   * A walk over 32-key chunks with K2's online softmax: a chunk's 4
//     score tiles take 16 registers. A full chunk runs a copy without the
//     key-tail guards, so its products interleave; only the last chunk is
//     partial.
//   * Q's fragments are reloaded and split per k-step (held, they would
//     take 16 D registers); K's come by ldmatrix and are split per use;
//     scale, bias and the -inf masks on the accumulators, so nothing
//     infinite is split.
//   * Each 8-key tile of P, split in registers, is the A operand of P.V
//     over relabelled keys; V's B fragments by scalar shared loads.
template <int D, bool HAS_BIAS>
__device__ __forceinline__ void attend_rows_tf32x3(const float* sQ, const float* sK, const float* sV,
                                                   const float* __restrict__ bias, int S, int q0,
                                                   float scale_log2e, int lane, float (&o)[D / 8][4],
                                                   float (&m_run)[2], float (&l)[2]) {
  constexpr int kStride = D + kPadF;
  constexpr int kSteps = D / 8;  // k-steps of 8 over the head dim
  constexpr int kTiles = kKeyChunkF / 8;  // 8-key n-tiles of a chunk
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row_g = q0 + g;  // this thread's rows: row_g, row_g + 8
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  m_run[0] = m_run[1] = -INFINITY;
  float l_run[2] = {0.f, 0.f};

  for (int j0 = 0; j0 < S; j0 += kKeyChunkF) {
    const int nk = S - j0;
    // one chunk of keys; `full` (a compile-time bool) drops the guards of
    // the keys past S, so that a full chunk's products share one basic
    // block and interleave; only the last chunk is partial
    auto chunk = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      // scores of 16 rows x the chunk's keys in split TF32; Q's fragments
      // are reloaded and split per k-step (held, they would take 16 D
      // registers and halve the blocks an SM holds)
      float s[kTiles][4];
#pragma unroll
      for (int n = 0; n < kTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t x[4], ah[4], al[4];
        load_a_f32(x, sQ, kStride, q0, ks * 8, lane);
        split_frag(x, ah, al);
#pragma unroll
        for (int p = 0; p < kTiles / 2; ++p) {
          if (kFull || p * 16 < nk) {
            uint32_t fh[4], fl[4];
            load_b_nk_f32(x, sK, kStride, j0 + p * 16, ks * 8, lane);
            split_frag(x, fh, fl);
            mma_tf32x3_x2(s[2 * p], s[2 * p + 1], ah, al, fh, fl);
          }
        }
      }
      // scale, bias and the key tail's mask in units of log2, on the
      // accumulators: nothing infinite is ever split
#pragma unroll
      for (int n = 0; n < kTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j0 + n * 8 + 2 * t4 + (e & 1);
          float v = s[n][e] * scale_log2e;
          if constexpr (HAS_BIAS) {
            const int r = row_g + 8 * (e >> 1);
            if (r < S && col < S) v += bias[(size_t)r * S + col] * kLog2e;
          }
          if (!kFull && col >= S) v = -INFINITY;
          s[n][e] = v;
        }
      }
      // online softmax per row (rows row_g and row_g + 8), as K2's: a row
      // that has seen only -inf keeps m = -inf and takes its exponent
      // against 0, so -inf - (-inf) never forms
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < kTiles; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = quad_max(mx);
        const float m_new = fmaxf(m_run[r], mx);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m_run[r] - m_safe);
        m_run[r] = m_new;
        float psum = 0.f;
#pragma unroll
        for (int n = 0; n < kTiles; ++n) {
          const float p0 = exp2f(s[n][2 * r] - m_safe);
          const float p1 = exp2f(s[n][2 * r + 1] - m_safe);
          s[n][2 * r] = p0;
          s[n][2 * r + 1] = p1;
          psum += p0 + p1;
        }
        l_run[r] = l_run[r] * corr + psum;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[n][2 * r] *= corr;
          o[n][2 * r + 1] *= corr;
        }
      }
      // O += P . V: each 8-key tile of P, split in registers, is an A
      // operand over relabelled keys; V's B fragments by scalar shared loads
#pragma unroll
      for (int n = 0; n < kTiles; ++n) {
        if (kFull || n * 8 < nk) {
          uint32_t ph[4], pl[4];
          split_acc(s[n], ph, pl);
#pragma unroll
          for (int dn = 0; dn < D / 8; dn += 2) {
            uint32_t vh[2], vl[2], wh[2], wl[2];
            load_b_kn_f32(vh, vl, sV, kStride, j0 + n * 8, dn * 8, lane);
            load_b_kn_f32(wh, wl, sV, kStride, j0 + n * 8, dn * 8 + 8, lane);
            mma_tf32x3_2(o[dn], ph, pl, vh[0], vh[1], vl[0], vl[1], o[dn + 1], ph, pl, wh[0], wh[1],
                         wl[0], wl[1]);
          }
        }
      }
    };
    if (nk >= kKeyChunkF)
      chunk(std::true_type());
    else
      chunk(std::false_type());
  }
  l[0] = quad_sum(l_run[0]);
  l[1] = quad_sum(l_run[1]);
}

// delta = rowsum(dO o O) of row `ri` (0 past S), fp32 rows: the 4 lanes
// of a quad take D / 4 columns each (16-byte loads) and every lane of the
// quad gets the sum. dout and out point at the head's lanes of row 0.
template <int D>
__device__ __forceinline__ float row_delta_f32(const float* dout, const float* out, int W, int ri,
                                               int S, int t4) {
  float part = 0.f;
  if (ri < S) {
    const float4* gp = reinterpret_cast<const float4*>(dout + (size_t)ri * W + t4 * (D / 4));
    const float4* op = reinterpret_cast<const float4*>(out + (size_t)ri * W + t4 * (D / 4));
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float4 gv = gp[c];
      const float4 ov = op[c];
      part = fmaf(gv.x, ov.x, part);
      part = fmaf(gv.y, ov.y, part);
      part = fmaf(gv.z, ov.z, part);
      part = fmaf(gv.w, ov.w, part);
    }
  }
  return quad_sum(part);
}

// A warp's 16 x D fp32 accumulator rows, times `f`, written straight
// from registers (8 bytes a lane) to dst[r * pitch + c] for r <
// valid_rows: for a result whose warp has no spare tile rows to stage it.
template <int D>
__device__ __forceinline__ void store_frag_rows_f32(const float (&acc)[D / 8][4], float f, float* dst,
                                                    size_t pitch, int valid_rows, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    if (g < valid_rows)
      *reinterpret_cast<float2*>(dst + (size_t)g * pitch + nt * 8 + 2 * t) =
          make_float2(acc[nt][0] * f, acc[nt][1] * f);
    if (g + 8 < valid_rows)
      *reinterpret_cast<float2*>(dst + (size_t)(g + 8) * pitch + nt * 8 + 2 * t) =
          make_float2(acc[nt][2] * f, acc[nt][3] * f);
  }
}

// `store_rows` for fp32: a warp's 16 x D accumulator rows, times f0 (rows
// g) and f1 (rows g + 8), staged in the warp's own 16 rows of an fp32 tile
// and written with 16-byte stores to dst[r * pitch + c] for r < valid_rows.
template <int D>
__device__ __forceinline__ void store_rows_f32(float* tile_rows, const float (&acc)[D / 8][4], float f0,
                                               float f1, float* dst, size_t pitch, int valid_rows,
                                               int lane) {
  constexpr int kStride = D + kPadF;
  constexpr int kChunks = D / 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    *reinterpret_cast<float2*>(tile_rows + g * kStride + nt * 8 + 2 * t) =
        make_float2(acc[nt][0] * f0, acc[nt][1] * f0);
    *reinterpret_cast<float2*>(tile_rows + (g + 8) * kStride + nt * 8 + 2 * t) =
        make_float2(acc[nt][2] * f1, acc[nt][3] * f1);
  }
  __syncwarp();
  static_assert((16 * kChunks) % 32 == 0, "every lane stores the same number of chunks");
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int idx = lane + it * 32;
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    if (r < valid_rows)
      *reinterpret_cast<float4*>(dst + (size_t)r * pitch + c * 4) =
          *reinterpret_cast<const float4*>(tile_rows + r * kStride + c * 4);
  }
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel
// instantiation and device, not per launch. `done` is the instantiation's
// own table (a static in its launch function).
constexpr int kMaxDevices = 64;

template <typename K>
int allow_smem_once(K kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 0 && dev < kMaxDevices && done[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return 0;
}

}  // namespace mma
