// Multi-head attention backward over the packed QKV projection, for sm_90a
// (K1).
//
// Replaces the backward Pallas kernel of
// clip_event_tpu/ops/attention_pallas.py::fused_attention_qkv
// (_bwd_kernel, launched by _fused_qkv_bwd). Same contract:
//
//   qkv   [B, S, 3W]  fp32 or bf16, contiguous; q lanes [0, W), k [W, 2W),
//                     v [2W, 3W), head h at [h*D, (h+1)*D) within each
//   bias  [S, S]      fp32 additive mask (may hold -inf), or null (it gets
//                     no gradient)
//   do    [B, S, W]   the output's cotangent, qkv's dtype
//   out   [B, S, W]   the forward's output and
//   lse   [B, H, S]   its fp32 row log-sum-exp (natural log): read by the
//                     tensor-core variants only
//   dqkv  [B, S, 3W]  written once, packed like qkv, in qkv's dtype
//   stats [3, B, H, S] fp32 scratch of the CUDA-core variant: the softmax
//                     row max m, row sum l and delta = rowsum(dP o P) of
//                     every query row (null for the tensor-core variants)
//
// The math is _bwd_kernel's:
//   P  = softmax(q*scale . k^T + bias)     (recomputed, never stored)
//   dV = P^T . dO        dP = dO . V^T      dS = P o (dP - delta)
//   dQ = dS . K * scale  dK = dS^T . Q * scale
//
// What bounds it: at the training shapes (text S=77 D=64, vision S=50
// D=64) the work is 10*B*H*S^2*D flops against B*S*7W elements moved, a
// few flops per byte, so in bf16 the memory rate is the card's floor
// (0.1898 ms at the B/32 train step's text call, B=1152, on the NVIDIA H100
// 80GB HBM3); in fp32 too (0.3796 ms there, against 0.2119 ms for three
// TF32 products a term at 495 TFLOP/s).
//
// Three hand-written variants, chosen by dtype and head_dim alone
// (`clip_attention_variant`, the forward's rule). In all, each (b, h)
// owns its dq/dk/dv slices: no atomics, the same bits on every run. q, k,
// v and dO are read by stride straight out of the packed rows; nothing is
// split, transposed or copied on the host.
//
// "mma": bf16 with D in {16, 32, 64, 128}, on the tensor cores
// (mma.sync.m16n8k16 bf16, fp32 accumulators; helpers in attention_mma.cuh,
// shared with K2). The forward left each row's log-sum-exp and the output,
// so nothing of the forward is recomputed but the scores: P = exp2(s - lse)
// directly. At S <= 128 all four [S, D] tiles fit one block (4 x 128 x 72
// x 2 B = 73.7 KB at D = 64, 139 KB at D = 128), so ONE launch, one block
// per (b, h), reads qkv and dO once:
//   * Q, K, V and dO are staged bf16 by cp.async into padded tiles; while
//     they fly each warp forms delta = rowsum(dO o O) and takes lse (in
//     log2 units) for its 16 query rows, into shared memory.
//   * dQ: ceil(S/16) warps, each owning 16 query rows. Per 16-key chunk
//     S = Q.K^T and dP = dO.V^T in fp32, P and dS = P o (dP - delta) in
//     fp32, dS rounded to bf16 in registers as the A operand of dQ += dS.K
//     (K by ldmatrix.trans). Q and dO fragments stay in registers at
//     D <= 64 (reloaded per chunk at D = 128). dQ * scale goes straight
//     from the accumulators to dqkv: every tile row is still read.
//   * A barrier, then dK and dV: each warp owns 16 key rows and walks the
//     16-query chunks with the transposed products S^T = K.Q^T and
//     dP^T = V.dO^T (key rows as M), so P^T and dS^T come out in
//     accumulator layout and turn in registers into the A operands of
//     dV += P^T.dO and dK += dS^T.Q; lse and delta are per column there.
//     dK * scale and dV are staged in the warp's own K and V rows (only
//     that warp reads them now) and written with 16-byte stores.
//   Tile rows past S are zero-filled; keys past S get P = 0; query rows
//   past S carry zero dO, lse = 0 and delta = 0, so they add nothing.
//
// "tf32x3": fp32 with D in {16, 32, 64, 128}, the mma variant's structure
// on fp32 tiles (rows of D + 4 floats) with every product in split TF32
// (mma.sync.m16n8k8 tf32, three products a term; attention_mma.cuh), held
// to the fp32 plain version's 1e-5. It reads the forward's out and lse.
//   * D <= 64: ONE launch, one block per (b, h): Q, K, V and dO staged
//     once (87 KB at S = 77, D = 64), lse and delta of every row into
//     shared memory while they fly; the dQ phase (every Q, dO, K and V
//     fragment split per use, each 8-key tile of dS split in registers as
//     an A operand over relabelled keys), a barrier, the dK/dV phase on
//     the transposed products. Capped at 168 registers a thread (below).
//   * D = 128: the four fp32 tiles of a head (270 KB at S = 128) do not
//     fit a block, so TWO launches, as K2's tf32x3 takes: a dq pass and a
//     dkv pass, each block owning 64 rows of one (b, h) beside the whole
//     head's other two tiles (203 KB at S = 128), each forming lse and
//     delta itself. The dkv pass walks its queries twice, over column
//     halves of dK and dV (64 accumulator registers, not 128).
//   Tile rows past S are zero-filled, keys past S get P = 0, query rows
//   past S carry zero dO, lse = 0 and delta = 0, as in the mma variant.
//
// "simt": bf16 and fp32 with another head_dim: two launches,
// as FlashAttention-2 splits its backward, each staging two of the four
// [S, D] tiles as fp32 (at S = D = 128 all four in fp32 would need 264 KB,
// more than a block's 227 KB):
//   1. dq pass: one block per (b, h) stages K and V. Each warp takes query
//      rows: it recomputes that row of P with the forward's exact
//      arithmetic, forms dP and dS for the row in registers, writes the dQ
//      row, and saves the row's m, l and delta to `stats`.
//   2. dkv pass: one block per (b, h) stages Q (pre-scaled) and dO, plus
//      the stats. Each warp takes key rows j: it recomputes column j of P
//      from m and l (bitwise the values of pass 1), forms dS for the
//      column, and writes the dK and dV rows.
//   Every product and sum is fp32 on the CUDA cores out of shared memory
//   (one shared load per operand per FMA), so it is limited by
//   shared-memory loads, far above the memory floor.
//
// Limits, checked by the Python wrapper too: S <= 128, D <= 128; the mma
// and tf32x3 variants need 16-byte-aligned qkv, do, out and dqkv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"

namespace {

constexpr int kMaxS = 128;
constexpr int kMaxD = 128;

// ---------------------------------------------------------------- mma

constexpr int kMmaWarps = kMaxS / 16;  // most warps a block takes: 16 rows each

template <int D>
constexpr size_t bwd_mma_smem_bytes(int rows) {
  // Q, K, V and dO tiles of `rows` padded rows, lse and delta per row
  return (size_t)4 * rows * (D + mma::kPad) * sizeof(__nv_bfloat16) + (size_t)2 * rows * sizeof(float);
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kMmaWarps * 32)
attention_bwd_kernel_mma(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ bias,
                         const __nv_bfloat16* __restrict__ dout,
                         const __nv_bfloat16* __restrict__ out, const float* __restrict__ lse,
                         __nv_bfloat16* __restrict__ dqkv, int S, int H, float scale,
                         float scale_log2e) {
  using namespace mma;
  constexpr int kStride = D + kPad;
  constexpr int kSteps = D / 16;
  constexpr bool kHold = D <= 64;  // A fragments of the warp's own rows stay in registers
  constexpr int kHeld = kHold ? kSteps : 1;
  // held fragments are indexed by the k-step, so that loop unrolls fully;
  // at D = 128 a shallower unroll keeps the loads from piling up in
  // registers beside the two 64-register accumulators
  constexpr int kUnrollKs = kHold ? kSteps : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = blockDim.x / 2;  // 16 per warp: S rounded up to 16
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [rows][D+8]
  __nv_bfloat16* sK = sQ + rows * kStride;                         // [rows][D+8]
  __nv_bfloat16* sV = sK + rows * kStride;                         // [rows][D+8]
  __nv_bfloat16* sG = sV + rows * kStride;                         // [rows][D+8] dO
  float* sLse = reinterpret_cast<float*>(sG + rows * kStride);     // [rows], log2 units
  float* sDelta = sLse + rows;                                     // [rows]

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
  const __nv_bfloat16* base = qkv + (size_t)b * S * row + h * D;
  const __nv_bfloat16* gbase = dout + (size_t)b * S * W + h * D;
  const __nv_bfloat16* obase = out + (size_t)b * S * W + h * D;
  __nv_bfloat16* dst = dqkv + (size_t)b * S * row + h * D;

  load_warp_rows<D>(sQ, base, row, S, tid, blockDim.x);
  load_warp_rows<D>(sK, base + W, row, S, tid, blockDim.x);
  load_warp_rows<D>(sV, base + 2 * W, row, S, tid, blockDim.x);
  load_warp_rows<D>(sG, gbase, (size_t)W, S, tid, blockDim.x);
  cp_async_commit();

  // delta = rowsum(dO o O) and lse (in log2 units) of this thread's rows,
  // while the copies fly; 0 for rows past S
  const int row_g = warp * 16 + g;  // this thread's query rows: row_g, row_g + 8
  float delta[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ri = row_g + 8 * r;
    delta[r] = row_delta<D>(gbase, obase, W, ri, S, t4);
    lse2[r] = ri < S ? lse[(size_t)bh * S + ri] * kLog2e : 0.f;
    if (t4 == 0) {
      sDelta[ri] = delta[r];
      sLse[ri] = lse2[r];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int nc = (S + 15) >> 4;  // 16-row chunks that hold a row below S

  // ---- dQ of the warp's 16 query rows
  {
    uint32_t qf[kHeld][4], gf[kHeld][4];
    if constexpr (kHold) {
#pragma unroll
      for (int ks = 0; ks < kHeld; ++ks) {
        load_a(qf[ks], sQ, kStride, warp * 16, ks * 16, lane);
        load_a(gf[ks], sG, kStride, warp * 16, ks * 16, lane);
      }
    }
    float dq[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
    for (int kc = 0; kc < nc; ++kc) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t kb[4], vb[4];
        load_b_nk(kb, sK, kStride, kc * 16, ks * 16, lane);
        load_b_nk(vb, sV, kStride, kc * 16, ks * 16, lane);
        if constexpr (kHold) {
          mma_bf16(s[0], qf[ks % kHeld], kb[0], kb[1]);
          mma_bf16(s[1], qf[ks % kHeld], kb[2], kb[3]);
          mma_bf16(dp[0], gf[ks % kHeld], vb[0], vb[1]);
          mma_bf16(dp[1], gf[ks % kHeld], vb[2], vb[3]);
        } else {
          uint32_t a[4];
          load_a(a, sQ, kStride, warp * 16, ks * 16, lane);
          mma_bf16(s[0], a, kb[0], kb[1]);
          mma_bf16(s[1], a, kb[2], kb[3]);
          load_a(a, sG, kStride, warp * 16, ks * 16, lane);
          mma_bf16(dp[0], a, vb[0], vb[1]);
          mma_bf16(dp[1], a, vb[2], vb[3]);
        }
      }
      // dS = P o (dP - delta), fp32, then bf16 as the next A operand
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = kc * 16 + n * 8 + 2 * t4 + (e & 1);
          const float p = prob<HAS_BIAS>(s[n][e], scale_log2e, bias, row_g + 8 * r, col, S, lse2[r]);
          s[n][e] = p * (dp[n][e] - delta[r]);
        }
      }
      uint32_t da[4];
      pack_a(da, s[0], s[1]);
#pragma unroll
      for (int dn = 0; dn < kSteps; ++dn) {
        uint32_t kb[4];
        load_b_kn(kb, sK, kStride, kc * 16, dn * 16, lane);
        mma_bf16(dq[2 * dn], da, kb[0], kb[1]);
        mma_bf16(dq[2 * dn + 1], da, kb[2], kb[3]);
      }
    }
    store_frag_rows<D>(dq, scale, dst + (size_t)warp * 16 * row, row, S - warp * 16, lane);
  }
  __syncthreads();  // no warp reads K or V rows other than its own from here

  // ---- dK and dV of the warp's 16 key rows
  const int key_g = warp * 16 + g;  // this thread's key rows: key_g, key_g + 8
  uint32_t kf[kHeld][4], vf[kHeld][4];
  if constexpr (kHold) {
#pragma unroll
    for (int ks = 0; ks < kHeld; ++ks) {
      load_a(kf[ks], sK, kStride, warp * 16, ks * 16, lane);
      load_a(vf[ks], sV, kStride, warp * 16, ks * 16, lane);
    }
  }
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  for (int qc = 0; qc < nc; ++qc) {
    // transposed chunks: rows are this warp's keys, columns 16 queries
    float st[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float dpt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll(kUnrollKs)
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t qb[4], gb[4];
      load_b_nk(qb, sQ, kStride, qc * 16, ks * 16, lane);
      load_b_nk(gb, sG, kStride, qc * 16, ks * 16, lane);
      if constexpr (kHold) {
        mma_bf16(st[0], kf[ks % kHeld], qb[0], qb[1]);
        mma_bf16(st[1], kf[ks % kHeld], qb[2], qb[3]);
        mma_bf16(dpt[0], vf[ks % kHeld], gb[0], gb[1]);
        mma_bf16(dpt[1], vf[ks % kHeld], gb[2], gb[3]);
      } else {
        uint32_t a[4];
        load_a(a, sK, kStride, warp * 16, ks * 16, lane);
        mma_bf16(st[0], a, qb[0], qb[1]);
        mma_bf16(st[1], a, qb[2], qb[3]);
        load_a(a, sV, kStride, warp * 16, ks * 16, lane);
        mma_bf16(dpt[0], a, gb[0], gb[1]);
        mma_bf16(dpt[1], a, gb[2], gb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qc * 16 + n * 8 + 2 * t4 + (e & 1);
        const float p = prob<HAS_BIAS>(st[n][e], scale_log2e, bias, qi, key_g + 8 * (e >> 1), S,
                                       sLse[qi]);
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - sDelta[qi]);
      }
    }
    uint32_t pa[4], da[4];
    pack_a(pa, st[0], st[1]);
    pack_a(da, dpt[0], dpt[1]);
#pragma unroll
    for (int dn = 0; dn < kSteps; ++dn) {
      uint32_t gb[4], qb[4];
      load_b_kn(gb, sG, kStride, qc * 16, dn * 16, lane);
      mma_bf16(dv[2 * dn], pa, gb[0], gb[1]);
      mma_bf16(dv[2 * dn + 1], pa, gb[2], gb[3]);
      load_b_kn(qb, sQ, kStride, qc * 16, dn * 16, lane);
      mma_bf16(dk[2 * dn], da, qb[0], qb[1]);
      mma_bf16(dk[2 * dn + 1], da, qb[2], qb[3]);
    }
  }
  __nv_bfloat16* dkv = dst + (size_t)warp * 16 * row;
  store_rows<D>(sK + warp * 16 * kStride, dk, scale, scale, dkv + W, row, S - warp * 16, lane);
  store_rows<D>(sV + warp * 16 * kStride, dv, 1.f, 1.f, dkv + 2 * W, row, S - warp * 16, lane);
}

template <int D, bool HAS_BIAS>
int launch_mma(const void* qkv, const float* bias, const void* dout, const void* out,
               const float* lse, void* dqkv, int B, int S, int H, float scale,
               cudaStream_t stream) {
  static bool smem_allowed[mma::kMaxDevices] = {};
  auto kernel = attention_bwd_kernel_mma<D, HAS_BIAS>;
  const int e = mma::allow_smem_once(kernel, bwd_mma_smem_bytes<D>(16 * kMmaWarps), smem_allowed);
  if (e) return e;
  const long long blocks = (long long)B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int warps = (S + 15) / 16;
  kernel<<<(unsigned)blocks, warps * 32, bwd_mma_smem_bytes<D>(16 * warps), stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), bias, static_cast<const __nv_bfloat16*>(dout),
      static_cast<const __nv_bfloat16*>(out), lse, static_cast<__nv_bfloat16*>(dqkv), S, H, scale,
      scale * mma::kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma_d(const void* qkv, const float* bias, const void* dout, const void* out,
                 const float* lse, void* dqkv, int B, int S, int H, float scale,
                 cudaStream_t stream) {
  if (bias != nullptr)
    return launch_mma<D, true>(qkv, bias, dout, out, lse, dqkv, B, S, H, scale, stream);
  return launch_mma<D, false>(qkv, bias, dout, out, lse, dqkv, B, S, H, scale, stream);
}

// ---------------------------------------------------------------- tf32x3

constexpr int kSplitRows = 64;  // rows a block owns in the two-launch backward (D = 128)

// lse (in log2 units) and delta = rowsum(dO o O) of `rows` query rows from
// row r0 into shared memory, 0 past S; one quad a row. Every lane of a warp
// takes the same number of turns (rows and the quad stride are multiples
// of 8), as quad_sum needs.
template <int D>
__device__ __forceinline__ void query_stats_f32(float* sLse, float* sDelta, const float* lse_bh,
                                                const float* gbase, const float* obase, int W, int r0,
                                                int rows, int S, int tid, int nthreads) {
  for (int r = tid >> 2; r < rows; r += nthreads >> 2) {
    const int ri = r0 + r;
    const float d = mma::row_delta_f32<D>(gbase, obase, W, ri, S, tid & 3);
    if ((tid & 3) == 0) {
      sDelta[r] = d;
      sLse[r] = ri < S ? lse_bh[ri] * mma::kLog2e : 0.f;
    }
  }
}

// dQ of one warp's 16 query rows (tile rows lr0.., query rows q0..) over
// every key in sK / sV, in split TF32: per 16-key chunk S = Q.K^T and
// dP = dO.V^T, P from lse and dS = P o (dP - delta) on the accumulators,
// then dQ += dS.K with each 8-key tile of dS split in registers as an A
// operand over relabelled keys (K's B fragments by scalar shared loads).
// Q's and dO's fragments are reloaded and split per k-step: held, Q's take
// 64 registers at D = 64, and the kernel spills under its cap (below).
template <int D, bool HAS_BIAS>
__device__ __forceinline__ void dq_rows_tf32x3(const float* sQ, const float* sG, const float* sK,
                                               const float* sV, const float* sLse,
                                               const float* sDelta, const float* __restrict__ bias,
                                               int S, int lr0, int q0, int nkc, float scale_log2e,
                                               int lane, float (&dq)[D / 8][4]) {
  using namespace mma;
  constexpr int kStride = D + kPadF;
  constexpr int kSteps = D / 8;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = sLse[lr0 + g + 8 * r];
    delta[r] = sDelta[lr0 + g + 8 * r];
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  for (int kc = 0; kc < nkc; ++kc) {
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t x[4], ah[4], al[4], fh[4], fl[4];
      load_a_f32(x, sQ, kStride, lr0, ks * 8, lane);
      split_frag(x, ah, al);
      load_b_nk_f32(x, sK, kStride, kc * 16, ks * 8, lane);
      split_frag(x, fh, fl);
      mma_tf32x3_x2(s[0], s[1], ah, al, fh, fl);
      load_a_f32(x, sG, kStride, lr0, ks * 8, lane);
      split_frag(x, ah, al);
      load_b_nk_f32(x, sV, kStride, kc * 16, ks * 8, lane);
      split_frag(x, fh, fl);
      mma_tf32x3_x2(dp[0], dp[1], ah, al, fh, fl);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = kc * 16 + n * 8 + 2 * t4 + (e & 1);
        const float p = prob<HAS_BIAS>(s[n][e], scale_log2e, bias, q0 + g + 8 * r, col, S, lse2[r]);
        s[n][e] = p * (dp[n][e] - delta[r]);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t dh[4], dl[4];
      split_acc(s[n], dh, dl);
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        uint32_t kh[2], kl[2], jh[2], jl[2];
        load_b_kn_f32(kh, kl, sK, kStride, kc * 16 + n * 8, dn * 8, lane);
        load_b_kn_f32(jh, jl, sK, kStride, kc * 16 + n * 8, dn * 8 + 8, lane);
        mma_tf32x3_2(dq[dn], dh, dl, kh[0], kh[1], kl[0], kl[1], dq[dn + 1], dh, dl, jh[0], jh[1],
                     jl[0], jl[1]);
      }
    }
  }
}

// dK and dV, columns [c0, c0 + 8 NC), of one warp's 16 key rows (tile rows
// lr0.., key rows k0..) over every query in sQ / sG, whose lse and delta
// sit in sLse / sDelta by query row: per 16-query chunk the transposed
// products S^T = K.Q^T and dP^T = V.dO^T (K's and V's fragments reloaded
// per k-step), P^T and dS^T on the accumulators, then dV += P^T.dO and
// dK += dS^T.Q with each 8-query tile split as an A operand.
template <int D, bool HAS_BIAS, int NC>
__device__ __forceinline__ void dkv_rows_tf32x3(const float* sQ, const float* sG, const float* sK,
                                                const float* sV, const float* sLse,
                                                const float* sDelta, const float* __restrict__ bias,
                                                int S, int lr0, int k0, int nqc, float scale_log2e,
                                                int c0, int lane, float (&dk)[NC][4], float (&dv)[NC][4]) {
  using namespace mma;
  constexpr int kStride = D + kPadF;
  constexpr int kSteps = D / 8;
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  for (int qc = 0; qc < nqc; ++qc) {
    float st[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float dpt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t x[4], ah[4], al[4], fh[4], fl[4];
      load_a_f32(x, sK, kStride, lr0, ks * 8, lane);
      split_frag(x, ah, al);
      load_b_nk_f32(x, sQ, kStride, qc * 16, ks * 8, lane);
      split_frag(x, fh, fl);
      mma_tf32x3_x2(st[0], st[1], ah, al, fh, fl);
      load_a_f32(x, sV, kStride, lr0, ks * 8, lane);
      split_frag(x, ah, al);
      load_b_nk_f32(x, sG, kStride, qc * 16, ks * 8, lane);
      split_frag(x, fh, fl);
      mma_tf32x3_x2(dpt[0], dpt[1], ah, al, fh, fl);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qc * 16 + n * 8 + 2 * t4 + (e & 1);
        const float p = prob<HAS_BIAS>(st[n][e], scale_log2e, bias, qi, k0 + g + 8 * (e >> 1), S, sLse[qi]);
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - sDelta[qi]);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      split_acc(st[n], ph, pl);
      split_acc(dpt[n], dh, dl);
#pragma unroll
      for (int dn = 0; dn < NC; ++dn) {
        uint32_t gh[2], gl[2], fh[2], fl[2];
        load_b_kn_f32(gh, gl, sG, kStride, qc * 16 + n * 8, c0 + dn * 8, lane);
        load_b_kn_f32(fh, fl, sQ, kStride, qc * 16 + n * 8, c0 + dn * 8, lane);
        mma_tf32x3_2(dv[dn], ph, pl, gh[0], gh[1], gl[0], gl[1], dk[dn], dh, dl, fh[0], fh[1], fl[0],
                     fl[1]);
      }
    }
  }
}

template <int D>
constexpr size_t bwd_tf32x3_smem_bytes(int rows) {
  // Q, K, V and dO fp32 tiles of `rows` padded rows, lse and delta per row
  return (size_t)4 * rows * (D + mma::kPadF) * sizeof(float) + (size_t)2 * rows * sizeof(float);
}

// D <= 64: one launch, one block per (b, h), the mma variant's structure on
// fp32 tiles (4 x 80 x 68 x 4 B = 87 KB at S = 77, D = 64: two blocks an
// SM; three at S = 50). A sub-partition of the SM holds 16,384 registers,
// and two blocks of 5 warps put 3 warps on some: 168 registers a thread at
// most (3 x 32 x 168 <= 16,384). Left to itself ptxas takes 216-255 (the
// bias loads hoisted) and one block fits an SM: an uncapped build took
// 2.68 ms at the B/32 text step's shape (with the saved out and lse) where
// this one takes 1.98 (chip_smoke.py, H100).
template <int D, bool HAS_BIAS>
__global__ void __maxnreg__(168)
attention_bwd_kernel_tf32x3(const float* __restrict__ qkv, const float* __restrict__ bias,
                            const float* __restrict__ dout, const float* __restrict__ out,
                            const float* __restrict__ lse, float* __restrict__ dqkv, int S, int H,
                            float scale, float scale_log2e) {
  using namespace mma;
  static_assert(D <= 64, "four fp32 tiles of a head fit one block up to D = 64");
  constexpr int kStride = D + kPadF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = blockDim.x / 2;  // 16 per warp: S rounded up to 16
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [rows][D+4]
  float* sK = sQ + rows * kStride;                 // [rows][D+4]
  float* sV = sK + rows * kStride;                 // [rows][D+4]
  float* sG = sV + rows * kStride;                 // [rows][D+4] dO
  float* sLse = sG + rows * kStride;               // [rows], log2 units
  float* sDelta = sLse + rows;                     // [rows]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int W = H * D;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row = 3 * (size_t)W;
  const float* base = qkv + (size_t)b * S * row + h * D;
  const float* gbase = dout + (size_t)b * S * W + h * D;
  float* dst = dqkv + (size_t)b * S * row + h * D;

  load_rows_f32<D>(sQ, base, row, rows, S, tid, blockDim.x);
  load_rows_f32<D>(sK, base + W, row, rows, S, tid, blockDim.x);
  load_rows_f32<D>(sV, base + 2 * W, row, rows, S, tid, blockDim.x);
  load_rows_f32<D>(sG, gbase, (size_t)W, rows, S, tid, blockDim.x);
  cp_async_commit();
  // lse and delta of every query row while the copies fly
  query_stats_f32<D>(sLse, sDelta, lse + (size_t)bh * S, gbase, out + (size_t)b * S * W + h * D, W, 0,
                     rows, S, tid, blockDim.x);
  cp_async_wait<0>();
  __syncthreads();

  const int nc = (S + 15) >> 4;  // 16-row chunks that hold a row below S
  const int r0 = warp * 16;
  {
    float dq[D / 8][4];
    dq_rows_tf32x3<D, HAS_BIAS>(sQ, sG, sK, sV, sLse, sDelta, bias, S, r0, r0, nc, scale_log2e, lane, dq);
    store_frag_rows_f32<D>(dq, scale, dst + (size_t)r0 * row, row, S - r0, lane);
  }
  __syncthreads();  // no warp reads K or V rows other than its own from here

  float dk[D / 8][4], dv[D / 8][4];
  dkv_rows_tf32x3<D, HAS_BIAS, D / 8>(sQ, sG, sK, sV, sLse, sDelta, bias, S, r0, r0, nc, scale_log2e, 0,
                                      lane, dk, dv);
  float* dkv = dst + (size_t)r0 * row;
  store_rows_f32<D>(sK + r0 * kStride, dk, scale, scale, dkv + W, row, S - r0, lane);
  store_rows_f32<D>(sV + r0 * kStride, dv, 1.f, 1.f, dkv + 2 * W, row, S - r0, lane);
}

// D = 128, where the four tiles of a head (270 KB at S = 128) do not fit a
// block: two launches, each block owning kSplitRows rows of one (b, h)
// beside the whole head's other two tiles (203 KB at S = 128). The dq pass
// stages its query rows of Q and dO and every row of K and V.
template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kSplitRows * 2, 1)
attention_bwd_dq_kernel_tf32x3(const float* __restrict__ qkv, const float* __restrict__ bias,
                               const float* __restrict__ dout, const float* __restrict__ out,
                               const float* __restrict__ lse, float* __restrict__ dqkv, int S, int H,
                               float scale, float scale_log2e) {
  using namespace mma;
  constexpr int kStride = D + kPadF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int head_rows = (S + 15) & ~15;
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [64][D+4]
  float* sG = sQ + kSplitRows * kStride;           // [64][D+4] dO
  float* sK = sG + kSplitRows * kStride;           // [head_rows][D+4]
  float* sV = sK + head_rows * kStride;            // [head_rows][D+4]
  float* sLse = sV + head_rows * kStride;          // [64], log2 units
  float* sDelta = sLse + kSplitRows;               // [64]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int W = H * D;
  const int tiles = (S + kSplitRows - 1) / kSplitRows;
  const int bh = blockIdx.x / tiles;
  const int i0 = (blockIdx.x - bh * tiles) * kSplitRows;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row = 3 * (size_t)W;
  const float* base = qkv + (size_t)b * S * row + h * D;
  const float* gbase = dout + (size_t)b * S * W + h * D;
  const int nq = min(kSplitRows, S - i0);

  load_rows_f32<D>(sQ, base + (size_t)i0 * row, row, kSplitRows, nq, tid, blockDim.x);
  load_rows_f32<D>(sG, gbase + (size_t)i0 * W, (size_t)W, kSplitRows, nq, tid, blockDim.x);
  load_rows_f32<D>(sK, base + W, row, head_rows, S, tid, blockDim.x);
  load_rows_f32<D>(sV, base + 2 * W, row, head_rows, S, tid, blockDim.x);
  cp_async_commit();
  query_stats_f32<D>(sLse, sDelta, lse + (size_t)bh * S, gbase, out + (size_t)b * S * W + h * D, W, i0,
                     kSplitRows, S, tid, blockDim.x);
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = warp * 16;
  if (r0 < nq) {
    float dq[D / 8][4];
    dq_rows_tf32x3<D, HAS_BIAS>(sQ, sG, sK, sV, sLse, sDelta, bias, S, r0, i0 + r0, head_rows / 16,
                                scale_log2e, lane, dq);
    store_frag_rows_f32<D>(dq, scale, dqkv + ((size_t)b * S + i0 + r0) * row + h * D, row, nq - r0, lane);
  }
}

// The dkv pass of the two-launch backward: its key rows of K and V, every
// row of Q and dO with their lse and delta. dK and dV would take 128
// registers beside the products: two walks, each over half the columns
// (S^T and dP^T formed in both), written straight from the registers.
template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kSplitRows * 2, 1)
attention_bwd_dkv_kernel_tf32x3(const float* __restrict__ qkv, const float* __restrict__ bias,
                                const float* __restrict__ dout, const float* __restrict__ out,
                                const float* __restrict__ lse, float* __restrict__ dqkv, int S, int H,
                                float scale, float scale_log2e) {
  using namespace mma;
  constexpr int kStride = D + kPadF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int head_rows = (S + 15) & ~15;
  float* sK = reinterpret_cast<float*>(smem_raw);  // [64][D+4]
  float* sV = sK + kSplitRows * kStride;           // [64][D+4]
  float* sQ = sV + kSplitRows * kStride;           // [head_rows][D+4]
  float* sG = sQ + head_rows * kStride;            // [head_rows][D+4] dO
  float* sLse = sG + head_rows * kStride;          // [head_rows], log2 units
  float* sDelta = sLse + head_rows;                // [head_rows]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int W = H * D;
  const int tiles = (S + kSplitRows - 1) / kSplitRows;
  const int bh = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - bh * tiles) * kSplitRows;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row = 3 * (size_t)W;
  const float* base = qkv + (size_t)b * S * row + h * D;
  const float* gbase = dout + (size_t)b * S * W + h * D;
  const int nk = min(kSplitRows, S - j0);

  load_rows_f32<D>(sK, base + (size_t)j0 * row + W, row, kSplitRows, nk, tid, blockDim.x);
  load_rows_f32<D>(sV, base + (size_t)j0 * row + 2 * W, row, kSplitRows, nk, tid, blockDim.x);
  load_rows_f32<D>(sQ, base, row, head_rows, S, tid, blockDim.x);
  load_rows_f32<D>(sG, gbase, (size_t)W, head_rows, S, tid, blockDim.x);
  cp_async_commit();
  query_stats_f32<D>(sLse, sDelta, lse + (size_t)bh * S, gbase, out + (size_t)b * S * W + h * D, W, 0,
                     head_rows, S, tid, blockDim.x);
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = warp * 16;
  if (r0 < nk) {
    float* dst = dqkv + ((size_t)b * S + j0 + r0) * row + h * D;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float dk[D / 16][4], dv[D / 16][4];
      dkv_rows_tf32x3<D, HAS_BIAS, D / 16>(sQ, sG, sK, sV, sLse, sDelta, bias, S, r0, j0 + r0,
                                           head_rows / 16, scale_log2e, half * (D / 2), lane, dk, dv);
      store_frag_rows_f32<D / 2>(dk, scale, dst + W + half * (D / 2), row, nk - r0, lane);
      store_frag_rows_f32<D / 2>(dv, 1.f, dst + 2 * W + half * (D / 2), row, nk - r0, lane);
    }
  }
}

template <int D, bool HAS_BIAS>
int launch_tf32x3(const void* qkv, const float* bias, const void* dout, const void* out,
                  const float* lse, void* dqkv, int B, int S, int H, float scale, cudaStream_t stream) {
  const float* q = static_cast<const float*>(qkv);
  const float* g = static_cast<const float*>(dout);
  const float* o = static_cast<const float*>(out);
  float* d = static_cast<float*>(dqkv);
  const float scale_log2e = scale * mma::kLog2e;
  if constexpr (D <= 64) {
    static bool smem_allowed[mma::kMaxDevices] = {};
    auto kernel = attention_bwd_kernel_tf32x3<D, HAS_BIAS>;
    const int e = mma::allow_smem_once(kernel, bwd_tf32x3_smem_bytes<D>(16 * kMmaWarps), smem_allowed);
    if (e) return e;
    const long long blocks = (long long)B * H;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const int warps = (S + 15) / 16;
    kernel<<<(unsigned)blocks, warps * 32, bwd_tf32x3_smem_bytes<D>(16 * warps), stream>>>(
        q, bias, g, o, lse, d, S, H, scale, scale_log2e);
    return (int)cudaGetLastError();
  } else {
    static bool dq_allowed[mma::kMaxDevices] = {};
    static bool dkv_allowed[mma::kMaxDevices] = {};
    auto dq_kernel = attention_bwd_dq_kernel_tf32x3<D, HAS_BIAS>;
    auto dkv_kernel = attention_bwd_dkv_kernel_tf32x3<D, HAS_BIAS>;
    // two tiles of kSplitRows rows and two of the head's rows, lse and
    // delta of the larger
    auto smem = [](int head_rows) {
      return (size_t)2 * (kSplitRows + head_rows) * (D + mma::kPadF) * sizeof(float) +
             (size_t)2 * (head_rows > kSplitRows ? head_rows : kSplitRows) * sizeof(float);
    };
    int e = mma::allow_smem_once(dq_kernel, smem(kMaxS), dq_allowed);
    if (e) return e;
    e = mma::allow_smem_once(dkv_kernel, smem(kMaxS), dkv_allowed);
    if (e) return e;
    const long long blocks = (long long)B * H * ((S + kSplitRows - 1) / kSplitRows);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const size_t bytes = smem((S + 15) & ~15);
    dq_kernel<<<(unsigned)blocks, kSplitRows * 2, bytes, stream>>>(q, bias, g, o, lse, d, S, H, scale,
                                                                  scale_log2e);
    e = (int)cudaGetLastError();
    if (e) return e;
    dkv_kernel<<<(unsigned)blocks, kSplitRows * 2, bytes, stream>>>(q, bias, g, o, lse, d, S, H, scale,
                                                                   scale_log2e);
    return (int)cudaGetLastError();
  }
}

template <int D>
int launch_tf32x3_d(const void* qkv, const float* bias, const void* dout, const void* out,
                    const float* lse, void* dqkv, int B, int S, int H, float scale,
                    cudaStream_t stream) {
  if (bias != nullptr)
    return launch_tf32x3<D, true>(qkv, bias, dout, out, lse, dqkv, B, S, H, scale, stream);
  return launch_tf32x3<D, false>(qkv, bias, dout, out, lse, dqkv, B, S, H, scale, stream);
}

// ---------------------------------------------------------------- simt

constexpr int kWarps = 8;
constexpr int kSlots = kMaxS / 32;  // rows of P (or columns) each lane holds

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

// Row stride of a staged [S, D] tile. Odd, so the 32 lanes of a warp, each
// reading column d of a different row, hit 32 different banks.
__host__ __device__ __forceinline__ int tile_stride(int D) { return D | 1; }

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                        const T* __restrict__ dout, T* __restrict__ dqkv,
                        float* __restrict__ stats, int S, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int W = H * D;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int st = tile_stride(D);
  float* ks = smem;              // [S, D|1]
  float* vs = ks + S * st;       // [S, D|1]
  float* qs = vs + S * st;       // [kWarps, D]  one scaled q row per warp
  float* gs = qs + kWarps * D;   // [kWarps, D]  one dO row per warp
  float* ds = gs + kWarps * D;   // [kWarps, S]  one dS row per warp

  const size_t row = 3 * (size_t)W;  // packed rows are 3W apart, not W
  const T* base = qkv + (size_t)b * S * row + h * D;
  for (int idx = threadIdx.x; idx < S * D; idx += blockDim.x) {
    const int j = idx / D;
    const int d = idx - j * D;
    const T* r = base + (size_t)j * row + d;
    ks[j * st + d] = to_float(r[W]);
    vs[j * st + d] = to_float(r[2 * W]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* q = qs + warp * D;
  float* g = gs + warp * D;
  float* dsr = ds + warp * S;
  const size_t bhs = (size_t)gridDim.x * S;  // B*H*S
  float* m_out = stats + (size_t)blockIdx.x * S;
  float* l_out = m_out + bhs;
  float* delta_out = l_out + bhs;

  for (int i = warp; i < S; i += kWarps) {
    const T* qrow = base + (size_t)i * row;
    const T* grow = dout + ((size_t)b * S + i) * W + h * D;
    for (int d = lane; d < D; d += 32) {
      q[d] = to_float(qrow[d]) * scale;
      g[d] = to_float(grow[d]);
    }
    __syncwarp();

    // logits and dP for keys lane, lane+32, ...; the padding slots hold
    // -inf (logit) and 0 (dP), so they drop out of every reduction
    float lg[kSlots], dp[kSlots];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int j = lane + 32 * t;
      float s = -INFINITY, e = 0.f;
      if (j < S) {
        const float* kr = ks + j * st;
        const float* vr = vs + j * st;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(q[d], kr[d], acc);
        s = bias ? acc + bias[i * S + j] : acc;
        for (int d = 0; d < D; ++d) e = fmaf(g[d], vr[d], e);
      }
      lg[t] = s;
      dp[t] = e;
      m = fmaxf(m, s);
    }
    m = warp_max(m);

    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const float e = lane + 32 * t < S ? expf(lg[t] - m) : 0.f;
      lg[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);

    float delta = 0.f;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      lg[t] = lg[t] / sum;  // P, exactly as the forward forms it
      delta = fmaf(lg[t], dp[t], delta);
    }
    delta = warp_sum(delta);
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int j = lane + 32 * t;
      if (j < S) dsr[j] = lg[t] * (dp[t] - delta);
    }
    __syncwarp();

    T* dq = dqkv + ((size_t)b * S + i) * row + h * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(dsr[j], ks[j * st + d], acc);
      dq[d] = from_float<T>(acc * scale);
    }
    if (lane == 0) {
      m_out[i] = m;
      l_out[i] = sum;
      delta_out[i] = delta;
    }
    __syncwarp();  // q, g and dS are rewritten for the warp's next row
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dkv_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                         const T* __restrict__ dout, T* __restrict__ dqkv,
                         const float* __restrict__ stats, int S, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int W = H * D;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int st = tile_stride(D);
  float* qs = smem;              // [S, D|1]  q * scale
  float* gs = qs + S * st;       // [S, D|1]  dO
  float* ms = gs + S * st;       // [S]       row max
  float* ls = ms + S;            // [S]       row sum
  float* dls = ls + S;           // [S]       delta
  float* kw = dls + S;           // [kWarps, D]  one k row per warp
  float* vw = kw + kWarps * D;   // [kWarps, D]  one v row per warp
  float* pw = vw + kWarps * D;   // [kWarps, S]  one column of P per warp
  float* dw = pw + kWarps * S;   // [kWarps, S]  one column of dS per warp

  const size_t row = 3 * (size_t)W;
  const T* base = qkv + (size_t)b * S * row + h * D;
  const T* gbase = dout + (size_t)b * S * W + h * D;
  for (int idx = threadIdx.x; idx < S * D; idx += blockDim.x) {
    const int i = idx / D;
    const int d = idx - i * D;
    qs[i * st + d] = to_float(base[(size_t)i * row + d]) * scale;
    gs[i * st + d] = to_float(gbase[(size_t)i * W + d]);
  }
  const size_t bhs = (size_t)gridDim.x * S;
  const float* m_in = stats + (size_t)blockIdx.x * S;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    ms[i] = m_in[i];
    ls[i] = m_in[bhs + i];
    dls[i] = m_in[2 * bhs + i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* k = kw + warp * D;
  float* v = vw + warp * D;
  float* p = pw + warp * S;
  float* dsc = dw + warp * S;

  for (int j = warp; j < S; j += kWarps) {
    const T* krow = base + (size_t)j * row + W;
    for (int d = lane; d < D; d += 32) {
      k[d] = to_float(krow[d]);
      v[d] = to_float(krow[W + d]);
    }
    __syncwarp();

    // column j of P and dS for query rows lane, lane+32, ...
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int i = lane + 32 * t;
      if (i < S) {
        const float* qr = qs + i * st;
        const float* gr = gs + i * st;
        float acc = 0.f, e = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], k[d], acc);
        const float s = bias ? acc + bias[i * S + j] : acc;
        const float pij = expf(s - ms[i]) / ls[i];
        for (int d = 0; d < D; ++d) e = fmaf(gr[d], v[d], e);
        p[i] = pij;
        dsc[i] = pij * (e - dls[i]);
      }
    }
    __syncwarp();

    T* dk = dqkv + ((size_t)b * S + j) * row + W + h * D;
    for (int d = lane; d < D; d += 32) {
      float acc_k = 0.f, acc_v = 0.f;
      for (int i = 0; i < S; ++i) {
        acc_k = fmaf(dsc[i], qs[i * st + d], acc_k);
        acc_v = fmaf(p[i], gs[i * st + d], acc_v);
      }
      dk[d] = from_float<T>(acc_k);  // q was staged pre-scaled
      dk[W + d] = from_float<T>(acc_v);
    }
    __syncwarp();  // k, v, P and dS are rewritten for the warp's next column
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)bytes);
}

template <typename T>
int launch(const void* qkv, const float* bias, const void* dout, void* dqkv, float* stats,
           int B, int S, int H, int D, float scale, cudaStream_t stream) {
  const int st = tile_stride(D);
  const size_t smem_dq =
      ((size_t)2 * S * st + (size_t)2 * kWarps * D + (size_t)kWarps * S) * sizeof(float);
  const size_t smem_dkv =
      ((size_t)2 * S * st + (size_t)3 * S + (size_t)2 * kWarps * (D + S)) * sizeof(float);
  int e = allow_smem(attention_bwd_dq_kernel<T>, smem_dq);
  if (e) return e;
  e = allow_smem(attention_bwd_dkv_kernel<T>, smem_dkv);
  if (e) return e;
  const T* q = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  T* dq = static_cast<T*>(dqkv);
  attention_bwd_dq_kernel<T><<<B * H, kWarps * 32, smem_dq, stream>>>(
      q, bias, g, dq, stats, S, H, D, scale);
  e = (int)cudaGetLastError();
  if (e) return e;
  attention_bwd_dkv_kernel<T><<<B * H, kWarps * 32, smem_dkv, stream>>>(
      q, bias, g, dq, stats, S, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The variant that takes (dtype, D), the forward's rule: 1 = "mma", 2 =
// "tf32x3", 0 = "simt". dtype: 0 = fp32, 1 = bf16.
extern "C" int clip_attention_variant(int dtype, int D) {
  if (D != 16 && D != 32 && D != 64 && D != 128) return 0;
  return dtype == 1 ? 1 : dtype == 0 ? 2 : 0;
}

// dtype: 0 = fp32, 1 = bf16. The tensor-core variants need `out` and `lse`
// (the forward's) and launch one kernel (tf32x3 at D = 128: the dq pass,
// then the dkv pass); the CUDA-core variant launches the dq pass, then the
// dkv pass, needs `stats` and ignores `out` and `lse`. On `stream`;
// returns the first launch error, or 0.
extern "C" int clip_attention_bwd(const void* qkv, const void* bias, const void* dout,
                                  const void* out, const void* lse, void* dqkv, void* stats, int B,
                                  int S, int H, int D, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || S > kMaxS || H < 1 || D < 1 || D > kMaxD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* bias_f = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int variant = clip_attention_variant(dtype, D);
  if (variant != 0) {
    if (out == nullptr || lse == nullptr) return (int)cudaErrorInvalidValue;
    const float* lse_f = static_cast<const float*>(lse);
    if (variant == 1) {
      switch (D) {
        case 16: return launch_mma_d<16>(qkv, bias_f, dout, out, lse_f, dqkv, B, S, H, scale, s);
        case 32: return launch_mma_d<32>(qkv, bias_f, dout, out, lse_f, dqkv, B, S, H, scale, s);
        case 64: return launch_mma_d<64>(qkv, bias_f, dout, out, lse_f, dqkv, B, S, H, scale, s);
        default: return launch_mma_d<128>(qkv, bias_f, dout, out, lse_f, dqkv, B, S, H, scale, s);
      }
    }
    switch (D) {
      case 16: return launch_tf32x3_d<16>(qkv, bias_f, dout, out, lse_f, dqkv, B, S, H, scale, s);
      case 32: return launch_tf32x3_d<32>(qkv, bias_f, dout, out, lse_f, dqkv, B, S, H, scale, s);
      case 64: return launch_tf32x3_d<64>(qkv, bias_f, dout, out, lse_f, dqkv, B, S, H, scale, s);
      default: return launch_tf32x3_d<128>(qkv, bias_f, dout, out, lse_f, dqkv, B, S, H, scale, s);
    }
  }
  if (stats == nullptr) return (int)cudaErrorInvalidValue;
  float* stats_f = static_cast<float*>(stats);
  if (dtype == 0) return launch<float>(qkv, bias_f, dout, dqkv, stats_f, B, S, H, D, scale, s);
  return launch<__nv_bfloat16>(qkv, bias_f, dout, dqkv, stats_f, B, S, H, D, scale, s);
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
