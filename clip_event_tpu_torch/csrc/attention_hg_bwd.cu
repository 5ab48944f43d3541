// Multi-head attention backward over the packed QKV projection for any
// sequence length (the head-grid kernel, K2), for sm_90a.
//
// Replaces the backward Pallas kernel of
// clip_event_tpu/ops/attention_pallas.py::fused_attention_qkv_headgrid
// (_hg_bwd_kernel, launched by _hg_bwd). Same contract:
//
//   qkv   [B, S, 3W]  fp32 or bf16, contiguous; q lanes [0, W), k [W, 2W),
//                     v [2W, 3W), head h at [h*D, (h+1)*D) within each
//   bias  [S, S]      fp32 additive mask (may hold -inf), or null; it gets
//                     no gradient
//   do    [B, S, W]   the output's cotangent, qkv's dtype
//   out   [B, S, W]   the forward's output and
//   lse   [B, H, S]   its fp32 row log-sum-exp (natural log): read by the
//                     tensor-core variants only; the CUDA-core variant
//                     recomputes both and ignores these
//   dqkv  [B, S, 3W]  written once in qkv's dtype: dq at lanes h*D, dk at
//                     W + h*D, dv at 2W + h*D, the layout of the TPU
//                     wrapper's concatenate([dq, dk, dv], -1)
//   stats [3, B, H, S] fp32 scratch. Tensor-core variants: the first
//                     [B, H, S] holds delta = rowsum(dO o O). CUDA-core
//                     variant: each row's softmax max m, sum l and delta
//
// The math is _hg_bwd_kernel's:
//   P  = softmax(q . k^T * scale + bias)   (recomputed, never stored)
//   dV = P^T . dO        dP = dO . V^T      dS = P o (dP - delta)
//   dQ = dS . K * scale  dK = dS^T . Q * scale
//
// What bounds it. At the vision training shapes (S=197 W=768 H=12, S=257
// W=1024 H=16, D=64) the work is 10*B*H*S^2*D flops against B*S*7W elements
// moved. In bf16 on the tensor cores the bound is the memory rate (0.0704
// ms at ViT-L/14's B=64 on the NVIDIA H100 80GB HBM3); in fp32 to fp32
// accuracy the operation rate: three TF32 products a term at 495 TFLOP/s,
// 0.2623 ms at that shape (67 TFLOP/s on the CUDA cores).
//
// Three hand-written variants, chosen by dtype and head_dim alone
// (`clip_attention_hg_variant`, the forward's rule). All take two
// launches, and in all each (b, h) owns its dq/dk/dv slices and each block
// its rows of them: no atomics, the same bits on every run. q, k, v and dO
// are read by stride straight out of the packed rows.
//
// "mma": bf16 with D in {16, 32, 64, 128}, on the tensor cores
// (mma.sync.m16n8k16 bf16, fp32 accumulators; helpers in attention_mma.cuh).
// The forward left each row's log-sum-exp and the output, so nothing of the
// forward is recomputed but the scores: P = exp2(s - lse) directly.
//   1. dq pass: one block per (b, h, 64 query rows), 4 warps x 16 rows. Each
//      thread first forms delta for its two rows from dO and O (and the
//      block writes it to `stats` for pass 2). Q and dO fragments are held
//      in registers (D <= 64; reloaded by ldmatrix per chunk at D = 128,
//      where they would not fit beside the dQ accumulator). K and V walk
//      through a two-stage cp.async ring of 64-key tiles; per 16-key chunk
//      S = Q.K^T and dP = dO.V^T in fp32, P and dS = P o (dP - delta) in
//      fp32, dS rounded to bf16 in registers as the A operand of
//      dQ += dS.K (K by ldmatrix.trans). dQ * scale is staged in the warp's
//      own Q rows and written with 16-byte stores.
//   2. dkv pass: one block per (b, h, 64 key rows), 4 warps x 16 key rows,
//      walking Q/dO tiles of 64 rows (with their lse and delta) through the
//      same ring. It computes the transposed chunks S^T = K.Q^T and
//      dP^T = V.dO^T (key rows as M), so P^T and dS^T come out in
//      accumulator layout and turn in registers into the A operands of
//      dV += P^T.dO and dK += dS^T.Q; lse and delta are per column there,
//      read from shared memory. dK * scale and dV are staged in the warp's
//      own K and V rows and written with 16-byte stores.
//   Tile rows past S are zero-filled by cp.async; keys past S get P = 0;
//   query rows past S carry zero dO, lse = 0 and delta = 0, so they add
//   nothing. A warp whose 16 rows are all past S skips the math but
//   reaches every barrier.
//
// "tf32x3": fp32 with D in {16, 32, 64, 128}, the mma variant's two passes
// on fp32 tiles (rows padded to D + 4 floats; 103 KB a block at D = 64, two
// blocks an SM) with every product in split TF32 (mma.sync.m16n8k8 tf32,
// three products a term; attention_mma.cuh), held to the fp32 plain
// version's 1e-5. It reads the forward's saved out and lse, as the mma
// variant does. What differs:
//   * dq pass: per 32-key chunk, S = Q.K^T and dP = dO.V^T, K and V by
//     ldmatrix, split per use; Q's split fragments held at D <= 64
//     (reloaded per k-step at D = 128), dO's reloaded per k-step. P and
//     dS in fp32 on the accumulators; each 8-key tile of dS split in
//     registers as the A operand of dQ += dS.K over relabelled keys, K's B
//     fragments by scalar shared loads.
//   * dkv pass: per chunk of 32 queries (16 at D = 128), S^T = K.Q^T and
//     dP^T = V.dO^T with K's and V's fragments reloaded per k-step; P^T
//     and dS^T, split per 8-query tile, are the A operands of
//     dV += P^T.dO and dK += dS^T.Q. At D = 128, where dK and dV would
//     take 128 registers, the block walks the Q/dO tiles twice, each time
//     for half of dK's and dV's columns (S^T and dP^T formed twice; the
//     launch count stays 2).
//   * Results staged in fp32 in the warp's own spent rows, 16-byte stores.
//   * __launch_bounds__ with a least of one block an SM, as the forward.
//
// "simt": bf16 and fp32 with another head_dim (1, 2, 4 or 8); every
// product and sum in fp32 on the CUDA cores out of shared memory, limited
// by shared-memory loads. Its dq pass first re-runs the forward's online
// softmax over K/V tiles for m, l and O (never stored) and delta, then
// walks K/V again for dQ; its dkv pass takes 32 key rows a block and
// recomputes each column of P bitwise as pass 1 does.
//
// Limits, checked by the Python wrapper too: D <= 128; any S >= 1; the mma
// and tf32x3 variants need 16-byte-aligned qkv, do, out and dqkv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"

namespace {

// ---------------------------------------------------------------- mma

template <int D>
constexpr size_t bwd_mma_smem_bytes() {
  // dq pass: Q, dO tiles + two stages of K, V; dkv pass: K, V tiles + two
  // stages of Q, dO and of the lse and delta rows
  return (size_t)6 * mma::kTile * (D + mma::kPad) * sizeof(__nv_bfloat16)
         + (size_t)4 * mma::kTile * sizeof(float);
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(mma::kThreads)
attention_hg_bwd_dq_kernel_mma(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ bias,
                               const __nv_bfloat16* __restrict__ dout,
                               const __nv_bfloat16* __restrict__ out, const float* __restrict__ lse,
                               __nv_bfloat16* __restrict__ dqkv, float* __restrict__ delta_out,
                               int S, int H, float scale, float scale_log2e) {
  using namespace mma;
  constexpr int kStride = D + kPad;
  constexpr int kSteps = D / 16;
  constexpr int kChunks = kTile / 16;
  constexpr bool kHold = D <= 64;  // Q and dO fragments stay in registers
  constexpr int kHeld = kHold ? kSteps : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][D+8]
  __nv_bfloat16* sG = sQ + kTile * kStride;                        // [64][D+8] dO
  __nv_bfloat16* sK = sG + kTile * kStride;                        // [2][64][D+8]
  __nv_bfloat16* sV = sK + 2 * kTile * kStride;                    // [2][64][D+8]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int W = H * D;
  const int tiles = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x / tiles;
  const int i0 = (blockIdx.x - bh * tiles) * kTile;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row = 3 * (size_t)W;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row + h * D;
  const __nv_bfloat16* gbase = dout + (size_t)b * S * W + h * D;
  const __nv_bfloat16* obase = out + (size_t)b * S * W + h * D;
  const int nq = min(kTile, S - i0);

  load_tile<D>(sQ, base + (size_t)i0 * row, row, nq, tid);
  load_tile<D>(sG, gbase + (size_t)i0 * W, (size_t)W, nq, tid);
  load_tile<D>(sK, base + W, row, min(kTile, S), tid);
  load_tile<D>(sV, base + 2 * W, row, min(kTile, S), tid);
  cp_async_commit();

  // delta = rowsum(dO o O) and lse (in log2 units) of this thread's rows,
  // while the copies fly: the 4 lanes of a row take D/4 columns each
  const bool active = warp * 16 < nq;
  const int row_g = i0 + warp * 16 + g;
  float delta[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ri = row_g + 8 * r;
    const float part = row_delta<D>(gbase, obase, W, ri, S, t4);
    delta[r] = part;
    lse2[r] = ri < S ? lse[(size_t)bh * S + ri] * kLog2e : 0.f;
    if (t4 == 0 && ri < S) delta_out[(size_t)bh * S + ri] = part;
  }

  uint32_t qf[kHeld][4], gf[kHeld][4];
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles) {
      const int stage = (kt + 1) & 1;
      const int j1 = (kt + 1) * kTile;
      load_tile<D>(sK + stage * kTile * kStride, base + (size_t)j1 * row + W, row,
                   min(kTile, S - j1), tid);
      load_tile<D>(sV + stage * kTile * kStride, base + (size_t)j1 * row + 2 * W, row,
                   min(kTile, S - j1), tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      if constexpr (kHold) {
        if (kt == 0) {
#pragma unroll
          for (int ks = 0; ks < kHeld; ++ks) {
            load_a(qf[ks], sQ, kStride, warp * 16, ks * 16, lane);
            load_a(gf[ks], sG, kStride, warp * 16, ks * 16, lane);
          }
        }
      }
      const __nv_bfloat16* ks_tile = sK + (kt & 1) * kTile * kStride;
      const __nv_bfloat16* vs_tile = sV + (kt & 1) * kTile * kStride;
      const int j0 = kt * kTile;
      const int nk = min(kTile, S - j0);
#pragma unroll
      for (int kc = 0; kc < kChunks; ++kc) {
        if (kc * 16 < nk) {
          float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int ks = 0; ks < kSteps; ++ks) {
            uint32_t kb[4], vb[4];
            load_b_nk(kb, ks_tile, kStride, kc * 16, ks * 16, lane);
            load_b_nk(vb, vs_tile, kStride, kc * 16, ks * 16, lane);
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
              const int col = j0 + kc * 16 + n * 8 + 2 * t4 + (e & 1);
              const float p = prob<HAS_BIAS>(s[n][e], scale_log2e, bias, row_g + 8 * r, col, S,
                                             lse2[r]);
              s[n][e] = p * (dp[n][e] - delta[r]);
            }
          }
          uint32_t da[4];
          pack_a(da, s[0], s[1]);
#pragma unroll
          for (int dn = 0; dn < kSteps; ++dn) {
            uint32_t kb[4];
            load_b_kn(kb, ks_tile, kStride, kc * 16, dn * 16, lane);
            mma_bf16(dq[2 * dn], da, kb[0], kb[1]);
            mma_bf16(dq[2 * dn + 1], da, kb[2], kb[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (active)
    store_rows<D>(sQ + warp * 16 * kStride, dq, scale, scale,
                  dqkv + ((size_t)b * S + i0 + warp * 16) * row + h * D, row, nq - warp * 16,
                  lane);
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(mma::kThreads)
attention_hg_bwd_dkv_kernel_mma(const __nv_bfloat16* __restrict__ qkv,
                                const float* __restrict__ bias,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dqkv, int S, int H, float scale,
                                float scale_log2e) {
  using namespace mma;
  constexpr int kStride = D + kPad;
  constexpr int kSteps = D / 16;
  constexpr int kChunks = kTile / 16;
  constexpr bool kHold = D <= 64;  // K and V fragments stay in registers
  constexpr int kHeld = kHold ? kSteps : 1;
  // held fragments are indexed by the k-step, so that loop unrolls fully;
  // at D = 128 a shallower unroll keeps the loads from piling up in
  // registers beside the two 64-register accumulators
  constexpr int kUnrollKs = kHold ? kSteps : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][D+8] own keys
  __nv_bfloat16* sV = sK + kTile * kStride;                        // [64][D+8]
  __nv_bfloat16* sQ = sV + kTile * kStride;                        // [2][64][D+8]
  __nv_bfloat16* sG = sQ + 2 * kTile * kStride;                    // [2][64][D+8] dO
  float* sLse = reinterpret_cast<float*>(sG + 2 * kTile * kStride);  // [2][64], log2 units
  float* sDelta = sLse + 2 * kTile;                                  // [2][64]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int W = H * D;
  const int tiles = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - bh * tiles) * kTile;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row = 3 * (size_t)W;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row + h * D;
  const __nv_bfloat16* gbase = dout + (size_t)b * S * W + h * D;
  const float* lse_bh = lse + (size_t)bh * S;
  const float* delta_bh = delta + (size_t)bh * S;
  const int nk = min(kTile, S - j0);

  load_tile<D>(sK, base + (size_t)j0 * row + W, row, nk, tid);
  load_tile<D>(sV, base + (size_t)j0 * row + 2 * W, row, nk, tid);
  load_tile<D>(sQ, base, row, min(kTile, S), tid);
  load_tile<D>(sG, gbase, (size_t)W, min(kTile, S), tid);
  cp_async_commit();
  if (tid < kTile) {
    sLse[tid] = tid < S ? lse_bh[tid] * kLog2e : 0.f;
    sDelta[tid] = tid < S ? delta_bh[tid] : 0.f;
  }

  const bool active = warp * 16 < nk;
  const int key_g = j0 + warp * 16 + g;  // this thread's key rows: key_g, key_g + 8
  uint32_t kf[kHeld][4], vf[kHeld][4];
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int qt = 0; qt < tiles; ++qt) {
    if (qt + 1 < tiles) {
      const int stage = (qt + 1) & 1;
      const int i1 = (qt + 1) * kTile;
      load_tile<D>(sQ + stage * kTile * kStride, base + (size_t)i1 * row, row, min(kTile, S - i1),
                   tid);
      load_tile<D>(sG + stage * kTile * kStride, gbase + (size_t)i1 * W, (size_t)W,
                   min(kTile, S - i1), tid);
      cp_async_commit();
      if (tid < kTile) {
        const int i = i1 + tid;
        sLse[stage * kTile + tid] = i < S ? lse_bh[i] * kLog2e : 0.f;
        sDelta[stage * kTile + tid] = i < S ? delta_bh[i] : 0.f;
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      if constexpr (kHold) {
        if (qt == 0) {
#pragma unroll
          for (int ks = 0; ks < kHeld; ++ks) {
            load_a(kf[ks], sK, kStride, warp * 16, ks * 16, lane);
            load_a(vf[ks], sV, kStride, warp * 16, ks * 16, lane);
          }
        }
      }
      const int stage = qt & 1;
      const __nv_bfloat16* qs_tile = sQ + stage * kTile * kStride;
      const __nv_bfloat16* gs_tile = sG + stage * kTile * kStride;
      const float* lse_t = sLse + stage * kTile;
      const float* delta_t = sDelta + stage * kTile;
      const int i0 = qt * kTile;
      const int nq = min(kTile, S - i0);
#pragma unroll
      for (int qc = 0; qc < kChunks; ++qc) {
        if (qc * 16 < nq) {
          // transposed chunks: rows are this warp's keys, columns 16 queries
          float st[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          float dpt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll(kUnrollKs)
          for (int ks = 0; ks < kSteps; ++ks) {
            uint32_t qb[4], gb[4];
            load_b_nk(qb, qs_tile, kStride, qc * 16, ks * 16, lane);
            load_b_nk(gb, gs_tile, kStride, qc * 16, ks * 16, lane);
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
              const int qi = qc * 16 + n * 8 + 2 * t4 + (e & 1);  // query within the tile
              const float p = prob<HAS_BIAS>(st[n][e], scale_log2e, bias, i0 + qi,
                                             key_g + 8 * (e >> 1), S, lse_t[qi]);
              st[n][e] = p;
              dpt[n][e] = p * (dpt[n][e] - delta_t[qi]);
            }
          }
          uint32_t pa[4], da[4];
          pack_a(pa, st[0], st[1]);
          pack_a(da, dpt[0], dpt[1]);
#pragma unroll
          for (int dn = 0; dn < kSteps; ++dn) {
            uint32_t gb[4], qb[4];
            load_b_kn(gb, gs_tile, kStride, qc * 16, dn * 16, lane);
            mma_bf16(dv[2 * dn], pa, gb[0], gb[1]);
            mma_bf16(dv[2 * dn + 1], pa, gb[2], gb[3]);
            load_b_kn(qb, qs_tile, kStride, qc * 16, dn * 16, lane);
            mma_bf16(dk[2 * dn], da, qb[0], qb[1]);
            mma_bf16(dk[2 * dn + 1], da, qb[2], qb[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (active) {
    __nv_bfloat16* dst = dqkv + ((size_t)b * S + j0 + warp * 16) * row + h * D;
    store_rows<D>(sK + warp * 16 * kStride, dk, scale, scale, dst + W, row, nk - warp * 16, lane);
    store_rows<D>(sV + warp * 16 * kStride, dv, 1.f, 1.f, dst + 2 * W, row, nk - warp * 16, lane);
  }
}

template <int D, bool HAS_BIAS>
int launch_mma(const void* qkv, const float* bias, const void* dout, const void* out,
               const float* lse, void* dqkv, float* delta, int B, int S, int H, float scale,
               cudaStream_t stream) {
  static bool dq_allowed[mma::kMaxDevices] = {};
  static bool dkv_allowed[mma::kMaxDevices] = {};
  auto dq_kernel = attention_hg_bwd_dq_kernel_mma<D, HAS_BIAS>;
  auto dkv_kernel = attention_hg_bwd_dkv_kernel_mma<D, HAS_BIAS>;
  constexpr size_t smem = bwd_mma_smem_bytes<D>();
  int e = mma::allow_smem_once(dq_kernel, smem, dq_allowed);
  if (e) return e;
  e = mma::allow_smem_once(dkv_kernel, smem, dkv_allowed);
  if (e) return e;
  const long long blocks = (long long)B * H * ((S + mma::kTile - 1) / mma::kTile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(dout);
  __nv_bfloat16* d = static_cast<__nv_bfloat16*>(dqkv);
  const float scale_log2e = scale * mma::kLog2e;
  dq_kernel<<<(unsigned)blocks, mma::kThreads, smem, stream>>>(
      q, bias, g, static_cast<const __nv_bfloat16*>(out), lse, d, delta, S, H, scale, scale_log2e);
  e = (int)cudaGetLastError();
  if (e) return e;
  dkv_kernel<<<(unsigned)blocks, mma::kThreads, smem, stream>>>(q, bias, g, lse, delta, d, S, H,
                                                                scale, scale_log2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma_d(const void* qkv, const float* bias, const void* dout, const void* out,
                 const float* lse, void* dqkv, float* delta, int B, int S, int H, float scale,
                 cudaStream_t stream) {
  if (bias != nullptr)
    return launch_mma<D, true>(qkv, bias, dout, out, lse, dqkv, delta, B, S, H, scale, stream);
  return launch_mma<D, false>(qkv, bias, dout, out, lse, dqkv, delta, B, S, H, scale, stream);
}

// ---------------------------------------------------------------- tf32x3

template <int D>
constexpr size_t bwd_tf32x3_smem_bytes() {
  // dq pass: Q, dO tiles + two stages of K, V; dkv pass: K, V tiles + two
  // stages of Q, dO and of the lse and delta rows; fp32
  return (size_t)6 * mma::kTile * (D + mma::kPadF) * sizeof(float)
         + (size_t)4 * mma::kTile * sizeof(float);
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(mma::kThreads, 1)
attention_hg_bwd_dq_kernel_tf32x3(const float* __restrict__ qkv, const float* __restrict__ bias,
                                  const float* __restrict__ dout, const float* __restrict__ out,
                                  const float* __restrict__ lse, float* __restrict__ dqkv,
                                  float* __restrict__ delta_out, int S, int H, float scale,
                                  float scale_log2e) {
  using namespace mma;
  constexpr int kStride = D + kPadF;
  constexpr int kSteps = D / 8;
  constexpr int kChunk = 32;              // keys a chunk
  constexpr int kChunkTiles = kChunk / 8;  // 8-key n-tiles of a chunk
  constexpr bool kHold = D <= 64;         // Q's split fragments stay in registers
  constexpr int kHeld = kHold ? kSteps : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [64][D+4]
  float* sG = sQ + kTile * kStride;                // [64][D+4] dO
  float* sK = sG + kTile * kStride;                // [2][64][D+4]
  float* sV = sK + 2 * kTile * kStride;            // [2][64][D+4]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int W = H * D;
  const int tiles = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x / tiles;
  const int i0 = (blockIdx.x - bh * tiles) * kTile;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row = 3 * (size_t)W;
  const float* base = qkv + (size_t)b * S * row + h * D;
  const float* gbase = dout + (size_t)b * S * W + h * D;
  const float* obase = out + (size_t)b * S * W + h * D;
  const int nq = min(kTile, S - i0);

  load_tile_f32<D>(sQ, base + (size_t)i0 * row, row, nq, tid);
  load_tile_f32<D>(sG, gbase + (size_t)i0 * W, (size_t)W, nq, tid);
  load_tile_f32<D>(sK, base + W, row, min(kTile, S), tid);
  load_tile_f32<D>(sV, base + 2 * W, row, min(kTile, S), tid);
  cp_async_commit();

  const bool active = warp * 16 < nq;
  const int row_g = i0 + warp * 16 + g;
  float delta[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ri = row_g + 8 * r;
    const float part = row_delta_f32<D>(gbase, obase, W, ri, S, t4);
    delta[r] = part;
    lse2[r] = ri < S ? lse[(size_t)bh * S + ri] * kLog2e : 0.f;
    if (t4 == 0 && ri < S) delta_out[(size_t)bh * S + ri] = part;
  }

  uint32_t qh[kHeld][4], ql[kHeld][4];
  float dq[D / 8][4];
  zero_acc<D>(dq);

  for (int kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles) {
      const int stage = (kt + 1) & 1;
      const int j1 = (kt + 1) * kTile;
      load_tile_f32<D>(sK + stage * kTile * kStride, base + (size_t)j1 * row + W, row,
                       min(kTile, S - j1), tid);
      load_tile_f32<D>(sV + stage * kTile * kStride, base + (size_t)j1 * row + 2 * W, row,
                       min(kTile, S - j1), tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      if constexpr (kHold) {
        if (kt == 0) {
#pragma unroll
          for (int ks = 0; ks < kSteps; ++ks) {
            uint32_t x[4];
            load_a_f32(x, sQ, kStride, warp * 16, ks * 8, lane);
            split_frag(x, qh[ks], ql[ks]);
          }
        }
      }
      const float* ks_tile = sK + (kt & 1) * kTile * kStride;
      const float* vs_tile = sV + (kt & 1) * kTile * kStride;
      const int j0 = kt * kTile;
      const int nk = min(kTile, S - j0);
#pragma unroll
      for (int kc = 0; kc < kTile / kChunk; ++kc) {
        if (kc * kChunk < nk) {
          float s[kChunkTiles][4], dp[kChunkTiles][4];
#pragma unroll
          for (int n = 0; n < kChunkTiles; ++n) {
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
            dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
          }
          // S = Q.K^T and dP = dO.V^T over this chunk's keys
#pragma unroll
          for (int ks = 0; ks < kSteps; ++ks) {
            uint32_t x[4], ah[4], al[4], gh[4], gl[4];
            if constexpr (kHold) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                ah[i] = qh[ks % kHeld][i];
                al[i] = ql[ks % kHeld][i];
              }
            } else {
              load_a_f32(x, sQ, kStride, warp * 16, ks * 8, lane);
              split_frag(x, ah, al);
            }
            load_a_f32(x, sG, kStride, warp * 16, ks * 8, lane);
            split_frag(x, gh, gl);
#pragma unroll
            for (int p = 0; p < kChunkTiles / 2; ++p) {
              const int key0 = kc * kChunk + p * 16;
              if (key0 < nk) {
                uint32_t fh[4], fl[4];
                load_b_nk_f32(x, ks_tile, kStride, key0, ks * 8, lane);
                split_frag(x, fh, fl);
                mma_tf32x3_x2(s[2 * p], s[2 * p + 1], ah, al, fh, fl);
                load_b_nk_f32(x, vs_tile, kStride, key0, ks * 8, lane);
                split_frag(x, fh, fl);
                mma_tf32x3_x2(dp[2 * p], dp[2 * p + 1], gh, gl, fh, fl);
              }
            }
          }
          // dS = P o (dP - delta), fp32 (P = 0 for keys past S)
#pragma unroll
          for (int n = 0; n < kChunkTiles; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const int col = j0 + kc * kChunk + n * 8 + 2 * t4 + (e & 1);
              const float p = prob<HAS_BIAS>(s[n][e], scale_log2e, bias, row_g + 8 * r, col, S,
                                             lse2[r]);
              s[n][e] = p * (dp[n][e] - delta[r]);
            }
          }
          // dQ += dS . K: each 8-key tile of dS, split, over relabelled keys
#pragma unroll
          for (int n = 0; n < kChunkTiles; ++n) {
            if (kc * kChunk + n * 8 < nk) {
              uint32_t dh[4], dl[4];
              split_acc(s[n], dh, dl);
#pragma unroll
              for (int dn = 0; dn < D / 8; dn += 2) {
                uint32_t kh[2], kl[2], jh[2], jl[2];
                load_b_kn_f32(kh, kl, ks_tile, kStride, kc * kChunk + n * 8, dn * 8, lane);
                load_b_kn_f32(jh, jl, ks_tile, kStride, kc * kChunk + n * 8, dn * 8 + 8, lane);
                mma_tf32x3_2(dq[dn], dh, dl, kh[0], kh[1], kl[0], kl[1], dq[dn + 1], dh, dl, jh[0],
                             jh[1], jl[0], jl[1]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  if (active)
    store_rows_f32<D>(sQ + warp * 16 * kStride, dq, scale, scale,
                      dqkv + ((size_t)b * S + i0 + warp * 16) * row + h * D, row, nq - warp * 16,
                      lane);
}

// One walk of the dkv pass over every Q/dO tile of (b, h), with their lse
// and delta rows, through the two-stage ring: S^T = K.Q^T, dP^T = V.dO^T,
// P^T and dS^T for this warp's 16 key rows, then dV += P^T.dO and
// dK += dS^T.Q for the NC 8-column tiles from column c0, into accumulators
// the caller zeroed. The block's own K and V rows are issued already (the
// walk's first commit covers them) or in shared memory.
template <int D, bool HAS_BIAS, int NC>
__device__ __forceinline__ void dkv_walk_tf32x3(float* smem, const float* base, const float* gbase,
                                                const float* lse_bh, const float* delta_bh,
                                                const float* __restrict__ bias, int S, int W,
                                                int key_g, bool active, float scale_log2e, int c0,
                                                float (&dk)[NC][4], float (&dv)[NC][4]) {
  using namespace mma;
  constexpr int kStride = D + kPadF;
  constexpr int kSteps = D / 8;
  // queries a chunk; at D = 128 the chunk narrows and the k-steps of the
  // transposed products unroll by two, so that the chunk's scores and
  // their fragment loads fit beside the 64 accumulator registers
  constexpr int kChunk = D <= 64 ? 32 : 16;
  constexpr int kChunkTiles = kChunk / 8;
  constexpr int kUnrollKs = D <= 64 ? kSteps : 2;
  float* sK = smem;                     // [64][D+4] own keys
  float* sV = sK + kTile * kStride;     // [64][D+4]
  float* sQ = sV + kTile * kStride;     // [2][64][D+4]
  float* sG = sQ + 2 * kTile * kStride; // [2][64][D+4] dO
  float* sLse = sG + 2 * kTile * kStride;  // [2][64], log2 units
  float* sDelta = sLse + 2 * kTile;        // [2][64]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const size_t row = 3 * (size_t)W;
  const int tiles = (S + kTile - 1) / kTile;

  load_tile_f32<D>(sQ, base, row, min(kTile, S), tid);
  load_tile_f32<D>(sG, gbase, (size_t)W, min(kTile, S), tid);
  cp_async_commit();
  if (tid < kTile) {
    sLse[tid] = tid < S ? lse_bh[tid] * kLog2e : 0.f;
    sDelta[tid] = tid < S ? delta_bh[tid] : 0.f;
  }

  for (int qt = 0; qt < tiles; ++qt) {
    if (qt + 1 < tiles) {
      const int stage = (qt + 1) & 1;
      const int i1 = (qt + 1) * kTile;
      load_tile_f32<D>(sQ + stage * kTile * kStride, base + (size_t)i1 * row, row,
                       min(kTile, S - i1), tid);
      load_tile_f32<D>(sG + stage * kTile * kStride, gbase + (size_t)i1 * W, (size_t)W,
                       min(kTile, S - i1), tid);
      cp_async_commit();
      if (tid < kTile) {
        const int i = i1 + tid;
        sLse[stage * kTile + tid] = i < S ? lse_bh[i] * kLog2e : 0.f;
        sDelta[stage * kTile + tid] = i < S ? delta_bh[i] : 0.f;
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      const int stage = qt & 1;
      const float* qs_tile = sQ + stage * kTile * kStride;
      const float* gs_tile = sG + stage * kTile * kStride;
      const float* lse_t = sLse + stage * kTile;
      const float* delta_t = sDelta + stage * kTile;
      const int i0 = qt * kTile;
      const int nq = min(kTile, S - i0);
#pragma unroll
      for (int qc = 0; qc < kTile / kChunk; ++qc) {
        if (qc * kChunk < nq) {
          // transposed chunks: rows are this warp's keys, columns queries
          float st[kChunkTiles][4], dpt[kChunkTiles][4];
#pragma unroll
          for (int n = 0; n < kChunkTiles; ++n) {
            st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
            dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
          }
#pragma unroll(kUnrollKs)
          for (int ks = 0; ks < kSteps; ++ks) {
            uint32_t x[4], kh[4], kl[4], vh[4], vl[4];
            load_a_f32(x, sK, kStride, warp * 16, ks * 8, lane);
            split_frag(x, kh, kl);
            load_a_f32(x, sV, kStride, warp * 16, ks * 8, lane);
            split_frag(x, vh, vl);
#pragma unroll
            for (int p = 0; p < kChunkTiles / 2; ++p) {
              const int q0 = qc * kChunk + p * 16;
              if (q0 < nq) {
                uint32_t fh[4], fl[4];
                load_b_nk_f32(x, qs_tile, kStride, q0, ks * 8, lane);
                split_frag(x, fh, fl);
                mma_tf32x3_x2(st[2 * p], st[2 * p + 1], kh, kl, fh, fl);
                load_b_nk_f32(x, gs_tile, kStride, q0, ks * 8, lane);
                split_frag(x, fh, fl);
                mma_tf32x3_x2(dpt[2 * p], dpt[2 * p + 1], vh, vl, fh, fl);
              }
            }
          }
          // P^T and dS^T = P^T o (dP^T - delta), per query column
#pragma unroll
          for (int n = 0; n < kChunkTiles; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = qc * kChunk + n * 8 + 2 * t4 + (e & 1);  // query within the tile
              const float p = prob<HAS_BIAS>(st[n][e], scale_log2e, bias, i0 + qi,
                                             key_g + 8 * (e >> 1), S, lse_t[qi]);
              st[n][e] = p;
              dpt[n][e] = p * (dpt[n][e] - delta_t[qi]);
            }
          }
          // dV += P^T . dO and dK += dS^T . Q over relabelled queries
#pragma unroll
          for (int n = 0; n < kChunkTiles; ++n) {
            if (qc * kChunk + n * 8 < nq) {
              uint32_t ph[4], pl[4], dh[4], dl[4];
              split_acc(st[n], ph, pl);
              split_acc(dpt[n], dh, dl);
#pragma unroll
              for (int dn = 0; dn < NC; ++dn) {
                uint32_t gh[2], gl[2], fh[2], fl[2];
                load_b_kn_f32(gh, gl, gs_tile, kStride, qc * kChunk + n * 8, c0 + dn * 8, lane);
                load_b_kn_f32(fh, fl, qs_tile, kStride, qc * kChunk + n * 8, c0 + dn * 8, lane);
                mma_tf32x3_2(dv[dn], ph, pl, gh[0], gh[1], gl[0], gl[1], dk[dn], dh, dl, fh[0], fh[1],
                             fl[0], fl[1]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(mma::kThreads, 1)
attention_hg_bwd_dkv_kernel_tf32x3(const float* __restrict__ qkv, const float* __restrict__ bias,
                                   const float* __restrict__ dout, const float* __restrict__ lse,
                                   const float* __restrict__ delta, float* __restrict__ dqkv, int S,
                                   int H, float scale, float scale_log2e) {
  using namespace mma;
  constexpr int kStride = D + kPadF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* sK = smem;                  // [64][D+4] own keys, then dK
  float* sV = sK + kTile * kStride;  // [64][D+4] own values, then dV

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int W = H * D;
  const int tiles = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - bh * tiles) * kTile;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row = 3 * (size_t)W;
  const float* base = qkv + (size_t)b * S * row + h * D;
  const float* gbase = dout + (size_t)b * S * W + h * D;
  const float* lse_bh = lse + (size_t)bh * S;
  const float* delta_bh = delta + (size_t)bh * S;
  const int nk = min(kTile, S - j0);

  load_tile_f32<D>(sK, base + (size_t)j0 * row + W, row, nk, tid);
  load_tile_f32<D>(sV, base + (size_t)j0 * row + 2 * W, row, nk, tid);

  const bool active = warp * 16 < nk;
  const int key_g = j0 + warp * 16 + g;  // this thread's key rows: key_g, key_g + 8
  float* dst = dqkv + ((size_t)b * S + j0 + warp * 16) * row + h * D;
  if constexpr (D <= 64) {
    float dk[D / 8][4], dv[D / 8][4];
    zero_acc<D>(dk);
    zero_acc<D>(dv);
    dkv_walk_tf32x3<D, HAS_BIAS, D / 8>(smem, base, gbase, lse_bh, delta_bh, bias, S, W, key_g,
                                        active, scale_log2e, 0, dk, dv);
    if (active) {
      store_rows_f32<D>(sK + warp * 16 * kStride, dk, scale, scale, dst + W, row, nk - warp * 16, lane);
      store_rows_f32<D>(sV + warp * 16 * kStride, dv, 1.f, 1.f, dst + 2 * W, row, nk - warp * 16, lane);
    }
  } else {
    // dK and dV would take 128 registers beside the products: two walks,
    // each over half the columns (S^T and dP^T formed in both), written
    // straight from the registers (K's and V's rows are still read)
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float dk[D / 16][4], dv[D / 16][4];
      zero_acc<D / 2>(dk);
      zero_acc<D / 2>(dv);
      dkv_walk_tf32x3<D, HAS_BIAS, D / 16>(smem, base, gbase, lse_bh, delta_bh, bias, S, W, key_g,
                                           active, scale_log2e, half * (D / 2), dk, dv);
      if (active) {
        store_frag_rows_f32<D / 2>(dk, scale, dst + W + half * (D / 2), row, nk - warp * 16, lane);
        store_frag_rows_f32<D / 2>(dv, 1.f, dst + 2 * W + half * (D / 2), row, nk - warp * 16, lane);
      }
    }
  }
}

template <int D, bool HAS_BIAS>
int launch_tf32x3(const void* qkv, const float* bias, const void* dout, const void* out,
                  const float* lse, void* dqkv, float* delta, int B, int S, int H, float scale,
                  cudaStream_t stream) {
  static bool dq_allowed[mma::kMaxDevices] = {};
  static bool dkv_allowed[mma::kMaxDevices] = {};
  auto dq_kernel = attention_hg_bwd_dq_kernel_tf32x3<D, HAS_BIAS>;
  auto dkv_kernel = attention_hg_bwd_dkv_kernel_tf32x3<D, HAS_BIAS>;
  constexpr size_t smem = bwd_tf32x3_smem_bytes<D>();
  int e = mma::allow_smem_once(dq_kernel, smem, dq_allowed);
  if (e) return e;
  e = mma::allow_smem_once(dkv_kernel, smem, dkv_allowed);
  if (e) return e;
  const long long blocks = (long long)B * H * ((S + mma::kTile - 1) / mma::kTile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float* q = static_cast<const float*>(qkv);
  const float* g = static_cast<const float*>(dout);
  float* d = static_cast<float*>(dqkv);
  const float scale_log2e = scale * mma::kLog2e;
  dq_kernel<<<(unsigned)blocks, mma::kThreads, smem, stream>>>(
      q, bias, g, static_cast<const float*>(out), lse, d, delta, S, H, scale, scale_log2e);
  e = (int)cudaGetLastError();
  if (e) return e;
  dkv_kernel<<<(unsigned)blocks, mma::kThreads, smem, stream>>>(q, bias, g, lse, delta, d, S, H,
                                                                scale, scale_log2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tf32x3_d(const void* qkv, const float* bias, const void* dout, const void* out,
                    const float* lse, void* dqkv, float* delta, int B, int S, int H, float scale,
                    cudaStream_t stream) {
  if (bias != nullptr)
    return launch_tf32x3<D, true>(qkv, bias, dout, out, lse, dqkv, delta, B, S, H, scale, stream);
  return launch_tf32x3<D, false>(qkv, bias, dout, out, lse, dqkv, delta, B, S, H, scale, stream);
}

// ---------------------------------------------------------------- simt


constexpr int kWarps = 8;
constexpr int kQTile = 64;   // query rows per dq block, and per dkv walk tile
constexpr int kKTile = 64;   // keys per dq walk tile
constexpr int kKRows = 32;   // key rows per dkv block
constexpr int kSlots = 2;    // 64 / 32: tile columns each lane holds
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

// Row stride of a tile whose rows the lanes of a warp read in parallel
// (one row per lane). Odd, so the 32 lanes hit 32 different banks.
__host__ __device__ __forceinline__ int tile_stride(int D) { return D | 1; }

__host__ __device__ __forceinline__ size_t dq_smem_floats(int D) {
  return 2 * (size_t)kKTile * tile_stride(D)  // K and V tiles
         + 3 * (size_t)kQTile * D             // scaled q, dO, O-then-dQ rows
         + 3 * (size_t)kQTile                 // m, l, delta per row
         + (size_t)kWarps * kKTile;           // one P (then dS) row per warp
}

__host__ __device__ __forceinline__ size_t dkv_smem_floats(int D) {
  return 2 * (size_t)kQTile * tile_stride(D)  // scaled q and dO tiles
         + 4 * (size_t)kKRows * D             // own K, V rows; dK, dV sums
         + 3 * (size_t)kQTile                 // m, l, delta of the q tile
         + 2 * (size_t)kWarps * kQTile;       // one P and one dS column per warp
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_hg_bwd_dq_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                           const T* __restrict__ dout, T* __restrict__ dqkv,
                           float* __restrict__ stats, int B, int S, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int W = H * D;
  const int tiles = (S + kQTile - 1) / kQTile;
  const int bh = blockIdx.x / tiles;
  const int i0 = (blockIdx.x - bh * tiles) * kQTile;
  const int b = bh / H;
  const int h = bh - b * H;
  const int st = tile_stride(D);
  float* ks = smem;                // [kKTile, D|1]
  float* vs = ks + kKTile * st;    // [kKTile, D|1]
  float* qs = vs + kKTile * st;    // [kQTile, D]  q * scale
  float* gs = qs + kQTile * D;     // [kQTile, D]  dO
  float* acc = gs + kQTile * D;    // [kQTile, D]  O (walk 1), then dQ (walk 2)
  float* ms = acc + kQTile * D;    // [kQTile]
  float* ls = ms + kQTile;         // [kQTile]
  float* dls = ls + kQTile;        // [kQTile]
  float* ps = dls + kQTile;        // [kWarps, kKTile]

  const size_t row = 3 * (size_t)W;
  const T* base = qkv + (size_t)b * S * row + h * D;
  const T* gbase = dout + (size_t)b * S * W + h * D;
  const int nq = min(kQTile, S - i0);
  for (int idx = threadIdx.x; idx < nq * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    qs[idx] = to_float(base[(size_t)(i0 + r) * row + d]) * scale;
    gs[idx] = to_float(gbase[(size_t)(i0 + r) * W + d]);
    acc[idx] = 0.f;
  }
  for (int r = threadIdx.x; r < kQTile; r += blockDim.x) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = ps + warp * kKTile;

  // ---- walk 1: the forward's online softmax → m, l, O per row
  for (int j0 = 0; j0 < S; j0 += kKTile) {
    const int nk = min(kKTile, S - j0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * D; idx += blockDim.x) {
      const int j = idx / D;
      const int d = idx - j * D;
      const T* r = base + (size_t)(j0 + j) * row + d;
      ks[j * st + d] = to_float(r[W]);
      vs[j * st + d] = to_float(r[2 * W]);
    }
    __syncthreads();
    for (int r = warp; r < nq; r += kWarps) {
      const int i = i0 + r;
      const float* q = qs + r * D;
      float s[kSlots];
      float tmax = -INFINITY;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int j = lane + 32 * t;
        float v = -INFINITY;
        if (j < nk) {
          const float* kr = ks + j * st;
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
      if (m_new == -INFINITY) continue;
      const float corr = expf(m_old - m_new);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int j = lane + 32 * t;
        const float e = j < nk ? expf(s[t] - m_new) : 0.f;
        if (j < nk) p[j] = e;
        psum += e;
      }
      psum = warp_sum(psum);
      __syncwarp();
      float* o = acc + r * D;
      for (int d = lane; d < D; d += 32) {
        float a = o[d] * corr;
        for (int j = 0; j < nk; ++j) a = fmaf(p[j], vs[j * st + d], a);
        o[d] = a;
      }
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = ls[r] * corr + psum;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // delta = dO . O per row; the row's O sums become its dQ sums
  for (int r = warp; r < nq; r += kWarps) {
    const float l = ls[r];
    float part = 0.f;
    for (int d = lane; d < D; d += 32) {
      part = fmaf(gs[r * D + d], acc[r * D + d] / l, part);
      acc[r * D + d] = 0.f;
    }
    part = warp_sum(part);
    if (lane == 0) dls[r] = part;
  }

  // ---- walk 2: P from m and l, dP, dS; dQ += dS . K
  for (int j0 = 0; j0 < S; j0 += kKTile) {
    const int nk = min(kKTile, S - j0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * D; idx += blockDim.x) {
      const int j = idx / D;
      const int d = idx - j * D;
      const T* r = base + (size_t)(j0 + j) * row + d;
      ks[j * st + d] = to_float(r[W]);
      vs[j * st + d] = to_float(r[2 * W]);
    }
    __syncthreads();
    for (int r = warp; r < nq; r += kWarps) {
      const int i = i0 + r;
      const float* q = qs + r * D;
      const float* g = gs + r * D;
      const float m = ms[r], l = ls[r], delta = dls[r];
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int j = lane + 32 * t;
        if (j < nk) {
          const float* kr = ks + j * st;
          const float* vr = vs + j * st;
          float a = 0.f, e = 0.f;
          for (int d = 0; d < D; ++d) a = fmaf(q[d], kr[d], a);
          const float sv = bias ? a + bias[(size_t)i * S + j0 + j] : a;
          for (int d = 0; d < D; ++d) e = fmaf(g[d], vr[d], e);
          const float pij = expf(sv - m) / l;
          p[j] = pij * (e - delta);
        }
      }
      __syncwarp();
      float* dq = acc + r * D;
      for (int d = lane; d < D; d += 32) {
        float a = dq[d];
        for (int j = 0; j < nk; ++j) a = fmaf(p[j], ks[j * st + d], a);
        dq[d] = a;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nq * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    dqkv[((size_t)b * S + i0 + r) * row + h * D + d] = from_float<T>(acc[idx] * scale);
  }
  const size_t bhs = (size_t)B * H * S;
  float* m_out = stats + (size_t)bh * S + i0;
  for (int r = threadIdx.x; r < nq; r += blockDim.x) {
    m_out[r] = ms[r];
    m_out[bhs + r] = ls[r];
    m_out[2 * bhs + r] = dls[r];
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_hg_bwd_dkv_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                            const T* __restrict__ dout, T* __restrict__ dqkv,
                            const float* __restrict__ stats, int B, int S, int H, int D,
                            float scale) {
  extern __shared__ float smem[];
  const int W = H * D;
  const int tiles = (S + kKRows - 1) / kKRows;
  const int bh = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - bh * tiles) * kKRows;
  const int b = bh / H;
  const int h = bh - b * H;
  const int st = tile_stride(D);
  float* qs = smem;                // [kQTile, D|1]  q * scale
  float* gs = qs + kQTile * st;    // [kQTile, D|1]  dO
  float* kr = gs + kQTile * st;    // [kKRows, D]    own k rows
  float* vr = kr + kKRows * D;     // [kKRows, D]    own v rows
  float* dk = vr + kKRows * D;     // [kKRows, D]
  float* dv = dk + kKRows * D;     // [kKRows, D]
  float* ms = dv + kKRows * D;     // [kQTile]
  float* ls = ms + kQTile;         // [kQTile]
  float* dls = ls + kQTile;        // [kQTile]
  float* pw = dls + kQTile;        // [kWarps, kQTile]
  float* dw = pw + kWarps * kQTile;  // [kWarps, kQTile]

  const size_t row = 3 * (size_t)W;
  const T* base = qkv + (size_t)b * S * row + h * D;
  const T* gbase = dout + (size_t)b * S * W + h * D;
  const int nk = min(kKRows, S - j0);
  for (int idx = threadIdx.x; idx < nk * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    const T* src = base + (size_t)(j0 + r) * row + d;
    kr[idx] = to_float(src[W]);
    vr[idx] = to_float(src[2 * W]);
    dk[idx] = 0.f;
    dv[idx] = 0.f;
  }
  const size_t bhs = (size_t)B * H * S;
  const float* m_in = stats + (size_t)bh * S;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = pw + warp * kQTile;
  float* dsc = dw + warp * kQTile;

  for (int i0 = 0; i0 < S; i0 += kQTile) {
    const int nq = min(kQTile, S - i0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nq * D; idx += blockDim.x) {
      const int i = idx / D;
      const int d = idx - i * D;
      qs[i * st + d] = to_float(base[(size_t)(i0 + i) * row + d]) * scale;
      gs[i * st + d] = to_float(gbase[(size_t)(i0 + i) * W + d]);
    }
    for (int i = threadIdx.x; i < nq; i += blockDim.x) {
      ms[i] = m_in[i0 + i];
      ls[i] = m_in[bhs + i0 + i];
      dls[i] = m_in[2 * bhs + i0 + i];
    }
    __syncthreads();

    for (int r = warp; r < nk; r += kWarps) {
      const int j = j0 + r;
      const float* k = kr + r * D;
      const float* v = vr + r * D;
      // column j of P and dS for query rows lane, lane+32 of the tile
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int i = lane + 32 * t;
        if (i < nq) {
          const float* qrow = qs + i * st;
          const float* grow = gs + i * st;
          float a = 0.f, e = 0.f;
          for (int d = 0; d < D; ++d) a = fmaf(qrow[d], k[d], a);
          const float sv = bias ? a + bias[(size_t)(i0 + i) * S + j] : a;
          for (int d = 0; d < D; ++d) e = fmaf(grow[d], v[d], e);
          const float pij = expf(sv - ms[i]) / ls[i];
          p[i] = pij;
          dsc[i] = pij * (e - dls[i]);
        }
      }
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float ak = dk[r * D + d], av = dv[r * D + d];
        for (int i = 0; i < nq; ++i) {
          ak = fmaf(dsc[i], qs[i * st + d], ak);
          av = fmaf(p[i], gs[i * st + d], av);
        }
        dk[r * D + d] = ak;
        dv[r * D + d] = av;
      }
      __syncwarp();  // P and dS are rewritten for the warp's next key row
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nk * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    T* dst = dqkv + ((size_t)b * S + j0 + r) * row + h * D + d;
    dst[W] = from_float<T>(dk[idx]);  // q was staged pre-scaled
    dst[2 * W] = from_float<T>(dv[idx]);
  }
}

template <typename T>
int launch(const void* qkv, const float* bias, const void* dout, void* dqkv, float* stats,
           int B, int S, int H, int D, float scale, cudaStream_t stream) {
  // one kernel serves every D: allow the most it can ask for, once
  static bool dq_allowed[mma::kMaxDevices] = {};
  static bool dkv_allowed[mma::kMaxDevices] = {};
  int e = mma::allow_smem_once(attention_hg_bwd_dq_kernel<T>, dq_smem_floats(kMaxD) * sizeof(float),
                               dq_allowed);
  if (e) return e;
  e = mma::allow_smem_once(attention_hg_bwd_dkv_kernel<T>, dkv_smem_floats(kMaxD) * sizeof(float),
                           dkv_allowed);
  if (e) return e;
  const size_t smem_dq = dq_smem_floats(D) * sizeof(float);
  const size_t smem_dkv = dkv_smem_floats(D) * sizeof(float);
  const long long dq_blocks = (long long)B * H * ((S + kQTile - 1) / kQTile);
  const long long dkv_blocks = (long long)B * H * ((S + kKRows - 1) / kKRows);
  if (dkv_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const T* q = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  T* dq = static_cast<T*>(dqkv);
  attention_hg_bwd_dq_kernel<T><<<(unsigned)dq_blocks, kWarps * 32, smem_dq, stream>>>(
      q, bias, g, dq, stats, B, S, H, D, scale);
  e = (int)cudaGetLastError();
  if (e) return e;
  attention_hg_bwd_dkv_kernel<T><<<(unsigned)dkv_blocks, kWarps * 32, smem_dkv, stream>>>(
      q, bias, g, dq, stats, B, S, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The variant that takes (dtype, D), the forward's rule: 1 = "mma", 2 =
// "tf32x3", 0 = "simt". dtype: 0 = fp32, 1 = bf16.
extern "C" int clip_attention_hg_variant(int dtype, int D) {
  if (D != 16 && D != 32 && D != 64 && D != 128) return 0;
  return dtype == 1 ? 1 : dtype == 0 ? 2 : 0;
}

// dtype: 0 = fp32, 1 = bf16. Launches the dq pass, then the dkv pass, on
// `stream`; returns the first launch error, or 0. `out` and `lse` (the
// forward's) are required by the tensor-core variants and ignored by the
// other.
extern "C" int clip_attention_hg_bwd(const void* qkv, const void* bias, const void* dout,
                                     const void* out, const void* lse, void* dqkv, void* stats,
                                     int B, int S, int H, int D, float scale, int dtype,
                                     void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > kMaxD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* bias_f = static_cast<const float*>(bias);
  float* stats_f = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int variant = clip_attention_hg_variant(dtype, D);
  if (variant != 0) {
    if (out == nullptr || lse == nullptr) return (int)cudaErrorInvalidValue;
    const float* lse_f = static_cast<const float*>(lse);
    if (variant == 1) {
      switch (D) {
        case 16: return launch_mma_d<16>(qkv, bias_f, dout, out, lse_f, dqkv, stats_f, B, S, H, scale, s);
        case 32: return launch_mma_d<32>(qkv, bias_f, dout, out, lse_f, dqkv, stats_f, B, S, H, scale, s);
        case 64: return launch_mma_d<64>(qkv, bias_f, dout, out, lse_f, dqkv, stats_f, B, S, H, scale, s);
        default: return launch_mma_d<128>(qkv, bias_f, dout, out, lse_f, dqkv, stats_f, B, S, H, scale, s);
      }
    }
    switch (D) {
      case 16: return launch_tf32x3_d<16>(qkv, bias_f, dout, out, lse_f, dqkv, stats_f, B, S, H, scale, s);
      case 32: return launch_tf32x3_d<32>(qkv, bias_f, dout, out, lse_f, dqkv, stats_f, B, S, H, scale, s);
      case 64: return launch_tf32x3_d<64>(qkv, bias_f, dout, out, lse_f, dqkv, stats_f, B, S, H, scale, s);
      default: return launch_tf32x3_d<128>(qkv, bias_f, dout, out, lse_f, dqkv, stats_f, B, S, H, scale, s);
    }
  }
  if (dtype == 0) return launch<float>(qkv, bias_f, dout, dqkv, stats_f, B, S, H, D, scale, s);
  return launch<__nv_bfloat16>(qkv, bias_f, dout, dqkv, stats_f, B, S, H, D, scale, s);
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
