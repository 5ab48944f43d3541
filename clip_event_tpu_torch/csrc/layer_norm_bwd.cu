// Fused LayerNorm backward (K4c), for sm_90a.
//
// Replaces the backward Pallas kernel of clip_event_tpu/ops/ln_pallas.py:
// _ln_bwd_kernel, launched by _ln_bwd_call for both custom VJPs (_ln_bwd of
// layer_norm_pallas, _add_ln_bwd of add_layer_norm_pallas). Same contract:
//
//   x      [N, W]  the saved input of the LayerNorm (for the add + LN
//                  kernel: the sum), fp32 or bf16, contiguous
//   gamma  [W]     fp32
//   dy     [N, W]  the cotangent of y, in x's type
//   dx_out [N, W]  the cotangent of the add + LN kernel's sum, or null
//   dx     [N, W]  (g - mean(g) - xhat * mean(g * xhat)) * rstd with
//                  g = dy * gamma, in x's type; with dx_out it is rounded to
//                  x's type and then added to dx_out in that type (the
//                  roundings of _add_ln_bwd, which adds outside its kernel)
//   dgamma, dbeta [W] fp32: sum over rows of dy * xhat, and of dy
//
// The statistics are recomputed from x in fp32 (mean, then the variance of
// the centred values), never saved.
//
// What bounds it: bytes. x, dy (and dx_out) are read once and dx written
// once; the flops are a few per element. The TPU kernel adds dgamma and
// dbeta into one output block across a sequential grid. Blocks on this card
// run at once, so here a grid sized to what the SMs hold (the wrapper asks
// `clip_layer_norm_bwd_blocks_per_sm`; on the register path one block an
// SM, of as many warps as its registers allow) loops over the rows, one
// warp a row, and the column sums are reduced in one launch:
//
//   1. rows. On the register path (layer_norm.cuh) a lane loads its columns
//      of x and dy into registers, all before the first reduction, and
//      recomputes xhat and g = dy * gamma from them for each pass; its
//      dgamma and dbeta partials for those fixed columns stay in registers
//      across every row its warp visits. The generic path parks the row and
//      the warp's column sums in shared memory instead.
//   2. block. The block's warps add their partials once, in warp order,
//      through shared memory, and the block writes one [2, W] partial.
//   3. grid. Blocks are cut into ceil(G / K) groups of K = ceil(sqrt(G)).
//      The last block of a group to finish (it adds one to the group's
//      counter after a __threadfence() and reads back K - 1) adds the
//      group's partials in block order; the last group to finish adds the
//      group sums in group order into dgamma and dbeta. Each winner sets its
//      counter back to 0. Which block does an addition varies from run to
//      run; the order of the additions does not, so the result is the same
//      bits every run.
//
// The counters are this library's own device memory (`g_counts`, zero when
// the library loads, one set per device), not an allocation: a CUDA graph
// that captures the kernel refers to them, and since every launch leaves
// them at 0, replays and eager calls can follow one another in any order.
// Two K4c launches must not overlap on one device (two streams at once):
// the port launches it on one stream.
//
// Limits, checked by the Python wrapper too: 1 <= W <= 3072 (the generic
// path: 4 warps x 4 fp32 rows of shared memory), G <= kMaxBlocks.

#include "layer_norm.cuh"

namespace {

using namespace ln;

constexpr int kMaxBlocks = 4096;
constexpr int kMaxGroups = 64;  // ceil(G / ceil(sqrt(G))) for G <= kMaxBlocks

// a counter per group, then the grid's
__device__ unsigned int g_counts[kMaxGroups + 1];

int group_size(int G) {
  int k = 1;
  while (k * k < G) ++k;
  return k;
}

// The element's share of the accumulate pass: the column sums dg += dy *
// xhat and db += dy, the row sums s1 += g and s2 += g * xhat.
__device__ __forceinline__ void accumulate(float xhat, float g, float dy, float& dg, float& db,
                                           float& s1, float& s2) {
  dg = __fadd_rn(dg, __fmul_rn(dy, xhat));
  db += dy;
  s1 += g;
  s2 = __fadd_rn(s2, __fmul_rn(g, xhat));
}

// One element of dx. With ADD the LayerNorm's dx is rounded to the I/O
// type before it meets dx_out, and their sum is rounded again.
template <typename T, bool ADD>
__device__ __forceinline__ float finish(float g, float xhat, float m1, float m2, float rstd,
                                        float dx_out) {
  const float dx = __fmul_rn(g - m1 - __fmul_rn(xhat, m2), rstd);
  if (!ADD) return dx;
  return dx_out + round_to<T>(dx);
}

// dst[c] for every column c < cols: the rows r < n of src[r][c] added in
// row order. A thread takes C columns at a time and loads R rows of them
// before it adds, so C R loads are in flight (the register path: 32, 8
// rows of 4 columns, as many columns as a thread has at W = 768 and 12
// warps; the generic kernels one, where the tail's registers made ptxas
// spill).
template <int R, int C>
__device__ __forceinline__ void sum_rows(const float* __restrict__ src, int n, int cols,
                                         float* __restrict__ dst) {
  for (int c0 = threadIdx.x; c0 < cols; c0 += C * blockDim.x) {
    float acc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] = 0.f;
    int r = 0;
    for (; r + R <= n; r += R) {
      float v[R][C];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int c = c0 + j * blockDim.x;
          v[i][j] = c < cols ? __ldcg(src + (size_t)(r + i) * cols + c) : 0.f;
        }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[j] += v[i][j];
    }
    for (; r < n; ++r) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int c = c0 + j * blockDim.x;
        if (c < cols) acc[j] += __ldcg(src + (size_t)r * cols + c);
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = c0 + j * blockDim.x;
      if (c < cols) dst[c] = acc[j];
    }
  }
}

// Step 3, after this block wrote its [2W] partial: the group's last block
// adds the group's partials, the last group's the group sums into dgb
// (dgamma, then dbeta). scratch: [ceil(G / K)][2W] group sums, then [G][2W]
// block partials.
template <int R, int C>
__device__ void reduce_grid(float* __restrict__ scratch, float* __restrict__ dgb, int W, int K) {
  __shared__ unsigned int last;
  const int G = gridDim.x;
  const int groups = (G + K - 1) / K;
  const int g = blockIdx.x / K;
  const int first = g * K;
  const int n = min(K, G - first);
  const int cols = 2 * W;
  float* sums = scratch;
  const float* partial = scratch + (size_t)groups * cols;

  // the block's partial written, then one thread counts the block in: its
  // fence orders the whole block's writes (the barrier makes them its own)
  // before the count, and after it for the last block's reads
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&g_counts[g], 1u) == (unsigned int)(n - 1);
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  sum_rows<R, C>(partial + (size_t)first * cols, n, cols, sums + (size_t)g * cols);
  __syncthreads();
  if (threadIdx.x == 0) {
    g_counts[g] = 0;
    __threadfence();
    last = atomicAdd(&g_counts[kMaxGroups], 1u) == (unsigned int)(groups - 1);
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  sum_rows<R, C>(sums, groups, cols, dgb);
  if (threadIdx.x == 0) g_counts[kMaxGroups] = 0;
}

// x's and dy's vectors of one row on the register path (zeros where a
// lane's last slot lies past the row)
template <typename T, int NV>
__device__ __forceinline__ void load_row(const T* __restrict__ x, const T* __restrict__ dy, size_t off,
                                         int lane, int nv, uint4 (&rx)[NV], uint4 (&rdy)[NV]) {
  constexpr int E = Vec<T>::E;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int k = i * 32 + lane;
    if (k < nv) {
      rx[i] = load16(x + off + (size_t)k * E);
      rdy[i] = load16(dy + off + (size_t)k * E);
    } else {
      rx[i] = rdy[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Warps a block of the register path's backward: one block an SM, as many
// warps as its registers allow. An SM quadrant holds 16,384 registers, so
// 12 warps (3 a quadrant) leave a thread 168 and 8 warps 255 (ptxas -v
// without these bounds: bf16 72, 122, 158, 197, 242 registers a thread at
// S = 1..5; fp32 80, 124, 168, 159, 193). One block an SM keeps the grid
// at the SM count, so step 3 adds few partials, with many threads.
template <typename T, bool ADD, int S>
__host__ __device__ constexpr int bwd_warps() {
  if (sizeof(T) == 2) return S <= 2 || (S == 3 && !ADD) ? 12 : 8;
  return S <= 2 ? 12 : 8;
}

// Whether the ADD kernel loads a row's dx_out with the row (its latency
// hidden behind the passes) rather than in the last pass: where the
// registers it takes fit under bwd_warps' bound (bf16 at S = 3 takes 8
// warps for it: on the H100 that beat 12 warps without it at W = 768).
template <typename T, int S>
__host__ __device__ constexpr bool bwd_early_out() {
  return sizeof(T) == 2 ? S != 5 : S <= 3;
}

// The register path: lane l holds the row's 16-byte vectors i * 32 + l,
// i < NV (S slots of 8 elements: NV = S in bf16, 2 S in fp32), and the
// column sums of those columns. Where the registers allow (NV <= 6: every
// bf16 width, fp32 up to W = 768) the next row's x and dy are loaded while
// this row is computed, so a warp keeps loads in flight through its
// arithmetic. Shared memory: WARPS x W fp32, for step 2.
template <typename T, bool ADD, int S, int WARPS = bwd_warps<T, ADD, S>()>
__global__ void __launch_bounds__(WARPS * 32, 1)
layer_norm_bwd_reg_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                          const T* __restrict__ dy, const T* __restrict__ dx_out,
                          T* __restrict__ dx, float* __restrict__ scratch,
                          float* __restrict__ dgb, int N, int W, int K, float inv_w, float eps) {
  constexpr int E = Vec<T>::E;
  constexpr int NV = S * 8 / E;
  constexpr bool kPrefetch = NV <= 6;
  constexpr bool kEarlyOut = ADD && kPrefetch && bwd_early_out<T, S>();
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nv = W / E;
  const float w = (float)W;
  const int stride = gridDim.x * WARPS;

  float dg[NV][E], db[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) dg[i][e] = db[i][e] = 0.f;

  uint4 rx[NV], rdy[NV];
  int row = blockIdx.x * WARPS + warp;
  if (kPrefetch && row < N) load_row<T, NV>(x, dy, (size_t)row * W, lane, nv, rx, rdy);
  for (; row < N; row += stride) {
    const size_t off = (size_t)row * W;
    uint4 nx[NV], ndy[NV], ro[kEarlyOut ? NV : 1];
    if constexpr (kEarlyOut) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int k = i * 32 + lane;
        if (k < nv) ro[i] = load16(dx_out + off + (size_t)k * E);
      }
    }
    if (!kPrefetch) load_row<T, NV>(x, dy, off, lane, nv, rx, rdy);
    else if (row + stride < N) load_row<T, NV>(x, dy, off + (size_t)stride * W, lane, nv, nx, ndy);

    float total = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float v[E];
      Vec<T>::unpack(rx[i], v);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; e += 2) part += v[e] + v[e + 1];
      total += part;
    }
    const float mean = div_w(warp_sum(total), w, inv_w);

    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < nv) {
        float v[E];
        Vec<T>::unpack(rx[i], v);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float d = v[e] - mean;
          sq = fmaf(d, d, sq);
        }
      }
    }
    const float rstd = rsqrtf(div_w(warp_sum(sq), w, inv_w) + eps);

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = i * 32 + lane;
      if (k < nv) {
        float v[E], d[E], gm[E];
        Vec<T>::unpack(rx[i], v);
        Vec<T>::unpack(rdy[i], d);
        load_f32<E>(gamma + k * E, gm);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xhat = __fmul_rn(v[e] - mean, rstd);
          accumulate(xhat, __fmul_rn(d[e], gm[e]), d[e], dg[i][e], db[i][e], s1, s2);
        }
      }
    }
    const float m1 = warp_sum(s1) * inv_w;
    const float m2 = warp_sum(s2) * inv_w;

#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = i * 32 + lane;
      if (k < nv) {
        float v[E], d[E], gm[E], o[E];
        Vec<T>::unpack(rx[i], v);
        Vec<T>::unpack(rdy[i], d);
        load_f32<E>(gamma + k * E, gm);
        if constexpr (kEarlyOut) Vec<T>::unpack(ro[i], o);
        else if constexpr (ADD) Vec<T>::unpack(load16(dx_out + off + (size_t)k * E), o);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xhat = __fmul_rn(v[e] - mean, rstd);
          o[e] = finish<T, ADD>(__fmul_rn(d[e], gm[e]), xhat, m1, m2, rstd, ADD ? o[e] : 0.f);
        }
        store16(dx + off + (size_t)k * E, Vec<T>::pack(o));
      }
    }
    if (kPrefetch && row + stride < N) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        rx[i] = nx[i];
        rdy[i] = ndy[i];
      }
    }
  }

  // step 2: dgamma, then dbeta, through WARPS x W of shared memory
  const int groups = (gridDim.x + K - 1) / K;
  float* out = scratch + ((size_t)groups + blockIdx.x) * 2 * W;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = i * 32 + lane;
      if (k < nv) {
#pragma unroll
        for (int e = 0; e < E; ++e) smem[(size_t)warp * W + k * E + e] = part ? db[i][e] : dg[i][e];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < W; c += blockDim.x) {
      float acc = 0.f;
#pragma unroll
      for (int v = 0; v < WARPS; ++v) acc += smem[(size_t)v * W + c];
      out[(size_t)part * W + c] = acc;
    }
    __syncthreads();
  }
  reduce_grid<8, 4>(scratch, dgb, W, K);
}

// The generic path. W4: the leading columns moved 4 at a time (W when
// W % 4 == 0 and every pointer is 16-byte aligned, else 0); the rest go one
// at a time. Each warp keeps its own [2, W] column sums in shared memory (a
// lane only ever touches its own columns: no atomics, no barrier inside the
// loop), and a row is parked there between the passes (x, then xhat and g).
// (At least 4 blocks an SM in the launch bounds: without it ptxas holds
// this kernel near 56 registers and spills.)
template <typename T, bool ADD>
__global__ void __launch_bounds__(kWarps * 32, 4)
layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const T* __restrict__ dy, const T* __restrict__ dx_out,
                      T* __restrict__ dx, float* __restrict__ scratch,
                      float* __restrict__ dgb, int N, int W, int W4, int K, float inv_w,
                      float eps) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* xs = smem + (size_t)warp * 4 * W;  // x, then xhat
  float* gs = xs + W;                       // dy * gamma
  float* dgs = gs + W;                      // this warp's column sums of dy * xhat
  float* dbs = dgs + W;                     // ... and of dy
  for (int c = lane; c < W; c += 32) {
    dgs[c] = 0.f;
    dbs[c] = 0.f;
  }
  // a lane clears columns lane, lane + 32, ... and later updates 4 * lane ..
  __syncwarp();

  for (int row = blockIdx.x * kWarps + warp; row < N; row += gridDim.x * kWarps) {
    const size_t off = (size_t)row * W;
    const T* xr = x + off;
    const T* dyr = dy + off;

    float total = 0.f;
    for (int c = lane * 4; c < W4; c += 128) {
      float v[4];
      load4(xr + c, v);
      store4(xs + c, v);
      total += (v[0] + v[1]) + (v[2] + v[3]);
    }
    for (int c = W4 + lane; c < W; c += 32) {
      const float v = to_float(xr[c]);
      xs[c] = v;
      total += v;
    }
    const float mean = div_w(warp_sum(total), (float)W, inv_w);

    float sq = 0.f;
    for (int c = lane * 4; c < W4; c += 128) {
      float v[4];
      load4(xs + c, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = v[i] - mean;
        sq = fmaf(d, d, sq);
      }
    }
    for (int c = W4 + lane; c < W; c += 32) {
      const float d = xs[c] - mean;
      sq = fmaf(d, d, sq);
    }
    const float rstd = rsqrtf(div_w(warp_sum(sq), (float)W, inv_w) + eps);

    float s1 = 0.f, s2 = 0.f;
    for (int c = lane * 4; c < W4; c += 128) {
      float v[4], d[4], gm[4], dg[4], db[4], xh[4], g[4];
      load4(xs + c, v);
      load4(dyr + c, d);
      load4(gamma + c, gm);
      load4(dgs + c, dg);
      load4(dbs + c, db);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xh[i] = __fmul_rn(v[i] - mean, rstd);
        g[i] = __fmul_rn(d[i], gm[i]);
        accumulate(xh[i], g[i], d[i], dg[i], db[i], s1, s2);
      }
      store4(xs + c, xh);
      store4(gs + c, g);
      store4(dgs + c, dg);
      store4(dbs + c, db);
    }
    for (int c = W4 + lane; c < W; c += 32) {
      const float d = to_float(dyr[c]);
      const float xh = __fmul_rn(xs[c] - mean, rstd);
      const float g = __fmul_rn(d, gamma[c]);
      accumulate(xh, g, d, dgs[c], dbs[c], s1, s2);
      xs[c] = xh;
      gs[c] = g;
    }
    const float m1 = warp_sum(s1) * inv_w;
    const float m2 = warp_sum(s2) * inv_w;

    T* dxr = dx + off;
    for (int c = lane * 4; c < W4; c += 128) {
      float xh[4], g[4], o[4] = {0.f, 0.f, 0.f, 0.f};
      load4(xs + c, xh);
      load4(gs + c, g);
      if (ADD) load4(dx_out + off + c, o);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = finish<T, ADD>(g[i], xh[i], m1, m2, rstd, o[i]);
      store4(dxr + c, o);
    }
    for (int c = W4 + lane; c < W; c += 32) {
      const float o = ADD ? to_float(dx_out[off + c]) : 0.f;
      dxr[c] = from_float<T>(finish<T, ADD>(gs[c], xs[c], m1, m2, rstd, o));
    }
  }

  // step 2: the warps' sums in warp order
  __syncthreads();
  const int groups = (gridDim.x + K - 1) / K;
  float* out = scratch + ((size_t)groups + blockIdx.x) * 2 * W;
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    float dg = 0.f, db = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      dg += smem[(size_t)w * 4 * W + 2 * W + c];
      db += smem[(size_t)w * 4 * W + 3 * W + c];
    }
    out[c] = dg;
    out[W + c] = db;
  }
  reduce_grid<1, 1>(scratch, dgb, W, K);
}

size_t generic_smem(int W) { return (size_t)kWarps * 4 * W * sizeof(float); }

// The kernel a call runs, its warps a block and its dynamic shared memory.
struct Geometry {
  const void* fn;
  int warps;
  size_t smem;
};

template <typename T, bool ADD, int S>
Geometry reg_geometry(int W) {
  if (slots(W) == S) {
    constexpr int warps = bwd_warps<T, ADD, S>();
    return {(const void*)layer_norm_bwd_reg_kernel<T, ADD, S>, warps, (size_t)warps * W * sizeof(float)};
  }
  if constexpr (S < kMaxSlots) return reg_geometry<T, ADD, S + 1>(W);
  return {nullptr, 0, 0};
}

template <typename T, bool ADD>
Geometry geometry(int W, int path) {
  if (path == kRegisters) return reg_geometry<T, ADD, 1>(W);
  return {(const void*)layer_norm_bwd_kernel<T, ADD>, kWarps, generic_smem(W)};
}

Geometry geometry(int W, int dtype, bool add, int path) {
  if (dtype == 0) return add ? geometry<float, true>(W, path) : geometry<float, false>(W, path);
  return add ? geometry<__nv_bfloat16, true>(W, path) : geometry<__nv_bfloat16, false>(W, path);
}

template <typename T, bool ADD>
int launch(const void* xv, const float* gamma, const void* dyv, const void* dx_outv, void* dxv,
           float* scratch, float* dgb, int N, int W, int G, float eps, int path,
           cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* dy = static_cast<const T*>(dyv);
  const T* dx_out = static_cast<const T*>(dx_outv);
  T* dx = static_cast<T*>(dxv);
  const bool aligned = aligned16(x) && aligned16(dy) && aligned16(dx) && aligned16(gamma) &&
                       (!ADD || aligned16(dx_out));
  int K = group_size(G);
  float inv_w = 1.f / (float)W;  // on the host: no division on the card
  if (path == kRegisters) {
    // the caller's rule (ops/ln.py: register_path); refused, never rerouted
    if (W % 8 != 0 || W > kRegMaxW || !aligned) return (int)cudaErrorInvalidValue;
    const Geometry geo = geometry<T, ADD>(W, path);
    void* args[] = {&x, &gamma, &dy, &dx_out, &dx, &scratch, &dgb, &N, &W, &K, &inv_w, &eps};
    const cudaError_t e = cudaLaunchKernel(geo.fn, dim3(G), dim3(geo.warps * 32), args, geo.smem, stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  const int W4 = (W % 4 == 0 && aligned) ? W : 0;
  layer_norm_bwd_kernel<T, ADD><<<G, kWarps * 32, generic_smem(W), stream>>>(
      x, gamma, dy, dx_out, dx, scratch, dgb, N, W, W4, K, inv_w, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Once a device, before its first K4c call: lets the generic kernels take
// the shared memory of the widest row (above the default 48 KB), and loads
// the library on the device. Returns a CUDA error code.
extern "C" int clip_layer_norm_bwd_setup() {
  const void* fns[] = {(const void*)layer_norm_bwd_kernel<float, false>,
                       (const void*)layer_norm_bwd_kernel<float, true>,
                       (const void*)layer_norm_bwd_kernel<__nv_bfloat16, false>,
                       (const void*)layer_norm_bwd_kernel<__nv_bfloat16, true>};
  for (const void* fn : fns) {
    const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)generic_smem(kMaxW));
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Blocks of the kernel a call at (W, dtype, dx_out given or not, path)
// runs that one SM holds at once (its registers and shared memory), or a
// negative CUDA error code; *warps: its warps a block, one row at a time each.
extern "C" int clip_layer_norm_bwd_blocks_per_sm(int W, int dtype, int add, int path, int* warps) {
  if (W < 1 || W > kMaxW || (dtype != 0 && dtype != 1) ||
      (path == kRegisters && (W % 8 != 0 || W > kRegMaxW)))
    return -(int)cudaErrorInvalidValue;
  const Geometry geo = geometry(W, dtype, add != 0, path);
  int blocks = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, geo.fn, geo.warps * 32, geo.smem);
  *warps = geo.warps;
  return e != cudaSuccess ? -(int)e : blocks;
}

// G: the grid's blocks (<= 4096); scratch: fp32, the outputs dgamma [W]
// and dbeta [W], then [ceil(G / K)][2][W] group sums and [G][2][W] block
// partials (K = ceil(sqrt(G))). dtype: 0 = fp32, 1 = bf16; path as
// clip_layer_norm_fwd's. Returns cudaGetLastError() after the launch.
extern "C" int clip_layer_norm_bwd(const void* x, const void* gamma, const void* dy,
                                   const void* dx_out, void* dx, void* scratch, int N, int W, int G,
                                   float eps, int dtype, int path, void* stream) {
  if (N < 1 || W < 1 || W > kMaxW || G < 1 || G > kMaxBlocks || (dtype != 0 && dtype != 1) ||
      (path != kGeneric && path != kRegisters))
    return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gamma);
  float* dgb = static_cast<float*>(scratch);  // dgamma, then dbeta
  float* sc = dgb + 2 * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool add = dx_out != nullptr;
  if (dtype == 0) {
    if (add) return launch<float, true>(x, g, dy, dx_out, dx, sc, dgb, N, W, G, eps, path, s);
    return launch<float, false>(x, g, dy, dx_out, dx, sc, dgb, N, W, G, eps, path, s);
  }
  if (add) return launch<__nv_bfloat16, true>(x, g, dy, dx_out, dx, sc, dgb, N, W, G, eps, path, s);
  return launch<__nv_bfloat16, false>(x, g, dy, dx_out, dx, sc, dgb, N, W, G, eps, path, s);
}

extern "C" const char* clip_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
