// Fused LM-head + SCE loss kernels for Hopper (sm_90a), bound through a plain
// C interface (ctypes). Python side: vct_tpu_torch/ops/loss_kernels.py.
//
// Replaces (vct_tpu/ops/pallas_loss.py):
//   * softmax_stats       (:124, _pass1_kernel :79)   online max / sum / label logit
//   * clipped_prob_stats  (:207, _pass2_kernel :170)  sum and count of p > 1e-7
//   * sce_backward_tiles  (:305, _bwd_kernel :254)    dz tiles, dx, dbg partials
//
// What bounds them on an H100: each kernel is a [N, E] x [E, V] product
// (2*N*E*V operations, 93.6 GFLOP at N=1984, E=768, V=30720) feeding a
// per-row reduction; the weights are 47 MB in bf16. Against 989 TFLOP/s and
// 3.35 TB/s the forward kernels are bound by operations (0.095 ms vs 0.014 ms
// of bytes); the backward one does two such products and writes the 122 MB
// dz.
//
// Three designs:
//
//   bfloat16 statistics (both forward kernels) -> stats_wgmma_kernel<MODE>
//   then stats_merge_kernel<MODE>:
//   * The vocab is split across blocks. A tile is (row tile of ST_BM = 128
//     rows, slab of ST_BN = 256 vocab columns); one persistent block per SM
//     walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ... in slab-major
//     order, so the blocks in flight share a few slabs of the weight in L2
//     and the weight crosses HBM about once. Every SM has work at every N
//     the kernel route takes (N=256: 2 x 120 tiles; N=1984: 16 x 120), and a
//     weight byte crosses into shared memory once per 128 rows, not once
//     per 32 as in stats_kernel.
//   * The product is wgmma.m64n256k16 with both operands in shared memory:
//     x [N, E] and the weight [V, E] are both K-major as they lie, written
//     by cp.async in 16-byte pieces (zero fill for rows past N and weight
//     rows past V) in the 128-byte swizzle, K in steps of 64 through a ring
//     of ST_STAGES stages that runs across tile boundaries. Each warpgroup
//     owns 64 rows of the tile and keeps their 64 x 256 float32 accumulators
//     in registers. The loop waits for the products of the step before last
//     only, but ptxas inserts a wait for the last one too (its note C7517);
//     an explicit wait for both, without that note, timed the same.
//   * The epilogue stays in registers: each accumulator is rounded to
//     bfloat16 and the bias added in bfloat16 (the reference's rounding
//     point), two columns at a time; the slab's bias waits in shared memory,
//     staged while the tile's first products run. A column past V has a
//     zero weight row and a NEG_INF bias, so its p is exactly 0 with no
//     mask, as on a padded generator. Each row's statistics over the slab
//     (MODE 0: max, the sum rescaled to it, the label logit; MODE 1: sa and
//     cnt of p > 1e-7) are reduced over the four lanes that hold the row.
//     One float32 partial per (row, slab) goes to a scratch buffer; the
//     label logit is written once, by the lane that holds it.
//   * stats_merge_kernel folds each row's partials in ascending slab order
//     (the online rescale for MODE 0, plain sums for MODE 1). No float
//     atomics: the same bits on every run.
//
//   bfloat16 backward -> bwd_dz_wgmma_kernel (dz and the dbg partials: the
//   statistics kernel's walk and product with a dz epilogue), then
//   bwd_dx_wgmma_kernel (dx = dz . w on wgmma, the vocab split into groups
//   across the SMs) and bwd_dx_merge_kernel (the groups' partials added in
//   order); described above the kernels. Route 0 reaches backward_kernel for
//   timing, and N past BWD_MAX_N takes it.
//
//   float32 statistics, and the float32 backward -> stats_kernel<T, MODE> and
//   backward_kernel<T>: one block owns a tile of BM rows and walks
//   the vocab in ascending tiles of 512 columns, which takes the place of the
//   TPU grid's sequential vocab axis. x's row tile stays in shared memory for
//   the whole walk; the weight tile streams through a two-stage cp.async
//   ring; the per-row accumulators (m, s, zt / sa, cnt) live in registers of
//   the warp that owns the row, and dx lives in tensor-core accumulator
//   fragments across the walk. A model wider than 768 gets its dx in column
//   slabs of 768, each with a vocab walk of its own that recomputes the
//   logits; dz and the dbg partials are written by the first walk only. The
//   product is nvcuda::wmma 16x16x16 bf16 tiles with fp32 accumulation, or a
//   shared-memory FMA tile for float32. The bfloat16 stats_kernel and
//   backward_kernel stay reachable (route 0) so that checks can time them
//   against their replacements.
//
// Layout: x [N, E] row-major; the generator weight in PyTorch's own [V, E]
// layout (row v holds column v of the product's right-hand side), so the
// 47 MB parameter is never transposed: the logits product reads it as a
// col-major B operand, the dx product as a row-major one. V is any count of
// rows: the kernels mask the ragged last vocab tile themselves (weight rows
// past V load as zeros, bias columns past V read as NEG_INF), so a pad
// column contributes exactly 0, as the zero rows and NEG_INF bias of a padded
// generator did. dz and the dbg partials have V_pad = round_up(V, 512)
// columns. Rows past N are masked inside the kernels (no padded copy of x).
// A label outside [0, V) has no logit: zt is 0 and no dz element subtracts
// the label term.
//
// Rounding points (vct_tpu/ops/pallas_loss.py:86-91): the logits tile is the
// fp32-accumulated product rounded to the compute dtype, then the bias is
// added in the compute dtype; every statistic is fp32; vocab tiles reduce in
// ascending order with the online rescale; dz subtracts the label term before
// rounding; dx accumulates the rounded dz in fp32; dbg sums the un-rounded dz
// over the block's rows in row order (no float atomics anywhere).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = 8;
constexpr int TILE_V = 512;
// dx's row tile lives in accumulator registers for a whole vocab walk, which
// caps the columns one walk can carry: a wider dx is made in slabs of SLAB_E
constexpr int SLAB_E = 768;
constexpr int MAX_DX_FRAGS = SLAB_E / 128;  // bf16: column fragments per warp
constexpr int MAX_DX_COLS = SLAB_E / 256;   // float32: columns t + 256 j
constexpr float EPS = 1e-7f;
constexpr float NEG_INF = -1e30f;  // the bias of a column past V

template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int BM = 32, KC = 32, KC2 = 16, PAD = 8;
};
template <> struct Cfg<float> {
  static constexpr int BM = 16, KC = 16, KC2 = 8, PAD = 4;
};

struct Params {
  const void* x;
  const void* w;
  const void* b;
  const int* labels;
  const float* lse;
  const float* u;
  const float* cc;
  const float* lt;
  float* o0;  // pass 1: m     pass 2: sa    backward: dx
  float* o1;  // pass 1: s     pass 2: cnt   backward: dbg partials
  float* o2;  // pass 1: zt
  void* dz;
  int n, e;
  int v;      // rows of the weight and entries of the bias
  int v_pad;  // v rounded up to TILE_V: the columns of dz and of the dbg partials
};

// ---- shared-memory plan (elements of T unless said) ------------------------

template <typename T> __host__ __device__ constexpr int xld(int e) { return e + Cfg<T>::PAD; }
template <typename T> __host__ __device__ constexpr int zld() { return TILE_V + Cfg<T>::PAD; }
template <typename T> __host__ __device__ constexpr int wld() { return Cfg<T>::KC + Cfg<T>::PAD; }

// leading dimension of a dx slab's weight rows in the ring
template <typename T> __host__ __device__ constexpr int sld(int e) {
  return xld<T>(e < SLAB_E ? e : SLAB_E);
}

template <typename T> __host__ __device__ inline int stage_elems(int e, bool bwd) {
  const int logits = TILE_V * wld<T>();
  const int dx = Cfg<T>::KC2 * sld<T>(e);
  return (bwd && dx > logits) ? dx : logits;
}

template <typename T> __host__ __device__ inline size_t smem_bytes(int e, bool bwd) {
  size_t bytes = (size_t)Cfg<T>::BM * xld<T>(e) * sizeof(T);     // x row tile
  bytes += (size_t)Cfg<T>::BM * zld<T>() * sizeof(T);             // logits / dz tile
  bytes += 2 * (size_t)stage_elems<T>(e, bwd) * sizeof(T);        // weight ring
  bytes += (size_t)WARPS * 256 * sizeof(float);                   // fragment patches
  bytes += (size_t)5 * Cfg<T>::BM * sizeof(float);                // per-row scalars
  return bytes;
}

// ---- small helpers ----------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// fp32 accumulator -> compute dtype, bias added in the compute dtype
__device__ __forceinline__ float round_add(float acc, float bias) { return acc + bias; }
__device__ __forceinline__ bf16 round_add(float acc, bf16 bias) {
  return __float2bfloat16(__bfloat162float(__float2bfloat16(acc)) + __bfloat162float(bias));
}

// the bias of column col; NEG_INF past the last of the v columns
template <typename T> __device__ __forceinline__ T bias_at(const T* bias, int col, int v) {
  return col < v ? bias[col] : from_f<T>(NEG_INF);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- loads --------------------------------------------------------------------

// rows [row0, row0 + BM) of x into xs; rows past n become zeros
template <typename T>
__device__ void load_x_tile(T* xs, const T* x, int n, int e, int row0) {
  constexpr int PER = 16 / sizeof(T);
  const int segs = e / PER;
  for (int idx = threadIdx.x; idx < Cfg<T>::BM * segs; idx += THREADS) {
    const int row = idx / segs, seg = idx - row * segs;
    T* dst = xs + row * xld<T>(e) + seg * PER;
    if (row0 + row < n)
      cp_async16(dst, x + (size_t)(row0 + row) * e + seg * PER, true);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// w[v0 .. v0+512, k0 .. k0+KC) -> dst[512][wld]; rows past v become zeros
template <typename T>
__device__ __forceinline__ void load_w_chunk(T* dst, const T* w, int e, int v, int v0, int k0) {
  constexpr int PER = 16 / sizeof(T), SEGS = Cfg<T>::KC / PER;
  for (int idx = threadIdx.x; idx < TILE_V * SEGS; idx += THREADS) {
    const int row = idx / SEGS, seg = idx - row * SEGS;
    const bool ok = v0 + row < v;
    cp_async16(dst + row * wld<T>() + seg * PER,
               w + (ok ? (size_t)(v0 + row) * e + k0 + seg * PER : 0), ok);
  }
  cp_async_commit();
}

// w[r0 .. r0+KC2, e0 .. e0+es) -> dst[KC2][sld]; rows past v become zeros
template <typename T>
__device__ __forceinline__ void load_w_rows(T* dst, const T* w, int e, int v, int r0, int e0,
                                            int es) {
  constexpr int PER = 16 / sizeof(T);
  const int segs = es / PER;
  for (int idx = threadIdx.x; idx < Cfg<T>::KC2 * segs; idx += THREADS) {
    const int row = idx / segs, seg = idx - row * segs;
    const bool ok = r0 + row < v;
    cp_async16(dst + row * sld<T>(e) + seg * PER,
               w + (ok ? (size_t)(r0 + row) * e + e0 + seg * PER : 0), ok);
  }
  cp_async_commit();
}

// ---- the logits tile: zs[BM][512] = round(xs . w_tile^T) + bias, in T --------

__device__ void logits_tile(const bf16* xs, bf16* ring, int stage, bf16* zs, float* patch,
                            const bf16* w, const bf16* bias, int e, int v, int v0) {
  using C = Cfg<bf16>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int XLD = xld<bf16>(e);
  constexpr int WLD = wld<bf16>(), ZLD = zld<bf16>();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nch = e / C::KC;
  load_w_chunk<bf16>(ring, w, e, v, v0, 0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      load_w_chunk<bf16>(ring + ((ch + 1) & 1) * stage, w, e, v, v0, (ch + 1) * C::KC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ws = ring + (ch & 1) * stage;
#pragma unroll
    for (int kk = 0; kk < C::KC / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + i * 16 * XLD + ch * C::KC + kk * 16, XLD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, ws + (warp * 64 + j * 16) * WLD + kk * 16, WLD);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* pw = patch + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(pw, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int idx = lane + 32 * q, rr = idx >> 4, col = warp * 64 + j * 16 + (idx & 15);
        zs[(i * 16 + rr) * ZLD + col] = round_add(pw[idx], bias_at(bias, v0 + col, v));
      }
      __syncwarp();
    }
  __syncthreads();
}

__device__ void logits_tile(const float* xs, float* ring, int stage, float* zs, float* /*patch*/,
                            const float* w, const float* bias, int e, int v, int v0) {
  using C = Cfg<float>;
  const int t = threadIdx.x;
  const int XLD = xld<float>(e);
  constexpr int WLD = wld<float>(), ZLD = zld<float>();
  float acc[C::BM][2];
#pragma unroll
  for (int r = 0; r < C::BM; ++r) acc[r][0] = acc[r][1] = 0.0f;

  const int nch = e / C::KC;
  load_w_chunk<float>(ring, w, e, v, v0, 0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      load_w_chunk<float>(ring + ((ch + 1) & 1) * stage, w, e, v, v0, (ch + 1) * C::KC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ws = ring + (ch & 1) * stage;
#pragma unroll
    for (int k = 0; k < C::KC; ++k) {
      const float w0 = ws[t * WLD + k], w1 = ws[(t + 256) * WLD + k];
#pragma unroll
      for (int r = 0; r < C::BM; ++r) {
        const float xv = xs[r * XLD + ch * C::KC + k];
        acc[r][0] = fmaf(xv, w0, acc[r][0]);
        acc[r][1] = fmaf(xv, w1, acc[r][1]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < C::BM; ++r) {
    zs[r * ZLD + t] = round_add(acc[r][0], bias_at(bias, v0 + t, v));
    zs[r * ZLD + t + 256] = round_add(acc[r][1], bias_at(bias, v0 + t + 256, v));
  }
  __syncthreads();
}

// ---- dx[:, e0 .. e0+es) += dz_tile[BM][512] . w_tile[512][e0 .. e0+es) ----------------------------------

template <typename T> struct DxAcc;

template <> struct DxAcc<bf16> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[2][MAX_DX_FRAGS];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < MAX_DX_FRAGS; ++j) wmma::fill_fragment(f[i][j], 0.0f);
  }

  __device__ void add_tile(const bf16* zs, bf16* ring, int stage, const bf16* w, int e, int v,
                           int v0, int e0, int es) {
    using C = Cfg<bf16>;
    const int warp = threadIdx.x >> 5;
    const int SLD = sld<bf16>(e), nf = es / 128, col0 = warp * (es / 8);
    constexpr int ZLD = zld<bf16>();
    constexpr int nch = TILE_V / C::KC2;
    load_w_rows<bf16>(ring, w, e, v, v0, e0, es);
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + 1 < nch) {
        load_w_rows<bf16>(ring + ((ch + 1) & 1) * stage, w, e, v, v0 + (ch + 1) * C::KC2, e0,
                          es);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* ws = ring + (ch & 1) * stage;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], zs + i * 16 * ZLD + ch * C::KC2, ZLD);
#pragma unroll
      for (int j = 0; j < MAX_DX_FRAGS; ++j) {
        if (j < nf) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, ws + col0 + j * 16, SLD);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(f[i][j], a[i], b, f[i][j]);
        }
      }
      __syncthreads();
    }
  }

  __device__ void store(float* dx, float* patch, int n, int e, int row0, int e0, int es) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nf = es / 128, col0 = e0 + warp * (es / 8);
    float* pw = patch + warp * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < MAX_DX_FRAGS; ++j) {
        if (j < nf) {
          wmma::store_matrix_sync(pw, f[i][j], 16, wmma::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int idx = lane + 32 * q, row = row0 + i * 16 + (idx >> 4);
            if (row < n) dx[(size_t)row * e + col0 + j * 16 + (idx & 15)] = pw[idx];
          }
          __syncwarp();
        }
      }
  }
};

template <> struct DxAcc<float> {
  float f[Cfg<float>::BM][MAX_DX_COLS];

  __device__ void zero() {
#pragma unroll
    for (int r = 0; r < Cfg<float>::BM; ++r)
#pragma unroll
      for (int j = 0; j < MAX_DX_COLS; ++j) f[r][j] = 0.0f;
  }

  __device__ void add_tile(const float* zs, float* ring, int stage, const float* w, int e,
                           int v, int v0, int e0, int es) {
    using C = Cfg<float>;
    const int t = threadIdx.x;
    const int SLD = sld<float>(e);
    constexpr int ZLD = zld<float>();
    constexpr int nch = TILE_V / C::KC2;
    load_w_rows<float>(ring, w, e, v, v0, e0, es);
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + 1 < nch) {
        load_w_rows<float>(ring + ((ch + 1) & 1) * stage, w, e, v, v0 + (ch + 1) * C::KC2, e0,
                           es);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* ws = ring + (ch & 1) * stage;
#pragma unroll
      for (int k = 0; k < C::KC2; ++k) {
        float wv[MAX_DX_COLS];
#pragma unroll
        for (int j = 0; j < MAX_DX_COLS; ++j) {
          const int col = t + 256 * j;
          wv[j] = col < es ? ws[k * SLD + col] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < C::BM; ++r) {
          const float a = zs[r * ZLD + ch * C::KC2 + k];
#pragma unroll
          for (int j = 0; j < MAX_DX_COLS; ++j) f[r][j] = fmaf(a, wv[j], f[r][j]);
        }
      }
      __syncthreads();
    }
  }

  __device__ void store(float* dx, float* /*patch*/, int n, int e, int row0, int e0, int es) {
    const int t = threadIdx.x;
#pragma unroll
    for (int r = 0; r < Cfg<float>::BM; ++r)
#pragma unroll
      for (int j = 0; j < MAX_DX_COLS; ++j) {
        const int col = t + 256 * j;
        if (row0 + r < n && col < es) dx[(size_t)(row0 + r) * e + e0 + col] = f[r][j];
      }
  }
};

// ---- the kernels ------------------------------------------------------------------

template <typename T> struct Smem {
  T* xs;
  T* zs;
  T* ring;
  float* patch;
  float* rows;
  int stage;
};

template <typename T> __device__ Smem<T> carve(unsigned char* base, int e, bool bwd) {
  Smem<T> s;
  s.stage = stage_elems<T>(e, bwd);
  s.xs = reinterpret_cast<T*>(base);
  s.zs = s.xs + Cfg<T>::BM * xld<T>(e);
  s.ring = s.zs + Cfg<T>::BM * zld<T>();
  s.patch = reinterpret_cast<float*>(s.ring + 2 * s.stage);
  s.rows = s.patch + WARPS * 256;
  return s;
}

// MODE 0: softmax_stats; MODE 1: clipped_prob_stats
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, 1) stats_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int BM = Cfg<T>::BM, RPW = BM / WARPS, ZLD = zld<T>();
  const Smem<T> sm = carve<T>(smem_raw, p.e, false);
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* w = static_cast<const T*>(p.w);
  const T* bias = static_cast<const T*>(p.b);
  load_x_tile<T>(sm.xs, static_cast<const T*>(p.x), p.n, p.e, row0);

  float a0[RPW], a1[RPW], a2[RPW], lse[RPW];
  int lab[RPW];
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    const int row = row0 + warp + WARPS * q;
    a0[q] = MODE == 0 ? -INFINITY : 0.0f;
    a1[q] = 0.0f;
    a2[q] = 0.0f;
    const int l = (MODE == 0 && row < p.n) ? p.labels[row] : -1;
    lab[q] = (l >= 0 && l < p.v) ? l : -1;  // a label outside [0, v) has no logit
    lse[q] = (MODE == 1 && row < p.n) ? p.lse[row] : 0.0f;
  }

  for (int v0 = 0; v0 < p.v_pad; v0 += TILE_V) {
    logits_tile(sm.xs, sm.ring, sm.stage, sm.zs, sm.patch, w, bias, p.e, p.v, v0);
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const T* zr = sm.zs + (warp + WARPS * q) * ZLD;
      float z[TILE_V / 32];
#pragma unroll
      for (int i = 0; i < TILE_V / 32; ++i) z[i] = to_f(zr[lane + 32 * i]);
      if (MODE == 0) {
        float cmax = z[0], cand = 0.0f;
        const int loc = lab[q] - v0;
#pragma unroll
        for (int i = 0; i < TILE_V / 32; ++i) {
          cmax = fmaxf(cmax, z[i]);
          if (lane + 32 * i == loc) cand = z[i];
        }
        cmax = warp_max(cmax);
        cand = warp_sum(cand);
        const float m_new = fmaxf(a0[q], cmax);
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < TILE_V / 32; ++i) part += expf(z[i] - m_new);
        part = warp_sum(part);
        a1[q] = a1[q] * expf(a0[q] - m_new) + part;
        a0[q] = m_new;
        a2[q] += cand;
      } else {
        float sa = 0.0f, cnt = 0.0f;
#pragma unroll
        for (int i = 0; i < TILE_V / 32; ++i) {
          const float pr = expf(z[i] - lse[q]);
          if (pr > EPS) {
            sa += pr;
            cnt += 1.0f;
          }
        }
        a0[q] += warp_sum(sa);
        a1[q] += warp_sum(cnt);
      }
    }
    // the next tile's epilogue rewrites zs only after its own barriers
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const int row = row0 + warp + WARPS * q;
      if (row < p.n) {
        p.o0[row] = a0[q];
        p.o1[row] = a1[q];
        if (MODE == 0) p.o2[row] = a2[q];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) backward_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int BM = Cfg<T>::BM, ZLD = zld<T>();
  const Smem<T> sm = carve<T>(smem_raw, p.e, true);
  const int row0 = blockIdx.x * BM;
  const int t = threadIdx.x;
  const T* w = static_cast<const T*>(p.w);
  const T* bias = static_cast<const T*>(p.b);
  T* dzg = static_cast<T*>(p.dz);
  float* lse_s = sm.rows;
  float* u_s = sm.rows + BM;
  float* cc_s = sm.rows + 2 * BM;
  float* lt_s = sm.rows + 3 * BM;
  int* lab_s = reinterpret_cast<int*>(sm.rows + 4 * BM);
  const int rows = min(BM, p.n - row0);
  if (t < BM) {
    const bool live = t < rows;
    lse_s[t] = live ? p.lse[row0 + t] : 0.0f;
    u_s[t] = live ? p.u[row0 + t] : 0.0f;
    cc_s[t] = live ? p.cc[row0 + t] : 0.0f;
    lt_s[t] = live ? p.lt[row0 + t] : 0.0f;
    const int l = live ? p.labels[row0 + t] : -1;
    lab_s[t] = (l >= 0 && l < p.v) ? l : -1;
  }
  load_x_tile<T>(sm.xs, static_cast<const T*>(p.x), p.n, p.e, row0);

  DxAcc<T> dx;
  // one vocab walk per slab of dx columns; the first also writes dz and dbg
  for (int e0 = 0; e0 < p.e; e0 += SLAB_E) {
    const int es = min(SLAB_E, p.e - e0);
    const bool first = e0 == 0;
    dx.zero();
    for (int v0 = 0; v0 < p.v_pad; v0 += TILE_V) {
      logits_tile(sm.xs, sm.ring, sm.stage, sm.zs, sm.patch, w, bias, p.e, p.v, v0);
      // dz in place over the logits tile: one thread per column walks the rows,
      // so the column sum of the un-rounded dz has a fixed order
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = t + 256 * jj, gcol = v0 + col;
        float colsum = 0.0f;
        for (int r = 0; r < BM; ++r) {
          T out = from_f<T>(0.0f);
          if (r < rows) {
            const float z = to_f(sm.zs[r * ZLD + col]);
            const float pr = expf(z - lse_s[r]);
            float dz = pr * (u_s[r] + cc_s[r] * (pr > EPS ? 1.0f : 0.0f));
            if (gcol == lab_s[r]) dz -= lt_s[r];
            colsum += dz;
            out = from_f<T>(dz);
            if (first) dzg[(size_t)(row0 + r) * p.v_pad + gcol] = out;
          }
          sm.zs[r * ZLD + col] = out;
        }
        if (first) p.o1[(size_t)blockIdx.x * p.v_pad + gcol] = colsum;
      }
      __syncthreads();
      dx.add_tile(sm.zs, sm.ring, sm.stage, w, p.e, p.v, v0, e0, es);
    }
    dx.store(p.o0, sm.patch, p.n, p.e, row0, e0, es);
  }
}

// ---- the tensor-core statistics kernel (bfloat16) --------------------------------

constexpr int ST_THREADS = 256;   // two warpgroups: rows 0-63 and 64-127 of a row tile
constexpr int ST_BM = 128;        // rows of a row tile
constexpr int ST_BN = 256;        // vocab columns of a slab: the N of wgmma.m64n256k16
constexpr int ST_BK = 64;         // K step: one 128-byte swizzled row of each operand
constexpr int ST_STAGES = 4;      // ring stages: two steps of copies and one product in flight
constexpr int ST_X_BYTES = ST_BM * 128;
constexpr int ST_STAGE = ST_X_BYTES + ST_BN * 128;
// 1 KB to reach a 1024-byte boundary, the ring, and two slabs of bias
constexpr int ST_SMEM = 1024 + ST_STAGES * ST_STAGE + 2 * ST_BN * 2;
static_assert(ST_THREADS == ST_BN, "one thread stages one bias entry of a slab");
constexpr int MERGE_THREADS = 128;

// Ties registers to this point of the program: after a wgmma wait, no read of
// the accumulators may be scheduled above it.
template <int N> __device__ __forceinline__ void pin_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Walks (tile, K step) in that nesting; the loader and the consumer each keep one.
struct StCursor {
  int tile, ks;
  __device__ __forceinline__ void advance(int ksteps, int stride) {
    if (++ks == ksteps) {
      ks = 0;
      tile += stride;
    }
  }
};

// One K step of a (row tile, slab) tile into a ring stage: x rows [rt * 128,
// +128) and weight rows [slab * 256, +256), columns [k0, k0 + 64); piece c of
// row r lands at piece c ^ (r % 8). Rows past n and weight rows past v are
// zeros.
__device__ __forceinline__ void st_fetch(unsigned char* st, const StCursor& c, const bf16* x,
                                         const bf16* w, int n, int e, int v, int row_tiles) {
  const int tid = threadIdx.x;
  const int slab = c.tile / row_tiles, rt = c.tile - slab * row_tiles;
  const int k0 = c.ks * ST_BK;
#pragma unroll
  for (int i = 0; i < ST_BM * 8 / ST_THREADS; ++i) {
    const int chunk = tid + i * ST_THREADS, r = chunk >> 3, kc = chunk & 7;
    const int row = rt * ST_BM + r;
    const bool ok = row < n;
    cp_async16(st + r * 128 + ((kc ^ (r & 7)) << 4),
               x + (ok ? (size_t)row * e + k0 + kc * 8 : 0), ok);
  }
  unsigned char* ws = st + ST_X_BYTES;
#pragma unroll
  for (int i = 0; i < ST_BN * 8 / ST_THREADS; ++i) {
    const int chunk = tid + i * ST_THREADS, r = chunk >> 3, kc = chunk & 7;
    const int col = slab * ST_BN + r;
    const bool ok = col < v;
    cp_async16(ws + r * 128 + ((kc ^ (r & 7)) << 4),
               w + (ok ? (size_t)col * e + k0 + kc * 8 : 0), ok);
  }
}

// parts: float32 [2][slabs][n]. MODE 0: (slab max, slab sum rescaled to it),
// and zt[row] for a label inside the slab; MODE 1: (sa, cnt) of the slab.
template <int MODE>
__global__ void __launch_bounds__(ST_THREADS, 1)
stats_wgmma_kernel(const bf16* x, const bf16* w, const bf16* bias, const int* labels,
                   const float* lse, float* parts, float* zt, int n, int e, int v,
                   int row_tiles, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles want a 1024-byte boundary
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // the bias of the slab of this block's tile i at bias_s[(i % 2) * ST_BN]
  bf16* bias_s = reinterpret_cast<bf16*>(ring + ST_STAGES * ST_STAGE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, q = lane & 3;
  const int ksteps = e / ST_BK;
  const int slabs = n_tiles / row_tiles;
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = my_tiles * ksteps;

  auto fetch = [&](const StCursor& c, int stage) {
    st_fetch(ring + stage * ST_STAGE, c, x, w, n, e, v, row_tiles);
  };

  float acc[128];   // rows 16 w4 + g + 8 h of the warpgroup's 64, columns 8 j + 2 q + c
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  StCursor ld = {(int)blockIdx.x, 0}, cs = {(int)blockIdx.x, 0};
  for (int s = 0; s < ST_STAGES - 2; ++s) {
    if (s < total) {
      fetch(ld, s);
      ld.advance(ksteps, gridDim.x);
    }
    cp_async_commit();
  }

  int lab[2] = {-1, -1};
  float lse_r[2] = {0.f, 0.f};
  int mine = 0;   // tiles this block has finished
  for (int s = 0; s < total; ++s) {
    cp_async_wait<ST_STAGES - 3>();   // step s has landed
    fence_async_shared();             // and the tensor cores may read it
    __syncthreads();                  // every warpgroup's products of step s - 2 are done
    if (s + ST_STAGES - 2 < total) {  // into the stage of step s - 2
      fetch(ld, (s + ST_STAGES - 2) % ST_STAGES);
      ld.advance(ksteps, gridDim.x);
    }
    cp_async_commit();

    const int slab = cs.tile / row_tiles, rt = cs.tile - slab * row_tiles;
    const int row0 = rt * ST_BM + wg * 64 + w4 * 16 + g;   // and row0 + 8
    const unsigned char* st = ring + (s % ST_STAGES) * ST_STAGE;
    const uint64_t a_desc = wgmma_desc_sw128(st + wg * 64 * 128);
    const uint64_t b_desc = wgmma_desc_sw128(st + ST_X_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ST_BK / 16; ++kk)   // a new tile starts from zero
      wgmma_m64n256k16_ss(acc, a_desc + 2 * kk, b_desc + 2 * kk, (cs.ks > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    if (cs.ks == 0) {
      // while the products run: the slab's bias into shared memory (read
      // after the next barrier; NEG_INF past v, where the weight rows are
      // zeros, so those columns' p is exactly 0 and no mask is needed) and
      // the rows' label or lse
      const int col = slab * ST_BN + tid;
      bias_s[(mine & 1) * ST_BN + tid] = col < v ? bias[col] : __float2bfloat16(NEG_INF);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (MODE == 0) {
          const int l = row < n ? labels[row] : -1;
          lab[h] = (l >= 0 && l < v) ? l - slab * ST_BN - 2 * q : -1;   // 8 j + c in this lane
        } else {
          lse_r[h] = row < n ? lse[row] : 0.f;
        }
      }
    }
    wgmma_wait<1>();   // the products of step s - 1 are done

    if (cs.ks == ksteps - 1) {
      wgmma_wait<0>();
      pin_regs(acc);
      // epilogue of (row tile rt, slab): acc[4 j + 2 h + c] is row row0 + 8 h,
      // column 8 j + 2 q + c of the slab; the four lanes of a quad hold a
      // row's 256. Two neighbouring columns are rounded and get their bias
      // as one bfloat16 pair: the bfloat16 sum of two bfloat16 values rounds
      // as the float32 sum rounded to bfloat16 does (round_add).
      const __nv_bfloat162* bias2 =
          reinterpret_cast<const __nv_bfloat162*>(bias_s + (mine & 1) * ST_BN + 2 * q);
      float red0[2], red1[2];
      if (MODE == 0) {
        red0[0] = red0[1] = -INFINITY;
#pragma unroll
        for (int j = 0; j < ST_BN / 8; ++j) {
          const __nv_bfloat162 b2 = bias2[4 * j];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 z = __bfloat1622float2(
                __hadd2(__floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]), b2));
            acc[4 * j + 2 * h] = z.x;
            acc[4 * j + 2 * h + 1] = z.y;
            red0[h] = fmaxf(red0[h], fmaxf(z.x, z.y));
            if (lab[h] == 8 * j) zt[row0 + 8 * h] = z.x;   // the one lane that holds it
            if (lab[h] == 8 * j + 1) zt[row0 + 8 * h] = z.y;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          red0[h] = fmaxf(red0[h], __shfl_xor_sync(0xffffffffu, red0[h], 1));
          red0[h] = fmaxf(red0[h], __shfl_xor_sync(0xffffffffu, red0[h], 2));
          red1[h] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < ST_BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < 2; ++c) red1[h] += expf(acc[4 * j + 2 * h + c] - red0[h]);
      } else {
        red0[0] = red0[1] = red1[0] = red1[1] = 0.f;
#pragma unroll
        for (int j = 0; j < ST_BN / 8; ++j) {
          const __nv_bfloat162 b2 = bias2[4 * j];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 z = __bfloat1622float2(
                __hadd2(__floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]), b2));
            const float p0 = expf(z.x - lse_r[h]), p1 = expf(z.y - lse_r[h]);
            if (p0 > EPS) {
              red0[h] += p0;
              red1[h] += 1.0f;
            }
            if (p1 > EPS) {
              red0[h] += p1;
              red1[h] += 1.0f;
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        red1[h] += __shfl_xor_sync(0xffffffffu, red1[h], 1);
        red1[h] += __shfl_xor_sync(0xffffffffu, red1[h], 2);
        if (MODE == 1) {
          red0[h] += __shfl_xor_sync(0xffffffffu, red0[h], 1);
          red0[h] += __shfl_xor_sync(0xffffffffu, red0[h], 2);
        }
        const int row = row0 + 8 * h;
        if (q == 0 && row < n) {
          parts[(size_t)slab * n + row] = red0[h];
          parts[((size_t)slabs + slab) * n + row] = red1[h];
        }
      }
      ++mine;
    }
    cs.advance(ksteps, gridDim.x);
  }
  cp_async_wait<0>();
}

// One thread per row folds the slab partials in ascending slab order: MODE 0
// the online rescale into (m, s) and zt = 0 for a label outside [0, v);
// MODE 1 plain sums into (sa, cnt).
template <int MODE>
__global__ void __launch_bounds__(MERGE_THREADS)
stats_merge_kernel(const float* parts, const int* labels, float* o0, float* o1, float* zt, int n,
                   int v, int slabs) {
  const int row = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (row >= n) return;
  constexpr int BATCH = 16;   // loads in flight per thread
  const float* p0 = parts + row;
  const float* p1 = parts + (size_t)slabs * n + row;
  float a0 = MODE == 0 ? -INFINITY : 0.f, a1 = 0.f;
  for (int j0 = 0; j0 < slabs; j0 += BATCH) {
    float b0[BATCH], b1[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const bool ok = j0 + i < slabs;
      b0[i] = ok ? p0[(size_t)(j0 + i) * n] : 0.f;
      b1[i] = ok ? p1[(size_t)(j0 + i) * n] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      if (j0 + i < slabs) {
        if (MODE == 0) {
          const float m_new = fmaxf(a0, b0[i]);
          a1 = a1 * expf(a0 - m_new) + b1[i] * expf(b0[i] - m_new);
          a0 = m_new;
        } else {
          a0 += b0[i];
          a1 += b1[i];
        }
      }
    }
  }
  o0[row] = a0;
  o1[row] = a1;
  if (MODE == 0) {
    const int l = labels[row];
    if (l < 0 || l >= v) zt[row] = 0.f;   // else the lane that held it wrote it
  }
}

// ---- the tensor-core backward (bfloat16) -------------------------------------------
//
// bwd_dz_wgmma_kernel: the statistics kernels' walk (128-row tile x 256-column
// slab, slab-major over persistent blocks, wgmma.m64n256k16 from the same
// ring) with a dz epilogue in registers. Each row's lse, u, cc, lab_term and
// label wait in shared memory, staged with the slab's bias while the tile's
// first products run. Per accumulator pair: the logits rounded with their
// bias as one bfloat16 pair, p = exp(z - lse), dz = p (u + cc [p > 1e-7]),
// the label term subtracted, then dz stored as bfloat16. A row past n gets
// lse = +inf, so its p and dz are exactly 0. The dbg partial of a 32-row
// group (two warps of a warpgroup) is the un-rounded dz summed over the
// thread's two rows, then over the 8 lanes of a column by a butterfly that
// halves the values a lane holds at each of its three steps (56 shuffles for
// 64 columns), then the odd warp's sum added to the even warp's through
// shared memory: one fixed order, no atomics.
//
// bwd_dx_wgmma_kernel: dx = dz . w with the vocab as K, computed transposed,
// dx^T = w^T . dz^T, as gen_wgmma.cuh computes the generator's logits: E is
// the M side (a warp reads 16 columns x 16 vocab rows of the [vocab][E]
// weight tile with ldmatrix.trans into the register operand), dz's rows are
// the N side, read as the 128-byte-swizzled K-major operand as dz lies in
// memory. A unit is (vocab group, row tile of 128, E tile of 256); the vocab
// is split into ``groups`` so that the units fill the SMs (48 E x row tiles
// at N = 1984 against 132 SMs), each group's float32 partial of dx is
// written whole, and bwd_dx_merge_kernel adds them in ascending group order.
// With one group the unit writes dx itself. Units run group-major, then row
// tile, then E tile, so the blocks in flight share a dz slice and a weight
// slice in L2.

constexpr int BW_ROW_BYTES = 5 * ST_BM * 4;        // lse, u, cc, lab_term, label of a tile
constexpr int BW_XCHG_BYTES = 4 * ST_BN * 4;       // the odd warps' dbg sums, one slab
constexpr int BW_SMEM = ST_SMEM + 2 * BW_ROW_BYTES + BW_XCHG_BYTES;
constexpr int DX_THREADS = 256;   // two warpgroups, each 128 E columns of the tile
constexpr int DX_BM = 256;        // E columns of a unit (the M side, transposed)
constexpr int DX_BN = 128;        // rows of dz in a unit (the N of wgmma.m64n128k16)
constexpr int DX_BK = 64;         // vocab rows of a K step
constexpr int DX_STAGES = 4;
constexpr int DX_WLD = DX_BM + 8; // pitch of the weight tile, elements
constexpr int DX_STAGE = DX_BN * 128 + DX_BK * DX_WLD * 2;
constexpr int DX_SMEM = 1024 + DX_STAGES * DX_STAGE;
constexpr int DX_MAX_GROUPS = 16;
constexpr int BWD_MAX_N = 16384;   // rows the partials of the tensor-core route are sized for

__global__ void __launch_bounds__(ST_THREADS, 1)
bwd_dz_wgmma_kernel(const bf16* x, const bf16* w, const bf16* bias, const int* labels,
                    const float* lse, const float* u, const float* cc, const float* lt, bf16* dz,
                    float* dbg, int n, int e, int v, int v_pad, int row_tiles, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* bias_s = reinterpret_cast<bf16*>(ring + ST_STAGES * ST_STAGE);
  float* rows_s = reinterpret_cast<float*>(bias_s + 2 * ST_BN);   // [2][5][ST_BM]
  float* xchg = rows_s + 2 * 5 * ST_BM;                           // [4 groups][8][32 lanes]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, q = lane & 3;
  const int ksteps = e / ST_BK;
  const int groups = (n + 31) / 32;
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = my_tiles * ksteps;

  auto fetch = [&](const StCursor& c, int stage) {
    st_fetch(ring + stage * ST_STAGE, c, x, w, n, e, v, row_tiles);
  };

  float acc[128];   // rows 16 w4 + g + 8 h of the warpgroup's 64, columns 8 j + 2 q + c
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  StCursor ld = {(int)blockIdx.x, 0}, cs = {(int)blockIdx.x, 0};
  for (int s = 0; s < ST_STAGES - 2; ++s) {
    if (s < total) {
      fetch(ld, s);
      ld.advance(ksteps, gridDim.x);
    }
    cp_async_commit();
  }

  int mine = 0;   // tiles this block has finished
  for (int s = 0; s < total; ++s) {
    cp_async_wait<ST_STAGES - 3>();
    fence_async_shared();
    __syncthreads();
    if (s + ST_STAGES - 2 < total) {
      fetch(ld, (s + ST_STAGES - 2) % ST_STAGES);
      ld.advance(ksteps, gridDim.x);
    }
    cp_async_commit();

    const int slab = cs.tile / row_tiles, rt = cs.tile - slab * row_tiles;
    const unsigned char* st = ring + (s % ST_STAGES) * ST_STAGE;
    const uint64_t a_desc = wgmma_desc_sw128(st + wg * 64 * 128);
    const uint64_t b_desc = wgmma_desc_sw128(st + ST_X_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ST_BK / 16; ++kk)
      wgmma_m64n256k16_ss(acc, a_desc + 2 * kk, b_desc + 2 * kk, (cs.ks > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    if (cs.ks == 0) {
      // while the products run: the slab's bias (NEG_INF past v) and the
      // tile's per-row values, read after a later barrier
      const int col = slab * ST_BN + tid;
      bias_s[(mine & 1) * ST_BN + tid] = col < v ? bias[col] : __float2bfloat16(NEG_INF);
      if (tid < ST_BM) {
        float* R = rows_s + (mine & 1) * 5 * ST_BM;
        const int row = rt * ST_BM + tid;
        const bool live = row < n;
        const int l = live ? labels[row] : -1;
        R[tid] = live ? lse[row] : INFINITY;
        R[ST_BM + tid] = live ? u[row] : 0.f;
        R[2 * ST_BM + tid] = live ? cc[row] : 0.f;
        R[3 * ST_BM + tid] = live ? lt[row] : 0.f;
        // the label's column within the slab, or -1
        R[4 * ST_BM + tid] = __int_as_float((l >= 0 && l < v) ? l - slab * ST_BN : -1);
      }
    }
    wgmma_wait<1>();

    if (cs.ks == ksteps - 1) {
      wgmma_wait<0>();
      pin_regs(acc);
      // acc[4 j + 2 h + c] is row lr0 + 8 h, column 8 j + 2 q + c of the slab
      const __nv_bfloat162* bias2 =
          reinterpret_cast<const __nv_bfloat162*>(bias_s + (mine & 1) * ST_BN + 2 * q);
      const float* R = rows_s + (mine & 1) * 5 * ST_BM;
      const int lr0 = wg * 64 + w4 * 16 + g;
      float lse_r[2], u_r[2], cc_r[2], lt_r[2];
      int lab[2];
      bf16* dz_row[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = lr0 + 8 * h, row = rt * ST_BM + lr;
        lse_r[h] = R[lr];
        u_r[h] = R[ST_BM + lr];
        cc_r[h] = R[2 * ST_BM + lr];
        lt_r[h] = R[3 * ST_BM + lr];
        lab[h] = __float_as_int(R[4 * ST_BM + lr]) - 2 * q;   // 8 j + c in this lane
        dz_row[h] = row < n ? dz + (size_t)row * v_pad + slab * ST_BN + 2 * q : nullptr;
      }
#pragma unroll
      for (int j = 0; j < ST_BN / 8; ++j) {
        const __nv_bfloat162 b2 = bias2[4 * j];
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 z = __bfloat1622float2(
              __hadd2(__floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]), b2));
          const float p0 = expf(z.x - lse_r[h]), p1 = expf(z.y - lse_r[h]);
          float d0 = p0 * (u_r[h] + cc_r[h] * (p0 > EPS ? 1.0f : 0.0f));
          float d1 = p1 * (u_r[h] + cc_r[h] * (p1 > EPS ? 1.0f : 0.0f));
          if (lab[h] == 8 * j) d0 -= lt_r[h];   // before the rounding
          if (lab[h] == 8 * j + 1) d1 -= lt_r[h];
          if (dz_row[h])
            *reinterpret_cast<__nv_bfloat162*>(dz_row[h] + 8 * j) = __floats2bfloat162_rn(d0, d1);
          sum0 += d0;
          sum1 += d1;
        }
        acc[4 * j] = sum0;   // the thread's two rows, column 8 j + 2 q (+1)
        acc[4 * j + 1] = sum1;
      }
      // over the 8 lanes of a column: value i (column 8 (i / 2) + 2 q + i % 2)
      // sits at acc[4 (i / 2) + i % 2]; each step keeps half of a lane's values
      // and adds its partner's copy of them
#define BW_V(i) acc[4 * ((i) >> 1) + ((i) & 1)]
#pragma unroll
      for (int step = 0; step < 3; ++step) {
        const int half = 32 >> step, bit = (lane >> (4 - step)) & 1;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (i < half) {
            const float lo = BW_V(i), hi = BW_V(i + half);
            const float send = bit ? lo : hi;
            BW_V(i) = (bit ? hi : lo) + __shfl_xor_sync(0xffffffffu, send, 16 >> step);
          }
        }
      }
      // lane (g, q) now holds columns 32 g + 8 m + 2 q + c at BW_V(2 m + c)
      // over its warp's 16 rows; the odd warp of a 32-row group hands its sums
      // to the even one
      const int gi = wg * 2 + (w4 >> 1);
      float* xg = xchg + gi * 8 * 32;
      if (w4 & 1) {
#pragma unroll
        for (int k = 0; k < 8; ++k) xg[k * 32 + lane] = BW_V(k);
      }
      __syncthreads();
      const int group = rt * 4 + gi;
      if (!(w4 & 1) && group < groups) {
        float* out = dbg + (size_t)group * v_pad + slab * ST_BN + 32 * g + 2 * q;
#pragma unroll
        for (int m = 0; m < 4; ++m)
          *reinterpret_cast<float2*>(out + 8 * m) =
              make_float2(BW_V(2 * m) + xg[(2 * m) * 32 + lane],
                          BW_V(2 * m + 1) + xg[(2 * m + 1) * 32 + lane]);
      }
#undef BW_V
      ++mine;
    }
    cs.advance(ksteps, gridDim.x);
  }
  cp_async_wait<0>();
}

// One unit per block: (vocab group, row tile, E tile) -> out [n, e] float32,
// the group's partial of dx (dx itself with one group). K steps [ks0, ks1) of
// the vocab, ks in units of DX_BK rows.
__global__ void __launch_bounds__(DX_THREADS, 1)
bwd_dx_wgmma_kernel(const bf16* dz, const bf16* w, float* parts, int n, int e, int v, int v_pad,
                    int row_tiles, int e_tiles, int groups) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wgid = warp >> 2, w4 = warp & 3, g = lane >> 2, q = lane & 3;
  const int unit = blockIdx.x;
  const int et = unit % e_tiles, rest = unit / e_tiles;
  const int rt = rest % row_tiles, grp = rest / row_tiles;
  const int kt = v_pad / DX_BK;
  const int ks0 = grp * kt / groups, ks1 = (grp + 1) * kt / groups;
  const int total = ks1 - ks0;
  const int row0 = rt * DX_BN, col0 = et * DX_BM;

  // dz rows [row0, +128) x vocab [k0, +64), swizzled; weight rows [k0, +64) x
  // E columns [col0, +256) at pitch DX_WLD
  auto fetch = [&](int ks, int stage) {
    unsigned char* st = ring + stage * DX_STAGE;
    const int k0 = ks * DX_BK;
#pragma unroll
    for (int i = 0; i < DX_BN * 8 / DX_THREADS; ++i) {
      const int chunk = tid + i * DX_THREADS, r = chunk >> 3, kc = chunk & 7;
      const int row = row0 + r;
      const bool ok = row < n;
      cp_async16(st + r * 128 + ((kc ^ (r & 7)) << 4),
                 dz + (ok ? (size_t)row * v_pad + k0 + kc * 8 : 0), ok);
    }
    bf16* ws = reinterpret_cast<bf16*>(st + DX_BN * 128);
#pragma unroll
    for (int i = 0; i < DX_BK * (DX_BM / 8) / DX_THREADS; ++i) {
      const int chunk = tid + i * DX_THREADS, kr = chunk / (DX_BM / 8), nc = chunk % (DX_BM / 8);
      const int k = k0 + kr, col = col0 + nc * 8;
      const bool ok = k < v && col < e;
      cp_async16(ws + kr * DX_WLD + nc * 8, w + (ok ? (size_t)k * e + col : 0), ok);
    }
  };

  float acc[2][64];   // two m64 tiles of E columns x 128 rows
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[mi][j] = 0.f;

  for (int s = 0; s < DX_STAGES - 1; ++s) {
    if (s < total) fetch(ks0 + s, s);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<DX_STAGES - 2>();   // step s has landed
    fence_async_shared();
    __syncthreads();                  // every warp's products of step s - 1 are done
    if (s + DX_STAGES - 1 < total) fetch(ks0 + s + DX_STAGES - 1, (s + DX_STAGES - 1) % DX_STAGES);
    cp_async_commit();

    const unsigned char* st = ring + (s % DX_STAGES) * DX_STAGE;
    const bf16* ws = reinterpret_cast<const bf16*>(st + DX_BN * 128);
    uint32_t afr[2][DX_BK / 16][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int kk = 0; kk < DX_BK / 16; ++kk)
        ldmatrix_x4_trans(afr[mi][kk],
                          ws + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * DX_WLD + wgid * 128 +
                              mi * 64 + w4 * 16 + ((lane >> 3) & 1) * 8);
    const uint64_t b_desc = wgmma_desc_sw128(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DX_BK / 16; ++kk)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        wgmma_m64n128k16_rs(acc[mi], afr[mi][kk], b_desc + 2 * kk, (s > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();
  // acc[mi][4 j + r]: E column col0 + wgid * 128 + mi * 64 + w4 * 16 + g + 8 (r / 2),
  // row row0 + 8 j + 2 q + r % 2
  float* out = parts + (groups > 1 ? (size_t)grp * n * e : 0);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = col0 + wgid * 128 + mi * 64 + w4 * 16 + g + 8 * (r >> 1);
        const int row = row0 + 8 * j + 2 * q + (r & 1);
        if (row < n && col < e) out[(size_t)row * e + col] = acc[mi][4 * j + r];
      }
}

// dx = the groups' partials added in ascending group order, four at a time
__global__ void __launch_bounds__(MERGE_THREADS)
bwd_dx_merge_kernel(const float* parts, float* dx, int count4, int groups, size_t stride4) {
  const int i = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (i >= count4) return;
  const float4* p = reinterpret_cast<const float4*>(parts) + i;
  float4 a = p[0];
  for (int gi = 1; gi < groups; ++gi) {
    const float4 b = p[gi * stride4];
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
  reinterpret_cast<float4*>(dx)[i] = a;
}

// ---- launch plans ----------------------------------------------------------------
// {route, rows of a row tile, vocab columns of a tile, K step, ring stages,
// dynamic shared memory, row tiles, vocab slabs, blocks}. Route 1 is the
// tensor-core kernel (bfloat16 only), route 0 stats_kernel (one block per
// row tile walks the whole vocab: 1 slab of TILE_V columns at a time).
// Route -1, what the package's wrappers pass, takes route 1 for bfloat16 and
// route 0 for float32. Every width the wrappers admit (multiples of 128 up to
// 1664 in float32, 2048 in bfloat16) fits route 1, which streams x as it
// streams the weight, so no shape of bfloat16 goes to route 0 by the rule.

struct StatsPlan {
  int route, bm, bn, bk, stages, smem, row_tiles, slabs, grid;
};

bool stats_plan(int dtype, int n, int e, int v, int route, int sms, StatsPlan* out) {
  if (n < 1 || e < 128 || e % 128 || v < 1 || sms < 1 || route < -1 || route > 1 ||
      (route == 1 && dtype != 1))
    return false;
  StatsPlan p;
  p.route = route < 0 ? (dtype == 1 ? 1 : 0) : route;
  if (p.route == 1) {
    p.bm = ST_BM; p.bn = ST_BN; p.bk = ST_BK; p.stages = ST_STAGES; p.smem = ST_SMEM;
    p.row_tiles = (n + ST_BM - 1) / ST_BM;
    p.slabs = (v + ST_BN - 1) / ST_BN;
    const int tiles = p.row_tiles * p.slabs;
    p.grid = tiles < sms ? tiles : sms;
  } else {
    const bool b16 = dtype == 1;
    p.bm = b16 ? Cfg<bf16>::BM : Cfg<float>::BM;
    p.bn = TILE_V;
    p.bk = b16 ? Cfg<bf16>::KC : Cfg<float>::KC;
    p.stages = 2;
    p.smem = (int)(b16 ? smem_bytes<bf16>(e, false) : smem_bytes<float>(e, false));
    p.row_tiles = (n + p.bm - 1) / p.bm;
    p.slabs = 1;
    p.grid = p.row_tiles;
  }
  *out = p;
  return p.smem <= SMEM_LIMIT;
}

// the SM count of the current device, and the tensor-core kernels' shared-
// memory attributes set once per device
int sm_count() {
  static int count[64] = {};
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && count[dev]) return count[dev];
  if (cudaFuncSetAttribute(stats_wgmma_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           ST_SMEM) != cudaSuccess ||
      cudaFuncSetAttribute(stats_wgmma_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           ST_SMEM) != cudaSuccess ||
      cudaFuncSetAttribute(bwd_dz_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           BW_SMEM) != cudaSuccess ||
      cudaFuncSetAttribute(bwd_dx_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DX_SMEM) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  if (dev < 64) count[dev] = sms;
  return sms;
}

template <int MODE>
int launch_stats_wgmma(const StatsPlan& pl, const Params& p, float* parts, cudaStream_t st) {
  if (!parts) return (int)cudaErrorInvalidValue;
  stats_wgmma_kernel<MODE><<<pl.grid, ST_THREADS, pl.smem, st>>>(
      (const bf16*)p.x, (const bf16*)p.w, (const bf16*)p.b, p.labels, p.lse, parts, p.o2, p.n,
      p.e, p.v, pl.row_tiles, pl.row_tiles * pl.slabs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_merge_kernel<MODE><<<(p.n + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS, 0, st>>>(
      parts, p.labels, p.o0, p.o1, p.o2, p.n, p.v, pl.slabs);
  return (int)cudaGetLastError();
}

template <typename T> int launch(int mode, const Params& p, cudaStream_t st) {
  const bool bwd = mode == 2;
  const size_t smem = smem_bytes<T>(p.e, bwd);
  // x's row tile shares the block's memory with the rings: widths to 1664 fit
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int grid = (p.n + Cfg<T>::BM - 1) / Cfg<T>::BM;
  cudaError_t err;
  if (mode == 0) {
    auto k = stats_kernel<T, 0>;
    if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return (int)err;
    k<<<grid, THREADS, smem, st>>>(p);
  } else if (mode == 1) {
    auto k = stats_kernel<T, 1>;
    if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return (int)err;
    k<<<grid, THREADS, smem, st>>>(p);
  } else {
    auto k = backward_kernel<T>;
    if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return (int)err;
    k<<<grid, THREADS, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

int dispatch(int dtype, int mode, const Params& p, void* stream) {
  if (p.n <= 0 || p.e <= 0 || p.e % 128 || p.v <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 1 ? launch<bf16>(mode, p, st) : launch<float>(mode, p, st);
}

// the two statistics kernels: route 1 by the plan, else stats_kernel
int dispatch_stats(int dtype, int mode, const Params& p, float* parts, int route,
                   void* stream) {
  const int sms = sm_count();
  StatsPlan pl;
  if (!sms || !stats_plan(dtype, p.n, p.e, p.v, route, sms, &pl))
    return (int)cudaErrorInvalidValue;
  if (pl.route == 0) return dispatch(dtype, mode, p, stream);
  cudaStream_t st = (cudaStream_t)stream;
  return mode == 0 ? launch_stats_wgmma<0>(pl, p, parts, st)
                   : launch_stats_wgmma<1>(pl, p, parts, st);
}

// ---- the backward's launch plan ----------------------------------------------------
// {route, rows of a dz tile, vocab columns of a slab, K step, ring stages, dz
// kernel's shared memory, row tiles, slabs, dz kernel's blocks, E tiles of dx,
// vocab groups of dx, dx units, dx kernel's shared memory}. Route 1 (bfloat16)
// is the tensor-core pair above while 1 <= n <= BWD_MAX_N; route 0 is
// backward_kernel<T> (one block per row tile of 32 (bfloat16) or 16 rows walks
// the vocab; ``e_tiles`` counts its dx column slabs of SLAB_E; groups 1, no
// dx units). Route -1, what the package's wrappers pass, takes route 1 where
// it may and route 0 elsewhere.
//
// The vocab groups of dx: the first count in [1, min(16, K steps / 8)] whose
// units fill at least 90% of the last wave over the SMs, else the count that
// fills the most (the smallest on a tie). N = 1984: 48 tiles x 5 groups = 240
// units over 132 SMs; N = 4096: 96 x 4 = 384.

struct BwdPlan {
  int route, bm, bn, bk, stages, smem, row_tiles, slabs, grid, e_tiles, groups, dx_units,
      dx_smem;
};

int dx_groups(int tiles, int ksteps, int sms) {
  int cap = ksteps / 8;
  cap = cap < 1 ? 1 : (cap > DX_MAX_GROUPS ? DX_MAX_GROUPS : cap);
  int best = 1;
  long best_fill = -1;   // units / (waves * sms), in millionths
  for (int gr = 1; gr <= cap; ++gr) {
    const long units = (long)tiles * gr;
    const long waves = (units + sms - 1) / sms;
    const long fill = units * 1000000 / (waves * sms);
    if (fill >= 900000) return gr;
    if (fill > best_fill) {
      best_fill = fill;
      best = gr;
    }
  }
  return best;
}

bool bwd_plan(int dtype, int n, int e, int v, int route, int sms, BwdPlan* out) {
  if (n < 1 || e < 128 || e % 128 || v < 1 || sms < 1 || route < -1 || route > 1 ||
      (route == 1 && (dtype != 1 || n > BWD_MAX_N)))
    return false;
  BwdPlan p = {};
  p.route = route >= 0 ? route : (dtype == 1 && n <= BWD_MAX_N ? 1 : 0);
  const int v_pad = (v + TILE_V - 1) / TILE_V * TILE_V;
  if (p.route == 1) {
    p.bm = ST_BM; p.bn = ST_BN; p.bk = ST_BK; p.stages = ST_STAGES; p.smem = BW_SMEM;
    p.row_tiles = (n + ST_BM - 1) / ST_BM;
    p.slabs = v_pad / ST_BN;
    const int tiles = p.row_tiles * p.slabs;
    p.grid = tiles < sms ? tiles : sms;
    p.e_tiles = (e + DX_BM - 1) / DX_BM;
    const int dx_row_tiles = (n + DX_BN - 1) / DX_BN;
    p.groups = dx_groups(dx_row_tiles * p.e_tiles, v_pad / DX_BK, sms);
    p.dx_units = dx_row_tiles * p.e_tiles * p.groups;
    p.dx_smem = DX_SMEM;
  } else {
    const bool b16 = dtype == 1;
    p.bm = b16 ? Cfg<bf16>::BM : Cfg<float>::BM;
    p.bn = TILE_V;
    p.bk = b16 ? Cfg<bf16>::KC : Cfg<float>::KC;
    p.stages = 2;
    p.smem = (int)(b16 ? smem_bytes<bf16>(e, true) : smem_bytes<float>(e, true));
    p.row_tiles = (n + p.bm - 1) / p.bm;
    p.slabs = 1;
    p.grid = p.row_tiles;
    p.e_tiles = (e + SLAB_E - 1) / SLAB_E;
    p.groups = 1;
  }
  *out = p;
  return p.smem <= SMEM_LIMIT && p.dx_smem <= SMEM_LIMIT;
}

// route 1: dz and the dbg partials, then dx (through ``parts``, room for
// ``parts_groups`` partials, when the vocab is split into groups), all on
// stream ``st``
int launch_bwd_wgmma(const BwdPlan& pl, const Params& p, float* parts, int parts_groups,
                     cudaStream_t st) {
  if (pl.groups > 1 && (!parts || parts_groups < pl.groups)) return (int)cudaErrorInvalidValue;
  bwd_dz_wgmma_kernel<<<pl.grid, ST_THREADS, pl.smem, st>>>(
      (const bf16*)p.x, (const bf16*)p.w, (const bf16*)p.b, p.labels, p.lse, p.u, p.cc, p.lt,
      (bf16*)p.dz, p.o1, p.n, p.e, p.v, p.v_pad, pl.row_tiles, pl.row_tiles * pl.slabs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* out = pl.groups > 1 ? parts : p.o0;
  bwd_dx_wgmma_kernel<<<pl.dx_units, DX_THREADS, pl.dx_smem, st>>>(
      (const bf16*)p.dz, (const bf16*)p.w, out, p.n, p.e, p.v, p.v_pad,
      (p.n + DX_BN - 1) / DX_BN, pl.e_tiles, pl.groups);
  if ((err = cudaGetLastError()) != cudaSuccess || pl.groups == 1) return (int)err;
  const int count4 = p.n * p.e / 4;
  bwd_dx_merge_kernel<<<(count4 + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS, 0, st>>>(
      parts, p.o0, count4, pl.groups, (size_t)count4);
  return (int)cudaGetLastError();
}

Params base_params(const void* x, const void* w, const void* b, int n, int e, int v) {
  Params p = {};
  p.x = x; p.w = w; p.b = b;
  p.n = n; p.e = e; p.v = v; p.v_pad = (v + TILE_V - 1) / TILE_V * TILE_V;
  return p;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x [n, e], w [v, e], b [v] in that dtype
// (v any count of rows; a generator padded with zero rows and a -1e30 bias
// gives the same statistics); labels int32 [n]; every other vector float32
// [n]. route: -1 = by the plan's rule (bfloat16 -> the tensor-core kernel,
// float32 -> stats_kernel), which is what the package's wrappers always
// pass; 0 = stats_kernel in either dtype, for checks that time the kernel
// the tensor-core one replaced; 1 = the tensor-core kernel (bfloat16 only).

// rows per block of the backward, which is also the row count one dbg
// partial covers
int vct_sce_block_rows(int dtype) { return dtype == 1 ? Cfg<bf16>::BM : Cfg<float>::BM; }

// out: 9 ints, see StatsPlan; sms: the device's SM count (the grid's cap)
int vct_sce_stats_plan(int dtype, int n, int e, int v, int route, int sms, int* out) {
  StatsPlan p;
  if (!stats_plan(dtype, n, e, v, route, sms, &p)) return (int)cudaErrorInvalidValue;
  const int vals[9] = {p.route, p.bm, p.bn, p.bk, p.stages, p.smem, p.row_tiles, p.slabs,
                       p.grid};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

// parts: float32 scratch [2, ceil(v / 256), n] for the tensor-core kernel
// (NULL on route 0)
int vct_sce_softmax_stats(int dtype, const void* x, const void* w, const void* b,
                          const void* labels, void* m, void* s, void* zt, void* parts, int n,
                          int e, int v, int route, void* stream) {
  Params p = base_params(x, w, b, n, e, v);
  p.labels = (const int*)labels;
  p.o0 = (float*)m; p.o1 = (float*)s; p.o2 = (float*)zt;
  return dispatch_stats(dtype, 0, p, (float*)parts, route, stream);
}

int vct_sce_clipped_stats(int dtype, const void* x, const void* w, const void* b,
                          const void* lse, void* sa, void* cnt, void* parts, int n, int e, int v,
                          int route, void* stream) {
  Params p = base_params(x, w, b, n, e, v);
  p.lse = (const float*)lse;
  p.o0 = (float*)sa; p.o1 = (float*)cnt;
  return dispatch_stats(dtype, 1, p, (float*)parts, route, stream);
}

// out: 13 ints, see BwdPlan; sms: the device's SM count
int vct_sce_backward_plan(int dtype, int n, int e, int v, int route, int sms, int* out) {
  BwdPlan p;
  if (!bwd_plan(dtype, n, e, v, route, sms, &p)) return (int)cudaErrorInvalidValue;
  const int vals[13] = {p.route, p.bm, p.bn, p.bk, p.stages, p.smem, p.row_tiles, p.slabs,
                        p.grid, p.e_tiles, p.groups, p.dx_units, p.dx_smem};
  for (int i = 0; i < 13; ++i) out[i] = vals[i];
  return 0;
}

// dx float32 [n, e]; dz [n, v_pad] in the compute dtype; dbg_parts float32
// [ceil(n / block_rows), v_pad]; v_pad = round_up(v, 512). parts: float32
// scratch [parts_groups, n, e] for the tensor-core route's dx partials (NULL
// with one group or on route 0); the call fails if the plan needs more
// groups. route: -1 by the plan's rule (what the package's wrappers pass), 0
// backward_kernel, 1 the tensor-core pair.
int vct_sce_backward(int dtype, const void* x, const void* w, const void* b, const void* lse,
                     const void* u, const void* cc, const void* lt, const void* labels,
                     void* dx, void* dz, void* dbg_parts, void* parts, int n, int e, int v,
                     int parts_groups, int route, void* stream) {
  Params p = base_params(x, w, b, n, e, v);
  p.lse = (const float*)lse; p.u = (const float*)u;
  p.cc = (const float*)cc; p.lt = (const float*)lt; p.labels = (const int*)labels;
  p.o0 = (float*)dx; p.o1 = (float*)dbg_parts; p.dz = dz;
  const int sms = sm_count();
  BwdPlan pl;
  if (!sms || !bwd_plan(dtype, n, e, v, route, sms, &pl)) return (int)cudaErrorInvalidValue;
  if (pl.route == 0) return dispatch(dtype, 2, p, stream);
  return launch_bwd_wgmma(pl, p, (float*)parts, parts_groups, (cudaStream_t)stream);
}

}  // extern "C"
