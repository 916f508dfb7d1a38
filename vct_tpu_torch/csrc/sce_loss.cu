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
// Design: one block owns a tile of BM rows and walks the vocab in ascending
// tiles of 512 columns, which takes the place of the TPU grid's sequential
// vocab axis. x's row tile stays in shared memory for the whole walk; the
// weight tile streams through a two-stage cp.async ring; the per-row
// accumulators (m, s, zt / sa, cnt) live in registers of the warp that owns
// the row, and dx lives in tensor-core accumulator fragments across the walk.
// A model wider than 768 gets its dx in column slabs of 768, each with a vocab
// walk of its own that recomputes the logits; dz and the dbg partials are
// written by the first walk only.
// The product is the kernel's own: nvcuda::wmma 16x16x16 bf16 tiles with fp32
// accumulation, or a shared-memory FMA tile for float32. The TPU kernel's
// two-slab MXU/VPU pipeline, the weight passed twice, the 8-sublane dbg rows
// and [N, 1] column vectors are gone. wgmma, TMA and a row tile per SM that
// fills all 132 SMs are later work.
//
// Layout: x [N, E] row-major; the generator weight in PyTorch's own [V_pad, E]
// layout (row v holds column v of the product's right-hand side), so the
// 47 MB parameter is never transposed: the logits product reads it as a
// col-major B operand, the dx product as a row-major one. V_pad is a
// multiple of 512; pad rows are zero and carry a -1e30 bias. Rows past N are
// masked inside the kernels (no padded copy of x).
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

#include <type_traits>

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
constexpr int SMEM_LIMIT = 232448;

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
  int n, e, v_pad;
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
      cp_async16(dst, x + (size_t)(row0 + row) * e + seg * PER);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
}

// w[v0 .. v0+512, k0 .. k0+KC) -> dst[512][wld]
template <typename T>
__device__ __forceinline__ void load_w_chunk(T* dst, const T* w, int e, int v0, int k0) {
  constexpr int PER = 16 / sizeof(T), SEGS = Cfg<T>::KC / PER;
  for (int idx = threadIdx.x; idx < TILE_V * SEGS; idx += THREADS) {
    const int row = idx / SEGS, seg = idx - row * SEGS;
    cp_async16(dst + row * wld<T>() + seg * PER, w + (size_t)(v0 + row) * e + k0 + seg * PER);
  }
  cp_commit();
}

// w[r0 .. r0+KC2, e0 .. e0+es) -> dst[KC2][sld]
template <typename T>
__device__ __forceinline__ void load_w_rows(T* dst, const T* w, int e, int r0, int e0, int es) {
  constexpr int PER = 16 / sizeof(T);
  const int segs = es / PER;
  for (int idx = threadIdx.x; idx < Cfg<T>::KC2 * segs; idx += THREADS) {
    const int row = idx / segs, seg = idx - row * segs;
    cp_async16(dst + row * sld<T>(e) + seg * PER, w + (size_t)(r0 + row) * e + e0 + seg * PER);
  }
  cp_commit();
}

// ---- the logits tile: zs[BM][512] = round(xs . w_tile^T) + bias, in T --------

__device__ void logits_tile(const bf16* xs, bf16* ring, int stage, bf16* zs, float* patch,
                            const bf16* w, const bf16* bias, int e, int v0) {
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
  load_w_chunk<bf16>(ring, w, e, v0, 0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      load_w_chunk<bf16>(ring + ((ch + 1) & 1) * stage, w, e, v0, (ch + 1) * C::KC);
      cp_wait<1>();
    } else {
      cp_wait<0>();
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
        zs[(i * 16 + rr) * ZLD + col] = round_add(pw[idx], bias[v0 + col]);
      }
      __syncwarp();
    }
  __syncthreads();
}

__device__ void logits_tile(const float* xs, float* ring, int stage, float* zs, float* /*patch*/,
                            const float* w, const float* bias, int e, int v0) {
  using C = Cfg<float>;
  const int t = threadIdx.x;
  const int XLD = xld<float>(e);
  constexpr int WLD = wld<float>(), ZLD = zld<float>();
  float acc[C::BM][2];
#pragma unroll
  for (int r = 0; r < C::BM; ++r) acc[r][0] = acc[r][1] = 0.0f;

  const int nch = e / C::KC;
  load_w_chunk<float>(ring, w, e, v0, 0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      load_w_chunk<float>(ring + ((ch + 1) & 1) * stage, w, e, v0, (ch + 1) * C::KC);
      cp_wait<1>();
    } else {
      cp_wait<0>();
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
    zs[r * ZLD + t] = round_add(acc[r][0], bias[v0 + t]);
    zs[r * ZLD + t + 256] = round_add(acc[r][1], bias[v0 + t + 256]);
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

  __device__ void add_tile(const bf16* zs, bf16* ring, int stage, const bf16* w, int e, int v0,
                           int e0, int es) {
    using C = Cfg<bf16>;
    const int warp = threadIdx.x >> 5;
    const int SLD = sld<bf16>(e), nf = es / 128, col0 = warp * (es / 8);
    constexpr int ZLD = zld<bf16>();
    constexpr int nch = TILE_V / C::KC2;
    load_w_rows<bf16>(ring, w, e, v0, e0, es);
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + 1 < nch) {
        load_w_rows<bf16>(ring + ((ch + 1) & 1) * stage, w, e, v0 + (ch + 1) * C::KC2, e0,
                            es);
        cp_wait<1>();
      } else {
        cp_wait<0>();
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
                           int v0, int e0, int es) {
    using C = Cfg<float>;
    const int t = threadIdx.x;
    const int SLD = sld<float>(e);
    constexpr int ZLD = zld<float>();
    constexpr int nch = TILE_V / C::KC2;
    load_w_rows<float>(ring, w, e, v0, e0, es);
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + 1 < nch) {
        load_w_rows<float>(ring + ((ch + 1) & 1) * stage, w, e, v0 + (ch + 1) * C::KC2, e0,
                             es);
        cp_wait<1>();
      } else {
        cp_wait<0>();
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
    lab[q] = (MODE == 0 && row < p.n) ? p.labels[row] : -1;
    lse[q] = (MODE == 1 && row < p.n) ? p.lse[row] : 0.0f;
  }

  for (int v0 = 0; v0 < p.v_pad; v0 += TILE_V) {
    logits_tile(sm.xs, sm.ring, sm.stage, sm.zs, sm.patch, w, bias, p.e, v0);
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
    lab_s[t] = live ? p.labels[row0 + t] : -1;
  }
  load_x_tile<T>(sm.xs, static_cast<const T*>(p.x), p.n, p.e, row0);

  DxAcc<T> dx;
  // one vocab walk per slab of dx columns; the first also writes dz and dbg
  for (int e0 = 0; e0 < p.e; e0 += SLAB_E) {
    const int es = min(SLAB_E, p.e - e0);
    const bool first = e0 == 0;
    dx.zero();
    for (int v0 = 0; v0 < p.v_pad; v0 += TILE_V) {
      logits_tile(sm.xs, sm.ring, sm.stage, sm.zs, sm.patch, w, bias, p.e, v0);
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
      dx.add_tile(sm.zs, sm.ring, sm.stage, w, p.e, v0, e0, es);
    }
    dx.store(p.o0, sm.patch, p.n, p.e, row0, e0, es);
  }
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
  if (p.n <= 0 || p.e <= 0 || p.e % 128 || p.v_pad <= 0 || p.v_pad % TILE_V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 1 ? launch<bf16>(mode, p, st) : launch<float>(mode, p, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x [n, e], w [v_pad, e], b [v_pad] in that
// dtype; labels int32 [n]; every other vector float32 [n].

// rows per block, which is also the row count one dbg partial covers
int vct_sce_block_rows(int dtype) { return dtype == 1 ? Cfg<bf16>::BM : Cfg<float>::BM; }

int vct_sce_softmax_stats(int dtype, const void* x, const void* w, const void* b,
                          const void* labels, void* m, void* s, void* zt, int n, int e,
                          int v_pad, void* stream) {
  Params p = {};
  p.x = x; p.w = w; p.b = b; p.labels = (const int*)labels;
  p.o0 = (float*)m; p.o1 = (float*)s; p.o2 = (float*)zt;
  p.n = n; p.e = e; p.v_pad = v_pad;
  return dispatch(dtype, 0, p, stream);
}

int vct_sce_clipped_stats(int dtype, const void* x, const void* w, const void* b,
                          const void* lse, void* sa, void* cnt, int n, int e, int v_pad,
                          void* stream) {
  Params p = {};
  p.x = x; p.w = w; p.b = b; p.lse = (const float*)lse;
  p.o0 = (float*)sa; p.o1 = (float*)cnt;
  p.n = n; p.e = e; p.v_pad = v_pad;
  return dispatch(dtype, 1, p, stream);
}

// dx float32 [n, e]; dz [n, v_pad] in the compute dtype; dbg_parts float32
// [ceil(n / block_rows), v_pad]
int vct_sce_backward(int dtype, const void* x, const void* w, const void* b, const void* lse,
                     const void* u, const void* cc, const void* lt, const void* labels,
                     void* dx, void* dz, void* dbg_parts, int n, int e, int v_pad,
                     void* stream) {
  Params p = {};
  p.x = x; p.w = w; p.b = b; p.lse = (const float*)lse; p.u = (const float*)u;
  p.cc = (const float*)cc; p.lt = (const float*)lt; p.labels = (const int*)labels;
  p.o0 = (float*)dx; p.o1 = (float*)dbg_parts; p.dz = dz;
  p.n = n; p.e = e; p.v_pad = v_pad;
  return dispatch(dtype, 2, p, stream);
}

}  // extern "C"
