// Fused multi-head attention for Hopper (sm_90a): forward, and a recompute
// backward, bound through a plain C interface (ctypes). Python side:
// vct_tpu_torch/ops/attention_kernels.py.
//
// Replaces (vct_tpu/ops/pallas_attention.py):
//   * fused_attention            (:81,  _attn_kernel :71, _attn_kernel_nobias :76)
//   * fused_attention_trainable  (:271, forward _fwd_train_kernel :191 and
//     _fwd_train_dropout_kernel :195, backward _bwd_train_kernel :206 and
//     _bwd_train_dropout_kernel :212)
//
// What bounds them on an H100: one (batch, head) cell does 4*Tq*Tk*D operations
// forward (Q.K^T and P.V) and 10*Tq*Tk*D backward, and must move q, k, v, o,
// the bias and the 1-byte keep mask once. At the long-video shapes (B=32, H=8,
// D=96, T=128..256, bf16) the bytes (tens of MB, ~0.01-0.03 ms at 3.35 TB/s)
// outweigh the operations (a few GFLOP, under 0.01 ms at 989 TFLOP/s): the
// kernels are bound by bytes, and the point of fusing is that the
// [B, H, Tq, Tk] float32 logits never reach device memory.
//
// Design (not the TPU kernel's: no whole cell in fast memory, no padding to a
// sublane quantum, no transpose to [B, H, T, D], no materialised bias):
//   * grid (tile of the sequence, head, batch); a loop over the other
//     sequence's tiles inside the block takes the place of the resident cell;
//   * q/k/v/dO are read in place from [B, T, H, D] by their strides (so the
//     slices of a packed QKV projection need no copy); ragged edges are
//     masked in the kernel; the bias comes with its broadcast strides (0 on
//     singleton dims), so a [B,1,1,Tk] padding bias is one row per batch;
//   * forward in two passes over the key tiles: pass 1 the row max m and the
//     row sum l (online rescale), pass 2 recomputes the logits, forms
//     exp(s - m) / l, applies the keep mask, rounds the weights to v's dtype
//     and accumulates P.V in float32: the reference's rounding points;
//   * backward without atomics, so the same bits from run to run: one kernel
//     per query tile (delta = rowsum(P * dP), then dQ), one per key tile
//     looping over the query tiles (dK, dV). P is recomputed from (m, l),
//     which the forward saves ([B, H, Tq, 2] float32), never stored;
//   * products: nvcuda::wmma 16x16x16 bf16 tiles with float32 accumulation
//     (tile 64), or shared-memory FMA loops for float32 (tile 32). In the
//     bf16 backward P, dropped P and dS are rounded to bf16 to feed the
//     tensor cores (the reference keeps them float32); in float32 nothing is
//     rounded. Accumulators live in shared memory between tiles. wgmma, TMA,
//     a software pipeline and a single-pass backward are later work.
//
// Masks are large finite negatives (-1e30): a fully masked row gives a
// uniform distribution over the Tk real keys.

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
constexpr int MAX_D = 128;
constexpr int SMEM_LIMIT = 232448;

template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int TILE = 64, PAD = 8;
};
template <> struct Cfg<float> {
  static constexpr int TILE = 32, PAD = 4;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;             // dO (backward)
  const float* bias;         // or null
  const unsigned char* keep; // [B, H, Tq, Tk] bytes, or null
  void* out;                 // forward: o [B, Tq, H, D]
  void* dq;                  // [B, Tq, H, D]
  void* dk;                  // [B, Tk, H, D]
  void* dv;
  float* stats;              // [B, H, Tq, 2]: row max, row sum (or null)
  float* delta;              // [B, H, Tq]
  int b, h, tq, tk, d;
  int q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, g_sb, g_st, g_sh;
  int bias_sb, bias_sh, bias_sq, bias_sk;
  float scale, keep_denom;
};

// ---- small helpers ------------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__host__ __device__ constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

// byte sizes of the four kinds of shared-memory tile
template <typename T> struct Lay {
  int d;
  __host__ __device__ int dld() const { return d + Cfg<T>::PAD; }  // data tile [TILE][d]
  __host__ __device__ int ald() const { return d + 4; }             // accumulator [TILE][d]
  static constexpr int SLD = Cfg<T>::TILE + 4;                      // float [TILE][TILE]
  static constexpr int PLD = Cfg<T>::TILE + Cfg<T>::PAD;            // T [TILE][TILE]
  __host__ __device__ size_t data_bytes() const {
    return round128((size_t)Cfg<T>::TILE * dld() * sizeof(T));
  }
  __host__ __device__ size_t acc_bytes() const {
    return round128((size_t)Cfg<T>::TILE * ald() * sizeof(float));
  }
  __host__ __device__ size_t s_bytes() const {
    return round128((size_t)Cfg<T>::TILE * SLD * sizeof(float));
  }
  __host__ __device__ size_t p_bytes() const {
    return round128((size_t)Cfg<T>::TILE * PLD * sizeof(T));
  }
  __host__ __device__ size_t total(int n_data, int n_s, int n_p, int n_acc) const {
    return n_data * data_bytes() + n_s * s_bytes() + n_p * p_bytes() + n_acc * acc_bytes();
  }
};

// rows [t0, t0 + TILE) of one (batch, head) slice into dst[TILE][ld]; rows
// past t_total become zeros. 16-byte loads.
template <typename T>
__device__ void load_rows(T* dst, int ld, const T* src, int stride_t, int t0, int t_total,
                          int d) {
  constexpr int PER = 16 / sizeof(T);
  const int segs = d / PER;
  for (int idx = threadIdx.x; idx < Cfg<T>::TILE * segs; idx += THREADS) {
    const int row = idx / segs, seg = idx - row * segs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + row < t_total)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(t0 + row) * stride_t + seg * PER);
    *reinterpret_cast<uint4*>(dst + row * ld + seg * PER) = val;
  }
}

// rows [t0, t0 + TILE) of an accumulator into a contiguous [B, T, H, D] output
template <typename T>
__device__ void store_rows(T* dst, const float* acc, int ald, int b, int h, int heads, int t0,
                           int t_total, int d) {
  for (int idx = threadIdx.x; idx < Cfg<T>::TILE * d; idx += THREADS) {
    const int row = idx / d, col = idx - row * d;
    if (t0 + row < t_total)
      dst[(((int64_t)b * t_total + t0 + row) * heads + h) * d + col] =
          from_f<T>(acc[row * ald + col]);
  }
}

// sum / max over the THREADS / TILE neighbouring lanes that share a row
template <int RT> __device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = RT / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
template <int RT> __device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = RT / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- tile products: c[TILE][n] (+)= op(a) . op(b), float32 accumulation --------
// NT: a [TILE][k] row-major, b [n][k] row-major (b^T is the operand)
// NN: a [TILE][k] row-major, b [k][n] row-major
// TN: a [k][TILE] row-major (a^T is the operand), b [k][n] row-major

enum { NT = 0, NN = 1, TN = 2 };

template <int MODE>
__device__ void mm(float* c, int ldc, int n, int kdim, const bf16* a, int lda, const bf16* b,
                   int ldb, bool accumulate) {
  using ALayout = typename std::conditional<MODE == TN, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<MODE == NT, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x >> 5, wr = warp & 3, wc = warp >> 2;
  for (int j = wc; j < n / 16; j += 2) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* cp = c + wr * 16 * ldc + j * 16;
    if (accumulate)
      wmma::load_matrix_sync(acc, cp, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < kdim; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb;
      wmma::load_matrix_sync(fa, MODE == TN ? a + kk * lda + wr * 16 : a + wr * 16 * lda + kk,
                             lda);
      wmma::load_matrix_sync(fb, MODE == NT ? b + j * 16 * ldb + kk : b + kk * ldb + j * 16,
                             ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(cp, acc, ldc, wmma::mem_row_major);
  }
}

template <int MODE>
__device__ void mm(float* c, int ldc, int n, int kdim, const float* a, int lda, const float* b,
                   int ldb, bool accumulate) {
  constexpr int RT = THREADS / Cfg<float>::TILE, MAXC = MAX_D / RT;
  const int r = threadIdx.x / RT, j = threadIdx.x % RT;
  const int nc = n / RT;
  float acc[MAXC];
#pragma unroll
  for (int i = 0; i < MAXC; ++i)
    acc[i] = (accumulate && i < nc) ? c[r * ldc + j + RT * i] : 0.0f;
  for (int kk = 0; kk < kdim; ++kk) {
    const float av = MODE == TN ? a[kk * lda + r] : a[r * lda + kk];
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      if (i < nc) {
        const int col = j + RT * i;
        acc[i] = fmaf(av, MODE == NT ? b[col * ldb + kk] : b[kk * ldb + col], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MAXC; ++i)
    if (i < nc) c[r * ldc + j + RT * i] = acc[i];
}

// ---- what one thread knows of its row -------------------------------------------

struct Row {
  const float* bias;          // this row's bias, or null
  const unsigned char* keep;  // this row's keep bytes, or null
  bool live;
};

__device__ __forceinline__ Row make_row(const Params& p, int b, int h, int row) {
  Row r;
  r.live = row < p.tq;
  r.bias = (p.bias && r.live) ? p.bias + (int64_t)b * p.bias_sb + (int64_t)h * p.bias_sh +
                                    (int64_t)row * p.bias_sq
                              : nullptr;
  r.keep = (p.keep && r.live) ? p.keep + (((int64_t)b * p.h + h) * p.tq + row) * p.tk : nullptr;
  return r;
}

__device__ __forceinline__ float logit(const Params& p, const Row& r, float qk, int col) {
  const float s = qk * p.scale;
  return r.bias ? s + r.bias[(int64_t)col * p.bias_sk] : s;
}

// ---- forward ------------------------------------------------------------------------

template <typename T> __global__ void __launch_bounds__(THREADS) fwd_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TILE = Cfg<T>::TILE, RT = THREADS / TILE;
  constexpr int SLD = Lay<T>::SLD, PLD = Lay<T>::PLD;
  const Lay<T> lay{p.d};
  const int DLD = lay.dld(), ALD = lay.ald();
  unsigned char* at = smem;
  T* qs = reinterpret_cast<T*>(at);
  at += lay.data_bytes();
  T* kvs = reinterpret_cast<T*>(at);
  at += lay.data_bytes();
  float* ss = reinterpret_cast<float*>(at);
  at += lay.s_bytes();
  T* ps = reinterpret_cast<T*>(at);
  at += lay.p_bytes();
  float* os = reinterpret_cast<float*>(at);

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const T* qg = static_cast<const T*>(p.q) + (int64_t)b * p.q_sb + (int64_t)h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + (int64_t)b * p.k_sb + (int64_t)h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + (int64_t)b * p.v_sb + (int64_t)h * p.v_sh;
  const int r = threadIdx.x / RT, j = threadIdx.x % RT;
  const Row row = make_row(p, b, h, q0 + r);

  load_rows<T>(qs, DLD, qg, p.q_st, q0, p.tq, p.d);

  // pass 1: row max and row sum over ascending key tiles
  float m = -INFINITY, l = 0.0f;
  for (int k0 = 0; k0 < p.tk; k0 += TILE) {
    __syncthreads();
    load_rows<T>(kvs, DLD, kg, p.k_st, k0, p.tk, p.d);
    __syncthreads();
    mm<NT>(ss, SLD, TILE, p.d, qs, DLD, kvs, DLD, false);
    __syncthreads();
    float tmax = -INFINITY;
    if (row.live)
      for (int c = j; c < TILE && k0 + c < p.tk; c += RT) {
        const float s = logit(p, row, ss[r * SLD + c], k0 + c);
        ss[r * SLD + c] = s;
        tmax = fmaxf(tmax, s);
      }
    tmax = group_max<RT>(tmax);
    const float m_new = fmaxf(m, tmax);
    float part = 0.0f;
    if (row.live)
      for (int c = j; c < TILE && k0 + c < p.tk; c += RT) part += expf(ss[r * SLD + c] - m_new);
    part = group_sum<RT>(part);
    if (row.live) {
      l = l * expf(m - m_new) + part;
      m = m_new;
    }
  }
  if (p.stats && row.live && j == 0) {
    float* st = p.stats + (((int64_t)b * p.h + h) * p.tq + q0 + r) * 2;
    st[0] = m;
    st[1] = l;
  }

  // pass 2: the weights, rounded to the value dtype, times v
  for (int k0 = 0; k0 < p.tk; k0 += TILE) {
    __syncthreads();
    load_rows<T>(kvs, DLD, kg, p.k_st, k0, p.tk, p.d);
    __syncthreads();
    mm<NT>(ss, SLD, TILE, p.d, qs, DLD, kvs, DLD, false);
    __syncthreads();
    for (int c = j; c < TILE; c += RT) {
      float w = 0.0f;
      if (row.live && k0 + c < p.tk) {
        w = expf(logit(p, row, ss[r * SLD + c], k0 + c) - m) / l;
        if (row.keep) w = row.keep[k0 + c] ? w / p.keep_denom : 0.0f;
      }
      ps[r * PLD + c] = from_f<T>(w);
    }
    load_rows<T>(kvs, DLD, vg, p.v_st, k0, p.tk, p.d);
    __syncthreads();
    mm<NN>(os, ALD, p.d, TILE, ps, PLD, kvs, DLD, k0 > 0);
  }
  __syncthreads();
  store_rows<T>(static_cast<T*>(p.out), os, ALD, b, h, p.h, q0, p.tq, p.d);
}

// ---- backward, per query tile: delta and dQ -------------------------------------------

template <typename T> __global__ void __launch_bounds__(THREADS) bwd_dq_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TILE = Cfg<T>::TILE, RT = THREADS / TILE;
  constexpr int SLD = Lay<T>::SLD, PLD = Lay<T>::PLD;
  const Lay<T> lay{p.d};
  const int DLD = lay.dld(), ALD = lay.ald();
  unsigned char* at = smem;
  T* qs = reinterpret_cast<T*>(at);
  at += lay.data_bytes();
  T* gs = reinterpret_cast<T*>(at);
  at += lay.data_bytes();
  T* ks = reinterpret_cast<T*>(at);
  at += lay.data_bytes();
  T* vs = reinterpret_cast<T*>(at);
  at += lay.data_bytes();
  float* ss = reinterpret_cast<float*>(at);
  at += lay.s_bytes();
  float* dps = reinterpret_cast<float*>(at);
  at += lay.s_bytes();
  T* dss = reinterpret_cast<T*>(at);
  at += lay.p_bytes();
  float* acc = reinterpret_cast<float*>(at);

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const T* qg = static_cast<const T*>(p.q) + (int64_t)b * p.q_sb + (int64_t)h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + (int64_t)b * p.k_sb + (int64_t)h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + (int64_t)b * p.v_sb + (int64_t)h * p.v_sh;
  const T* gg = static_cast<const T*>(p.g) + (int64_t)b * p.g_sb + (int64_t)h * p.g_sh;
  const int r = threadIdx.x / RT, j = threadIdx.x % RT;
  const Row row = make_row(p, b, h, q0 + r);
  const int64_t stat_at = ((int64_t)b * p.h + h) * p.tq + q0 + r;
  const float m = row.live ? p.stats[stat_at * 2] : 0.0f;
  const float l = row.live ? p.stats[stat_at * 2 + 1] : 1.0f;

  load_rows<T>(qs, DLD, qg, p.q_st, q0, p.tq, p.d);
  load_rows<T>(gs, DLD, gg, p.g_st, q0, p.tq, p.d);

  float delta = 0.0f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < p.tk; k0 += TILE) {
      __syncthreads();
      load_rows<T>(ks, DLD, kg, p.k_st, k0, p.tk, p.d);
      load_rows<T>(vs, DLD, vg, p.v_st, k0, p.tk, p.d);
      __syncthreads();
      mm<NT>(ss, SLD, TILE, p.d, qs, DLD, ks, DLD, false);
      mm<NT>(dps, SLD, TILE, p.d, gs, DLD, vs, DLD, false);
      __syncthreads();
      for (int c = j; c < TILE; c += RT) {
        float ds = 0.0f;
        if (row.live && k0 + c < p.tk) {
          const float pr = expf(logit(p, row, ss[r * SLD + c], k0 + c) - m) / l;
          float dp = dps[r * SLD + c];
          if (row.keep) dp = row.keep[k0 + c] ? dp / p.keep_denom : 0.0f;
          if (pass == 0)
            delta += pr * dp;
          else
            ds = pr * (dp - delta) * p.scale;
        }
        if (pass == 1) dss[r * PLD + c] = from_f<T>(ds);
      }
      if (pass == 1) {
        __syncthreads();
        mm<NN>(acc, ALD, p.d, TILE, dss, PLD, ks, DLD, k0 > 0);
      }
    }
    if (pass == 0) {
      delta = group_sum<RT>(delta);
      if (row.live && j == 0) p.delta[stat_at] = delta;
    }
  }
  __syncthreads();
  store_rows<T>(static_cast<T*>(p.dq), acc, ALD, b, h, p.h, q0, p.tq, p.d);
}

// ---- backward, per key tile: dK and dV over ascending query tiles ---------------------

template <typename T> __global__ void __launch_bounds__(THREADS) bwd_dkv_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TILE = Cfg<T>::TILE, RT = THREADS / TILE;
  constexpr int SLD = Lay<T>::SLD, PLD = Lay<T>::PLD;
  const Lay<T> lay{p.d};
  const int DLD = lay.dld(), ALD = lay.ald();
  unsigned char* at = smem;
  T* qs = reinterpret_cast<T*>(at);
  at += lay.data_bytes();
  T* gs = reinterpret_cast<T*>(at);
  at += lay.data_bytes();
  T* ks = reinterpret_cast<T*>(at);
  at += lay.data_bytes();
  T* vs = reinterpret_cast<T*>(at);
  at += lay.data_bytes();
  float* ss = reinterpret_cast<float*>(at);
  at += lay.s_bytes();
  float* dps = reinterpret_cast<float*>(at);
  at += lay.s_bytes();
  T* pds = reinterpret_cast<T*>(at);
  at += lay.p_bytes();
  T* dss = reinterpret_cast<T*>(at);
  at += lay.p_bytes();
  float* dk_acc = reinterpret_cast<float*>(at);
  at += lay.acc_bytes();
  float* dv_acc = reinterpret_cast<float*>(at);

  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const T* qg = static_cast<const T*>(p.q) + (int64_t)b * p.q_sb + (int64_t)h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + (int64_t)b * p.k_sb + (int64_t)h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + (int64_t)b * p.v_sb + (int64_t)h * p.v_sh;
  const T* gg = static_cast<const T*>(p.g) + (int64_t)b * p.g_sb + (int64_t)h * p.g_sh;
  const int r = threadIdx.x / RT, j = threadIdx.x % RT;

  load_rows<T>(ks, DLD, kg, p.k_st, k0, p.tk, p.d);
  load_rows<T>(vs, DLD, vg, p.v_st, k0, p.tk, p.d);

  for (int q0 = 0; q0 < p.tq; q0 += TILE) {
    __syncthreads();
    load_rows<T>(qs, DLD, qg, p.q_st, q0, p.tq, p.d);
    load_rows<T>(gs, DLD, gg, p.g_st, q0, p.tq, p.d);
    __syncthreads();
    mm<NT>(ss, SLD, TILE, p.d, qs, DLD, ks, DLD, false);
    mm<NT>(dps, SLD, TILE, p.d, gs, DLD, vs, DLD, false);
    __syncthreads();
    const Row row = make_row(p, b, h, q0 + r);
    const int64_t stat_at = ((int64_t)b * p.h + h) * p.tq + q0 + r;
    const float m = row.live ? p.stats[stat_at * 2] : 0.0f;
    const float l = row.live ? p.stats[stat_at * 2 + 1] : 1.0f;
    const float delta = row.live ? p.delta[stat_at] : 0.0f;
    for (int c = j; c < TILE; c += RT) {
      float pd = 0.0f, ds = 0.0f;
      if (row.live && k0 + c < p.tk) {
        const float pr = expf(logit(p, row, ss[r * SLD + c], k0 + c) - m) / l;
        float dp = dps[r * SLD + c];
        pd = pr;
        if (row.keep) {
          const bool kept = row.keep[k0 + c] != 0;
          pd = kept ? pr / p.keep_denom : 0.0f;
          dp = kept ? dp / p.keep_denom : 0.0f;
        }
        ds = pr * (dp - delta) * p.scale;
      }
      pds[r * PLD + c] = from_f<T>(pd);
      dss[r * PLD + c] = from_f<T>(ds);
    }
    __syncthreads();
    mm<TN>(dv_acc, ALD, p.d, TILE, pds, PLD, gs, DLD, q0 > 0);
    mm<TN>(dk_acc, ALD, p.d, TILE, dss, PLD, qs, DLD, q0 > 0);
  }
  __syncthreads();
  store_rows<T>(static_cast<T*>(p.dk), dk_acc, ALD, b, h, p.h, k0, p.tk, p.d);
  store_rows<T>(static_cast<T*>(p.dv), dv_acc, ALD, b, h, p.h, k0, p.tk, p.d);
}

// ---- launches ---------------------------------------------------------------------------

bool shape_ok(const Params& p) {
  return p.b > 0 && p.b <= 65535 && p.h > 0 && p.h <= 65535 && p.tq > 0 && p.tk > 0 &&
         p.d >= 16 && p.d <= MAX_D && p.d % 16 == 0;
}

template <typename K>
int launch_one(K kernel, const Params& p, int tiles, size_t smem, cudaStream_t st) {
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(tiles, p.h, p.b), THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T> int launch_forward(const Params& p, cudaStream_t st) {
  constexpr int TILE = Cfg<T>::TILE;
  const Lay<T> lay{p.d};
  return launch_one(fwd_kernel<T>, p, (p.tq + TILE - 1) / TILE, lay.total(2, 1, 1, 1), st);
}

template <typename T> int launch_backward(const Params& p, cudaStream_t st) {
  constexpr int TILE = Cfg<T>::TILE;
  const Lay<T> lay{p.d};
  const int err =
      launch_one(bwd_dq_kernel<T>, p, (p.tq + TILE - 1) / TILE, lay.total(4, 2, 1, 1), st);
  if (err) return err;
  return launch_one(bwd_dkv_kernel<T>, p, (p.tk + TILE - 1) / TILE, lay.total(4, 2, 2, 2), st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q [B, Tq, H, D] and k, v [B, Tk, H, D] in
// that dtype with unit stride on D and the element strides given (batch,
// time, head); bias float32 with its four broadcast strides, or null; keep
// bytes [B, H, Tq, Tk] contiguous, or null (then keep_denom is unused); out
// [B, Tq, H, D] contiguous; stats float32 [B, H, Tq, 2] or null.

int vct_attn_forward(int dtype, const void* q, const void* k, const void* v, const void* bias,
                     const void* keep, void* out, void* stats, int b, int h, int tq, int tk,
                     int d, const int* strides, float scale, float keep_denom, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.bias = (const float*)bias; p.keep = (const unsigned char*)keep;
  p.out = out; p.stats = (float*)stats;
  p.b = b; p.h = h; p.tq = tq; p.tk = tk; p.d = d;
  p.q_sb = strides[0]; p.q_st = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_st = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_st = strides[7]; p.v_sh = strides[8];
  p.bias_sb = strides[12]; p.bias_sh = strides[13]; p.bias_sq = strides[14];
  p.bias_sk = strides[15];
  p.scale = scale; p.keep_denom = keep_denom;
  if (!shape_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 1 ? launch_forward<bf16>(p, st) : launch_forward<float>(p, st);
}

// g = dO [B, Tq, H, D] with its strides; stats from the forward; delta float32
// [B, H, Tq] scratch; dq, dk, dv contiguous outputs in the inputs' dtype.
int vct_attn_backward(int dtype, const void* q, const void* k, const void* v, const void* bias,
                      const void* keep, const void* g, const void* stats, void* delta, void* dq,
                      void* dk, void* dv, int b, int h, int tq, int tk, int d,
                      const int* strides, float scale, float keep_denom, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.g = g; p.bias = (const float*)bias;
  p.keep = (const unsigned char*)keep;
  p.stats = (float*)stats; p.delta = (float*)delta; p.dq = dq; p.dk = dk; p.dv = dv;
  p.b = b; p.h = h; p.tq = tq; p.tk = tk; p.d = d;
  p.q_sb = strides[0]; p.q_st = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_st = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_st = strides[7]; p.v_sh = strides[8];
  p.g_sb = strides[9]; p.g_st = strides[10]; p.g_sh = strides[11];
  p.bias_sb = strides[12]; p.bias_sh = strides[13]; p.bias_sq = strides[14];
  p.bias_sk = strides[15];
  p.scale = scale; p.keep_denom = keep_denom;
  if (!shape_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 1 ? launch_backward<bf16>(p, st) : launch_backward<float>(p, st);
}

}  // extern "C"
