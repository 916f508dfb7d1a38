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
//   * forward, bfloat16 (fwd_onchip_kernel): Q.K^T is computed ONCE. The
//     float32 logits of a 64-row query tile stay in shared memory between the
//     sweep that takes the row maximum and sum and the sweep that forms
//     exp(s - m) / l, applies the keep mask, rounds the weights to v's dtype
//     and accumulates P.V in float32: the reference's rounding points. K and
//     V tiles come through a double-buffered cp.async ring, the products are
//     mma.sync.m16n8k16 with ldmatrix, O lives in registers for the whole key
//     loop and P feeds the second product from registers. mma.sync and not
//     wgmma: a cell is a few MFLOP against tens of KB, bound by bytes, and
//     with 16 query rows per warp P never has to pass through shared memory
//     in the operand layout a wgmma descriptor wants;
//   * forward, float32, and bfloat16 when 64 rows of Tk logits do not fit a
//     block's shared memory (forward_plan states the limit): fwd_kernel, two
//     passes over the key tiles, pass 1 the row max m and the row sum l
//     (online rescale), pass 2 recomputes the logits. Same rounding points;
//   * backward without atomics, so the same bits from run to run: one kernel
//     per query tile (delta = rowsum(P * dP), then dQ), one per key tile
//     looping over the query tiles (dK, dV). P is recomputed from (m, l),
//     which the forward saves ([B, H, Tq, 2] float32), never stored;
//   * products of the backward and of fwd_kernel: nvcuda::wmma 16x16x16 bf16
//     tiles with float32 accumulation (tile 64), or shared-memory FMA loops
//     for float32 (tile 32), accumulators in shared memory between tiles. In
//     the bf16 backward P, dropped P and dS are rounded to bf16 to feed the
//     tensor cores (the reference keeps them float32); in float32 nothing is
//     rounded. The backward recomputes P from the (m, l) either forward saves.
//
// Masks are large finite negatives (-1e30): a fully masked row gives a
// uniform distribution over the Tk real keys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int MAX_D = 128;

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

// ---- forward with the logits on chip (bfloat16) ---------------------------------------
//
// One block is 64 query rows of one (batch, head) cell: 8 warps, warp (rg, kh)
// owning the 16 rows of row group rg against key half kh (keys kh * 32 .. +31
// of every 64-key tile). Two warps per row group double the warps an SM
// holds at the same shared memory, which is what hides the latencies here.
// The flat sequence Q tile, K tiles 0..n-1, V tiles 0..n-1 (each V tile with
// its 64 x 64 keep bytes) runs through a two-stage cp.async ring, so the next
// tile is in flight while this one is multiplied and V tile 0 while the rows
// are reduced. Q.K^T is computed once: every thread parks the scaled, biased
// logits of its own accumulator fragments in shared memory (a spill area that
// no other thread reads, laid out lane-contiguous, so it needs no barrier and
// has no bank conflict). The row maximum and sum meet across the two key
// halves through a few floats of shared memory; the parked logits become e =
// exp(s - m), and the second sweep forms e * (1 / l), applies the keep mask,
// rounds to bfloat16 where the reference rounds and feeds the result to P.V
// as the A operand straight from registers (two neighbouring accumulator
// tiles are one A fragment). O stays in mma.sync fragments for the whole key
// loop; at the end the kh = 1 warps hand their partial O to their kh = 0
// partners, which round, stage their 16 rows and store 16 bytes a thread.

constexpr int OC_THREADS = 256;
constexpr int OC_TQ = 64, OC_TK = 64, OC_STAGES = 2;
constexpr int OC_KEEP_LD = OC_TK + 16;  // 80-byte rows: 8 rows on 8 bank groups

__host__ __device__ constexpr int oc_stage_bytes(int d) { return OC_TK * (d + 8) * 2; }
__host__ __device__ constexpr int oc_key_tiles(int tk) { return (tk + OC_TK - 1) / OC_TK; }
__host__ __device__ constexpr size_t oc_smem_bytes(int tk, int d, bool keep) {
  return (size_t)OC_TQ * oc_key_tiles(tk) * OC_TK * sizeof(float) +
         (size_t)OC_STAGES * (oc_stage_bytes(d) + (keep ? OC_TQ * OC_KEEP_LD : 0));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DT>  // head width / 16
__global__ void __launch_bounds__(OC_THREADS, 2) fwd_onchip_kernel(Params p) {
  constexpr int D = DT * 16, LD = D + 8, STAGE = oc_stage_bytes(D), NS = OC_STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float row_max[2][OC_TQ], row_sum[2][OC_TQ];  // per key half
  const int n_tiles = oc_key_tiles(p.tk), nt4 = n_tiles * 4;
  float2* parked = reinterpret_cast<float2*>(smem);
  unsigned char* ring = smem + (size_t)OC_TQ * n_tiles * OC_TK * sizeof(float);
  unsigned char* keeps = ring + NS * STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int rg = warp & 3, kh = warp >> 2;
  const int q0 = blockIdx.x * OC_TQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qg = static_cast<const bf16*>(p.q) + (int64_t)b * p.q_sb + (int64_t)h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + (int64_t)b * p.k_sb + (int64_t)h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + (int64_t)b * p.v_sb + (int64_t)h * p.v_sh;
  const unsigned char* keep_cell =
      p.keep ? p.keep + ((int64_t)b * p.h + h) * p.tq * (int64_t)p.tk : nullptr;
  const bool keep_fast = (p.tk & 15) == 0;  // every row segment on a 16-byte boundary

  // item 0 is the Q tile, 1..n the K tiles, n+1..2n the V tiles; item i goes
  // to stage i % NS
  auto fetch = [&](int item) {
    const bf16* src = qg;
    int stride = p.q_st, t0 = q0, t_total = p.tq;
    if (item > n_tiles) {
      src = vg; stride = p.v_st; t0 = (item - n_tiles - 1) * OC_TK; t_total = p.tk;
    } else if (item > 0) {
      src = kg; stride = p.k_st; t0 = (item - 1) * OC_TK; t_total = p.tk;
    }
    bf16* dst = reinterpret_cast<bf16*>(ring + (item % NS) * STAGE);
#pragma unroll
    for (int i = 0; i < (DT + 1) / 2; ++i) {  // 64 rows x D / 8 pieces over 256 threads
      const int idx = tid + i * OC_THREADS;
      if (idx < OC_TK * 2 * DT) {
        const int row = idx / (2 * DT), seg = idx - row * (2 * DT);
        const bool ok = t0 + row < t_total;
        cp_async16(dst + row * LD + seg * 8,
                   src + (ok ? (int64_t)(t0 + row) * stride + seg * 8 : 0), ok);
      }
    }
    if (item > n_tiles && keep_cell) {
      unsigned char* kd = keeps + (item % NS) * (OC_TQ * OC_KEEP_LD);
      if (keep_fast) {  // 64 rows x 4 pieces of 16 bytes: one a thread
        const int row = tid >> 2, seg = tid & 3;
        const bool ok = q0 + row < p.tq && t0 + seg * 16 < p.tk;
        cp_async16(kd + row * OC_KEEP_LD + seg * 16,
                   keep_cell + (ok ? (int64_t)(q0 + row) * p.tk + t0 + seg * 16 : 0), ok);
      } else {
        for (int idx = tid; idx < OC_TQ * OC_TK; idx += OC_THREADS) {
          const int row = idx >> 6, col = idx & 63;
          const bool ok = q0 + row < p.tq && t0 + col < p.tk;
          kd[row * OC_KEEP_LD + col] = ok ? keep_cell[(int64_t)(q0 + row) * p.tk + t0 + col] : 0;
        }
      }
    }
  };
  // the item has landed and every warp is done with the one before it, whose
  // stage the item NS - 1 ahead then takes
  auto turn = [&](int item) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (item + NS - 1 <= 2 * n_tiles) fetch(item + NS - 1);
    cp_async_commit();
  };

  for (int item = 0; item < NS - 1; ++item) {
    if (item <= 2 * n_tiles) fetch(item);
    cp_async_commit();
  }
  turn(0);
  uint32_t qf[DT][4];
  {
    const bf16* qs = reinterpret_cast<const bf16*>(ring);
#pragma unroll
    for (int kk = 0; kk < DT; ++kk)
      ldmatrix_x4(qf[kk], qs + (rg * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  }

  // this thread's two rows (g and g + 8 of the row group's 16); a row past Tq
  // reads the last row's bias and is never stored
  const int r_lo = q0 + rg * 16 + g, r_hi = r_lo + 8;
  const float* bias_lo = nullptr;
  const float* bias_hi = nullptr;
  if (p.bias) {
    const float* cell = p.bias + (int64_t)b * p.bias_sb + (int64_t)h * p.bias_sh;
    bias_lo = cell + (int64_t)min(r_lo, p.tq - 1) * p.bias_sq;
    bias_hi = cell + (int64_t)min(r_hi, p.tq - 1) * p.bias_sq;
  }
  const bool bias_rows = p.bias && p.bias_sq != 0;  // else one bias row serves every query row
  float2* mine = parked + (size_t)warp * nt4 * 64 + lane;  // [nt4][2][32 lanes]

  // sweep 1: the logits, once; row maxima
  float m_lo = -INFINITY, m_hi = -INFINITY;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * OC_TK + kh * 32 + 2 * q;  // this thread's first key of the tile
    // this tile's bias, asked for before the barrier and the products so that
    // its latency hides behind them
    float bl[4][2], bh[4][2];
    if (bias_lo) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = min(c0 + nt * 8 + j, p.tk - 1);
          bl[nt][j] = bias_lo[c * p.bias_sk];
          bh[nt][j] = bias_rows ? bias_hi[c * p.bias_sk] : bl[nt][j];
        }
    }
    turn(t + 1);
    const bf16* ks = reinterpret_cast<const bf16*>(ring + ((t + 1) % NS) * STAGE) + kh * 32 * LD;
    float sacc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t kb[4];  // keys np*16.., widths kk*16..: (b0, b1) of two n8 tiles
        ldmatrix_x4(kb, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16_16816(sacc[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16_16816(sacc[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float s[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (c0 + nt * 8 + j < p.tk) {
          s[j] = sacc[nt][j] * p.scale;
          s[2 + j] = sacc[nt][2 + j] * p.scale;
          if (bias_lo) {
            s[j] += bl[nt][j];
            s[2 + j] += bh[nt][j];
          }
        } else {
          s[j] = s[2 + j] = -INFINITY;  // past the last key: weight 0
        }
      }
      m_lo = fmaxf(m_lo, fmaxf(s[0], s[1]));
      m_hi = fmaxf(m_hi, fmaxf(s[2], s[3]));
      mine[((t * 4 + nt) * 2) * 32] = make_float2(s[0], s[1]);
      mine[((t * 4 + nt) * 2 + 1) * 32] = make_float2(s[2], s[3]);
    }
  }

  // the rows' statistics, over both key halves; the parked logits become
  // e = exp(s - m). A half whose keys all lie past Tk holds -inf and 0.
  m_lo = quad_max(m_lo);
  m_hi = quad_max(m_hi);
  if (q == 0) {
    row_max[kh][rg * 16 + g] = m_lo;
    row_max[kh][rg * 16 + g + 8] = m_hi;
  }
  __syncthreads();
  m_lo = fmaxf(row_max[0][rg * 16 + g], row_max[1][rg * 16 + g]);
  m_hi = fmaxf(row_max[0][rg * 16 + g + 8], row_max[1][rg * 16 + g + 8]);
  float l_lo = 0.f, l_hi = 0.f;
#pragma unroll 4
  for (int i = 0; i < nt4; ++i) {
    float2 a = mine[(i * 2) * 32], c = mine[(i * 2 + 1) * 32];
    a.x = expf(a.x - m_lo); a.y = expf(a.y - m_lo);
    c.x = expf(c.x - m_hi); c.y = expf(c.y - m_hi);
    l_lo += a.x + a.y;
    l_hi += c.x + c.y;
    mine[(i * 2) * 32] = a;
    mine[(i * 2 + 1) * 32] = c;
  }
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  if (q == 0) {
    row_sum[kh][rg * 16 + g] = l_lo;
    row_sum[kh][rg * 16 + g + 8] = l_hi;
  }
  __syncthreads();
  l_lo = row_sum[0][rg * 16 + g] + row_sum[1][rg * 16 + g];
  l_hi = row_sum[0][rg * 16 + g + 8] + row_sum[1][rg * 16 + g + 8];
  if (p.stats && q == 0 && kh == 0) {
    float* st = p.stats + ((int64_t)b * p.h + h) * p.tq * 2;
    if (r_lo < p.tq) { st[r_lo * 2] = m_lo; st[r_lo * 2 + 1] = l_lo; }
    if (r_hi < p.tq) { st[r_hi * 2] = m_hi; st[r_hi * 2 + 1] = l_hi; }
  }
  float w_lo = 1.0f / l_lo, w_hi = 1.0f / l_hi;  // one reciprocal per row
  if (keep_cell) { w_lo /= p.keep_denom; w_hi /= p.keep_denom; }

  // sweep 2: the weights, rounded to bfloat16, times v
  float oacc[2 * DT][4];
#pragma unroll
  for (int nt = 0; nt < 2 * DT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[nt][j] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int item = n_tiles + 1 + t;
    turn(item);
    const bf16* vs = reinterpret_cast<const bf16*>(ring + (item % NS) * STAGE) + kh * 32 * LD;
    const unsigned char* kt = keeps + (item % NS) * (OC_TQ * OC_KEEP_LD) +
                              (rg * 16 + g) * OC_KEEP_LD + kh * 32 + 2 * q;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if (t * OC_TK + kh * 32 + kk * 16 >= p.tk) break;  // the rest is past the last key
      const float2 e0 = mine[((t * 4 + 2 * kk) * 2) * 32];
      const float2 e1 = mine[((t * 4 + 2 * kk) * 2 + 1) * 32];
      const float2 e2 = mine[((t * 4 + 2 * kk + 1) * 2) * 32];
      const float2 e3 = mine[((t * 4 + 2 * kk + 1) * 2 + 1) * 32];
      float w[8] = {e0.x * w_lo, e0.y * w_lo, e1.x * w_hi, e1.y * w_hi,
                    e2.x * w_lo, e2.y * w_lo, e3.x * w_hi, e3.y * w_hi};
      if (keep_cell) {
        const unsigned short k0 = *reinterpret_cast<const unsigned short*>(kt + kk * 16);
        const unsigned short k1 =
            *reinterpret_cast<const unsigned short*>(kt + 8 * OC_KEEP_LD + kk * 16);
        const unsigned short k2 = *reinterpret_cast<const unsigned short*>(kt + kk * 16 + 8);
        const unsigned short k3 =
            *reinterpret_cast<const unsigned short*>(kt + 8 * OC_KEEP_LD + kk * 16 + 8);
        if (!(k0 & 0xff)) w[0] = 0.f;
        if (!(k0 >> 8)) w[1] = 0.f;
        if (!(k1 & 0xff)) w[2] = 0.f;
        if (!(k1 >> 8)) w[3] = 0.f;
        if (!(k2 & 0xff)) w[4] = 0.f;
        if (!(k2 >> 8)) w[5] = 0.f;
        if (!(k3 & 0xff)) w[6] = 0.f;
        if (!(k3 >> 8)) w[7] = 0.f;
      }
      const uint32_t pa[4] = {pack_bf16(w[0], w[1]), pack_bf16(w[2], w[3]), pack_bf16(w[4], w[5]),
                              pack_bf16(w[6], w[7])};
#pragma unroll
      for (int np = 0; np < DT; ++np) {
        uint32_t vb[4];  // keys kk*16.., widths np*16..: (b0, b1) of two n8 tiles
        ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
        mma_bf16_16816(oacc[2 * np], pa, vb[0], vb[1]);
        mma_bf16_16816(oacc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // O = the two key halves' sums. Nothing is in flight into the ring any
  // more; once every warp is done with it, the kh = 1 warp of a row group
  // leaves its fragments there, lane-contiguous, for the same lanes of its
  // kh = 0 partner, which then stages its 16 rows in the same place.
  __syncthreads();
  float2* handoff = reinterpret_cast<float2*>(ring) + (size_t)rg * (2 * DT * 2 * 32) + lane;
  if (kh == 1) {
#pragma unroll
    for (int nt = 0; nt < 2 * DT; ++nt) {
      handoff[(nt * 2) * 32] = make_float2(oacc[nt][0], oacc[nt][1]);
      handoff[(nt * 2 + 1) * 32] = make_float2(oacc[nt][2], oacc[nt][3]);
    }
  }
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int nt = 0; nt < 2 * DT; ++nt) {
    const float2 a = handoff[(nt * 2) * 32], c = handoff[(nt * 2 + 1) * 32];
    oacc[nt][0] += a.x; oacc[nt][1] += a.y;
    oacc[nt][2] += c.x; oacc[nt][3] += c.y;
  }
  __syncwarp();
  bf16* os = reinterpret_cast<bf16*>(handoff - lane);  // 16 x LD bf16 fit the 64 x D bytes
#pragma unroll
  for (int nt = 0; nt < 2 * DT; ++nt) {
    *reinterpret_cast<uint32_t*>(os + g * LD + nt * 8 + 2 * q) = pack_bf16(oacc[nt][0], oacc[nt][1]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + nt * 8 + 2 * q) =
        pack_bf16(oacc[nt][2], oacc[nt][3]);
  }
  __syncwarp();
  bf16* og = static_cast<bf16*>(p.out);
  for (int idx = lane; idx < 16 * 2 * DT; idx += 32) {
    const int row = idx / (2 * DT), seg = idx - row * (2 * DT);
    const int tq_row = q0 + rg * 16 + row;
    if (tq_row < p.tq)
      *reinterpret_cast<uint4*>(og + (((int64_t)b * p.tq + tq_row) * p.h + h) * D + seg * 8) =
          *reinterpret_cast<const uint4*>(os + row * LD + seg * 8);
  }
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

// The forward's launch plan: {route, query rows of a block, keys of a tile,
// ring stages, dynamic shared memory, threads}. Route 1 keeps the logits of a
// query tile on chip (bfloat16 only, and only while 64 rows of Tk logits, the
// K/V ring and the keep tiles fit the 232,448 bytes a block may have: Tk up to
// 768 at D = 96 without a keep mask, 704 with one). Route 0 is the two-pass
// kernel: every float32 call, and bfloat16 past that limit. ``route`` -1 asks
// for the rule; 0 or 1 asks for that route, and 1 fails where it does not fit.
struct FwdPlan {
  int route, tile_q, tile_k, stages, smem, threads;
};

template <typename T> FwdPlan two_pass_plan(int d) {
  const Lay<T> lay{d};
  return {0, Cfg<T>::TILE, Cfg<T>::TILE, 1, (int)lay.total(2, 1, 1, 1), THREADS};
}

bool forward_plan(int dtype, int tk, int d, bool keep, int route, FwdPlan* out) {
  const bool fits = dtype == 1 && oc_smem_bytes(tk, d, keep) <= (size_t)SMEM_LIMIT;
  if (route > 1 || (route == 1 && !fits)) return false;
  if (route == 1 || (route < 0 && fits))
    *out = {1, OC_TQ, OC_TK, OC_STAGES, (int)oc_smem_bytes(tk, d, keep), OC_THREADS};
  else
    *out = dtype == 1 ? two_pass_plan<bf16>(d) : two_pass_plan<float>(d);
  return true;
}

template <int DT> int launch_onchip(const Params& p, const FwdPlan& plan, cudaStream_t st) {
  auto kernel = fwd_onchip_kernel<DT>;
  // the attribute is asked for once per device and size, not once per launch
  static int granted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || plan.smem > granted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) granted[dev] = plan.smem;
  }
  kernel<<<dim3((p.tq + OC_TQ - 1) / OC_TQ, p.h, p.b), OC_THREADS, plan.smem, st>>>(p);
  return (int)cudaGetLastError();
}

int launch_forward(int dtype, const Params& p, int route, cudaStream_t st) {
  FwdPlan plan;
  if (!forward_plan(dtype, p.tk, p.d, p.keep != nullptr, route, &plan))
    return (int)cudaErrorInvalidValue;
  if (plan.route == 0) {
    const int tiles = (p.tq + plan.tile_q - 1) / plan.tile_q;
    return dtype == 1 ? launch_one(fwd_kernel<bf16>, p, tiles, plan.smem, st)
                      : launch_one(fwd_kernel<float>, p, tiles, plan.smem, st);
  }
  switch (p.d / 16) {
    case 1: return launch_onchip<1>(p, plan, st);
    case 2: return launch_onchip<2>(p, plan, st);
    case 3: return launch_onchip<3>(p, plan, st);
    case 4: return launch_onchip<4>(p, plan, st);
    case 5: return launch_onchip<5>(p, plan, st);
    case 6: return launch_onchip<6>(p, plan, st);
    case 7: return launch_onchip<7>(p, plan, st);
    default: return launch_onchip<8>(p, plan, st);
  }
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
// [B, Tq, H, D] contiguous; stats float32 [B, H, Tq, 2] or null; route -1 (by
// the shape rule of forward_plan), which is what the package's wrappers always
// pass; 0 or 1 are for checks that time or test one route against the other.

int vct_attn_forward(int dtype, const void* q, const void* k, const void* v, const void* bias,
                     const void* keep, void* out, void* stats, int b, int h, int tq, int tk,
                     int d, const int* strides, float scale, float keep_denom, int route,
                     void* stream) {
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
  return launch_forward(dtype, p, route, st);
}

// The plan vct_attn_forward follows for such a call: 6 ints, see FwdPlan.
int vct_attn_forward_plan(int dtype, int tk, int d, int has_keep, int route, int* out) {
  if (tk < 1 || d < 16 || d > MAX_D || d % 16) return (int)cudaErrorInvalidValue;
  FwdPlan plan;
  if (!forward_plan(dtype, tk, d, has_keep != 0, route, &plan)) return (int)cudaErrorInvalidValue;
  const int vals[6] = {plan.route, plan.tile_q, plan.tile_k, plan.stages, plan.smem,
                       plan.threads};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
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
