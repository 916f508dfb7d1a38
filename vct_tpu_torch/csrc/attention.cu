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
// the bias and the 1-byte keep mask once (the backward also dO, dq, dk, dv).
// At the long-video shapes (B=32, H=8, D=96, T=128..256, bf16) the bytes
// (tens of MB, ~0.01-0.03 ms at 3.35 TB/s) outweigh the operations (a few
// GFLOP, under 0.01 ms at 989 TFLOP/s): the kernels are bound by bytes, and
// the point of fusing is that the [B, H, Tq, Tk] float32 logits never reach
// device memory. In practice a block's latencies (tile turns, barriers, the
// elementwise exp and masks between the products) set the pace, not either
// bound.
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
//   * backward, bfloat16 (bwd_dq_onchip_kernel + bwd_dkv_onchip_kernel; the
//     comment above them has the details): the forward's layout and ring,
//     products on mma.sync with their accumulators in registers. Kernel 1
//     takes a query tile, computes S and dP once per key tile, parks P and
//     dP (float32) in shared memory, so delta = rowsum(P * dP) comes in one
//     sweep from float32 values, then forms dS and dQ = dS.K. Kernel 2 takes
//     a key tile and sweeps the query tiles in ascending order with the
//     products transposed (keys as rows), so Pd^T and dS^T feed dV and dK
//     straight from registers. 7 units of 2 Tq Tk D a cell where the pair
//     below does 9, no accumulator in shared memory, one reciprocal per row
//     in place of a division per element (the plain version and the pair
//     below divide: P and the dropped dP move by up to about one float32 ulp
//     before their bf16 rounding). backward_plan takes 64 query rows a block
//     while their P and dP over Tk fit (Tk up to 320 at D = 96), and the
//     pair below past that;
//   * backward, float32, and bfloat16 past that limit (bwd_dq_kernel +
//     bwd_dkv_kernel): no atomics, so the same bits from run to run: one
//     kernel per query tile (delta = rowsum(P * dP), then dQ), one per key
//     tile looping over the query tiles (dK, dV). P is recomputed from (m,
//     l), which the forward saves ([B, H, Tq, 2] float32), never stored;
//   * products of that backward pair and of fwd_kernel: nvcuda::wmma
//     16x16x16 bf16 tiles with float32 accumulation (tile 64), or
//     shared-memory FMA loops for float32 (tile 32), accumulators in shared
//     memory between tiles. In every bf16 backward P, dropped P and dS are
//     rounded to bf16 to feed the tensor cores (the reference keeps them
//     float32); in float32 nothing is rounded. The backward recomputes P from
//     the (m, l) either forward saves.
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

__host__ __device__ constexpr int oc_tile_bytes(int d) { return OC_TK * (d + 8) * 2; }
__host__ __device__ constexpr int oc_key_tiles(int tk) { return (tk + OC_TK - 1) / OC_TK; }
__host__ __device__ constexpr size_t oc_smem_bytes(int tk, int d, bool keep) {
  return (size_t)OC_TQ * oc_key_tiles(tk) * OC_TK * sizeof(float) +
         (size_t)OC_STAGES * (oc_tile_bytes(d) + (keep ? OC_TQ * OC_KEEP_LD : 0));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows [t0, t0 + rows) of one (batch, head) slice into dst[rows][D + 8] by
// cp.async, zero fill past t_total
template <int DT>
__device__ __forceinline__ void fetch_rows(bf16* dst, const bf16* src, int stride, int t0,
                                           int t_total, int rows) {
  constexpr int LD = DT * 16 + 8;
  for (int idx = threadIdx.x; idx < rows * 2 * DT; idx += OC_THREADS) {
    const int row = idx / (2 * DT), seg = idx - row * (2 * DT);
    const bool ok = t0 + row < t_total;
    cp_async16(dst + row * LD + seg * 8, src + (ok ? (int64_t)(t0 + row) * stride + seg * 8 : 0),
               ok);
  }
}

// keep bytes [rows][64] of the cell from (row r0, key k0) into dst[rows][80]
__device__ __forceinline__ void fetch_keep(unsigned char* dst, const unsigned char* cell,
                                           const Params& p, int r0, int k0, int rows) {
  if ((p.tk & 15) == 0) {  // every row segment on a 16-byte boundary
    for (int idx = threadIdx.x; idx < rows * 4; idx += OC_THREADS) {
      const int row = idx >> 2, seg = idx & 3;
      const bool ok = r0 + row < p.tq && k0 + seg * 16 < p.tk;
      cp_async16(dst + row * OC_KEEP_LD + seg * 16,
                 cell + (ok ? (int64_t)(r0 + row) * p.tk + k0 + seg * 16 : 0), ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * OC_TK; idx += OC_THREADS) {
      const int row = idx >> 6, col = idx & 63;
      const bool ok = r0 + row < p.tq && k0 + col < p.tk;
      dst[row * OC_KEEP_LD + col] = ok ? cell[(int64_t)(r0 + row) * p.tk + k0 + col] : 0;
    }
  }
}

// 16 rows of float32 fragments acc[2 DT][4] (rows g, g + 8; cols nt * 8 + 2q)
// rounded to bfloat16, staged in ``stage`` (16 x (D + 8)) by one warp and
// stored to rows [t0, t0 + 16) of a contiguous [B, T, H, D] output
template <int DT>
__device__ __forceinline__ void store16_rows(bf16* stage, float (&acc)[2 * DT][4], bf16* out,
                                             int b, int h, int heads, int t0, int t_total) {
  constexpr int D = DT * 16, LD = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2 * DT; ++nt) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + nt * 8 + 2 * q) = pack_bf16(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + nt * 8 + 2 * q) =
        pack_bf16(acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * 2 * DT; idx += 32) {
    const int row = idx / (2 * DT), seg = idx - row * (2 * DT);
    if (t0 + row < t_total)
      *reinterpret_cast<uint4*>(out + (((int64_t)b * t_total + t0 + row) * heads + h) * D + seg * 8) =
          *reinterpret_cast<const uint4*>(stage + row * LD + seg * 8);
  }
  __syncwarp();
}

template <int DT>  // head width / 16
__global__ void __launch_bounds__(OC_THREADS, 2) fwd_onchip_kernel(Params p) {
  constexpr int D = DT * 16, LD = D + 8, STAGE = oc_tile_bytes(D), NS = OC_STAGES;
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
    fetch_rows<DT>(reinterpret_cast<bf16*>(ring + (item % NS) * STAGE), src, stride, t0, t_total,
                   OC_TK);
    if (item > n_tiles && keep_cell)
      fetch_keep(keeps + (item % NS) * (OC_TQ * OC_KEEP_LD), keep_cell, p, q0, t0, OC_TQ);
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
  // 16 x LD bfloat16 fit the row group's 64 x D bytes of handoff
  store16_rows<DT>(reinterpret_cast<bf16*>(handoff - lane), oacc, static_cast<bf16*>(p.out), b, h,
                   p.h, q0 + rg * 16, p.tq);
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

// ---- backward with the products on chip (bfloat16) -------------------------------------
//
// Kernel 1, bwd_dq_onchip_kernel<DT>: one block is TQ = 64 query rows of
// one (batch, head) cell, 8 warps, warp (rg, kq) owning the 16 rows of row
// group rg against key half kq (KW = 32 keys of every 64-key tile). The flat sequence Q + dO tile, (K, V) tiles 0..n-1 (each with its
// TQ x 64 keep bytes), K tiles 0..n-1 runs through a two-stage cp.async ring.
// Sweep 1 computes S = Q.K^T and dP = dO.V^T once per key tile on mma.sync
// (Q and dO fragments stay in registers), forms P = exp(s - m) / l from the
// forward's saved statistics and the keep-scaled dP, adds P * dP into the
// rows' float32 delta and parks P and dP, float32, lane-contiguous in shared
// memory. The delta meets over the KS = 2 key halves through shared memory,
// in a fixed order. Sweep 2 forms dS = P (dP - delta) scale from the parked
// values, rounds it to bfloat16 straight into an A fragment and accumulates
// dQ = dS.K in registers (K through ldmatrix.trans). The kq > 0 warps hand
// their partial dQ to the kq = 0 warp of their row group, which adds them in
// kq order, rounds and stores 16 bytes a thread.
//
// Kernel 2, bwd_dkv_onchip_kernel<DT>: one block is 64 keys of one cell; K
// and V stay in shared memory, the query tiles (Q, dO, the rows' m, l, delta
// and the keep bytes) come through a two-stage ring in ascending order. The
// products are computed transposed, keys as rows: S^T = K.Q^T and dP^T =
// V.dO^T put a key row's values in the accumulator layout that is an A
// fragment of the next product, so Pd^T and dS^T go from registers, rounded
// to bfloat16, into dV += Pd^T.dO and dK += dS^T.Q (dO and Q through
// ldmatrix.trans). Warp (kg, qh) owns 16 keys against 32 queries of each
// tile; the qh = 1 warps hand their dK and dV to their qh = 0 partners at
// the end, which add, round and store.
//
// Products: 3 units of 2 Tq Tk D in kernel 1, 4 in kernel 2 (the old pair
// did 9); no accumulator passes through shared memory.
//
// Rounding: P = exp(s - m) * (1 / l) and the dropped dP = dP * (1 / keep)
// take one reciprocal per row and per call where the plain version divides
// per element; the product is rounded twice where the quotient is rounded
// once, so P and dP move by up to about one float32 ulp before P, Pd and dS
// are rounded to bf16. On an H100 a division per element took the pair from
// 0.26 to 0.45 ms at 256 x 256: the elementwise work, not the products, sets
// the warps' instruction throughput.

constexpr int OB_STAT_BYTES = 3 * OC_TK * 4;  // a query tile's m, 1 / l and delta

constexpr int OB_TQ = 64;  // kernel 1's query rows a block

// kernel 1: parked P and dP of OB_TQ rows x Tk (whole key tiles), the ring
__host__ __device__ constexpr size_t ob_dq_smem(int tk, int d, bool keep) {
  return (size_t)OB_TQ * oc_key_tiles(tk) * OC_TK * 2 * sizeof(float) +
         (size_t)OC_STAGES * (2 * oc_tile_bytes(d) + (keep ? OB_TQ * OC_KEEP_LD : 0));
}
// kernel 2: the K and V tiles, the ring of query tiles
__host__ __device__ constexpr size_t ob_dkv_smem(int d, bool keep) {
  return (size_t)2 * oc_tile_bytes(d) +
         (size_t)OC_STAGES * (2 * oc_tile_bytes(d) + OB_STAT_BYTES + (keep ? OC_TK * OC_KEEP_LD : 0));
}

template <int DT>  // head width / 16
__global__ void __launch_bounds__(OC_THREADS, 1) bwd_dq_onchip_kernel(Params p) {
  constexpr int D = DT * 16, LD = D + 8, TILE = oc_tile_bytes(D), STAGE = 2 * TILE;
  constexpr int NS = OC_STAGES, KS = 2, RG = 8 / KS, TQ = OB_TQ, KW = OC_TK / KS, NT = KW / 8;
  static_assert(TQ == 16 * RG, "a warp owns 16 rows of its key half");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float row_part[KS][TQ];  // per key part: the rows' delta
  const int n_tiles = oc_key_tiles(p.tk);
  float4* parked = reinterpret_cast<float4*>(smem);
  unsigned char* ring = smem + (size_t)TQ * n_tiles * OC_TK * 2 * sizeof(float);
  unsigned char* keeps = ring + NS * STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int rg = warp % RG, kq = warp / RG;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qg = static_cast<const bf16*>(p.q) + (int64_t)b * p.q_sb + (int64_t)h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + (int64_t)b * p.k_sb + (int64_t)h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + (int64_t)b * p.v_sb + (int64_t)h * p.v_sh;
  const bf16* gg = static_cast<const bf16*>(p.g) + (int64_t)b * p.g_sb + (int64_t)h * p.g_sh;
  const unsigned char* keep_cell =
      p.keep ? p.keep + ((int64_t)b * p.h + h) * p.tq * (int64_t)p.tk : nullptr;

  // item 0 is the Q and dO tile, 1..n the (K, V) tiles, n+1..2n the K tiles
  auto fetch = [&](int item) {
    unsigned char* st = ring + (item % NS) * STAGE;
    bf16* s0 = reinterpret_cast<bf16*>(st);
    bf16* s1 = reinterpret_cast<bf16*>(st + TILE);
    if (item == 0) {
      fetch_rows<DT>(s0, qg, p.q_st, q0, p.tq, TQ);
      fetch_rows<DT>(s1, gg, p.g_st, q0, p.tq, TQ);
    } else if (item <= n_tiles) {
      const int k0 = (item - 1) * OC_TK;
      fetch_rows<DT>(s0, kg, p.k_st, k0, p.tk, OC_TK);
      fetch_rows<DT>(s1, vg, p.v_st, k0, p.tk, OC_TK);
      if (keep_cell) fetch_keep(keeps + (item % NS) * (TQ * OC_KEEP_LD), keep_cell, p, q0, k0, TQ);
    } else {
      fetch_rows<DT>(s0, kg, p.k_st, (item - n_tiles - 1) * OC_TK, p.tk, OC_TK);
    }
  };
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
  uint32_t qf[DT][4], gf[DT][4];
  {
    const bf16* qs = reinterpret_cast<const bf16*>(ring);
    const bf16* gs = reinterpret_cast<const bf16*>(ring + TILE);
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      ldmatrix_x4(qf[kk], qs + (rg * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      ldmatrix_x4(gf[kk], gs + (rg * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
  }

  // this thread's two rows; a row past Tq reads the last row's bias and
  // statistics and is never stored
  const int r_lo = q0 + rg * 16 + g, r_hi = r_lo + 8;
  const float* stats = p.stats + ((int64_t)b * p.h + h) * p.tq * 2;
  // one reciprocal per row and one for the keep scale: the products below
  // multiply where the plain version divides
  const float m_lo = stats[min(r_lo, p.tq - 1) * 2], il_lo = 1.0f / stats[min(r_lo, p.tq - 1) * 2 + 1];
  const float m_hi = stats[min(r_hi, p.tq - 1) * 2], il_hi = 1.0f / stats[min(r_hi, p.tq - 1) * 2 + 1];
  const float ikeep = 1.0f / p.keep_denom;
  const float* bias_lo = nullptr;
  const float* bias_hi = nullptr;
  if (p.bias) {
    const float* cell = p.bias + (int64_t)b * p.bias_sb + (int64_t)h * p.bias_sh;
    bias_lo = cell + (int64_t)min(r_lo, p.tq - 1) * p.bias_sq;
    bias_hi = cell + (int64_t)min(r_hi, p.tq - 1) * p.bias_sq;
  }
  const bool bias_rows = p.bias && p.bias_sq != 0;
  float4* mine = parked + (size_t)warp * n_tiles * NT * 2 * 32 + lane;  // [tile][nt][P, dP][lane]

  // sweep 1: S and dP once; P, the keep-scaled dP and delta
  float d_lo = 0.f, d_hi = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * OC_TK + kq * KW + 2 * q;  // this thread's first key of the tile
    float bl[NT][2], bh[NT][2];
    if (bias_lo) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = min(c0 + nt * 8 + j, p.tk - 1);
          bl[nt][j] = bias_lo[c * p.bias_sk];
          bh[nt][j] = bias_rows ? bias_hi[c * p.bias_sk] : bl[nt][j];
        }
    }
    turn(t + 1);
    const unsigned char* st = ring + ((t + 1) % NS) * STAGE;
    const bf16* ks = reinterpret_cast<const bf16*>(st) + kq * KW * LD;
    const bf16* vs = reinterpret_cast<const bf16*>(st + TILE) + kq * KW * LD;
    float sacc[NT][4], pacc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[nt][j] = pacc[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int off = (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, ks + off);
        ldmatrix_x4(vb, vs + off);
        mma_bf16_16816(sacc[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16_16816(sacc[2 * np + 1], qf[kk], kb[2], kb[3]);
        mma_bf16_16816(pacc[2 * np], gf[kk], vb[0], vb[1]);
        mma_bf16_16816(pacc[2 * np + 1], gf[kk], vb[2], vb[3]);
      }
    const unsigned char* kt = keeps + ((t + 1) % NS) * (TQ * OC_KEEP_LD) +
                              (rg * 16 + g) * OC_KEEP_LD + kq * KW + 2 * q;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float pr[4], dp[4];
      unsigned short k_lo = 0xffff, k_hi = 0xffff;
      if (keep_cell) {
        k_lo = *reinterpret_cast<const unsigned short*>(kt + nt * 8);
        k_hi = *reinterpret_cast<const unsigned short*>(kt + 8 * OC_KEEP_LD + nt * 8);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        pr[j] = pr[2 + j] = dp[j] = dp[2 + j] = 0.f;
        if (c0 + nt * 8 + j < p.tk) {
          float s_lo = sacc[nt][j] * p.scale, s_hi = sacc[nt][2 + j] * p.scale;
          if (bias_lo) {
            s_lo += bl[nt][j];
            s_hi += bh[nt][j];
          }
          pr[j] = expf(s_lo - m_lo) * il_lo;
          pr[2 + j] = expf(s_hi - m_hi) * il_hi;
          dp[j] = pacc[nt][j];
          dp[2 + j] = pacc[nt][2 + j];
          if (keep_cell) {
            dp[j] = ((k_lo >> (8 * j)) & 0xff) ? dp[j] * ikeep : 0.f;
            dp[2 + j] = ((k_hi >> (8 * j)) & 0xff) ? dp[2 + j] * ikeep : 0.f;
          }
        }
        d_lo += pr[j] * dp[j];
        d_hi += pr[2 + j] * dp[2 + j];
      }
      mine[((t * NT + nt) * 2) * 32] = make_float4(pr[0], pr[1], pr[2], pr[3]);
      mine[((t * NT + nt) * 2 + 1) * 32] = make_float4(dp[0], dp[1], dp[2], dp[3]);
    }
  }

  // delta over the key parts, in kq order
  d_lo = quad_sum(d_lo);
  d_hi = quad_sum(d_hi);
  if (q == 0) {
    row_part[kq][rg * 16 + g] = d_lo;
    row_part[kq][rg * 16 + g + 8] = d_hi;
  }
  __syncthreads();
  d_lo = d_hi = 0.f;
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    d_lo += row_part[i][rg * 16 + g];
    d_hi += row_part[i][rg * 16 + g + 8];
  }
  if (kq == 0 && q == 0) {
    float* dl = p.delta + ((int64_t)b * p.h + h) * p.tq;
    if (r_lo < p.tq) dl[r_lo] = d_lo;
    if (r_hi < p.tq) dl[r_hi] = d_hi;
  }

  // sweep 2: dS, rounded to bfloat16, times K
  float acc[2 * DT][4];
#pragma unroll
  for (int nt = 0; nt < 2 * DT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int item = n_tiles + 1 + t;
    turn(item);
    const bf16* ks = reinterpret_cast<const bf16*>(ring + (item % NS) * STAGE) + kq * KW * LD;
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      if (t * OC_TK + kq * KW + kk * 16 >= p.tk) break;  // the rest is past the last key
      const float4 p0 = mine[((t * NT + 2 * kk) * 2) * 32];
      const float4 e0 = mine[((t * NT + 2 * kk) * 2 + 1) * 32];
      const float4 p1 = mine[((t * NT + 2 * kk + 1) * 2) * 32];
      const float4 e1 = mine[((t * NT + 2 * kk + 1) * 2 + 1) * 32];
      const uint32_t pa[4] = {
          pack_bf16(p0.x * (e0.x - d_lo) * p.scale, p0.y * (e0.y - d_lo) * p.scale),
          pack_bf16(p0.z * (e0.z - d_hi) * p.scale, p0.w * (e0.w - d_hi) * p.scale),
          pack_bf16(p1.x * (e1.x - d_lo) * p.scale, p1.y * (e1.y - d_lo) * p.scale),
          pack_bf16(p1.z * (e1.z - d_hi) * p.scale, p1.w * (e1.w - d_hi) * p.scale)};
#pragma unroll
      for (int np = 0; np < DT; ++np) {
        uint32_t kb[4];  // keys kk*16.., widths np*16..: (b0, b1) of two n8 tiles
        ldmatrix_x4_trans(kb, ks + (kk * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
        mma_bf16_16816(acc[2 * np], pa, kb[0], kb[1]);
        mma_bf16_16816(acc[2 * np + 1], pa, kb[2], kb[3]);
      }
    }
  }

  // dQ = the key parts' sums, added in kq order by the kq = 0 warp
  __syncthreads();
  float2* area = reinterpret_cast<float2*>(ring);  // [rg][kq - 1][2 DT][2][32 lanes]
  if (kq > 0) {
    float2* mine_out = area + ((size_t)(rg * (KS - 1) + kq - 1) * 2 * DT * 2) * 32 + lane;
#pragma unroll
    for (int nt = 0; nt < 2 * DT; ++nt) {
      mine_out[(nt * 2) * 32] = make_float2(acc[nt][0], acc[nt][1]);
      mine_out[(nt * 2 + 1) * 32] = make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();
  if (kq > 0) return;
#pragma unroll
  for (int i = 1; i < KS; ++i) {
    const float2* part = area + ((size_t)(rg * (KS - 1) + i - 1) * 2 * DT * 2) * 32 + lane;
#pragma unroll
    for (int nt = 0; nt < 2 * DT; ++nt) {
      const float2 a = part[(nt * 2) * 32], c = part[(nt * 2 + 1) * 32];
      acc[nt][0] += a.x; acc[nt][1] += a.y;
      acc[nt][2] += c.x; acc[nt][3] += c.y;
    }
  }
  __syncwarp();
  // 16 x (D + 8) bfloat16 fit the area of the (rg, 1) partner, which only this warp reads
  store16_rows<DT>(reinterpret_cast<bf16*>(area + (size_t)(rg * (KS - 1)) * 2 * DT * 2 * 32),
                 acc, static_cast<bf16*>(p.dq), b, h, p.h, q0 + rg * 16, p.tq);
}

template <int DT>
__global__ void __launch_bounds__(OC_THREADS, 1) bwd_dkv_onchip_kernel(Params p) {
  constexpr int D = DT * 16, LD = D + 8, TILE = oc_tile_bytes(D);
  constexpr int NS = OC_STAGES, STAGE = 2 * TILE + OB_STAT_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  const bf16* ks = reinterpret_cast<const bf16*>(smem);
  const bf16* vs = reinterpret_cast<const bf16*>(smem + TILE);
  unsigned char* ring = smem + 2 * TILE;
  unsigned char* keeps = ring + NS * STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int kgr = warp & 3, qh = warp >> 2;
  const int k0 = blockIdx.x * OC_TK, h = blockIdx.y, b = blockIdx.z;
  const int64_t cell = (int64_t)b * p.h + h;
  const bf16* qg = static_cast<const bf16*>(p.q) + (int64_t)b * p.q_sb + (int64_t)h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + (int64_t)b * p.k_sb + (int64_t)h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + (int64_t)b * p.v_sb + (int64_t)h * p.v_sh;
  const bf16* gg = static_cast<const bf16*>(p.g) + (int64_t)b * p.g_sb + (int64_t)h * p.g_sh;
  const unsigned char* keep_cell = p.keep ? p.keep + cell * p.tq * (int64_t)p.tk : nullptr;
  const float* stats = p.stats + cell * p.tq * 2;
  const float* deltas = p.delta + cell * p.tq;
  const int n_q = (p.tq + OC_TK - 1) / OC_TK;

  // query tile t: Q and dO rows, the rows' (m, 1 / l, delta) and the keep
  // bytes. A row past Tq gets (0, 1, 0) and zero inputs; its weight is masked.
  auto fetch = [&](int t) {
    unsigned char* st = ring + (t % NS) * STAGE;
    const int r0 = t * OC_TK;
    fetch_rows<DT>(reinterpret_cast<bf16*>(st), qg, p.q_st, r0, p.tq, OC_TK);
    fetch_rows<DT>(reinterpret_cast<bf16*>(st + TILE), gg, p.g_st, r0, p.tq, OC_TK);
    if (keep_cell) fetch_keep(keeps + (t % NS) * (OC_TK * OC_KEEP_LD), keep_cell, p, r0, k0, OC_TK);
    if (tid < OC_TK) {
      float* sv = reinterpret_cast<float*>(st + 2 * TILE);
      const bool ok = r0 + tid < p.tq;
      sv[tid] = ok ? stats[(r0 + tid) * 2] : 0.f;
      sv[OC_TK + tid] = ok ? 1.0f / stats[(r0 + tid) * 2 + 1] : 1.f;  // 1 / l
      sv[2 * OC_TK + tid] = ok ? deltas[r0 + tid] : 0.f;
    }
  };
  auto turn = [&](int t) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (t + NS - 1 < n_q) fetch(t + NS - 1);
    cp_async_commit();
  };
  fetch_rows<DT>(const_cast<bf16*>(ks), kg, p.k_st, k0, p.tk, OC_TK);
  fetch_rows<DT>(const_cast<bf16*>(vs), vg, p.v_st, k0, p.tk, OC_TK);
  for (int t = 0; t < NS - 1; ++t) {
    if (t < n_q) fetch(t);
    cp_async_commit();
  }

  // this thread's two keys (g and g + 8 of the warp's 16); a key past Tk
  // reads the last key's bias and is never stored
  const int key_lo = k0 + kgr * 16 + g, key_hi = key_lo + 8;
  const bool live_lo = key_lo < p.tk, live_hi = key_hi < p.tk;
  const float* bias_cell =
      p.bias ? p.bias + (int64_t)b * p.bias_sb + (int64_t)h * p.bias_sh : nullptr;
  const int64_t bk_lo = (int64_t)min(key_lo, p.tk - 1) * p.bias_sk;
  const int64_t bk_hi = (int64_t)min(key_hi, p.tk - 1) * p.bias_sk;
  const bool bias_rows = p.bias && p.bias_sq != 0;  // else one value per key for every query
  const float ikeep = 1.0f / p.keep_denom;
  float bias_key_lo = 0.f, bias_key_hi = 0.f;
  if (bias_cell && !bias_rows) {
    bias_key_lo = bias_cell[bk_lo];
    bias_key_hi = bias_cell[bk_hi];
  }

  float dk[2 * DT][4], dv[2 * DT][4];
#pragma unroll
  for (int nt = 0; nt < 2 * DT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[nt][j] = dv[nt][j] = 0.f;

  for (int t = 0; t < n_q; ++t) {
    const int qc0 = qh * 32 + 2 * q;  // this thread's first query column of the tile
    float bl[4][2], bh[4][2];  // per element bias, asked for before the barrier
    if (bias_rows) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int64_t rq = (int64_t)min(t * OC_TK + qc0 + nt * 8 + j, p.tq - 1) * p.bias_sq;
          bl[nt][j] = bias_cell[rq + bk_lo];
          bh[nt][j] = bias_cell[rq + bk_hi];
        }
    }
    turn(t);
    const unsigned char* st = ring + (t % NS) * STAGE;
    const bf16* qs = reinterpret_cast<const bf16*>(st) + qh * 32 * LD;
    const bf16* gs = reinterpret_cast<const bf16*>(st + TILE) + qh * 32 * LD;
    const float* sv = reinterpret_cast<const float*>(st + 2 * TILE) + qh * 32;
    float sacc[4][4], pacc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[nt][j] = pacc[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, ks + (kgr * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      ldmatrix_x4(va, vs + (kgr * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int off = (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t qb[4], gb[4];
        ldmatrix_x4(qb, qs + off);
        ldmatrix_x4(gb, gs + off);
        mma_bf16_16816(sacc[2 * np], ka, qb[0], qb[1]);
        mma_bf16_16816(sacc[2 * np + 1], ka, qb[2], qb[3]);
        mma_bf16_16816(pacc[2 * np], va, gb[0], gb[1]);
        mma_bf16_16816(pacc[2 * np + 1], va, gb[2], gb[3]);
      }
    }
    // P, the dropped P and dS, key rows (g, g + 8) x query columns, in place
    const unsigned char* kt = keeps + (t % NS) * (OC_TK * OC_KEEP_LD) + kgr * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = nt * 8 + 2 * q + j;  // query column within the warp's 32
        const bool q_live = t * OC_TK + qh * 32 + c < p.tq;
        const float m = sv[c], il = sv[OC_TK + c], dl = sv[2 * OC_TK + c];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          float s = sacc[nt][2 * hi + j] * p.scale;
          if (bias_rows) s += hi ? bh[nt][j] : bl[nt][j];
          else if (bias_cell) s += hi ? bias_key_hi : bias_key_lo;
          const bool live = q_live && (hi ? live_hi : live_lo);
          const float pr = live ? expf(s - m) * il : 0.f;
          float dp = pacc[nt][2 * hi + j], pd = pr;
          if (keep_cell) {
            const bool kept = kt[(qh * 32 + c) * OC_KEEP_LD + 8 * hi] != 0;
            pd = kept ? pr * ikeep : 0.f;
            dp = kept ? dp * ikeep : 0.f;
          }
          sacc[nt][2 * hi + j] = pd;
          pacc[nt][2 * hi + j] = pr * (dp - dl) * p.scale;
        }
      }
    // dV += Pd^T . dO, dK += dS^T . Q over the warp's 32 queries
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      const uint32_t pa[4] = {pack_bf16(sacc[2 * kc][0], sacc[2 * kc][1]),
                              pack_bf16(sacc[2 * kc][2], sacc[2 * kc][3]),
                              pack_bf16(sacc[2 * kc + 1][0], sacc[2 * kc + 1][1]),
                              pack_bf16(sacc[2 * kc + 1][2], sacc[2 * kc + 1][3])};
      const uint32_t da[4] = {pack_bf16(pacc[2 * kc][0], pacc[2 * kc][1]),
                              pack_bf16(pacc[2 * kc][2], pacc[2 * kc][3]),
                              pack_bf16(pacc[2 * kc + 1][0], pacc[2 * kc + 1][1]),
                              pack_bf16(pacc[2 * kc + 1][2], pacc[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < DT; ++np) {
        const int off = (kc * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8;
        uint32_t gb[4], qb[4];
        ldmatrix_x4_trans(gb, gs + off);
        ldmatrix_x4_trans(qb, qs + off);
        mma_bf16_16816(dv[2 * np], pa, gb[0], gb[1]);
        mma_bf16_16816(dv[2 * np + 1], pa, gb[2], gb[3]);
        mma_bf16_16816(dk[2 * np], da, qb[0], qb[1]);
        mma_bf16_16816(dk[2 * np + 1], da, qb[2], qb[3]);
      }
    }
  }

  // dK, dV = the two query halves' sums; the qh = 1 warps hand theirs over
  __syncthreads();
  float2* area = reinterpret_cast<float2*>(ring);  // [kg][dK, dV][2 DT][2][32 lanes]
  float2* dk_area = area + ((size_t)(kgr * 2) * 2 * DT * 2) * 32;
  float2* dv_area = area + ((size_t)(kgr * 2 + 1) * 2 * DT * 2) * 32;
  if (qh == 1) {
#pragma unroll
    for (int nt = 0; nt < 2 * DT; ++nt) {
      dk_area[(nt * 2) * 32 + lane] = make_float2(dk[nt][0], dk[nt][1]);
      dk_area[(nt * 2 + 1) * 32 + lane] = make_float2(dk[nt][2], dk[nt][3]);
      dv_area[(nt * 2) * 32 + lane] = make_float2(dv[nt][0], dv[nt][1]);
      dv_area[(nt * 2 + 1) * 32 + lane] = make_float2(dv[nt][2], dv[nt][3]);
    }
  }
  __syncthreads();
  if (qh == 1) return;
#pragma unroll
  for (int nt = 0; nt < 2 * DT; ++nt) {
    float2 a = dk_area[(nt * 2) * 32 + lane], c = dk_area[(nt * 2 + 1) * 32 + lane];
    dk[nt][0] += a.x; dk[nt][1] += a.y; dk[nt][2] += c.x; dk[nt][3] += c.y;
    a = dv_area[(nt * 2) * 32 + lane];
    c = dv_area[(nt * 2 + 1) * 32 + lane];
    dv[nt][0] += a.x; dv[nt][1] += a.y; dv[nt][2] += c.x; dv[nt][3] += c.y;
  }
  __syncwarp();
  store16_rows<DT>(reinterpret_cast<bf16*>(dk_area), dk, static_cast<bf16*>(p.dk), b, h, p.h,
                 k0 + kgr * 16, p.tk);
  store16_rows<DT>(reinterpret_cast<bf16*>(dv_area), dv, static_cast<bf16*>(p.dv), b, h, p.h,
                 k0 + kgr * 16, p.tk);
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

// The backward's launch plan: {route, query rows of a kernel-1 block, keys of
// a kernel-2 block, ring stages, kernel 1's and kernel 2's dynamic shared
// memory, threads}. Route 1 keeps the products in registers and P and dP of
// a query tile on chip (bfloat16 only): 64 query rows a block while their P
// and dP over Tk, the ring and the keep tiles fit the 232,448 bytes a block
// may have (Tk up to 320 at D = 96, with or without a keep mask). Route 0 is
// the pair of kernels with shared-memory accumulators: every float32 call,
// and bfloat16 past that limit. ``route`` -1 asks for the rule; 0 or 1 asks
// for that route, and 1 fails where it does not fit.
struct BwdPlan {
  int route, tile_q, tile_k, stages, smem_dq, smem_dkv, threads;
};

bool backward_plan(int dtype, int tk, int d, bool keep, int route, BwdPlan* out) {
  const bool fits = dtype == 1 && ob_dq_smem(tk, d, keep) <= (size_t)SMEM_LIMIT &&
                    ob_dkv_smem(d, keep) <= (size_t)SMEM_LIMIT;
  if (route > 1 || (route == 1 && !fits)) return false;
  if (route == 1 || (route < 0 && fits)) {
    *out = {1, OB_TQ, OC_TK, OC_STAGES, (int)ob_dq_smem(tk, d, keep),
            (int)ob_dkv_smem(d, keep), OC_THREADS};
  } else if (dtype == 1) {
    const Lay<bf16> lay{d};
    *out = {0, Cfg<bf16>::TILE, Cfg<bf16>::TILE, 1, (int)lay.total(4, 2, 1, 1),
            (int)lay.total(4, 2, 2, 2), THREADS};
  } else {
    const Lay<float> lay{d};
    *out = {0, Cfg<float>::TILE, Cfg<float>::TILE, 1, (int)lay.total(4, 2, 1, 1),
            (int)lay.total(4, 2, 2, 2), THREADS};
  }
  return true;
}

// the dynamic shared memory attribute, asked for once per kernel, device and size
template <typename K> cudaError_t grant_smem(K kernel, int smem, int (&granted)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && smem <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < 64) granted[dev] = smem;
  return err;
}

template <int DT> int launch_bwd_onchip(const Params& p, const BwdPlan& plan, cudaStream_t st) {
  static int granted_dq[64] = {}, granted_dkv[64] = {};
  auto dq_kernel = bwd_dq_onchip_kernel<DT>;
  auto dkv_kernel = bwd_dkv_onchip_kernel<DT>;
  cudaError_t err = grant_smem(dq_kernel, plan.smem_dq, granted_dq);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<dim3((p.tq + plan.tile_q - 1) / plan.tile_q, p.h, p.b), OC_THREADS, plan.smem_dq,
              st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = grant_smem(dkv_kernel, plan.smem_dkv, granted_dkv)) != cudaSuccess) return (int)err;
  dkv_kernel<<<dim3((p.tk + OC_TK - 1) / OC_TK, p.h, p.b), OC_THREADS, plan.smem_dkv, st>>>(p);
  return (int)cudaGetLastError();
}

int launch_backward_routed(int dtype, const Params& p, int route, cudaStream_t st) {
  BwdPlan plan;
  if (!backward_plan(dtype, p.tk, p.d, p.keep != nullptr, route, &plan))
    return (int)cudaErrorInvalidValue;
  if (plan.route == 0) return dtype == 1 ? launch_backward<bf16>(p, st) : launch_backward<float>(p, st);
  switch (p.d / 16) {
    case 1: return launch_bwd_onchip<1>(p, plan, st);
    case 2: return launch_bwd_onchip<2>(p, plan, st);
    case 3: return launch_bwd_onchip<3>(p, plan, st);
    case 4: return launch_bwd_onchip<4>(p, plan, st);
    case 5: return launch_bwd_onchip<5>(p, plan, st);
    case 6: return launch_bwd_onchip<6>(p, plan, st);
    case 7: return launch_bwd_onchip<7>(p, plan, st);
    default: return launch_bwd_onchip<8>(p, plan, st);
  }
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

// The plan vct_attn_backward follows for such a call: 7 ints, see BwdPlan.
int vct_attn_backward_plan(int dtype, int tk, int d, int has_keep, int route, int* out) {
  if (tk < 1 || d < 16 || d > MAX_D || d % 16) return (int)cudaErrorInvalidValue;
  BwdPlan plan;
  if (!backward_plan(dtype, tk, d, has_keep != 0, route, &plan)) return (int)cudaErrorInvalidValue;
  const int vals[7] = {plan.route, plan.tile_q, plan.tile_k, plan.stages, plan.smem_dq,
                       plan.smem_dkv, plan.threads};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

// g = dO [B, Tq, H, D] with its strides; stats from the forward; delta float32
// [B, H, Tq] scratch; dq, dk, dv contiguous outputs in the inputs' dtype;
// route as for the forward (-1: the rule of backward_plan).
int vct_attn_backward(int dtype, const void* q, const void* k, const void* v, const void* bias,
                      const void* keep, const void* g, const void* stats, void* delta, void* dq,
                      void* dk, void* dv, int b, int h, int tq, int tk, int d,
                      const int* strides, float scale, float keep_denom, int route,
                      void* stream) {
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
  return launch_backward_routed(dtype, p, route, st);
}

}  // extern "C"
