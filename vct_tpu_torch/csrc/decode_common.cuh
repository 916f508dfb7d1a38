// Device code shared by the decode kernels (decode_step.cu, decode_multi.cu,
// gen_topk.cu): rounding helpers, the warp LayerNorm, the hand-written
// matvec tile, the phases of one decode step and ``decode_token``, which
// strings them into one token through the decoder stack (and, for the
// generating kernels, the final norm, the vocab projection and the argmax).
// decode_step.cu's header describes the design.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NTHREADS 256
#define NWARPS 8
#define BT 8      // batch rows per matvec unit (one warp loads one row)
#define TN 32     // output columns per matvec unit (one lane, one column)
#define LMAX 1024 // longest attention span (self cache rows or memory slots)
#define LN_EPS 1e-5f

typedef unsigned long long u64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
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

__device__ __forceinline__ u64 warp_max_u64(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    u64 w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// (order-preserving float bits << 32) | (0xFFFFFFFF - index): a larger key is
// a larger value or, among equal values, a lower index. 0 is below every key.
__device__ __forceinline__ u64 argmax_key(float v, int n) {
  v = v + 0.0f;  // -0 -> +0: the two compare equal in the reference
  unsigned int u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (u64)(0xFFFFFFFFu - (unsigned int)n);
}

__device__ __forceinline__ int key_index(u64 key) {
  return (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull));
}

__device__ __forceinline__ float key_value(u64 key) {
  const unsigned int u = (unsigned int)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

// LayerNorm of one row (length E) by one warp; fp32 statistics, two passes
// (mean, then the mean of squared deviations), then (x - mean) * rsqrt(var +
// eps) * g + b. ``round`` rounds the result to the compute dtype T. dst2 (if
// set) receives a copy, rounded only if ``round2``.
template <typename T, typename S>
__device__ void warp_layernorm(const S* src, int E, const float* g, const float* b,
                               bool round, float* dst, float* dst2, bool round2 = false) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int k = lane; k < E; k += 32) s += to_f(src[k]);
  const float mean = warp_sum(s) / (float)E;
  float q = 0.f;
  for (int k = lane; k < E; k += 32) {
    const float d = to_f(src[k]) - mean;
    q += d * d;
  }
  const float rs = rsqrtf(warp_sum(q) / (float)E + LN_EPS);
  for (int k = lane; k < E; k += 32) {
    const float y = (to_f(src[k]) - mean) * rs * g[k] + b[k];
    dst[k] = round ? round_t<T>(y) : y;
    if (dst2) dst2[k] = round2 ? round_t<T>(y) : y;
  }
}

// One (TN columns x BT rows) tile of xs[BT][K] @ W[K, N]. Each lane loads 16
// bytes of one weight row (VW = 8 bf16 or 4 fp32 columns), so a warp reads
// 32 / LPR rows of the tile per load instruction; warp w takes the row blocks
// w, w + NWARPS, ... The partial sums meet first across the lanes that share
// columns (shuffles), then across warps in ``red``. Returns the finished dot
// product for row = warp, column = ct * TN + lane (0 past N). The caller has
// synchronised after filling xs; N and the row pointers are multiples of VW.
template <typename T>
__device__ float matvec_tile(const float* xs, int K, const T* W, int N, int ct,
                             float* red) {
  constexpr int VW = 16 / sizeof(T);  // columns per 16-byte load
  constexpr int LPR = TN / VW;        // lanes per weight row of the tile
  constexpr int RPI = 32 / LPR;       // weight rows per warp load
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cl = (lane % LPR) * VW;   // this lane's first column in the tile
  const int c0 = ct * TN + cl;
  float acc[BT][VW];
#pragma unroll
  for (int r = 0; r < BT; ++r)
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[r][j] = 0.f;
  if (c0 < N) {
    const T* wp = W + c0;
#pragma unroll 2
    for (int k = warp * RPI + lane / LPR; k < K; k += NWARPS * RPI) {
      const uint4 raw = *reinterpret_cast<const uint4*>(wp + (size_t)k * N);
      const T* wv = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float xv = xs[r * K + k];
#pragma unroll
        for (int j = 0; j < VW; ++j) acc[r][j] += xv * to_f(wv[j]);
      }
    }
  }
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int j = 0; j < VW; ++j) acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], o);
  __syncthreads();  // the previous tile's readers of red are done
  if (lane < LPR) {
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int j = 0; j < VW; ++j) red[(warp * BT + r) * TN + cl + j] = acc[r][j];
  }
  __syncthreads();
  float v = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) v += red[(w * BT + warp) * TN + lane];
  return v;
}

// ---------------------------------------------------------------------------
// the phases of one decode step
// ---------------------------------------------------------------------------

struct StepArgs {
  const void* x;      // [B, E] T
  void* kc;           // [NL, L, B, E] T (row idx written)
  void* vc;
  const void* ck;     // [NL, Tm, B, E] T
  const void* cv;
  const float* mem_bias;  // [B, Tm] or null
  const void* wqkv; const void* bqkv;  // [NL, E, 3E], [NL, 3E]
  const void* wo; const void* bo;      // [NL, E, E], [NL, E]
  const void* wcq; const void* bcq;
  const void* wco; const void* bco;
  const float* n1s; const float* n1b; const float* n2s; const float* n2b;
  const void* w1; const void* b1;      // [NL, E, F], [NL, F]
  const void* w2; const void* b2;      // [NL, F, E], [NL, E]
  const float* n3s; const float* n3b;
  const float* norm_s; const float* norm_b;  // final LayerNorm (gen only)
  const void* wg; const float* bg;           // [E, V] T, [V] f32 (gen only)
  void* out;          // gen ? int32 tokens : T [B, E] x_out
  float* scratch;     // f32 [B * (5E + F)]
  u64* keys;          // [B] per generated token (gen only)
  int B, E, H, F, NL, L, Tm, V, idx, l_view, gen;
};

// Where the first product of a token reads its rows from when it is not
// ``StepArgs.x``: the embedding row of ``cur[b]`` (zero for ``pad_id`` or an
// id past the table) plus the position's row, summed in fp32 and rounded once.
struct EmbedIn {
  const void* emb;    // [n_emb, E] T
  const void* pe_row; // [E] T
  const int* cur;     // [B] token ids (may live in shared memory)
  int n_emb, pad_id;
};

enum { IN_T = 0, IN_F32 = 1, IN_LN = 2, IN_EMB = 3 };
enum { OUT_QKV = 0, OUT_F32 = 1, OUT_RESID = 2, OUT_GELU = 3, OUT_ARGMAX = 4 };

struct Matvec {
  int in_mode;
  const void* in;       // [B, K]: T (IN_T) or f32; an EmbedIn (IN_EMB)
  const float* ln_g; const float* ln_b;  // IN_LN
  float* res_out;       // if set, column-tile-0 units store the loaded rows here:
  int res_round;        // IN_LN: the LayerNorm output rounded to T (a layer's
                        // input x) or in fp32 (x1, x2 inside a layer)
  const void* W; const void* bias; int bias_f32;
  int K, N;
  int out_mode;
  float* dst;           // [B, N] (OUT_F32/RESID/GELU) or q rows (OUT_QKV)
  const float* res_in;  // OUT_RESID
  void* kc_row; void* vc_row;  // OUT_QKV: cache row idx of this layer, or null
};

template <typename T>
__device__ void matvec_phase(const Matvec& m, int B, u64* keys, float* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_ct = (m.N + TN - 1) / TN, n_bt = (B + BT - 1) / BT;
  float* xs = smem;
  float* red = smem + BT * m.K;
  for (int u = blockIdx.x; u < n_ct * n_bt; u += gridDim.x) {
    const int bt = u % n_bt, ct = u / n_bt;
    __syncthreads();  // the previous unit is done with xs
    {
      const int b = bt * BT + warp;
      float* row = xs + warp * m.K;
      float* res = (m.res_out && ct == 0 && b < B) ? m.res_out + (size_t)b * m.K : nullptr;
      if (b >= B) {
        for (int k = lane; k < m.K; k += 32) row[k] = 0.f;
      } else if (m.in_mode == IN_T) {
        const T* src = (const T*)m.in + (size_t)b * m.K;
        for (int k = lane; k < m.K; k += 32) {
          row[k] = to_f(src[k]);
          if (res) res[k] = row[k];
        }
      } else if (m.in_mode == IN_EMB) {
        const EmbedIn* e = (const EmbedIn*)m.in;
        const int tok = e->cur[b];
        const bool zero = tok == e->pad_id || tok < 0 || tok >= e->n_emb;
        const T* src = (const T*)e->emb + (size_t)(zero ? 0 : tok) * m.K;
        const T* pr = (const T*)e->pe_row;
        for (int k = lane; k < m.K; k += 32) {
          row[k] = round_t<T>((zero ? 0.f : to_f(src[k])) + to_f(pr[k]));
          if (res) res[k] = row[k];
        }
      } else if (m.in_mode == IN_F32) {
        const float* src = (const float*)m.in + (size_t)b * m.K;
        for (int k = lane; k < m.K; k += 32) row[k] = src[k];
      } else {
        warp_layernorm<T, float>((const float*)m.in + (size_t)b * m.K, m.K, m.ln_g,
                                 m.ln_b, true, row, res, m.res_round != 0);
      }
    }
    __syncthreads();
    float v = matvec_tile<T>(xs, m.K, (const T*)m.W, m.N, ct, red);
    const int b = bt * BT + warp, n = ct * TN + lane;
    const bool ok = b < B && n < m.N;
    if (ok) v += m.bias_f32 ? ((const float*)m.bias)[n] : to_f(((const T*)m.bias)[n]);
    if (m.out_mode == OUT_ARGMAX) {
      u64 key = warp_max_u64(ok ? argmax_key(v, n) : 0ull);
      if (lane == 0 && b < B) atomicMax(keys + b, key);
      continue;
    }
    if (!ok) continue;
    const size_t o = (size_t)b * m.N + n;
    if (m.out_mode == OUT_QKV) {
      const int E = m.N / 3;
      if (n < E) {
        m.dst[(size_t)b * E + n] = v;
      } else if (n < 2 * E) {
        if (m.kc_row) ((T*)m.kc_row)[(size_t)b * E + n - E] = from_f<T>(v);
      } else {
        if (m.vc_row) ((T*)m.vc_row)[(size_t)b * E + n - 2 * E] = from_f<T>(v);
      }
    } else if (m.out_mode == OUT_F32) {
      m.dst[o] = v;
    } else if (m.out_mode == OUT_RESID) {
      m.dst[o] = m.res_in[o] + v;
    } else {  // OUT_GELU
      m.dst[o] = round_t<T>(gelu_exact(v));
    }
  }
}

// Single-query multi-head attention: one warp per (row b, head h) over
// cache rows 0..nrows-1 of kc/vc [rows, B, E]; q [B, E] f32; bias [B, ld]
// or null. out [B, E] f32 holding values rounded to T.
template <typename T>
__device__ void attention_phase(const float* q, const T* kc, const T* vc, int nrows,
                                const float* bias, int bias_ld, int B, int E, int H,
                                float* out, float* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = E / H;
  const float scale = rsqrtf((float)D);
  float* s = smem + warp * LMAX;
  for (int u = blockIdx.x * NWARPS + warp; u < B * H; u += gridDim.x * NWARPS) {
    const int b = u / H, h = u % H;
    const float* qp = q + (size_t)b * E + h * D;
    float m = -__int_as_float(0x7f800000);  // -inf
    for (int j = 0; j < nrows; ++j) {
      const T* kp = kc + ((size_t)j * B + b) * E + h * D;
      float d = 0.f;
      for (int t = lane; t < D; t += 32) d += qp[t] * to_f(kp[t]);
      float lg = warp_sum(d) * scale;
      if (bias) lg += bias[(size_t)b * bias_ld + j];
      if (lane == 0) s[j] = lg;
      m = fmaxf(m, lg);
    }
    __syncwarp();
    float sum = 0.f;
    for (int j = lane; j < nrows; j += 32) {
      const float e = expf(s[j] - m);
      s[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    for (int t = lane; t < D; t += 32) {
      float o = 0.f;
      for (int j = 0; j < nrows; ++j)
        o += (s[j] / sum) * to_f(vc[((size_t)j * B + b) * E + h * D + t]);
      out[(size_t)b * E + h * D + t] = round_t<T>(o);
    }
    __syncwarp();
  }
}

// One token at position ``idx`` through the NL layers of the stack, every
// block of a cooperative grid together. The first product reads ``a.x``, or
// the embedding of ``emb->cur`` when ``emb`` is set. Each layer writes cache
// row idx in place before it attends rows 0..min(idx, l_view - 1); the
// grid.sync() after the write makes the row visible grid-wide, so a loop of
// calls needs no in-register patch of fresh rows. Without ``a.gen`` the
// result goes to a.out (NaN when idx >= l_view); with it, the argmax keys of
// the padded vocab go to ``keys`` [B], which must hold zeros on entry, and
// are complete after the grid.sync() this function ends with.
template <typename T>
__device__ void decode_token(const StepArgs& a, cg::grid_group& grid, float* smem, int idx,
                             const EmbedIn* emb, u64* keys) {
  const int B = a.B, E = a.E, F = a.F;
  float* qbuf = a.scratch;             // q / cross q, f32
  float* abuf = qbuf + (size_t)B * E;  // attention output (rounded)
  float* rbuf = abuf + (size_t)B * E;  // residual sum into the next LayerNorm
  float* xres = rbuf + (size_t)B * E;  // residual stream input
  float* hbuf = xres + (size_t)B * E;  // FFN hidden (rounded)
  float* ynbuf = hbuf + (size_t)B * F; // final-norm output (gen)
  const bool poison = idx >= a.l_view;
  const int nself = min(idx + 1, a.l_view);
  const size_t LBE = (size_t)a.L * B * E, TBE = (size_t)a.Tm * B * E;
  const size_t EE = (size_t)E * E;

  for (int li = 0; li < a.NL; ++li) {
    T* kc = (T*)a.kc + li * LBE;
    T* vc = (T*)a.vc + li * LBE;
    const T* ck = (const T*)a.ck + li * TBE;
    const T* cv = (const T*)a.cv + li * TBE;
    Matvec m;
    m.res_out = nullptr; m.res_in = nullptr; m.kc_row = nullptr; m.vc_row = nullptr;
    m.bias_f32 = 0; m.ln_g = nullptr; m.ln_b = nullptr; m.res_round = 1;

    // 1. packed QKV; the fresh K/V row goes into the cache at idx
    if (li == 0) {
      if (emb) {
        m.in_mode = IN_EMB; m.in = emb;
      } else {
        m.in_mode = IN_T; m.in = a.x;
      }
    } else {
      m.in_mode = IN_LN; m.in = rbuf;
      m.ln_g = a.n3s + (size_t)(li - 1) * E; m.ln_b = a.n3b + (size_t)(li - 1) * E;
    }
    m.res_out = xres;
    m.W = (const T*)a.wqkv + li * 3 * EE; m.bias = (const T*)a.bqkv + (size_t)li * 3 * E;
    m.K = E; m.N = 3 * E; m.out_mode = OUT_QKV; m.dst = qbuf;
    if (idx < a.L) {
      m.kc_row = kc + (size_t)idx * B * E;
      m.vc_row = vc + (size_t)idx * B * E;
    }
    matvec_phase<T>(m, B, keys, smem);
    grid.sync();

    // 2. causal self-attention over rows 0..min(idx, l_view - 1)
    attention_phase<T>(qbuf, kc, vc, nself, nullptr, 0, B, E, a.H, abuf, smem);
    grid.sync();

    // 3. out-projection + residual
    m.in_mode = IN_F32; m.in = abuf; m.res_out = nullptr;
    m.W = (const T*)a.wo + li * EE; m.bias = (const T*)a.bo + (size_t)li * E;
    m.K = E; m.N = E; m.out_mode = OUT_RESID; m.dst = rbuf; m.res_in = xres;
    matvec_phase<T>(m, B, keys, smem);
    grid.sync();

    // 4. x1 = norm1(...) -> cross-attention query
    m.in_mode = IN_LN; m.in = rbuf; m.res_out = xres; m.res_round = 0;
    m.ln_g = a.n1s + (size_t)li * E; m.ln_b = a.n1b + (size_t)li * E;
    m.W = (const T*)a.wcq + li * EE; m.bias = (const T*)a.bcq + (size_t)li * E;
    m.out_mode = OUT_F32; m.dst = qbuf;
    matvec_phase<T>(m, B, keys, smem);
    grid.sync();

    // 5. cross-attention over the memory with its padding bias
    attention_phase<T>(qbuf, ck, cv, a.Tm, a.mem_bias, a.Tm, B, E, a.H, abuf, smem);
    grid.sync();

    // 6. cross out-projection + residual
    m.in_mode = IN_F32; m.in = abuf; m.res_out = nullptr;
    m.W = (const T*)a.wco + li * EE; m.bias = (const T*)a.bco + (size_t)li * E;
    m.out_mode = OUT_RESID; m.dst = rbuf; m.res_in = xres;
    matvec_phase<T>(m, B, keys, smem);
    grid.sync();

    // 7. x2 = norm2(...) -> FFN up-projection + exact GELU
    m.in_mode = IN_LN; m.in = rbuf; m.res_out = xres; m.res_round = 0;
    m.ln_g = a.n2s + (size_t)li * E; m.ln_b = a.n2b + (size_t)li * E;
    m.W = (const T*)a.w1 + (size_t)li * E * F; m.bias = (const T*)a.b1 + (size_t)li * F;
    m.K = E; m.N = F; m.out_mode = OUT_GELU; m.dst = hbuf;
    matvec_phase<T>(m, B, keys, smem);
    grid.sync();

    // 8. FFN down-projection + residual (norm3 is applied by the next loader)
    m.in_mode = IN_F32; m.in = hbuf; m.res_out = nullptr;
    m.W = (const T*)a.w2 + (size_t)li * F * E; m.bias = (const T*)a.b2 + (size_t)li * E;
    m.K = F; m.N = E; m.out_mode = OUT_RESID; m.dst = rbuf; m.res_in = xres;
    matvec_phase<T>(m, B, keys, smem);
    grid.sync();
  }

  // final norm3 of the last layer, one warp per row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* g3 = a.n3s + (size_t)(a.NL - 1) * E;
  const float* b3 = a.n3b + (size_t)(a.NL - 1) * E;
  for (int b = blockIdx.x * NWARPS + warp; b < B; b += gridDim.x * NWARPS) {
    float* xrow = xres + (size_t)b * E;
    warp_layernorm<T, float>(rbuf + (size_t)b * E, E, g3, b3, true, xrow, nullptr);
    __syncwarp();
    if (!a.gen) {
      T* o = (T*)a.out + (size_t)b * E;
      for (int k = lane; k < E; k += 32) o[k] = from_f<T>(poison ? __int_as_float(0x7fc00000) : xrow[k]);
    } else {
      warp_layernorm<T, float>(xrow, E, a.norm_s, a.norm_b, false,
                               ynbuf + (size_t)b * E, nullptr);
    }
  }
  if (!a.gen) return;
  grid.sync();

  // generator + argmax over the padded vocab
  Matvec g;
  g.in_mode = IN_F32; g.in = ynbuf; g.res_out = nullptr; g.ln_g = nullptr; g.ln_b = nullptr;
  g.res_round = 0;
  g.W = a.wg; g.bias = a.bg; g.bias_f32 = 1; g.K = E; g.N = a.V;
  g.out_mode = OUT_ARGMAX; g.dst = nullptr; g.res_in = nullptr;
  g.kc_row = nullptr; g.vc_row = nullptr;
  matvec_phase<T>(g, B, keys, smem);
  grid.sync();
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// dynamic shared memory of the phases: the loaded rows, the cross-warp
// reduction and the attention weights
static inline size_t step_smem_bytes(int E, int F) {
  const int kmax = E > F ? E : F;
  return sizeof(float) * ((size_t)BT * kmax + (size_t)NWARPS * BT * TN + (size_t)NWARPS * LMAX);
}

// A cooperative launch of ``kernel(args)`` with every block resident, as
// grid.sync() needs: two blocks per SM keep loads in flight without making
// each barrier slower.
template <typename K, typename A>
static cudaError_t launch_cooperative(K kernel, const A& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = sms * (per_sm < 2 ? per_sm : 2);
  A args = a;
  void* params[] = {(void*)&args};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(NTHREADS), params,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the argument pointers of StepArgs from x to keys, in order (31 entries;
// unused ones may be null)
static inline void fill_step_args(StepArgs& a, void* const* t) {
  a.x = t[0]; a.kc = t[1]; a.vc = t[2]; a.ck = t[3]; a.cv = t[4];
  a.mem_bias = (const float*)t[5];
  a.wqkv = t[6]; a.bqkv = t[7]; a.wo = t[8]; a.bo = t[9];
  a.wcq = t[10]; a.bcq = t[11]; a.wco = t[12]; a.bco = t[13];
  a.n1s = (const float*)t[14]; a.n1b = (const float*)t[15];
  a.n2s = (const float*)t[16]; a.n2b = (const float*)t[17];
  a.w1 = t[18]; a.b1 = t[19]; a.w2 = t[20]; a.b2 = t[21];
  a.n3s = (const float*)t[22]; a.n3b = (const float*)t[23];
  a.norm_s = (const float*)t[24]; a.norm_b = (const float*)t[25];
  a.wg = t[26]; a.bg = (const float*)t[27];
  a.out = t[28]; a.scratch = (float*)t[29]; a.keys = (u64*)t[30];
}
