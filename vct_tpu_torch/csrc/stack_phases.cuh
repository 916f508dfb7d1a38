// Device code shared by the bfloat16 stack kernels on tensor cores
// (stack_step.cu: 65-2048 rows in 64 x 64 product units; small_step.cu:
// 1-64 rows in 8-column units with the generator inside): the product
// epilogue's stores, compensated sums, the staged single-query attention and
// the LayerNorm row pass. stack_step.cu's header describes the design.

#pragma once

#include "decode_common.cuh"
#include "mma_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int SK_DMAX = 128;           // widest head
constexpr int SK_EMAX = 1024;          // widest row a LayerNorm warp holds in registers
constexpr int SK_CH = 32;              // cache rows an attention warp stages at a time
// an attention warp's staging: q in float32, SK_CH key rows at a pitch of
// 2 D + 16 bytes (16-byte reads by 8 lanes of 8 rows fall in 8 bank groups),
// SK_CH value rows
constexpr int SK_WARP_ATTN = SK_DMAX * 4 + SK_CH * (SK_DMAX * 2 + 16) + SK_CH * SK_DMAX * 2;
constexpr int SK_ATTN = NWARPS * SK_WARP_ATTN;

// The small-row token path (small_step.cu): products in units of SS_G
// output columns over the whole K on mma.sync, the rows padded to m16 tiles
// (at most SS_MAX_ROWS), the A operand in chunks of SS_KC through a ring of
// SS_STAGES, each block's weight slice in one of two slots of SS_SLOT bytes
// (the next product's slice loads into the other while this one runs), at
// most SS_MAX_UNITS units a block per round; the work area holds the ring or
// the attention staging.
constexpr int SS_G = 8;
constexpr int SS_MAX_ROWS = 64;
constexpr int SS_KC = 256;
constexpr int SS_STAGES = 4;
constexpr int SS_ALD = SS_KC + 8;   // elements: 16 bytes past a multiple of 128
constexpr int SS_ASTAGE = SS_MAX_ROWS * SS_ALD * 2;
constexpr int SS_RING = SS_STAGES * SS_ASTAGE;
constexpr int SS_SLOT = 36864;
constexpr int SS_MAX_K = SS_SLOT / (SS_G * 2);   // 2304: the deepest K of one unit's slice
constexpr int SS_MAX_UNITS = 3;
constexpr int SS_WORK = SS_RING > SK_ATTN ? SS_RING : SK_ATTN;
constexpr int SS_SMEM = 2 * SS_SLOT + SS_WORK;

// The rule for the small-row path at these widths, as a plan's ``why``: 0 it
// runs; 1 route 0 asked for; 2 float32; 3 rows above SS_MAX_ROWS; 4 a width
// (E or F) that is not a multiple of 64; 5 E above SK_EMAX; 6 a head width
// that is not a multiple of 8 or is above SK_DMAX; 7 F above SS_MAX_K (one
// unit's slice outgrows a slot).
inline int small_why(int dtype, int B, int E, int H, int F, int route) {
  const int D = E / H;
  if (route == 0) return 1;
  if (dtype != 1) return 2;
  if (B > SS_MAX_ROWS) return 3;
  if (E % 64 || F % 64) return 4;
  if (E > SK_EMAX) return 5;
  if (D % 8 || D > SK_DMAX) return 6;
  if (F > SS_MAX_K) return 7;
  return 0;
}

enum { EP_QKV = 0, EP_F32 = 1, EP_RESID = 2, EP_GELU = 3 };
// s + x with the rounding error carried in c (Kahan)
__device__ __forceinline__ void add_compensated(float& s, float& c, float x) {
  const float y = x - c, t = s + y;
  c = (t - s) - y;
  s = t;
}

struct Prod {
  const bf16* A; int K;                  // [B, K]
  const bf16* W; const bf16* bias; int N;  // [K, N], [N]
  int ep;
  float* dst;          // EP_QKV: q [B, E]; EP_F32, EP_RESID: [B, N]
  bf16* dst_b;         // EP_GELU: [B, N]
  const float* res_f;  // EP_RESID: the residual in float32, or
  const bf16* res_b;   //           in bfloat16
  bf16* kc_row;        // EP_QKV: cache row idx of the layer [B, E], or null
  bf16* vc_row;
};

// out[row, col .. col + 1] of a product's epilogue; v0, v1 hold the bias, r
// the residual (EP_RESID)
__device__ __forceinline__ void prod_store(const Prod& m, int row, int col, float v0, float v1,
                                           float2 r) {
  if (m.ep == EP_QKV) {
    const int E = m.N / 3;
    if (col < E) {
      *reinterpret_cast<float2*>(m.dst + (size_t)row * E + col) = make_float2(v0, v1);
    } else {
      bf16* cache = col < 2 * E ? m.kc_row : m.vc_row;
      if (cache)
        *reinterpret_cast<__nv_bfloat162*>(cache + (size_t)row * E + col % E) =
            __floats2bfloat162_rn(v0, v1);
    }
    return;
  }
  const size_t o = (size_t)row * m.N + col;
  if (m.ep == EP_F32) {
    *reinterpret_cast<float2*>(m.dst + o) = make_float2(v0, v1);
  } else if (m.ep == EP_RESID) {
    *reinterpret_cast<float2*>(m.dst + o) = make_float2(r.x + v0, r.y + v1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(m.dst_b + o) =
        __floats2bfloat162_rn(gelu_exact(v0), gelu_exact(v1));
  }
}

// Single-query attention, one warp per (row b, head h) over cache rows 0 ..
// nrows - 1 of kc / vc [rows, B, E]; q [B, E] float32; bias [B, bias_ld] or
// null. out [B, E] bfloat16. The warp stages q and SK_CH key and value rows
// at a time in its shared memory with one round of cp.async, lane j forms the
// logit of row j, and the softmax runs over the chunks online (max, then the
// sum and the weighted values rescaled to it); the lanes split the head's
// columns in pairs for the weighted sum.
__device__ void attention_phase_tc(const float* q, const bf16* kc, const bf16* vc, int nrows,
                                   const float* bias, int bias_ld, int B, int E, int H, bf16* out,
                                   unsigned char* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = E / H, pieces = D / 8, kld = 2 * D + 16;
  const float scale = rsqrtf((float)D);
  float* qs = reinterpret_cast<float*>(smem + warp * SK_WARP_ATTN);
  unsigned char* ks = reinterpret_cast<unsigned char*>(qs + SK_DMAX);
  const bf16* vs = reinterpret_cast<const bf16*>(ks + SK_CH * (SK_DMAX * 2 + 16));
  const size_t row_stride = (size_t)B * E;
  for (int u = blockIdx.x * NWARPS + warp; u < B * H; u += gridDim.x * NWARPS) {
    const int b = u / H, h = u % H;
    const size_t off = (size_t)b * E + h * D;
    float m = -INFINITY, sum = 0.f;
    float o[SK_DMAX / 64][2] = {};   // columns 2 lane + 64 p, + 1
    for (int j0 = 0; j0 < nrows; j0 += SK_CH) {
      const int n = min(SK_CH, nrows - j0);
      __syncwarp();   // every lane is done with the last chunk's staging
      if (j0 == 0)
        for (int i = lane; i < D / 4; i += 32) cp_async16(qs + 4 * i, q + off + 4 * i, true);
      for (int i = lane; i < n * pieces; i += 32) {
        const int r = i / pieces, c = i - r * pieces;
        const size_t src = (size_t)(j0 + r) * row_stride + off + c * 8;
        cp_async16(ks + r * kld + c * 16, kc + src, true);
        cp_async16((unsigned char*)vs + (r * D + c * 8) * 2, vc + src, true);
      }
      cp_async_commit();
      const float bj = (bias && lane < n) ? bias[(size_t)b * bias_ld + j0 + lane] : 0.f;
      cp_async_wait<0>();
      __syncwarp();
      float lg = -INFINITY;
      if (lane < n) {
        const unsigned char* kr = ks + lane * kld;
        float d = 0.f;
        for (int t = 0; t < D; t += 8) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + 2 * t);
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 kv = __bfloat1622float2(k2[i]);
            d += qs[t + 2 * i] * kv.x;
            d += qs[t + 2 * i + 1] * kv.y;
          }
        }
        lg = d * scale + bj;
      }
      const float mn = fmaxf(m, warp_max(lg));
      const float keep = expf(m - mn);   // 0 on the first chunk
      const float e = lane < n ? expf(lg - mn) : 0.f;
      sum = sum * keep + warp_sum(e);
#pragma unroll
      for (int p = 0; p < SK_DMAX / 64; ++p) {
        o[p][0] *= keep;
        o[p][1] *= keep;
      }
      for (int jj = 0; jj < n; ++jj) {
        const float w = __shfl_sync(0xffffffffu, e, jj);
#pragma unroll
        for (int p = 0; p < SK_DMAX / 64; ++p) {
          const int t = 2 * lane + 64 * p;
          if (t < D) {
            const float2 v2 =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vs + jj * D + t));
            o[p][0] += w * v2.x;
            o[p][1] += w * v2.y;
          }
        }
      }
      m = mn;
    }
#pragma unroll
    for (int p = 0; p < SK_DMAX / 64; ++p) {
      const int t = 2 * lane + 64 * p;
      if (t < D)
        *reinterpret_cast<__nv_bfloat162*>(out + off + t) =
            __floats2bfloat162_rn(o[p][0] / sum, o[p][1] / sum);
    }
  }
}

// LayerNorm of each row of src [B, E] float32, one warp per row holding it in
// registers (E <= SK_EMAX, a multiple of 4): float32 statistics in two
// passes, then y = (x - mean) * rsqrt(var + eps) * gam + bet. Writes y in
// float32 to dst_f and rounded to bfloat16 to dst_b (either may be null), and
// to out rounded, or NaN with ``poison`` (out may be null).
__device__ void layernorm_phase(const float* src, int B, int E, const float* gam,
                                const float* bet, float* dst_f, bf16* dst_b, bf16* out,
                                bool poison) {
  constexpr int C = SK_EMAX / 128;   // float4 pieces a lane holds
  const int lane = threadIdx.x & 31;
  const int E4 = E / 4;
  for (int b = blockIdx.x * NWARPS + (threadIdx.x >> 5); b < B; b += gridDim.x * NWARPS) {
    const float4* r = reinterpret_cast<const float4*>(src + (size_t)b * E);
    float4 x[C], g4[C], b4[C];   // the row, and its scale and shift asked for with it
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = lane + 32 * i;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      x[i] = c < E4 ? __ldcg(r + c) : z;
      g4[i] = c < E4 ? reinterpret_cast<const float4*>(gam)[c] : z;
      b4[i] = c < E4 ? reinterpret_cast<const float4*>(bet)[c] : z;
    }
#pragma unroll
    for (int i = 0; i < C; ++i) s += (x[i].x + x[i].y) + (x[i].z + x[i].w);
    const float mean = warp_sum(s) / (float)E;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (lane + 32 * i < E4) {
        const float d0 = x[i].x - mean, d1 = x[i].y - mean, d2 = x[i].z - mean,
                    d3 = x[i].w - mean;
        sq += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
      }
    }
    const float rs = rsqrtf(warp_sum(sq) / (float)E + LN_EPS);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = lane + 32 * i;
      if (c >= E4) continue;
      const float4 y = make_float4((x[i].x - mean) * rs * g4[i].x + b4[i].x,
                                   (x[i].y - mean) * rs * g4[i].y + b4[i].y,
                                   (x[i].z - mean) * rs * g4[i].z + b4[i].z,
                                   (x[i].w - mean) * rs * g4[i].w + b4[i].w);
      const size_t o = (size_t)b * E + 4 * c;
      if (dst_f) *reinterpret_cast<float4*>(dst_f + o) = y;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y), hi = __floats2bfloat162_rn(y.z, y.w);
      if (dst_b) {
        reinterpret_cast<__nv_bfloat162*>(dst_b + o)[0] = lo;
        reinterpret_cast<__nv_bfloat162*>(dst_b + o)[1] = hi;
      }
      if (out) {
        const float nan = __int_as_float(0x7fc00000);
        reinterpret_cast<__nv_bfloat162*>(out + o)[0] = poison ? __floats2bfloat162_rn(nan, nan) : lo;
        reinterpret_cast<__nv_bfloat162*>(out + o)[1] = poison ? __floats2bfloat162_rn(nan, nan) : hi;
      }
    }
  }
}

}  // namespace
