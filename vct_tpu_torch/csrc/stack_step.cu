// The bfloat16 decoder-stack step on tensor cores for Hopper (sm_90a), bound
// through a plain C interface (ctypes). Python side:
// vct_tpu_torch/ops/decode_kernels.py (``fused_layers_step``,
// ``stack_step_plan``).
//
// Replaces (vct_tpu/ops/pallas_decode.py): fused_layers_step (:516,
// _layers_step_kernel :373 via _stack_layers :322) in bfloat16, where
// decode_step.cu's decode_step_kernel served it with products on the CUDA
// cores. float32, and any shape past the plan's limits, keep that kernel
// (route 0), which also stays reachable for same-run timing.
//
// What bounds it on an H100: one token through NL = 3 layers at the MSVD
// widths reads 40 MB of weights (12 us of HBM) and does 2 x rows x 20 M
// operations (10.3 GFLOP at 256 beam rows, 10 us at 989 TFLOP/s); every
// product needs the whole previous row, so the layer is a chain of phases.
// decode_step_kernel spent 1.31 ms at 256 rows: fp32 FMAs, each weight tile
// read again for every 8 rows, LayerNorm recomputed by every column tile,
// attention walking the cache rows one after another.
//
// Design: one cooperative launch per call, one block per SM, phases separated
// by grid.sync():
//   QKV | self-attention | Wo + residual | LN1 | Wcq | cross-attention |
//   Wco + residual | LN2 | W1 + GELU | W2 + residual | LN3
// * A product phase runs units of 64 rows x 64 output columns over the whole
//   K on mma.sync m16n8k16 (bfloat16 operands, float32 accumulation; each
//   64-deep K step summed from zero and added to float32 registers, with
//   compensation past K = 1024). The A
//   operand is a bfloat16 activation [rows, K] in global scratch, written
//   whole by the phase before (every A operand is already rounded where the
//   reference rounds: the layer input, the attention outputs, the LayerNorm
//   outputs and the GELU output), so the loader is a plain cp.async of it;
//   the weight tile [64 k][64 n] comes through the same 4-stage ring and is
//   read by ldmatrix.trans as the B operand. A weight tile crosses into a
//   block once per 64 rows (4 times at 256 rows, not 32), and the units of
//   one column tile run next to each other, so L2 serves all but the first.
// * LayerNorm runs once per row in a row pass after the residual phase: one
//   warp holds its row (and the scale and shift, asked for with it) in
//   registers, two-pass float32 statistics, and writes the float32 output
//   (the next residual) and its bfloat16 rounding (the next A operand).
// * Attention gives one warp to each (row, head): q and 32 key and value rows
//   at a time reach its shared memory in one round of cp.async, lane j forms
//   the logit of row j, and the softmax runs online over the chunks; the
//   lanes split the head's columns for the weighted sum.
// * The fresh K/V row goes into the cache at idx in the QKV epilogue, before
//   attention over rows < min(idx + 1, l_view); x_out is NaN when idx >=
//   l_view. Data produced inside the launch is read with L2-only loads.
// What the time is (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// --stack-variant on a copy that stamps %globaltimer after each barrier): 32
// barriers take 0.04 ms; each phase then costs a few dependent
// trips to memory (a LayerNorm pass 3-4 us, attention 7-8, a product 9-10 at
// K = 768 whatever its unit count), so the call is bound by its chain of 33
// phases, not by its bytes or operations. Splitting K across more blocks,
// deeper rings, two blocks per SM and non-inlined phases did not help.
// Rounding points are decode_step.cu's: the products, their sums with the
// residual and the LayerNorm statistics in float32; the cache rows, the
// attention outputs, the LayerNorm outputs that feed a product, the GELU
// output and x_out in bfloat16. Only the order of the float32 sums changes.
// Every sum has one order, so two calls give the same bits.

#include "decode_common.cuh"
#include "mma_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int SK_BM = 64;              // rows of a product unit
constexpr int SK_BN = 64;              // output columns of a product unit
constexpr int SK_BK = 64;              // K step
constexpr int SK_STAGES = 4;
// pitches of a stage's A tile [SK_BM rows][SK_BK k] and weight tile [SK_BK k]
// [SK_BN n], elements: 16 bytes past a multiple of 128, so the eight rows an
// ldmatrix reads fall in eight bank groups
constexpr int SK_ALD = SK_BK + 8;
constexpr int SK_WLD = SK_BN + 8;
constexpr int SK_A_BYTES = SK_BM * SK_ALD * 2;
constexpr int SK_STAGE = SK_A_BYTES + SK_BK * SK_WLD * 2;
constexpr int SK_DMAX = 128;           // widest head
constexpr int SK_EMAX = 1024;          // widest row a LayerNorm warp holds in registers
constexpr int SK_CH = 32;              // cache rows an attention warp stages at a time
// an attention warp's staging: q in float32, SK_CH key rows at a pitch of
// 2 D + 16 bytes (16-byte reads by 8 lanes of 8 rows fall in 8 bank groups),
// SK_CH value rows
constexpr int SK_WARP_ATTN = SK_DMAX * 4 + SK_CH * (SK_DMAX * 2 + 16) + SK_CH * SK_DMAX * 2;
constexpr int SK_RING = SK_STAGES * SK_STAGE;
constexpr int SK_ATTN = NWARPS * SK_WARP_ATTN;
constexpr int SK_SMEM = SK_RING > SK_ATTN ? SK_RING : SK_ATTN;
// Rows it takes: greedy decode sends 65 and more to fused_layers_step (64 and
// fewer run the whole-step kernel, whose stack is decode_step_kernel's), and
// beam search up to 64 videos x a beam of 32. At 64 rows and fewer the stack
// keeps decode_step_kernel's summation order, so that beam search at width 1
// gives greedy decode's tokens at every batch size.
constexpr int STACK_MIN_ROWS = 65;
constexpr int STACK_MAX_ROWS = 2048;

enum { EP_QKV = 0, EP_F32 = 1, EP_RESID = 2, EP_GELU = 3 };
constexpr int SK_COMP_K = 1024;   // a deeper K adds its steps' sums with compensation

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

// A [B, K] . W [K, N] + bias, in units of 64 rows x 64 columns; warp w takes
// rows 16 (w % 4) and columns 32 (w / 4) of a unit. K and N are multiples of
// 64. A phase costs a few dependent trips to memory more than its K loop, so
// the residual an epilogue adds is asked for before the loop starts.
// COMPENSATE: the K steps' sums are added with compensation (K past
// SK_COMP_K: the FFN's down-projection, 32 steps at F = 2048), which keeps
// the deepest sum as close to the exact one as the short ones; every
// instruction in the loop lengthens each step's chain, so the short products
// go without.
template <bool COMPENSATE>
__device__ void product_phase(const Prod& m, int B, unsigned char* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3, wc = warp >> 2, g = lane >> 2, q = lane & 3;
  const int n_rt = (B + SK_BM - 1) / SK_BM, n_ct = m.N / SK_BN, ksteps = m.K / SK_BK;
  for (int u = blockIdx.x; u < n_rt * n_ct; u += gridDim.x) {
    const int rt = u % n_rt, ct = u / n_rt;   // the row tiles of a column tile side by side
    const int r0 = rt * SK_BM, c0 = ct * SK_BN;
    auto fetch = [&](int ks, int stage) {
      bf16* as = reinterpret_cast<bf16*>(smem + stage * SK_STAGE);
      bf16* ws = reinterpret_cast<bf16*>(smem + stage * SK_STAGE + SK_A_BYTES);
      const int k0 = ks * SK_BK;
#pragma unroll
      for (int i = 0; i < SK_BM * SK_BK / 8 / NTHREADS; ++i) {   // A: 16 bytes a piece
        const int c = tid + i * NTHREADS, r = c / (SK_BK / 8), kc = c % (SK_BK / 8);
        const bool ok = r0 + r < B;
        cp_async16(as + r * SK_ALD + kc * 8,
                   m.A + (ok ? (size_t)(r0 + r) * m.K + k0 + kc * 8 : 0), ok);
      }
#pragma unroll
      for (int i = 0; i < SK_BK * SK_BN / 8 / NTHREADS; ++i) {   // the weight
        const int c = tid + i * NTHREADS, r = c / (SK_BN / 8), nc = c % (SK_BN / 8);
        cp_async16(ws + r * SK_WLD + nc * 8, m.W + (size_t)(k0 + r) * m.N + c0 + nc * 8, true);
      }
    };
    __syncthreads();   // the previous unit or phase is done with the ring
    float2 res[4][2];  // EP_RESID: the residual of this thread's outputs
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t o = (size_t)(r0 + wr * 16 + g + 8 * h) * m.N + c0 + wc * 32 + j * 8 + 2 * q;
        res[j][h] = make_float2(0.f, 0.f);
        if (m.ep != EP_RESID || r0 + wr * 16 + g + 8 * h >= B) continue;
        res[j][h] = m.res_f ? __ldcg(reinterpret_cast<const float2*>(m.res_f + o))
                            : __bfloat1622float2(
                                  __ldcg(reinterpret_cast<const __nv_bfloat162*>(m.res_b + o)));
      }
    float acc[4][4], comp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = comp[j][i] = 0.f;
#pragma unroll
    for (int s = 0; s < SK_STAGES - 1; ++s) {
      if (s < ksteps) fetch(s, s);
      cp_async_commit();
    }
    for (int s = 0; s < ksteps; ++s) {
      cp_async_wait<SK_STAGES - 2>();   // step s has landed
      __syncthreads();                  // and every warp is done with step s - 1
      if (s + SK_STAGES - 1 < ksteps) fetch(s + SK_STAGES - 1, (s + SK_STAGES - 1) % SK_STAGES);
      cp_async_commit();
      const bf16* as = reinterpret_cast<const bf16*>(smem + (s % SK_STAGES) * SK_STAGE);
      const bf16* ws = reinterpret_cast<const bf16*>(smem + (s % SK_STAGES) * SK_STAGE + SK_A_BYTES);
      float part[4][4];   // this K step's sums, from zero
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < SK_BK / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, as + (wr * 16 + (lane & 15)) * SK_ALD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          uint32_t b[4];   // k 0-7 | 8-15 of n tile 2 n2, then of n tile 2 n2 + 1
          ldmatrix_x4_trans(b, ws + (kk * 16 + (lane & 15)) * SK_WLD + wc * 32 + n2 * 16 +
                                   (lane >> 4) * 8);
          mma_bf16_16816(part[2 * n2], a, b[0], b[1]);
          mma_bf16_16816(part[2 * n2 + 1], a, b[2], b[3]);
        }
      }
      // The tensor cores round their float32 sums toward zero: over a whole K
      // of 768 that bias moved about twice as many bfloat16 outputs one unit
      // as float32 reordering does. Each K step's sum is added here with
      // round-to-nearest, which brings it back to reordering's level.
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (COMPENSATE)
            add_compensated(acc[j][i], comp[j][i], part[j][i]);
          else
            acc[j][i] += part[j][i];
        }
    }
    cp_async_wait<0>();
    // acc[j]: rows g, g + 8 of the warp's 16, columns 8 j + 2 q, + 1 of its 32
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + wc * 32 + j * 8 + 2 * q;
      const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(m.bias + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + wr * 16 + g + 8 * h;
        if (row < B)
          prod_store(m, row, col, acc[j][2 * h] + bv.x, acc[j][2 * h + 1] + bv.y, res[j][h]);
      }
    }
  }
}

__device__ void run_product(const Prod& m, int B, unsigned char* smem) {
  if (m.K > SK_COMP_K)
    product_phase<true>(m, B, smem);
  else
    product_phase<false>(m, B, smem);
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

__global__ void __launch_bounds__(NTHREADS, 1) stack_step_kernel(StepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, E = a.E, F = a.F, idx = a.idx;
  const size_t BE = (size_t)B * E;
  // scratch: float32 q, r, xf [B, E]; bfloat16 att, xb, xin [B, E], hid [B, F]
  float* qb = a.scratch;
  float* rb = qb + BE;     // the residual sum into the next LayerNorm
  float* xf = rb + BE;     // x1, x2: the LayerNorm output in float32 (the next residual)
  bf16* att = reinterpret_cast<bf16*>(xf + BE);   // the attention output
  bf16* xb = att + BE;     // x1, x2 rounded: the A operand of Wcq, W1
  bf16* xin = xb + BE;     // the next layer's input
  bf16* hid = xin + BE;    // the FFN hidden, rounded
  const int nself = min(idx + 1, a.l_view);
  const size_t LBE = (size_t)a.L * BE, TBE = (size_t)a.Tm * BE, EE = (size_t)E * E;

  for (int li = 0; li < a.NL; ++li) {
    bf16* kc = (bf16*)a.kc + li * LBE;
    bf16* vc = (bf16*)a.vc + li * LBE;
    const bf16* x_in = li == 0 ? (const bf16*)a.x : xin;
    const bool last = li == a.NL - 1;
    Prod m = {};

    // 1. packed QKV; the fresh K/V row goes into the cache at idx
    m.A = x_in; m.K = E;
    m.W = (const bf16*)a.wqkv + li * 3 * EE; m.bias = (const bf16*)a.bqkv + (size_t)li * 3 * E;
    m.N = 3 * E; m.ep = EP_QKV; m.dst = qb;
    m.kc_row = idx < a.L ? kc + (size_t)idx * BE : nullptr;
    m.vc_row = idx < a.L ? vc + (size_t)idx * BE : nullptr;
    run_product(m, B, smem);
    grid.sync();
    // 2. causal self-attention over rows 0 .. min(idx, l_view - 1)
    attention_phase_tc(qb, kc, vc, nself, nullptr, 0, B, E, a.H, att, smem);
    grid.sync();
    // 3. out-projection + residual (the layer input)
    m = Prod{};
    m.A = att; m.K = E; m.W = (const bf16*)a.wo + li * EE; m.bias = (const bf16*)a.bo + (size_t)li * E;
    m.N = E; m.ep = EP_RESID; m.dst = rb; m.res_b = x_in;
    run_product(m, B, smem);
    grid.sync();
    // 4. x1 = norm1(...)
    layernorm_phase(rb, B, E, a.n1s + (size_t)li * E, a.n1b + (size_t)li * E, xf, xb, nullptr,
                    false);
    grid.sync();
    // 5. cross-attention query
    m = Prod{};
    m.A = xb; m.K = E; m.W = (const bf16*)a.wcq + li * EE; m.bias = (const bf16*)a.bcq + (size_t)li * E;
    m.N = E; m.ep = EP_F32; m.dst = qb;
    run_product(m, B, smem);
    grid.sync();
    // 6. cross-attention over the memory with its padding bias
    attention_phase_tc(qb, (const bf16*)a.ck + li * TBE, (const bf16*)a.cv + li * TBE, a.Tm,
                       a.mem_bias, a.Tm, B, E, a.H, att, smem);
    grid.sync();
    // 7. cross out-projection + residual (x1)
    m = Prod{};
    m.A = att; m.K = E; m.W = (const bf16*)a.wco + li * EE; m.bias = (const bf16*)a.bco + (size_t)li * E;
    m.N = E; m.ep = EP_RESID; m.dst = rb; m.res_f = xf;
    run_product(m, B, smem);
    grid.sync();
    // 8. x2 = norm2(...)
    layernorm_phase(rb, B, E, a.n2s + (size_t)li * E, a.n2b + (size_t)li * E, xf, xb, nullptr,
                    false);
    grid.sync();
    // 9. FFN up-projection + exact GELU
    m = Prod{};
    m.A = xb; m.K = E; m.W = (const bf16*)a.w1 + (size_t)li * E * F;
    m.bias = (const bf16*)a.b1 + (size_t)li * F; m.N = F; m.ep = EP_GELU; m.dst_b = hid;
    run_product(m, B, smem);
    grid.sync();
    // 10. FFN down-projection + residual (x2)
    m = Prod{};
    m.A = hid; m.K = F; m.W = (const bf16*)a.w2 + (size_t)li * F * E;
    m.bias = (const bf16*)a.b2 + (size_t)li * E; m.N = E; m.ep = EP_RESID; m.dst = rb; m.res_f = xf;
    run_product(m, B, smem);
    grid.sync();
    // 11. norm3: the next layer's input, or x_out
    layernorm_phase(rb, B, E, a.n3s + (size_t)li * E, a.n3b + (size_t)li * E, nullptr,
                    last ? nullptr : xin, last ? (bf16*)a.out : nullptr, a.idx >= a.l_view);
    if (!last) grid.sync();
  }
}

// ---------------------------------------------------------------------------
// the plan: {route, rows of a product unit, its columns, K step, ring stages,
// dynamic shared memory, why}. Route 1 is stack_step_kernel, route 0
// decode_step_kernel. Route -1 (what fused_layers_step passes) takes route 1
// for bfloat16 when every limit below holds, and says by ``why`` which did
// not: 0 route 1 by the rule; 1 route 0 asked for; 2 float32; 3 rows outside
// [STACK_MIN_ROWS, STACK_MAX_ROWS]; 4 a width (E or F) that is not a multiple
// of 64; 5 E above SK_EMAX; 6 a head width that is not a multiple of 8 or is
// above SK_DMAX.
// ---------------------------------------------------------------------------

struct StackPlan {
  int route, bm, bn, bk, stages, smem, why;
};

bool stack_plan(int dtype, int B, int E, int H, int F, int route, StackPlan* out) {
  if (B < 1 || E < 1 || H < 1 || F < 1 || E % H || route < -1 || route > 1) return false;
  const int D = E / H;
  int why = 0;
  if (route == 0) why = 1;
  else if (dtype != 1) why = 2;
  else if (B < STACK_MIN_ROWS || B > STACK_MAX_ROWS) why = 3;
  else if (E % 64 || F % 64) why = 4;
  else if (E > SK_EMAX) why = 5;
  else if (D % 8 || D > SK_DMAX) why = 6;
  if (route == 1 && why) return false;   // route 1 asked for where it does not run
  StackPlan p;
  p.route = why ? 0 : 1;
  p.why = why;
  if (p.route == 1) {
    p.bm = SK_BM; p.bn = SK_BN; p.bk = SK_BK; p.stages = SK_STAGES; p.smem = SK_SMEM;
  } else {   // decode_step_kernel: units of BT rows x TN columns, no ring
    p.bm = BT; p.bn = TN; p.bk = 0; p.stages = 0; p.smem = (int)step_smem_bytes(E, F);
  }
  *out = p;
  return true;
}

}  // namespace

extern "C" {

int vct_decode_step(int dtype, void* const* t, int B, int E, int H, int F, int NL, int L,
                    int Tm, int V, int idx, int l_view, int gen, void* stream);

// out: 7 ints, see StackPlan
int vct_stack_step_plan(int dtype, int B, int E, int H, int F, int route, int* out) {
  StackPlan p;
  if (!stack_plan(dtype, B, E, H, F, route, &p)) return (int)cudaErrorInvalidValue;
  const int vals[7] = {p.route, p.bm, p.bn, p.bk, p.stages, p.smem, p.why};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

// fused_layers_step: tensors as vct_decode_step takes them (the generator's
// null); route -1 by the plan, 0 decode_step_kernel, 1 stack_step_kernel.
// scratch: float32 [B * (5E + F)], of which route 1 uses B * (18E + 2F) bytes.
int vct_stack_step(int dtype, void* const* t, int B, int E, int H, int F, int NL, int L, int Tm,
                   int idx, int l_view, int route, void* stream) {
  StackPlan p;
  if (!stack_plan(dtype, B, E, H, F, route, &p) || Tm > LMAX || l_view > LMAX)
    return (int)cudaErrorInvalidValue;
  if (p.route == 0)
    return vct_decode_step(dtype, t, B, E, H, F, NL, L, Tm, 0, idx, l_view, 0, stream);
  StepArgs a;
  fill_step_args(a, t);
  a.B = B; a.E = E; a.H = H; a.F = F; a.NL = NL; a.L = L; a.Tm = Tm; a.V = 0;
  a.idx = idx; a.l_view = l_view; a.gen = 0;
  // one block per SM: with two, the phases that keep fewer blocks than SMs
  // busy ran slower (a block's units shared an SM with another's)
  return (int)launch_cooperative(stack_step_kernel, a, (size_t)SK_SMEM, (cudaStream_t)stream, 1);
}

}  // extern "C"
