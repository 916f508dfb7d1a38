// The bfloat16 decode token at 1-64 rows on tensor cores for Hopper (sm_90a),
// generator included, bound through a plain C interface (ctypes). Python
// side: vct_tpu_torch/ops/decode_kernels.py (``fused_whole_step``,
// ``fused_multi_step``, ``fused_sequence_decode``, ``fused_layers_step`` and
// ``fused_layer_step`` at 64 rows and fewer; ``whole_step_plan``,
// ``multi_step_plan``, ``sequence_decode_plan``, ``stack_step_plan``).
//
// Replaces (vct_tpu/ops/pallas_decode.py), in bfloat16 at 1-64 rows:
//   * fused_whole_step (:581, _whole_step_kernel :397): small_step_kernel with
//     the generator phase, one cooperative launch per token;
//   * fused_multi_step (:1289, _multi_step_kernel :1144), window mode:
//     small_multi_kernel, the same token in a loop of ``unroll`` tokens;
//   * fused_sequence_decode (:997, _sequence_decode_kernel :858), at 1-32
//     rows: small_multi_kernel in sequence mode, the whole caption from the
//     start token with each row's done flag inside;
//   * fused_layers_step (:516) at 64 rows and fewer, and fused_layer_step
//     (:211, _layer_step_kernel :155) as the stack at NL = 1:
//     small_step_kernel without the generator, so that beam search at width 1
//     and a decode run layer by layer sum as greedy decode.
// Every greedy route at 1-64 rows (the per-token loop, windows, the sequence
// kernel, a beam of 1, the layer-by-layer decode) thus gives the same tokens.
// float32 and shapes outside the plans keep decode_token (decode_common.cuh),
// which stays reachable by route 0 for same-run timing.
//
// What bounds it on an H100: bytes. At 64 rows and fewer a token is a chain
// of matrix-vector products over 13.4 MB of weights a layer and the 47.2 MB
// generator (88 MB at the MSVD widths, 26 us of HBM); the operations are a
// few GFLOP. decode_token spent 0.54-0.67 ms on it: fp32 FMAs in units of 32
// columns x 8 rows that re-read their weight tile for every 8 rows, LayerNorm
// recomputed by every column unit, attention walking the cache row by row.
//
// Design: one cooperative launch, one block per SM, the phases of
// stack_step.cu separated by grid.sync():
//   QKV | self-attention | Wo + residual | LN1 | Wcq | cross-attention |
//   Wco + residual | LN2 | W1 + GELU | W2 + residual | LN3 [| norm + split |
//   vocab walk with the argmax epilogue]
// * A product phase spreads its weight bytes over every SM: block b owns the
//   8-column units [b U / grid, (b + 1) U / grid) of the U = N / 8, each over
//   the whole K (2-3 units of 768 at QKV, 1 of 2048 at the FFN's
//   down-projection: 12-36 KB a block). The slice lies in shared memory as
//   [unit][K][8] and is the B operand of mma.sync m16n8k16 (ldmatrix.trans);
//   the rows, padded to m16 tiles, are the A operand, streamed from L2 in
//   chunks of 256 k through a 4-stage cp.async ring.
// * Weight prefetch: the weights do not depend on the phase before, so every
//   product asks for the NEXT product's slice (into the other of two slots)
//   as soon as its own first chunk has landed; the slice is in shared memory
//   when the barriers before that product pass, and only the A operand waits
//   for them. The last product of a token in the multi-token kernel asks for
//   the next token's QKV slice.
// * The K steps of 16 go to the eight warps in turn (step s to warp s % 8);
//   each warp sums its MMAs' results (each from zero) with compensation
//   (Kahan), then the eight partials meet in shared memory in warp order.
//   The order depends neither on the rows nor on the grid, so a row gives the
//   same bits at every batch size, and greedy, multi-step and beam search
//   (fused_layers_step here plus gen_topk.cu at one candidate) agree bit for
//   bit.
// * LayerNorm, attention and the epilogues are stack_phases.cuh's: LayerNorm
//   once per row in a row pass, attention staged in one round of cp.async
//   with an online softmax. The multi-token kernel forms a token's input in
//   a row pass before its QKV: emb[cur] (zero for pad_id) + pe[i0 + j],
//   summed in float32 and rounded once (a row pass and a barrier measured
//   faster than forming the rows in the first product's loader, where every
//   block formed all of them).
// * The products, attention and LayerNorm passes are functions of their own
//   (__noinline__): a token runs each at several places, and one copy of
//   each measured faster than inlined copies (a whole step at B=32 0.2947
//   ms against 0.3407 with the products inlined and 0.3159 with the passes
//   inlined; chip_smoke.py --stack-variant on copies, NVIDIA H100 80GB HBM3,
//   700 W): fewer instructions to fetch. The first layer of a launch, which
//   meets them cold, runs its attention and LayerNorm passes up to 2.5x
//   slower than the later layers.
// * The generator: the last LN3 row pass also forms yn = LayerNorm(x) and its
//   bfloat16 hi/lo parts with gen_wgmma.cuh's norm_split_row (the same bits
//   as gen_norm_split_kernel) and zeroes the argmax keys; after a barrier
//   every block runs gen_walk, the vocab walk of gen_wgmma_kernel, with the
//   argmax epilogue of gen_argmax.cu (64-bit atomicMax keys, the first index
//   wins ties); after another barrier the tokens are read from the keys. The
//   logits are those of fused_norm_generator_argmax and _topk at the same
//   rows.
// * Rows past B in a padded M tile are zeros in the ring and never written.
// What the time is (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// --stack-variant on a copy that defines VCT_SMALL_STAMPS, B=32): a product
// phase 8.8-11 us at K = 768 and 13-17 at K = 2048 (barrier included), a
// LayerNorm pass 2.7-2.9, attention 4.3-5.5, the last LayerNorm with the
// split 9; 0.29 ms a token against a 0.029 ms byte bound. Like
// stack_step.cu's, the call is bound by its chain of 35 phases, each a few
// dependent trips to memory, not by its bytes.
// Rounding points are decode_step.cu's: the products, their sums with the
// residual and the LayerNorm statistics in float32; the cache rows, the
// attention outputs, the LayerNorm outputs that feed a product, the GELU
// output and x in bfloat16. Only the order of the float32 sums changes, and
// every sum has one order: two calls give the same bits.

#include "gen_wgmma.cuh"
#include "stack_phases.cuh"

namespace {

#ifdef VCT_SMALL_STAMPS
// A measurement copy defines VCT_SMALL_STAMPS: block 0 then stamps
// %globaltimer at the start and after every barrier of a launch, and
// vct_small_stamps copies the stamps of the last launch out.
__device__ unsigned long long g_small_stamps[256];
__device__ int g_small_nstamps;
__device__ __forceinline__ void small_stamp(bool first = false) {
  if (blockIdx.x || threadIdx.x) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (first) g_small_nstamps = 0;
  if (g_small_nstamps < 256) g_small_stamps[g_small_nstamps++] = t;
}
#else
__device__ __forceinline__ void small_stamp(bool = false) {}
#endif

constexpr int SS_GEN = SS_SLOT;   // the generator's ring: past slot 0, which stays free
static_assert(SS_GEN + gw_ring_bytes(64) + ArgmaxEpi::smem_bytes<64>() <= SS_SMEM,
              "the generator's ring and epilogue fit the arena");
// the split's staging, past the generator's ring and epilogue
constexpr int SS_SPLIT = (SS_GEN + gw_ring_bytes(64) + ArgmaxEpi::smem_bytes<64>() + 15) / 16 * 16;
static_assert(SS_SPLIT + NWARPS * SK_EMAX * 2 <= SS_SMEM, "the split's staging fits the arena");
static_assert(NWARPS * SS_MAX_ROWS * SS_MAX_UNITS * SS_G * 4 <= SS_RING,
              "the warps' partial sums fit the A ring");

// a token's input from token ids (the multi-token kernel's row pass)
struct EmbSrc {
  const bf16* emb;      // [n_emb, E]
  const bf16* pe_row;   // [E]
  const int* cur;       // [B] in shared memory
  int n_emb, pad_id;
};

// 8 columns from k of row ``row``'s decoder input: emb[cur] (zero for pad_id
// or an id past the table) + pe, summed in float32 and rounded once
__device__ __forceinline__ uint4 embed8(const EmbSrc& e, int row, int k, int E) {
  const int tok = e.cur[row];
  const bool zero = tok == e.pad_id || tok < 0 || tok >= e.n_emb;
  const uint4 p = *reinterpret_cast<const uint4*>(e.pe_row + k);
  const uint4 w = zero ? make_uint4(0u, 0u, 0u, 0u)
                       : *reinterpret_cast<const uint4*>(e.emb + (size_t)tok * E + k);
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&p);
  const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&w);
  uint4 out;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(w2[i]), b = __bfloat1622float2(p2[i]);
    o2[i] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
  }
  return out;
}

// this block's units [u0, u0 + nu) of a product N columns wide
__device__ __forceinline__ void my_units(int N, int& u0, int& nu) {
  const int n = N / SS_G;
  u0 = (int)((long long)blockIdx.x * n / gridDim.x);
  nu = (int)((long long)(blockIdx.x + 1) * n / gridDim.x) - u0;
}

// units of K deep whose slices fit one slot
__device__ __forceinline__ int units_per_round(int K) {
  const int c = SS_SLOT / (SS_G * 2 * K);
  return c < SS_MAX_UNITS ? c : SS_MAX_UNITS;
}

// the weight slice of units [u0, u0 + nu) as [nu][K][8] into ``slot``, one
// cp.async group; neighbouring threads take neighbouring units of a k row
__device__ void fetch_slice(const Prod& m, int u0, int nu, bf16* slot) {
  const int total = nu * m.K;
  for (int i = threadIdx.x; i < total; i += NTHREADS) {
    const int ui = i % nu, k = i / nu;
    cp_async16(slot + ((size_t)ui * m.K + k) * SS_G, m.W + (size_t)k * m.N + (u0 + ui) * SS_G,
               true);
  }
  cp_async_commit();
}

// the first round of this block's slice of ``m`` (an empty group if it has none)
__device__ void prefetch_slice(const Prod& m, bf16* slot) {
  int u0, nu;
  my_units(m.N, u0, nu);
  nu = min(nu, units_per_round(m.K));
  if (nu > 0)
    fetch_slice(m, u0, nu, slot);
  else
    cp_async_commit();
}

// A [B, K] . W [K, N] + bias for this block's units, whose first round is in
// ``slot`` or on its way. As
// soon as the first chunk has landed, asks for ``next``'s first round (if
// any) into ``next_slot``. K is a multiple of 16 (the plans ask for 64), N of
// 8, B <= SS_MAX_ROWS.
__device__ __noinline__ void small_product(const Prod& m, int B, bf16* slot, unsigned char* work,
                                           const Prod* next, bf16* next_slot) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int n_mt = (B + 15) / 16, bp = n_mt * 16;
  const int nchunks = (m.K + SS_KC - 1) / SS_KC;
  const int cap = units_per_round(m.K);
  int u0, nu;
  my_units(m.N, u0, nu);
  bool asked = next == nullptr;
  if (nu == 0) {
    if (!asked) prefetch_slice(*next, next_slot);
    return;
  }
  float* red = reinterpret_cast<float*>(work);   // [NWARPS][bp][SS_MAX_UNITS * SS_G]
  constexpr int RLD = SS_MAX_UNITS * SS_G;
  for (int r0 = 0; r0 < nu; r0 += cap) {
    const int gn = min(cap, nu - r0), ub = u0 + r0, items = B * gn * 4;
    if (r0 > 0) {
      __syncthreads();   // the last round is done with the slot and the work area
      fetch_slice(m, ub, gn, slot);
    }
    auto fetch_a = [&](int c, int stage) {
      bf16* as = reinterpret_cast<bf16*>(work + stage * SS_ASTAGE);
      const int k0 = c * SS_KC, pieces = min(SS_KC, m.K - k0) / 8;
      for (int i = tid; i < bp * pieces; i += NTHREADS) {
        const int r = i / pieces, p = i - r * pieces;
        bf16* dst = as + r * SS_ALD + p * 8;
        const bool ok = r < B;
        cp_async16(dst, m.A + (ok ? (size_t)r * m.K + k0 + p * 8 : 0), ok);
      }
    };
    float acc[4][SS_MAX_UNITS][4], comp[4][SS_MAX_UNITS][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int ui = 0; ui < SS_MAX_UNITS; ++ui)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][ui][i] = comp[mt][ui][i] = 0.f;
#pragma unroll
    for (int s = 0; s < SS_STAGES - 1; ++s) {
      if (s < nchunks) fetch_a(s, s);
      cp_async_commit();
    }
    // the bias and residual of this thread's outputs, asked for once the A
    // chunks are on their way and kept as loaded until the epilogue (a
    // conversion here would wait for them)
    float2 res[3];
    __nv_bfloat162 res_b[3], bias[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int it = tid + i * NTHREADS;
      if (it >= items) continue;
      const int row = it / (gn * 4), col = ub * SS_G + (it % (gn * 4)) * 2;
      bias[i] = *reinterpret_cast<const __nv_bfloat162*>(m.bias + col);
      if (m.ep != EP_RESID) continue;
      const size_t o = (size_t)row * m.N + col;
      if (m.res_f)
        res[i] = __ldcg(reinterpret_cast<const float2*>(m.res_f + o));
      else
        res_b[i] = __ldcg(reinterpret_cast<const __nv_bfloat162*>(m.res_b + o));
    }
    for (int c = 0; c < nchunks; ++c) {
      cp_async_wait<SS_STAGES - 2>();   // chunk c (and the slice) have landed
      __syncthreads();                  // and every warp is done with chunk c - 1
      if (c + SS_STAGES - 1 < nchunks) fetch_a(c + SS_STAGES - 1, (c + SS_STAGES - 1) % SS_STAGES);
      cp_async_commit();
      // the next product's slice once this one's last chunk has landed: a
      // later wait of this phase would wait for it too
      if (!asked && c == nchunks - 1) {
        prefetch_slice(*next, next_slot);
        asked = true;
      }
      const bf16* as = reinterpret_cast<const bf16*>(work + (c % SS_STAGES) * SS_ASTAGE);
      const int steps = min(SS_KC, m.K - c * SS_KC) / 16;
      for (int j = warp; j < steps; j += NWARPS) {
        const int s = c * (SS_KC / 16) + j;   // the global K step: s % NWARPS == warp
        uint32_t b[SS_MAX_UNITS][2];
#pragma unroll
        for (int ui = 0; ui < SS_MAX_UNITS; ++ui)
          if (ui < gn)
            ldmatrix_x2_trans(b[ui], slot + ((size_t)ui * m.K + s * 16 + (lane & 15)) * SS_G);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt >= n_mt) continue;
          uint32_t a[4];
          ldmatrix_x4(a, as + (mt * 16 + (lane & 15)) * SS_ALD + j * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int ui = 0; ui < SS_MAX_UNITS; ++ui) {
            if (ui >= gn) continue;
            // each MMA from zero, its sum added with compensation: the tensor
            // cores round toward zero inside an MMA, and a K of 768-2048
            // summed there drifts from the float32 sum of the plain version
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16_16816(part, a, b[ui][0], b[ui][1]);
#pragma unroll
            for (int i = 0; i < 4; ++i) add_compensated(acc[mt][ui][i], comp[mt][ui][i], part[i]);
          }
        }
      }
    }
    __syncthreads();   // every warp is done with the ring, which holds the partials now
    // acc[mt][ui]: rows mt * 16 + g (+ 8), columns ui * 8 + 2 q, + 1
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt >= n_mt) continue;
#pragma unroll
      for (int ui = 0; ui < SS_MAX_UNITS; ++ui) {
        if (ui >= gn) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* dst = red + ((size_t)warp * bp + mt * 16 + g + 8 * h) * RLD + ui * SS_G + 2 * q;
          dst[0] = acc[mt][ui][2 * h] - comp[mt][ui][2 * h];
          dst[1] = acc[mt][ui][2 * h + 1] - comp[mt][ui][2 * h + 1];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int it = tid + i * NTHREADS;
      if (it >= items) continue;
      const int row = it / (gn * 4), cl = (it % (gn * 4)) * 2, col = ub * SS_G + cl;
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {   // the warps' partials in warp order
        const float* src = red + ((size_t)w * bp + row) * RLD + cl;
        v0 += src[0];
        v1 += src[1];
      }
      const float2 bv = __bfloat1622float2(bias[i]);
      const float2 rv = m.ep != EP_RESID ? make_float2(0.f, 0.f)
                        : m.res_f ? res[i] : __bfloat1622float2(res_b[i]);
      prod_store(m, row, col, v0 + bv.x, v1 + bv.y, rv);
    }
  }
}

// The last LN3 and the generator's LayerNorm and split in one row pass: one
// warp per row of the padded tile of SS_MAX_ROWS (rows past B become zeros),
// x = bf16(LayerNorm3(r)) as layernorm_phase forms it, in registers; the
// values move through shared memory (``stage``: SK_EMAX bfloat16 a warp) to
// the layout norm_split_row reads (k = lane + 32 i), and split_row_regs
// forms yn and its hi/lo parts with norm_split_row's sums, so the parts carry
// gen_norm_split_kernel's bits for the same x. Zeroes the rows' argmax keys.
// E is a multiple of 64, at most SK_EMAX.
__device__ void ln3_split_phase(const float* src, int B, int E, const float* gam,
                                const float* bet, const float* ns, const float* nb, bf16* parts,
                                u64* keys, bf16* stage) {
  constexpr int C = SK_EMAX / 128, CS = SK_EMAX / 32;
  const int lane = threadIdx.x & 31;
  const int E4 = E / 4;
  for (int b = blockIdx.x * NWARPS + (threadIdx.x >> 5); b < SS_MAX_ROWS;
       b += gridDim.x * NWARPS) {
    bf16* hi = parts + (size_t)b * E;
    bf16* lo = parts + ((size_t)SS_MAX_ROWS + b) * E;
    if (b >= B) {
      for (int k = lane; k < E; k += 32) hi[k] = lo[k] = __float2bfloat16_rn(0.f);
      continue;
    }
    if (lane == 0) keys[b] = 0ull;   // below every real key
    const float4* r = reinterpret_cast<const float4*>(src + (size_t)b * E);
    float4 x[C], g4[C], b4[C];
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
    // x as layernorm_phase forms it (rounded to bfloat16 below)
#pragma unroll
    for (int i = 0; i < C; ++i)
      x[i] = make_float4((x[i].x - mean) * rs * g4[i].x + b4[i].x,
                         (x[i].y - mean) * rs * g4[i].y + b4[i].y,
                         (x[i].z - mean) * rs * g4[i].z + b4[i].z,
                         (x[i].w - mean) * rs * g4[i].w + b4[i].w);
    // through the warp's staging in shared memory to the layout
    // norm_split_row reads, k = lane + 32 i
    bf16* st = stage + (threadIdx.x >> 5) * SK_EMAX;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = lane + 32 * i;
      if (c >= E4) continue;
      reinterpret_cast<__nv_bfloat162*>(st + 4 * c)[0] = __floats2bfloat162_rn(x[i].x, x[i].y);
      reinterpret_cast<__nv_bfloat162*>(st + 4 * c)[1] = __floats2bfloat162_rn(x[i].z, x[i].w);
    }
    __syncwarp();
    float xs[CS];
#pragma unroll
    for (int i = 0; i < CS; ++i)
      xs[i] = lane + 32 * i < E ? __bfloat162float(st[lane + 32 * i]) : 0.f;
    __syncwarp();   // the staging is free for the warp's next row
    split_row_regs<CS>(xs, E, ns, nb, hi, lo);
  }
}

// stack_phases.cuh's attention and LayerNorm passes as functions of their own
// here: each runs at several places of a token, and one copy of the code
// each keeps the kernel's instructions fewer
__device__ __noinline__ void small_attention(const float* q, const bf16* kc, const bf16* vc,
                                                int nrows, const float* bias, int bias_ld, int B,
                                                int E, int H, bf16* out, unsigned char* smem) {
  attention_phase_tc(q, kc, vc, nrows, bias, bias_ld, B, E, H, out, smem);
}

__device__ __noinline__ void small_layernorm(const float* src, int B, int E, const float* gam,
                                                const float* bet, float* dst_f, bf16* dst_b,
                                                bf16* out, bool poison) {
  layernorm_phase(src, B, E, gam, bet, dst_f, dst_b, out, poison);
}

// the scratch of a token: float32 q, r, xf [B, E]; bfloat16 att, xb, xin [B,
// E], hid [B, F], the generator's hi/lo parts [2, SS_MAX_ROWS, E]
struct Scratch {
  float* qb;    // q, the cross-attention query
  float* rb;    // the residual sum into the next LayerNorm
  float* xf;    // x1, x2: the LayerNorm output in float32 (the next residual)
  bf16* att;    // the attention output
  bf16* xb;     // x1, x2 rounded: the A operand of Wcq, W1
  bf16* xin;    // the layer input (and the last layer's output, for the generator)
  bf16* hid;    // the FFN hidden, rounded
  bf16* parts;
};

__device__ __forceinline__ Scratch scratch_of(const StepArgs& a) {
  const size_t BE = (size_t)a.B * a.E;
  Scratch s;
  s.qb = a.scratch;
  s.rb = s.qb + BE;
  s.xf = s.rb + BE;
  s.att = reinterpret_cast<bf16*>(s.xf + BE);
  s.xb = s.att + BE;
  s.xin = s.xb + BE;
  s.hid = s.xin + BE;
  s.parts = s.hid + (size_t)a.B * a.F;
  return s;
}

enum { P_QKV = 0, P_WO, P_WCQ, P_WCO, P_W1, P_W2, P_COUNT };

// product ``which`` of layer li at position idx; ``emb``: layer 0's input is
// formed from token ids into xin by a row pass
__device__ Prod make_prod(const StepArgs& a, const Scratch& s, int li, int which, int idx,
                          bool emb) {
  const int E = a.E, F = a.F;
  const size_t EE = (size_t)E * E, BE = (size_t)a.B * E, LBE = (size_t)a.L * BE;
  const bf16* x_in = li == 0 && !emb ? (const bf16*)a.x : s.xin;
  Prod m = {};
  switch (which) {
    case P_QKV:
      m.A = x_in; m.K = E; m.N = 3 * E; m.ep = EP_QKV; m.dst = s.qb;
      m.W = (const bf16*)a.wqkv + li * 3 * EE; m.bias = (const bf16*)a.bqkv + (size_t)li * 3 * E;
      m.kc_row = idx < a.L ? (bf16*)a.kc + li * LBE + (size_t)idx * BE : nullptr;
      m.vc_row = idx < a.L ? (bf16*)a.vc + li * LBE + (size_t)idx * BE : nullptr;
      break;
    case P_WO:
      m.A = s.att; m.K = E; m.N = E; m.ep = EP_RESID; m.dst = s.rb; m.res_b = x_in;
      m.W = (const bf16*)a.wo + li * EE; m.bias = (const bf16*)a.bo + (size_t)li * E;
      break;
    case P_WCQ:
      m.A = s.xb; m.K = E; m.N = E; m.ep = EP_F32; m.dst = s.qb;
      m.W = (const bf16*)a.wcq + li * EE; m.bias = (const bf16*)a.bcq + (size_t)li * E;
      break;
    case P_WCO:
      m.A = s.att; m.K = E; m.N = E; m.ep = EP_RESID; m.dst = s.rb; m.res_f = s.xf;
      m.W = (const bf16*)a.wco + li * EE; m.bias = (const bf16*)a.bco + (size_t)li * E;
      break;
    case P_W1:
      m.A = s.xb; m.K = E; m.N = F; m.ep = EP_GELU; m.dst_b = s.hid;
      m.W = (const bf16*)a.w1 + (size_t)li * E * F; m.bias = (const bf16*)a.b1 + (size_t)li * F;
      break;
    default:
      m.A = s.hid; m.K = F; m.N = E; m.ep = EP_RESID; m.dst = s.rb; m.res_f = s.xf;
      m.W = (const bf16*)a.w2 + (size_t)li * F * E; m.bias = (const bf16*)a.b2 + (size_t)li * E;
  }
  return m;
}

// One token at position idx through the stack and, with a.gen, the
// generator, every block of the cooperative grid together. The first
// product's slice (layer 0's QKV) must be on its way into slot 0. EMB: layer
// 0's input from ``emb``. With a.gen the argmax keys of the token land in
// ``keys`` [B], complete after the barrier this function ends with; without
// it x goes to a.out (NaN when idx >= l_view). ``more``: ask for the next
// token's first slice.
template <bool EMB>
__device__ void small_token(const StepArgs& a, cg::grid_group& grid, unsigned char* smem, int idx,
                            const EmbSrc* emb, u64* keys, bool more) {
  const int B = a.B, E = a.E;
  const Scratch s = scratch_of(a);
  bf16* slots[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem + SS_SLOT)};
  unsigned char* work = smem + 2 * SS_SLOT;
  const int nself = min(idx + 1, a.l_view);
  const size_t LBE = (size_t)a.L * B * E, TBE = (size_t)a.Tm * B * E;
  auto sync = [&]() {
    grid.sync();
    small_stamp();
  };

  // product p of the token (li * P_COUNT + which) runs from slot p % 2 and
  // asks for product p + 1
  auto product = [&](int li, int which) {
    const Prod m = make_prod(a, s, li, which, idx, EMB);
    Prod nx;
    const Prod* next = &nx;
    if (which + 1 < P_COUNT)
      nx = make_prod(a, s, li, which + 1, idx, EMB);
    else if (li + 1 < a.NL)
      nx = make_prod(a, s, li + 1, P_QKV, idx, EMB);
    else if (more)
      nx = make_prod(a, s, 0, P_QKV, idx + 1, EMB);
    else
      next = nullptr;
    const int p = li * P_COUNT + which;
    small_product(m, B, slots[p % 2], work, next, slots[(p + 1) % 2]);
  };

  for (int li = 0; li < a.NL; ++li) {
    const bool last = li == a.NL - 1;
    bf16* kc = (bf16*)a.kc + li * LBE;
    bf16* vc = (bf16*)a.vc + li * LBE;
    // 1. packed QKV; the fresh K/V row goes into the cache at idx
    if (EMB && li == 0) {   // layer 0's input in a row pass of its own
      for (int i = blockIdx.x * NTHREADS + threadIdx.x; i < B * E / 8; i += gridDim.x * NTHREADS) {
        const int r = i / (E / 8), k = (i % (E / 8)) * 8;
        *reinterpret_cast<uint4*>(s.xin + (size_t)r * E + k) = embed8(*emb, r, k, E);
      }
      sync();
    }
    product(li, P_QKV);
    sync();
    // 2. causal self-attention over rows 0 .. min(idx, l_view - 1)
    small_attention(s.qb, kc, vc, nself, nullptr, 0, B, E, a.H, s.att, work);
    sync();
    // 3. out-projection + residual (the layer input)
    product(li, P_WO);
    sync();
    // 4. x1 = norm1(...)
    small_layernorm(s.rb, B, E, a.n1s + (size_t)li * E, a.n1b + (size_t)li * E, s.xf, s.xb,
                    nullptr, false);
    sync();
    // 5. cross-attention query
    product(li, P_WCQ);
    sync();
    // 6. cross-attention over the memory with its padding bias
    small_attention(s.qb, (const bf16*)a.ck + li * TBE, (const bf16*)a.cv + li * TBE, a.Tm,
                       a.mem_bias, a.Tm, B, E, a.H, s.att, work);
    sync();
    // 7. cross out-projection + residual (x1)
    product(li, P_WCO);
    sync();
    // 8. x2 = norm2(...)
    small_layernorm(s.rb, B, E, a.n2s + (size_t)li * E, a.n2b + (size_t)li * E, s.xf, s.xb,
                    nullptr, false);
    sync();
    // 9. FFN up-projection + exact GELU
    product(li, P_W1);
    sync();
    // 10. FFN down-projection + residual (x2)
    product(li, P_W2);
    sync();
    // 11. norm3: the next layer's input, x_out, or the generator's input
    const float* g3 = a.n3s + (size_t)li * E;
    const float* b3 = a.n3b + (size_t)li * E;
    if (!last) {
      small_layernorm(s.rb, B, E, g3, b3, nullptr, s.xin, nullptr, false);
      sync();
    } else if (!a.gen) {
      small_layernorm(s.rb, B, E, g3, b3, nullptr, nullptr, (bf16*)a.out, idx >= a.l_view);
    } else {
      ln3_split_phase(s.rb, B, E, g3, b3, a.norm_s, a.norm_b, s.parts, keys,
                      reinterpret_cast<bf16*>(smem + SS_SPLIT));
      sync();
      gen_walk<64, ArgmaxEpi>(s.parts, (const bf16*)a.wg, a.bg, B, SS_MAX_ROWS, E, a.V,
                              (a.V + GA_BN - 1) / GA_BN, 1, ArgmaxEpi{keys, nullptr},
                              smem + SS_GEN);
      sync();
    }
  }
}

// fused_whole_step (a.gen = 1) or fused_layers_step (a.gen = 0) at 1-64 rows
__global__ void __launch_bounds__(NTHREADS, 1) small_step_kernel(StepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  small_stamp(true);
  prefetch_slice(make_prod(a, scratch_of(a), 0, P_QKV, a.idx, false),
                 reinterpret_cast<bf16*>(smem));
  small_token<false>(a, grid, smem, a.idx, nullptr, a.keys, false);
  if (a.gen && blockIdx.x == 0) {
    int* tok = (int*)a.out;
    for (int b = threadIdx.x; b < a.B; b += NTHREADS)
      tok[b] = a.idx >= a.l_view ? -1 : key_index(__ldcg(a.keys + b));
  }
}

struct SmallMultiArgs {
  StepArgs s;          // x unused; idx unused (positions are i0 + j); gen = 1
  const bf16* emb;     // [n_emb, E]
  const bf16* pe;      // [>= i0 + n_tok, E]
  const int* cur;      // [B] the window's first input tokens (sequence mode: unused)
  int* tok_out;        // window: [B, out_ld], the raw argmax chain; sequence:
                       // [B, out_ld] from column 1, column 0 and the pad fill
                       // written by the wrapper
  int n_emb, i0, n_tok, poison, pad_id, out_ld;
  int seq;             // 1: the whole caption from start_id, done flags inside
  int start_id, end_id;
};

// fused_multi_step's window (seq 0): n_tok tokens from position i0, each
// token's argmax fed into the next one's embedding without a further
// barrier. fused_sequence_decode (seq 1): the same loop from start_id at
// position 0; a row's done flag is set once it emits end_id, and every block
// computes the same flags from the same keys, so all leave the loop after
// the token at which every row is done. The later positions keep the
// wrapper's pad fill. The caches are the launch's own: token j writes row j
// before it attends rows 0..j, so no row is read before it is written.
__global__ void __launch_bounds__(NTHREADS, 1) small_multi_kernel(SmallMultiArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int cur_s[SS_MAX_ROWS];
  __shared__ int done_s[SS_MAX_ROWS];
  cg::grid_group grid = cg::this_grid();
  const int B = a.s.B, E = a.s.E;
  for (int b = threadIdx.x; b < B; b += NTHREADS) {
    cur_s[b] = a.seq ? a.start_id : a.cur[b];
    done_s[b] = 0;
  }
  __syncthreads();
  small_stamp(true);
  EmbSrc e = {a.emb, a.pe, cur_s, a.n_emb, a.pad_id};
  prefetch_slice(make_prod(a.s, scratch_of(a.s), 0, P_QKV, a.i0, true),
                 reinterpret_cast<bf16*>(smem));
  for (int j = 0; j < a.n_tok; ++j) {
    u64* keys = a.s.keys + (size_t)j * B;
    e.pe_row = a.pe + (size_t)(a.i0 + j) * E;
    small_token<true>(a.s, grid, smem, a.i0 + j, &e, keys, j + 1 < a.n_tok);
    // the keys of token j are complete: every block resolves the next input
    int mine_done = 1;
    for (int b = threadIdx.x; b < B; b += NTHREADS) {
      const int nxt = key_index(__ldcg(keys + b));
      cur_s[b] = nxt;
      if (a.seq) {
        done_s[b] |= nxt == a.end_id;
        mine_done &= done_s[b];
      }
      if (blockIdx.x == 0)
        a.tok_out[(size_t)b * a.out_ld + (a.seq ? j + 1 : j)] = a.poison ? -1 : nxt;
    }
    // also publishes cur_s; the same value in every thread of every block
    const int all_done = __syncthreads_and(mine_done);
    if (a.seq && all_done) {
      // the token's last product asked for the next token's first slice:
      // let it land before the block leaves
      cp_async_wait<0>();
      break;
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// the plans: {route, rows of an M tile, columns of a unit, K of an A chunk,
// ring stages, dynamic shared memory, why}. Route 1 is the small-row kernel
// (small_step_kernel / small_multi_kernel), route 0 the kernel it replaced
// (decode_step_kernel / decode_multi_kernel), whose entries are its unit's
// rows and columns, no K step or stages, and its shared memory. Route -1 (what
// the wrappers pass) takes route 1 for bfloat16 when every limit holds, and
// says by ``why`` which did not: 0 route 1 by the rule; 1 route 0 asked for;
// 2 float32; 3 rows outside [1, SS_MAX_ROWS]; 4 a width (E or F) that is not a
// multiple of 64; 5 E above SK_EMAX; 6 a head width that is not a multiple of
// 8 or is above SK_DMAX; 7 F above SS_MAX_K (one unit's slice outgrows a
// slot). False for what neither route takes; the sequence kernel takes
// neither past SEQ_MAX_B rows.
// ---------------------------------------------------------------------------

// fused_sequence_decode's batch rule, kept from the reference: one batch tile
constexpr int SEQ_MAX_B = 32;

struct SmallPlan {
  int route, bm, bn, bk, stages, smem, why;
};

static bool small_plan(int dtype, int B, int E, int H, int F, int V, int route, int smem0,
                SmallPlan* out) {
  if (B < 1 || E < 1 || H < 1 || F < 1 || E % H || V < 8 || V % 8 || E % 8 || F % 8 ||
      route < -1 || route > 1)
    return false;
  const int why = small_why(dtype, B, E, H, F, route);
  if (route == 1 && why) return false;   // route 1 asked for where it does not run
  SmallPlan p;
  p.route = why ? 0 : 1;
  p.why = why;
  if (p.route == 1) {
    p.bm = 16; p.bn = SS_G; p.bk = SS_KC; p.stages = SS_STAGES; p.smem = SS_SMEM;
  } else {
    p.bm = BT; p.bn = TN; p.bk = 0; p.stages = 0; p.smem = smem0;
  }
  *out = p;
  return true;
}

// decode_multi_kernel's shared memory: decode_step_kernel's, then the rows'
// token ids and done flags
static int multi_smem0(int B, int E, int F) {
  return (int)(step_smem_bytes(E, F) + sizeof(float) * (((2 * B + 3) / 4) * 4));
}

static int plan_out(const SmallPlan& p, int* out) {
  const int vals[7] = {p.route, p.bm, p.bn, p.bk, p.stages, p.smem, p.why};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

// small_multi_kernel: tensors as vct_decode_multi takes them (keys [n_tok,
// B]); the caller has checked the plan
static int launch_small_multi(void* const* t, int B, int E, int H, int F, int NL, int L, int Tm,
                              int V, int l_view, int n_emb, int i0, int n_tok, int poison,
                              int pad_id, int out_ld, int seq, int start_id, int end_id,
                              void* stream) {
  if (Tm > LMAX || l_view > LMAX) return (int)cudaErrorInvalidValue;
  SmallMultiArgs a;
  fill_step_args(a.s, t);
  a.s.B = B; a.s.E = E; a.s.H = H; a.s.F = F; a.s.NL = NL; a.s.L = L; a.s.Tm = Tm;
  a.s.V = V; a.s.idx = 0; a.s.l_view = l_view; a.s.gen = 1;
  a.emb = (const bf16*)t[31]; a.pe = (const bf16*)t[32]; a.cur = (const int*)t[33];
  a.tok_out = (int*)t[34];
  a.n_emb = n_emb; a.i0 = i0; a.n_tok = n_tok; a.poison = poison; a.pad_id = pad_id;
  a.out_ld = out_ld; a.seq = seq; a.start_id = start_id; a.end_id = end_id;
  return (int)launch_cooperative(small_multi_kernel, a, (size_t)SS_SMEM, (cudaStream_t)stream, 1);
}

extern "C" {

int vct_decode_step(int dtype, void* const* t, int B, int E, int H, int F, int NL, int L,
                    int Tm, int V, int idx, int l_view, int gen, void* stream);
int vct_decode_multi(int dtype, void* const* t, int B, int E, int H, int F, int NL, int L,
                     int Tm, int V, int l_view, int n_emb, int i0, int n_tok, int seq,
                     int poison, int start_id, int end_id, int pad_id, int out_ld,
                     void* stream);

// out: 7 ints, see SmallPlan
int vct_whole_step_plan(int dtype, int B, int E, int H, int F, int V, int route, int* out) {
  SmallPlan p;
  if (!small_plan(dtype, B, E, H, F, V, route, (int)step_smem_bytes(E, F), &p))
    return (int)cudaErrorInvalidValue;
  return plan_out(p, out);
}

int vct_multi_step_plan(int dtype, int B, int E, int H, int F, int V, int route, int* out) {
  SmallPlan p;
  if (!small_plan(dtype, B, E, H, F, V, route, multi_smem0(B, E, F), &p))
    return (int)cudaErrorInvalidValue;
  return plan_out(p, out);
}

// the multi-step rule at 1 to SEQ_MAX_B rows; route 0 is decode_multi_kernel
// in sequence mode
int vct_sequence_decode_plan(int dtype, int B, int E, int H, int F, int V, int route, int* out) {
  SmallPlan p;
  if (B > SEQ_MAX_B || !small_plan(dtype, B, E, H, F, V, route, multi_smem0(B, E, F), &p))
    return (int)cudaErrorInvalidValue;
  return plan_out(p, out);
}

// small_step_kernel: tensors as vct_decode_step takes them; gen 1 writes
// tokens (keys [B] scratch), gen 0 x_out. The caller has checked the plan.
// scratch: B * (18E + 2F) + 256E bytes.
int vct_small_step(void* const* t, int B, int E, int H, int F, int NL, int L, int Tm, int V,
                   int idx, int l_view, int gen, void* stream) {
  if (Tm > LMAX || l_view > LMAX || B < 1 || B > SS_MAX_ROWS) return (int)cudaErrorInvalidValue;
  StepArgs a;
  fill_step_args(a, t);
  a.B = B; a.E = E; a.H = H; a.F = F; a.NL = NL; a.L = L; a.Tm = Tm; a.V = V;
  a.idx = idx; a.l_view = l_view; a.gen = gen;
  return (int)launch_cooperative(small_step_kernel, a, (size_t)SS_SMEM, (cudaStream_t)stream, 1);
}

// fused_whole_step: tensors as vct_decode_step takes them; route -1 by the
// plan, 0 decode_step_kernel, 1 small_step_kernel. scratch: float32
// [B * (5E + F) + 64E].
int vct_whole_step(int dtype, void* const* t, int B, int E, int H, int F, int NL, int L, int Tm,
                   int V, int idx, int l_view, int route, void* stream) {
  SmallPlan p;
  if (!small_plan(dtype, B, E, H, F, V, route, 0, &p)) return (int)cudaErrorInvalidValue;
  if (p.route == 0)
    return vct_decode_step(dtype, t, B, E, H, F, NL, L, Tm, V, idx, l_view, 1, stream);
  return vct_small_step(t, B, E, H, F, NL, L, Tm, V, idx, l_view, 1, stream);
}

// fused_multi_step's window: tensors as vct_decode_multi takes them (keys
// [n_tok, B]); route -1 by the plan, 0 decode_multi_kernel, 1
// small_multi_kernel. scratch as vct_whole_step's.
int vct_multi_step(int dtype, void* const* t, int B, int E, int H, int F, int NL, int L, int Tm,
                   int V, int l_view, int n_emb, int i0, int n_tok, int poison, int pad_id,
                   int out_ld, int route, void* stream) {
  SmallPlan p;
  if (!small_plan(dtype, B, E, H, F, V, route, 0, &p) || n_tok < 1)
    return (int)cudaErrorInvalidValue;
  if (p.route == 0)
    return vct_decode_multi(dtype, t, B, E, H, F, NL, L, Tm, V, l_view, n_emb, i0, n_tok, 0,
                            poison, 0, -1, pad_id, out_ld, stream);
  return launch_small_multi(t, B, E, H, F, NL, L, Tm, V, l_view, n_emb, i0, n_tok, poison,
                            pad_id, out_ld, 0, 0, -1, stream);
}

// fused_sequence_decode: tensors as vct_decode_multi takes them (keys
// [n_tok, B], cur unused, tok_out [B, out_ld] with column 0 and the pad fill
// written); n_tok tokens from position 0; route -1 by the plan, 0
// decode_multi_kernel, 1 small_multi_kernel. scratch as vct_whole_step's.
int vct_sequence_decode(int dtype, void* const* t, int B, int E, int H, int F, int NL, int L,
                        int Tm, int V, int l_view, int n_emb, int n_tok, int start_id,
                        int end_id, int pad_id, int out_ld, int route, void* stream) {
  SmallPlan p;
  // tokens go to columns 1 .. n_tok
  if (B > SEQ_MAX_B || !small_plan(dtype, B, E, H, F, V, route, 0, &p) || n_tok < 1 ||
      n_tok >= out_ld)
    return (int)cudaErrorInvalidValue;
  if (p.route == 0)
    return vct_decode_multi(dtype, t, B, E, H, F, NL, L, Tm, V, l_view, n_emb, 0, n_tok, 1, 0,
                            start_id, end_id, pad_id, out_ld, stream);
  return launch_small_multi(t, B, E, H, F, NL, L, Tm, V, l_view, n_emb, 0, n_tok, 0, pad_id,
                            out_ld, 1, start_id, end_id, stream);
}

#ifdef VCT_SMALL_STAMPS
// the stamps of the last launch (ns): out[0] their count, then the stamps
int vct_small_stamps(unsigned long long* out) {
  int n = 0;
  cudaError_t err = cudaMemcpyFromSymbol(&n, g_small_nstamps, sizeof(int));
  if (err == cudaSuccess) {
    out[0] = (unsigned long long)n;
    err = cudaMemcpyFromSymbol(out + 1, g_small_stamps, sizeof(unsigned long long) * n);
  }
  return (int)err;
}
#endif

}  // extern "C"
