// The bfloat16 decoder-stack step on tensor cores for Hopper (sm_90a), bound
// through a plain C interface (ctypes). Python side:
// vct_tpu_torch/ops/decode_kernels.py (``fused_layers_step``,
// ``fused_layer_step``, ``stack_step_plan``).
//
// Replaces (vct_tpu/ops/pallas_decode.py): fused_layers_step (:516,
// _layers_step_kernel :373 via _stack_layers :322) in bfloat16, and
// fused_layer_step (:211, _layer_step_kernel :155) as the stack at NL = 1,
// where decode_step.cu's decode_step_kernel served them with products on the
// CUDA cores. float32, and any shape past the plan's limits, keep that kernel
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

#include "stack_phases.cuh"

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
constexpr int SK_RING = SK_STAGES * SK_STAGE;
constexpr int SK_SMEM = SK_RING > SK_ATTN ? SK_RING : SK_ATTN;
// Rows the rule gives it: greedy decode sends 65 and more to
// fused_layers_step (64 and fewer run the whole-step kernel), beam search up
// to 64 videos x a beam of 32. At 64 rows and fewer the rule takes the
// small-row kernel (small_step.cu), whose sums are the whole-step kernel's,
// so that beam search at width 1 gives greedy decode's tokens at every batch
// size; route 1 asked for runs this kernel at any row count up to
// STACK_MAX_ROWS.
constexpr int STACK_MIN_ROWS = 65;
constexpr int STACK_MAX_ROWS = 2048;

constexpr int SK_COMP_K = 1024;   // a deeper K adds its steps' sums with compensation

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
// dynamic shared memory, why}. Route 1 is stack_step_kernel, route 2 the
// small-row kernel (small_step.cu without the generator: units of an m16 row
// tile x 8 columns, A chunks of 256 k), route 0 decode_step_kernel. Route -1
// (what fused_layers_step and fused_layer_step pass) takes route 2 for
// bfloat16 at 1-64 rows and route 1 at 65-2048 when every limit below holds,
// and says by ``why`` which did not: 0 route 1 or 2 by the rule; 1 route 0
// asked for; 2 float32; 3 rows above STACK_MAX_ROWS; 4 a width (E or F) that
// is not a multiple of 64; 5 E above SK_EMAX; 6 a head width that is not a
// multiple of 8 or is above SK_DMAX; 7 at 64 rows and fewer, F above
// SS_MAX_K. Route 1 asked for runs at
// 1-2048 rows, route 2 at 1-64, each within its limits.
// ---------------------------------------------------------------------------

struct StackPlan {
  int route, bm, bn, bk, stages, smem, why;
};

bool stack_plan(int dtype, int B, int E, int H, int F, int route, StackPlan* out) {
  if (B < 1 || E < 1 || H < 1 || F < 1 || E % H || route < -1 || route > 2) return false;
  const int D = E / H;
  int why = 0;
  if (route == 0) why = 1;
  else if (dtype != 1) why = 2;
  else if (B > STACK_MAX_ROWS) why = 3;
  else if (E % 64 || F % 64) why = 4;
  else if (E > SK_EMAX) why = 5;
  else if (D % 8 || D > SK_DMAX) why = 6;
  else if (B < STACK_MIN_ROWS && route != 1) why = small_why(dtype, B, E, H, F, 2);
  const int by_rule = why ? 0 : (B < STACK_MIN_ROWS ? 2 : 1);
  if (route == 2 && (why || by_rule != 2)) return false;   // route 2 only at its rows
  if (route == 1 && why) return false;
  StackPlan p;
  p.route = route > 0 ? route : by_rule;
  p.why = why;
  if (p.route == 1) {
    p.bm = SK_BM; p.bn = SK_BN; p.bk = SK_BK; p.stages = SK_STAGES; p.smem = SK_SMEM;
  } else if (p.route == 2) {
    p.bm = 16; p.bn = SS_G; p.bk = SS_KC; p.stages = SS_STAGES; p.smem = SS_SMEM;
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
int vct_small_step(void* const* t, int B, int E, int H, int F, int NL, int L, int Tm, int V,
                   int idx, int l_view, int gen, void* stream);

// out: 7 ints, see StackPlan
int vct_stack_step_plan(int dtype, int B, int E, int H, int F, int route, int* out) {
  StackPlan p;
  if (!stack_plan(dtype, B, E, H, F, route, &p)) return (int)cudaErrorInvalidValue;
  const int vals[7] = {p.route, p.bm, p.bn, p.bk, p.stages, p.smem, p.why};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

// fused_layers_step, and fused_layer_step at NL = 1: tensors as
// vct_decode_step takes them (the generator's null); route -1 by the plan,
// 0 decode_step_kernel, 1 stack_step_kernel, 2 the small-row kernel.
// scratch: float32 [B * (5E + F)], of which routes 1 and 2 use B * (18E +
// 2F) bytes.
int vct_stack_step(int dtype, void* const* t, int B, int E, int H, int F, int NL, int L, int Tm,
                   int idx, int l_view, int route, void* stream) {
  StackPlan p;
  if (!stack_plan(dtype, B, E, H, F, route, &p) || Tm > LMAX || l_view > LMAX)
    return (int)cudaErrorInvalidValue;
  if (p.route == 0)
    return vct_decode_step(dtype, t, B, E, H, F, NL, L, Tm, 0, idx, l_view, 0, stream);
  if (p.route == 2) return vct_small_step(t, B, E, H, F, NL, L, Tm, 0, idx, l_view, 0, stream);
  StepArgs a;
  fill_step_args(a, t);
  a.B = B; a.E = E; a.H = H; a.F = F; a.NL = NL; a.L = L; a.Tm = Tm; a.V = 0;
  a.idx = idx; a.l_view = l_view; a.gen = 0;
  // one block per SM: with two, the phases that keep fewer blocks than SMs
  // busy ran slower (a block's units shared an SM with another's)
  return (int)launch_cooperative(stack_step_kernel, a, (size_t)SK_SMEM, (cudaStream_t)stream, 1);
}

}  // extern "C"
