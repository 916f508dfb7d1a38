// Final norm + vocab projection + per-row top-k and logsumexp for Hopper
// (sm_90a), bound through a plain C interface (ctypes). Python side:
// vct_tpu_torch/ops/decode_kernels.py.
//
// Replaces vct_tpu/ops/pallas_decode.py:721 fused_norm_generator_topk
// (_gen_topk_kernel :677, _topk_rows :655): beam search's [B*K, V]
// log-softmax collapsed into k values, k ids and one logsumexp per row; the
// logits never reach device memory.
//
// What bounds it on an H100: at the beam rows of one eval batch (256) the
// bf16 generator (47 MB) is read once while 2 * 256 * 768 * 30720 operations
// are done, which puts bytes and operations within a factor of two of each
// other. The hi/lo product doubles the tensor-core work, and the k key passes
// of the epilogue, which run while the tensor cores wait, cost about as much
// as the product.
//
// The TPU kernel carries a running top-k and a running (max, sum) across its
// sequential vocab tiles; Hopper blocks run in no order, so the reduction has
// two phases, each with two routes chosen by the weights' dtype:
//   1. per (row, slab of 256 columns): the slab's k best 64-bit keys (value
//      bits, inverted id), its max and its sum of exp, into part_key /
//      part_m / part_s.
//      bfloat16 -> the tensor-core route: gen_wgmma.cuh (LayerNorm once per
//        row with yn split into bf16 hi + lo, one persistent block per SM
//        walking the slabs with all batch tiles against each, wgmma on the
//        transposed product; gen_argmax.cu's design) with TopkEpi as its
//        epilogue, in registers: the bias (PAD_BIAS past V, so a pad column's
//        exp is exactly 0 and no key pass takes it), k passes that each take
//        every row's largest key below the one taken before (a thread's four
//        columns, then the eight lanes that hold the row by a butterfly that
//        transposes as it reduces, then the eight warps in shared memory),
//        and the sum of exp after pass 0, whose key holds the max;
//      float32, and bfloat16 for checks that time the replaced kernel
//        (route 0) -> gen_topk_partial, grid (column blocks, 8-row batch
//        tiles): the loader and the product of gen_argmax_fma_kernel
//        (LayerNorm recomputed per block, fp32 logits on the CUDA cores), the
//        logits of 8 rows x 256 columns in shared memory, k passes of a warp
//        argmax per row;
//   2. gen_topk_merge, one warp per row: k argmax passes over the slabs'
//      candidates, and the (max, sum) pairs folded in a fixed order (each
//      lane its slabs in ascending order, then a butterfly across lanes).
// A key orders by value descending, then by vocab id ascending, and ids are
// unique, so the result is the k-pass first-win argmax of the reference
// (lowest id among equal logits, across slabs too) and does not change from
// run to run: no atomics, no order that depends on scheduling.

#include "gen_wgmma.cuh"

#define TOPK_TILES 8                 // column tiles (of TN) per block
#define TOPK_COLS (TOPK_TILES * TN)  // 256 columns per block
#define TOPK_MAX 32                  // largest k (any k <= TOPK_COLS would do)

namespace {

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
gen_topk_partial(const T* x, const float* ns, const float* nb, const T* wg, const float* bg,
                 u64* part_key, float* part_m, float* part_s, int B, int E, int V, int k) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = smem;
  float* red = smem + BT * E;
  float* lg = red + NWARPS * BT * TN;  // [BT][TOPK_COLS]
  const int b = blockIdx.y * BT + warp;
  if (b < B) {
    warp_layernorm<T, T>(x + (size_t)b * E, E, ns, nb, false, xs + warp * E, nullptr);
  } else {
    for (int c = lane; c < E; c += 32) xs[warp * E + c] = 0.f;
  }
  __syncthreads();
  const float neg_inf = -__int_as_float(0x7f800000);
  const int ct0 = blockIdx.x * TOPK_TILES;
  for (int t = 0; t < TOPK_TILES; ++t) {
    const int n = (ct0 + t) * TN + lane;
    float v = neg_inf;
    if (n - lane < V) {  // block-uniform: every thread takes part in the tile
      v = matvec_tile<T>(xs, E, wg, V, ct0 + t, red);
      v = n < V ? v + bg[n] : neg_inf;
    }
    lg[warp * TOPK_COLS + t * TN + lane] = v;
  }
  __syncwarp();  // a warp reads back only its own row
  if (b >= B) return;

  u64 keys[TOPK_TILES];
  float m = neg_inf;
#pragma unroll
  for (int t = 0; t < TOPK_TILES; ++t) {
    const float v = lg[warp * TOPK_COLS + t * TN + lane];
    const int n = (ct0 + t) * TN + lane;
    keys[t] = n < V ? argmax_key(v, n) : 0ull;
    m = fmaxf(m, v);
  }
  m = warp_max(m);  // finite: the block's first column is below V
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < TOPK_TILES; ++t) s += expf(lg[warp * TOPK_COLS + t * TN + lane] - m);
  s = warp_sum(s);
  const size_t slot = (size_t)b * gridDim.x + blockIdx.x;
  if (lane == 0) {
    part_m[slot] = m;
    part_s[slot] = s;
  }
  for (int p = 0; p < k; ++p) {
    u64 best = 0ull;
#pragma unroll
    for (int t = 0; t < TOPK_TILES; ++t) best = keys[t] > best ? keys[t] : best;
    best = warp_max_u64(best);
#pragma unroll
    for (int t = 0; t < TOPK_TILES; ++t)
      if (keys[t] == best) keys[t] = 0ull;  // ids are unique: one slot of one lane
    if (lane == 0) part_key[slot * k + p] = best;
  }
}

// one warp per row over its n_blk * k candidate keys and n_blk (max, sum)
// pairs -> topv [B, k], topi [B, k], lse [B]
__global__ void gen_topk_merge(const u64* part_key, const float* part_m, const float* part_s,
                               float* topv, int* topi, float* lse, int B, int n_blk, int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const u64* keys = part_key + (size_t)b * n_blk * k;
  const int n = n_blk * k;
  u64 prev = ~0ull;  // the last key taken: the next is the largest below it
  for (int p = 0; p < k; ++p) {
    u64 best = 0ull;
    for (int i = lane; i < n; i += 4 * 32) {  // four loads in flight a lane
      u64 c[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) c[u] = i + 32 * u < n ? keys[i + 32 * u] : 0ull;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c[u] < prev && c[u] > best) best = c[u];
    }
    best = warp_max_u64(best);
    if (lane == 0) {
      topv[(size_t)b * k + p] = key_value(best);
      topi[(size_t)b * k + p] = key_index(best);
    }
    prev = best;
  }
  const float* pm = part_m + (size_t)b * n_blk;
  const float* ps = part_s + (size_t)b * n_blk;
  float m = -__int_as_float(0x7f800000);
  for (int i = lane; i < n_blk; i += 32) m = fmaxf(m, pm[i]);
  m = warp_max(m);
  float s = 0.f;
  for (int i = lane; i < n_blk; i += 32) s += ps[i] * expf(pm[i] - m);
  s = warp_sum(s);
  if (lane == 0) lse[b] = m + logf(s);
}

// ---------------------------------------------------------------------------
// the tensor-core route: gen_wgmma.cuh's product with the top-k epilogue
// ---------------------------------------------------------------------------

constexpr float PAD_BIAS = -1e30f;  // the bias of a column past V

// Reduces v[n] of each of the eight lanes that share q (lane % 4) with op:
// three butterfly steps (xor 16, 8, 4), each halving the values a lane holds,
// so that afterwards v[i], i < n / 8, is slot (lane & 28) * n / 32 + i reduced
// over those lanes: 7 n / 8 shuffles where one reduction per slot takes 3 n.
// The order of the operands is fixed, so a float sum has the same bits on
// every run.
template <int N, typename T, typename Op>
__device__ __forceinline__ void lane_transpose_reduce(T (&v)[N], Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int step = 0; step < 3; ++step) {
    const int o = 16 >> step, half = N >> (step + 1);
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const T send = up ? v[i] : v[i + half];
      const T keep = up ? v[i + half] : v[i];
      v[i] = op(keep, __shfl_xor_sync(0xffffffffu, send, o));
    }
  }
}

// Per (batch row, slab): the row's float32 max and sum of exp over the slab's
// 256 columns and its k best 64-bit keys, written where gen_topk_merge reads
// them (slot = row * n_blk + slab, n_blk = the slabs).
struct TopkEpi {
  u64* part_key;
  float* part_m;
  float* part_s;
  int k, n_blk;

  // per warp and row a key and a float; per row the last key taken
  template <int NB> static constexpr int smem_bytes() {
    return 8 * NB * ((int)sizeof(u64) + (int)sizeof(float)) + NB * (int)sizeof(u64);
  }

  // acc[mi][4 j + r]: vocab column mi * 64 + w4 * 16 + g + 8 * (r / 2) of the
  // warpgroup's 128, batch row 8 j + 2 q + r % 2: a row's 256 columns lie
  // four to a thread over the eight lanes that share q and the eight warps.
  // A thread's rows go through the lane reductions in groups of SL slots (j
  // of the group, then r % 2).
  template <int NB>
  __device__ __forceinline__ void tile(float (&acc)[2][NB / 2], const float* bg, int slab, int mt,
                                       int B, int V, unsigned char* smem) const {
    constexpr int SL = 8, GROUPS = NB / 4 / SL;
    u64* skeys = reinterpret_cast<u64*>(smem);          // [8 warps][NB]
    u64* taken = skeys + 8 * NB;                        // [NB]: the key taken last
    float* red = reinterpret_cast<float*>(taken + NB);  // [8 warps][NB]
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wgid = warp >> 2, w4 = warp & 3, q = lane & 3;
    const int v0 = slab * GA_BN + wgid * 128 + w4 * 16 + (lane >> 2);
    // the tile row of the slot a lane holds after a reduction of group grp
    const int sl_here = (lane & 28) * SL / 32;
    const int row_here_0 = 8 * (sl_here / 2) + 2 * q + sl_here % 2;  // + 8 * SL / 2 per group
    // the logits: a column past V has zero weights and the PAD_BIAS bias, so
    // its exp is exactly 0; the key passes skip it
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int v = v0 + mi * 64 + rr * 8;
        const float bv = v < V ? bg[v] : PAD_BIAS;
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          acc[mi][4 * j + 2 * rr] += bv;
          acc[mi][4 * j + 2 * rr + 1] += bv;
        }
      }
    auto umax = [](u64 a, u64 b) { return a > b ? a : b; };
    // k passes: each the largest key below the one taken before (keys are
    // unique, so this is the k-pass first-win argmax); 0 when the slab has no
    // column left. Pass 0's key holds the row's max, which the sum of exp
    // takes after it.
    for (int pass = 0; pass < k; ++pass) {
#pragma unroll
      for (int grp = 0; grp < GROUPS; ++grp) {
        u64 best[SL];
#pragma unroll
        for (int sl = 0; sl < SL; ++sl) {
          const int j = grp * SL / 2 + sl / 2, c = sl % 2;
          const u64 below = pass == 0 ? ~0ull : taken[8 * j + 2 * q + c];
          best[sl] = 0ull;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int v = v0 + mi * 64 + rr * 8;
              const u64 key = argmax_key(acc[mi][4 * j + 2 * rr + c], v);
              if (v < V && key < below && key > best[sl]) best[sl] = key;
            }
        }
        lane_transpose_reduce(best, umax);
        skeys[warp * NB + row_here_0 + grp * 4 * SL] = best[0];
      }
      __syncthreads();
      if (tid < NB) {
        u64 best = skeys[tid];
#pragma unroll
        for (int w = 1; w < 8; ++w) best = umax(best, skeys[w * NB + tid]);
        taken[tid] = best;
        if (mt * NB + tid < B) part_key[((size_t)(mt * NB + tid) * n_blk + slab) * k + pass] = best;
      }
      __syncthreads();
      if (pass > 0) continue;
      // the sum of exp(v - max), in a fixed order: the lane butterfly, warps 0..7
#pragma unroll
      for (int grp = 0; grp < GROUPS; ++grp) {
        float sum[SL];
#pragma unroll
        for (int sl = 0; sl < SL; ++sl) {
          const int j = grp * SL / 2 + sl / 2, c = sl % 2;
          const float m = key_value(taken[8 * j + 2 * q + c]);
          sum[sl] = (expf(acc[0][4 * j + c] - m) + expf(acc[0][4 * j + 2 + c] - m)) +
                    (expf(acc[1][4 * j + c] - m) + expf(acc[1][4 * j + 2 + c] - m));
        }
        lane_transpose_reduce(sum, [](float a, float b) { return a + b; });
        red[warp * NB + row_here_0 + grp * 4 * SL] = sum[0];
      }
      __syncthreads();
      if (tid < NB && mt * NB + tid < B) {
        float s = red[tid];
#pragma unroll
        for (int w = 1; w < 8; ++w) s += red[w * NB + tid];
        const size_t slot = (size_t)(mt * NB + tid) * n_blk + slab;
        part_m[slot] = key_value(taken[tid]);
        part_s[slot] = s;
      }
    }
  }

  __device__ __forceinline__ void finish(int, unsigned char*) const {}
};

// ---------------------------------------------------------------------------
// the launch plan (GenPlan in gen_wgmma.cuh). Route 1 is the tensor-core
// route, route 0 gen_topk_partial: units of 8 rows x 256 columns, no K step
// or stages, batch tiles, column blocks, 0. Both end in gen_topk_merge.
// ---------------------------------------------------------------------------

bool topk_plan(int dtype, int B, int E, int V, int k, int route, GenPlan* out) {
  if (B < 1 || E < 8 || V < 8 || E % 8 || V % 8 || k < 1 || k > TOPK_MAX || k > V ||
      route > 1 || (route == 1 && dtype != 1))
    return false;
  GenPlan p;
  if ((route < 0 ? (dtype == 1 ? 1 : 0) : route) == 1) {
    p = gen_tc_plan<TopkEpi>(B, V);
  } else {
    p.route = 0;
    p.bm = BT; p.bn = TOPK_COLS; p.bk = 0; p.stages = 0;
    p.smem = (int)sizeof(float) * (BT * E + NWARPS * BT * TN + BT * TOPK_COLS);
    p.m_tiles = (B + BT - 1) / BT;
    p.n_tiles = (V + TOPK_COLS - 1) / TOPK_COLS;
    p.b_pad = 0;
  }
  *out = p;
  return p.smem <= SMEM_LIMIT;
}

template <typename T>
static cudaError_t launch_partial(const GenPlan& p, const void* x, const void* ns, const void* nb,
                                  const void* wg, const void* bg, void* part_key, void* part_m,
                                  void* part_s, int B, int E, int V, int k, cudaStream_t st) {
  auto kernel = gen_topk_partial<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.n_tiles, p.m_tiles), NTHREADS, p.smem, st>>>(
      (const T*)x, (const float*)ns, (const float*)nb, (const T*)wg, (const float*)bg,
      (u64*)part_key, (float*)part_m, (float*)part_s, B, E, V, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// column blocks of the partial phase for a vocab of V columns: the caller
// sizes part_key [B, n, k] (u64), part_m and part_s [B, n] (f32) with it
int vct_gen_topk_blocks(int V) { return (V + TOPK_COLS - 1) / TOPK_COLS; }

// dtype: 0 = float32, 1 = bfloat16. route: -1 = by the dtype (bfloat16 ->
// tensor cores, float32 -> gen_topk_partial), which is what the package's
// wrapper always passes; 0 (either dtype) and 1 (bfloat16 only) are for
// checks that time or test one kernel against the other. out: 9 ints, see
// GenPlan.
int vct_gen_topk_plan(int dtype, int B, int E, int V, int k, int route, int* out) {
  GenPlan p;
  if (!topk_plan(dtype, B, E, V, k, route, &p)) return (int)cudaErrorInvalidValue;
  const int vals[9] = {p.route, p.bm, p.bn, p.bk, p.stages, p.smem, p.m_tiles, p.n_tiles,
                       p.b_pad};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

// part_key [B, n, k] (u64), part_m and part_s [B, n] (f32), n =
// vct_gen_topk_blocks(V); parts: bfloat16 scratch [2, b_pad, E] of the plan
// (tensor-core route only).
int vct_gen_topk(int dtype, const void* x, const void* ns, const void* nb, const void* wg,
                 const void* bg, void* part_key, void* part_m, void* part_s, void* topv,
                 void* topi, void* lse, void* parts, int B, int E, int V, int k, int route,
                 void* stream) {
  GenPlan p;
  if (!topk_plan(dtype, B, E, V, k, route, &p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_blk = vct_gen_topk_blocks(V);
  cudaError_t err;
  if (p.route == 1) {
    if (!parts) return (int)cudaErrorInvalidValue;
    err = launch_gen_tc(p, x, ns, nb, parts, wg, bg, nullptr, B, E, V,
                        TopkEpi{(u64*)part_key, (float*)part_m, (float*)part_s, k, n_blk}, st);
  } else {
    err = dtype == 1 ? launch_partial<__nv_bfloat16>(p, x, ns, nb, wg, bg, part_key, part_m,
                                                     part_s, B, E, V, k, st)
                     : launch_partial<float>(p, x, ns, nb, wg, bg, part_key, part_m, part_s, B,
                                             E, V, k, st);
  }
  if (err != cudaSuccess) return (int)err;
  gen_topk_merge<<<(B + 3) / 4, 128, 0, st>>>((const u64*)part_key, (const float*)part_m,
                                              (const float*)part_s, (float*)topv, (int*)topi,
                                              (float*)lse, B, n_blk, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
