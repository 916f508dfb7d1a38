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
// other; this first version does its products on the CUDA cores (fp32
// accumulation, no wgmma) and re-reads the generator from L2 once per 8-row
// batch tile, so it runs far above the bound. Making it fast is later work.
//
// Design. The TPU kernel carries a running top-k and a running (max, sum)
// across its sequential vocab tiles; Hopper blocks run in no order, so the
// reduction has two phases:
//   1. gen_topk_partial, grid (column blocks, 8-row batch tiles): the loader
//      and the product of gen_argmax_fma_kernel (LayerNorm with fp32 statistics
//      kept in fp32, fp32 logits). A block keeps the logits of its 8 rows x
//      256 columns in shared memory; each warp then takes its row's k best
//      by k passes of a warp argmax on 64-bit keys (value bits, inverted
//      index), and the row's (max, sum of exp) over the block's columns.
//   2. gen_topk_merge, one warp per row: k argmax passes over the blocks'
//      candidates, and the (max, sum) pairs folded in a fixed order (each
//      lane its blocks in ascending order, then a butterfly across lanes).
// A key orders by value descending, then by vocab id ascending, and ids are
// unique, so the result is the k-pass first-win argmax of the reference
// (lowest id among equal logits, across tiles too) and does not change from
// run to run: no atomics, no order that depends on scheduling. Pad columns
// carry a NEG_INF bias: exp underflows to exactly 0 and they never enter
// the top-k.

#include "decode_common.cuh"

#define TOPK_TILES 8                 // column tiles (of TN) per block
#define TOPK_COLS (TOPK_TILES * TN)  // 256 columns per block
#define TOPK_MAX 32                  // largest k (any k <= TOPK_COLS would do)

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
    for (int i = lane; i < n; i += 32) {
      const u64 c = keys[i];
      if (c < prev && c > best) best = c;
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

template <typename T>
static cudaError_t launch_topk(const void* x, const void* ns, const void* nb, const void* wg,
                               const void* bg, void* part_key, void* part_m, void* part_s,
                               void* topv, void* topi, void* lse, int B, int E, int V, int k,
                               int n_blk, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)BT * E + (size_t)NWARPS * BT * TN +
                                       (size_t)BT * TOPK_COLS);
  auto kernel = gen_topk_partial<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_blk, (B + BT - 1) / BT);
  kernel<<<grid, NTHREADS, smem, st>>>((const T*)x, (const float*)ns, (const float*)nb,
                                       (const T*)wg, (const float*)bg, (u64*)part_key,
                                       (float*)part_m, (float*)part_s, B, E, V, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gen_topk_merge<<<(B + 3) / 4, 128, 0, st>>>((const u64*)part_key, (const float*)part_m,
                                              (const float*)part_s, (float*)topv, (int*)topi,
                                              (float*)lse, B, n_blk, k);
  return cudaGetLastError();
}

extern "C" {

// column blocks of the partial phase for a vocab of V columns: the caller
// sizes part_key [B, n, k] (u64), part_m and part_s [B, n] (f32) with it
int vct_gen_topk_blocks(int V) { return (V + TOPK_COLS - 1) / TOPK_COLS; }

int vct_gen_topk(int dtype, const void* x, const void* ns, const void* nb, const void* wg,
                 const void* bg, void* part_key, void* part_m, void* part_s, void* topv,
                 void* topi, void* lse, int B, int E, int V, int k, void* stream) {
  if (E % 8 || V % 8 || k < 1 || k > TOPK_MAX || k > V) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_blk = vct_gen_topk_blocks(V);
  return (int)(dtype == 1
                   ? launch_topk<__nv_bfloat16>(x, ns, nb, wg, bg, part_key, part_m, part_s,
                                                topv, topi, lse, B, E, V, k, n_blk, st)
                   : launch_topk<float>(x, ns, nb, wg, bg, part_key, part_m, part_s, topv,
                                        topi, lse, B, E, V, k, n_blk, st));
}

}  // extern "C"
