// Greedy decode-step kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes). Python side: vct_tpu_torch/ops/decode_kernels.py.
//
// Replaces (vct_tpu/ops/pallas_decode.py):
//   * fused_layers_step   (:516, _layers_step_kernel :373 via _stack_layers :322)
//   * fused_whole_step    (:581, _whole_step_kernel :397)
//   * fused_norm_generator_argmax (:811, _gen_argmax_kernel :783)
//   * fused_layer_step    (:211, _layer_step_kernel :155): decode_step_kernel
//     at NL = 1 over one layer's un-stacked weights and [L, B, E] caches
//
// What bounds them on an H100: at the serving batch (B <= 64) one token is a
// chain of matrix-vector products, so a step is bound by weight bytes: ~40 MB
// of stacked decoder weights plus the 48.8 MB bf16 generator at the MSVD
// widths, against 3.35 TB/s of HBM. Every product depends on the whole
// previous row, an order the TPU grid gave for free and Hopper blocks do not
// have.
//
// Design (the device code is in decode_common.cuh, which decode_multi.cu and
// gen_topk.cu share):
//   * decode_step_kernel is ONE persistent cooperative launch per token. The
//     step is a sequence of phases separated by grid.sync(); in each matvec
//     phase a work unit is (32 output columns x 8 batch rows), its 8 warps
//     split the reduction dimension and read the weights in 16-byte loads,
//     so every weight column tile is fetched by the units of one phase at the
//     same time (L2 serves the batch tiles after the first). The attention
//     phases take one warp per (row, head).
//   * LayerNorm is fused into the loader of the next product: each unit
//     recomputes the statistics of its 8 rows (fp32, two passes), rounds to
//     the compute dtype where the reference does, and the units of column
//     tile 0 also write the fp32 residual the later epilogue adds.
//   * The fresh K/V row is written into the cache before attention (no
//     in-register "fresh row" patch: that was a TPU layout device), and
//     attention covers rows 0..min(idx, l_view - 1).
//   * The argmax over the vocab reduces across blocks with a 64-bit atomicMax
//     on (order-preserving float bits << 32) | (0xFFFFFFFF - index): the
//     largest logit wins and, among equal logits, the lowest index (first-win,
//     like the reference's running argmax).
//   * Products are written by hand with fp32 accumulation (no cuBLAS). Making
//     them fast (wgmma, TMA, CUDA graphs over the per-token loop) is later
//     work.
//
// Rounding points follow the reference exactly: x in the compute dtype
// between layers; q, products and the residual stream into each LayerNorm in
// fp32; the attention outputs, the LayerNorm outputs feeding a product and
// the GELU output rounded to the compute dtype; yn in fp32 times the
// compute-dtype generator with fp32 accumulation.

#include "decode_common.cuh"

// ---------------------------------------------------------------------------
// the persistent decode-step kernel
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2) decode_step_kernel(StepArgs a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  if (a.gen && blockIdx.x == 0)
    for (int b = threadIdx.x; b < a.B; b += NTHREADS) a.keys[b] = 0ull;
  decode_token<T>(a, grid, smem, a.idx, nullptr, a.keys);
  if (a.gen && blockIdx.x == 0) {
    int* tok = (int*)a.out;
    for (int b = threadIdx.x; b < a.B; b += NTHREADS)
      tok[b] = a.idx >= a.l_view ? -1 : key_index(a.keys[b]);
  }
}

// ---------------------------------------------------------------------------
// standalone final norm + generator + argmax
// ---------------------------------------------------------------------------

#define GEN_TILES_PER_BLOCK 8

// grid (ceil(column tiles / GEN_TILES_PER_BLOCK), batch tiles); each block
// normalises its BT rows once and sweeps its column tiles.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
gen_argmax_kernel(const T* x, const float* ns, const float* nb, const T* wg,
                  const float* bg, u64* keys, int B, int E, int V) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = smem;
  float* red = smem + BT * E;
  const int b = blockIdx.y * BT + warp;
  if (b < B) {
    warp_layernorm<T, T>(x + (size_t)b * E, E, ns, nb, false, xs + warp * E, nullptr);
  } else {
    for (int k = lane; k < E; k += 32) xs[warp * E + k] = 0.f;
  }
  __syncthreads();
  const int n_ct = (V + TN - 1) / TN;
  const int ct0 = blockIdx.x * GEN_TILES_PER_BLOCK;
  for (int ct = ct0; ct < min(ct0 + GEN_TILES_PER_BLOCK, n_ct); ++ct) {
    float v = matvec_tile<T>(xs, E, wg, V, ct, red);
    const int n = ct * TN + lane;
    const bool ok = b < B && n < V;
    u64 key = warp_max_u64(ok ? argmax_key(v + bg[n], n) : 0ull);
    if (lane == 0 && b < B) atomicMax(keys + b, key);
  }
}

__global__ void keys_to_tokens_kernel(const u64* keys, int* tok, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) tok[b] = key_index(keys[b]);
}

// ---------------------------------------------------------------------------
// host entry points (plain C, bound with ctypes)
// ---------------------------------------------------------------------------

extern "C" {

// tensors: host array of device pointers in StepArgs order, from x to keys
// (31 entries; unused ones may be null). dtype: 0 = float32, 1 = bfloat16.
int vct_decode_step(int dtype, void* const* t, int B, int E, int H, int F, int NL, int L,
                    int Tm, int V, int idx, int l_view, int gen, void* stream) {
  StepArgs a;
  fill_step_args(a, t);
  a.B = B; a.E = E; a.H = H; a.F = F; a.NL = NL; a.L = L; a.Tm = Tm; a.V = V;
  a.idx = idx; a.l_view = l_view; a.gen = gen;
  if (Tm > LMAX || l_view > LMAX || E % H != 0 || E % 8 || F % 8 || V % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = step_smem_bytes(E, F);
  return (int)(dtype == 1 ? launch_cooperative(decode_step_kernel<__nv_bfloat16>, a, smem, st)
                          : launch_cooperative(decode_step_kernel<float>, a, smem, st));
}

// keys must hold zeros on entry (the wrapper allocates them that way).
int vct_gen_argmax(int dtype, const void* x, const void* ns, const void* nb, const void* wg,
                   const void* bg, void* keys, void* tok, int B, int E, int V, void* stream) {
  if (E % 8 || V % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = sizeof(float) * ((size_t)BT * E + (size_t)NWARPS * BT * TN);
  const int n_ct = (V + TN - 1) / TN;
  dim3 grid((n_ct + GEN_TILES_PER_BLOCK - 1) / GEN_TILES_PER_BLOCK, (B + BT - 1) / BT);
  cudaError_t err;
  if (dtype == 1) {
    auto k = gen_argmax_kernel<__nv_bfloat16>;
    if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return (int)err;
    k<<<grid, NTHREADS, smem, st>>>((const __nv_bfloat16*)x, (const float*)ns,
                                    (const float*)nb, (const __nv_bfloat16*)wg,
                                    (const float*)bg, (u64*)keys, B, E, V);
  } else {
    auto k = gen_argmax_kernel<float>;
    if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return (int)err;
    k<<<grid, NTHREADS, smem, st>>>((const float*)x, (const float*)ns, (const float*)nb,
                                    (const float*)wg, (const float*)bg, (u64*)keys, B, E, V);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  keys_to_tokens_kernel<<<(B + 255) / 256, 256, 0, st>>>((const u64*)keys, (int*)tok, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
