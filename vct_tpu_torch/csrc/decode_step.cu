// Greedy decode-step kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes). Python side: vct_tpu_torch/ops/decode_kernels.py.
//
// decode_step_kernel is the CUDA-core route. In bfloat16 the tensor-core
// kernels took its main work: small_step.cu (fused_whole_step,
// fused_layers_step and fused_layer_step at 1-64 rows, launched through
// vct_whole_step / vct_stack_step) and stack_step.cu (fused_layers_step and
// fused_layer_step at 65-2048 rows). It still runs float32 and bfloat16 rows
// or widths outside those kernels' plans (whole_step_plan, stack_step_plan
// name the rule by ``why``), and stays reachable by route 0 for same-run
// timing.
//
// Replaces (vct_tpu/ops/pallas_decode.py), on the routes above:
//   * fused_layers_step   (:516, _layers_step_kernel :373 via _stack_layers :322)
//   * fused_whole_step    (:581, _whole_step_kernel :397)
//   * (fused_norm_generator_argmax :811 on its own is gen_argmax.cu; the
//     whole-step kernel runs the same projection as its last phase)
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
//   * Products are written by hand with fp32 accumulation on the CUDA cores
//     (no cuBLAS): at the serving batch a step is a chain of matrix-vector
//     products bound by weight bytes. The standalone generator + argmax, which
//     runs at B > 64, has a tensor-core kernel of its own (gen_argmax.cu).
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

}  // extern "C"
