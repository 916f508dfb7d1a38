// Final LayerNorm + vocab projection + first-win argmax for Hopper (sm_90a),
// bound through a plain C interface (ctypes). Python side:
// vct_tpu_torch/ops/decode_kernels.py (fused_norm_generator_argmax).
//
// Replaces vct_tpu/ops/pallas_decode.py fused_norm_generator_argmax (:811,
// _gen_argmax_kernel :783): yn = LayerNorm(x) in float32, logits = yn . wg +
// bg with float32 accumulation, running (max, argmax) over the vocab, lowest
// index wins ties; the [B, V] logits are never stored.
//
// What bounds it on an H100: bytes. The bfloat16 generator weight (E x V_pad,
// 47.2 MB at E = 768, V_pad = 30720) must cross HBM once (0.014 ms at 3.35
// TB/s); the product itself (2 B E V operations, 6 GFLOP at B = 128) is under
// 0.01 ms on the tensor cores.
//
// Two routes, chosen by the weights' dtype in the host launcher:
//
//   bfloat16 -> the tensor-core route (gen_wgmma.cuh: gen_norm_split_kernel,
//   then gen_wgmma_kernel with ArgmaxEpi as its epilogue; gen_topk.cu runs
//   the same product with its top-k epilogue):
//   * LayerNorm once per row, in a prologue of one warp per row, with the
//     float32 statistics of the reference. yn stays float32 in the reference,
//     so it is split yn = hi + lo into two bfloat16 parts (hi = bf16(yn), lo =
//     bf16(yn - hi)) which keep about 16 mantissa bits of yn, and the product
//     is hi . wg + lo . wg accumulated in one float32 accumulator: twice the
//     tensor-core work (12 GFLOP at B = 128, 0.012 ms at the card's peak).
//     The prologue also zeroes the argmax keys and a count of finished blocks.
//   * The weight crosses HBM once: a block owns a slab of 256 vocab columns
//     and carries ALL batch rows against it (batch tiles of 128 rows, 64 when
//     B <= 64; pad rows are zeros written by the prologue). For B above one
//     batch tile the block runs the tiles one after the other over the same
//     slab, which its own first pass left in L2. One persistent block per SM
//     walks the slabs blockIdx.x, blockIdx.x + gridDim.x, ... (120 slabs at
//     V_pad = 30720: one each). Every block reads all of the hi/lo parts once
//     per slab from L2, so a slab this wide halves that traffic against 128
//     columns, which measured slower.
//   * K = E in steps of 64 through a 3-stage cp.async ring (16-byte copies,
//     zero fill past E and past V); the ring runs across slab and batch-tile
//     boundaries, so the next tiles are in flight during an epilogue.
//   * wgmma.m64nNk16 with the product transposed, logits^T [vocab, batch] =
//     wg^T . yn^T (the comment above the kernel has the operand layouts): the
//     [E, V] row-major weight, whose N is contiguous, never needs a
//     transposed shared-memory descriptor, because each warp reads its 16
//     vocab columns of the tile with ldmatrix.trans into the register operand;
//     the batch rows are the K-major operand the tensor cores read from
//     shared memory. A weight fragment is loaded once and used against the hi
//     and the lo rows. An mma.sync version of the same tiling was 20% slower
//     at B = 128 (its ldmatrix traffic for both operands competes with the
//     products for shared memory).
//   * Epilogue in registers: add bg, each thread scans its four vocab columns
//     of a batch row in ascending order (strict >, so the first wins), then
//     the 64-bit order-preserving key (value bits, inverted global column) is
//     reduced over the eight lanes that hold the row with shuffles, over the
//     eight warps in shared memory, and one atomicMax per (row, slab) merges
//     the blocks. Every candidate carries its own global column, and max is
//     order-independent: the tokens are the same from run to run. The block
//     that finishes last (a counter after a __threadfence) writes the tokens.
//
//   float32 -> the CUDA-core route (gen_argmax_fma_kernel): (32 columns x 8
//   rows) units of matvec_tile, LayerNorm recomputed per block, as before the
//   tensor-core route existed. float32 has no bf16 tensor-core product that
//   keeps its mantissa, and only the card tests use it.

#include "gen_wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// the CUDA-core route
// ---------------------------------------------------------------------------

constexpr int GEN_TILES_PER_BLOCK = 8;

// grid (ceil(column tiles / GEN_TILES_PER_BLOCK), batch tiles); each block
// normalises its BT rows once and sweeps its column tiles.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
gen_argmax_fma_kernel(const T* x, const float* ns, const float* nb, const T* wg,
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
// the tensor-core route: gen_wgmma.cuh's product with the argmax epilogue
// ---------------------------------------------------------------------------

struct ArgmaxEpi {
  u64* keys;   // [B + 1]: the rows' keys, then the count of finished blocks
  int* tok;

  template <int NB> static constexpr int smem_bytes() { return 8 * NB * (int)sizeof(u64); }

  // acc[mi][4 j + r]: vocab column mi * 64 + w4 * 16 + g + 8 * (r / 2) of the
  // warpgroup's 128, batch row 8 j + 2 q + r % 2. A thread's four columns
  // ascend with (mi, r / 2).
  template <int NB>
  __device__ __forceinline__ void tile(float (&acc)[2][NB / 2], const float* bg, int slab, int mt,
                                       int B, int V, unsigned char* smem) const {
    u64* skeys = reinterpret_cast<u64*>(smem);  // [8 warps][NB]
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wgid = warp >> 2, w4 = warp & 3, g = lane >> 2, q = lane & 3;
    const int v0 = slab * GA_BN + wgid * 128 + w4 * 16 + g;
    float bgv[2][2];
    bool okv[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int v = v0 + mi * 64 + rr * 8;
        okv[mi][rr] = v < V;
        bgv[mi][rr] = okv[mi][rr] ? bg[v] : 0.f;
      }
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float best = -__int_as_float(0x7f800000);
        int at = v0;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float v = acc[mi][4 * j + 2 * rr + c] + bgv[mi][rr];
            if (okv[mi][rr] && v > best) { best = v; at = v0 + mi * 64 + rr * 8; }
          }
        u64 key = okv[0][0] ? argmax_key(best, at) : 0ull;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {   // the eight lanes that share q
          const u64 other = __shfl_xor_sync(0xffffffffu, key, o);
          key = other > key ? other : key;
        }
        if (g == 0) skeys[warp * NB + 8 * j + 2 * q + c] = key;
      }
    __syncthreads();
    if (tid < NB) {
      const int row = mt * NB + tid;
      u64 key = skeys[tid];
#pragma unroll
      for (int w = 1; w < 8; ++w) key = skeys[w * NB + tid] > key ? skeys[w * NB + tid] : key;
      if (row < B && key) atomicMax(keys + row, key);
    }
  }

  // the block that finishes last turns the keys into tokens
  __device__ __forceinline__ void finish(int B, unsigned char*) const {
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(keys + B, 1ull) == (u64)gridDim.x - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      for (int b = threadIdx.x; b < B; b += GA_THREADS) tok[b] = key_index(__ldcg(keys + b));
    }
  }
};

// ---------------------------------------------------------------------------
// the launch plan (GenPlan in gen_wgmma.cuh). Route 0 is the CUDA-core
// route, whose entries are its unit's rows and columns, no K step or stages,
// batch tiles, column-tile groups, 0.
// ---------------------------------------------------------------------------

// false for what no route takes
bool gen_plan(int dtype, int B, int E, int V, int route, GenPlan* out) {
  if (B < 1 || E < 8 || V < 8 || E % 8 || V % 8 || route > 1 || (route == 1 && dtype != 1))
    return false;
  GenPlan p;
  if ((route < 0 ? (dtype == 1 ? 1 : 0) : route) == 1) {
    p = gen_tc_plan<ArgmaxEpi>(B, V);
  } else {
    p.route = 0;
    p.bm = BT; p.bn = TN; p.bk = 0; p.stages = 0;
    p.smem = (int)sizeof(float) * (BT * E + NWARPS * BT * TN);
    p.m_tiles = (B + BT - 1) / BT;
    p.n_tiles = ((V + TN - 1) / TN + GEN_TILES_PER_BLOCK - 1) / GEN_TILES_PER_BLOCK;
    p.b_pad = 0;
  }
  *out = p;
  return p.smem <= SMEM_LIMIT;
}

template <typename T>
cudaError_t launch_fma(const GenPlan& p, const void* x, const void* ns, const void* nb,
                       const void* wg, const void* bg, void* keys, int B, int E, int V,
                       cudaStream_t st) {
  auto k = gen_argmax_fma_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  k<<<dim3(p.n_tiles, p.m_tiles), NTHREADS, p.smem, st>>>(
      (const T*)x, (const float*)ns, (const float*)nb, (const T*)wg, (const float*)bg,
      (u64*)keys, B, E, V);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// host entry points (plain C, bound with ctypes)
// ---------------------------------------------------------------------------

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. route: -1 = by the dtype (bfloat16 ->
// tensor cores, float32 -> CUDA cores), which is what the package's wrapper
// always passes; 0 = the CUDA-core route (either dtype) and 1 = the
// tensor-core route (bfloat16 only) are for checks that time or test one
// kernel against the other. out: 9 ints, see GenPlan.
int vct_gen_argmax_plan(int dtype, int B, int E, int V, int route, int* out) {
  GenPlan p;
  if (!gen_plan(dtype, B, E, V, route, &p)) return (int)cudaErrorInvalidValue;
  const int vals[9] = {p.route, p.bm, p.bn, p.bk, p.stages, p.smem, p.m_tiles, p.n_tiles,
                       p.b_pad};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

// keys: [B + 1] 64-bit scratch. The CUDA-core route needs zeros in it on entry
// (the wrapper allocates them that way); the tensor-core route zeroes it in
// its prologue and counts finished blocks in the last entry.
// parts: bfloat16 scratch [2, b_pad, E] of the plan (tensor-core route only).
int vct_gen_argmax(int dtype, const void* x, const void* ns, const void* nb, const void* wg,
                   const void* bg, void* keys, void* tok, void* parts, int B, int E, int V,
                   int route, void* stream) {
  GenPlan p;
  if (!gen_plan(dtype, B, E, V, route, &p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (p.route == 1) {
    if (!parts) return (int)cudaErrorInvalidValue;
    return (int)launch_gen_tc(p, x, ns, nb, parts, wg, bg, (u64*)keys, B, E, V,
                              ArgmaxEpi{(u64*)keys, (int*)tok}, st);
  }
  err = dtype == 1 ? launch_fma<bf16>(p, x, ns, nb, wg, bg, keys, B, E, V, st)
                   : launch_fma<float>(p, x, ns, nb, wg, bg, keys, B, E, V, st);
  if (err != cudaSuccess) return (int)err;
  keys_to_tokens_kernel<<<(B + 255) / 256, 256, 0, st>>>((const u64*)keys, (int*)tok, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
