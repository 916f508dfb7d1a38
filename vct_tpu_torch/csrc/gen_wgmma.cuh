// The tensor-core route of the generator kernels (gen_argmax.cu, gen_topk.cu):
// final LayerNorm, vocab projection on wgmma and a per-(row, slab) epilogue
// that the including kernel supplies. gen_argmax.cu's header describes the
// design; in short:
//   * gen_norm_split_kernel: LayerNorm once per row with float32 statistics,
//     yn split into bfloat16 hi = bf16(yn) and lo = bf16(yn - hi), about 16
//     mantissa bits of yn; pad rows up to whole batch tiles are zeros;
//   * gen_wgmma_kernel<NB, Epi>: one persistent block per SM walks the
//     256-column vocab slabs blockIdx.x, blockIdx.x + gridDim.x, ... and
//     carries every batch tile of NB rows against each slab, K in steps of 64
//     through a 3-stage cp.async ring that runs across slab and tile
//     boundaries; the product is transposed, logits^T = wg^T . yn^T, on
//     wgmma.m64nNk16 (weight fragments by ldmatrix.trans into the register
//     operand, the hi and lo rows as the 128-byte-swizzled K-major operand);
//   * after the last K step of a (slab, batch tile) the epilogue gets the
//     float32 accumulators in registers: acc[mi][4 j + r] is vocab column
//     mi * 64 + w4 * 16 + g + 8 * (r / 2) of the warpgroup's 128 columns,
//     batch row 8 j + 2 q + r % 2 of the tile. Columns past V carry zero
//     weights.
// An epilogue is a struct with
//   template <int NB> static constexpr int smem_bytes();      // its shared memory
//   template <int NB> __device__ void tile(float (&acc)[2][NB / 2], const float* bg,
//       int slab, int mt, int B, int V, unsigned char* smem) const;
//   __device__ void finish(int B, unsigned char* smem) const;  // after the walk

#pragma once

#include "decode_common.cuh"
#include "mma_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int GA_THREADS = 256;     // two warpgroups; each owns 128 columns of the slab
constexpr int GA_BN = 256;          // vocab columns of a slab
constexpr int GA_BK = 64;           // K step of the ring: one 128-byte swizzled row of the parts
constexpr int GA_STAGES = 3;
constexpr int SK_NS_EMAX = 1024;    // widest row norm_split_row holds in registers

// The LayerNorm and split of one row whose values k = lane + 32 i a lane holds
// in x[i] (E <= 32 C): the sums of norm_split_row in its order; writes the
// hi and lo rows.
template <int C>
__device__ __forceinline__ void split_row_regs(const float (&x)[C], int E, const float* ns,
                                               const float* nb, bf16* hi, bf16* lo) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i)
    if (lane + 32 * i < E) s += x[i];
  const float mean = warp_sum(s) / (float)E;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (lane + 32 * i >= E) continue;
    const float d = x[i] - mean;
    q += d * d;
  }
  const float rs = rsqrtf(warp_sum(q) / (float)E + LN_EPS);
  // the scale and shift asked for before any store, which the compiler
  // would not move them past
  float g[C], b[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int k = lane + 32 * i;
    g[i] = k < E ? ns[k] : 0.f;
    b[i] = k < E ? nb[k] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int k = lane + 32 * i;
    if (k >= E) continue;
    const float y = (x[i] - mean) * rs * g[i] + b[i];
    const bf16 h = __float2bfloat16_rn(y);
    hi[k] = h;
    lo[k] = __float2bfloat16_rn(y - __bfloat162float(h));
  }
}

__device__ __forceinline__ void norm_split_row(const bf16* src, const float* ns, const float* nb,
                                               bf16* parts, u64* keys, int row, int B, int b_pad,
                                               int E) {
  constexpr int C = SK_NS_EMAX / 32;   // the row's values a lane holds: k = lane + 32 i
  const int lane = threadIdx.x & 31;
  if (keys && lane == 0 && row < B) keys[row] = 0ull;   // below every real key
  bf16* hi = parts + (size_t)row * E;
  bf16* lo = parts + ((size_t)b_pad + row) * E;
  if (row >= B) {
    for (int k = lane; k < E; k += 32) hi[k] = lo[k] = __float2bfloat16_rn(0.f);
    return;
  }
  if (E > SK_NS_EMAX) {   // wider than the registers hold: three passes over memory
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
      const float y = (to_f(src[k]) - mean) * rs * ns[k] + nb[k];
      const bf16 h = __float2bfloat16_rn(y);
      hi[k] = h;
      lo[k] = __float2bfloat16_rn(y - __bfloat162float(h));
    }
    return;
  }
  // the same sums in the same order, the row read once into registers
  float x[C];
#pragma unroll
  for (int i = 0; i < C; ++i) x[i] = lane + 32 * i < E ? to_f(src[lane + 32 * i]) : 0.f;
  split_row_regs<C>(x, E, ns, nb, hi, lo);
}

// One warp per row: norm_split_row of x[row]. parts is [2, b_pad, E]; rows
// from B to b_pad become zeros. With ``keys`` set it also zeroes keys[0..B]
// (the argmax keys and the count of finished blocks).
__global__ void __launch_bounds__(GA_THREADS)
gen_norm_split_kernel(const bf16* x, const float* ns, const float* nb, bf16* parts, u64* keys,
                      int B, int b_pad, int E) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (GA_THREADS / 32) + warp;
  if (row >= b_pad) return;
  if (keys && lane == 0 && row == 0) keys[B] = 0ull;    // the count of finished blocks
  norm_split_row(x + (size_t)(row < B ? row : 0) * E, ns, nb, parts, keys, row, B, b_pad, E);
}

// Walks (slab, M tile, K step) in that nesting, one step at a time; the loader
// and the consumer each keep one.
struct GaCursor {
  int tile, mt, ks;
  __device__ __forceinline__ void advance(int ksteps, int m_tiles, int stride) {
    if (++ks == ksteps) {
      ks = 0;
      if (++mt == m_tiles) {
        mt = 0;
        tile += stride;
      }
    }
  }
};

// The product transposed: logits^T [vocab, batch] = wg^T . yn^T. The vocab is
// the M side of the tensor cores: a warp reads its 16 vocab columns x 16 k of
// the [k][n] weight tile with ldmatrix.trans into the register (A) operand,
// once for the hi and the lo product. The hi and lo parts are the B operand,
// [batch row][k], K-major as they lie in memory, which the tensor cores read
// from shared memory in the 128-byte-swizzled layout (cp.async writes piece c
// of row r at piece c ^ (r % 8)).

constexpr int GW_W_BYTES = GA_BK * (GA_BN + 8) * 2;   // weight tile, pitch 264 elements

__host__ __device__ constexpr int gw_stage_bytes(int nb) { return 2 * nb * 128 + GW_W_BYTES; }
// 1 KB to reach a 1024-byte boundary, the ring, the epilogue's own bytes
__host__ __device__ constexpr int gw_ring_bytes(int nb) {
  return 1024 + GA_STAGES * gw_stage_bytes(nb);
}

// The vocab walk of one block: slabs blockIdx.x, blockIdx.x + gridDim.x, ...
// (none when blockIdx.x >= n_tiles), every M tile of NB rows against each,
// the epilogue's ``tile`` after the last K step of a (slab, M tile). smem_raw
// holds gw_ring_bytes(NB) + the epilogue's bytes. gen_wgmma_kernel runs it
// as a kernel of its own; the small-row token kernels (small_step.cu) run it
// inside their cooperative launch, so both give the same logits.
// NB: batch rows of a tile (the N of the product), 64 or 128
template <int NB, class Epi>
__device__ __forceinline__ void gen_walk(const bf16* parts, const bf16* wg, const float* bg,
                                         int B, int b_pad, int E, int V, int n_tiles,
                                         int m_tiles, const Epi& epi, unsigned char* smem_raw) {
  constexpr int STAGE = gw_stage_bytes(NB), WLD = GA_BN + 8, NC = GA_BN / 8;
  constexpr int P_CHUNKS = 2 * NB * 8 / GA_THREADS, W_CHUNKS = GA_BK * NC / GA_THREADS;
  // the swizzled tiles want a 1024-byte boundary
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* epi_smem = ring + GA_STAGES * STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wgid = warp >> 2, w4 = warp & 3;
  const int ksteps = (E + GA_BK - 1) / GA_BK;
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = my_tiles * m_tiles * ksteps;

  auto fetch = [&](const GaCursor& c, int stage) {
    unsigned char* st = ring + stage * STAGE;
    const int k0 = c.ks * GA_BK, n0 = c.tile * GA_BN;
#pragma unroll
    for (int i = 0; i < P_CHUNKS; ++i) {
      const int chunk = tid + i * GA_THREADS;
      const int kc = chunk & 7, row2 = chunk >> 3;
      const int half = row2 / NB, row = row2 - half * NB;
      const int k = k0 + kc * 8;
      const bool ok = k < E;
      const bf16* src = parts + ((size_t)half * b_pad + (size_t)c.mt * NB + row) * E + (ok ? k : 0);
      cp_async16(st + half * (NB * 128) + row * 128 + ((kc ^ (row & 7)) << 4), src, ok);
    }
    bf16* ws = reinterpret_cast<bf16*>(st + 2 * NB * 128);
#pragma unroll
    for (int i = 0; i < W_CHUNKS; ++i) {
      const int chunk = tid + i * GA_THREADS;
      const int kr = chunk / NC, nc = chunk % NC;
      const int k = k0 + kr, n = n0 + nc * 8;
      const bool ok = k < E && n < V;
      cp_async16(ws + kr * WLD + nc * 8, wg + (ok ? (size_t)k * V + n : 0), ok);
    }
  };

  float acc[2][NB / 2];   // two m64 tiles of vocab columns x NB batch rows
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) acc[mi][j] = 0.f;

  GaCursor ld = {(int)blockIdx.x, 0, 0}, cs = {(int)blockIdx.x, 0, 0};
  for (int s = 0; s < GA_STAGES - 1; ++s) {
    if (s < total) {
      fetch(ld, s);
      ld.advance(ksteps, m_tiles, gridDim.x);
    }
    cp_async_commit();
  }

  for (int s = 0; s < total; ++s) {
    cp_async_wait<GA_STAGES - 2>();   // step s has landed
    fence_async_shared();             // and the tensor cores may read it
    __syncthreads();                  // every warp's products of step s - 1 are done
    if (s + GA_STAGES - 1 < total) {
      fetch(ld, (s + GA_STAGES - 1) % GA_STAGES);
      ld.advance(ksteps, m_tiles, gridDim.x);
    }
    cp_async_commit();

    const unsigned char* st = ring + (s % GA_STAGES) * STAGE;
    const bf16* ws = reinterpret_cast<const bf16*>(st + 2 * NB * 128);
    uint32_t afr[2][GA_BK / 16][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int kk = 0; kk < GA_BK / 16; ++kk)
        ldmatrix_x4_trans(afr[mi][kk],
                          ws + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * WLD + wgid * 128 +
                              mi * 64 + w4 * 16 + ((lane >> 3) & 1) * 8);
    const uint64_t hi_desc = wgmma_desc_sw128(st), lo_desc = wgmma_desc_sw128(st + NB * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GA_BK / 16; ++kk)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int keep = (cs.ks > 0 || kk > 0) ? 1 : 0;   // 0: a new tile starts from zero
        if constexpr (NB == 128) {
          wgmma_m64n128k16_rs(acc[mi], afr[mi][kk], hi_desc + 2 * kk, keep);
          wgmma_m64n128k16_rs(acc[mi], afr[mi][kk], lo_desc + 2 * kk, 1);
        } else {
          wgmma_m64n64k16_rs(acc[mi], afr[mi][kk], hi_desc + 2 * kk, keep);
          wgmma_m64n64k16_rs(acc[mi], afr[mi][kk], lo_desc + 2 * kk, 1);
        }
      }
    wgmma_commit();
    wgmma_wait<0>();

    if (cs.ks == ksteps - 1) epi.template tile<NB>(acc, bg, cs.tile, cs.mt, B, V, epi_smem);
    cs.advance(ksteps, m_tiles, gridDim.x);
  }
  cp_async_wait<0>();
}

template <int NB, class Epi>
__global__ void __launch_bounds__(GA_THREADS, 1)
gen_wgmma_kernel(const bf16* parts, const bf16* wg, const float* bg, int B, int b_pad, int E,
                 int V, int n_tiles, int m_tiles, Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  gen_walk<NB, Epi>(parts, wg, bg, B, b_pad, E, V, n_tiles, m_tiles, epi, smem_raw);
  epi.finish(B, smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023) +
                    GA_STAGES * gw_stage_bytes(NB));
}

// The argmax epilogue (gen_argmax.cu's tensor-core route, and the generator
// phase of the small-row token kernels in small_step.cu): per (row, slab) the
// first-win maximum as a 64-bit key, merged across blocks by atomicMax.
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
// the launch plan: {route, rows of an M tile, columns of a slab, K step,
// stages, dynamic shared memory, M tiles, slabs, padded rows}. Route 1 is the
// tensor-core route; each kernel fills route 0 with its CUDA-core kernel.
// ---------------------------------------------------------------------------

struct GenPlan {
  int route, bm, bn, bk, stages, smem, m_tiles, n_tiles, b_pad;
};

template <class Epi> GenPlan gen_tc_plan(int B, int V) {
  GenPlan p;
  p.route = 1;
  p.bm = B <= 64 ? 64 : 128;
  p.bn = GA_BN; p.bk = GA_BK; p.stages = GA_STAGES;
  p.smem = gw_ring_bytes(p.bm) +
           (p.bm == 64 ? Epi::template smem_bytes<64>() : Epi::template smem_bytes<128>());
  p.m_tiles = (B + p.bm - 1) / p.bm;
  p.n_tiles = (V + GA_BN - 1) / GA_BN;
  p.b_pad = p.m_tiles * p.bm;
  return p;
}

// LayerNorm and split, then the product kernel with the epilogue ``epi``
template <class Epi>
cudaError_t launch_gen_tc(const GenPlan& p, const void* x, const void* ns, const void* nb,
                          const void* parts, const void* wg, const void* bg, u64* keys, int B,
                          int E, int V, Epi epi, cudaStream_t st) {
  const int rows_per_block = GA_THREADS / 32;
  gen_norm_split_kernel<<<(p.b_pad + rows_per_block - 1) / rows_per_block, GA_THREADS, 0, st>>>(
      (const bf16*)x, (const float*)ns, (const float*)nb, (bf16*)parts, keys, B, p.b_pad, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto k = p.bm == 64 ? gen_wgmma_kernel<64, Epi> : gen_wgmma_kernel<128, Epi>;
  // the attribute and the SM count are asked for once per device and tile size
  static int sm_count[2][64] = {};
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  int* cached = dev < 64 ? &sm_count[p.bm == 64][dev] : nullptr;
  if (!cached || !*cached) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (cached) *cached = sms;
  } else {
    sms = *cached;
  }
  const int grid = p.n_tiles < sms ? p.n_tiles : sms;
  k<<<grid, GA_THREADS, p.smem, st>>>((const bf16*)parts, (const bf16*)wg, (const float*)bg, B,
                                      p.b_pad, E, V, p.n_tiles, p.m_tiles, epi);
  return cudaGetLastError();
}

}  // namespace
