// The routed experts of a mixture-of-experts layer for Hopper (sm_90a): the
// router's top-k with a sort of the picks by expert, and a grouped bfloat16
// product over the sorted rows, forward and backward. Bound through a plain C
// interface (ctypes). Python side: vct_tpu_torch/ops/moe_kernels.py.
//
// Replaces no TPU kernel: the JAX package runs no mixture-of-experts model.
// It was added for the LFM2 caption LM (vct_tpu_torch/models/lfm2.py), whose
// MoE layers route each token to 4 of 32 SwiGLU experts. A library has no
// single call for a product whose row groups and weights change with the
// data; a loop of one product per expert asks the host for the group sizes,
// which a captured train step may not do (a copy from the device waits for
// it).
//
// What bounds them on an H100: at the LFM2 training shapes (2,816 tokens a
// step, 11,264 picks, about 350 rows an expert) one layer's three expert
// products are 242 GFLOP forward against 705 MB of bfloat16 weights, so a
// product sits near the ridge of 295 operations a byte: about as much time
// in the tensor cores (0.245 ms) as in reading the weights once (0.21 ms).
//
// Design:
//   * moe_route_kernel (one block): per token the sigmoid of its router
//     logits plus the expert bias, the top k by that score (ties to the
//     lower expert), then a counting sort of the T x k picks by expert: each
//     thread counts a contiguous range of picks per expert, an exclusive scan
//     over the threads gives each range its place, and a second walk writes
//     each pick's row in the sorted order (dest), the token of each sorted
//     row (src), the per-expert offsets and counts. Sorted rows run by
//     expert, then token, then pick: the order of a stable sort. Everything
//     stays on the device and the sizes are fixed (T x k rows), so a CUDA
//     graph can capture it; no token is dropped.
//   * the products, over the rows sorted by expert:
//       MODE 0  out[r, n] = sum_k A[map(r), k] W[e(r), n, k]   (forward; the
//               token rows are gathered as they load, no permuted copy)
//       MODE 1  out[r, n] = sum_k A[r, k] W[e(r), k, n]        (dX)
//       MODE 2  out[e, m, n] = sum_{r in e} A[r, m] B[map(r), n] (dW, float32)
//     grouped_wgmma_kernel<MODE> (modes 0 and 1) computes the product
//     transposed, out^T = W^T . A^T, as gen_wgmma.cuh's generator does: the
//     weight's 256 output columns of the block are the M side, read by each
//     warp with ldmatrix (transposed for mode 1's [k][n] weight) into the
//     register operand of wgmma.m64n128k16; the block's 128 token rows are
//     the N side, K-major in the 128-byte-swizzled layout the tensor cores
//     read from shared memory; K in steps of 64 through a 3-stage cp.async
//     ring. A block finds its (expert, row tile) from the offsets: the grid
//     is the upper bound ceil(R / 128) + E row tiles, blocks past the last
//     return, and consecutive blocks share a weight tile in L2.
//     grouped_dw_kernel (mode 2, both operands stored along the rows it
//     sums) gives each (expert, 128 x 128 tile) one block: eight warps of
//     64 x 32 on mma.sync.m16n8k16, fragments by ldmatrix.trans, K (the
//     expert's rows, in ascending order) in steps of 32 through a 3-stage
//     cp.async ring.
//   No atomics: every sum has a fixed order, so runs and graph replays give
//   the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int RT_THREADS = 256;
constexpr int RT_MAX_E = 64;
constexpr int RT_MAX_K = 8;
constexpr int RT_MAX_ROWS = 98304;   // picks a launch sorts (T x k), one byte each in shared memory

// mode 2 (dW): 128 x 128 tiles of one expert's gradient, eight warps of 64 x 32
constexpr int GG_THREADS = 256;
constexpr int GG_BM = 128;
constexpr int GG_BN = 128;
constexpr int GG_BK = 32;            // rows summed a step
constexpr int GG_STAGES = 3;
constexpr int GG_MP = GG_BM + 8;     // pitch of a [32][128] tile (272 bytes: no bank conflict)
constexpr int GG_STAGE = 2 * GG_BK * GG_MP;   // elements: the A and B tiles
constexpr int GG_SMEM = GG_STAGES * GG_STAGE * 2;

// ---- routing -------------------------------------------------------------------

__global__ void __launch_bounds__(RT_THREADS)
moe_route_kernel(const float* __restrict__ logits, const float* __restrict__ bias, int T, int E,
                 int K, int* __restrict__ idx, int* __restrict__ dest, int* __restrict__ src,
                 int* __restrict__ offsets, int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char rt_smem[];
  int* cnt = reinterpret_cast<int*>(rt_smem);          // [E][RT_THREADS]
  int* base = cnt + E * RT_THREADS;                     // [E + 1]
  unsigned char* pick = rt_smem + (E * RT_THREADS + RT_MAX_E + 1) * 4;   // [T * K]
  const int tid = threadIdx.x;
  const int R = T * K;

  // top k of sigmoid(logit) + bias per token, ties to the lower expert
  for (int t = tid; t < T; t += RT_THREADS) {
    float bv[RT_MAX_K];
    int bi[RT_MAX_K];
    for (int j = 0; j < K; ++j) { bv[j] = -INFINITY; bi[j] = 0; }
    const float* row = logits + (size_t)t * E;
    for (int e = 0; e < E; ++e) {
      const float s = 1.f / (1.f + expf(-row[e])) + bias[e];
      int p = K;
      while (p > 0 && s > bv[p - 1]) --p;
      if (p == K) continue;
      for (int j = K - 1; j > p; --j) { bv[j] = bv[j - 1]; bi[j] = bi[j - 1]; }
      bv[p] = s;
      bi[p] = e;
    }
    for (int j = 0; j < K; ++j) {
      idx[t * K + j] = bi[j];
      pick[t * K + j] = (unsigned char)bi[j];
    }
  }
  for (int e = 0; e < E; ++e) cnt[e * RT_THREADS + tid] = 0;
  __syncthreads();

  // each thread's contiguous range of picks, counted per expert
  const int per = (R + RT_THREADS - 1) / RT_THREADS;
  const int lo = min(R, tid * per), hi = min(R, lo + per);
  for (int p = lo; p < hi; ++p) ++cnt[pick[p] * RT_THREADS + tid];
  __syncthreads();

  // per expert an exclusive scan over the threads: warp w takes experts w, w + 8, ...
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int PER_LANE = RT_THREADS / 32;
  for (int e = warp; e < E; e += RT_THREADS / 32) {
    int* c = cnt + e * RT_THREADS + lane * PER_LANE;
    int s = 0;
    for (int i = 0; i < PER_LANE; ++i) s += c[i];
    int incl = s;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - s;
    for (int i = 0; i < PER_LANE; ++i) {
      const int v = c[i];
      c[i] = run;
      run += v;
    }
    if (lane == 31) base[e + 1] = incl;   // the expert's total, for now
  }
  __syncthreads();
  if (tid == 0) {
    base[0] = 0;
    for (int e = 0; e < E; ++e) {
      counts[e] = base[e + 1];
      base[e + 1] += base[e];
    }
  }
  __syncthreads();
  for (int e = tid; e <= E; e += RT_THREADS) offsets[e] = base[e];

  // the second walk: each pick's sorted row
  for (int p = lo; p < hi; ++p) {
    const int e = pick[p];
    const int row = base[e] + cnt[e * RT_THREADS + tid]++;
    dest[p] = row;
    src[row] = p / K;
  }
}

// ---- grouped products ------------------------------------------------------------

struct GGArgs {
  const bf16* a;
  const int* a_map;
  const bf16* b;
  const int* b_map;
  const int* offsets;
  void* out;
  int E, R, M, N, K;
};

// ---- mode 2 (dW) on mma.sync ------------------------------------------------------

// one [32][128] tile stored along M or N: rows k0 + i (valid while < k_end) through ``map``,
// columns c0..c0+127
__device__ __forceinline__ void load_rows_t(bf16* dst, const bf16* src, const int* map, int ld,
                                            int k0, int k_end, int c0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + GG_THREADS * i;   // 512 pieces of 16 bytes
    const int r = c >> 4, cc = c & 15;
    const int row = k0 + r;
    const bool ok = row < k_end;
    const int g = ok ? (map ? map[row] : row) : 0;
    cp_async16(dst + r * GG_MP + cc * 8, src + (size_t)g * ld + c0 + cc * 8, ok);
  }
}

// out[e] [M][N] float32 = the expert's rows r (ascending) of A[r] [M] x B[map(r)] [N]: both
// tiles stored [k = row][m or n], so the A and B fragments come by ldmatrix.trans
__global__ void __launch_bounds__(GG_THREADS)
grouped_dw_kernel(GGArgs g) {
  extern __shared__ __align__(16) unsigned char gg_smem[];
  bf16* ring = reinterpret_cast<bf16*>(gg_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int e = blockIdx.z, n0 = blockIdx.x * GG_BN, m0 = blockIdx.y * GG_BM;
  const int row0 = g.offsets[e], row_end = g.offsets[e + 1];
  const int ksteps = (row_end - row0 + GG_BK - 1) / GG_BK;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  auto load = [&](int ks, int slot) {
    bf16* ta = ring + slot * GG_STAGE;
    const int k0 = row0 + ks * GG_BK;
    load_rows_t(ta, g.a, nullptr, g.M, k0, row_end, m0);
    load_rows_t(ta + GG_STAGE / 2, g.b, g.b_map, g.N, k0, row_end, n0);
  };

#pragma unroll
  for (int s = 0; s < GG_STAGES - 1; ++s) {
    if (s < ksteps) load(s, s);
    cp_async_commit();
  }
  const int mi = lane >> 3, rr = lane & 7;
  for (int ks = 0; ks < ksteps; ++ks) {
    cp_async_wait<GG_STAGES - 2>();
    __syncthreads();
    const int nxt = ks + GG_STAGES - 1;
    if (nxt < ksteps) load(nxt, nxt % GG_STAGES);
    cp_async_commit();
    const bf16* ta = ring + (ks % GG_STAGES) * GG_STAGE;
    const bf16* tb = ta + GG_STAGE / 2;
#pragma unroll
    for (int kk = 0; kk < GG_BK; kk += 16) {
      // B: b0, b1 of the n8 tiles wn + 16 jj and wn + 16 jj + 8
      uint32_t bf[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldmatrix_x4_trans(bf[jj], tb + (kk + (mi & 1) * 8 + rr) * GG_MP + wn + jj * 16 +
                                      (mi >> 1) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t af[4];
        ldmatrix_x4_trans(af, ta + (kk + (mi >> 1) * 8 + rr) * GG_MP + wm + i * 16 +
                                  (mi & 1) * 8);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          mma_bf16_16816(acc[i][2 * jj], af, bf[jj][0], bf[jj][1]);
          mma_bf16_16816(acc[i][2 * jj + 1], af, bf[jj][2], bf[jj][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int gq = lane >> 2, q = lane & 3;
  float* out = reinterpret_cast<float*>(g.out) + (size_t)e * g.M * g.N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + gq + 8 * h;
        const int n = n0 + wn + j * 8 + 2 * q;
        *reinterpret_cast<float2*>(out + (size_t)m * g.N + n) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

// ---- modes 0 and 1 on wgmma -------------------------------------------------------

constexpr int GW_THREADS = 256;      // two warpgroups, each 128 of the block's weight columns
constexpr int GW_BM = 256;           // weight output columns of a block (the M side)
constexpr int GW_BN = 128;           // token rows of a block (the N of wgmma.m64n128k16)
constexpr int GW_BK = 64;            // K step: one 128-byte swizzled row of the token tile
constexpr int GW_STAGES = 3;
constexpr int GW_ROWS_BYTES = GW_BN * 128;           // the token tile, swizzled
constexpr int GW_KP = GW_BK + 8;                     // mode 0's weight tile [n][k], pitch 72
constexpr int GW_NP = GW_BM + 8;                     // mode 1's weight tile [k][n], pitch 264
constexpr int GW_W_BYTES = (GW_BM * GW_KP > GW_BK * GW_NP ? GW_BM * GW_KP : GW_BK * GW_NP) * 2;
constexpr int GW_STAGE = GW_ROWS_BYTES + GW_W_BYTES;  // a multiple of 1024
constexpr int GW_SMEM = 1024 + GW_STAGES * GW_STAGE + 4 * (RT_MAX_E + 1);

template <int MODE>
__global__ void __launch_bounds__(GW_THREADS, 1)
grouped_wgmma_kernel(GGArgs g) {
  extern __shared__ unsigned char gw_raw[];
  unsigned char* ring = gw_raw + ((1024 - (smem_addr(gw_raw) & 1023)) & 1023);
  int* off = reinterpret_cast<int*>(ring + GW_STAGES * GW_STAGE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wgid = warp >> 2, w4 = warp & 3;
  for (int e = tid; e <= g.E; e += GW_THREADS) off[e] = g.offsets[e];
  __syncthreads();

  int e = 0, t = blockIdx.x, found = 0;
  for (; e < g.E; ++e) {
    const int tiles = (off[e + 1] - off[e] + GW_BN - 1) / GW_BN;
    if (t < tiles) { found = 1; break; }
    t -= tiles;
  }
  if (!found) return;
  const int row0 = off[e] + t * GW_BN, row_end = off[e + 1];
  const int n0 = blockIdx.y * GW_BM;
  const int ksteps = g.K / GW_BK;
  const bf16* w = g.b + (size_t)e * g.N * g.K;

  auto fetch = [&](int ks, int stage) {
    unsigned char* st = ring + stage * GW_STAGE;
    const int k0 = ks * GW_BK;
#pragma unroll
    for (int i = 0; i < GW_BN * 8 / GW_THREADS; ++i) {   // token rows: 8 pieces a row
      const int c = tid + i * GW_THREADS;
      const int r = c >> 3, kc = c & 7;
      const int row = row0 + r;
      const bool ok = row < row_end;
      const int src = ok ? (MODE == 0 && g.a_map ? g.a_map[row] : row) : 0;
      cp_async16(st + r * 128 + ((kc ^ (r & 7)) << 4), g.a + (size_t)src * g.K + k0 + kc * 8, ok);
    }
    bf16* ws = reinterpret_cast<bf16*>(st + GW_ROWS_BYTES);
    if (MODE == 0) {   // W[e] [N][K]: 256 rows of the block's columns, 8 pieces each
#pragma unroll
      for (int i = 0; i < GW_BM * 8 / GW_THREADS; ++i) {
        const int c = tid + i * GW_THREADS;
        const int n = c >> 3, kc = c & 7;
        cp_async16(ws + n * GW_KP + kc * 8, w + (size_t)(n0 + n) * g.K + k0 + kc * 8, true);
      }
    } else {           // W[e] [K][N]: 64 rows of k, 32 pieces of the block's columns each
#pragma unroll
      for (int i = 0; i < GW_BK * (GW_BM / 8) / GW_THREADS; ++i) {
        const int c = tid + i * GW_THREADS;
        const int k = c >> 5, nc = c & 31;
        cp_async16(ws + k * GW_NP + nc * 8, w + (size_t)(k0 + k) * g.N + n0 + nc * 8, true);
      }
    }
  };

  float acc[2][GW_BN / 2];   // two m64 tiles of weight columns x 128 token rows
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < GW_BN / 2; ++j) acc[mi][j] = 0.f;

#pragma unroll
  for (int s = 0; s < GW_STAGES - 1; ++s) {
    if (s < ksteps) fetch(s, s);
    cp_async_commit();
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    cp_async_wait<GW_STAGES - 2>();   // step ks has landed
    fence_async_shared();             // and the tensor cores may read it
    __syncthreads();                  // every warp's products of step ks - 1 are done
    if (ks + GW_STAGES - 1 < ksteps) fetch(ks + GW_STAGES - 1, (ks + GW_STAGES - 1) % GW_STAGES);
    cp_async_commit();

    const unsigned char* st = ring + (ks % GW_STAGES) * GW_STAGE;
    const bf16* ws = reinterpret_cast<const bf16*>(st + GW_ROWS_BYTES);
    uint32_t afr[2][GW_BK / 16][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int kk = 0; kk < GW_BK / 16; ++kk) {
        const int m = wgid * 128 + mi * 64 + w4 * 16;
        if (MODE == 0)
          ldmatrix_x4(afr[mi][kk], ws + (m + (lane & 15)) * GW_KP + kk * 16 + (lane >> 4) * 8);
        else
          ldmatrix_x4_trans(afr[mi][kk], ws + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * GW_NP +
                                             m + ((lane >> 3) & 1) * 8);
      }
    const uint64_t desc = wgmma_desc_sw128(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GW_BK / 16; ++kk)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        wgmma_m64n128k16_rs(acc[mi], afr[mi][kk], desc + 2 * kk, (ks > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();

  // acc[mi][4 j + r]: weight column mi * 64 + w4 * 16 + gq + 8 * (r / 2) of the warpgroup's
  // 128, token row 8 j + 2 q + r % 2 of the block's
  const int gq = lane >> 2, q = lane & 3;
  bf16* out = reinterpret_cast<bf16*>(g.out);
#pragma unroll
  for (int j = 0; j < GW_BN / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = row0 + 8 * j + 2 * q + c;
      if (row >= row_end) continue;
      bf16* dst = out + (size_t)row * g.N + n0 + wgid * 128 + w4 * 16 + gq;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          dst[mi * 64 + 8 * h] = __float2bfloat16_rn(acc[mi][4 * j + 2 * h + c]);
    }
}

template <int MODE> int launch_wgmma(const GGArgs& g, cudaStream_t st) {
  static bool attr = false;   // set once per process (one card)
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(grouped_wgmma_kernel<MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, GW_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const dim3 grid((g.R + GW_BN - 1) / GW_BN + g.E, g.N / GW_BM);
  grouped_wgmma_kernel<MODE><<<grid, GW_THREADS, GW_SMEM, st>>>(g);
  return (int)cudaGetLastError();
}

int launch_dw(const GGArgs& g, cudaStream_t st) {
  static bool attr = false;   // set once per process (one card)
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(grouped_dw_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, GG_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  grouped_dw_kernel<<<dim3(g.N / GG_BN, g.M / GG_BM, g.E), GG_THREADS, GG_SMEM, st>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of the routing launch for T tokens, E experts, k picks a token.
int vct_moe_route_smem(int T, int E, int K) {
  return (E * RT_THREADS + RT_MAX_E + 1) * 4 + ((T * K + 15) / 16) * 16;
}

// logits float32 [T, E], bias float32 [E] -> idx [T, K] (experts by score, ties to the
// lower), dest [T, K] (each pick's sorted row), src [T K] (each sorted row's token),
// offsets [E + 1], counts [E]; all int32.
int vct_moe_route(const void* logits, const void* bias, int T, int E, int K, void* idx,
                  void* dest, void* src, void* offsets, void* counts, void* stream) {
  if (T <= 0 || E <= 0 || E > RT_MAX_E || K <= 0 || K > RT_MAX_K || K > E ||
      (long long)T * K > RT_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  const int smem = vct_moe_route_smem(T, E, K);
  static int attr = 0;
  if (smem > 48 * 1024 && smem > attr) {
    cudaError_t err = cudaFuncSetAttribute(moe_route_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr = smem;
  }
  moe_route_kernel<<<1, RT_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)logits, (const float*)bias, T, E, K, (int*)idx, (int*)dest, (int*)src,
      (int*)offsets, (int*)counts);
  return (int)cudaGetLastError();
}

// The grouped product over rows sorted by expert (offsets [E + 1] int32 on the device),
// bfloat16 operands:
//   mode 0: out bf16 [R, N] = A[a_map(r)] [., K] . W[e(r)] [N, K]^T   (a_map may be null)
//   mode 1: out bf16 [R, N] = A [R, K] . W[e(r)] [K, N]
//   mode 2: out float32 [E, M, N] = sum over the rows r of expert e of A[r] [M] x B[b_map(r)] [N]
// N a multiple of 256 (modes 0, 1) or 128 (mode 2), M (mode 2) of 128, K (modes 0, 1) of
// 64; R the rows (T k).
int vct_grouped_gemm(int mode, const void* a, const void* a_map, const void* b,
                     const void* b_map, const void* offsets, void* out, int E, int R, int M,
                     int N, int K, void* stream) {
  if (E <= 0 || E > RT_MAX_E || R <= 0 || N <= 0 || N % GG_BN)
    return (int)cudaErrorInvalidValue;
  GGArgs g{(const bf16*)a, (const int*)a_map, (const bf16*)b, (const int*)b_map,
           (const int*)offsets, out, E, R, M, N, K};
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0 || mode == 1) {
    if (K <= 0 || K % GW_BK || N % GW_BM) return (int)cudaErrorInvalidValue;
    return mode == 0 ? launch_wgmma<0>(g, st) : launch_wgmma<1>(g, st);
  }
  if (mode == 2) {
    if (M <= 0 || M % GG_BM) return (int)cudaErrorInvalidValue;
    return launch_dw(g, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
