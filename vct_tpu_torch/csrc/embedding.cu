// Token embedding lookup and its gradient for Hopper (sm_90a), bound through a
// plain C interface (ctypes). Python side: vct_tpu_torch/ops/embedding_kernels.py.
//
// Replaces no TPU kernel: the JAX package's token embedding
// (vct_tpu/models/decoder.py:132-135, jnp.take + jnp.where) is plain XLA.
// The pair was added for the train step, where PyTorch's expression of it
// (weight.to(dtype)[ids].masked_fill(ids == pad, 0)) cast the whole float32
// table to the compute dtype to gather a few thousand rows, and its backward
// (index_put_ with accumulate on a zeroed table in the compute dtype, then a
// cast of the dense table back to float32) gave each run of equal ids to one
// warp that added the run's gradient rows one after another, each a round
// trip through device memory with a rounding. A caption batch is mostly pad
// ids (about 1,090 of 1,984 positions in the MSVD recipe's batches), so one
// warp walked a chain of about a thousand dependent steps: 1.03 ms of a 9.2
// ms train step.
//
// What bounds them on an H100: bytes. The gather reads the N gathered rows of
// the table and writes N rows of the output (9 MB at N=1984, E=768, float32
// table, bf16 out). The gradient is a dense float32 [V, E] tensor, as a
// dense optimizer wants it, so its floor is the zero fill of V x E x 4 bytes
// (93.8 MB at V=30522) plus reading the gradient rows of the non-pad
// positions and writing the rows they touch (a few MB): about 30 us.
//
// Design:
//   * embed_gather_kernel: one warp per position, 8 columns a lane per
//     16-byte load; a pad id (or an id outside [0, V)) gives exact zeros, as
//     masked_fill does. Casting the gathered rows equals gathering the cast
//     table, bit for bit.
//   * The gradient of the table, written straight into float32 [V, E]:
//     - embed_rank_kernel: the positions' 64-bit keys id << 32 | position
//       (no vocab size limits them; a pad position has none, as its incoming
//       gradient is exactly zero by the forward's definition) are ranked, a
//       warp for 4 positions, by counting the keys below each, so each
//       position's place in the sorted order is written directly: equal ids
//       together, in ascending position. Chunks of at most CHUNK positions
//       bound the count's quadratic work. Further blocks of the same launch
//       zero the table (float4 stores, at the byte floor as a
//       cudaMemsetAsync is), so the ranking costs no time of its own: a sort
//       before a memset, or a sort in one block, would add its whole time
//       (29 us for a bitonic sort of 1,984 keys in one block);
//     - embed_accum_kernel: one warp per (run, 256 columns), each lane
//       owning 8 columns; the run's gradient rows are summed in float32 in
//       ascending position with 8 rows' loads in flight (a batch's [CLS]
//       and [SEP] runs are 64 rows long), rounded once to the compute dtype
//       (the dtype the table's cast gave the gradient) and stored as
//       float32. Chunks run in order, a later chunk adding to the float32 sum
//       an earlier one left, so the order is ascending position across
//       chunks too; with more than one chunk the rounding waits for
//       embed_round_kernel after the last.
//   No atomics, and nothing depends on scheduling: every run gives the same
//   bits, and a graph replay gives the eager call's. A run of length one
//   gives its gradient row unchanged, as the replaced kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CHUNK = 16384;          // ids ranked and summed a launch at a time
constexpr int THREADS = 256;          // 8 warps: a position (gather) or a run's columns (sums)
constexpr int WARPS = THREADS / 32;
constexpr int KEY_TILE = 1024;        // keys a ranking block stages in shared memory at once
constexpr int RANK_POS = 4;           // positions a warp ranks
constexpr int RANK_BLOCK_POS = WARPS * RANK_POS;
constexpr int FILL_BLOCKS = 528;      // 4 a SM of 132: the zero fill, beside the ranks
constexpr int MAX_BLOCKS = 1056;      // the sums' grid, at most 8 blocks a SM
constexpr uint64_t NO_KEY = ~0ull;    // pads and positions past the chunk rank last

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}

// x rounded to T's precision and back (float32: unchanged)
template <typename T> __device__ __forceinline__ float round_to(float x) { return x; }
template <> __device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ bool takes_row(int id, int v, int pad_id) {
  return id != pad_id && id >= 0 && id < v;
}

template <typename W, typename C>
__global__ void __launch_bounds__(THREADS)
embed_gather_kernel(const W* __restrict__ w, const int* __restrict__ ids, C* __restrict__ out,
                    int n, int v, int e, int pad_id) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int id = ids[row];
  const bool keep = takes_row(id, v, pad_id);
  const W* src = w + (keep ? (size_t)id * e : 0);
  C* dst = out + (size_t)row * e;
  for (int c = lane * 8; c < e; c += 256) {
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (keep) load8(src + c, x);
    store8(dst + c, x);
  }
}

__device__ __forceinline__ uint64_t key_of(int id, int pos, int v, int pad_id) {
  return takes_row(id, v, pad_id) ? ((uint64_t)(uint32_t)id << 32) | (uint32_t)pos : NO_KEY;
}

// Scratch (int32) of a gradient of n positions in `chunks` chunks:
//   perm       [n]       chunk c's non-pad positions sorted by (id, position),
//                        at [c * CHUNK, ...)
//   sorted_ids [n]       the id of each, at the same places
//   n_real     [chunks]  the non-pad positions of each chunk
//
// Blocks [0, rank_blocks): each warp ranks RANK_POS positions of chunk
// `chunk`, a position's rank being the count of the chunk's keys below its
// own (the keys staged through shared memory KEY_TILE at a time, each lane
// counting every 32nd), so the warp writes each position's place in the
// sorted order itself. Blocks past those (chunk 0 only): the zero fill of the
// table gradient, float4 stores, running beside the ranks.
__global__ void __launch_bounds__(THREADS)
embed_rank_kernel(const int* __restrict__ ids, int* __restrict__ perm,
                  int* __restrict__ sorted_ids, int* __restrict__ n_real,
                  float* __restrict__ fill, size_t fill_vec4, int n, int v, int pad_id,
                  int chunk, int rank_blocks) {
  if ((int)blockIdx.x >= rank_blocks) {
    float4* out = reinterpret_cast<float4*>(fill);
    const size_t stride = (size_t)(gridDim.x - rank_blocks) * THREADS;
    for (size_t i = (size_t)(blockIdx.x - rank_blocks) * THREADS + threadIdx.x; i < fill_vec4;
         i += stride)
      out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  __shared__ uint64_t tile[KEY_TILE];
  const int c0 = chunk * CHUNK;
  const int nc = min(CHUNK, n - c0);
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * RANK_BLOCK_POS + (threadIdx.x >> 5) * RANK_POS;
  uint64_t mine[RANK_POS];
  int less[RANK_POS];
#pragma unroll
  for (int r = 0; r < RANK_POS; ++r) {
    const int i = first + r;
    mine[r] = i < nc ? key_of(ids[c0 + i], c0 + i, v, pad_id) : NO_KEY;
    less[r] = 0;
  }
  int real = 0;
  for (int t0 = 0; t0 < nc; t0 += KEY_TILE) {
    const int cnt = min(KEY_TILE, nc - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += THREADS)
      tile[j] = key_of(ids[c0 + t0 + j], c0 + t0 + j, v, pad_id);
    __syncthreads();
    for (int j = lane; j < cnt; j += 32) {
      const uint64_t k = tile[j];
      real += k != NO_KEY;
#pragma unroll
      for (int r = 0; r < RANK_POS; ++r) less[r] += k < mine[r];
    }
  }
#pragma unroll
  for (int r = 0; r < RANK_POS; ++r) less[r] = __reduce_add_sync(0xffffffffu, less[r]);
  real = __reduce_add_sync(0xffffffffu, real);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RANK_POS; ++r) {
      if (mine[r] == NO_KEY) continue;
      perm[c0 + less[r]] = c0 + first + r;
      sorted_ids[c0 + less[r]] = (int)(mine[r] >> 32);
    }
    if (first == 0) n_real[chunk] = real;
  }
}

// One warp per (run, 256-column tile) of chunk `chunk`: the warp of a run's
// first sorted index sums the run's gradient rows in its columns, in
// ascending position, each lane 8 columns; the run's positions are read 32
// at a time and handed round by shuffles, so 8 rows' loads are in flight
// at once. `carry`: add to what earlier chunks left (else start from zero);
// `round_sum`: round the sum to C before the store.
template <typename C>
__global__ void __launch_bounds__(THREADS)
embed_accum_kernel(const C* __restrict__ g, const int* __restrict__ perm,
                   const int* __restrict__ sorted_ids, const int* __restrict__ n_real,
                   float* __restrict__ out, int e, int chunk, int carry, int round_sum) {
  const int* pm = perm + chunk * CHUNK;
  const int* sid = sorted_ids + chunk * CHUNK;
  const int real = n_real[chunk];
  const int tiles = (e + 255) / 256;
  const int lane = threadIdx.x & 31;
  for (int w = blockIdx.x * WARPS + (threadIdx.x >> 5); w < real * tiles;
       w += gridDim.x * WARPS) {
    const int k = w / tiles, col = (w % tiles) * 256 + lane * 8;
    const int id = sid[k];
    if (k > 0 && sid[k - 1] == id) continue;  // not the first of its run
    const bool mine_cols = col < e;
    float* dst = out + (size_t)id * e + col;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (carry && mine_cols) load8(dst, acc);
    for (int k0 = k;; k0 += 32) {
      const int kk = k0 + lane;
      const bool in = kk < real && sid[kk] == id;
      const unsigned stop = __ballot_sync(0xffffffffu, !in);
      const int cnt = stop ? __ffs(stop) - 1 : 32;
      const int at = in ? pm[kk] : 0;
      int j = 0;
      for (; j + 8 <= cnt; j += 8) {
        float x[8][8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int p = __shfl_sync(0xffffffffu, at, j + u);
          if (mine_cols) load8(g + (size_t)p * e + col, x[u]);
        }
        if (mine_cols) {
#pragma unroll
          for (int u = 0; u < 8; ++u)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[q] += x[u][q];
        }
      }
      for (; j < cnt; ++j) {
        const int p = __shfl_sync(0xffffffffu, at, j);
        if (mine_cols) {
          float x[8];
          load8(g + (size_t)p * e + col, x);
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[q] += x[q];
        }
      }
      if (cnt < 32) break;
    }
    if (mine_cols) {
      if (round_sum) {
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] = round_to<C>(acc[q]);
      }
      store8(dst, acc);
    }
  }
}

// After the last of several chunks: every touched row rounded to C once,
// walked as embed_accum_kernel walks the runs (blockIdx.y the chunk). A row
// that runs in two chunks is rounded twice, which changes nothing the second
// time.
template <typename C>
__global__ void __launch_bounds__(THREADS)
embed_round_kernel(const int* __restrict__ sorted_ids, const int* __restrict__ n_real,
                   float* __restrict__ out, int e) {
  const int* sid = sorted_ids + blockIdx.y * CHUNK;
  const int real = n_real[blockIdx.y];
  const int tiles = (e + 255) / 256;
  const int lane = threadIdx.x & 31;
  for (int w = blockIdx.x * WARPS + (threadIdx.x >> 5); w < real * tiles;
       w += gridDim.x * WARPS) {
    const int k = w / tiles, col = (w % tiles) * 256 + lane * 8;
    const int id = sid[k];
    if ((k > 0 && sid[k - 1] == id) || col >= e) continue;
    float* row = out + (size_t)id * e + col;
    float x[8];
    load8(row, x);
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = round_to<C>(x[q]);
    store8(row, x);
  }
}

struct GradPlan {
  int chunk, chunks, rank_blocks, fill_blocks, accum_blocks, threads, round_blocks,
      scratch_ints;
};

int rank_blocks(int nc) { return (nc + RANK_BLOCK_POS - 1) / RANK_BLOCK_POS; }

int accum_blocks(int nc, int e) {
  return min((nc * ((e + 255) / 256) + WARPS - 1) / WARPS, MAX_BLOCKS);
}

// the launches of a gradient of n positions; rank_blocks and accum_blocks
// are the first chunk's (the largest); round_blocks is 0 where no rounding
// kernel runs (one chunk, or float32)
bool grad_plan(int dtype, int n, int e, GradPlan* p) {
  if (n <= 0 || e <= 0 || e % 8 || (dtype != 0 && dtype != 1)) return false;
  p->chunk = CHUNK;
  p->chunks = (n + CHUNK - 1) / CHUNK;
  p->rank_blocks = rank_blocks(min(n, CHUNK));
  p->fill_blocks = FILL_BLOCKS;
  p->accum_blocks = accum_blocks(min(n, CHUNK), e);
  p->threads = THREADS;
  p->round_blocks = (p->chunks > 1 && dtype == 1) ? accum_blocks(CHUNK, e) : 0;
  p->scratch_ints = 2 * n + p->chunks;
  return true;
}

template <typename W, typename C>
int launch_gather(const void* w, const int* ids, void* out, int n, int v, int e, int pad_id,
                  cudaStream_t st) {
  embed_gather_kernel<W, C><<<(n + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      (const W*)w, ids, (C*)out, n, v, e, pad_id);
  return (int)cudaGetLastError();
}

template <typename C>
int launch_grad(const GradPlan& pl, const void* g, const int* ids, float* out, int* scratch,
                int n, int v, int e, int pad_id, cudaStream_t st) {
  int* perm = scratch;
  int* sorted_ids = perm + n;
  int* n_real = sorted_ids + n;
  const bool round_each = pl.round_blocks == 0;
  cudaError_t err = cudaSuccess;
  for (int c = 0; c < pl.chunks; ++c) {
    const int nc = min(CHUNK, n - c * CHUNK);
    const int ranks = rank_blocks(nc);
    embed_rank_kernel<<<ranks + (c == 0 ? pl.fill_blocks : 0), THREADS, 0, st>>>(
        ids, perm, sorted_ids, n_real, out, c == 0 ? (size_t)v * e / 4 : 0, n, v, pad_id, c,
        ranks);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    embed_accum_kernel<C><<<accum_blocks(nc, e), THREADS, 0, st>>>(
        (const C*)g, perm, sorted_ids, n_real, out, e, c, c > 0, round_each);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (!round_each) {
    embed_round_kernel<C><<<dim3(pl.round_blocks, pl.chunks), THREADS, 0, st>>>(
        sorted_ids, n_real, out, e);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.

// out [n, e] (out_dtype) = the rows ids [n] (int32) of w [v, e] (w_dtype),
// cast; zeros where an id is pad_id or outside [0, v). e a multiple of 8.
int vct_embed_gather(int w_dtype, int out_dtype, const void* w, const void* ids, void* out,
                     int n, int v, int e, int pad_id, void* stream) {
  if (n <= 0 || v <= 0 || e <= 0 || e % 8 || w_dtype < 0 || w_dtype > 1 || out_dtype < 0 ||
      out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* id = (const int*)ids;
  if (w_dtype == 0)
    return out_dtype == 0 ? launch_gather<float, float>(w, id, out, n, v, e, pad_id, st)
                          : launch_gather<float, bf16>(w, id, out, n, v, e, pad_id, st);
  return out_dtype == 0 ? launch_gather<bf16, float>(w, id, out, n, v, e, pad_id, st)
                        : launch_gather<bf16, bf16>(w, id, out, n, v, e, pad_id, st);
}

// out: 8 ints, see GradPlan
int vct_embed_grad_plan(int dtype, int n, int e, int* out) {
  GradPlan p;
  if (!grad_plan(dtype, n, e, &p)) return (int)cudaErrorInvalidValue;
  const int vals[8] = {p.chunk, p.chunks, p.rank_blocks, p.fill_blocks, p.accum_blocks,
                       p.threads, p.round_blocks, p.scratch_ints};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

// out float32 [v, e] = the gradient of a float32 or bf16 table whose rows
// ids [n] were gathered, from g [n, e] in dtype: every row zeroed, then each
// id's rows of g summed in float32 in ascending position and rounded once to
// dtype; pad_id and ids outside [0, v) take nothing. scratch: int32
// [scratch_ints] of the plan.
int vct_embed_grad(int dtype, const void* g, const void* ids, void* out, void* scratch, int n,
                   int v, int e, int pad_id, void* stream) {
  GradPlan pl;
  if (v <= 0 || !grad_plan(dtype, n, e, &pl)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 1 ? launch_grad<bf16>(pl, g, (const int*)ids, (float*)out, (int*)scratch, n,
                                        v, e, pad_id, st)
                    : launch_grad<float>(pl, g, (const int*)ids, (float*)out, (int*)scratch, n,
                                         v, e, pad_id, st);
}

}  // extern "C"
