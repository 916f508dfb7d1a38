// Adam's (and AdamW's) update of a param group in one pass, for Hopper
// (sm_90a), bound through a plain C interface (ctypes). Python side:
// vct_tpu_torch/ops/optim_kernels.py; the optimizers that call it:
// vct_tpu_torch/train/optimizers.py.
//
// Replaces no TPU kernel: the JAX package's update (optax.adam / adamw in
// vct_tpu/train/optimizers.py) is plain XLA. It was added for the graphed
// train step, where torch's capturable multi-tensor Adam made eight passes
// over float32 tensors of every parameter's size (lerp into m, mul and
// addcmul of v, sqrt of v into a temporary, two divides and an add on that
// temporary, addcdiv into p): 80 bytes a parameter, and its two divides by a
// 0-dim device tensor ran as unvectorised, broadcasting elementwise kernels
// one tensor at a time.
//
// What bounds it on an H100: bytes. Each element needs its parameter,
// gradient and both moments read and the parameter and moments written:
// 28 bytes, nothing reused, nothing to compute that the card notices (one
// sqrt and three divides an element). 1.73 B parameters are 48.6 GB, 14.5 ms
// at 3.35 TB/s.
//
// Design:
//   * adam_update_kernel: the arithmetic of torch's capturable branch, in
//     float32, operation for operation and rounded where torch rounds
//     (t = step + 1; m = m + (1 - b1)(g - m), torch's lerp; v = b2 v +
//     (1 - b2) g g; p += m / ((sqrt(v) / sqrt(1 - b2^t) + eps) /
//     (lr / (b1^t - 1))); with decoupled decay p = p (1 - lr wd) first),
//     with no temporary in device memory. lr and each tensor's step are
//     read from the device, so a graph replay sees the values filled in
//     since its capture.
//   * The group's tensors travel in the launch's parameters (pointers,
//     sizes, the running sum of their 16-byte units): nothing is copied
//     from the host, which a CUDA graph's capture would refuse. Since CUDA
//     12.1 a launch takes 32,764 bytes of parameters, room for CAPACITY
//     tensors; a larger group is launched in parts by the wrapper.
//   * The group's units (16-byte runs of 4 elements, each tensor's count
//     rounded up) laid end to end are cut into tiles of THREADS x UNROLL
//     units; a persistent grid of at most BLOCKS_PER_SM blocks a SM takes
//     them in turn, block b tiles b, b + B, b + 2B, ..., so the tiles split
//     evenly (counts one apart) and at any moment the blocks stream
//     neighbouring tiles: the card's memory sees each operand as one front
//     of adjacent addresses. (Contiguous ranges of T / B units a block, the
//     first design, kept 264 far-apart streams of each operand open and
//     reached 58% of the byte bound at the LFM2 cell's parameters and 67%
//     at the MSVD recipe's; the tiles reach 87% and 81%.) A tile may span
//     tensors. The split follows the sizes alone: a list of many small
//     tensors and one of a few stacked expert tensors take the same code.
//   * Each thread has UNROLL 16-byte loads of each of the four operands in
//     flight, loaded and stored with the streaming hints (ld.global.cs,
//     st.global.cs): nothing is read twice. No shared memory. A tensor's last
//     numel % 4 elements are updated one element a thread. Not compute
//     bound: multiplying by reciprocals in place of the divides gains
//     nothing measurable.
//   * adam_count_kernel, one block launched after it, adds 1 to every
//     tensor's step: the update kernel's blocks all read the step before,
//     so no block sees another's write.
//   No atomics and no order between blocks: every run gives the same bits,
//   and a graph replay gives the eager call's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;          // 16-byte units of each operand in flight a thread
constexpr int BLOCKS_PER_SM = 2;   // 512 threads of at most 128 registers (122 built) a SM
constexpr int COUNT_THREADS = 256;
#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
constexpr int CAPACITY = 512;      // 28,720 bytes of parameters (the limit is 32,764)
#else
constexpr int CAPACITY = 64;       // under the 4,096-byte limit of older toolkits
#endif

struct Table {
  float* p[CAPACITY];
  const float* g[CAPACITY];
  float* m[CAPACITY];
  float* v[CAPACITY];
  float* step[CAPACITY];
  long long numel[CAPACITY];
  long long start[CAPACITY + 1];  // each tensor's first unit of 4 elements; start[n] all units
  int n;
};

struct Hyper {
  const float* lr;
  float b1, b2;   // betas
  float w1;       // 1 - b1, lerp's weight
  float omb2;     // 1 - b2, addcmul's value
  float eps;
  float wd;       // decoupled weight decay, 0 for none
};

// One tensor's factors, from its step before this update: torch's
// _foreach_pow, sub, div, reciprocal and sqrt on float32 scalars.
struct Factors {
  float step_size;  // lr / (b1^t - 1): negative
  float bc2_sqrt;   // sqrt(1 - b2^t)
  float decay;      // 1 - lr wd
};

__device__ __forceinline__ Factors factors(const Hyper& h, float lr, float step) {
  const float t = __fadd_rn(step, 1.0f);
  Factors f;
  f.step_size = __frcp_rn(__fdiv_rn(__fsub_rn(powf(h.b1, t), 1.0f), lr));
  f.bc2_sqrt = __fsqrt_rn(-__fsub_rn(powf(h.b2, t), 1.0f));
  f.decay = __fsub_rn(1.0f, __fmul_rn(lr, h.wd));
  return f;
}

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, const Hyper& h,
                                       const Factors& f, bool decay) {
  if (decay) p = __fmul_rn(p, f.decay);
  m = fmaf(h.w1, __fsub_rn(g, m), m);
  v = fmaf(h.omb2, __fmul_rn(g, g), __fmul_rn(v, h.b2));
  const float den = __fdiv_rn(__fadd_rn(__fdiv_rn(__fsqrt_rn(v), f.bc2_sqrt), h.eps),
                              f.step_size);
  p = __fadd_rn(p, __fdiv_rn(m, den));
}

__device__ __forceinline__ void update4(float4& p, const float4& g, float4& m, float4& v,
                                        const Hyper& h, const Factors& f, bool decay) {
  update(p.x, g.x, m.x, v.x, h, f, decay);
  update(p.y, g.y, m.y, v.y, h, f, decay);
  update(p.z, g.z, m.z, v.z, h, f, decay);
  update(p.w, g.w, m.w, v.w, h, f, decay);
}

__global__ void __launch_bounds__(THREADS)
adam_update_kernel(const __grid_constant__ Table tab, const Hyper h) {
  constexpr int TILE = THREADS * UNROLL;
  const long long total = tab.start[tab.n];
  const long long tiles = (total + TILE - 1) / TILE;
  const float lr = *h.lr;
  const bool decay = h.wd != 0.0f;
  int i = 0;  // the tile's first tensor: tiles only move forward
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long u0 = t * TILE;
    const long long u1 = u0 + TILE < total ? u0 + TILE : total;
    while (tab.start[i + 1] <= u0) ++i;  // past the tensors (empty ones too) before it
    for (int j = i; j < tab.n && tab.start[j] < u1; ++j) {
      const long long s = tab.start[j];
      const long long a = (u0 > s ? u0 : s) - s;
      const long long b = (u1 < tab.start[j + 1] ? u1 : tab.start[j + 1]) - s;
      if (a >= b) continue;
      const Factors f = factors(h, lr, *tab.step[j]);
      const long long full = tab.numel[j] >> 2;
      const long long end = b < full ? b : full;
      float4* p4 = reinterpret_cast<float4*>(tab.p[j]);
      const float4* g4 = reinterpret_cast<const float4*>(tab.g[j]);
      float4* m4 = reinterpret_cast<float4*>(tab.m[j]);
      float4* v4 = reinterpret_cast<float4*>(tab.v[j]);
      float4 rp[UNROLL], rg[UNROLL], rm[UNROLL], rv[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long u = a + threadIdx.x + k * THREADS;
        if (u < end) {
          rp[k] = __ldcs(p4 + u);
          rg[k] = __ldcs(g4 + u);
          rm[k] = __ldcs(m4 + u);
          rv[k] = __ldcs(v4 + u);
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long u = a + threadIdx.x + k * THREADS;
        if (u < end) {
          update4(rp[k], rg[k], rm[k], rv[k], h, f, decay);
          __stcs(p4 + u, rp[k]);
          __stcs(m4 + u, rm[k]);
          __stcs(v4 + u, rv[k]);
        }
      }
      // the partial last unit: numel % 4 elements, one a thread
      if (full >= a && full < b && threadIdx.x < (tab.numel[j] & 3)) {
        const long long e = full * 4 + threadIdx.x;
        float p = tab.p[j][e], m = tab.m[j][e], v = tab.v[j][e];
        update(p, tab.g[j][e], m, v, h, f, decay);
        tab.p[j][e] = p;
        tab.m[j][e] = m;
        tab.v[j][e] = v;
      }
    }
  }
}

__global__ void __launch_bounds__(COUNT_THREADS)
adam_count_kernel(const __grid_constant__ Table tab) {
  for (int i = threadIdx.x; i < tab.n; i += COUNT_THREADS)
    *tab.step[i] = __fadd_rn(*tab.step[i], 1.0f);
}

int update_blocks(long long units, int sms) {
  const long long per_block = (long long)THREADS * UNROLL;
  long long blocks = (units + per_block - 1) / per_block;
  const long long most = (long long)sms * BLOCKS_PER_SM;
  if (blocks > most) blocks = most;
  return blocks < 1 ? 1 : (int)blocks;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

}  // namespace

extern "C" {

// The most tensors one call takes.
int vct_adam_capacity() { return CAPACITY; }

// The update kernel's grid for a group of `units` 16-byte units on a card of
// `sms` SMs (sms <= 0: the current card's).
int vct_adam_plan(long long units, int sms, int* blocks) {
  if (units < 0) return (int)cudaErrorInvalidValue;
  if (sms <= 0) {
    const int err = sm_count(&sms);
    if (err) return err;
  }
  *blocks = update_blocks(units, sms);
  return 0;
}

// One Adam step of n (1..CAPACITY) float32 tensors, contiguous and on
// 16-byte boundaries: ptrs holds n pointers each of the parameters, the
// gradients, exp_avg, exp_avg_sq and the 0-dim float32 steps, in that order;
// numel each tensor's element count; lr a float32 on the device. Two
// launches on `stream`: the update, then the step counts.
int vct_adam_update(int n, const unsigned long long* ptrs, const long long* numel,
                    const void* lr, float b1, float b2, float w1, float omb2, float eps,
                    float wd, void* stream) {
  if (n < 1 || n > CAPACITY || lr == nullptr) return (int)cudaErrorInvalidValue;
  Table tab;  // copied into the launch's parameters
  tab.n = n;
  tab.start[0] = 0;
  for (int i = 0; i < n; ++i) {
    if (numel[i] < 0) return (int)cudaErrorInvalidValue;
    tab.p[i] = reinterpret_cast<float*>(ptrs[i]);
    tab.g[i] = reinterpret_cast<const float*>(ptrs[n + i]);
    tab.m[i] = reinterpret_cast<float*>(ptrs[2 * n + i]);
    tab.v[i] = reinterpret_cast<float*>(ptrs[3 * n + i]);
    tab.step[i] = reinterpret_cast<float*>(ptrs[4 * n + i]);
    tab.numel[i] = numel[i];
    tab.start[i + 1] = tab.start[i] + (numel[i] + 3) / 4;
  }
  const Hyper h{reinterpret_cast<const float*>(lr), b1, b2, w1, omb2, eps, wd};
  cudaStream_t st = (cudaStream_t)stream;
  if (tab.start[n] > 0) {
    int sms = 0;
    const int err = sm_count(&sms);
    if (err) return err;
    adam_update_kernel<<<update_blocks(tab.start[n], sms), THREADS, 0, st>>>(tab, h);
    const cudaError_t launch = cudaGetLastError();
    if (launch != cudaSuccess) return (int)launch;
  }
  adam_count_kernel<<<1, COUNT_THREADS, 0, st>>>(tab);
  return (int)cudaGetLastError();
}

}  // extern "C"
