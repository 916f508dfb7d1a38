// Several greedy tokens per launch for Hopper (sm_90a), bound through a plain
// C interface (ctypes). Python side: vct_tpu_torch/ops/decode_kernels.py.
//
// decode_multi_kernel runs the fused_multi_step windows and the
// fused_sequence_decode captions that small_step.cu's plans
// (multi_step_plan, sequence_decode_plan) leave to it: float32, rows above
// 64, widths they refuse; vct_multi_step and vct_sequence_decode reach it by
// route 0 for same-run timing. In bfloat16 it sums in another order than the
// small-row kernel, so its tokens may part from the per-token loop's at
// near-ties.
//
// Replaces (vct_tpu/ops/pallas_decode.py):
//   * fused_multi_step      (:1289, _multi_step_kernel :1144) - u tokens of a
//     window; the raw argmax chain comes back, the caller applies the
//     all-rows-finished -> PAD rule between windows;
//   * fused_sequence_decode (:997, _sequence_decode_kernel :858) - the whole
//     caption, with the done flags and the PAD rule inside.
//
// What bounds them on an H100: as for the one-token kernel (decode_step.cu),
// every token streams the stack's and the generator's weights once, so a
// launch of n tokens is bound by n times the weight bytes; what these
// kernels remove is the host work between two launches, not device work.
//
// Design: the cooperative one-launch-per-token kernel with a token loop
// around decode_token (decode_common.cuh). What the loop adds:
//   * the embedding is fused into the loader of the first product: the row
//     of the current token (zero for pad_id) plus the position's row, summed
//     in fp32 and rounded once;
//   * each token has its own argmax key slots (keys [n_tok, B], zeroed by
//     the wrapper before the launch), complete after the grid.sync() that
//     ends decode_token. Every block then decodes the new tokens from the
//     keys into its shared memory by itself, so feeding token j into token
//     j + 1 costs no further barrier;
//   * cache rows are written in place and made visible by the barrier after
//     the QKV phase, so a window's fresh rows are attended from the cache
//     (the reference patches them in from registers because its cache tile
//     is a stale copy);
//   * the sequence mode keeps each row's done flag in shared memory. Every
//     block computes the same flags from the same keys, so all blocks agree
//     on "every row has finished" and leave the loop together; the remaining
//     positions keep the pad_id the wrapper filled in.

#include "decode_common.cuh"

struct MultiArgs {
  StepArgs s;         // x unused; idx unused (positions are i0 + j); gen = 1
  const void* emb;    // [n_emb, E] T
  const void* pe;     // [>= i0 + n_tok, E] T
  const int* cur;     // [B] the first input tokens (window mode)
  int* tok_out;       // window: [B, n_tok]; sequence: [B, max_len], column 0
                      // and the pad fill written by the wrapper
  int n_emb, i0, n_tok;
  int seq;            // 0: a window's raw argmax chain; 1: the whole caption
  int poison;         // window mode: write -1 for every token
  int start_id, end_id, pad_id, out_ld;
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2) decode_multi_kernel(MultiArgs a) {
  extern __shared__ float smem_all[];
  cg::grid_group grid = cg::this_grid();
  const int B = a.s.B, E = a.s.E;
  int* cur_s = (int*)smem_all;       // [B] the tokens fed into this step
  int* done_s = cur_s + B;           // [B] sequence mode: the row has emitted end_id
  float* smem = smem_all + ((2 * B + 3) / 4) * 4;

  // sequence mode: the caches are scratch of the launch and stay as they
  // were allocated; token j writes row j before it attends rows 0..j
  for (int b = threadIdx.x; b < B; b += NTHREADS) {
    cur_s[b] = a.seq ? a.start_id : a.cur[b];
    done_s[b] = 0;
  }
  __syncthreads();

  EmbedIn emb;
  emb.emb = a.emb; emb.cur = cur_s; emb.n_emb = a.n_emb; emb.pad_id = a.pad_id;
  for (int j = 0; j < a.n_tok; ++j) {
    u64* keys = a.s.keys + (size_t)j * B;
    emb.pe_row = (const T*)a.pe + (size_t)(a.i0 + j) * E;
    decode_token<T>(a.s, grid, smem, a.i0 + j, &emb, keys);
    // the keys of token j are complete: every block resolves the next input
    int mine_done = 1;
    for (int b = threadIdx.x; b < B; b += NTHREADS) {
      int nxt = key_index(__ldcg(keys + b));
      if (a.seq) {
        done_s[b] |= nxt == a.end_id;
        mine_done &= done_s[b];
      }
      cur_s[b] = nxt;
      if (blockIdx.x == 0)
        a.tok_out[(size_t)b * a.out_ld + (a.seq ? j + 1 : j)] = a.poison ? -1 : nxt;
    }
    // also publishes cur_s; the same value in every thread of every block
    const int all_done = __syncthreads_and(mine_done);
    if (a.seq && all_done) break;  // every later position keeps the pad fill
  }
}

template <typename T>
static cudaError_t launch_multi(const MultiArgs& a, cudaStream_t stream) {
  const size_t smem = step_smem_bytes(a.s.E, a.s.F) + sizeof(float) * (((2 * a.s.B + 3) / 4) * 4);
  return launch_cooperative(decode_multi_kernel<T>, a, smem, stream);
}

extern "C" {

// tensors: the 31 StepArgs pointers (x unused, keys [n_tok, B] zeroed by the
// caller, out unused), then emb, pe, cur, tok_out. dtype: 0 = float32,
// 1 = bfloat16.
int vct_decode_multi(int dtype, void* const* t, int B, int E, int H, int F, int NL, int L,
                     int Tm, int V, int l_view, int n_emb, int i0, int n_tok, int seq,
                     int poison, int start_id, int end_id, int pad_id, int out_ld,
                     void* stream) {
  MultiArgs a;
  fill_step_args(a.s, t);
  a.s.B = B; a.s.E = E; a.s.H = H; a.s.F = F; a.s.NL = NL; a.s.L = L; a.s.Tm = Tm;
  a.s.V = V; a.s.idx = 0; a.s.l_view = l_view; a.s.gen = 1;
  a.emb = t[31]; a.pe = t[32]; a.cur = (const int*)t[33]; a.tok_out = (int*)t[34];
  a.n_emb = n_emb; a.i0 = i0; a.n_tok = n_tok; a.seq = seq; a.poison = poison;
  a.start_id = start_id; a.end_id = end_id; a.pad_id = pad_id; a.out_ld = out_ld;
  if (Tm > LMAX || l_view > LMAX || E % H != 0 || E % 8 || F % 8 || V % 8 || n_tok < 1 ||
      B > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 1 ? launch_multi<__nv_bfloat16>(a, st) : launch_multi<float>(a, st));
}

}  // extern "C"
