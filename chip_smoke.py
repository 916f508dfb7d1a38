#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, evaluation and video paths
once on one CUDA card.

    python3 chip_smoke.py                  every phase below
    python3 chip_smoke.py --profile-train  build, then a torch.profiler
                                           reading of a few MSVD train steps
    python3 chip_smoke.py --profile-long-train  the same reading of the
                                           long-video recipe's train step, with
                                           the attention kernels on and off
    python3 chip_smoke.py --profile-decode build, then a torch.profiler
                                           reading of one caption at B=1 in
                                           each greedy mode
    python3 chip_smoke.py --profile-beam   build, then a torch.profiler
                                           reading of a beam-4 eval batch of 64
    python3 chip_smoke.py --stack-variant ROOT
                                           the package under ROOT (a copy of
                                           vct_tpu_torch with a changed
                                           csrc/stack_step.cu or
                                           csrc/small_step.cu) in place of the
                                           one beside the script: its stack
                                           kernel's time at B=128 and 256 rows,
                                           the small-row kernels' at B=1, 32
                                           and 64 (u=4 at 32; the sequence
                                           kernel at 32 and 1, the layer step
                                           at 32), its route checks
                                           and the bf16 beam loop checks, and
                                           per-phase times if its library
                                           exports vct_stack_stamps or
                                           vct_small_stamps (a copy that
                                           defines VCT_SMALL_STAMPS)

Phases, each of which must pass:
  1. device   the card's name and power limit (nvidia-smi); no card -> exit 1
  2. build    nvcc builds vct_tpu_torch/csrc into the package's _build/
  3. kernels  each CUDA kernel against its plain PyTorch version on the card,
              at the MSVD widths in bfloat16 (seeded inputs, several idx and
              l_view windows, both window poisons); the generator + argmax
              kernel at B = 1, 65, 128, 200 and 256 (tokens equal but at
              near-ties, no pad column wins, the same tokens twice) and with
              one weight column planted on both sides of a slab boundary and
              in a far slab, where the lowest index must win; the stack
              kernel's tensor-core routes at B = 1, 32, 64 (small-row
              kernel), 65, 128 and 256 (stack_step_kernel) against its plain
              version and the kernel it replaced, the same bits twice, and
              its plan (stack_step_plan) against the C launcher's; the
              whole step's small-row kernel at B = 1, 7, 32 and 64 against
              its plain version and decode_step_kernel, the same bits twice,
              the tokens of the beam's stack + top-k (k=1) and of the argmax
              kernel equal to its own, its window poison, and its plans
              (whole_step_plan, multi_step_plan) against the launchers'
  4. server   configs/msvd.json with a synthetic 30522-entry vocab and seeded
              random weights saved as a reference-keyed .pth; the port's HTTP
              server on port 0 with max_batch 32 answers concurrent
              /v1/caption requests (some shorter than 12 frames, so the memory
              mask is used); the served tokens are held against the port's
              module path on the card
  5. b128     greedy_generate_fused at B=128 (fused_layers_step +
              fused_norm_generator_argmax) against the module path
  6. loss-kernels  the three fused-loss kernels against their plain versions
              at N=1984, E=768, V=30522 in bfloat16 (and float32 at N=300),
              on the generator as the fused loss passes it (cast, not
              padded): SCE and CE-only, a ragged last row tile, labels in the
              last partial vocab tile, rows of zero weight; the four loss
              parts and every gradient through the autograd function against
              the chunked route; the bfloat16 statistics kernels (the
              tensor-core kernel) at N = 256, 1000, 1984 and 4096, V = 1111,
              3000 and 30522 bare and 30522 padded, E = 768 and 896, against
              their plain versions and the kernel they replaced, labels
              outside [0, V), the same bits from two calls, and their launch
              plan (sce_stats_plan) against the C launcher's; the bfloat16
              backward's tensor-core route at N = 1984, 4096, 1000 and 300
              (E = 896) the same way, and its plan (sce_backward_plan)
  7. train    a synthetic MSVD-shaped dataset (features, annotations, the
              30522-entry vocab) and configs/msvd.json with only paths and
              the epoch count changed, through vct_tpu_torch.cli.train's
              main: 20 train steps at batch 64, a validation pass, an eval
              decode and a checkpoint; then a second run resumes it for one
              more epoch. Every loss finite, the training loss falls, 3 loss
              kernel launches per train step and 2 per validation step, and
              step 0's loss and gradients equal on the kernel route and the
              chunked route
  8. beam-kernels  the four kernels of the eval slice against their plain
              versions in bfloat16 at the MSVD widths: the top-k kernel at
              256 beam rows with k=4 (and crafted ties across column blocks,
              the same bits from run to run, and the widest k it carries;
              then its tensor-core route at B = 1, 65, 128, 200, 256 and k =
              1, 4, 32 on a ragged vocab against the plain version and the
              kernel it replaced, with ties across slabs),
              fused_layer_step (the stack's launch at NL = 1) at B = 1, 32,
              64 (small-row kernel), 65 and 256 (stack_step_kernel) against
              its plain version and the kernel it replaced, the same bits
              twice, fused_layers_step's bits at NL = 1, an idx past the
              cache refused on every route;
              fused_multi_step at B = 1, 7, 32 and 64, u=2 and 4, over
              several windows against the plain version and the kernel it
              replaced, the same bits twice, the per-token whole step along
              its chain bit for bit, the window poison on both routes;
              fused_sequence_decode (small-row kernel) at B=1 and 32, free
              running, with end tokens that stop rows and the whole batch
              early, and with every row done at step 1 (the pad fill): the
              per-token kernel loop's bits, the same bits twice, against the
              plain loop and the kernel it replaced but at near-ties
  9. eval     vct_tpu_torch.cli.eval's main on the synthetic dataset (160
              videos, eval batch 64) and the seeded .pth: greedy, --beam 4
              (256 beam rows) and --beam 1; predictions and metrics files
              written, every score finite, --beam 1 equal to greedy; the
              beam path against the module path on the card in float32
              (tokens); in bfloat16 the kernel beam loop against the same
              loop on the kernels' plain versions at 256 beam rows and at a
              beam of 16, and against the module path, where beams may part
              only at candidate near-ties; a beam above the top-k kernel's
              width raises
 10. multi    greedy_generate_fused(multi_step=2 and 4) and a beam of 1
              token-equal, bit for bit, to the per-token kernel loop at B=1,
              32 and 64 (the beam also at 65), and so are
              (sequence_kernel=True) at B=1 and 32 and a 29-token decode at
              B=32 with the stack run layer by layer through
              fused_layer_step; the per-token loop against the plain greedy
              chain but at near-ties at B=1 and 32
 11. timings  kernel, plain and library-call times with each kernel's bound
              (the whole step at B = 32, 1 and 64, the u=4 window at B=32,
              the sequence kernel at B = 32 and 1, fused_layer_step at B=32
              and the stack at 1-64 rows against the kernels they replaced),
              ms per token of both decode paths at B=1, 32 and 128,
              captions/s of the server phase, the loss routes at N=1984 and
              N=7936, the generator's padded copy against the bare cast, ms
              per train step with the fused loss on and off, ms per caption
              at B=1 of the per-token loop, u=2, u=4 and the
              sequence kernel, beam-4 against greedy captions/s at eval
              batch 64 with beam's parts apart

 12. attn-kernels  fused_attention and fused_attention_trainable (forward and
              backward, dropout rate 0 and 0.3 with a seeded keep mask)
              against their plain versions: bfloat16 at the long-video
              recipe's three shapes (B=32, H=8, D=96; encoder 256 x 256 with
              a [B,1,1,Tk] padding bias, decoder self 128 x 128 with a
              [B,1,T,T] causal + padding bias, cross 128 x 256), float32 at
              ragged small shapes, no bias, a fully masked row, the same bits
              from two runs, and shapes outside the kernels' span, which
              raise before any launch; the bfloat16 forward on both routes of
              its shape rule (logits on chip, two passes) at Tk = 100, 255 and
              257 with and without bias and keep mask, the two routes'
              statistics against each other, and Tk = 800, past the on-chip
              limit, through the wrappers; the bfloat16 backward's on-chip
              route at ragged shapes (Tk up to its limit of 320), every bias
              kind, a fully masked row, keep mask on and off, against the
              plain version and the pair it replaced, and its plan at the
              boundaries
 13. long-train  the long-video recipe (configs/msvd.json with
              tpu.max_frames 255, tpu.max_caption_len 129 and batch 32;
              videos of 100-400 frames, captions of 40-140 words) through
              vct_tpu_torch.cli.train's main: 10 train steps, a validation
              pass, an eval decode, a checkpoint; every loss finite, the loss
              falls; 7 forward and 7 backward attention launches and 3 loss
              kernel launches per train step, 7 inference attention launches
              per validation step; step 0's loss and gradients with
              tpu.use_pallas_attention on against off under one generator
              seed (the same dropout masks), and no attention launch when off
 14. long-eval  vct_tpu_torch.cli.eval greedy on the long recipe: one
              attention launch per batch; one batch's tokens against the
              module path of a model with the kernels off
 15. encoders  an HMME model (512 + 1024 wide, layers (2, 1), 127 + 127
              frames -> 256 tokens) and a SimpleSep model at the MSVD width:
              caption loss and gradients on the kernel route against the math
              route; an MME encode with biGRU aggregation against the CPU
 16. attn-timings  for each long-recipe shape the kernels' forward and
              backward ms (and the kernels they replaced), the bound, the
              plain version, the math path and
              F.scaled_dot_product_attention with the same mask (timed only,
              the port never calls it); ms per long train step with the
              attention kernels on and off
 17. video    a seeded ViT-B/32 at full width (OpenAI keys, .pt) and seeded
              .avi files: the tower's features on the card against the CPU
              in float32; vct_tpu_torch.cli.predict's main -v (uni_12) on
              phase 4's checkpoint: fused_whole_step once per generated
              token, the tokens against the module path on the tower's
              features; --beam 4: fused_layers_step and
              fused_norm_generator_topk once per beam token; --vis_attn:
              predict.attn [29, layers, 1, 13] from the module path (and the
              heatmap where matplotlib is installed); the server with
              --clip_weights answers 8 concurrent /v1/caption_video, each
              batch against the module path; tower and request ms
 18. cross-train  a seeded full-width CLIP text tower (.pt) and a synthetic
              BPE vocab: configs/msvd.json with train.task cross through
              vct_tpu_torch.cli.train's main (20 train steps, validation,
              eval decode, checkpoint): every loss finite, the total falls,
              the three loss kernels once per train step; step 0's cap_loss
              and match_loss on the card against the CPU (dropout off) in
              float32 and bfloat16; ms per cross train step; a Trainer with
              caption_decoder.univl importing a seeded UniVL decoder at the
              MSVD widths, each weight equal to its source

Times: every row of the ``kernels`` line names its ``timer``. ``cuda_events``
is ``cuda_time``, CUDA events around a Python loop of calls. ``graph_replay``
is ``device_time`` (the calls captured into a CUDA graph and replayed: the
device alone), used for the generator + argmax kernel, the top-k kernel, the
attention forward and (``backward_timer``) backward, the three loss kernels
(at N=1984 and, in ``*_n4096``, N=4096) and their library calls, the stack
kernel (at B=128 and, in ``*_b256``, 256 beam rows; at 1-64 rows in
``*_b1``, ``*_b32``, ``*_b64``), the whole step (B=32; ``*_b1``, ``*_b64``),
the multi-token window, the sequence kernel (B=32; ``*_b1``) and the layer step,
because their wrappers' host code outlasts the kernels or, for the backward,
because autograd's host loop is no clock of its kernels; ``eager_ms`` is the
loop's reading of the same call (for the backward, forward + backward minus
forward). SDPA's backward (``backward_library_ms``) is the ATen backward op
it dispatched to: its autograd node called on the saved tensors of one
forward, captured like the rest.
``previous_same_run_ms`` is the kernel that a redesign replaced, timed in this
run on the same inputs by the same timer. ``cold_weight_ms`` replays the
generator kernel on two copies of the weight in turn (94 MB against 50 MB of
L2), so that no call finds its weight left in L2 by the call before.

Launch counts are set to 0 just before phases 4, 5, 7, 9, 10, 13, 14, 17 and
18 (each predict run and the video server in 17) and read just after each:
the server must have launched the whole-step kernel,
the B=128 decode the other two decode kernels, training the three loss
kernels, the beam eval the stack and top-k kernels once per beam token, the
multi phase the other three, the long training the trainable attention kernel
forward and backward, the long eval the inference attention kernel, the video
path the whole step (greedy, served) and the stack and top-k (beam), cross
training the three loss kernels. The line
before the last is a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}, printed only when every phase passed. Any
failure exits 1 before it.
"""

from __future__ import annotations

import dataclasses
import io
import itertools
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from http.client import HTTPConnection
from pathlib import Path

import numpy as np
import torch

SEED = 666
MAX_BATCH = 32
N_REQUESTS = 48
# bfloat16 keeps 8 significant bits. Kernel and plain version round at the
# same points but sum in other orders, so a value near a rounding boundary
# may land one unit in the last place (2**-6 at magnitudes 2..4 after a
# LayerNorm) apart, and such a unit travels on through later layers.
BF16_ATOL = 0.125          # max abs difference: 8 such units
BF16_MEAN_ATOL = 2e-3      # mean abs difference: almost every value agrees
NEAR_TIE_SAME = 1e-2       # kernel vs plain version: same rounding points
# The module path rounds every product, and its logits, to bfloat16: logits
# of magnitude 4..8 carry a unit of 2**-5, and the hidden state differs from
# the kernels' fp32-statistics schedule by a few such units.
NEAR_TIE_MODULE = 0.125
SOURCE = "vct_tpu_torch/csrc/decode_step.cu"
SMALL_SOURCE = "vct_tpu_torch/csrc/small_step.cu"
SMALL_BATCHES = (1, 7, 32, 64)   # the small-row kernel's rows: one, ragged, serving, its top
LOSS_SOURCE = "vct_tpu_torch/csrc/sce_loss.cu"
REPLACES = {
    "fused_whole_step": "vct_tpu/ops/pallas_decode.py:581",
    "fused_layers_step": "vct_tpu/ops/pallas_decode.py:516",
    "fused_norm_generator_argmax": "vct_tpu/ops/pallas_decode.py:811",
}
# the kernels of the eval slice: name -> (TPU kernel, CUDA source)
BEAM_REPLACES = {
    "fused_norm_generator_topk": ("vct_tpu/ops/pallas_decode.py:721",
                                  "vct_tpu_torch/csrc/gen_topk.cu"),
    "fused_layer_step": ("vct_tpu/ops/pallas_decode.py:211", SMALL_SOURCE),
    "fused_multi_step": ("vct_tpu/ops/pallas_decode.py:1289", SMALL_SOURCE),
    "fused_sequence_decode": ("vct_tpu/ops/pallas_decode.py:997", SMALL_SOURCE),
}
# Top-k values and logsumexp: kernel and plain version form float32 logits
# from the same float32 LayerNorm output and bfloat16 weights and differ by
# the order of a 768-term float32 sum.
TOPK_ATOL = 1e-3
ARGMAX_BATCHES = (1, 65, 128, 200, 256)
# ms of the kernels that a redesign replaced, as earlier runs of this script
# recorded them by ``cuda_time`` (NVIDIA H100 80GB HBM3, 700.00 W). Printed on a
# line of their own for the reader; the ``kernels`` line holds only what this
# run measures (``previous_same_run_ms``).
RECORDED_PREVIOUS_MS = {
    "fused_norm_generator_argmax": 0.4596,
    "fused_attention": {"encoder_self": 0.3009, "decoder_self": 0.0910,
                        "decoder_cross": 0.1550},
    "fused_attention_trainable": {"encoder_self": 0.3445, "decoder_self": 0.1657,
                                  "decoder_cross": 0.1834},
    "fused_attention_trainable_backward": {"encoder_self": 1.3829, "decoder_self": 0.6538,
                                           "decoder_cross": 0.7419},
    "fused_norm_generator_topk": 0.8690,
    "fused_layers_step": {"b128": 0.8744, "b256": 1.3138},
    "fused_whole_step": 0.6746,
    "fused_multi_step": 2.8116,
    "fused_sequence_decode": 21.9150,
    "fused_layer_step": 0.1622,
    "sce_backward_tiles": 4.5906,
}
BEAM_ROWS, BEAM_K = 256, 4   # eval batch 64 x beam 4
LOSS_REPLACES = {
    "softmax_stats": "vct_tpu/ops/pallas_loss.py:124",
    "clipped_prob_stats": "vct_tpu/ops/pallas_loss.py:207",
    "sce_backward_tiles": "vct_tpu/ops/pallas_loss.py:305",
}
# Published peaks of one H100 SXM (NVIDIA's data sheet): the least time a
# kernel could take is the larger of bytes / HBM rate and operations / peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the MSVD train step's loss shape: batch 64 x 31 positions, width 768
LOSS_N, LOSS_E, LOSS_V = 1984, 768, 30522
TRAIN_STEPS, VAL_STEPS, BATCH = 20, 2, 64
EVAL_VIDEOS = TRAIN_STEPS * BATCH // 8  # the eval phase decodes the train split's videos


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def synthetic_vocab(path: Path, size: int = 30522) -> None:
    """BERT's special ids ([PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102,
    [MASK]=103), filler words elsewhere."""
    special = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]", 103: "[MASK]"}
    words = [special.get(i, f"[unused{i}]" if i < 100 else f"w{i}") for i in range(size)]
    path.write_text("\n".join(words) + "\n")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple:
    """(least ms the card could take, "bytes" or "operations")."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def cuda_time(fn, iters: int = 20) -> float:
    """ms per call by CUDA events, after a warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time(fn, iters: int = 20) -> float:
    """ms per call on the device alone: ``iters`` calls captured into one CUDA
    graph and replayed, timed by CUDA events. A kernel of a few hundredths of
    a millisecond takes less than its wrapper's Python and launch code, so
    ``cuda_time`` of it reads the host; a decode loop's host runs ahead of the
    device and its tokens cost the device time."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # a warm-up off the default stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def library_plan(entry: str, *args, n: int) -> tuple:
    """The launch plan the C launcher reports (``n`` ints)."""
    import ctypes

    from vct_tpu_torch.ops._build import load_library

    out = (ctypes.c_int * n)()
    if getattr(load_library(), entry)(*args, out) != 0:
        fail(f"{entry}{args}: the launcher reports no plan")
    return tuple(out)


class no_plain_on_cuda:
    """While active, records every call of a plain version (``*_reference``
    in ``module``) on a CUDA tensor; leaving the block fails the run if there
    was one."""

    def __init__(self, what, module):
        self.what, self.module, self.seen, self.originals = what, module, [], {}

    def __enter__(self):
        for name in [n for n in dir(self.module) if n.endswith("_reference")]:
            fn = self.originals[name] = getattr(self.module, name)

            def spy(*a, _fn=fn, _name=name, **k):
                if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                    self.seen.append(_name)
                return _fn(*a, **k)

            setattr(self.module, name, spy)
        return self

    def __exit__(self, exc_type, exc, tb):
        for name, fn in self.originals.items():
            setattr(self.module, name, fn)
        if exc_type is None and self.seen:
            fail(f"{self.what}: plain versions ran on CUDA tensors: {sorted(set(self.seen))}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def step_inputs(fw, b, idx, tm, gen):
    """Seeded decode-step inputs at the model's widths: caches filled below
    idx, zeros from idx on, a memory bias that masks the tail of odd rows."""
    stacked = fw["stacked"]
    nl, e, dt, dev = stacked["wqkv"].shape[0], stacked["wqkv"].shape[1], \
        stacked["wqkv"].dtype, stacked["wqkv"].device
    g = torch.Generator(device="cpu").manual_seed(gen)
    rnd = lambda *s: torch.randn(s, generator=g).to(dev, dt)  # noqa: E731
    kc, vc = rnd(nl, 32, b, e), rnd(nl, 32, b, e)
    kc[:, idx:] = 0
    vc[:, idx:] = 0
    mem_bias = torch.zeros((b, tm), device=dev)
    mem_bias[1::2, -4:] = -1e30
    return {"x": rnd(b, e), "kc": kc, "vc": vc, "ck": rnd(nl, tm, b, e),
            "cv": rnd(nl, tm, b, e), "mem_bias": mem_bias}


def compare_float(name, got, want, means):
    """Max abs difference of two bf16 results; their mean abs difference is
    appended to ``means``."""
    if not bool(torch.isfinite(got.float()).all()):
        fail(f"{name}: non-finite values")
    d = (got.float() - want.float()).abs()
    mx, mean = float(d.max()), float(d.mean())
    means.append(mean)
    if mx > BF16_ATOL or mean > BF16_MEAN_ATOL:
        fail(f"{name}: max abs diff {mx} (limit {BF16_ATOL}), mean {mean} "
             f"(limit {BF16_MEAN_ATOL})")
    return mx


def token_err(name, got, want, logits, bound):
    """Tokens must agree except where the plain logits' top-2 gap is under
    ``bound``; returns the largest logit shortfall of a differing token."""
    bad = (got != want).nonzero().flatten().tolist()
    top = torch.topk(logits.float(), 2, dim=-1).values
    gaps = (top[:, 0] - top[:, 1])
    err = 0.0
    for r in bad:
        gap = float(gaps[r])
        if gap >= bound:
            fail(f"{name}: row {r} token {int(got[r])} vs {int(want[r])}, top-2 gap "
                 f"{gap} >= {bound}")
        err = max(err, float(logits[r, want[r]] - logits[r, got[r]]))
    if bad:
        say(f"  {name}: {len(bad)}/{len(got)} tokens differ, all near-ties")
    return err


def plain_logits(dk, x, fw):
    return dk._ln(x, fw["norm_s"], fw["norm_b"]) @ fw["wg"].float() + fw["bg"]


def check_kernels(fw, heads, tm):
    from vct_tpu_torch.ops import decode_kernels as dk

    errs = {k: 0.0 for k in REPLACES}
    means = []
    # fused_whole_step at B=1 and B=32, windows below the full 32 rows
    for b, cases in ((1, ((0, 8), (7, 8), (17, 24))), (32, ((3, 8), (12, 16), (29, 32)))):
        for idx, l_view in cases:
            a = step_inputs(fw, b, idx, tm, gen=b * 100 + idx)
            k1, v1 = a["kc"].clone(), a["vc"].clone()
            k2, v2 = a["kc"].clone(), a["vc"].clone()
            tok, _, _ = dk.fused_whole_step(a["x"], k1, v1, a["ck"], a["cv"], a["mem_bias"],
                                            fw, idx, heads=heads, l_view=l_view)
            x_ref = dk._stack_reference(a["x"], k2, v2, a["ck"], a["cv"], a["mem_bias"],
                                        fw["stacked"], idx, heads, l_view)
            tok_ref = dk.fused_norm_generator_argmax_reference(
                x_ref, fw["norm_s"], fw["norm_b"], fw["wg"], fw["bg"])
            torch.cuda.synchronize()
            name = f"fused_whole_step B={b} idx={idx} l_view={l_view}"
            errs["fused_whole_step"] = max(
                errs["fused_whole_step"],
                compare_float(name + " k rows", k1[:, idx], k2[:, idx], means),
                compare_float(name + " v rows", v1[:, idx], v2[:, idx], means),
                token_err(name, tok, tok_ref, plain_logits(dk, x_ref, fw), NEAR_TIE_SAME))
            if int(tok.max()) >= fw["vocab"]:
                fail(f"{name}: a padded vocab column won")
            say(f"  ok {name}")
    # fused_layers_step at B=128
    for idx, l_view in ((5, 8), (20, 24), (31, 32)):
        a = step_inputs(fw, 128, idx, tm, gen=1000 + idx)
        k1, v1 = a["kc"].clone(), a["vc"].clone()
        k2, v2 = a["kc"].clone(), a["vc"].clone()
        x_k, _, _ = dk.fused_layers_step(a["x"], k1, v1, a["ck"], a["cv"], a["mem_bias"],
                                         fw["stacked"], idx, heads=heads, l_view=l_view)
        x_r, _, _ = dk.fused_layers_step_reference(a["x"], k2, v2, a["ck"], a["cv"],
                                                   a["mem_bias"], fw["stacked"], idx,
                                                   heads=heads, l_view=l_view)
        torch.cuda.synchronize()
        name = f"fused_layers_step B=128 idx={idx} l_view={l_view}"
        errs["fused_layers_step"] = max(
            errs["fused_layers_step"], compare_float(name + " x_out", x_k, x_r, means),
            compare_float(name + " k rows", k1[:, idx], k2[:, idx], means),
            compare_float(name + " v rows", v1[:, idx], v2[:, idx], means))
        say(f"  ok {name}")
    errs["fused_layers_step"] = max(errs["fused_layers_step"],
                                    check_stack_routes(fw, heads, tm, means))
    errs["fused_whole_step"] = max(errs["fused_whole_step"],
                                   check_whole_routes(fw, heads, tm, means))
    # fused_norm_generator_argmax on decoder-like activations: one M tile of 64
    # rows, one of 128, two of 128; twice, for the same bits
    gargs = (fw["norm_s"], fw["norm_b"], fw["wg"], fw["bg"])
    for b in ARGMAX_BATCHES:
        x = decoder_like(fw, heads, tm, b, 2000 + b)
        tok = dk.fused_norm_generator_argmax(x, *gargs)
        again = dk.fused_norm_generator_argmax(x, *gargs)
        tok_ref = dk.fused_norm_generator_argmax_reference(x, *gargs)
        torch.cuda.synchronize()
        name = f"fused_norm_generator_argmax B={b}"
        errs["fused_norm_generator_argmax"] = max(
            errs["fused_norm_generator_argmax"],
            token_err(name, tok, tok_ref, plain_logits(dk, x, fw), NEAR_TIE_SAME))
        if not torch.equal(tok, again):
            fail(f"{name}: two runs gave different tokens")
        if int(tok.max()) >= fw["vocab"] or int(tok.min()) < 0:
            fail(f"{name}: a token outside the vocab (a padded column won)")
        say(f"  ok {name}")
    # one weight column planted on both sides of a slab boundary and in a far
    # slab, with a leading bias: the lowest index wins
    plan = library_plan("vct_gen_argmax_plan", 1, 200, x.shape[1], fw["wg"].shape[1], -1, n=9)
    if plan != tuple(dk.gen_argmax_plan(200, x.shape[1], fw["wg"].shape[1], x.dtype)):
        fail(f"fused_norm_generator_argmax: the launcher plans {plan}, the Python mirror differs")
    slab = plan[2]
    wg, bg = fw["wg"].clone(), fw["bg"].clone()
    planted = [slab - 1, slab, 40 * slab + 7]
    for c in planted[1:]:
        wg[:, c] = wg[:, planted[0]]
    bg[planted] = 1e3
    x = decoder_like(fw, heads, tm, 200, 2200)
    tok = dk.fused_norm_generator_argmax(x, fw["norm_s"], fw["norm_b"], wg, bg)
    bg[planted[0]] = 0.0
    tok2 = dk.fused_norm_generator_argmax(x, fw["norm_s"], fw["norm_b"], wg, bg)
    torch.cuda.synchronize()
    if tok.tolist() != [planted[0]] * 200 or tok2.tolist() != [planted[1]] * 200:
        fail(f"fused_norm_generator_argmax: a tie across the slab boundary at {slab} did "
             f"not go to the lower index")
    del wg, bg
    say(f"  ok fused_norm_generator_argmax ties across slabs (columns {planted})")
    # the window poisons
    a = step_inputs(fw, 32, 8, tm, gen=3000)
    tok, _, _ = dk.fused_whole_step(a["x"], a["kc"], a["vc"], a["ck"], a["cv"],
                                    a["mem_bias"], fw, 8, heads=heads, l_view=8)
    x, _, _ = dk.fused_layers_step(a["x"], a["kc"], a["vc"], a["ck"], a["cv"],
                                   a["mem_bias"], fw["stacked"], 16, heads=heads, l_view=16)
    torch.cuda.synchronize()
    if not bool((tok == -1).all()) or not bool(torch.isnan(x.float()).all()):
        fail("window poisons did not fire")
    say("  ok window poisons (tokens -1, activations NaN)")
    say(f"  max abs differences {errs}, worst mean abs difference {max(means)}")
    return errs


def check_stack_routes(fw, heads, tm, means):
    """fused_layers_step's plan (stack_step_plan) against the launcher's;
    then in bfloat16 at B = 1, 32 and 64, where the plan picks the small-row
    kernel (route 2), and at 65, 128 and 256 beam rows, where it picks
    stack_step_kernel (route 1): x_out and the fresh cache rows against the plain
    version and against decode_step_kernel (route 0), within the step
    kernels' bounds; two calls give the same bits."""
    import ctypes

    from vct_tpu_torch.ops import decode_kernels as dk
    from vct_tpu_torch.ops._build import load_library

    st = fw["stacked"]
    e, f = st["wqkv"].shape[1], st["w1"].shape[-1]
    for dtype, b, (we, wh, wf), route in itertools.product(
            (torch.bfloat16, torch.float32), (1, 64, 65, 256, dk.STACK_MAX_ROWS,
                                              dk.STACK_MAX_ROWS + 1),
            ((e, heads, f), (128, 4, 256), (96, 12, 256), (1280, 8, 2048), (768, 2, 2048),
             (768, 8, 2560)),
            (-1, 0, 1, 2)):
        try:
            want = tuple(dk.stack_step_plan(b, we, wh, wf, dtype, route))
        except ValueError:
            want = None
        out = (ctypes.c_int * 7)()
        err = load_library().vct_stack_step_plan(dk._DTYPE_CODE[dtype], b, we, wh, wf, route, out)
        if (None if err else tuple(out)) != want:
            fail(f"stack_step_plan({b}, {we}, {wh}, {wf}, {dtype}, {route}) is {want}, the "
                 f"launcher's {None if err else tuple(out)}")
    worst = 0.0
    for b, idx, l_view in ((1, 12, 16), (32, 12, 16), (64, 29, 32), (65, 12, 16), (128, 12, 16),
                           (256, 12, 16), (256, 31, 32)):
        plan = dk.stack_step_plan(b, e, heads, f, st["wqkv"].dtype)
        if plan.route != (2 if b <= dk.SMALL_MAX_ROWS else 1):
            fail(f"fused_layers_step B={b}: the plan takes route {plan.route} ({plan.why})")
        a = step_inputs(fw, b, idx, tm, gen=7000 + b + idx)
        args = (a["x"], None, None, a["ck"], a["cv"], a["mem_bias"], st, idx)
        runs = {}
        for label, fn in (
                ("kernel", lambda *s: dk.fused_layers_step(*s, heads=heads, l_view=l_view)[0]),
                ("again", lambda *s: dk.fused_layers_step(*s, heads=heads, l_view=l_view)[0]),
                ("replaced", lambda *s: dk._launch_layers_step(*s, heads=heads, l_view=l_view,
                                                               _route=0)),
                ("plain", lambda *s: dk.fused_layers_step_reference(
                    *s, heads=heads, l_view=l_view)[0])):
            kc, vc = a["kc"].clone(), a["vc"].clone()
            runs[label] = (fn(args[0], kc, vc, *args[3:]), kc[:, idx], vc[:, idx])
        torch.cuda.synchronize()
        name = f"fused_layers_step tensor-core route {plan.route} B={b} idx={idx} l_view={l_view}"
        if not all(torch.equal(p, q) for p, q in zip(runs["kernel"], runs["again"])):
            fail(f"{name}: two calls gave different bits")
        for ref in ("plain", "replaced"):
            for part, got, want in zip(("x_out", "k rows", "v rows"), runs["kernel"], runs[ref]):
                err = compare_float(f"{name} {part} against the {ref}", got, want, means)
                if ref == "plain":
                    worst = max(worst, err)
        say(f"  ok {name}: against the plain version and the replaced kernel; same bits twice")
    return worst


def check_small_plans(fw, heads):
    """whole_step_plan, multi_step_plan and sequence_decode_plan against the
    launchers' plans."""
    import ctypes

    from vct_tpu_torch.ops import decode_kernels as dk
    from vct_tpu_torch.ops._build import load_library

    st = fw["stacked"]
    e, f, v = st["wqkv"].shape[1], st["w1"].shape[-1], fw["wg"].shape[1]
    for entry, plan_fn in (("vct_whole_step_plan", dk.whole_step_plan),
                           ("vct_multi_step_plan", dk.multi_step_plan),
                           ("vct_sequence_decode_plan", dk.sequence_decode_plan)):
        for dtype, b, (we, wh, wf), wv, route in itertools.product(
                (torch.bfloat16, torch.float32), (1, 7, 32, 33, 64, 65),
                ((e, heads, f), (128, 4, 256), (96, 12, 256), (1280, 8, 2048), (768, 2, 2048),
                 (768, 8, 2560)), (v, 1020), (-1, 0, 1)):
            try:
                want = tuple(plan_fn(b, we, wh, wf, wv, dtype, route))
            except ValueError:
                want = None
            out = (ctypes.c_int * 7)()
            err = getattr(load_library(), entry)(dk._DTYPE_CODE[dtype], b, we, wh, wf, wv, route,
                                                 out)
            if (None if err else tuple(out)) != want:
                fail(f"{plan_fn.__name__}({b}, {we}, {wh}, {wf}, {wv}, {dtype}, {route}) is "
                     f"{want}, the launcher's {None if err else tuple(out)}")


def check_whole_routes(fw, heads, tm, means):
    """fused_whole_step's plans against the launchers'; then in bfloat16 at
    B = 1, 7, 32 and 64, where the plan takes the small-row kernel: tokens
    and fresh cache rows against the plain version and against
    decode_step_kernel (route 0), tokens equal but at near-ties of the plain
    logits; two calls give the same bits; the stack a beam runs at these
    rows (fused_layers_step) with the top-k kernel at k = 1, and the argmax
    kernel, give the whole step's tokens bit for bit; the window poison."""
    from vct_tpu_torch.ops import decode_kernels as dk

    check_small_plans(fw, heads)
    st = fw["stacked"]
    e, f, v = st["wqkv"].shape[1], st["w1"].shape[-1], fw["wg"].shape[1]
    gargs = (fw["norm_s"], fw["norm_b"], fw["wg"], fw["bg"])
    worst = 0.0
    for b in SMALL_BATCHES:
        plan = dk.whole_step_plan(b, e, heads, f, v, st["wqkv"].dtype)
        if plan.route != 1:
            fail(f"fused_whole_step B={b}: the plan takes route {plan.route} ({plan.why})")
        for idx, l_view in ((12, 16), (29, 32)):
            a = step_inputs(fw, b, idx, tm, gen=7500 + b + idx)
            args = (a["x"], None, None, a["ck"], a["cv"], a["mem_bias"], fw, idx)
            runs = {}
            for label, route in (("kernel", -1), ("again", -1), ("replaced", 0)):
                kc, vc = a["kc"].clone(), a["vc"].clone()
                tok = dk._launch_whole_step(args[0], kc, vc, *args[3:], heads=heads,
                                            l_view=l_view, _route=route)
                runs[label] = (tok, kc[:, idx], vc[:, idx])
            kc, vc = a["kc"].clone(), a["vc"].clone()
            x_ref = dk._stack_reference(a["x"], kc, vc, a["ck"], a["cv"], a["mem_bias"], st, idx,
                                        heads, l_view)
            logits = plain_logits(dk, x_ref, fw)
            runs["plain"] = (torch.argmax(logits, -1).to(torch.int32), kc[:, idx], vc[:, idx])
            kc, vc = a["kc"].clone(), a["vc"].clone()
            xs, _, _ = dk.fused_layers_step(a["x"], kc, vc, a["ck"], a["cv"], a["mem_bias"], st,
                                           idx, heads=heads, l_view=l_view)
            top1 = dk.fused_norm_generator_topk(xs, *gargs, k=1)[1][:, 0]
            arg = dk.fused_norm_generator_argmax(xs, *gargs)
            torch.cuda.synchronize()
            name = f"fused_whole_step small-row route B={b} idx={idx} l_view={l_view}"
            if not all(torch.equal(p, q) for p, q in zip(runs["kernel"], runs["again"])):
                fail(f"{name}: two calls gave different bits")
            if not (torch.equal(top1, runs["kernel"][0]) and torch.equal(arg, runs["kernel"][0])
                    and torch.equal(kc[:, idx], runs["kernel"][1])):
                fail(f"{name}: the stack at these rows with the top-k (k=1) or argmax kernel "
                     f"gives other tokens or cache rows than the whole step")
            for ref in ("plain", "replaced"):
                worst = max(worst, token_err(f"{name} against the {ref}", runs["kernel"][0],
                                             runs[ref][0], logits, NEAR_TIE_SAME))
                for part, got, want in zip(("k rows", "v rows"), runs["kernel"][1:],
                                           runs[ref][1:]):
                    err = compare_float(f"{name} {part} against the {ref}", got, want, means)
                    if ref == "plain":
                        worst = max(worst, err)
            say(f"  ok {name}: against the plain version and the replaced kernel; same bits "
                f"twice; the beam's stack + top-k at k=1 and the argmax give its tokens")
        a = step_inputs(fw, b, 16, tm, gen=7600 + b)
        tok = dk.fused_whole_step(a["x"], a["kc"], a["vc"], a["ck"], a["cv"], a["mem_bias"], fw,
                                  16, heads=heads, l_view=16)[0]
        torch.cuda.synchronize()
        if not bool((tok == -1).all()) or float(a["kc"][:, 16].float().abs().max()) == 0.0:
            fail(f"fused_whole_step small-row route B={b}: the window poison did not fire "
                 f"(or the row was not written)")
    return worst


def step_bound(fw, a, b, l_view, gen: bool):
    """Bound of one decode step: every weight, the attended cache rows, the
    cross K/V and the activations once; 2 operations per weight and row."""
    st = fw["stacked"]
    mats = [st[k] for k in ("wqkv", "wo", "wcq", "wco", "w1", "w2")]
    tensors = list(st.values()) + [a["x"], a["kc"][:, :l_view], a["vc"][:, :l_view],
                                   a["ck"], a["cv"], a["mem_bias"]]
    if gen:
        mats.append(fw["wg"])
        tensors += [fw["wg"], fw["bg"], fw["norm_s"], fw["norm_b"]]
    ops = 2.0 * b * sum(m.numel() for m in mats)
    return bound_ms(nbytes(*tensors) + nbytes(a["x"]), ops, a["x"].dtype)


def time_kernels(fw, heads, tm):
    """name -> {ms, plain_ms, bound_ms, bound_by, library_ms} of the decode
    kernels at the shapes the serving path gives them."""
    import torch.nn.functional as F

    from vct_tpu_torch.ops import decode_kernels as dk

    out = {}
    # the whole step (the small-row kernel) and decode_step_kernel, which it
    # replaced in bfloat16, by graph replay in turns (kernel, replaced,
    # replaced, kernel) at B=32 (the serving batch), B=1 and B=64 (its top)
    row = {"timer": "graph_replay", "library_ms": None}
    for b in (32, 1, 64):
        a = step_inputs(fw, b, 12, tm, gen=4000 if b == 32 else 4010 + b)
        args = (a["x"], a["kc"], a["vc"], a["ck"], a["cv"], a["mem_bias"], fw)
        fns = {"kernel": lambda: dk.fused_whole_step(*args, 12, heads=heads, l_view=16),
               "previous": lambda: dk._launch_whole_step(*args, 12, heads=heads, l_view=16,
                                                         _route=0)}
        t = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for which in order:
                t[which].append(device_time(fns[which]))
        bnd = step_bound(fw, a, b, 16, True)
        sfx = "" if b == 32 else f"_b{b}"
        row.update({f"ms{sfx}": min(t["kernel"]), f"previous_same_run_ms{sfx}": min(t["previous"]),
                    f"bound_ms{sfx}": bnd[0], f"bound_by{sfx}": bnd[1]})
        if b == 32:
            row["eager_ms"] = cuda_time(fns["kernel"])
            row["plain_ms"] = cuda_time(lambda: dk.fused_whole_step_reference(
                *args, 12, heads=heads, l_view=16))
    out["fused_whole_step"] = row
    say(f"  fused_whole_step [small-row kernel, graph replay]: B=32 {row['ms']:.4f} ms (replaced "
        f"kernel {row['previous_same_run_ms']:.4f}, recorded earlier by cuda_time "
        f"{RECORDED_PREVIOUS_MS['fused_whole_step']:.4f}; host loop {row['eager_ms']:.4f}; bound "
        f"{row['bound_ms']:.4f}), B=1 {row['ms_b1']:.4f} (replaced "
        f"{row['previous_same_run_ms_b1']:.4f}), B=64 {row['ms_b64']:.4f} (replaced "
        f"{row['previous_same_run_ms_b64']:.4f})")
    # the stack kernel and decode_step_kernel, which it replaced in bfloat16,
    # by graph replay in turns (kernel, replaced, replaced, kernel) at B=128
    # (greedy decode past 64) and 256 beam rows (eval batch 64 at beam 4)
    row = {"timer": "graph_replay", "library_ms": None}
    for b in (128, BEAM_ROWS):
        a = step_inputs(fw, b, 12, tm, gen=4001 if b == 128 else 4003)
        args = (a["x"], a["kc"], a["vc"], a["ck"], a["cv"], a["mem_bias"], fw["stacked"])
        fns = {"kernel": lambda: dk.fused_layers_step(*args, 12, heads=heads, l_view=16),
               "previous": lambda: dk._launch_layers_step(*args, 12, heads=heads, l_view=16,
                                                          _route=0)}
        t = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for which in order:
                t[which].append(device_time(fns[which]))
        bnd = step_bound(fw, a, b, 16, False)
        sfx = "" if b == 128 else f"_b{b}"
        row.update({f"ms{sfx}": min(t["kernel"]), f"previous_same_run_ms{sfx}": min(t["previous"]),
                    f"bound_ms{sfx}": bnd[0], f"bound_by{sfx}": bnd[1]})
        if b == 128:
            row["eager_ms"] = cuda_time(fns["kernel"])
            row["plain_ms"] = cuda_time(lambda: dk.fused_layers_step_reference(
                *args, 12, heads=heads, l_view=16))
            x = a["x"]
    # at 1-64 rows the stack is the small-row kernel (route 2), taken for its
    # summation order (a beam of 1 sums as greedy decode); beside it
    # decode_step_kernel, which it replaced there, and stack_step_kernel
    # forced to these rows (route 1)
    for b in (1, 32, 64):
        a = step_inputs(fw, b, 12, tm, gen=4020 + b)
        args = (a["x"], a["kc"], a["vc"], a["ck"], a["cv"], a["mem_bias"], fw["stacked"])
        for key, route in (("ms", -1), ("previous_same_run_ms", 0), ("stack_step_kernel_ms", 1)):
            row[f"{key}_b{b}"] = device_time(lambda: dk._launch_layers_step(
                *args, 12, heads=heads, l_view=16, _route=route))
        bnd = step_bound(fw, a, b, 16, False)
        row[f"bound_ms_b{b}"], row[f"bound_by_b{b}"] = bnd
    out["fused_layers_step"] = row
    say("  fused_layers_step at 1-64 rows [small-row kernel, graph replay]: "
        + ", ".join(f"B={b} {row[f'ms_b{b}']:.4f} ms (replaced kernel "
                    f"{row[f'previous_same_run_ms_b{b}']:.4f}, stack_step_kernel "
                    f"{row[f'stack_step_kernel_ms_b{b}']:.4f})" for b in (1, 32, 64)))
    rec = RECORDED_PREVIOUS_MS["fused_layers_step"]
    say(f"  fused_layers_step [stack kernel, graph replay]: B=128 {row['ms']:.4f} ms (replaced "
        f"kernel {row['previous_same_run_ms']:.4f}, recorded earlier by cuda_time "
        f"{rec['b128']:.4f}; host loop {row['eager_ms']:.4f}; bound {row['bound_ms']:.4f}), "
        f"{BEAM_ROWS} rows {row[f'ms_b{BEAM_ROWS}']:.4f} ms (replaced kernel "
        f"{row[f'previous_same_run_ms_b{BEAM_ROWS}']:.4f}, recorded earlier {rec['b256']:.4f}; "
        f"bound {row[f'bound_ms_b{BEAM_ROWS}']:.4f})")
    gargs = (x, fw["norm_s"], fw["norm_b"], fw["wg"], fw["bg"])
    bg_dt = fw["bg"].to(x.dtype)

    def library_argmax(wg=fw["wg"]):  # layer_norm -> product on the bf16 weights -> argmax
        yn = F.layer_norm(x.float(), (x.shape[1],), fw["norm_s"], fw["norm_b"], 1e-5)
        return torch.argmax(torch.addmm(bg_dt, yn.to(x.dtype), wg), dim=-1)

    bnd = bound_ms(nbytes(*gargs) + 4 * x.shape[0], 2.0 * x.shape[0] * fw["wg"].numel(),
                   x.dtype)
    # device times (CUDA graph replay): the kernel, the CUDA-core kernel it
    # replaced on the same inputs, and the library route, which rounds yn to
    # bfloat16 once and so does less than the kernel
    t = {"kernel": [], "previous": [], "library": []}
    for _ in range(2):  # kernel, previous, library, library, previous, kernel
        order = list(t) if not t["kernel"] else list(t)[::-1]
        for which in order:
            t[which].append(device_time(
                {"kernel": lambda: dk.fused_norm_generator_argmax(*gargs),
                 "previous": lambda: dk._launch_gen_argmax(*gargs, _route=0),
                 "library": library_argmax}[which]))
    # two copies of the weight in turn: each call streams its 47 MB from HBM
    turn = itertools.cycle((fw["wg"], fw["wg"].clone()))
    out["fused_norm_generator_argmax"] = {
        "timer": "graph_replay",
        "ms": min(t["kernel"]),
        "cold_weight_ms": device_time(
            lambda: dk.fused_norm_generator_argmax(*gargs[:3], next(turn), gargs[4])),
        "eager_ms": cuda_time(lambda: dk.fused_norm_generator_argmax(*gargs)),
        "previous_same_run_ms": min(t["previous"]),
        "plain_ms": cuda_time(lambda: dk.fused_norm_generator_argmax_reference(*gargs)),
        "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": min(t["library"]),
        "library_cold_weight_ms": device_time(lambda: library_argmax(next(turn))),
        "library_eager_ms": cuda_time(library_argmax)}
    del turn
    for b in (65, 256):
        xb = step_inputs(fw, b, 12, tm, gen=4002 + b)["x"]
        bargs = (xb,) + gargs[1:]
        out["fused_norm_generator_argmax"][f"ms_b{b}"] = device_time(
            lambda: dk.fused_norm_generator_argmax(*bargs))
        out["fused_norm_generator_argmax"][f"previous_same_run_ms_b{b}"] = device_time(
            lambda: dk._launch_gen_argmax(*bargs, _route=0))
    return out


# ---------------------------------------------------------------------------
# phases 4-5: the server and the B=128 decode against the module path
# ---------------------------------------------------------------------------


def check_against_module(model, feats, masks, got, what, near_tie=NEAR_TIE_MODULE):
    from vct_tpu_torch.decode import first_mismatch_gaps, greedy_generate

    want, _ = greedy_generate(model, feats, masks, max_len=got.shape[1],
                              start_id=101, end_id=102)
    mism = first_mismatch_gaps(model, feats, masks, got, want)
    for row, pos, gap in mism:
        if gap >= near_tie:
            fail(f"{what}: row {row} parts from the module path at position {pos} "
                 f"with top-2 gap {gap} >= {near_tie}")
    say(f"  {what}: {len(got) - len(mism)}/{len(got)} rows equal to the module path, "
        f"{len(mism)} part at near-ties (max gap "
        f"{max([g for _, _, g in mism], default=0.0):.4g})")


def request_body(i, rng):
    t = (12, 12, 8, 5, 20, 3)[i % 6]  # < 12 frames pads the memory; 20 subsamples
    arr = rng.standard_normal((t, 512)).astype(np.float32)
    buf = io.BytesIO()
    if i % 4 == 3:
        np.savez(buf, CLIP4Clip=arr)
    else:
        np.save(buf, arr)
    return buf.getvalue()


def run_server(cfg, ckpt, model):
    from vct_tpu_torch.ops import decode_kernels as dk
    from vct_tpu_torch.serve import serve

    srv = serve(cfg, str(ckpt), device=torch.device("cuda", 0), host="127.0.0.1", port=0,
                max_batch=MAX_BATCH, batch_timeout_ms=20.0, log=say)
    records = []
    decode = srv.service.decode_fn

    def recording_decode(feats, masks):
        tokens, attn = decode(feats, masks)
        records.append((feats, masks, tokens))
        return tokens, attn

    srv.service.decode_fn = recording_decode
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]
    rng = np.random.default_rng(SEED)
    bodies = [request_body(i, rng) for i in range(N_REQUESTS)]
    results = [None] * N_REQUESTS

    def post(i):
        conn = HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("POST", "/v1/caption", body=bodies[i])
        resp = conn.getresponse()
        results[i] = (resp.status, json.loads(resp.read()))
        conn.close()

    with no_plain_on_cuda("server", dk):
        try:
            conn = HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("GET", "/healthz")
            health = json.loads(conn.getresponse().read())
            conn.close()
            if health.get("status") != "ok":
                fail(f"/healthz: {health}")
            for fn in dk.WRAPPERS:
                fn.launches = 0
            t0 = time.perf_counter()
            threads = [threading.Thread(target=post, args=(i,)) for i in range(N_REQUESTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            elapsed = time.perf_counter() - t0
            launches = dk.fused_whole_step.launches
        finally:
            srv.shutdown()
            srv.server_close()
            srv.service.close()
            thread.join(timeout=30)
    if any(t.is_alive() for t in threads):
        fail("server: clients still waiting")
    bad = [r for r in results if r is None or r[0] != 200
           or not isinstance(r[1].get("caption"), str)]
    if bad:
        fail(f"server: {len(bad)} requests failed, e.g. {bad[0]}")
    if launches == 0:
        fail("server: fused_whole_step was never launched")
    say(f"  {N_REQUESTS} requests answered 200 in {len(records)} batches, "
        f"fused_whole_step launches {launches}")
    for feats, masks, tokens in records:
        check_against_module(model, feats, masks, tokens, "served batch")
    return launches, N_REQUESTS / elapsed, elapsed


def run_b128(model, fw):
    """The two-kernel path (B > 64) through greedy_generate_fused ->
    launches of its two kernels, counted from 0."""
    from vct_tpu_torch.decode_fast import greedy_generate_fused
    from vct_tpu_torch.ops import decode_kernels as dk

    dev = fw["wg"].device
    g = torch.Generator().manual_seed(SEED + 1)
    feats = [torch.randn((128, 12, 512), generator=g).to(dev)]
    masks = torch.zeros((128, 12), dtype=torch.bool)
    masks[::3, 7:] = True
    masks = [masks.to(dev)]
    for fn in dk.WRAPPERS:
        fn.launches = 0
    got, _ = greedy_generate_fused(model, feats, masks, max_len=30, start_id=101,
                                   end_id=102, fw=fw)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in dk.WRAPPERS}
    for name in ("fused_layers_step", "fused_norm_generator_argmax"):
        if launches[name] == 0:
            fail(f"b128: {name} was never launched")
    if launches["fused_whole_step"]:
        fail("b128: the whole-step kernel ran above B=64")
    say(f"  launches {launches}")
    check_against_module(model, feats, masks, got, "B=128 decode")
    return launches


def time_decode(model, fw, card):
    """ms per token of the kernel path and the module path, 29 tokens with
    the encoder included, host clock around synchronised runs."""
    from vct_tpu_torch.decode import greedy_generate
    from vct_tpu_torch.decode_fast import greedy_generate_fused

    dev = fw["wg"].device
    report = {}
    for b in (1, 32, 128):
        g = torch.Generator().manual_seed(SEED + b)
        feats = [torch.randn((b, 12, 512), generator=g).to(dev)]
        masks = [torch.zeros((b, 12), dtype=torch.bool, device=dev)]
        for label, fn in (
                ("kernel", lambda: greedy_generate_fused(
                    model, feats, masks, max_len=30, start_id=101, end_id=-1, fw=fw)),
                ("plain", lambda: greedy_generate(
                    model, feats, masks, max_len=30, start_id=101, end_id=-1))):
            fn()
            torch.cuda.synchronize()
            reps = 3
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1000 / reps / 29
            report[f"ms_per_token_{label}_b{b}"] = ms
            path = "kernel path" if label == "kernel" else "plain path (module)"
            say(f"  B={b} {path}: {ms:.3f} ms/token [{card}]")
    return report


# ---------------------------------------------------------------------------
# phases 8-10: the eval slice's kernels, the eval CLI, several tokens a launch
# ---------------------------------------------------------------------------


def reset_launches():
    from vct_tpu_torch.ops import decode_kernels as dk

    for fn in dk.WRAPPERS:
        fn.launches = 0


def read_launches():
    from vct_tpu_torch.ops import decode_kernels as dk

    return {fn.__name__: fn.launches for fn in dk.WRAPPERS}


def decoder_like(fw, heads, tm, b, seed):
    """Activations [b, E] as the generator sees them: seeded step inputs
    through the plain stack."""
    from vct_tpu_torch.ops import decode_kernels as dk

    a = step_inputs(fw, b, 9, tm, gen=seed)
    x, _, _ = dk.fused_layers_step_reference(a["x"], a["kc"], a["vc"], a["ck"], a["cv"],
                                             a["mem_bias"], fw["stacked"], 9, heads=heads,
                                             l_view=16)
    return x


def check_topk(fw, heads, tm):
    """fused_norm_generator_topk at the beam rows of one eval batch."""
    from vct_tpu_torch.ops import decode_kernels as dk

    x = decoder_like(fw, heads, tm, BEAM_ROWS, 5000)
    args = (x, fw["norm_s"], fw["norm_b"], fw["wg"], fw["bg"])
    got = dk.fused_norm_generator_topk(*args, k=BEAM_K)
    again = dk.fused_norm_generator_topk(*args, k=BEAM_K)
    want = dk.fused_norm_generator_topk_reference(*args, k=BEAM_K)
    torch.cuda.synchronize()
    name = f"fused_norm_generator_topk B={BEAM_ROWS} k={BEAM_K}"
    err = max(max_err(name + " values", got[0], want[0], TOPK_ATOL),
              max_err(name + " lse", got[2], want[2], TOPK_ATOL))
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        fail(f"{name}: two runs on the same inputs gave different bits")
    logits = plain_logits(dk, x, fw)
    differ = got[1] != want[1]
    gap = (torch.gather(logits, 1, want[1].long())
           - torch.gather(logits, 1, got[1].long())).abs()
    if bool(differ.any()):
        worst = float(gap[differ].max())
        if worst >= NEAR_TIE_SAME:
            fail(f"{name}: ids differ where the plain logits are {worst} apart "
                 f"(limit {NEAR_TIE_SAME})")
        say(f"  {name}: {int(differ.sum())}/{differ.numel()} ids differ, all near-ties")
    if int(got[1].max()) >= fw["vocab"] or int(got[1].min()) < 0:
        fail(f"{name}: an id outside the vocab")
    say(f"  ok {name}: values and lse within {TOPK_ATOL}, same bits from run to run")
    # four columns in four column blocks share one weight column and lead the
    # vocab: the ids must come out in ascending order with equal values
    cols = [20, 300, 9000, 30000]
    wg, bg = fw["wg"].clone(), fw["bg"].clone()
    for c in cols[1:]:
        wg[:, c] = wg[:, cols[0]]
    bg[cols] = 1e3
    v, i, _ = dk.fused_norm_generator_topk(x, fw["norm_s"], fw["norm_b"], wg, bg, k=BEAM_K)
    torch.cuda.synchronize()
    if i.cpu().tolist() != [cols] * BEAM_ROWS or not bool((v == v[:, :1]).all()):
        fail(f"{name}: tied columns {cols} came out as {i[0].tolist()} with values "
             f"{v[0].tolist()}")
    say(f"  ok {name}: ties across column blocks go to the lowest id")
    # the widest k the kernel carries, on 64 rows
    kmax = dk.TOPK_MAX
    args = (x[:64].contiguous(),) + args[1:]
    got = dk.fused_norm_generator_topk(*args, k=kmax)
    want = dk.fused_norm_generator_topk_reference(*args, k=kmax)
    torch.cuda.synchronize()
    name = f"fused_norm_generator_topk B=64 k={kmax}"
    err = max(err, max_err(name + " values", got[0], want[0], TOPK_ATOL),
              max_err(name + " lse", got[2], want[2], TOPK_ATOL))
    differ = got[1] != want[1]
    gap = (torch.gather(logits[:64], 1, want[1].long())
           - torch.gather(logits[:64], 1, got[1].long())).abs()
    if bool(differ.any()) and float(gap[differ].max()) >= NEAR_TIE_SAME:
        fail(f"{name}: ids differ where the plain logits are {float(gap[differ].max())} "
             f"apart (limit {NEAR_TIE_SAME})")
    say(f"  ok {name}: values and lse within {TOPK_ATOL}, {int(differ.sum())} ids differ "
        f"at near-ties")
    return max(err, check_topk_routes(fw, x, logits))


def check_topk_routes(fw, x, logits):
    """The tensor-core route (the wrapper's, bf16) at B=1, 65, 128, 200, 256
    and k=1, 4, 32 on a ragged vocab (30528 columns: a last slab of 64)
    against the plain version and the replaced kernel (route 0); ties across
    slabs -> the largest values difference."""
    from vct_tpu_torch.ops import decode_kernels as dk

    v = -(-fw["vocab"] // 8) * 8
    if v % 256 == 0:
        fail(f"check_topk_routes: vocab {v} is a whole number of slabs, not ragged")
    wg, bg = fw["wg"][:, :v].contiguous(), fw["bg"][:v].contiguous()
    err = 0.0
    for b in ARGMAX_BATCHES:
        if dk.gen_topk_plan(b, x.shape[1], v, 4, wg.dtype).route != 1:
            fail(f"top-k: the plan for B={b} is not the tensor-core route")
        for k in (1, BEAM_K, dk.TOPK_MAX):
            args = (x[:b].contiguous(), fw["norm_s"], fw["norm_b"], wg, bg)
            got = dk.fused_norm_generator_topk(*args, k=k)
            again = dk.fused_norm_generator_topk(*args, k=k)
            old = dk._launch_gen_topk(*args, k, _route=0)
            want = dk.fused_norm_generator_topk_reference(*args, k=k)
            torch.cuda.synchronize()
            name = f"fused_norm_generator_topk B={b} k={k} V={v}"
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                fail(f"{name}: two runs on the same inputs gave different bits")
            for label, ref in (("plain version", want), ("replaced kernel", old)):
                err = max(err, max_err(f"{name} values against the {label}", got[0], ref[0],
                                       TOPK_ATOL),
                          max_err(f"{name} lse against the {label}", got[2], ref[2], TOPK_ATOL))
                differ = got[1] != ref[1]
                gap = (torch.gather(logits[:b, :v], 1, ref[1].long())
                       - torch.gather(logits[:b, :v], 1, got[1].long())).abs()
                if bool(differ.any()) and float(gap[differ].max()) >= NEAR_TIE_SAME:
                    fail(f"{name}: ids differ from the {label} where the plain logits are "
                         f"{float(gap[differ].max())} apart (limit {NEAR_TIE_SAME})")
            if int(got[1].max()) >= fw["vocab"] or int(got[1].min()) < 0:
                fail(f"{name}: an id outside the vocab")
    # one weight column at both sides of a slab boundary and in the ragged last slab
    cols = [255, 256, 9000, v - 10]
    wt, bt = wg.clone(), bg.clone()
    for c in cols[1:]:
        wt[:, c] = wt[:, cols[0]]
    bt[cols] = 1e3
    vals, ids, _ = dk.fused_norm_generator_topk(x[:65].contiguous(), fw["norm_s"], fw["norm_b"],
                                                wt, bt, k=BEAM_K)
    torch.cuda.synchronize()
    if ids.cpu().tolist() != [cols] * 65 or not bool((vals == vals[:, :1]).all()):
        fail(f"top-k tensor-core route: tied columns {cols} came out as {ids[0].tolist()}")
    say(f"  ok the tensor-core top-k at B={ARGMAX_BATCHES}, k=1, {BEAM_K}, {dk.TOPK_MAX}, V={v}: "
        f"against the plain version and the replaced kernel, same bits twice, ties across "
        f"slabs; max values/lse difference {err:.3g}")
    return err


def check_layer_step(fw, heads, tm):
    """fused_layer_step on layer 1's un-stacked weights, the stack's launch at
    NL = 1: at B=32 (the small-row kernel, route 2) at idx 0, 11 and 31, and
    at B = 1 and 64 (route 2), 65 and 256 (stack_step_kernel, route 1) at idx
    12: x_out and the fresh cache rows against the plain version and against
    decode_step_kernel (route 0), which it replaced; the same bits twice; the
    bits of fused_layers_step at NL = 1 on the same layer; an idx past the
    cache refused on every route."""
    from vct_tpu_torch.ops import decode_kernels as dk

    err, means = 0.0, []
    st = fw["stacked"]
    e, f, dt = st["wqkv"].shape[1], st["w1"].shape[-1], st["wqkv"].dtype
    w1 = {k: v[1] for k, v in st.items()}
    one = {k: v[1:2] for k, v in st.items()}   # the same layer as a stack of one
    for b, idx, with_bias in ((32, 0, True), (32, 11, False), (32, 31, True), (1, 12, True),
                              (64, 12, False), (65, 12, True), (256, 12, True)):
        route = dk.stack_step_plan(b, e, heads, f, dt).route
        if route != (2 if b <= dk.SMALL_MAX_ROWS else 1):
            fail(f"fused_layer_step B={b}: the plan takes route {route}")
        a = step_inputs(fw, b, idx, tm, gen=6000 + idx + (0 if b == 32 else b))
        mb = a["mem_bias"] if with_bias else None
        x, ck, cv = a["x"], a["ck"][1], a["cv"][1]
        runs = {}
        for label, fn in (
                ("kernel", lambda k, v: dk.fused_layer_step(x, k, v, ck, cv, mb, w1, idx,
                                                            heads=heads)[0]),
                ("again", lambda k, v: dk.fused_layer_step(x, k, v, ck, cv, mb, w1, idx,
                                                           heads=heads)[0]),
                ("replaced", lambda k, v: dk._launch_layer_step(x, k, v, ck, cv, mb, w1, idx,
                                                                heads=heads, _route=0)),
                ("plain", lambda k, v: dk.fused_layer_step_reference(x, k, v, ck, cv, mb, w1,
                                                                     idx, heads=heads)[0]),
                ("stack", lambda k, v: dk.fused_layers_step(
                    x, k[None], v[None], ck[None], cv[None], mb, one, idx, heads=heads)[0])):
            k, v = a["kc"][1].clone(), a["vc"][1].clone()
            runs[label] = (fn(k, v), k[idx], v[idx])
        torch.cuda.synchronize()
        name = f"fused_layer_step route {route} B={b} idx={idx} bias={with_bias}"
        if not all(torch.equal(p, q) for p, q in zip(runs["kernel"], runs["again"])):
            fail(f"{name}: two calls gave different bits")
        if not all(torch.equal(p, q) for p, q in zip(runs["kernel"], runs["stack"])):
            fail(f"{name}: other bits than fused_layers_step at NL = 1")
        for ref in ("plain", "replaced"):
            for part, got, want in zip(("x_out", "k row", "v row"), runs["kernel"], runs[ref]):
                d = compare_float(f"{name} {part} against the {ref}", got, want, means)
                if ref == "plain":
                    err = max(err, d)
        say(f"  ok {name}: against the plain version and the replaced kernel; same bits twice; "
            f"the stack's bits at NL = 1")
    big_l = a["kc"].shape[1]
    for route in (-1, 0, 1, 2):
        try:
            dk._launch_layer_step(a["x"], a["kc"][1].clone(), a["vc"][1].clone(), a["ck"][1],
                                  a["cv"][1], None, w1, big_l, heads=heads, _route=route)
        except ValueError:
            continue
        fail(f"fused_layer_step route {route}: idx {big_l} past the cache was not refused")
    say(f"  ok fused_layer_step: idx {big_l}, past the cache, refused on every route")
    return err


def check_multi_step(fw, heads, tm):
    """fused_multi_step at B = 1, 7, 32 and 64 (the small-row kernel), u=2
    and 4, four windows each: every window's chain and cache rows against the
    plain version one token at a time, and against decode_multi_kernel (the
    replaced kernel, route 0) up to near-ties; the same window twice gives
    the same bits; fused_whole_step one token at a time along the kernel's
    chain gives the same tokens and rows bit for bit; then the window poison
    on both routes. Each window starts from the plain version's state, so a
    near-tie does not travel."""
    from vct_tpu_torch.ops import decode_kernels as dk

    err, means = 0.0, []
    emb, pe = fw["emb"], fw["pe"]
    for b in SMALL_BATCHES:
        a = step_inputs(fw, b, 0, tm, gen=7000 + b)
        ck, cv, mb = a["ck"], a["cv"], a["mem_bias"]
        start = torch.full((b,), 101, dtype=torch.int32, device=ck.device)
        start[0] = 0  # a pad token embeds to zero
        e, f, v = ck.shape[3], fw["stacked"]["w1"].shape[-1], fw["wg"].shape[1]
        if dk.multi_step_plan(b, e, heads, f, v, ck.dtype).route != 1:
            fail(f"fused_multi_step B={b}: the plan keeps the replaced kernel")
        for u in (2, 4):
            ks_r, vs_r = torch.zeros_like(a["kc"]), torch.zeros_like(a["kc"])
            cur = start
            for w in range(4):
                l_view = (((w + 1) * u + 7) // 8) * 8
                runs = {}
                for label, route in (("kernel", -1), ("again", -1), ("replaced", 0)):
                    ks, vs = ks_r.clone(), vs_r.clone()
                    tok = torch.empty((b, u), dtype=torch.int32, device=ck.device)
                    dk._launch_multi(cur, ks, vs, ck, cv, mb, emb, pe, fw, heads=heads,
                                     l_view=l_view, i0=w * u, n_tok=u, seq=False, poison=False,
                                     tok_out=tok, start_id=0, end_id=-1, pad_id=0, route=route)
                    runs[label] = (tok, ks, vs)
                # the per-token whole step along the kernel's chain
                ks_w, vs_w = ks_r.clone(), vs_r.clone()
                c, chain = cur, []
                for j in range(u):
                    x = dk._embed_step(emb, pe, c, w * u + j, 0)
                    c = dk.fused_whole_step(x, ks_w, vs_w, ck, cv, mb, fw, w * u + j, heads=heads,
                                            l_view=l_view)[0]
                    chain.append(c)
                    c = runs["kernel"][0][:, j].contiguous()
                torch.cuda.synchronize()
                name = f"fused_multi_step B={b} u={u} window {w}"
                t_k = runs["kernel"][0]
                if not all(torch.equal(p, q) for p, q in zip(runs["kernel"], runs["again"])):
                    fail(f"{name}: two calls gave different bits")
                if not (torch.equal(torch.stack(chain, 1), t_k)
                        and torch.equal(ks_w, runs["kernel"][1])
                        and torch.equal(vs_w, runs["kernel"][2])):
                    fail(f"{name}: the per-token whole step gives other tokens or rows")
                cur_r = cur
                ok = torch.ones((b,), dtype=torch.bool, device=ck.device)  # chains agree so far
                ok_old = ok.clone()
                for j in range(u):
                    pos = w * u + j
                    x = dk._embed_step(emb, pe, cur_r, pos, 0)
                    xs = dk._stack_reference(x, ks_r, vs_r, ck, cv, mb, fw["stacked"], pos,
                                             heads, l_view)
                    logits = plain_logits(dk, xs, fw)
                    cur_r = torch.argmax(logits, dim=-1).to(torch.int32)
                    err = max(err, token_err(f"{name} token {j}", t_k[ok, j], cur_r[ok],
                                             logits[ok], NEAR_TIE_SAME))
                    token_err(f"{name} token {j} (replaced kernel)", runs["replaced"][0][ok_old, j],
                              cur_r[ok_old], logits[ok_old], NEAR_TIE_SAME)
                    ok &= t_k[:, j] == cur_r
                    ok_old &= runs["replaced"][0][:, j] == cur_r
                rows = slice(w * u, w * u + u)
                for label in ("kernel", "replaced"):
                    both = ok & ok_old
                    for part, got, want in (("k rows", runs[label][1], ks_r),
                                            ("v rows", runs[label][2], vs_r)):
                        d = compare_float(f"{name} {part} ({label})", got[:, rows][:, :, both],
                                          want[:, rows][:, :, both], means)
                        if label == "kernel":
                            err = max(err, d)
                cur = cur_r.contiguous()   # go on from the plain version's chain and rows
            say(f"  ok fused_multi_step B={b} u={u}: 4 windows against the plain version and "
                f"the replaced kernel, same bits twice, the per-token whole step bit for bit")
        for route in (-1, 0):
            tok = torch.empty((b, 4), dtype=torch.int32, device=ck.device)
            dk._launch_multi(start, torch.zeros_like(a["kc"]), torch.zeros_like(a["kc"]), ck, cv,
                             mb, emb, pe, fw, heads=heads, l_view=8, i0=8, n_tok=4, seq=False,
                             poison=True, tok_out=tok, start_id=0, end_id=-1, pad_id=0,
                             route=route)
            torch.cuda.synchronize()
            if not bool((tok == -1).all()):
                fail(f"fused_multi_step B={b} route {route}: the window poison did not fire")
    t_k, _, _ = dk.fused_multi_step(start, torch.zeros_like(a["kc"]), torch.zeros_like(a["kc"]),
                                    ck, cv, mb, emb, pe, fw, 2, heads=heads, unroll=4,
                                    pad_id=0, l_view=8)
    torch.cuda.synchronize()
    if not bool((t_k == -1).all()):
        fail("fused_multi_step: the window poison did not fire")
    say("  ok fused_multi_step window poison (tokens -1) on both routes")
    return err


def plain_chain(fw, cks, cvs, mem_bias, heads, max_len, start_id, end_id, pad_id):
    """The plain greedy loop -> (tokens [B, max_len], the plain logits' top-2
    gap at every generated position [B, max_len - 1])."""
    from vct_tpu_torch.ops import decode_kernels as dk

    nl, _, b, e = cks.shape
    ks = torch.zeros((nl, 32, b, e), dtype=cks.dtype, device=cks.device)
    vs = torch.zeros_like(ks)
    tokens = torch.full((b, max_len), pad_id, dtype=torch.int32, device=cks.device)
    tokens[:, 0] = start_id
    gaps = torch.full((b, max_len - 1), float("inf"), device=cks.device)
    done = torch.zeros((b,), dtype=torch.bool, device=cks.device)
    for i in range(max_len - 1):
        x = dk._embed_step(fw["emb"], fw["pe"], tokens[:, i], i, pad_id)
        xs = dk._stack_reference(x, ks, vs, cks, cvs, mem_bias, fw["stacked"], i, heads, 32)
        logits = plain_logits(dk, xs, fw)
        top = torch.topk(logits, 2, dim=-1).values
        gaps[:, i] = top[:, 0] - top[:, 1]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        tokens[:, i + 1] = nxt
        done |= nxt == end_id
        if bool(done.all()):
            break
    return tokens, gaps


def chain_err(name, got, want, gaps, bound):
    """Chains must agree except that a row may part where the plain logits'
    top-2 gap is under ``bound``; returns the largest such gap."""
    err = 0.0
    for r in (got != want).any(dim=1).nonzero().flatten().tolist():
        first = int((got[r] != want[r]).int().argmax())
        gap = float(gaps[r, first - 1])
        if gap >= bound:
            fail(f"{name}: row {r} parts at position {first} with top-2 gap {gap} >= {bound}")
        err = max(err, gap)
    return err


def eval_inputs(b, dev, seed):
    g = torch.Generator().manual_seed(seed)
    feats = [torch.randn((b, 12, 512), generator=g).to(dev)]
    masks = torch.zeros((b, 12), dtype=torch.bool)
    masks[1::3, 8:] = True
    return feats, [masks.to(dev)]


def check_sequence(model, fw):
    """fused_sequence_decode at B=1 and 32 (the small-row kernel by its plan):
    free running, with an end token that finishes rows early (at B=1 the
    whole batch, so the kernel leaves its loop), and with a generator biased
    to the end token (every row finishes at step 1, the pad fill after it).
    Each case bit for bit against the per-token kernel loop, the same bits
    twice, against the plain loop but at near-ties; decode_multi_kernel
    (route 0), which it replaced, against the plain loop the same way."""
    from vct_tpu_torch.decode_fast import _decode_loop, _prep_decode
    from vct_tpu_torch.ops import decode_kernels as dk

    err, heads = 0.0, fw["heads"]
    dev = fw["wg"].device
    st = fw["stacked"]
    e, f, v = st["wqkv"].shape[1], st["w1"].shape[-1], fw["wg"].shape[1]
    for b in (1, 32):
        if dk.sequence_decode_plan(b, e, heads, f, v, fw["wg"].dtype).route != 1:
            fail(f"fused_sequence_decode B={b}: the plan keeps the replaced kernel")
        feats, masks = eval_inputs(b, dev, SEED + 10 + b)
        _, cks, cvs, mem_bias = _prep_decode(model, feats, masks, 30, fw)
        kw = dict(heads=heads, max_len=30, start_id=101, pad_id=0)
        free, _ = plain_chain(fw, cks, cvs, mem_bias, heads, 30, 101, -1, 0)
        biased = dict(fw, bg=fw["bg"].clone())
        biased["bg"][102] = 1e3
        for w, end_id in ((fw, -1), (fw, int(free[0, 3])), (biased, 102)):
            name = f"fused_sequence_decode B={b} end_id={end_id}" + (
                " (biased generator)" if w is biased else "")
            want, gaps = plain_chain(w, cks, cvs, mem_bias, heads, 30, 101, end_id, 0)
            loop = _decode_loop(w, cks, cvs, mem_bias, max_len=30, start_id=101, end_id=end_id,
                                pad_id=0, single_kernel=True)
            sargs = (w["emb"], w["pe"], cks, cvs, mem_bias, w)
            got = dk.fused_sequence_decode(*sargs, end_id=end_id, **kw)
            again = dk.fused_sequence_decode(*sargs, end_id=end_id, **kw)
            old = dk._launch_sequence_decode(*sargs, end_id=end_id, _route=0, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"{name}: two calls gave different bits")
            if not torch.equal(got, loop):
                rows = (got != loop).any(1).nonzero().flatten().tolist()
                fail(f"{name}: rows {rows} differ from the per-token kernel loop")
            err = max(err, chain_err(name, got, want, gaps, NEAR_TIE_SAME))
            chain_err(f"{name} (replaced kernel)", old, want, gaps, NEAR_TIE_SAME)
            if w is biased and not (got.cpu().tolist() == old.cpu().tolist()
                                    == [[101, 102] + [0] * 28] * b):
                fail(f"{name}: every row finished at step 1, got {got[0]} and {old[0]}")
            if b == 1 and end_id == int(free[0, 3]) and not bool((want[0, 4:] == 0).all()):
                fail(f"{name}: the plain loop did not stop at the end token")
        say(f"  ok fused_sequence_decode B={b}: free running, end_id={int(free[0, 3])}, every "
            f"row finished at once; the per-token loop's bits, same bits twice, the plain "
            f"chain and the replaced kernel's but at near-ties")
    return err


def check_beam_kernels(model, fw, heads, tm):
    return {"fused_norm_generator_topk": check_topk(fw, heads, tm),
            "fused_layer_step": check_layer_step(fw, heads, tm),
            "fused_multi_step": check_multi_step(fw, heads, tm),
            "fused_sequence_decode": check_sequence(model, fw)}


def eval_config(repo: Path, root: Path, vocab: Path) -> Path:
    """The training phase's config with the eval split on the train split's
    videos: EVAL_VIDEOS videos, three eval batches of 64."""
    cfg = json.loads(train_config(repo, root, vocab, 1).read_text())
    cfg["data"]["eval"]["feat_dir"] = [str(root / "feats" / "train")]
    cfg["data"]["eval"]["annotation_path"] = str(root / "train.txt")
    path = root / "msvd_eval.json"
    path.write_text(json.dumps(cfg))
    return path


def run_eval(repo: Path, root: Path, vocab: Path, ckpt: Path, card: str):
    """vct_tpu_torch.cli.eval's main: greedy, --beam 4 and --beam 1 ->
    (launches of the --beam 4 run, report)."""
    from vct_tpu_torch.cli import eval as eval_cli
    from vct_tpu_torch.ops import decode_kernels as dk

    cfg_path = str(eval_config(repo, root, vocab))
    runs, report = {}, {}
    for label, flags in (("greedy", []), ("beam4", ["--beam", "4"]), ("beam1", ["--beam", "1"])):
        out, metrics = root / f"pred_{label}.json", root / f"metrics_{label}.json"
        reset_launches()
        t0 = time.perf_counter()
        with no_plain_on_cuda(f"eval {label}", dk):
            scores = eval_cli.main(["-c", cfg_path, "-m", str(ckpt), "--out", str(out),
                                    "--metrics_out", str(metrics)] + flags)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        preds = json.loads(out.read_text())
        record = json.loads(metrics.read_text())
        record.pop("_meteor_synonyms")
        if len(preds) != EVAL_VIDEOS or not all(isinstance(c, str) for c in preds.values()):
            fail(f"eval {label}: {len(preds)} predictions for {EVAL_VIDEOS} videos")
        if set(record) < {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr"} or \
                not all(math.isfinite(v) for v in record.values()) or \
                record != {k: float(v) for k, v in scores.items()}:
            fail(f"eval {label}: scores {record}")
        runs[label] = (preds, launches)
        report[f"eval_{label}_seconds"] = seconds
        say(f"  eval {label}: {EVAL_VIDEOS} videos in {seconds:.2f} s with loading and "
            f"scoring, {len(set(preds.values()))} distinct captions, CIDEr "
            f"{record['CIDEr']:.4f}, launches "
            f"{ {k: v for k, v in launches.items() if v} } [{card}]")
    g, b4, b1 = (runs[k][1] for k in ("greedy", "beam4", "beam1"))
    if g["fused_whole_step"] == 0 or g["fused_norm_generator_topk"]:
        fail(f"eval greedy: launches {g}")
    n_batches = -(-EVAL_VIDEOS // BATCH)
    for label, l in (("beam4", b4), ("beam1", b1)):
        steps = l["fused_norm_generator_topk"]
        if steps != l["fused_layers_step"] or not n_batches <= steps <= 29 * n_batches \
                or l["fused_whole_step"] or l["fused_norm_generator_argmax"]:
            fail(f"eval {label}: expected one fused_layers_step and one "
                 f"fused_norm_generator_topk launch per beam token, got {l}")
    if runs["beam1"][0] != runs["greedy"][0]:
        bad = [v for v in runs["greedy"][0] if runs["beam1"][0][v] != runs["greedy"][0][v]]
        fail(f"eval: --beam 1 differs from greedy for {len(bad)} videos, e.g. {bad[0]}")
    say("  ok --beam 1 predicts what greedy predicts")
    return b4, report


def module_score(model, feats, masks, tokens, end_id, length_penalty=0.6):
    """The module path's length-normalised log-probability of ``tokens``,
    teacher-forced, counted as beam search counts it (up to and with the
    first end token)."""
    memory, mem_mask, _ = model.encode(feats, masks)
    b, max_len = tokens.shape
    caches = model.init_cache(b, max_len, memory)
    total = torch.zeros((b,), device=tokens.device)
    lengths = torch.ones((b,), device=tokens.device)
    alive = torch.ones((b,), dtype=torch.bool, device=tokens.device)
    for i in range(max_len - 1):
        logits, caches, _ = model.decode_step(tokens[:, i], caches, i, mem_mask)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nxt = tokens[:, i + 1].long()
        total += torch.where(alive, logp.gather(1, nxt[:, None])[:, 0], 0.0)
        lengths += alive
        alive &= nxt != end_id
    return total / lengths.pow(length_penalty).clamp(min=1.0)


class beam_trace:
    """While active, records every step of a beam search (``decode.
    beam_generate`` or ``decode_fast._beam_loop``) in ``steps``: the k best
    candidate scores of every video, sorted, the selection (beam_idx [B, K],
    tok_idx [B, K]) and, for a reference run, ``value_of(video, beam, token)``:
    this run's score of any candidate, selected or not. The module path is
    such a reference (it forms all K*V candidates). With ``plain=True`` the
    kernel beam loop runs on the plain versions of its two kernels instead
    (called directly, so CUDA tensors do not launch anything) and keeps each
    step's whole log-softmax for ``value_of``."""

    def __init__(self, plain=False, pad_id=0):
        self.plain, self.pad_id, self.steps = plain, pad_id, []
        self.top = self.cand = self.logp = self.entering = self.leaving = None

    def __enter__(self):
        import vct_tpu_torch.decode as dec
        import vct_tpu_torch.decode_fast as df
        from vct_tpu_torch.ops import decode_kernels as dk

        self.saved = [(dec, "topk_first_win", dec.topk_first_win),
                      (df, "topk_first_win", df.topk_first_win),
                      (dec, "beam_advance", dec.beam_advance),
                      (df, "fused_layers_step", df.fused_layers_step),
                      (df, "fused_norm_generator_topk", df.fused_norm_generator_topk)]
        real_topk, real_advance = dec.topk_first_win, dec.beam_advance

        def topk(vals, k):
            self.cand = vals
            out = real_topk(vals, k)
            self.top = out[0].cpu()
            self.entering, self.leaving = self.leaving, out[0]
            return out

        def plain_topk(x, ns, nb, wg, bg, *, k):
            logits = dk._ln(x, ns, nb) @ wg.float() + bg.float()
            self.logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
            return dk.fused_norm_generator_topk_reference(x, ns, nb, wg, bg, k=k)

        def advance(tokens, finished, lengths, beam_idx, tok_idx, i, end_id):
            self.steps.append((self.top, beam_idx.cpu(), tok_idx.cpu(),
                               self.value_fn(finished.clone())))
            return real_advance(tokens, finished, lengths, beam_idx, tok_idx, i, end_id)

        dec.topk_first_win = df.topk_first_win = topk
        dec.beam_advance = advance
        if self.plain:
            df.fused_layers_step = dk.fused_layers_step_reference
            df.fused_norm_generator_topk = plain_topk
        return self

    def value_fn(self, finished):
        """This step's score of candidate (video, beam, token), from the
        state the step started in."""
        from vct_tpu_torch.ops.decode_kernels import NEG_INF

        cand, logp, k = self.cand, self.logp, finished.shape[1]
        if cand.shape[1] > k * k:  # the module path: all K*V candidates
            v = cand.shape[1] // k
            return lambda r, beam, tok: float(cand[r, beam * v + tok])
        if not self.plain:
            return None
        scores = self.entering
        if scores is None:  # the first step: only beam 0 is live
            scores = torch.full_like(self.leaving, NEG_INF)
            scores[:, 0] = 0.0

        def value_of(r, beam, tok):
            if bool(finished[r, beam]):  # frozen: [PAD] at zero cost, nothing else
                return float(scores[r, beam]) if tok == self.pad_id else NEG_INF
            return float(scores[r, beam] + logp[r * k + beam, tok])

        return value_of

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def beam_partings(name, got, want, near_tie, step_drift):
    """Two traces of one search on the same inputs, ``want`` the reference.
    A video's beams may part (another beam or token at some rank of a step's
    selection) only at a near-tie of candidates: the reference's own score of
    the candidate that ``got`` selected at that rank lies within ``near_tie``
    plus twice the drift of the reference's selection there, where the drift
    is how far the two runs' scores of that video's selected beams were apart
    one step earlier. The drift of a video that has not parted stays under
    ``step_drift`` per step taken.
    -> (rows that parted, largest gap at a parting, largest drift)."""
    b = want[0][1].shape[0]
    together = torch.ones((b,), dtype=torch.bool)
    drift = torch.zeros((b,))
    worst_gap = worst_drift = 0.0
    for i, ((top_g, beam_g, tok_g, _), (top_w, beam_w, tok_w, value_of)) in \
            enumerate(zip(got, want)):
        differ = (beam_g != beam_w) | (tok_g != tok_w)
        for r in (differ.any(dim=1) & together).nonzero().flatten().tolist():
            rank = int(differ[r].int().argmax())
            gap = float(top_w[r, rank]) - value_of(r, int(beam_g[r, rank]), int(tok_g[r, rank]))
            limit = near_tie + 2 * float(drift[r])
            if not -limit < gap < limit:
                fail(f"{name}: video {r} parts at step {i}, rank {rank}: the reference scores "
                     f"its own selection {gap} above the other's (limit {limit}: near-tie "
                     f"{near_tie} + twice the drift {float(drift[r])})")
            worst_gap = max(worst_gap, gap)
        together &= ~differ.any(dim=1)
        drift = torch.where(together, (top_g - top_w).abs().max(dim=1).values, drift)
        if bool(together.any()):
            worst = float(drift[together].max())
            if worst > step_drift * (i + 1):
                fail(f"{name}: scores drifted {worst} apart by step {i} "
                     f"(limit {step_drift} per step)")
            worst_drift = max(worst_drift, worst)
    return ~together, worst_gap, worst_drift


def check_beam_loop(model, fw, b, k, seed):
    """The kernel beam loop against the same loop on the plain versions of
    its two kernels, on the same bfloat16 inputs (both round at the same
    points): every step's selection equal unless the candidates part at a
    near-tie (NEAR_TIE_SAME), and the videos that never part end in equal
    tokens and scores."""
    from vct_tpu_torch.decode_fast import beam_generate_fused

    feats, masks = eval_inputs(b, fw["wg"].device, seed)
    kw = dict(beam_size=k, max_len=30, start_id=101, end_id=102, fw=fw)
    with beam_trace() as kernel:
        tok_k, sc_k = beam_generate_fused(model, feats, masks, **kw)
    with beam_trace(plain=True) as plain:
        tok_p, sc_p = beam_generate_fused(model, feats, masks, **kw)
    torch.cuda.synchronize()
    name = f"beam loop bfloat16 B={b} K={k} ({b * k} rows)"
    # a step adds one log-probability to a beam's score, and the two runs'
    # log-probabilities agree to what decides a near-tie
    step_drift = NEAR_TIE_SAME
    parted, gap, drift = beam_partings(name, kernel.steps, plain.steps, NEAR_TIE_SAME,
                                       step_drift)
    same = ~parted.to(tok_k.device)
    if not torch.equal(tok_k[same], tok_p[same]):
        fail(f"{name}: videos whose selections never parted ended in different tokens")
    off = float((sc_k[same] - sc_p[same]).abs().max()) if bool(same.any()) else 0.0
    if off > step_drift * 29:
        fail(f"{name}: final scores {off} apart (limit {step_drift * 29})")
    say(f"  ok {name}: {int(same.sum())}/{b} videos select the same beams and tokens at "
        f"every step as the loop on the plain versions (final scores within {off:.3g}, "
        f"drift at most {drift:.3g}); {int(parted.sum())} part at candidate near-ties "
        f"(largest gap {gap:.3g}, limit {NEAR_TIE_SAME} + twice the drift)")


def check_beam_against_module(cfg, model, fw, dev):
    """The kernel beam path on the card: against the module path in float32
    at the eval batch's 256 beam rows (the two sum in different orders only:
    the same selection at every step, or a parting where candidates lie
    within 1e-4, and final scores within 1e-4); against the same loop on the
    kernels' plain versions in bfloat16 at the eval batch's 256 beam rows and
    at a beam of 16 (``check_beam_loop``); and against the module path in
    bfloat16. The module path rounds every product and its logits to 8 bits,
    so there the two searches part and end in different captions: each video
    may part only at a candidate near-tie (NEAR_TIE_MODULE, the drift
    allowed for), and the module path's own teacher-forced score of the
    kernel path's caption must agree with the kernel path's score to one
    near-tie unit per token after the length penalty. A beam wider than the
    top-k kernel carries must raise."""
    from vct_tpu_torch.cli.common import make_trainer_pieces
    from vct_tpu_torch.decode import beam_generate, make_auto_beam_fn
    from vct_tpu_torch.decode_fast import beam_generate_fused
    from vct_tpu_torch.ops import decode_kernels as dk

    with torch.no_grad():
        cfg32 = cfg.replace(tpu=dataclasses.replace(cfg.tpu, dtype="float32"))
        model32, _ = make_trainer_pieces(cfg32, dev, seed=SEED)
        feats, masks = eval_inputs(BATCH, dev, SEED + 50)
        kw = dict(beam_size=BEAM_K, max_len=30, start_id=101, end_id=102)
        with beam_trace() as kernel:
            tok_k, sc_k = beam_generate_fused(model32, feats, masks, **kw)
        with beam_trace() as module:
            tok_m, sc_m = beam_generate(model32, feats, masks, **kw)
        torch.cuda.synchronize()
        name = f"beam float32 B={BATCH} K={BEAM_K} against the module path"
        parted, gap, drift = beam_partings(name, kernel.steps, module.steps, 1e-4, 1e-5)
        same = ~parted.to(dev)
        if not torch.equal(tok_k[same], tok_m[same]):
            fail(f"{name}: videos whose selections never parted ended in different tokens")
        off = float((sc_k - sc_m)[same].abs().max()) if bool(same.any()) else 0.0
        if off > 1e-4:
            fail(f"{name}: scores {off} apart (limit 1e-4)")
        say(f"  ok {name}: {int(same.sum())}/{BATCH} videos select the same beams and tokens "
            f"at every step and end token-equal, {int(parted.sum())} part at candidate "
            f"near-ties (largest gap {gap:.3g}, limit 1e-4); final scores within {off:.3g}, "
            f"drift at most {drift:.3g}")
        del model32
        check_beam_loop(model, fw, BATCH, BEAM_K, SEED + 51)
        check_beam_loop(model, fw, 8, 16, SEED + 52)

        feats, masks = eval_inputs(BATCH, dev, SEED + 51)
        with beam_trace() as kernel:
            tok_k, sc_k = beam_generate_fused(model, feats, masks, fw=fw, **kw)
        with beam_trace() as module:
            tok_m, sc_m = beam_generate(model, feats, masks, **kw)
        rescored = module_score(model, feats, masks, tok_k, 102)
        torch.cuda.synchronize()
        name = f"beam bfloat16 B={BATCH} K={BEAM_K} against the module path"
        parted, gap, drift = beam_partings(name, kernel.steps, module.steps, NEAR_TIE_MODULE,
                                           NEAR_TIE_MODULE)
        same = ~parted.to(dev)
        if not torch.equal(tok_k[same], tok_m[same]):
            fail(f"{name}: videos whose selections never parted ended in different tokens")
        tol = NEAR_TIE_MODULE * 29 / 30 ** 0.6
        own = float((sc_k - rescored).abs().max())
        if own > tol:
            fail(f"{name}: the kernel path's captions score {own} away from the module "
                 f"path's scoring of them (limit {tol:.3f})")
        short = sc_m - rescored
        say(f"  ok {name}: {int(same.sum())}/{BATCH} videos select alike at every step; "
            f"{int(parted.sum())} part, each at a candidate near-tie (largest gap {gap:.3g}, "
            f"limit {NEAR_TIE_MODULE} + twice the drift, drift at most {drift:.3g}); the "
            f"module path scores the kernel path's captions within {own:.4f} of theirs "
            f"(limit {tol:.3f}); its own best is {float(short.mean()):+.4f} above that on "
            f"average, from {float(short.min()):+.4f} to {float(short.max()):+.4f} by video "
            f"(a reading, not a limit: after a parting the two searches are different "
            f"searches)")

        wide = dk.TOPK_MAX + 1
        before = read_launches()
        try:
            make_auto_beam_fn(model, 30, 101, 102, wide)(*eval_inputs(2, dev, SEED + 53))
        except ValueError as exc:
            say(f"  ok a beam of {wide} raises on the card: {exc}")
        else:
            fail(f"a beam of {wide} ran on the card: the top-k kernel carries {dk.TOPK_MAX}")
        if read_launches() != before:
            fail(f"a beam of {wide} launched kernels before it raised")


def per_layer_decode(fw, cks, cvs, mem_bias, max_len=30, start_id=101, pad_id=0):
    """A greedy decode whose stack runs one fused_layer_step launch per layer
    (decode_fast.layers_step_per_layer) -> tokens [B, max_len]. No entry
    point of the port takes this route, as none of the reference does."""
    from vct_tpu_torch.decode_fast import layers_step_per_layer
    from vct_tpu_torch.ops import decode_kernels as dk

    nl, _, b, e = cks.shape
    ks = torch.zeros((nl, 32, b, e), dtype=cks.dtype, device=cks.device)
    vs = torch.zeros_like(ks)
    tokens = torch.full((b, max_len), pad_id, dtype=torch.int32, device=cks.device)
    tokens[:, 0] = start_id
    for i in range(max_len - 1):
        x = dk._embed_step(fw["emb"], fw["pe"], tokens[:, i], i, pad_id)
        x, ks, vs = layers_step_per_layer(x, ks, vs, cks, cvs, mem_bias, fw["stacked"], i,
                                          heads=fw["heads"])
        tokens[:, i + 1] = dk.fused_norm_generator_argmax(x, fw["norm_s"], fw["norm_b"],
                                                          fw["wg"], fw["bg"])
    return tokens


def run_multi(model, fw):
    """The opt-in greedy modes against the per-token kernel loop at B = 1, 32
    and 64, token for token, bit for bit: multi_step=2 and 4 (the small-row
    kernel, which sums as the whole step); the sequence kernel at B = 1 and
    32 (the same token in its loop); at B=32 a 29-token decode whose stack
    runs layer by layer through fused_layer_step (the stack's launch at NL =
    1); a beam of 1 (fused_layers_step + the top-k kernel) at B = 1, 32, 64
    and 65, across the boundary where greedy decode leaves the whole-step
    kernel. At B = 1 and 32 the per-token loop, and so every route that
    gives its bits, is also held to the plain greedy chain, parting only at
    its near-ties -> launches, counted from 0."""
    from vct_tpu_torch.decode_fast import _prep_decode, beam_generate_fused, greedy_generate_fused
    from vct_tpu_torch.ops import decode_kernels as dk

    dev = fw["wg"].device
    plain = {}   # the plain greedy chains, read before the launches are counted
    with torch.no_grad():
        for b in (1, 32):
            feats, masks = eval_inputs(b, dev, SEED + 20 + b)
            _, cks, cvs, mem_bias = _prep_decode(model, feats, masks, 30, fw)
            plain[b] = plain_chain(fw, cks, cvs, mem_bias, fw["heads"], 30, 101, -1, 0)
    reset_launches()
    with no_plain_on_cuda("multi", dk), torch.no_grad():
        for b in (1, 32, 64, 65):
            feats, masks = eval_inputs(b, dev, SEED + 20 + b)
            kw = dict(max_len=30, start_id=101, end_id=-1, fw=fw)
            base, _ = greedy_generate_fused(model, feats, masks, **kw)
            if b in plain:   # and so every route below that gives its bits
                chain_err(f"multi B={b} per-token loop", base, *plain[b], NEAR_TIE_SAME)
            exact = [("beam of 1", lambda: beam_generate_fused(model, feats, masks, beam_size=1,
                                                                **kw)[0])]
            if b <= dk.SMALL_MAX_ROWS:
                exact += [(str(mode), lambda mode=mode: greedy_generate_fused(
                    model, feats, masks, **mode, **kw)[0])
                    for mode in (dict(multi_step=2), dict(multi_step=4))]
            if b <= dk.SEQUENCE_MAX_B:
                exact.append(("{'sequence_kernel': True}", lambda: greedy_generate_fused(
                    model, feats, masks, sequence_kernel=True, **kw)[0]))
            if b == 32:
                _, cks, cvs, mem_bias = _prep_decode(model, feats, masks, 30, fw)
                exact.append(("one fused_layer_step per layer",
                              lambda: per_layer_decode(fw, cks, cvs, mem_bias)))
            for label, run in exact:
                got = run()
                torch.cuda.synchronize()
                if not torch.equal(got, base):
                    rows = (got != base).any(1).nonzero().flatten().tolist()
                    fail(f"multi B={b} {label}: rows {rows} differ from the per-token loop, "
                         f"which sums alike")
                say(f"  ok B={b} {label}: {b}/{b} rows equal to the per-token kernel loop")
    launches = read_launches()
    for name in ("fused_multi_step", "fused_sequence_decode", "fused_layer_step"):
        if launches[name] == 0:
            fail(f"multi: {name} was never launched")
    if launches["fused_sequence_decode"] != 2:
        fail(f"multi: the sequence kernel takes one launch per caption batch, counted "
             f"{launches['fused_sequence_decode']} for 2")
    say(f"  launches {launches}")
    return launches


def time_beam_kernels(model, fw, heads, tm, card):
    """name -> {ms, plain_ms, bound_ms, bound_by, library_ms} of the four
    kernels at the shapes the eval and multi phases give them."""
    import torch.nn.functional as F

    from vct_tpu_torch.decode_fast import _prep_decode
    from vct_tpu_torch.ops import decode_kernels as dk

    out = {}
    dt = fw["wg"].dtype
    x = decoder_like(fw, heads, tm, BEAM_ROWS, 5001)
    gargs = (x, fw["norm_s"], fw["norm_b"], fw["wg"], fw["bg"])
    bg_dt = fw["bg"].to(dt)

    def library_topk():  # layer_norm -> product on the bf16 weights -> topk + logsumexp
        yn = F.layer_norm(x.float(), (x.shape[1],), fw["norm_s"], fw["norm_b"], 1e-5)
        logits = torch.addmm(bg_dt, yn.to(dt), fw["wg"]).float()
        return torch.topk(logits, BEAM_K, dim=-1), torch.logsumexp(logits, dim=-1)

    bnd = bound_ms(nbytes(*gargs) + BEAM_ROWS * (8 * BEAM_K + 4),
                   2.0 * BEAM_ROWS * fw["wg"].numel(), dt)
    wide = (x[:64].contiguous(),) + gargs[1:]  # the widest k the kernel carries
    # device times (graph replay) of the kernel, the one it replaced and the
    # library route, in turns: kernel, previous, library, library, previous, kernel
    runs = {"kernel": lambda: dk.fused_norm_generator_topk(*gargs, k=BEAM_K),
            "previous": lambda: dk._launch_gen_topk(*gargs, BEAM_K, _route=0),
            "library": library_topk}
    dev_ms = {key: device_time(fn) for key, fn in runs.items()}
    for key, fn in reversed(runs.items()):
        dev_ms[key] = min(dev_ms[key], device_time(fn))
    out["fused_norm_generator_topk"] = {
        "timer": "graph_replay", "ms": dev_ms["kernel"],
        "eager_ms": cuda_time(runs["kernel"]),
        "previous_same_run_ms": dev_ms["previous"],
        "plain_ms": cuda_time(lambda: dk.fused_norm_generator_topk_reference(*gargs, k=BEAM_K),
                              iters=5),
        "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": dev_ms["library"],
        "library_eager_ms": cuda_time(library_topk),
        "ms_b64_k32": device_time(lambda: dk.fused_norm_generator_topk(*wide, k=dk.TOPK_MAX)),
        "previous_same_run_ms_b64_k32": device_time(
            lambda: dk._launch_gen_topk(*wide, dk.TOPK_MAX, _route=0))}
    t = out["fused_norm_generator_topk"]
    say(f"  fused_norm_generator_topk at {BEAM_ROWS} rows, k={BEAM_K} [{card}]: kernel "
        f"{t['ms']:.4f} ms (replaced kernel {t['previous_same_run_ms']:.4f}, recorded earlier "
        f"{RECORDED_PREVIOUS_MS['fused_norm_generator_topk']:.4f}; host loop "
        f"{t['eager_ms']:.4f}), library {t['library_ms']:.4f} (host loop "
        f"{t['library_eager_ms']:.4f}), bound {t['bound_ms']:.4f}; 64 rows, k={dk.TOPK_MAX}: "
        f"kernel {t['ms_b64_k32']:.4f}, replaced kernel {t['previous_same_run_ms_b64_k32']:.4f}")

    a = step_inputs(fw, 32, 12, tm, gen=8000)
    w1 = {k: v[1] for k, v in fw["stacked"].items()}
    largs = (a["x"], a["kc"][1].clone(), a["vc"][1].clone(), a["ck"][1], a["cv"][1],
             a["mem_bias"], w1)
    mats = [w1[k] for k in ("wqkv", "wo", "wcq", "wco", "w1", "w2")]
    # the step at idx 12 attends cache rows 0..12
    bnd = bound_ms(nbytes(*w1.values(), a["x"], largs[1][:13], largs[2][:13], *largs[3:6])
                   + nbytes(a["x"]), 2.0 * 32 * sum(m.numel() for m in mats), dt)
    # the stack's launch at NL = 1 (the small-row kernel at 32 rows) and
    # decode_step_kernel, which it replaced, by graph replay in turns (kernel,
    # replaced, replaced, kernel): the wrapper's host code outlasts the kernel
    fns = {"kernel": lambda: dk.fused_layer_step(*largs, 12, heads=heads),
           "previous": lambda: dk._launch_layer_step(*largs, 12, heads=heads, _route=0)}
    t = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for which in order:
            t[which].append(device_time(fns[which]))
    out["fused_layer_step"] = {
        "timer": "graph_replay", "ms": min(t["kernel"]),
        "previous_same_run_ms": min(t["previous"]), "eager_ms": cuda_time(fns["kernel"]),
        "plain_ms": cuda_time(lambda: dk.fused_layer_step_reference(*largs, 12, heads=heads)),
        "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}
    say(f"  fused_layer_step [small-row kernel at NL = 1, graph replay] B=32 idx 12: "
        f"{out['fused_layer_step']['ms']:.4f} ms (replaced kernel "
        f"{out['fused_layer_step']['previous_same_run_ms']:.4f}, recorded earlier by cuda_time "
        f"{RECORDED_PREVIOUS_MS['fused_layer_step']:.4f})")

    # several tokens per launch at B=32: every input once for ``bound_ms``;
    # ``restream_bound_ms`` counts the weights once per token instead, since a
    # token needs the previous token's argmax and the weights (88 MB) exceed
    # what the card keeps on chip
    b, u = 32, 4
    feats, masks = eval_inputs(b, x.device, SEED + 60)
    _, cks, cvs, mem_bias = _prep_decode(model, feats, masks, 30, fw)
    ks = torch.zeros((cks.shape[0], 32, b, cks.shape[3]), dtype=dt, device=x.device)
    vs = torch.zeros_like(ks)
    cur = torch.full((b,), 101, dtype=torch.int32, device=x.device)
    weights = nbytes(*fw["stacked"].values(), fw["wg"], fw["bg"], fw["norm_s"], fw["norm_b"])
    mat_elems = sum(fw["stacked"][k].numel() for k in ("wqkv", "wo", "wcq", "wco", "w1", "w2")) \
        + fw["wg"].numel()

    def once_bound(n_tok, rows, cks, cvs, mem_bias):
        """Every input once, ``rows`` rows of both caches, the tokens'
        embedding and position rows and ids."""
        rb = cks.shape[2]
        moved = weights + nbytes(cks, cvs, mem_bias) + 2 * rows * nbytes(cks[:, :1]) \
            + n_tok * rb * (fw["emb"].shape[1] * 2 * 2 + 4)
        return bound_ms(moved, n_tok * 2.0 * rb * mat_elems, dt)

    def per_token(cks, cvs, mem_bias):
        """A token's bound with the weights re-streamed (the window of 8 rows)."""
        rb, e = cks.shape[2], cks.shape[3]
        stack = {"x": torch.empty((rb, e), dtype=dt, device=cks.device),
                 "kc": torch.empty((cks.shape[0], 8, rb, e), dtype=dt, device=cks.device),
                 "ck": cks, "cv": cvs, "mem_bias": mem_bias}
        stack["vc"] = stack["kc"]
        return step_bound(fw, stack, rb, 8, True)[0]

    margs = (cur, ks, vs, cks, cvs, mem_bias, fw["emb"], fw["pe"], fw)
    bnd = once_bound(u, 8, cks, cvs, mem_bias)
    # the small-row kernel's window and decode_multi_kernel, which it replaced,
    # by graph replay in turns (kernel, replaced, replaced, kernel)
    tok = torch.empty((b, u), dtype=torch.int32, device=x.device)
    fns = {"kernel": lambda: dk.fused_multi_step(*margs, 1, heads=heads, unroll=u, pad_id=0,
                                                 l_view=8),
           "previous": lambda: dk._launch_multi(*margs[:8], fw, heads=heads, l_view=8, i0=u,
                                                n_tok=u, seq=False, poison=False, tok_out=tok,
                                                start_id=0, end_id=-1, pad_id=0, route=0)}
    t = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for which in order:
            t[which].append(device_time(fns[which]))
    out["fused_multi_step"] = {
        "timer": "graph_replay", "ms": min(t["kernel"]),
        "previous_same_run_ms": min(t["previous"]), "eager_ms": cuda_time(fns["kernel"]),
        "plain_ms": cuda_time(lambda: dk.fused_multi_step_reference(
            *margs, 1, heads=heads, unroll=u, pad_id=0, l_view=8), iters=5),
        "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
        "restream_bound_ms": u * per_token(cks, cvs, mem_bias)}
    say(f"  fused_multi_step [small-row kernel, graph replay] B={b} u={u}: "
        f"{out['fused_multi_step']['ms']:.4f} ms (replaced kernel "
        f"{out['fused_multi_step']['previous_same_run_ms']:.4f}, recorded earlier by cuda_time "
        f"{RECORDED_PREVIOUS_MS['fused_multi_step']:.4f})")
    # the whole caption (29 tokens, end_id=-1: this run's data needs all of
    # them) on the small-row kernel and on decode_multi_kernel, which it
    # replaced, by graph replay in turns (kernel, replaced, replaced, kernel)
    # at B=32 and B=1
    skw = dict(heads=heads, max_len=30, start_id=101, end_id=-1, pad_id=0)
    row = {"timer": "graph_replay", "library_ms": None}
    for rb in (32, 1):
        if rb != b:
            feats, masks = eval_inputs(rb, x.device, SEED + 61)
            _, cks, cvs, mem_bias = _prep_decode(model, feats, masks, 30, fw)
        sargs = (fw["emb"], fw["pe"], cks, cvs, mem_bias, fw)
        fns = {"kernel": lambda: dk.fused_sequence_decode(*sargs, **skw),
               "previous": lambda: dk._launch_sequence_decode(*sargs, _route=0, **skw)}
        t = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for which in order:
                t[which].append(device_time(fns[which], iters=5))
        bnd = once_bound(29, 32, cks, cvs, mem_bias)
        sfx = "" if rb == 32 else f"_b{rb}"
        row.update({f"ms{sfx}": min(t["kernel"]), f"previous_same_run_ms{sfx}": min(t["previous"]),
                    f"eager_ms{sfx}": cuda_time(fns["kernel"], iters=5),
                    f"plain_ms{sfx}": cuda_time(
                        lambda: dk.fused_sequence_decode_reference(*sargs, **skw), iters=2),
                    f"bound_ms{sfx}": bnd[0], f"bound_by{sfx}": bnd[1],
                    f"restream_bound_ms{sfx}": 29 * per_token(cks, cvs, mem_bias)})
    out["fused_sequence_decode"] = row
    say(f"  fused_sequence_decode [small-row kernel, graph replay] 29 tokens: B=32 "
        f"{row['ms']:.4f} ms (replaced kernel {row['previous_same_run_ms']:.4f}, recorded earlier "
        f"by cuda_time {RECORDED_PREVIOUS_MS['fused_sequence_decode']:.4f}; host loop "
        f"{row['eager_ms']:.4f}), B=1 {row['ms_b1']:.4f} ms (replaced kernel "
        f"{row['previous_same_run_ms_b1']:.4f})")
    for name, t in out.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        extra = f", re-streamed bound {t['restream_bound_ms']:.4f} ms" \
            if "restream_bound_ms" in t else ""
        say(f"  {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}){extra}, library {lib} [{card}]")
    return out


def host_time(fn, reps=3):
    """ms per call on the host clock around synchronised runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000 / reps


def time_captions(model, fw, tm, card):
    """ms per caption at B=1 of the greedy modes (29 tokens, the encoder
    included), then greedy against beam-4 at eval batch 64 with beam's parts
    timed apart at the shapes of its middle stage (l_view=16)."""
    from vct_tpu_torch.decode_fast import beam_generate_fused, greedy_generate_fused
    from vct_tpu_torch.ops import decode_kernels as dk

    dev = fw["wg"].device
    report = {}
    feats, masks = eval_inputs(1, dev, SEED + 70)
    kw = dict(max_len=30, start_id=101, end_id=-1, fw=fw)
    with torch.no_grad():
        for label, mode in (("per_token", {}), ("multi_u2", dict(multi_step=2)),
                            ("multi_u4", dict(multi_step=4)),
                            ("sequence", dict(sequence_kernel=True))):
            ms = host_time(lambda: greedy_generate_fused(model, feats, masks, **mode, **kw),
                           reps=5)
            report[f"ms_per_caption_b1_{label}"] = ms
            say(f"  B=1 greedy {label}: {ms:.3f} ms per caption ({ms / 29:.3f} ms/token) "
                f"[{card}]")
        feats, masks = eval_inputs(BATCH, dev, SEED + 71)
        for label, fn in (
                ("greedy", lambda: greedy_generate_fused(model, feats, masks, **kw)),
                ("beam4", lambda: beam_generate_fused(model, feats, masks, beam_size=BEAM_K,
                                                      **kw))):
            ms = host_time(fn)
            report[f"captions_per_s_b64_{label}"] = BATCH / ms * 1000
            say(f"  eval batch {BATCH} {label}: {ms:.2f} ms per batch, "
                f"{BATCH / ms * 1000:.1f} captions/s ({ms / 29:.3f} ms/token) [{card}]")
        # beam's parts at 256 beam rows, per token
        nl, e = fw["stacked"]["wqkv"].shape[:2]
        ks = torch.randn((nl, 32, BEAM_ROWS, e), device=dev).to(fw["wg"].dtype)
        ks2 = torch.empty_like(ks)
        flat = torch.randint(0, BEAM_ROWS, (BEAM_ROWS,), device=dev)

        def regather():  # both caches, the first 16 rows of every layer
            for _ in range(2):
                for li in range(nl):
                    torch.index_select(ks[li, :16], 1, flat, out=ks2[li, :16])

        topv = torch.randn((BEAM_ROWS, BEAM_K), device=dev)
        topi = torch.randint(0, 30522, (BEAM_ROWS, BEAM_K), device=dev, dtype=torch.int32)
        lse = torch.randn((BEAM_ROWS,), device=dev)
        scores = torch.randn((BATCH, BEAM_K), device=dev)
        finished = torch.zeros((BATCH, BEAM_K), dtype=torch.bool, device=dev)
        frozen = torch.zeros((BEAM_K,), device=dev)

        def merge():  # the [B, K, K] candidate merge of one beam step
            logp = torch.where(finished[..., None], frozen,
                               (topv - lse[:, None]).reshape(BATCH, BEAM_K, BEAM_K))
            tok = torch.where(finished[..., None], 0, topi.reshape(BATCH, BEAM_K, BEAM_K))
            cand = scores[..., None] + logp
            s, idx = dk.topk_first_win(cand.reshape(BATCH, BEAM_K * BEAM_K), BEAM_K)
            return s, idx // BEAM_K, torch.gather(tok.reshape(BATCH, -1), 1, idx)

        a = step_inputs(fw, BEAM_ROWS, 12, tm, gen=9000)
        parts = {
            "stack_kernel": cuda_time(lambda: dk.fused_layers_step(
                a["x"], a["kc"], a["vc"], a["ck"], a["cv"], a["mem_bias"], fw["stacked"], 12,
                heads=fw["heads"], l_view=16)),
            "regather": cuda_time(regather),
            "candidate_merge": cuda_time(merge)}
    for k, ms in parts.items():
        report[f"beam_part_{k}_ms"] = ms
    say(f"  beam-4 parts per token at {BEAM_ROWS} rows (device time, besides the top-k "
        f"kernel above): " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in parts.items())
        + f" [{card}]")
    return report


# ---------------------------------------------------------------------------
# phase 6: the fused-loss kernels against their plain versions
# ---------------------------------------------------------------------------
# Tolerances. Kernel and plain version round the logits tile to the compute
# dtype at the same point but sum the product in another order, so a logit on
# a rounding boundary may land one unit apart: at |z| < 8 a bfloat16 unit is
# 2**-5, which moves that column's p (and dz) by up to 3% and the label logit
# zt by 0.03. Per-row float32 statistics (lse, sa) average over 30522 columns
# and agree to 2e-3 absolute in bfloat16, 2e-5 in float32; cnt counts p > 1e-7
# and may differ by the few columns that sit on the threshold. dx, dbg, dwg
# are sums of dz: max error at most 2% of the largest value.
STAT_ATOL = {torch.bfloat16: 2e-3, torch.float32: 2e-5}
ZT_ATOL = {torch.bfloat16: 0.04, torch.float32: 2e-5}
GRAD_REL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def loss_inputs(dev, dt, n, seed, e=LOSS_E, v=LOSS_V):
    """Seeded loss inputs at the generator's shape: some labels in the last,
    partial vocab tile, some pad labels, rows 8..16 with zero weights. ``w``
    and ``b`` are the generator as the fused loss hands it to the kernels
    (cast, not padded); ``w_pad`` and ``b_pad`` the same padded to a multiple
    of 512 columns with zero rows and a NEG_INF bias."""
    from vct_tpu_torch.ops import loss_kernels as lk

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, e), generator=g).to(dev)
    wg = (torch.randn((v, e), generator=g) / math.sqrt(e)).to(dev)
    bg = (torch.randn((v,), generator=g) * 0.1).to(dev)
    labels = torch.randint(0, v, (n,), generator=g)
    labels[:6] = torch.arange(v - 6, v)  # past the last full tile of 512
    labels[20:40] = 0
    labels = labels.to(dev)
    keep = (labels != 0).float()
    rect = (torch.rand((n,), generator=g) > 0.2).float().to(dev)
    keep[8:16] = 0.0
    rect[8:16] = 0.0
    w_pad, b_pad = lk.pad_generator(wg, bg, dt)
    return {"x": x, "wg": wg, "bg": bg, "labels": labels, "keep": keep, "rect": rect,
            "x_dt": x.to(dt).contiguous(), "w": wg.to(dt).contiguous(),
            "b": bg.to(dt).contiguous(), "w_pad": w_pad, "b_pad": b_pad,
            "lab32": labels.to(torch.int32).contiguous()}


def max_err(name, got, want, atol):
    if not bool(torch.isfinite(got.float()).all()):
        fail(f"{name}: non-finite values")
    err = float((got.float() - want.float()).abs().max())
    if err > atol:
        fail(f"{name}: max abs difference {err} > {atol}")
    return err


def abs_and_rel(name, got, want, rel):
    """Holds the difference under ``rel`` of the largest wanted value ->
    (max abs difference, the same as a share of that value)."""
    scale = float(want.float().abs().max())
    err = max_err(name, got, want, rel * scale + 1e-12)
    return err, err / max(scale, 1e-30)


def rel_err(name, got, want, rel):
    return abs_and_rel(name, got, want, rel)[1]


def backward_err(name, got, want, dt):
    """sce_backward_tiles' outputs against ``want``: dz within one unit of
    the compute dtype in all but 0.1% of the elements and within 5% in
    every one, rows 8..16 (zero weight) exactly 0, dx and dbg within
    GRAD_REL of their largest value -> (max abs difference, the largest of
    dx's and dbg's as a share of their largest value, the share of dz
    elements beyond one unit)."""
    dx, dz, parts = got
    dx_r, dz_r, parts_r = want
    err = (dz.float() - dz_r.float()).abs()
    ref = dz_r.float().abs()
    unit = 2.0 ** -7 if dt == torch.bfloat16 else 2e-5
    off = float((err > unit * ref + 1e-12).float().mean())
    if off > 1e-3 or not bool((err <= 0.05 * ref + 1e-12).all()):
        fail(f"{name}: dz off by more than one unit in {off:.2e} of the elements, worst "
             f"{float((err / (ref + 1e-12)).max()):.3g} relative")
    if float(dz[8:16].float().abs().max()) != 0.0:
        fail(f"{name}: zero-weight rows gave a gradient")
    dx_err = abs_and_rel(f"{name} dx", dx, dx_r, GRAD_REL[dt])
    dbg_err = abs_and_rel(f"{name} dbg", parts.sum(0), parts_r.sum(0), GRAD_REL[dt])
    return max(dx_err[0], dbg_err[0], float(err.max())), max(dx_err[1], dbg_err[1]), off


def check_loss_kernels(dev):
    from vct_tpu_torch.ops import fused_loss as fl
    from vct_tpu_torch.ops import loss_kernels as lk
    from vct_tpu_torch.ops._build import load_library

    for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        if load_library().vct_sce_block_rows(code) != lk.ROW_TILE[dt]:
            fail("loss_kernels.ROW_TILE disagrees with the built kernels")
    errs = {k: 0.0 for k in LOSS_REPLACES}
    # of sce_backward_tiles: dx and dbg as a share of their largest value, and
    # the share of dz elements more than one unit of the compute dtype apart
    bwd = {"max_rel_err": 0.0, "dz_beyond_one_unit": 0.0}
    # N=1984 is the train step's shape; 1000 and 300 end in a ragged row tile;
    # the widths above 768 make dx in column slabs (768 + 128)
    for dt, n, e, v in ((torch.bfloat16, LOSS_N, LOSS_E, LOSS_V),
                        (torch.bfloat16, 1000, LOSS_E, LOSS_V),
                        (torch.float32, 300, LOSS_E, LOSS_V),
                        (torch.bfloat16, 300, 896, 3000), (torch.float32, 300, 896, 3000)):
        a = loss_inputs(dev, dt, n, seed=n, e=e, v=v)
        x, w, b, lab = a["x_dt"], a["w"], a["b"], a["lab32"]
        name = f"N={n} E={e} V={v} {str(dt).split('.')[1]}"
        m, s, zt = lk.softmax_stats(x, w, b, lab)
        m_r, s_r, zt_r = lk.softmax_stats_reference(x, w, b, lab)
        lse = m_r + torch.log(s_r)
        sa, cnt = lk.clipped_prob_stats(x, w, b, lse)
        sa_r, cnt_r = lk.clipped_prob_stats_reference(x, w, b, lse)
        u, cc, lt = fl._bwd_coefficients(
            torch.tensor(0.5 / n, device=dev), torch.tensor(0.5 / n, device=dev),
            a["keep"], a["rect"], lse, zt_r, sa_r, True)
        bargs = (x, w, b, lse, u.contiguous(), cc.contiguous(), lt.contiguous(), lab)
        got = lk.sce_backward_tiles(*bargs)
        want = lk.sce_backward_tiles_reference(*bargs)
        torch.cuda.synchronize()
        errs["softmax_stats"] = max(
            errs["softmax_stats"],
            max_err(f"softmax_stats {name} lse", m + torch.log(s), lse, STAT_ATOL[dt]),
            max_err(f"softmax_stats {name} zt", zt, zt_r, ZT_ATOL[dt]))
        if float((zt - zt_r).abs().mean()) > STAT_ATOL[dt]:
            fail(f"softmax_stats {name}: mean zt difference above {STAT_ATOL[dt]}")
        errs["clipped_prob_stats"] = max(
            errs["clipped_prob_stats"],
            max_err(f"clipped_prob_stats {name} sa", sa, sa_r, STAT_ATOL[dt]))
        max_err(f"clipped_prob_stats {name} cnt", cnt, cnt_r, 8.0)
        err, rel, off = backward_err(f"sce_backward_tiles {name}", got, want, dt)
        errs["sce_backward_tiles"] = max(errs["sce_backward_tiles"], err)
        bwd["max_rel_err"] = max(bwd["max_rel_err"], rel)
        bwd["dz_beyond_one_unit"] = max(bwd["dz_beyond_one_unit"], off)
        say(f"  ok kernels {name}: dz beyond one unit in {off:.2e} of the elements")
        # the autograd function: kernel route against the chunked route
        for with_rce in (True, False):
            outs = []
            for use_kernels in (True, False):
                leaves = [a[k].clone().requires_grad_() for k in ("x", "wg", "bg")]
                before = [fn.launches for fn in lk.WRAPPERS]
                parts4 = fl.linear_sce_parts(*leaves, a["labels"], a["keep"], a["rect"], dt,
                                             2048, with_rce, use_kernels)
                loss = 0.5 * parts4[0] / parts4[1] + 0.5 * parts4[2] / parts4[3].clamp(min=1)
                loss.backward()
                torch.cuda.synchronize()
                got = [fn.launches - c for fn, c in zip(lk.WRAPPERS, before)]
                want = [1, int(with_rce), 1] if use_kernels else [0, 0, 0]
                if got != want:
                    fail(f"linear_sce_parts {name}: launches {got}, expected {want}")
                outs.append(([t.detach() for t in parts4], [t.grad for t in leaves]))
            for i, label in enumerate(("ce_sum", "ce_n", "rce_sum", "rce_n")):
                rel_err(f"linear_sce_parts {name} {label}", outs[0][0][i], outs[1][0][i],
                        2e-3 if dt == torch.bfloat16 else 1e-5)
            for i, label in enumerate(("dx", "dwg", "dbg")):
                rel_err(f"linear_sce_parts {name} rce={with_rce} {label}", outs[0][1][i],
                        outs[1][1][i], GRAD_REL[dt])
        say(f"  ok linear_sce_parts {name}: SCE and CE-only, both routes")
    for name, err in check_stats_kernels(dev).items():
        errs[name] = max(errs[name], err)
    err, rel, off = check_backward_routes(dev)
    errs["sce_backward_tiles"] = max(errs["sce_backward_tiles"], err)
    bwd["max_rel_err"] = max(bwd["max_rel_err"], rel)
    bwd["dz_beyond_one_unit"] = max(bwd["dz_beyond_one_unit"], off)
    say(f"  max abs differences {errs}; sce_backward_tiles {bwd}")
    return errs, bwd


# (N, E, V, padded): the kernel route's window (256 .. 4096), ragged row
# tiles, ragged vocabularies and the padded generator of earlier versions
STATS_SHAPES = [(256, 768, 1111, False), (1000, 896, 3000, False), (1984, 768, LOSS_V, False),
                (4096, 768, LOSS_V, False), (1984, 768, LOSS_V, True), (4096, 896, 3000, False),
                (1000, 768, LOSS_V, False)]


def check_stats_kernels(dev):
    """The bfloat16 statistics kernels (the tensor-core kernel, route -1)
    against their plain versions and against the kernel they replaced (route
    0) at STATS_SHAPES, with labels in the last partial vocab tile and
    outside [0, V); two calls give the same bits; ``sce_stats_plan`` against
    the C launcher's plan."""
    from vct_tpu_torch.ops import loss_kernels as lk

    dt = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, e, v, dtype in itertools.product((1, 31, 256, 1984, 4096, 7936), (128, 768, 896, 1664),
                                            (30522, 1111), (torch.bfloat16, torch.float32)):
        for route in ((-1, 0, 1) if dtype == torch.bfloat16 else (-1, 0)):
            got = library_plan("vct_sce_stats_plan", lk._DTYPE_CODE[dtype], n, e, v, route, sms,
                               n=9)
            if got != tuple(lk.sce_stats_plan(n, e, v, dtype, route, sms)):
                fail(f"sce_stats_plan({n}, {e}, {v}, {dtype}, {route}) disagrees with the "
                     f"launcher: {got}")
    errs = {"softmax_stats": 0.0, "clipped_prob_stats": 0.0}
    for n, e, v, padded in STATS_SHAPES:
        a = loss_inputs(dev, dt, n, seed=n + e + v, e=e, v=v)
        x, w, b = a["x_dt"], a["w_pad" if padded else "w"], a["b_pad" if padded else "b"]
        lab = a["lab32"].clone()
        lab[6:9] = torch.tensor([-1, v, v + 700], dtype=torch.int32, device=dev)
        name = f"N={n} E={e} V={v}{' padded' if padded else ''}"
        with no_plain_on_cuda(f"stats kernels {name}", lk):
            m, s, zt = lk.softmax_stats(x, w, b, lab)
            again = lk.softmax_stats(x, w, b, lab)
            old = lk._launch_softmax_stats(x, w, b, lab, _route=0)
        m_r, s_r, zt_r = lk.softmax_stats_reference(x, w, b, lab)
        lse = m_r + torch.log(s_r)
        with no_plain_on_cuda(f"stats kernels {name}", lk):
            sa, cnt = lk.clipped_prob_stats(x, w, b, lse)
            sa2, cnt2 = lk.clipped_prob_stats(x, w, b, lse)
            sa_o, cnt_o = lk._launch_clipped_prob_stats(x, w, b, lse, _route=0)
        sa_r, cnt_r = lk.clipped_prob_stats_reference(x, w, b, lse)
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip((m, s, zt, sa, cnt), (*again, sa2, cnt2))):
            fail(f"stats kernels {name}: two calls gave different bits")
        if not padded and float(zt[6:9].abs().max()) != 0.0:
            fail(f"softmax_stats {name}: a label outside [0, V) gave zt {zt[6:9].tolist()}")
        for label, got in (("", (m, s, zt, sa, cnt)), (" replaced kernel", (*old, sa_o, cnt_o))):
            err_s = max(max_err(f"softmax_stats{label} {name} lse", got[0] + torch.log(got[1]),
                                lse, STAT_ATOL[dt]),
                        max_err(f"softmax_stats{label} {name} zt", got[2], zt_r, ZT_ATOL[dt]))
            if float((got[2] - zt_r).abs().mean()) > STAT_ATOL[dt]:
                fail(f"softmax_stats{label} {name}: mean zt difference above {STAT_ATOL[dt]}")
            err_c = max_err(f"clipped_prob_stats{label} {name} sa", got[3], sa_r, STAT_ATOL[dt])
            max_err(f"clipped_prob_stats{label} {name} cnt", got[4], cnt_r, 8.0)
            if not label:
                errs["softmax_stats"] = max(errs["softmax_stats"], err_s)
                errs["clipped_prob_stats"] = max(errs["clipped_prob_stats"], err_c)
                report = f"lse and zt {err_s:.2e}, sa {err_c:.2e}"
        say(f"  ok stats kernels {name}: {report} from the plain versions; same bits twice; "
            f"the replaced kernel within the same bounds")
    return errs


# (N, E, V) of the backward's route checks: the MSVD step, the long step, a
# ragged last row tile, a width whose last dx tile is half full
BWD_SHAPES = [(LOSS_N, LOSS_E, LOSS_V), (4096, LOSS_E, LOSS_V), (1000, LOSS_E, LOSS_V),
              (300, 896, 3000)]


def check_backward_routes(dev):
    """sce_backward_tiles' plan (sce_backward_plan) against the C launcher's;
    then in bfloat16 at BWD_SHAPES, where the plan takes the tensor-core
    pair, against the plain version and against backward_kernel (route 0)
    by backward_err's bounds, with labels outside [0, V); two calls give the
    same bits. -> backward_err's worst figures against the plain versions."""
    import ctypes

    from vct_tpu_torch.ops import fused_loss as fl
    from vct_tpu_torch.ops import loss_kernels as lk
    from vct_tpu_torch.ops._build import load_library

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype, n, e, v, route in itertools.product(
            (torch.bfloat16, torch.float32), (1, 33, 256, 1984, 4096, 7936, lk.BWD_MAX_N + 1),
            (128, 768, 896, 1664), (1111, 30522), (-1, 0, 1)):
        try:
            want = tuple(lk.sce_backward_plan(n, e, v, dtype, route, sms))
        except ValueError:
            want = None
        out = (ctypes.c_int * 13)()
        err = load_library().vct_sce_backward_plan(lk._DTYPE_CODE[dtype], n, e, v, route, sms,
                                                   out)
        if (None if err else tuple(out)) != want:
            fail(f"sce_backward_plan({n}, {e}, {v}, {dtype}, {route}) is {want}, the "
                 f"launcher's {None if err else tuple(out)}")
    dt = torch.bfloat16
    worst = (0.0, 0.0, 0.0)
    for n, e, v in BWD_SHAPES:
        plan = lk.sce_backward_plan(n, e, v, dt, -1, sms)
        if plan.route != 1:
            fail(f"sce_backward_tiles N={n} E={e} V={v}: the plan takes route {plan.route}")
        a = loss_inputs(dev, dt, n, seed=n + e + v + 1, e=e, v=v)
        x, w, b = a["x_dt"], a["w"], a["b"]
        lab = a["lab32"].clone()
        lab[16:19] = torch.tensor([-1, v, v + 700], dtype=torch.int32, device=dev)
        m, s, zt = lk.softmax_stats_reference(x, w, b, lab)
        lse = m + torch.log(s)
        sa, _ = lk.clipped_prob_stats_reference(x, w, b, lse)
        g = torch.tensor(0.5 / n, device=dev)
        u, cc, lt = (t.contiguous() for t in fl._bwd_coefficients(
            g, g, a["keep"], a["rect"], lse, zt, sa, True))
        bargs = (x, w, b, lse, u, cc, lt, lab)
        name = f"sce_backward_tiles tensor-core route N={n} E={e} V={v}"
        with no_plain_on_cuda(name, lk):
            got = lk.sce_backward_tiles(*bargs)
            again = lk.sce_backward_tiles(*bargs)
            old = lk._launch_backward(*bargs, _route=0)
        want = lk.sce_backward_tiles_reference(*bargs)
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            fail(f"{name}: two calls gave different bits")
        res = backward_err(name, got, want, dt)
        backward_err(f"{name} against the replaced kernel", got, old, dt)
        worst = tuple(max(p, q) for p, q in zip(worst, res))
        say(f"  ok {name} ({plan.groups} vocab groups of dx): against the plain version (dz "
            f"beyond one unit in {res[2]:.2e}, dx and dbg within {res[1]:.2e} of their largest) "
            f"and the replaced kernel; same bits twice")
    return worst


def time_loss_kernels(dev, card):
    """name -> {ms, plain_ms, bound_ms, bound_by, library_ms} at the train
    step's shape, and the routes of linear_sce_parts at N=1984 and N=7936.
    The three kernels, the kernels they replaced (route 0) and their library
    calls are timed by graph replay at N=1984 and N=4096, and so is the
    whole loss backward (kernel, dwg, dbg) against its library route. The
    generator's padded copy against the bare cast, by graph replay."""
    import torch.nn.functional as F

    from vct_tpu_torch.models.losses import sce_loss_parts
    from vct_tpu_torch.ops import fused_loss as fl
    from vct_tpu_torch.ops import loss_kernels as lk

    dt = torch.bfloat16
    a = loss_inputs(dev, dt, LOSS_N, seed=7)
    x, w, b, lab = a["x_dt"], a["w"], a["b"], a["lab32"]
    n, e = x.shape
    v = w.shape[0]
    v_pad = lk._round_up(v, lk.BLOCK_V)   # the columns of dz and of the dbg partials
    m, s, zt = lk.softmax_stats(x, w, b, lab)
    lse = (m + torch.log(s)).contiguous()
    sa, _ = lk.clipped_prob_stats(x, w, b, lse)
    g = torch.tensor(0.5 / n, device=dev)
    u, cc, lt = (t.contiguous() for t in fl._bwd_coefficients(
        g, g, a["keep"], a["rect"], lse, zt, sa, True))
    bargs = (x, w, b, lse, u, cc, lt, lab)
    long_lab = a["labels"]

    leaves = [a[k].clone().requires_grad_() for k in ("x", "wg", "bg")]

    def materialised(backward: bool):
        logits = F.linear(leaves[0].to(dt), leaves[1].to(dt), leaves[2].to(dt))
        parts = sce_loss_parts(logits, long_lab, ignore_index=0, rect_mask=a["rect"] > 0)
        loss = 0.5 * parts[0] / parts[1] + 0.5 * parts[2] / parts[3]
        if backward:
            for t in leaves:
                t.grad = None
            loss.backward()
        return loss

    mat_fwd = cuda_time(lambda: materialised(False), iters=10)
    mat_both = cuda_time(lambda: materialised(True), iters=10)
    out = {}

    def lib_backward_for(x, w, b, lse, u, cc, lt, long_lab, with_dwg=False):
        """The backward's outputs from library calls (materialised logits),
        without dwg unless asked for."""
        rows_idx = torch.arange(x.shape[0], device=x.device)

        def run():
            p = torch.exp(F.linear(x, w, b).float() - lse[:, None])
            dz = p * (u[:, None] + cc[:, None] * (p > 1e-7))
            dz[rows_idx, long_lab] -= lt
            dz_dt = dz.to(dt)
            out = (fl._matmul_f32(dz_dt, w), dz_dt, dz.sum(0))
            return out + (fl._matmul_f32(dz_dt.t(), x),) if with_dwg else out
        return run

    def whole_backward_for(bargs):
        """The kernel route's whole loss backward: the kernel, dwg on one
        product, the dbg partials summed (fused_loss.py's backward)."""
        def run():
            dx, dz, parts = lk.sce_backward_tiles(*bargs)
            return dx, fl._matmul_f32(dz.t(), bargs[0])[:v], parts.sum(dim=0)[:v]
        return run

    # the statistics kernels by graph replay, in turns (kernel, replaced
    # kernel, library call, then the other way round), at the MSVD step's N
    # and the long step's
    for rows in (LOSS_N, 4096):
        ar = a if rows == LOSS_N else loss_inputs(dev, dt, rows, seed=8)
        xr, wr, br, labr, lab_r = ar["x_dt"], ar["w"], ar["b"], ar["lab32"], ar["labels"]
        mr, sr, _ = lk.softmax_stats(xr, wr, br, labr)
        lse_r = (mr + torch.log(sr)).contiguous()

        def lib_clip(xr=xr, wr=wr, br=br):   # the materialised logits, softmax, masked sums
            p = torch.softmax(F.linear(xr, wr, br).float(), dim=-1)
            above = p > 1e-7
            return torch.where(above, p, 0.0).sum(-1), above.sum(-1)

        calls = {
            "softmax_stats": {
                "kernel": lambda: lk.softmax_stats(xr, wr, br, labr),
                "previous": lambda: lk._launch_softmax_stats(xr, wr, br, labr, _route=0),
                # the materialised logits, then lse - zt
                "library": lambda: F.cross_entropy(F.linear(xr, wr, br).float(), lab_r,
                                                   reduction="none")},
            "clipped_prob_stats": {
                "kernel": lambda: lk.clipped_prob_stats(xr, wr, br, lse_r),
                "previous": lambda: lk._launch_clipped_prob_stats(xr, wr, br, lse_r, _route=0),
                "library": lib_clip}}
        bnd = bound_ms(nbytes(xr, wr, br, labr) + 3 * 4 * rows, 2.0 * rows * e * wr.shape[0], dt)
        sfx = "" if rows == LOSS_N else f"_n{rows}"
        for name, fns in calls.items():
            t = {k: [] for k in fns}
            for order in (list(fns), list(fns)[::-1]):
                for which in order:
                    t[which].append(device_time(fns[which], iters=10))
            row = out.setdefault(name, {"timer": "graph_replay"})
            row.update({f"ms{sfx}": min(t["kernel"]),
                        f"previous_same_run_ms{sfx}": min(t["previous"]),
                        f"library_ms{sfx}": min(t["library"]),
                        f"bound_ms{sfx}": bnd[0], f"bound_by{sfx}": bnd[1]})
            if rows == LOSS_N:
                row["eager_ms"] = cuda_time(fns["kernel"], iters=10)
    out["softmax_stats"]["plain_ms"] = cuda_time(
        lambda: lk.softmax_stats_reference(x, w, b, lab), iters=3)
    out["clipped_prob_stats"]["plain_ms"] = cuda_time(
        lambda: lk.clipped_prob_stats_reference(x, w, b, lse), iters=3)
    # the backward by graph replay, in turns (kernel, replaced kernel, library
    # route, then the other way round), at N=1984 and N=4096; then the whole
    # loss backward (kernel, dwg, dbg) against the library route with dwg
    row = out["sce_backward_tiles"] = {"timer": "graph_replay"}
    for rows in (LOSS_N, 4096):
        if rows == LOSS_N:
            ar, br, lab_long = a, bargs, long_lab
        else:
            ar = loss_inputs(dev, dt, rows, seed=9)
            mr, sr, ztr = lk.softmax_stats(ar["x_dt"], ar["w"], ar["b"], ar["lab32"])
            lse_r = (mr + torch.log(sr)).contiguous()
            sa_r, _ = lk.clipped_prob_stats(ar["x_dt"], ar["w"], ar["b"], lse_r)
            gr = torch.tensor(0.5 / rows, device=dev)
            ur, ccr, ltr = (t.contiguous() for t in fl._bwd_coefficients(
                gr, gr, ar["keep"], ar["rect"], lse_r, ztr, sa_r, True))
            br = (ar["x_dt"], ar["w"], ar["b"], lse_r, ur, ccr, ltr, ar["lab32"])
            lab_long = ar["labels"]
        fns = {"kernel": lambda: lk.sce_backward_tiles(*br),
               "previous": lambda: lk._launch_backward(*br, _route=0),
               "library": lib_backward_for(*br[:7], lab_long)}
        t = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for which in order:
                t[which].append(device_time(fns[which], iters=10))
        whole = {"kernel": whole_backward_for(br),
                 "library": lib_backward_for(*br[:7], lab_long, with_dwg=True)}
        tw = {k: [] for k in whole}
        for order in (list(whole), list(whole)[::-1]):
            for which in order:
                tw[which].append(device_time(whole[which], iters=10))
        nr = br[0].shape[0]
        moved = nbytes(*br) + 4 * nr * e + 2 * nr * v_pad + 4 * v_pad * ((nr + 31) // 32)
        bnd = bound_ms(moved, 2 * 2.0 * nr * e * v, dt)
        sfx = "" if rows == LOSS_N else f"_n{rows}"
        row.update({f"ms{sfx}": min(t["kernel"]), f"previous_same_run_ms{sfx}": min(t["previous"]),
                    f"library_ms{sfx}": min(t["library"]), f"bound_ms{sfx}": bnd[0],
                    f"bound_by{sfx}": bnd[1], f"whole_backward_ms{sfx}": min(tw["kernel"]),
                    f"whole_backward_library_ms{sfx}": min(tw["library"])})
        if rows == LOSS_N:
            row["eager_ms"] = cuda_time(fns["kernel"], iters=10)
            row["plain_ms"] = cuda_time(lambda: lk.sce_backward_tiles_reference(*bargs), iters=3)
    say(f"  sce_backward_tiles whole loss backward (kernel + dwg + dbg, graph replay): "
        f"{row['whole_backward_ms']:.4f} ms at N={LOSS_N} (library route with dwg "
        f"{row['whole_backward_library_ms']:.4f}), {row['whole_backward_ms_n4096']:.4f} at "
        f"N=4096 (library {row['whole_backward_library_ms_n4096']:.4f}); replaced kernel "
        f"recorded earlier by cuda_time {RECORDED_PREVIOUS_MS['sce_backward_tiles']:.4f} [{card}]")
    for name, t in out.items():
        was = "" if "previous_same_run_ms" not in t else (
            f" (replaced kernel {t['previous_same_run_ms']:.4f}; N=4096: kernel "
            f"{t['ms_n4096']:.4f}, replaced {t['previous_same_run_ms_n4096']:.4f}, library "
            f"{t['library_ms_n4096']:.4f}, bound {t['bound_ms_n4096']:.4f}; host loop "
            f"{t['eager_ms']:.4f})")
        say(f"  {name}: kernel {t['ms']:.4f} ms{was}, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), library {t['library_ms']:.4f} ms "
            f"[{card}]")
    # what the fused loss's forward did to the generator before the kernels
    # masked the ragged tile themselves, against what it does now
    gen_t = {"pad": [], "cast": []}
    gen_calls = {"pad": lambda: lk.pad_generator(a["wg"], a["bg"], dt),
                 "cast": lambda: (a["wg"].to(dt).contiguous(), a["bg"].to(dt).contiguous())}
    for order in (("pad", "cast"), ("cast", "pad")):
        for which in order:
            gen_t[which].append(device_time(gen_calls[which], iters=10))
    say(f"  generator [{a['wg'].shape[0]}, {e}] float32 -> bf16: padded copy "
        f"{min(gen_t['pad']):.4f} ms, bare cast {min(gen_t['cast']):.4f} ms (graph replay) "
        f"[{card}]")
    say(f"  materialised route (F.linear -> sce_loss_parts) N={n}: forward {mat_fwd:.4f} ms, "
        f"forward+backward {mat_both:.4f} ms [{card}]")
    report = {"loss_materialised_fwd_ms": mat_fwd, "loss_materialised_fwd_bwd_ms": mat_both,
              "generator_pad_ms": min(gen_t["pad"]), "generator_cast_ms": min(gen_t["cast"])}
    # the function under linear_sce_parts with the route given, so that N=7936,
    # outside the dispatch window, can be read on the kernel route too
    for rows in (LOSS_N, 4 * LOSS_N):
        a = loss_inputs(dev, dt, rows, seed=rows + 1)
        for label, kernels in (("kernel", True), ("chunked", False)):
            lv = [a[k].clone().requires_grad_() for k in ("x", "wg", "bg")]

            def run():
                for t in lv:
                    t.grad = None
                parts = fl._LinearSCE.apply(*lv, a["labels"], a["keep"], a["rect"], dt, 2048,
                                            True, kernels)
                (parts[0] / parts[1] + parts[2] / parts[3]).backward()

            ms = cuda_time(run, iters=5)
            report[f"loss_{label}_route_n{rows}_ms"] = ms
            say(f"  linear_sce_parts forward+backward N={rows} {label} route: "
                f"{ms:.3f} ms [{card}]")
    return out, report


# ---------------------------------------------------------------------------
# phase 7: training through the CLI
# ---------------------------------------------------------------------------


def write_dataset(root: Path) -> None:
    """A seeded MSVD-shaped workspace under ``root``. Captions draw on 40
    words so a few steps already lower the loss; 160 train videos x 8
    captions give TRAIN_STEPS batches of 64, 16 validation videos x 8 give
    VAL_STEPS."""
    rng = np.random.default_rng(SEED)
    words = [f"w{i}" for i in rng.choice(np.arange(1000, 30522), 40, replace=False)]
    for split, n_vid in (("train", TRAIN_STEPS * BATCH // 8), ("val", VAL_STEPS * BATCH // 8)):
        feat_dir = root / "feats" / split
        feat_dir.mkdir(parents=True)
        lines = []
        for i in range(n_vid):
            np.save(feat_dir / f"{split}{i}.npy",
                    rng.standard_normal((int(rng.integers(6, 15)), 512)).astype(np.float32))
            for _ in range(8):
                cap = " ".join(rng.choice(words, int(rng.integers(4, 25))))
                lines.append(f"{split}{i} {cap}")
        (root / f"{split}.txt").write_text("\n".join(lines))


def train_config(repo: Path, root: Path, vocab: Path, epochs: int, **tpu) -> Path:
    """configs/msvd.json with the workspace's paths and ``epochs`` -> file."""
    cfg = json.loads((repo / "configs" / "msvd.json").read_text())
    for name, split in (("train", "train"), ("validation", "val"), ("eval", "val")):
        cfg["data"][name]["feat_dir"] = [str(root / "feats" / split)]
        cfg["data"][name]["annotation_path"] = str(root / f"{split}.txt")
    cfg["train"].update(epoch=epochs, save_dir=str(root / "ckpt"), log_dir=str(root / "log"),
                        tag="smoke")
    cfg["tpu"].update(vocab_path=str(vocab), progress_bar=False, **tpu)
    path = root / ("_".join(["msvd", str(epochs)] + [f"{k}{v}" for k, v in tpu.items()])
                   + ".json")
    path.write_text(json.dumps(cfg))
    return path


def run_training(repo: Path, root: Path, vocab: Path):
    import vct_tpu_torch.train.loop as loop
    from vct_tpu_torch.cli import train as train_cli
    from vct_tpu_torch.ops import decode_kernels as dk
    from vct_tpu_torch.ops import loss_kernels as lk

    losses, val_parts = [], []
    make_train, make_eval = loop.make_train_step, loop.make_eval_step

    def recording_train(task):
        step = make_train(task)

        def wrapped(state, batch):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
            return state, metrics

        return wrapped

    def recording_eval(task):
        step = make_eval(task)

        def wrapped(model, batch):
            parts = step(model, batch)
            val_parts.append(parts)
            return parts

        return wrapped

    loop.make_train_step, loop.make_eval_step = recording_train, recording_eval
    try:
        with no_plain_on_cuda("train", lk):
            for fn in lk.WRAPPERS + dk.WRAPPERS:
                fn.launches = 0
            scores = train_cli.main(["-c", str(train_config(repo, root, vocab, 1)),
                                     "--no_tensorboard"])
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in lk.WRAPPERS}
            decode_launches = dk.fused_whole_step.launches
            first = [float(v) for v in losses]
            vals = [{k: float(v) for k, v in parts.items()} for parts in val_parts]
            losses.clear()
            train_cli.main(["-c", str(train_config(repo, root, vocab, 2)), "--no_tensorboard",
                            "--resume", "auto"])
            torch.cuda.synchronize()
            second = [float(v) for v in losses]
    finally:
        loop.make_train_step, loop.make_eval_step = make_train, make_eval
    want = {"softmax_stats": TRAIN_STEPS + VAL_STEPS, "clipped_prob_stats": TRAIN_STEPS + VAL_STEPS,
            "sce_backward_tiles": TRAIN_STEPS}
    if len(first) != TRAIN_STEPS or len(vals) != VAL_STEPS or len(second) != TRAIN_STEPS:
        fail(f"train: {len(first)} + {len(second)} train steps, {len(vals)} validation steps")
    if launches != want:
        fail(f"train: loss kernel launches {launches}, expected {want} "
             f"(3 per train step, 2 per validation step)")
    if decode_launches == 0:
        fail("train: the eval decode never launched fused_whole_step")
    if not all(math.isfinite(v) for v in first + second) or \
            not all(math.isfinite(v) for parts in vals for v in parts.values()):
        fail("train: a loss is not finite")
    head, tail = sum(first[:5]) / 5, sum(first[-5:]) / 5
    resumed = sum(second) / len(second)
    if not tail < head or not resumed < head:
        fail(f"train: the loss did not fall: first five {head}, last five {tail}, resumed "
             f"epoch {resumed}")
    if not (root / "ckpt" / "smoke_latest.pt").is_file() or \
            set(scores) < {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr"}:
        fail(f"train: no checkpoint or no scores ({scores})")
    say(f"  {TRAIN_STEPS} train steps: loss {head:.4f} (first five) -> {tail:.4f} (last "
        f"five); resumed epoch {resumed:.4f}; launches {launches}; eval decode "
        f"fused_whole_step launches {decode_launches}")
    return launches


def make_trainer(repo, root, vocab, dev, **tpu):
    from vct_tpu_torch.cli.common import load_config
    from vct_tpu_torch.train.loop import Trainer

    cfg = load_config(str(train_config(repo, root, vocab, 1, **tpu)))
    return Trainer(cfg, device=dev, log=lambda *_: None)


def first_batch(trainer):
    """The first train batch on the trainer's device, with its text features
    when the task has a text encoder."""
    from vct_tpu_torch.train.step import batch_to_arrays

    trainer.loaders["train"].set_epoch(0)
    return batch_to_arrays(next(iter(trainer.loaders["train"])), trainer.device,
                           trainer.text_encoder)


def caption_grads(model):
    """name -> gradient of every parameter the caption loss reaches: all but
    the matching head, which configs/msvd.json builds and the caption task
    leaves out."""
    return {k: p.grad for k, p in model.named_parameters() if not k.startswith("matching.")}


def check_step0_routes(repo, root, vocab, dev):
    """Step 0 of training with the same weights, batch and dropout masks on
    the kernel route and on the chunked route: loss within 1e-3 relative,
    every gradient within 3% of its largest value (bfloat16 logits one unit
    apart move single dz elements by up to 3%)."""
    grads, losses = [], []
    for kernels in (True, False):
        tr = make_trainer(repo, root, vocab, dev, fused_loss_pallas=kernels)
        batch = first_batch(tr)
        tr.model.train()
        loss = tr.model.caption_loss(batch["feats"], batch["masks"], batch["token_ids"],
                                     batch["token_mask"], row_valid=batch["row_valid"])
        loss.backward()
        torch.cuda.synchronize()
        losses.append(float(loss.detach()))
        grads.append(caption_grads(tr.model))
    if abs(losses[0] - losses[1]) > 1e-3 * abs(losses[1]):
        fail(f"step 0: loss {losses[0]} on the kernel route, {losses[1]} on the chunked route")
    worst = 0.0
    for k, ref in grads[1].items():
        worst = max(worst, rel_err(f"step 0 gradient {k}", grads[0][k], ref, 3e-2))
    say(f"  step 0: loss {losses[0]:.6f} (kernel route) vs {losses[1]:.6f} (chunked route), "
        f"worst gradient difference {worst:.3g} of its largest value, "
        f"{len(grads[1])} parameters")


def time_train_steps(repo, root, vocab, dev, card):
    """ms per train step (batch 64, dropout on) on a fixed batch: fused loss
    on the kernel route, on the chunked route, and off (materialised logits)."""
    report = {}
    for label, tpu in (("fused_kernels", {}), ("fused_chunked", {"fused_loss_pallas": False}),
                       ("materialised", {"use_fused_loss": False})):
        tr = make_trainer(repo, root, vocab, dev, **tpu)
        batch = first_batch(tr)
        for _ in range(3):
            tr.train_step(tr.state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            tr.train_step(tr.state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 100
        report[f"train_step_ms_{label}"] = ms
        say(f"  train step, loss {label}: {ms:.2f} ms [{card}]")
    return report


def device_rows(fn, calls):
    """torch.profiler over ``calls`` calls of ``fn`` -> ([(kernel, device ms
    per call, launches per call)], host ms per call under the profiler). User
    annotations and the optimizer's and profiler's own ranges are left out:
    their device time is their kernels'."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / calls
    rows = [(e.key, e.device_time_total / 1e3 / calls, e.count / calls)
            for e in prof.key_averages()
            if e.device_time_total > 0 and str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("Optimizer.", "ProfilerStep"))]
    return rows, wall


def profile_train(tr, card):
    """Where a train step of the Trainer ``tr`` goes: ms per step without
    the profiler, then torch.profiler over 10 steps for the device's busy
    time by kernel. The idle share sets the busy time against the unprofiled
    step, since the profiler slows the host several times over."""
    batch = first_batch(tr)
    for _ in range(3):
        tr.train_step(tr.state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        tr.train_step(tr.state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 100
    rows, profiled_ms = device_rows(lambda: tr.train_step(tr.state, batch), 10)
    busy = sum(r[1] for r in rows)
    say(f"profile of 10 train steps [{card}]: {step_ms:.2f} ms/step unprofiled "
        f"({profiled_ms:.1f} under the profiler), device busy {busy:.2f} ms/step, idle share "
        f"{1 - busy / step_ms:.2f}, {sum(r[2] for r in rows):.0f} kernels/step")
    bwd = sum(r[1] for r in rows if "bwd_dq" in r[0] or "bwd_dkv" in r[0])  # attention's
    say(f"  attention backward kernels {bwd:.3f} ms/step, {bwd / busy:.3f} of the busy time")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:14]:
        say(f"  {ms:8.3f} ms/step  {count:6.1f}/step  {key[:100]}")


def profile_beam(model, fw, card):
    """Where a beam-4 eval batch of 64 goes (29 tokens, the encoder
    included): ms per batch without the profiler, then torch.profiler over 3
    batches for the device's busy time per batch and per token by kernel."""
    from vct_tpu_torch.decode_fast import beam_generate_fused

    feats, masks = eval_inputs(BATCH, fw["wg"].device, SEED + 71)
    with torch.no_grad():
        def fn():
            return beam_generate_fused(model, feats, masks, beam_size=BEAM_K, max_len=30,
                                       start_id=101, end_id=-1, fw=fw)

        ms = host_time(fn)
        rows, _ = device_rows(fn, 3)
    busy = sum(r[1] for r in rows)
    say(f"profile of a beam-{BEAM_K} eval batch of {BATCH} [{card}]: {ms:.2f} ms unprofiled "
        f"({BATCH / ms * 1000:.1f} captions/s), device busy {busy:.3f} ms per batch, "
        f"{busy / 29:.4f} ms per beam token, idle share {1 - busy / ms:.2f}, "
        f"{sum(r[2] for r in rows):.0f} kernels per batch")
    for key, k_ms, count in sorted(rows, key=lambda r: -r[1])[:10]:
        say(f"  {k_ms:8.3f} ms/batch  {count:6.1f}/batch  {key[:90]}")


def stack_variant(root, model, fw, heads, tm, card):
    """The stack kernel of the package under ``root``: graph-replay ms at
    B=128 and 256 rows, its route checks (the worst mean difference), the
    bf16 beam loop checks (reported, not fatal), and per-phase µs from
    %globaltimer stamps where the library exports ``vct_stack_stamps`` (a
    copy instrumented to write one after each barrier)."""
    import ctypes

    import vct_tpu_torch
    from vct_tpu_torch.ops import decode_kernels as dk
    from vct_tpu_torch.ops._build import load_library

    times = {}
    for b in (128, BEAM_ROWS):
        a = step_inputs(fw, b, 12, tm, gen=4001)
        args = (a["x"], a["kc"], a["vc"], a["ck"], a["cv"], a["mem_bias"], fw["stacked"])
        times[b] = min(device_time(lambda: dk.fused_layers_step(*args, 12, heads=heads, l_view=16))
                       for _ in range(2))
    say(f"stack variant {root} ({Path(vct_tpu_torch.__file__).parent}) [{card}]: B=128 "
        f"{times[128]:.4f} ms, {BEAM_ROWS} rows {times[BEAM_ROWS]:.4f} ms (graph replay)")
    small = {}
    for b in (1, 32, 64):
        a = step_inputs(fw, b, 12, tm, gen=4010 + b)
        args = (a["x"], a["kc"], a["vc"], a["ck"], a["cv"], a["mem_bias"])
        small[f"whole B={b}"] = min(device_time(lambda: dk.fused_whole_step(
            *args, fw, 12, heads=heads, l_view=16)) for _ in range(2))
        small[f"stack B={b}"] = device_time(lambda: dk.fused_layers_step(
            *args, fw["stacked"], 12, heads=heads, l_view=16))
    a = step_inputs(fw, 32, 0, tm, gen=4100)
    ks, vs = torch.zeros_like(a["kc"]), torch.zeros_like(a["kc"])
    cur = torch.full((32,), 101, dtype=torch.int32, device=ks.device)
    small["multi B=32 u=4"] = device_time(lambda: dk.fused_multi_step(
        cur, ks, vs, a["ck"], a["cv"], a["mem_bias"], fw["emb"], fw["pe"], fw, 1, heads=heads,
        unroll=4, pad_id=0, l_view=8))
    skw = dict(heads=heads, max_len=30, start_id=101, end_id=-1, pad_id=0)
    for b in (32, 1):
        sa = step_inputs(fw, b, 0, tm, gen=4200 + b)
        small[f"sequence B={b}"] = device_time(lambda: dk.fused_sequence_decode(
            fw["emb"], fw["pe"], sa["ck"], sa["cv"], sa["mem_bias"], fw, **skw), iters=3)
    la = step_inputs(fw, 32, 12, tm, gen=4300)
    w1 = {k: v[1] for k, v in fw["stacked"].items()}
    small["layer_step B=32"] = device_time(lambda: dk.fused_layer_step(
        la["x"], la["kc"][1], la["vc"][1], la["ck"][1], la["cv"][1], la["mem_bias"], w1, 12,
        heads=heads))
    say("  small-row kernels (graph replay): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in small.items()))
    means = []
    check_stack_routes(fw, heads, tm, means)
    check_whole_routes(fw, heads, tm, means)
    say(f"  route checks passed, worst mean abs difference {max(means):.6f}")
    for b, k, seed in ((BATCH, BEAM_K, SEED + 51), (8, 16, SEED + 52)):
        try:
            check_beam_loop(model, fw, b, k, seed)
        except SystemExit:
            say(f"  beam loop B={b} K={k}: failed (above)")
    lib = load_library()
    names = ("qkv", "self", "wo", "ln1", "wcq", "cross", "wco", "ln2", "w1", "w2", "ln3")
    if hasattr(lib, "vct_small_stamps"):   # a copy built with VCT_SMALL_STAMPS
        a = step_inputs(fw, 32, 12, tm, gen=4032)
        args = (a["x"], a["kc"], a["vc"], a["ck"], a["cv"], a["mem_bias"])
        per = {}
        for _ in range(5):
            dk.fused_whole_step(*args, fw, 12, heads=heads, l_view=16)
            torch.cuda.synchronize()
            stamps = (ctypes.c_ulonglong * 257)()
            if lib.vct_small_stamps(stamps) != 0:
                fail("vct_small_stamps failed")
            for i in range(int(stamps[0]) - 1):
                per.setdefault(i, []).append((stamps[i + 2] - stamps[i + 1]) / 1e3)
        med = [sorted(v)[len(v) // 2] for v in per.values()]
        labels = [f"L{li}.{n}" for li in range(fw["stacked"]["wqkv"].shape[0]) for n in names]
        labels[-1] = "ln3+split"
        say("  whole step at B=32, µs per phase (block 0, median of 5, after each barrier): "
            + "; ".join(f"{k} {v:.1f}" for k, v in zip(labels + ["walk"], med)))
        # the sequence kernel's first tokens: the embedding pass, 11 phases a
        # layer, the split and the walk
        sa = step_inputs(fw, 32, 0, tm, gen=4232)
        dk.fused_sequence_decode(fw["emb"], fw["pe"], sa["ck"], sa["cv"], sa["mem_bias"], fw,
                                 **skw)
        torch.cuda.synchronize()
        if lib.vct_small_stamps(stamps) != 0:
            fail("vct_small_stamps failed")
        per_tok = 2 + 11 * fw["stacked"]["wqkv"].shape[0]
        ts = [stamps[i + 1] for i in range(int(stamps[0]))]
        say("  sequence kernel at B=32, µs per token (block 0's stamps, tokens 0-"
            f"{(len(ts) - 1) // per_tok - 1}): "
            + ", ".join(f"{(ts[(j + 1) * per_tok] - ts[j * per_tok]) / 1e3:.1f}"
                        for j in range((len(ts) - 1) // per_tok)))
    if not hasattr(lib, "vct_stack_stamps"):
        return
    nl = fw["stacked"]["wqkv"].shape[0]
    for b in (128, BEAM_ROWS):
        a = step_inputs(fw, b, 12, tm, gen=4001)
        args = (a["x"], a["kc"], a["vc"], a["ck"], a["cv"], a["mem_bias"], fw["stacked"])
        per = {}
        for _ in range(3):
            dk.fused_layers_step(*args, 12, heads=heads, l_view=16)
            torch.cuda.synchronize()
            stamps = (ctypes.c_ulonglong * 128)()
            if lib.vct_stack_stamps(stamps) != 0:
                fail("vct_stack_stamps failed")
        for i in range(11 * nl):
            per.setdefault(names[i % 11], []).append(round((stamps[i + 1] - stamps[i]) / 1e3, 2))
        say(f"  phases at {b} rows, µs per layer (block 0, after each barrier): "
            + "; ".join(f"{k} {v}" for k, v in per.items()))


def profile_decode(model, fw, card):
    """Where one caption's time goes at B=1 in each greedy mode: ms per
    caption without the profiler, then torch.profiler over 3 captions for the
    device's busy time by kernel. The idle share sets the busy time against
    the unprofiled caption, since the profiler slows the host."""
    from vct_tpu_torch.decode_fast import greedy_generate_fused

    feats, masks = eval_inputs(1, fw["wg"].device, SEED + 70)
    kw = dict(max_len=30, start_id=101, end_id=-1, fw=fw)
    with torch.no_grad():
        for label, mode in (("per_token", {}), ("multi_u2", dict(multi_step=2)),
                            ("multi_u4", dict(multi_step=4)),
                            ("sequence", dict(sequence_kernel=True))):
            def fn():
                return greedy_generate_fused(model, feats, masks, **mode, **kw)

            ms = host_time(fn, reps=5)
            rows, _ = device_rows(fn, 3)
            busy = sum(r[1] for r in rows)
            say(f"profile of a B=1 caption, {label} [{card}]: {ms:.3f} ms unprofiled, device "
                f"busy {busy:.3f} ms, idle share {1 - busy / ms:.2f}, "
                f"{sum(r[2] for r in rows):.0f} kernels per caption")
            for key, k_ms, count in sorted(rows, key=lambda r: -r[1])[:4]:
                say(f"  {k_ms:8.3f} ms/caption  {count:6.1f}/caption  {key[:90]}")


# ---------------------------------------------------------------------------
# phases 12-16: the attention kernels, the long-video recipe, the encoder
# families
# ---------------------------------------------------------------------------

ATTN_SOURCE = "vct_tpu_torch/csrc/attention.cu"
ATTN_REPLACES = {
    "fused_attention": "vct_tpu/ops/pallas_attention.py:81",
    "fused_attention_trainable": "vct_tpu/ops/pallas_attention.py:271",
}
# The long-video recipe: configs/msvd.json with these fields changed.
LONG_FRAMES, LONG_CAPTION, LONG_BATCH = 255, 129, 32
LONG_TRAIN_STEPS, LONG_VAL_STEPS = 10, 1
LONG_B, LONG_H, LONG_D = LONG_BATCH, 8, 96
# name -> (Tq, Tk, bias kind) at B=32, H=8, D=96: what one long train step runs
LONG_SHAPES = {
    "encoder_self": (LONG_FRAMES + 1, LONG_FRAMES + 1, "padding"),
    "decoder_self": (LONG_CAPTION - 1, LONG_CAPTION - 1, "rows"),
    "decoder_cross": (LONG_CAPTION - 1, LONG_FRAMES + 1, "padding"),
}
RAGGED_SHAPES = [(31, 13, 2, 96), (13, 13, 8, 96), (8, 16, 4, 64), (37, 200, 2, 128)]
# Forward: kernel and plain version round at the same points (float32 logits
# and softmax, weights rounded to the value dtype, float32 accumulation,
# output rounded) and differ by summation order: 2e-5 in float32 on outputs of
# magnitude ~1; in bfloat16 one unit (0.02 at magnitudes up to 2), almost all
# values equal (mean 1e-3). Backward, float32: 1e-4 of the largest gradient.
# Backward, bfloat16: the kernel rounds P, the dropped P and dS to bfloat16
# for the tensor cores where the plain version keeps them float32 (2**-9
# relative per element, averaged down over the sum): 2% of the largest value.
ATTN_FWD_ATOL = {torch.float32: 2e-5, torch.bfloat16: 0.02}
ATTN_FWD_MEAN = {torch.float32: 2e-6, torch.bfloat16: 1e-3}
ATTN_GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def attn_inputs(dev, dt, b, tq, tk, h, d, bias_kind, rate, seed):
    """Seeded q, k, v, dO, the framework's bias of that kind and a keep mask."""
    from vct_tpu_torch.ops.attention import causal_bias, combine_bias, padding_bias

    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(s, generator=g).to(dev, dt)
                   for s in ((b, tq, h, d), (b, tk, h, d), (b, tk, h, d), (b, tq, h, d)))
    bias = None
    if bias_kind is not None:
        pad = torch.zeros((b, tk), dtype=torch.bool)
        pad[1::2, tk - tk // 3:] = True  # odd rows end in padding
        bias = padding_bias(pad.to(dev))
        if bias_kind == "rows":
            bias = combine_bias(causal_bias(tq, device=dev), bias)
    keep = None
    if rate > 0:
        keep = (torch.rand((b, h, tq, tk), generator=g) >= rate).to(dev)
    return q, k, v, do, bias, keep


def attn_compare(name, args, rate, dt, plain):
    """Both kernels against their plain versions ``plain`` = (forward,
    backward) -> (forward, backward) max abs differences."""
    from vct_tpu_torch.ops import attention_kernels as ak

    q, k, v, do, bias, keep = args
    want = plain[0](q, k, v, bias, keep, rate)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ak.fused_attention_trainable(*leaves, bias, keep, rate)
    out.backward(do)
    torch.cuda.synchronize()
    out = out.detach()
    fwd = max_err(f"{name} forward", out, want, ATTN_FWD_ATOL[dt])
    if float((out.float() - want.float()).abs().mean()) > ATTN_FWD_MEAN[dt]:
        fail(f"{name} forward: mean difference above {ATTN_FWD_MEAN[dt]}")
    if rate == 0.0:
        fwd = max(fwd, max_err(f"{name} inference", ak.fused_attention(q, k, v, bias), want,
                               ATTN_FWD_ATOL[dt]))
    bwd = 0.0
    refs = plain[1](q, k, v, bias, keep, rate, do)
    for label, leaf, ref in zip(("dq", "dk", "dv"), leaves, refs):
        bwd = max(bwd, abs_and_rel(f"{name} {label}", leaf.grad, ref, ATTN_GRAD_REL[dt])[0])
    return fwd, bwd


def check_attention_kernels(dev):
    from vct_tpu_torch.ops import attention_kernels as ak

    errs = {"fused_attention": 0.0, "fused_attention_trainable": 0.0}
    worst_bwd = 0.0
    plain = (ak.fused_attention_trainable_reference, ak.fused_attention_backward_reference)
    with no_plain_on_cuda("attn-kernels", ak):
        cases = [(torch.bfloat16, LONG_B, tq, tk, LONG_H, LONG_D, kind, name)
                 for name, (tq, tk, kind) in LONG_SHAPES.items()]
        cases += [(torch.float32, 2, tq, tk, h, d, "rows" if tq == tk else "padding",
                   f"ragged {tq}x{tk}x{h}x{d}") for tq, tk, h, d in RAGGED_SHAPES]
        cases += [(torch.bfloat16, 2, 70, 130, 2, 96, None, "no bias"),
                  (torch.float32, 2, 37, 200, 2, 128, None, "no bias float32")]
        for i, (dt, b, tq, tk, h, d, kind, name) in enumerate(cases):
            for rate in (0.0, 0.3):
                args = attn_inputs(dev, dt, b, tq, tk, h, d, kind, rate, seed=100 + i)
                label = f"attention {name} {str(dt).split('.')[1]} rate {rate}"
                fwd, bwd = attn_compare(label, args, rate, dt, plain)
                errs["fused_attention_trainable"] = max(errs["fused_attention_trainable"], fwd)
                if rate == 0.0:
                    errs["fused_attention"] = max(errs["fused_attention"], fwd)
                worst_bwd = max(worst_bwd, bwd)
            say(f"  ok {name} ({str(dt).split('.')[1]}, B={b}, Tq={tq}, Tk={tk}, H={h}, D={d}): "
                f"forward and backward, rate 0 and 0.3")
        # a fully masked row: uniform over the real keys, and a finite gradient
        q, k, v, do, _, _ = attn_inputs(dev, torch.float32, 2, 33, 45, 2, 64, None, 0.0, 7)
        bias = torch.zeros((2, 2, 33, 45), device=dev)
        bias[0, 1, 5] = ak.NEG_INF
        out = ak.fused_attention(q, k, v, bias)
        max_err("attention fully masked row", out[0, 5, 1], v[0, :, 1].mean(dim=0), 2e-6)
        attn_compare("attention fully masked row", (q, k, v, do, bias, None), 0.0,
                     torch.float32, plain)
        # no atomics: the same bits from two runs
        args = attn_inputs(dev, torch.bfloat16, 8, 128, 256, LONG_H, LONG_D, "padding", 0.3, 9)
        runs = []
        for _ in range(2):
            leaves = [t.clone().requires_grad_() for t in args[:3]]
            out = ak.fused_attention_trainable(*leaves, args[4], args[5], 0.3)
            out.backward(args[3])
            runs.append([out.detach()] + [t.grad for t in leaves])
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(*runs)):
            fail("attention: two runs of forward and backward gave different bits")
    routes = check_attention_routes(dev)
    errs["fused_attention"] = max(errs["fused_attention"], routes)
    errs["fused_attention_trainable"] = max(errs["fused_attention_trainable"], routes)
    worst_bwd = max(worst_bwd, check_attention_backward_routes(dev))
    for bad, why in ((torch.zeros((1, 128, 2, 100), device=dev), "head width 100"),
                     (torch.zeros((1, 128, 2, 256), device=dev), "head width 256"),
                     (torch.zeros((1, 128, 2, 64), device=dev, dtype=torch.float16), "float16")):
        before = [ak.fused_attention.launches, ak.fused_attention_trainable.launches]
        try:
            ak.fused_attention_trainable(bad, bad, bad)
        except (ValueError, TypeError):
            pass
        else:
            fail(f"attention: {why} is outside the kernels' span and did not raise")
        if [ak.fused_attention.launches, ak.fused_attention_trainable.launches] != before:
            fail(f"attention: {why} launched a kernel before it raised")
    say(f"  ok a fully masked row, the same bits twice, three shapes that raise; max abs "
        f"differences {errs}, backward {worst_bwd:.4g}")
    return errs, {"backward_max_abs_err": worst_bwd}


def check_attention_routes(dev):
    """The bfloat16 forward at ragged shapes on both routes of the shape rule
    (logits on chip, two passes), with and without bias and keep mask, against
    the plain version; the two routes' statistics against each other; the same
    bits from two runs; a Tk past the on-chip limit through the wrappers ->
    the largest forward difference."""
    from vct_tpu_torch.ops import attention_kernels as ak

    dt, worst = torch.bfloat16, 0.0
    for tk in (100, 255, 257):
        for kind in (None, "padding"):
            for rate in (0.0, 0.3):
                q, k, v, _, bias, keep = attn_inputs(dev, dt, 2, 70, tk, 2, LONG_D, kind, rate,
                                                     seed=300 + tk)
                want = ak.fused_attention_trainable_reference(q, k, v, bias, keep, rate)
                stats = []
                for route in (1, 0):
                    name = f"attention Tk={tk} bias {kind} rate {rate} route {route}"
                    out, st = ak._launch_forward(q, k, v, bias, keep, rate, True, route)
                    again, st2 = ak._launch_forward(q, k, v, bias, keep, rate, True, route)
                    torch.cuda.synchronize()
                    worst = max(worst, max_err(name, out, want, ATTN_FWD_ATOL[dt]))
                    if float((out.float() - want.float()).abs().mean()) > ATTN_FWD_MEAN[dt]:
                        fail(f"{name}: mean difference above {ATTN_FWD_MEAN[dt]}")
                    if not (torch.equal(out, again) and torch.equal(st, st2)):
                        fail(f"{name}: two runs gave different bits")
                    stats.append(st)
                # row max and row sum: float32 on both routes, other summation orders
                max_err(f"attention Tk={tk} bias {kind} statistics of the two routes",
                        stats[0], stats[1], 1e-4 * float(stats[1].abs().max()))
    # past the on-chip limit the shape rule takes the two-pass route; asking
    # for the on-chip route there makes the launcher refuse before any launch
    tk = 800
    for keys, route in ((tk, 0), (256, 1)):
        plan = library_plan("vct_attn_forward_plan", 1, keys, LONG_D, 1, -1, n=6)
        if plan[0] != route or plan != tuple(ak.attention_forward_plan(keys, LONG_D, dt, True)):
            fail(f"attention: the launcher plans {plan} for Tk={keys}, expected route {route} "
                 f"and the Python mirror's plan")
    q, k, v, do, bias, keep = attn_inputs(dev, dt, 2, 70, tk, 2, LONG_D, "padding", 0.3, seed=77)
    plain = (ak.fused_attention_trainable_reference, ak.fused_attention_backward_reference)
    worst = max(worst, attn_compare(f"attention Tk={tk} (two-pass route)",
                                    (q, k, v, do, bias, keep), 0.3, dt, plain)[0])
    try:
        ak._launch_forward(q, k, v, bias, keep, 0.3, True, 1)
    except RuntimeError:  # the launcher's refusal
        pass
    else:
        fail(f"attention: the on-chip route took Tk={tk}, past its shared memory")
    say(f"  ok both forward routes at Tk=100, 255, 257 (bias, keep mask, same bits twice, "
        f"statistics), Tk={tk} by the shape rule; max abs difference {worst:.4g}")
    return worst


# (B, Tq, Tk, H, D) of the bfloat16 backward's route check: ragged in both
# lengths, the three widths, Tk at the route's limit (320 at D = 96)
BWD_ROUTE_SHAPES = [(2, 31, 13, 2, 96), (2, 13, 13, 8, 96), (2, 100, 100, 2, 96),
                    (1, 37, 200, 2, 128), (2, 70, 255, 2, 16), (1, 65, 320, 2, 96)]


def check_attention_backward_routes(dev):
    """The bfloat16 backward on the route with its products in registers (1)
    at ragged shapes, every bias kind (none, a [B,1,1,Tk] padding bias, a
    [B,1,T,T] causal one, a full [B,H,Tq,Tk] one with a fully masked row),
    keep mask on and off, against the plain version and against the pair it
    replaced (route 0), under ATTN_GRAD_REL; the same bits from two runs; the
    plan against the launcher at its boundary -> the largest gradient
    difference. Also printed, each as a share of the largest plain gradient:
    the new route against the plain version, the replaced pair (which divides
    per element where the new route multiplies by a reciprocal, as the plain
    version divides) against the plain version, and new against replaced."""
    from vct_tpu_torch.ops import attention_kernels as ak

    dt, worst, n = torch.bfloat16, 0.0, 0
    share = {"new": 0.0, "replaced": 0.0, "new_vs_replaced": 0.0}
    for b, tq, tk, h, d in BWD_ROUTE_SHAPES:
        for kind in (None, "padding", "rows", "full"):
            if kind == "rows" and tq != tk:
                continue
            for rate in (0.0, 0.3):
                q, k, v, do, bias, keep = attn_inputs(dev, dt, b, tq, tk, h, d,
                                                      None if kind == "full" else kind, rate,
                                                      seed=400 + tq + tk)
                if kind == "full":
                    g = torch.Generator().manual_seed(tq)
                    bias = torch.randn((b, h, tq, tk), generator=g).to(dev)
                    bias[0, h - 1, tq // 2] = ak.NEG_INF  # a fully masked row
                _, stats = ak._launch_forward(q, k, v, bias, keep, rate, True)
                new = ak._launch_backward(q, k, v, bias, keep, rate, do, stats, 1)
                again = ak._launch_backward(q, k, v, bias, keep, rate, do, stats, 1)
                old = ak._launch_backward(q, k, v, bias, keep, rate, do, stats, 0)
                want = ak.fused_attention_backward_reference(q, k, v, bias, keep, rate, do)
                torch.cuda.synchronize()
                name = f"attention backward {b}x{tq}x{tk}x{h}x{d} bias {kind} rate {rate}"
                for label, got, prev, ref, rep in zip(("dq", "dk", "dv"), new, old, want, again):
                    worst = max(worst, abs_and_rel(f"{name} {label}", got, ref,
                                                   ATTN_GRAD_REL[dt])[0])
                    abs_and_rel(f"{name} {label} against the replaced kernels", got, prev,
                                ATTN_GRAD_REL[dt])
                    if not torch.equal(got, rep):
                        fail(f"{name} {label}: two runs gave different bits")
                    top = max(float(ref.float().abs().max()), 1e-30)
                    for key, a, c in (("new", got, ref), ("replaced", prev, ref),
                                      ("new_vs_replaced", got, prev)):
                        share[key] = max(share[key],
                                         float((a.float() - c.float()).abs().max()) / top)
                n += 1
    for tk, route, rows in ((320, 1, 64), (321, 0, 64)):
        plan = library_plan("vct_attn_backward_plan", 1, tk, LONG_D, 1, -1, n=7)
        if plan[:2] != (route, rows) or plan != tuple(
                ak.attention_backward_plan(tk, LONG_D, dt, True)):
            fail(f"attention backward: the launcher plans {plan} for Tk={tk}, expected route "
                 f"{route} with {rows}-row tiles and the Python mirror's plan")
    say(f"  ok the bfloat16 backward's on-chip route in {n} cases (shapes {BWD_ROUTE_SHAPES}, "
        f"four bias kinds, keep mask on and off) against the plain version and the replaced "
        f"kernels, same bits twice, its plan at Tk=320 / 321; max abs gradient "
        f"difference {worst:.4g}; as a share of the largest gradient: new against plain "
        f"{share['new']:.4g}, replaced against plain {share['replaced']:.4g}, new against "
        f"replaced {share['new_vs_replaced']:.4g} (limit {ATTN_GRAD_REL[dt]})")
    return worst


def attention_counts():
    from vct_tpu_torch.ops import attention_kernels as ak

    return {"fused_attention": ak.fused_attention.launches,
            "fused_attention_trainable": ak.fused_attention_trainable.launches,
            "fused_attention_trainable_backward": ak.fused_attention_trainable.backward_launches}


def reset_attention_counts():
    from vct_tpu_torch.ops import attention_kernels as ak

    ak.fused_attention.launches = 0
    ak.fused_attention_trainable.launches = 0
    ak.fused_attention_trainable.backward_launches = 0


# ---- the long-video recipe ------------------------------------------------------


def write_long_dataset(root: Path) -> None:
    """A seeded long-video workspace under ``root``: videos of 100-400 frames
    x 512 (those above 255 are subsampled, those below padded, so the mask is
    used) and captions of 40-140 words (some cut at 129 positions). 40 train
    videos x 8 captions give LONG_TRAIN_STEPS batches of 32, 4 validation
    videos x 8 give one."""
    rng = np.random.default_rng(SEED + 4)
    words = [f"w{i}" for i in rng.choice(np.arange(1000, 30522), 40, replace=False)]
    for split, n_vid in (("train", LONG_TRAIN_STEPS * LONG_BATCH // 8),
                         ("val", LONG_VAL_STEPS * LONG_BATCH // 8)):
        feat_dir = root / "feats" / split
        feat_dir.mkdir(parents=True)
        lines = []
        for i in range(n_vid):
            np.save(feat_dir / f"{split}{i}.npy",
                    rng.standard_normal((int(rng.integers(100, 401)), 512)).astype(np.float32))
            for _ in range(8):
                cap = " ".join(rng.choice(words, int(rng.integers(40, 141))))
                lines.append(f"{split}{i} {cap}")
        (root / f"{split}.txt").write_text("\n".join(lines))


def long_config(repo: Path, root: Path, vocab: Path, *, eval_split: str = "val",
                **tpu) -> Path:
    """configs/msvd.json as the long-video recipe (``tpu.max_frames`` 255,
    ``tpu.max_caption_len`` 129, batch 32 in every split) on the long
    workspace's paths -> file."""
    cfg = json.loads(train_config(repo, root, vocab, 1, max_frames=LONG_FRAMES,
                                  max_caption_len=LONG_CAPTION, **tpu).read_text())
    for name in ("train", "validation", "eval"):
        cfg["data"][name]["batch_size"] = LONG_BATCH
    cfg["data"]["eval"]["feat_dir"] = [str(root / "feats" / eval_split)]
    cfg["data"]["eval"]["annotation_path"] = str(root / f"{eval_split}.txt")
    cfg["train"]["tag"] = "long"
    path = root / ("_".join(["long", eval_split] + [f"{k}{v}" for k, v in tpu.items()])
                   + ".json")
    path.write_text(json.dumps(cfg))
    return path


def long_trainer(repo, root, vocab, dev, **tpu):
    from vct_tpu_torch.cli.common import load_config
    from vct_tpu_torch.train.loop import Trainer

    return Trainer(load_config(str(long_config(repo, root, vocab, **tpu))), device=dev,
                   log=lambda *_: None)


def run_long_training(repo: Path, root: Path, vocab: Path):
    """The long recipe through vct_tpu_torch.cli.train's main: one epoch of
    LONG_TRAIN_STEPS steps, a validation pass, an eval decode, a checkpoint
    -> launch counts of the attention kernels."""
    import vct_tpu_torch.train.loop as loop
    from vct_tpu_torch.cli import train as train_cli
    from vct_tpu_torch.ops import attention_kernels as ak
    from vct_tpu_torch.ops import decode_kernels as dk
    from vct_tpu_torch.ops import loss_kernels as lk

    losses = []
    make_train = loop.make_train_step

    def recording_train(task):
        step = make_train(task)

        def wrapped(state, batch):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
            return state, metrics

        return wrapped

    loop.make_train_step = recording_train
    try:
        with no_plain_on_cuda("long-train", ak), no_plain_on_cuda("long-train", lk):
            for fn in lk.WRAPPERS + dk.WRAPPERS:
                fn.launches = 0
            reset_attention_counts()
            scores = train_cli.main(["-c", str(long_config(repo, root, vocab)),
                                     "--no_tensorboard"])
            torch.cuda.synchronize()
    finally:
        loop.make_train_step = make_train
    counts = attention_counts()
    loss_launches = {fn.__name__: fn.launches for fn in lk.WRAPPERS}
    steps, val = LONG_TRAIN_STEPS, LONG_VAL_STEPS
    # a train step: 1 encoder + 3 x (self, cross) trainable launches forward and
    # as many backward; a validation step the same seven on the inference
    # kernel; the eval decode's encoder one per batch (its 29 decode steps are
    # single-query and run fused_whole_step), and one more for the sample
    # caption the Trainer prints after the epoch
    want = {"fused_attention": 7 * val + 1 + 1, "fused_attention_trainable": 7 * steps,
            "fused_attention_trainable_backward": 7 * steps}
    want_loss = {"softmax_stats": steps + val, "clipped_prob_stats": steps + val,
                 "sce_backward_tiles": steps}
    values = [float(v) for v in losses]
    if len(values) != steps:
        fail(f"long-train: {len(values)} train steps, expected {steps}")
    if counts != want:
        fail(f"long-train: attention launches {counts}, expected {want}")
    if loss_launches != want_loss:
        fail(f"long-train: loss kernel launches {loss_launches}, expected {want_loss}")
    if dk.fused_whole_step.launches == 0:
        fail("long-train: the eval decode never launched fused_whole_step")
    if not all(math.isfinite(v) for v in values):
        fail(f"long-train: a loss is not finite: {values}")
    head, tail = sum(values[:3]) / 3, sum(values[-3:]) / 3
    if not tail < head:
        fail(f"long-train: the loss did not fall: first three {head}, last three {tail}")
    if not (root / "ckpt" / "long_latest.pt").is_file() or \
            set(scores) < {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr"}:
        fail(f"long-train: no checkpoint or no scores ({scores})")
    say(f"  {steps} train steps at batch {LONG_BATCH}: loss {head:.4f} (first three) -> "
        f"{tail:.4f} (last three); attention launches {counts}; loss kernel launches "
        f"{loss_launches}; eval decode fused_whole_step launches "
        f"{dk.fused_whole_step.launches}")
    return counts


def check_long_step0_routes(repo, root, vocab, dev):
    """Step 0 of the long recipe with the same weights, batch and generator
    seed (so the same dropout masks) with the attention kernels on and off:
    loss within 1e-3 relative, every gradient within 3% of its largest value
    (bfloat16 values one unit apart move single elements that far; the loss
    kernels' own limit). With the flag off no attention kernel is launched."""
    grads, losses, counts = [], [], []
    for kernels in (True, False):
        tr = long_trainer(repo, root, vocab, dev, use_pallas_attention=kernels)
        batch = first_batch(tr)
        tr.model.train()
        reset_attention_counts()
        loss = tr.model.caption_loss(batch["feats"], batch["masks"], batch["token_ids"],
                                     batch["token_mask"], row_valid=batch["row_valid"])
        loss.backward()
        torch.cuda.synchronize()
        counts.append(attention_counts())
        losses.append(float(loss.detach()))
        grads.append(caption_grads(tr.model))
    if counts[0] != {"fused_attention": 0, "fused_attention_trainable": 7,
                     "fused_attention_trainable_backward": 7} or any(counts[1].values()):
        fail(f"long step 0: attention launches {counts[0]} with the kernels on, "
             f"{counts[1]} with them off")
    if abs(losses[0] - losses[1]) > 1e-3 * abs(losses[1]):
        fail(f"long step 0: loss {losses[0]} with the attention kernels, {losses[1]} without")
    worst = 0.0
    for k, ref in grads[1].items():
        worst = max(worst, rel_err(f"long step 0 gradient {k}", grads[0][k], ref, 3e-2))
    say(f"  step 0: loss {losses[0]:.6f} (attention kernels) vs {losses[1]:.6f} (math path), "
        f"worst gradient difference {worst:.3g} of its largest value, {len(grads[1])} "
        f"parameters; launches {counts[0]} on, {counts[1]} off")


def run_long_eval(repo: Path, root: Path, vocab: Path, ckpt: Path, dev, card: str):
    """vct_tpu_torch.cli.eval greedy on the long recipe (the train split's 40
    videos, two batches), then one batch's tokens against the module path of
    a model with the kernels off."""
    from vct_tpu_torch.cli import eval as eval_cli
    from vct_tpu_torch.cli.common import load_checkpoint_into, load_config, make_trainer_pieces
    from vct_tpu_torch.decode import make_auto_greedy_fn
    from vct_tpu_torch.ops import attention_kernels as ak
    from vct_tpu_torch.ops import decode_kernels as dk

    n_videos = LONG_TRAIN_STEPS * LONG_BATCH // 8
    n_batches = -(-n_videos // LONG_BATCH)
    cfg_path = long_config(repo, root, vocab, eval_split="train")
    out = root / "pred_long.json"
    reset_launches()
    reset_attention_counts()
    t0 = time.perf_counter()
    with no_plain_on_cuda("long-eval", ak), no_plain_on_cuda("long-eval", dk):
        scores = eval_cli.main(["-c", str(cfg_path), "-m", str(ckpt), "--out", str(out)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, decode = attention_counts(), read_launches()
    preds = json.loads(out.read_text())
    if len(preds) != n_videos or not all(math.isfinite(float(v)) for v in scores.values()):
        fail(f"long-eval: {len(preds)} predictions for {n_videos} videos, scores {scores}")
    if counts != {"fused_attention": n_batches, "fused_attention_trainable": 0,
                  "fused_attention_trainable_backward": 0}:
        fail(f"long-eval: attention launches {counts}, expected one per batch ({n_batches})")
    if not n_batches <= decode["fused_whole_step"] <= 29 * n_batches:
        fail(f"long-eval: decode launches {decode}")
    say(f"  long eval greedy: {n_videos} videos in {seconds:.2f} s with loading and scoring, "
        f"attention launches {counts}, fused_whole_step {decode['fused_whole_step']} [{card}]")

    models = []
    for kernels in (True, False):
        cfg = load_config(str(long_config(repo, root, vocab, eval_split="train",
                                          use_pallas_attention=kernels)))
        model, _ = make_trainer_pieces(cfg, dev)
        load_checkpoint_into(model, str(ckpt), log=lambda *_: None, cfg=cfg)
        models.append(model.to_compute_dtype())
    g = torch.Generator().manual_seed(SEED + 40)
    feats = [torch.randn((LONG_BATCH, LONG_FRAMES, 512), generator=g).to(dev)]
    masks = [(torch.arange(LONG_FRAMES)[None, :]
              >= torch.randint(100, LONG_FRAMES + 1, (LONG_BATCH, 1), generator=g)).to(dev)]
    reset_attention_counts()
    got, _ = make_auto_greedy_fn(models[0], 30, 101, 102)(feats, masks)
    on = attention_counts()
    off_fn = make_auto_greedy_fn(models[1], 30, 101, 102)
    reset_launches()
    off_fn(feats, masks)
    if on["fused_attention"] != 1 or any(attention_counts()[k] != on[k] for k in on) \
            or any(read_launches().values()):
        fail(f"long-eval: launches {on} with the kernels on; with them off attention "
             f"{attention_counts()}, decode {read_launches()}")
    check_against_module(models[1], feats, masks, got, "long eval, kernels on vs off")
    return counts, {"long_eval_seconds": seconds}


# ---- the other encoder families ---------------------------------------------------


def encoder_model(repo, vocab, dev, dtype, kernels, video_encoder, modal_shape, **mme):
    """configs/msvd.json's model with ``video_encoder`` fields, ``mme`` fields
    and the modalities replaced, seeded weights."""
    from vct_tpu_torch.cli.common import load_config, make_trainer_pieces

    cfg = load_config(str(repo / "configs" / "msvd.json"))
    ve = cfg.model.video_encoder
    ve = dataclasses.replace(ve, mme=dataclasses.replace(ve.mme, **mme), **video_encoder)
    model_cfg = dataclasses.replace(
        cfg.model, video_encoder=ve, modal=[f"m{i}" for i in range(len(modal_shape))],
        modal_shape=list(modal_shape))
    cfg = cfg.replace(model=model_cfg, tpu=dataclasses.replace(
        cfg.tpu, vocab_path=str(vocab), dtype=dtype, use_pallas_attention=kernels))
    model, _ = make_trainer_pieces(cfg, torch.device("cpu"), seed=SEED + 5)
    return model.to(dev)


def check_encoders(repo, vocab, dev):
    """HMME (512 + 1024 wide, layers (2, 1), 127 + 127 frames -> 256 tokens)
    and SimpleSep (two modalities of 128 frames) at the MSVD width in
    bfloat16: caption loss and one backward on the kernel route against the
    math route (same weights, no dropout: eval mode); then an MME encode with
    biGRU aggregation in float32 against the CPU result."""
    from vct_tpu_torch.ops import attention_kernels as ak

    g = torch.Generator().manual_seed(SEED + 6)
    tokens = torch.randint(1000, 30000, (8, LONG_CAPTION), generator=g).to(dev, torch.int32)
    tokens[:, 0] = 101
    tokens[1::2, 90:] = 0
    for label, ve, frames, want in (
            # 3 decoder layers x (self, cross) and two encoder attentions each:
            # HMME's shared stack is max(2, 1) layers deep, SimpleSep runs one
            # layer per modality
            ("hmme", {"type": "hmme", "layer": (2, 1)}, 127, (6 + 2, 6 + 2)),
            ("simple", {"type": "simple", "layer": 1}, 128, (6 + 2, 6 + 2))):
        feats = [torch.randn((8, frames, w), generator=g).to(dev) for w in (512, 1024)]
        masks = [(torch.arange(frames)[None, :] >= n).to(dev) for n in
                 (torch.randint(60, frames + 1, (8, 1), generator=g),
                  torch.randint(60, frames + 1, (8, 1), generator=g))]
        outs = []
        for kernels in (True, False):
            model = encoder_model(repo, vocab, dev, "bfloat16", kernels, ve, (512, 1024))
            reset_attention_counts()
            with no_plain_on_cuda(f"encoders {label}", ak):
                loss = model.caption_loss(feats, masks, tokens, tokens == 0)
                loss.backward()
            torch.cuda.synchronize()
            counts = attention_counts()
            got = (counts["fused_attention_trainable"],
                   counts["fused_attention_trainable_backward"])
            if got != (want if kernels else (0, 0)) or counts["fused_attention"]:
                fail(f"encoders {label}: attention launches {counts} with kernels={kernels}")
            outs.append((float(loss.detach()),
                         caption_grads(model)))
        if not math.isfinite(outs[0][0]) or abs(outs[0][0] - outs[1][0]) > 1e-3 * abs(outs[1][0]):
            fail(f"encoders {label}: loss {outs[0][0]} on the kernel route, {outs[1][0]} on "
                 f"the math route")
        worst = max(rel_err(f"encoders {label} gradient {k}", outs[0][1][k], ref, 3e-2)
                    for k, ref in outs[1][1].items())
        say(f"  ok {label}: loss {outs[0][0]:.6f} vs {outs[1][0]:.6f}, worst gradient "
            f"difference {worst:.3g} of its largest value, {want[0]} + {want[1]} attention "
            f"launches")
    cpu = encoder_model(repo, vocab, torch.device("cpu"), "float32", True, {}, (512,),
                        aggregation="biGRU")
    feats = [torch.randn((4, 12, 512), generator=g)]
    masks = [torch.arange(12)[None, :] >= torch.tensor([[12], [7], [12], [3]])]
    with torch.no_grad():
        mem_cpu, _, agg_cpu = cpu.encode(feats, masks)
        card_model = cpu.to(dev)
        mem, _, agg = card_model.encode([f.to(dev) for f in feats], [m.to(dev) for m in masks])
    err = max(max_err("encoders biGRU memory", mem.cpu(), mem_cpu, 1e-4),
              max_err("encoders biGRU aggregate", agg.cpu(), agg_cpu, 1e-4))
    say(f"  ok MME with biGRU aggregation, card against CPU in float32: max abs difference "
        f"{err:.3g}")


# ---- timings ---------------------------------------------------------------------------


def time_attention(dev, card):
    """name -> the kernels' line entries, and a report of every shape: kernel
    forward and backward ms (CUDA events), the bound, the plain version, the
    math path (dot_product_attention with the kernels off) and
    F.scaled_dot_product_attention with the same mask (timed only)."""
    import torch.nn.functional as F

    from vct_tpu_torch.models.layers import Dropout, DropoutRng
    from vct_tpu_torch.ops import attention_kernels as ak
    from vct_tpu_torch.ops.attention import dot_product_attention

    dt = torch.bfloat16
    b, h, d = LONG_B, LONG_H, LONG_D
    report, per_shape = {}, {}
    for name, (tq, tk, kind) in LONG_SHAPES.items():
        q, k, v, do, bias, keep = attn_inputs(dev, dt, b, tq, tk, h, d, kind, 0.3, seed=50)
        cells = b * h
        fwd_bound = bound_ms(nbytes(q, k, v, bias) + nbytes(q), 4.0 * tq * tk * d * cells, dt)
        drop_bound = bound_ms(nbytes(q, k, v, bias, keep) + nbytes(q),
                              4.0 * tq * tk * d * cells, dt)
        bwd_bound = bound_ms(nbytes(q, k, v, do, bias, keep) + nbytes(q, k, v),
                             10.0 * tq * tk * d * cells, dt)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        drop = Dropout(0.3, DropoutRng(torch.Generator(device=dev).manual_seed(1))).train()
        mask = bias.to(dt)
        qt, kt, vt = (t.transpose(1, 2) for t in leaves)

        def kernel_train():
            return ak.fused_attention_trainable(*leaves, bias, keep, 0.3)

        def math_train():
            return dot_product_attention(*leaves, bias, dropout=drop)[0]

        def lib_train():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, dropout_p=0.3)

        def with_backward(fn, grad):
            def run():
                for t in leaves:
                    t.grad = None
                fn().backward(grad)
            return run

        def lib_inference():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask)

        # Device times (CUDA graph replay) for the forward kernel, the two-pass
        # kernel it replaced (still the route past the on-chip limit) and the
        # library call: kernel, previous, library, library, previous, kernel.
        with torch.no_grad():
            runs = {
                "inference": lambda: ak.fused_attention(q, k, v, bias),
                "inference_previous": lambda: ak._launch_forward(
                    q, k, v, bias, None, 0.0, False, 0),
                "inference_library": lib_inference,
                "forward": lambda: ak._launch_forward(q, k, v, bias, keep, 0.3, True),
                "forward_previous": lambda: ak._launch_forward(q, k, v, bias, keep, 0.3, True, 0),
                "forward_library": lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, dropout_p=0.3),
            }
            dev_ms = {key: device_time(fn) for key, fn in runs.items()}
            for key, fn in reversed(runs.items()):
                dev_ms[key] = min(dev_ms[key], device_time(fn))
        t = {
            "inference_ms": dev_ms["inference"],
            "inference_eager_ms": cuda_time(lambda: ak.fused_attention(q, k, v, bias)),
            "inference_previous_same_run_ms": dev_ms["inference_previous"],
            "inference_plain_ms": cuda_time(
                lambda: ak.fused_attention_reference(q, k, v, bias), iters=5),
            "inference_math_ms": cuda_time(
                lambda: dot_product_attention(q, k, v, bias)[0], iters=5),
            "inference_library_ms": dev_ms["inference_library"],
            "inference_library_eager_ms": cuda_time(lib_inference),
            "inference_bound_ms": fwd_bound[0],
            "forward_ms": dev_ms["forward"],
            "forward_eager_ms": cuda_time(kernel_train),
            "forward_previous_same_run_ms": dev_ms["forward_previous"],
            "forward_plain_ms": cuda_time(
                lambda: ak.fused_attention_trainable_reference(q, k, v, bias, keep, 0.3),
                iters=5),
            "forward_math_ms": cuda_time(math_train, iters=5),
            "forward_library_ms": dev_ms["forward_library"],
            "forward_library_eager_ms": cuda_time(lib_train),
            "forward_bound_ms": drop_bound[0],
            "bound_by": drop_bound[1],
            "backward_plain_ms": cuda_time(
                lambda: ak.fused_attention_backward_reference(q, k, v, bias, keep, 0.3, do),
                iters=5),
            "backward_bound_ms": bwd_bound[0],
            "backward_bound_by": bwd_bound[1],
        }
        # the backward by difference of host-loop times (eager: what an
        # autograd loop waits for)
        both = cuda_time(with_backward(kernel_train, do))
        t["backward_eager_ms"] = both - t["forward_eager_ms"]
        t["backward_math_ms"] = cuda_time(with_backward(math_train, do), iters=5) \
            - t["forward_math_ms"]
        t["backward_library_eager_ms"] = cuda_time(
            with_backward(lib_train, do.transpose(1, 2))) - t["forward_library_eager_ms"]
        # Device times (graph replay) of the backward kernels on the forward's
        # saved statistics, the pair they replaced (route 0), and the
        # library's backward: the ATen backward op SDPA dispatched to (its
        # autograd node, called on the saved tensors of one forward; autograd's
        # engine cannot be captured here). Kernel, previous, library, library,
        # previous, kernel.
        _, stats = ak._launch_forward(q, k, v, bias, keep, 0.3, True)
        lib_node = lib_train().grad_fn
        do_t = do.transpose(1, 2)
        runs = {"backward": lambda: ak._launch_backward(q, k, v, bias, keep, 0.3, do, stats),
                "backward_previous": lambda: ak._launch_backward(q, k, v, bias, keep, 0.3, do,
                                                                 stats, 0),
                "backward_library": lambda: lib_node(do_t)}
        bwd_ms = {key: device_time(fn) for key, fn in runs.items()}
        for key, fn in reversed(runs.items()):
            bwd_ms[key] = min(bwd_ms[key], device_time(fn))
        t["backward_ms"] = bwd_ms["backward"]
        t["backward_previous_same_run_ms"] = bwd_ms["backward_previous"]
        t["backward_library_ms"] = bwd_ms["backward_library"]
        per_shape[name] = t
        say(f"  attention {name} (B={b}, H={h}, Tq={tq}, Tk={tk}, D={d}, bf16) [{card}]:")
        say(f"    inference: kernel {t['inference_ms']:.4f} ms (previous kernel "
            f"{t['inference_previous_same_run_ms']:.4f}, recorded earlier "
            f"{RECORDED_PREVIOUS_MS['fused_attention'][name]:.4f}; host loop "
            f"{t['inference_eager_ms']:.4f}), bound "
            f"{t['inference_bound_ms']:.4f} ({fwd_bound[1]}), plain "
            f"{t['inference_plain_ms']:.4f}, math path {t['inference_math_ms']:.4f}, library "
            f"{t['inference_library_ms']:.4f} (host loop {t['inference_library_eager_ms']:.4f})")
        say(f"    forward with dropout: kernel {t['forward_ms']:.4f} ms (previous kernel "
            f"{t['forward_previous_same_run_ms']:.4f}, recorded earlier "
            f"{RECORDED_PREVIOUS_MS['fused_attention_trainable'][name]:.4f}; host loop "
            f"{t['forward_eager_ms']:.4f}), bound "
            f"{t['forward_bound_ms']:.4f} ({t['bound_by']}), plain {t['forward_plain_ms']:.4f}, "
            f"math path {t['forward_math_ms']:.4f}, library {t['forward_library_ms']:.4f} "
            f"(host loop {t['forward_library_eager_ms']:.4f})")
        say(f"    backward: kernel {t['backward_ms']:.4f} ms (replaced kernels "
            f"{t['backward_previous_same_run_ms']:.4f}, recorded earlier "
            f"{RECORDED_PREVIOUS_MS['fused_attention_trainable_backward'][name]:.4f}; host loop "
            f"{t['backward_eager_ms']:.4f}), bound {t['backward_bound_ms']:.4f} "
            f"({t['backward_bound_by']}), plain {t['backward_plain_ms']:.4f}, math path "
            f"{t['backward_math_ms']:.4f}, library {t['backward_library_ms']:.4f} "
            f"({type(lib_node).__name__}; host loop {t['backward_library_eager_ms']:.4f})")
        for key, val in t.items():
            if key.endswith("_ms"):
                report[f"attention_{name}_{key}"] = val
    enc = per_shape["encoder_self"]
    kernels = {
        # the eval path runs the inference kernel at the encoder's shape
        "fused_attention": {
            "timer": "graph_replay",
            "ms": enc["inference_ms"], "eager_ms": enc["inference_eager_ms"],
            "previous_same_run_ms": enc["inference_previous_same_run_ms"],
            "plain_ms": enc["inference_plain_ms"],
            "bound_ms": enc["inference_bound_ms"], "bound_by": enc["bound_by"],
            "library_ms": enc["inference_library_ms"],
            "math_path_ms": enc["inference_math_ms"],
            "by_shape": {n: {key: per_shape[n]["inference_" + key] for key in
                             ("ms", "previous_same_run_ms", "bound_ms", "library_ms")} for n in per_shape}},
        "fused_attention_trainable": {
            "timer": "graph_replay", "backward_timer": "graph_replay",
            "ms": enc["forward_ms"], "eager_ms": enc["forward_eager_ms"],
            "previous_same_run_ms": enc["forward_previous_same_run_ms"],
            "plain_ms": enc["forward_plain_ms"],
            "bound_ms": enc["forward_bound_ms"], "bound_by": enc["bound_by"],
            "library_ms": enc["forward_library_ms"], "math_path_ms": enc["forward_math_ms"],
            "backward_ms": enc["backward_ms"], "backward_eager_ms": enc["backward_eager_ms"],
            "backward_previous_same_run_ms": enc["backward_previous_same_run_ms"],
            "backward_plain_ms": enc["backward_plain_ms"],
            "backward_bound_ms": enc["backward_bound_ms"],
            "backward_bound_by": enc["backward_bound_by"],
            "backward_library_ms": enc["backward_library_ms"],
            "by_shape": {n: {key: per_shape[n]["forward_" + key] for key in
                             ("ms", "previous_same_run_ms", "bound_ms", "library_ms")} for n in per_shape},
            "backward_by_shape": {n: {key: per_shape[n]["backward_" + key] for key in
                                      ("ms", "previous_same_run_ms", "bound_ms", "library_ms")}
                                  for n in per_shape}},
    }
    return kernels, report


def time_long_train_steps(repo, root, vocab, dev, card):
    """ms per train step of the long recipe (batch 32, dropout on) on a fixed
    batch with the attention kernels on, off, off, on."""
    report = {}
    for i, kernels in enumerate((True, False, False, True)):
        tr = long_trainer(repo, root, vocab, dev, use_pallas_attention=kernels)
        batch = first_batch(tr)
        for _ in range(2):
            tr.train_step(tr.state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            tr.train_step(tr.state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 6
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        label = f"long_train_step_ms_attention_{'kernels' if kernels else 'math'}_{i // 2}"
        report[label] = ms
        say(f"  long train step, attention {'kernels' if kernels else 'math path'}: "
            f"{ms:.2f} ms, peak memory so far {peak:.0f} MiB [{card}]")
        del tr
    return report


# ---------------------------------------------------------------------------
# phases 17-18: the single-video path and the cross task
# ---------------------------------------------------------------------------
# The CLIP towers run in float32 on the card and on the CPU with TF32 off:
# the two sum 768- and 3072-term products in other orders over 12 layers, a
# few float32 units on features of magnitude ~1. The bound is the reference's
# own tower tolerance (tests/test_clip.py).
TOWER_ATOL = 2e-4
CLIP_FRAMES = 12          # uni_12, the shipped checkpoints' sampling
VIDEO_REQUESTS = 8
# Step 0 of the cross task on the card against the CPU, dropout off. float32:
# two devices sum in other orders, 1e-4 relative (the CPU tests' bound of the
# two packages). bfloat16: every product rounds to 8 significant bits (2**-8
# relative) and the card's loss kernels and cuBLAS round at other points than
# the CPU's chunked loss, 2e-2 relative.
# A float32 caption against the float32 module path: the kernels and the
# module sum 768-term products in other orders (~1e-5 on the logits); rows may
# part only at top-2 gaps below this.
NEAR_TIE_F32 = 1e-3
CROSS_REL = {"float32": 1e-4, "bfloat16": 2e-2}
CROSS_TRAIN_STEPS = TRAIN_STEPS


def write_video(path: Path, seed: int, n_frames: int = 40) -> None:
    """A seeded MJPG .avi (as tests/test_pipeline.py writes them): a moving
    rectangle of a seeded colour on seeded noise."""
    import cv2

    rng = np.random.default_rng(seed)
    colour = tuple(int(c) for c in rng.integers(0, 256, 3))
    base = rng.integers(0, 80, (240, 320, 3)).astype(np.uint8)
    x0 = int(rng.integers(0, 260))
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (320, 240))
    for i in range(n_frames):
        f = base.copy()
        x = (x0 + 5 * i) % 260
        cv2.rectangle(f, (x, 60), (x + 60, 160), colour, -1)
        w.write(f)
    w.release()


def write_clip_vision(path: Path) -> int:
    """A seeded ViT-B/32 at full width in OpenAI's key layout (``visual.*``),
    as a .pt -> its parameter count."""
    from vct_tpu_torch.clip.vision import CLIPVisionTower, init_clip_weights

    tower = init_clip_weights(CLIPVisionTower(), torch.Generator().manual_seed(SEED + 17))
    torch.save({f"visual.{k}": v for k, v in tower.state_dict().items()}, path)
    return sum(v.numel() for v in tower.state_dict().values())


def greedy_steps(tokens, end_id=102, max_len=30) -> int:
    """Tokens the fused greedy loop generates for one caption: it tests for
    the end once per 8-token stage (decode_fast._decode_loop)."""
    ends = np.nonzero(np.asarray(tokens)[1:] == end_id)[0]
    if not len(ends):
        return max_len - 1
    return min(-(-(int(ends[0]) + 1) // 8) * 8, max_len - 1)


def run_video(repo: Path, root: Path, vocab: Path, cfg, ckpt: Path, model, card: str):
    """Phase 17 -> ({kernel: launches}, report)."""
    from vct_tpu_torch.cli import predict as pcli
    from vct_tpu_torch.clip import preprocess_frames, sample_frames
    from vct_tpu_torch.ops import decode_kernels as dk

    dev = torch.device("cuda", 0)
    weights = root / "clip_vit_b32_seeded.pt"
    n_params = write_clip_vision(weights)
    videos = [root / f"video{i}.avi" for i in range(VIDEO_REQUESTS)]
    for i, v in enumerate(videos):
        write_video(v, SEED + 100 + i)
    cfg_path = str(train_config(repo, root, vocab, 1))
    args = ["-c", cfg_path, "-m", str(ckpt), "-v", str(videos[0]), "--clip_weights",
            str(weights), "--ext_type", f"uni_{CLIP_FRAMES}"]
    say(f"  ViT-B/32 {n_params} parameters (seeded, OpenAI keys); {len(videos)} videos of "
        f"40 frames 320x240")
    report, launches = {}, {}

    # the tower on the card against the same tower on the CPU, float32
    t0 = time.perf_counter()
    frames = sample_frames(str(videos[0]), f"uni_{CLIP_FRAMES}")
    pixels = torch.from_numpy(preprocess_frames(frames))
    host_ms = (time.perf_counter() - t0) * 1e3
    tower = pcli.load_clip_tower(str(weights), dev)
    with torch.no_grad():
        feats = tower(pixels.to(dev)).float()
        cpu = pcli.load_clip_tower(str(weights), torch.device("cpu"))(pixels)
    err = max_err("video: tower on the card against the CPU", feats.cpu(), cpu, TOWER_ATOL)
    if tuple(feats.shape) != (CLIP_FRAMES, 512):
        fail(f"video: tower features of shape {tuple(feats.shape)}")
    with torch.no_grad():
        tower_ms = cuda_time(lambda: tower(pixels.to(dev)), iters=10)
    report.update(video_tower_ms=tower_ms, video_host_ms=host_ms, video_tower_max_abs_err=err)
    say(f"  tower, {CLIP_FRAMES} frames: {tower_ms:.3f} ms on the card (CUDA events), "
        f"sampling + preprocessing {host_ms:.1f} ms on the host; card against CPU (float32) "
        f"max abs difference {err:.3g} (bound {TOWER_ATOL}) [{card}]")
    feats, masks = [feats[None]], [torch.zeros((1, CLIP_FRAMES), dtype=torch.bool, device=dev)]

    # greedy, then --beam 4, each with the launch counts set to 0 just before
    for label, extra in (("greedy", []), ("beam4", ["--beam", "4"])):
        reset_launches()
        t0 = time.perf_counter()
        with no_plain_on_cuda(f"predict {label}", dk):
            caption = pcli.main(args + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = read_launches()
        tokens = torch.from_numpy(pcli.predict.tokens)
        if not isinstance(caption, str) or tokens.shape != (30,) or tokens[0] != 101:
            fail(f"predict {label}: caption {caption!r}, tokens {tokens}")
        if label == "greedy":
            want = greedy_steps(tokens)
            if got["fused_whole_step"] != want or any(
                    v for k, v in got.items() if k != "fused_whole_step"):
                fail(f"predict -v: launches {got}, expected {want} of fused_whole_step "
                     f"(one per generated token)")
            check_against_module(model, feats, masks, tokens[None].to(dev), "predict -v")
            launches["fused_whole_step"] = got["fused_whole_step"]
        else:
            steps = got["fused_layers_step"]
            if steps != got["fused_norm_generator_topk"] or steps not in (8, 16, 24, 29) \
                    or got["fused_whole_step"] or got["fused_norm_generator_argmax"]:
                fail(f"predict --beam 4: launches {got}, expected one fused_layers_step "
                     f"and one fused_norm_generator_topk per beam token")
            launches.update({k: got[k] for k in ("fused_layers_step",
                                                 "fused_norm_generator_topk")})
        report[f"predict_{label}_seconds"] = seconds
        say(f"  predict -v {' '.join(extra) or '--greedy'}: {caption!r} in {seconds:.2f} s "
            f"with loading; launches { {k: v for k, v in got.items() if v} } [{card}]")

    # float32 (the triage rule's own setting): bf16 logits of a seeded random
    # model tie often, float32 ones do not
    from vct_tpu_torch.cli.common import make_trainer_pieces

    cfg32_path = str(train_config(repo, root, vocab, 1, dtype="float32"))
    model32, _ = make_trainer_pieces(pcli.load_config(cfg32_path), torch.device("cpu"))
    model32.load_state_dict(torch.load(ckpt, weights_only=True))
    model32 = model32.to(dev).to_compute_dtype()
    reset_launches()
    with no_plain_on_cuda("predict float32", dk):
        caption = pcli.main(["-c", cfg32_path] + args[2:])
    got = read_launches()
    tokens = torch.from_numpy(pcli.predict.tokens)
    if got["fused_whole_step"] != greedy_steps(tokens):
        fail(f"predict -v float32: launches {got}")
    check_against_module(model32, feats, masks, tokens[None].to(dev), "predict -v float32",
                         near_tie=NEAR_TIE_F32)
    say(f"  predict -v in float32: {caption!r}; launches "
        f"{ {k: v for k, v in got.items() if v} } [{card}]")

    # --vis_attn: the module path's per-token cross-attention
    ns = pcli.build_parser().parse_args(args + ["--vis_attn"])
    reset_launches()
    pcli.predict(pcli.load_config(cfg_path), ns, device=dev, log=lambda *_: None)
    want_shape = (29, cfg.model.caption_decoder.layer, 1, CLIP_FRAMES + 1)
    attn = pcli.predict.attn
    if attn is None or attn.shape != want_shape or not np.isfinite(attn).all() or \
            any(read_launches().values()):
        fail(f"predict --vis_attn: attn {None if attn is None else attn.shape}, want "
             f"{want_shape} from the module path")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        say(f"  --vis_attn: predict.attn {want_shape} from the module path; matplotlib is "
            f"not installed on this machine, so the heatmap PNG is left to the CPU tests")
    else:
        from vct_tpu_torch.text.tokenizer import make_tokenizer

        png = root / "attn.png"
        pcli.visualize_attention(attn, pcli.predict.tokens,
                                 make_tokenizer(cfg.tpu.vocab_path, cfg.model.tokenizer),
                                 str(png))
        if not png.is_file() or png.stat().st_size == 0:
            fail("predict --vis_attn: no heatmap written")
        say(f"  --vis_attn: predict.attn {want_shape}, heatmap {png.stat().st_size} bytes")

    launches["video_server_fused_whole_step"], server_report = run_video_server(
        cfg, ckpt, weights, videos, model, card)
    report.update(server_report)
    return launches, report


def run_video_server(cfg, ckpt: Path, weights: Path, videos, model, card: str):
    """The server with --clip_weights: concurrent /v1/caption_video requests,
    each batch's tokens against the module path on the tower's features."""
    from vct_tpu_torch.ops import decode_kernels as dk
    from vct_tpu_torch.serve import serve

    srv = serve(cfg, str(ckpt), device=torch.device("cuda", 0), host="127.0.0.1", port=0,
                clip_weights=str(weights), max_batch=MAX_BATCH, batch_timeout_ms=20.0,
                log=lambda *_: None)
    records = []
    decode = srv.service.decode_fn

    def recording_decode(feats, masks):
        tokens, aux = decode(feats, masks)
        records.append((feats, masks, tokens))
        return tokens, aux

    srv.service.decode_fn = recording_decode
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    bodies = [v.read_bytes() for v in videos]
    results, request_ms = [None] * len(bodies), [0.0] * len(bodies)

    def post(i):
        t0 = time.perf_counter()
        conn = HTTPConnection("127.0.0.1", srv.server_address[1], timeout=300)
        conn.request("POST", "/v1/caption_video", body=bodies[i])
        resp = conn.getresponse()
        results[i] = (resp.status, json.loads(resp.read()))
        conn.close()
        request_ms[i] = (time.perf_counter() - t0) * 1e3

    with no_plain_on_cuda("video server", dk):
        try:
            reset_launches()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            elapsed = time.perf_counter() - t0
            launches = dk.fused_whole_step.launches
        finally:
            srv.shutdown()
            srv.server_close()
            srv.service.close()
            thread.join(timeout=30)
    bad = [r for r in results if r is None or r[0] != 200
           or not isinstance(r[1].get("caption"), str)]
    if bad:
        fail(f"video server: {len(bad)} requests failed, e.g. {bad[0]}")
    if launches == 0:
        fail("video server: fused_whole_step was never launched")
    for feats, masks, tokens in records:
        check_against_module(model, feats, masks, tokens, "served video batch")
    ms = sorted(request_ms)
    say(f"  server: {len(bodies)} concurrent /v1/caption_video answered 200 in "
        f"{len(records)} batches, {elapsed * 1e3:.1f} ms for all; request ms p50 "
        f"{ms[len(ms) // 2]:.1f}, max {ms[-1]:.1f}; fused_whole_step launches {launches} [{card}]")
    return launches, {"video_requests_ms_all": elapsed * 1e3,
                      "video_request_ms_p50": ms[len(ms) // 2],
                      "video_request_ms_max": ms[-1]}


# ---- phase 18: the cross task ----------------------------------------------


def write_text_assets(root: Path):
    """A seeded full-width CLIP text tower (OpenAI text keys, vocab 49408) as
    a .pt, and a byte-level BPE vocab.json / merges.txt that encodes every
    caption of the synthetic dataset -> (weights, vocab.json, merges.txt,
    parameter count)."""
    from vct_tpu_torch.clip.text import CLIPTextTower, _bytes_to_unicode
    from vct_tpu_torch.clip.vision import init_clip_weights

    tower = init_clip_weights(CLIPTextTower(), torch.Generator().manual_seed(SEED + 18))
    weights = root / "clip_text_seeded.pt"
    torch.save(tower.state_dict(), weights)
    merges = [("w", "1"), ("w", "2"), ("1", "0</w>"), ("2", "5</w>")]
    chars = list(_bytes_to_unicode().values())
    tokens = chars + [c + "</w>" for c in chars] + ["".join(m) for m in merges]
    tokens += ["<|startoftext|>", "<|endoftext|>"]
    vocab_json, merges_txt = root / "bpe_vocab.json", root / "bpe_merges.txt"
    vocab_json.write_text(json.dumps({t: i for i, t in enumerate(tokens)}))
    merges_txt.write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges))
    return weights, vocab_json, merges_txt, sum(v.numel() for v in tower.state_dict().values())


def cross_config(repo: Path, root: Path, vocab: Path, assets, **tpu) -> Path:
    """configs/msvd.json with train.task cross, the text encoder's assets and
    the workspace's paths -> file."""
    cfg = json.loads(Path(train_config(repo, root, vocab, 1)).read_text())
    cfg["train"].update(task="cross", tag="cross", save_dir=str(root / "ckpt_cross"))
    cfg["tpu"].update(clip_text_weights=str(assets[0]), clip_vocab_json=str(assets[1]),
                      clip_merges_txt=str(assets[2]), **tpu)
    path = root / ("cross" + "".join(f"_{k}{v}" for k, v in tpu.items()) + ".json")
    path.write_text(json.dumps(cfg))
    return path


def run_cross(repo: Path, root: Path, vocab: Path, card: str):
    """Phase 18 -> ({loss kernel: launches}, report)."""
    import vct_tpu_torch.train.loop as loop
    from vct_tpu_torch.cli import train as train_cli
    from vct_tpu_torch.cli.common import load_config
    from vct_tpu_torch.ops import decode_kernels as dk
    from vct_tpu_torch.ops import loss_kernels as lk

    assets = write_text_assets(root)
    say(f"  CLIP text tower {assets[3]} parameters (seeded, vocab 49408, width 512, 12 "
        f"layers, 8 heads, context 77), a {len(json.loads(assets[1].read_text()))}-entry BPE "
        f"vocab")
    metrics, make_train = [], loop.make_train_step

    def recording_train(task):
        step = make_train(task)

        def wrapped(state, batch):
            state, m = step(state, batch)
            metrics.append(m)
            return state, m

        return wrapped

    loop.make_train_step = recording_train
    try:
        with no_plain_on_cuda("cross train", lk):
            for fn in lk.WRAPPERS + dk.WRAPPERS:
                fn.launches = 0
            t0 = time.perf_counter()
            scores = train_cli.main(["-c", str(cross_config(repo, root, vocab, assets)),
                                     "--no_tensorboard"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in lk.WRAPPERS}
            decode_launches = dk.fused_whole_step.launches
    finally:
        loop.make_train_step = make_train
    want = {"softmax_stats": CROSS_TRAIN_STEPS + VAL_STEPS,
            "clipped_prob_stats": CROSS_TRAIN_STEPS + VAL_STEPS,
            "sce_backward_tiles": CROSS_TRAIN_STEPS}
    if launches != want:
        fail(f"cross train: loss kernel launches {launches}, expected {want} "
             f"(3 per train step, 2 per validation step)")
    if len(metrics) != CROSS_TRAIN_STEPS or decode_launches == 0:
        fail(f"cross train: {len(metrics)} train steps, eval decode launches {decode_launches}")
    values = {k: [float(m[k]) for m in metrics] for k in ("loss", "cap_loss", "match_loss")}
    if not all(math.isfinite(v) for vs in values.values() for v in vs):
        fail("cross train: a loss is not finite")
    head, tail = sum(values["loss"][:5]) / 5, sum(values["loss"][-5:]) / 5
    if not tail < head:
        fail(f"cross train: the loss did not fall: first five {head}, last five {tail}")
    if not (root / "ckpt_cross" / "cross_latest.pt").is_file() or \
            set(scores) < {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr"}:
        fail(f"cross train: no checkpoint or no scores ({scores})")
    say(f"  {CROSS_TRAIN_STEPS} cross train steps + validation + eval decode + checkpoint in "
        f"{seconds:.1f} s: loss {head:.4f} (first five) -> {tail:.4f} (last five); cap_loss "
        f"{values['cap_loss'][0]:.4f} -> {values['cap_loss'][-1]:.4f}, match_loss "
        f"{values['match_loss'][0]:.4f} -> {values['match_loss'][-1]:.4f}; launches "
        f"{launches}; eval decode fused_whole_step launches {decode_launches} [{card}]")

    # step 0 on the card against the CPU, dropout off
    report = {"cross_train_seconds": seconds}
    for dtype, rel in CROSS_REL.items():
        outs = []
        for device in (torch.device("cuda", 0), torch.device("cpu")):
            tr = loop.Trainer(load_config(str(cross_config(repo, root, vocab, assets,
                                                           dtype=dtype))),
                              device=device, log=lambda *_: None)
            batch = first_batch(tr)
            tr.model.eval()
            with torch.no_grad():
                out = tr.model.cross_loss(batch["feats"], batch["masks"], batch["token_ids"],
                                          batch["token_mask"], batch["text_feat"],
                                          row_valid=batch["row_valid"])
            outs.append(([float(v) for v in out], batch["text_feat"].cpu()))
        text_err = max_err(f"cross {dtype}: text features on the card against the CPU",
                           outs[0][1], outs[1][1], TOWER_ATOL)
        for name, got, ref in zip(("loss", "cap_loss", "match_loss"), outs[0][0], outs[1][0]):
            if not math.isfinite(got) or abs(got - ref) > rel * abs(ref):
                fail(f"cross step 0 {dtype}: {name} {got} on the card, {ref} on the CPU "
                     f"(bound {rel} relative)")
        say(f"  step 0 {dtype}, card vs CPU: cap_loss {outs[0][0][1]:.6f} vs "
            f"{outs[1][0][1]:.6f}, match_loss {outs[0][0][2]:.6f} vs {outs[1][0][2]:.6f} "
            f"(bound {rel} relative); text features max abs difference {text_err:.3g}")

    # ms per cross train step on a fixed batch, with its loss kernel launches
    tr = loop.Trainer(load_config(str(cross_config(repo, root, vocab, assets))),
                      device=torch.device("cuda", 0), log=lambda *_: None)
    batch = first_batch(tr)
    for _ in range(3):
        tr.train_step(tr.state, batch)
    torch.cuda.synchronize()
    for fn in lk.WRAPPERS:
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(10):
        tr.train_step(tr.state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 100
    per_step = {fn.__name__: fn.launches / 10 for fn in lk.WRAPPERS}
    t0 = time.perf_counter()
    for _ in range(10):
        tr.text_encoder(["w1234 w2345 w3456 w4567"] * BATCH)
    torch.cuda.synchronize()
    text_ms = (time.perf_counter() - t0) * 100
    report.update(cross_train_step_ms=step_ms, cross_text_encoder_ms=text_ms)
    say(f"  cross train step (batch {BATCH}, text features given): {step_ms:.2f} ms, loss "
        f"kernel launches per step {per_step}; text encoder on {BATCH} captions "
        f"{text_ms:.2f} ms [{card}]")
    report.update(run_univl(repo, root, vocab))
    return launches, report


def run_univl(repo: Path, root: Path, vocab: Path):
    """One Trainer start with caption_decoder.univl: a seeded UniVL-keyed
    decoder at the MSVD widths (512-row position table, as UniVL's) imported
    on the card, each weight equal to its source."""
    from vct_tpu_torch.cli.common import load_config
    from vct_tpu_torch.convert import univl_to_reference_keys
    from vct_tpu_torch.train.loop import Trainer

    g = torch.Generator().manual_seed(SEED + 19)
    e, ff, v, layers = 768, 2048, 30522, 3
    sd = {}
    for l in range(layers):
        p = f"decoder.decoder.layer.{l}"
        for attn in ("slf_attn", "enc_attn"):
            for part in ("query", "key", "value"):
                sd[f"{p}.{attn}.att.{part}.weight"] = torch.randn((e, e), generator=g)
                sd[f"{p}.{attn}.att.{part}.bias"] = torch.randn((e,), generator=g)
            sd[f"{p}.{attn}.output.dense.weight"] = torch.randn((e, e), generator=g)
            for leaf in ("output.dense.bias", "output.LayerNorm.weight",
                         "output.LayerNorm.bias"):
                sd[f"{p}.{attn}.{leaf}"] = torch.randn((e,), generator=g)
        sd[f"{p}.intermediate.dense.weight"] = torch.randn((ff, e), generator=g)
        sd[f"{p}.intermediate.dense.bias"] = torch.randn((ff,), generator=g)
        sd[f"{p}.output.dense.weight"] = torch.randn((e, ff), generator=g)
        for leaf in ("output.dense.bias", "output.LayerNorm.weight", "output.LayerNorm.bias"):
            sd[f"{p}.{leaf}"] = torch.randn((e,), generator=g)
    for leaf, shape in (("decoder.embeddings.LayerNorm.weight", (e,)),
                        ("decoder.embeddings.LayerNorm.bias", (e,)),
                        ("decoder.embeddings.word_embeddings.weight", (v, e)),
                        ("decoder.embeddings.position_embeddings.weight", (512, e)),
                        ("decoder.classifier.cls.predictions.decoder.weight", (v, e)),
                        ("decoder.classifier.cls.predictions.bias", (v,))):
        sd[leaf] = torch.randn(shape, generator=g)
    path = root / "univl_seeded.pt"
    torch.save(sd, path)
    cfg = json.loads(Path(train_config(repo, root, vocab, 1)).read_text())
    cfg["model"]["caption_decoder"]["univl"] = str(path)
    cfg_path = root / "univl.json"
    cfg_path.write_text(json.dumps(cfg))
    logs = []
    t0 = time.perf_counter()
    tr = Trainer(load_config(str(cfg_path)), device=torch.device("cuda", 0), log=logs.append)
    seconds = time.perf_counter() - t0
    got = tr.model.state_dict()
    want = univl_to_reference_keys(sd)
    for k, src in want.items():
        dst = got[k][: src.shape[0]] if k.endswith("pos_embedding") else got[k]
        if not torch.equal(dst.cpu(), src):
            fail(f"univl: {k} differs from its source")
    if not any("imported UniVL decoder" in line for line in logs):
        fail(f"univl: the Trainer did not import the decoder ({logs})")
    say(f"  univl: {len(want)} decoder tensors ({sum(t.numel() for t in want.values())} "
        f"values) imported on the card, each equal to its source; Trainer built in "
        f"{seconds:.1f} s")
    return {"univl_trainer_seconds": seconds}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA card")
    repo = Path(__file__).resolve().parent
    if not (repo / "vct_tpu_torch" / "csrc").is_dir():
        fail(f"{repo} holds no vct_tpu_torch package: run from a checkout")
    sys.path.insert(0, str(repo))
    variant = None
    if "--stack-variant" in sys.argv[1:]:
        variant = Path(sys.argv[sys.argv.index("--stack-variant") + 1]).resolve()
        if not (variant / "vct_tpu_torch" / "csrc" / "stack_step.cu").is_file():
            fail(f"{variant} holds no vct_tpu_torch package")
        sys.path.insert(0, str(variant))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    say(card)
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} device(s)")

    from vct_tpu_torch.cli.common import load_config, make_trainer_pieces
    from vct_tpu_torch.decode_fast import extract_fast_weights
    from vct_tpu_torch.ops._build import load_library

    t0 = time.perf_counter()
    load_library()
    say(f"build: {load_library.build_seconds:.1f} s nvcc, "
        f"{time.perf_counter() - t0:.1f} s with loading")
    for line in load_library.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say("  ptxas: " + line.strip())

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        vocab = work / "vocab.txt"
        synthetic_vocab(vocab)
        write_dataset(work)
        long_work = work / "long"
        long_work.mkdir()
        write_long_dataset(long_work)
        if "--profile-train" in sys.argv[1:]:
            profile_train(make_trainer(repo, work, vocab, dev), card)
            return 0
        if "--profile-long-train" in sys.argv[1:]:
            for kernels in (True, False):
                say(f"long-video recipe, tpu.use_pallas_attention={kernels}")
                profile_train(long_trainer(repo, long_work, vocab, dev,
                                           use_pallas_attention=kernels), card)
            return 0
        cfg = load_config(str(repo / "configs" / "msvd.json"))
        cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, vocab_path=str(vocab)))
        model, _ = make_trainer_pieces(cfg, torch.device("cpu"), seed=SEED)
        ckpt = work / "msvd_seeded.pth"
        torch.save(model.state_dict(), ckpt)
        n_params = sum(t.numel() for t in model.state_dict().values())
        model = model.to(dev).to_compute_dtype()
        fw = extract_fast_weights(model)
        fw["vocab"] = model.config.vocab_size
        heads, tm = fw["heads"], cfg.tpu.max_frames + 1
        if "--profile-decode" in sys.argv[1:]:
            profile_decode(model, fw, card)
            return 0
        if "--profile-beam" in sys.argv[1:]:
            profile_beam(model, fw, card)
            return 0
        if variant is not None:
            stack_variant(variant, model, fw, heads, tm, card)
            return 0
        say(f"model: configs/msvd.json, {n_params} parameters and buffers, vocab "
            f"{model.config.vocab_size} (padded {fw['wg'].shape[1]}), {cfg.tpu.dtype}")

        say("phase kernels: CUDA kernels against their plain versions (bf16)")
        errs = check_kernels(fw, heads, tm)
        say(f"phase server: {N_REQUESTS} concurrent /v1/caption, max_batch {MAX_BATCH}")
        whole_launches, cps, elapsed = run_server(cfg, ckpt, model)
        say(f"  server: {cps:.1f} captions/s ({N_REQUESTS} in {elapsed:.2f} s) [{card}]")
        say("phase b128: greedy_generate_fused at B=128 (two-kernel path)")
        launches = run_b128(model, fw)
        launches["fused_whole_step"] = whole_launches
        say("phase loss-kernels: fused-loss kernels against their plain versions")
        loss_errs, bwd_errs = check_loss_kernels(dev)
        errs.update(loss_errs)
        say(f"phase train: vct_tpu_torch.cli.train on {TRAIN_STEPS} batches of {BATCH}, "
            f"then a resumed epoch")
        launches.update(run_training(repo, work, vocab))
        check_step0_routes(repo, work, vocab, dev)
        say("phase beam-kernels: the eval slice's kernels against their plain versions")
        errs.update(check_beam_kernels(model, fw, heads, tm))
        say(f"phase eval: vct_tpu_torch.cli.eval on {EVAL_VIDEOS} videos, eval batch {BATCH}: "
            f"greedy, --beam 4, --beam 1")
        beam_launches, eval_report = run_eval(repo, work, vocab, ckpt, card)
        launches["fused_norm_generator_topk"] = beam_launches["fused_norm_generator_topk"]
        check_beam_against_module(cfg, model, fw, dev)
        say("phase multi: several tokens per launch against the per-token kernel loop")
        multi_launches = run_multi(model, fw)
        for name in ("fused_layer_step", "fused_multi_step", "fused_sequence_decode"):
            launches[name] = multi_launches[name]
        say(f"phase timings [{card}]")
        kernel_times = time_kernels(fw, heads, tm)
        for name, t in kernel_times.items():
            lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
            was = "" if name != "fused_norm_generator_argmax" else (
                f" (previous kernel {t['previous_same_run_ms']:.4f}, recorded earlier "
                f"{RECORDED_PREVIOUS_MS[name]:.4f}; weight not left in L2: kernel "
                f"{t['cold_weight_ms']:.4f}, library {t['library_cold_weight_ms']:.4f}; host loop "
                f"{t['eager_ms']:.4f}, library host loop {t['library_eager_ms']:.4f}; B=65 "
                f"{t['ms_b65']:.4f}, B=256 {t['ms_b256']:.4f})")
            say(f"  {name}: kernel {t['ms']:.4f} ms{was}, plain {t['plain_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}), library {lib} [{card}]")
        kernel_times.update(time_beam_kernels(model, fw, heads, tm, card))
        report = {"server_captions_per_s": cps, **eval_report, **time_decode(model, fw, card),
                  **time_captions(model, fw, tm, card)}
        loss_times, loss_report = time_loss_kernels(dev, card)
        kernel_times.update(loss_times)
        report.update(loss_report)
        report.update(time_train_steps(repo, work, vocab, dev, card))

        say("phase attn-kernels: the attention kernels against their plain versions")
        attn_errs, attn_bwd_errs = check_attention_kernels(dev)
        errs.update(attn_errs)
        say(f"phase long-train: vct_tpu_torch.cli.train on the long-video recipe "
            f"({LONG_FRAMES} frames, captions to {LONG_CAPTION}), {LONG_TRAIN_STEPS} batches "
            f"of {LONG_BATCH}")
        train_counts = run_long_training(repo, long_work, vocab)
        check_long_step0_routes(repo, long_work, vocab, dev)
        say("phase long-eval: vct_tpu_torch.cli.eval greedy on the long-video recipe")
        eval_counts, long_report = run_long_eval(repo, long_work, vocab, ckpt, dev, card)
        report.update(long_report)
        launches["fused_attention"] = eval_counts["fused_attention"]
        launches["fused_attention_trainable"] = train_counts["fused_attention_trainable"]
        say("phase encoders: HMME and SimpleSep on the kernel route, biGRU aggregation")
        check_encoders(repo, vocab, dev)
        say(f"phase attn-timings [{card}]")
        attn_times, attn_report = time_attention(dev, card)
        kernel_times.update(attn_times)
        report.update(attn_report)
        report.update(time_long_train_steps(repo, long_work, vocab, dev, card))

        say("phase video: vct_tpu_torch.cli.predict -v (greedy, --beam 4, --vis_attn) and "
            f"{VIDEO_REQUESTS} concurrent /v1/caption_video with --clip_weights")
        t0 = time.perf_counter()
        video_launches, video_report = run_video(repo, work, vocab, cfg, ckpt, model, card)
        report.update(video_report, video_phase_seconds=time.perf_counter() - t0)
        say(f"phase cross-train: vct_tpu_torch.cli.train with train.task cross on "
            f"{CROSS_TRAIN_STEPS} batches of {BATCH}, the CLIP text tower; a UniVL start")
        t0 = time.perf_counter()
        cross_launches, cross_report = run_cross(repo, work, vocab, card)
        report.update(cross_report, cross_phase_seconds=time.perf_counter() - t0)
        say(f"  phases video and cross-train took {report['video_phase_seconds']:.1f} s and "
            f"{report['cross_phase_seconds']:.1f} s")

    say(json.dumps(report))
    sources = {**{k: SOURCE for k in REPLACES},
               "fused_layers_step": "vct_tpu_torch/csrc/stack_step.cu",
               "fused_whole_step": SMALL_SOURCE,
               "fused_norm_generator_argmax": "vct_tpu_torch/csrc/gen_argmax.cu",
               **{k: LOSS_SOURCE for k in LOSS_REPLACES},
               **{k: v[1] for k, v in BEAM_REPLACES.items()},
               **{k: ATTN_SOURCE for k in ATTN_REPLACES}}
    replaced = {**REPLACES, **LOSS_REPLACES, **{k: v[0] for k, v in BEAM_REPLACES.items()},
                **ATTN_REPLACES}
    extra = {"sce_backward_tiles": bwd_errs,
             "fused_attention_trainable": {
                 **attn_bwd_errs,
                 "backward_launches": train_counts["fused_attention_trainable_backward"]},
             "fused_whole_step": {
                 "video_launches": video_launches["fused_whole_step"],
                 "video_server_launches": video_launches["video_server_fused_whole_step"]},
             **{k: {"video_beam_launches": video_launches[k]}
                for k in ("fused_layers_step", "fused_norm_generator_topk")}}
    for name, n in cross_launches.items():
        extra[name] = {**extra.get(name, {}), "cross_train_launches": n}
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name], "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name], "timer": "cuda_events",
         **kernel_times[name],
         **extra.get(name, {})}
        for name, replaces in replaced.items()]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
