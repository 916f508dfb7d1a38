"""A beam token's kernels against their bound: ``fused_layers_step`` (the
stack over batch x beam rows at the token's position) and
``fused_norm_generator_topk`` (norm, LM head, each row's top-k and
logsumexp), each launch's least time from its shapes over the device time of
both, summed over the traced window. Kernels: ``stack_step_kernel`` (and the
replaced ``decode_step_kernel``), ``gen_wgmma_kernel`` + ``gen_topk_merge``
(and the replaced ``gen_topk_partial``). Moves ``eval_captions_per_s``."""

from benchlib import counts
from benchlib.readings import token_roofline

STACK = ("stack_step_kernel", "decode_step_kernel")
TOPK = ("gen_wgmma_kernel", "gen_topk_merge", "gen_topk_partial")


def read(ctx, out):
    d, beam = ctx.dims, out.records["beam"]
    rows, t_mem = out.records["batch"] * beam, d["max_frames"] + 1

    def bound(pos):
        s, h = counts.stack_step(d, rows, pos, t_mem), counts.head_step(d, rows, beam)
        return {"bytes": s["bytes"] + h["bytes"], "flops": s["flops"] + h["flops"]}

    return token_roofline(out.trace, STACK, TOPK, bound)
