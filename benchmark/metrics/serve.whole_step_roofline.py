"""``fused_whole_step`` against its bound: each launch's least time from its
shapes (the server's ``max_batch`` rows; the weights and LM head once, the
cache rows its position attends, the cross K / V, the activations) over its
device time, summed over the traced window. Kernels: ``small_step_kernel``
(bf16 at 1-64 rows) and ``decode_step_kernel`` (the route it replaced).
Moves ``serve_p50_ms``."""

from benchlib import counts
from benchlib.readings import token_roofline

KERNELS = ("small_step_kernel", "decode_step_kernel")


def read(ctx, out):
    d, rows = ctx.dims, int(ctx.traffic["max_batch"])
    return token_roofline(out.trace, KERNELS, (),
                          lambda pos: counts.whole_step(d, rows, pos, d["max_frames"] + 1))
