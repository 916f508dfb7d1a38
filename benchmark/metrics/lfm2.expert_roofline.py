"""The grouped expert kernel against its bound: each launch of
``grouped_wgmma_kernel<0>`` (the forward's up and down products),
``grouped_wgmma_kernel<1>`` (the backward's two dX products) or
``grouped_dw_kernel`` (its two dW products), each pair in that order, in the
traced window is one of an MoE layer's step, whose
least time is the larger of its operations (routed rows x widths) over the
bf16 peak and its bytes (the layer's bfloat16 expert weights, the rows in,
the outputs) over the memory bandwidth (``benchlib.lfm2.expert_launches``);
their sum over the kernel's device time. Moves ``train_samples_per_s``."""

import re

from benchlib import counts, lfm2

KERNEL = re.compile(r"grouped_wgmma_kernel<(\d)>|grouped_dw_kernel")


def read(ctx, out):
    trace = out.trace
    if trace is None:
        return None
    per_mode = lfm2.expert_launches(lfm2.dims_of(ctx.cell.config), out.records["batch"])
    seen = {0: 0, 1: 0, 2: 0}
    bound = spent = 0.0
    for name, _, dur in trace.ops:
        m = KERNEL.search(name)
        if m is None:
            continue
        mode = int(m.group(1)) if m.group(1) is not None else 2
        c = per_mode[mode][seen[mode] % 2]
        seen[mode] += 1
        bound += counts.bound_s(c["bytes"], c["flops"])
        spent += dur / 1e6
    if spent <= 0:
        return None
    return 100.0 * bound / spent
