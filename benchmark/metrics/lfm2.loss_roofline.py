"""The fused SCE loss's kernels at the LFM2 head's width (E = 2,048, V =
65,536) against their bound (by operations): per train step one
``softmax_stats`` and one ``clipped_prob_stats`` (each the [N, E] x [E, V]
product) and one ``sce_backward_tiles`` (its recomputation and dx), N the
step's caption positions; their least time over the device time of their
kernels in the traced window, steps counted by the backward's first kernel.
The kernels are ``train.loss_roofline``'s. Moves ``train_samples_per_s``."""

from benchlib import counts, lfm2
from benchlib.readings import launches, seconds

KERNELS = ("stats_wgmma_kernel", "stats_merge_kernel", "bwd_dz_wgmma_kernel",
           "bwd_dx_wgmma_kernel", "bwd_dx_merge_kernel", "stats_kernel", "backward_kernel")
STEP_MARKS = ("bwd_dz_wgmma_kernel", "backward_kernel")


def read(ctx, out):
    trace = out.trace
    if trace is None:
        return None
    steps = len(launches(trace, STEP_MARKS))
    spent = seconds(launches(trace, KERNELS))
    if steps == 0 or spent <= 0:
        return None
    d = lfm2.dims_of(ctx.cell.config)
    n_rows = out.records["batch"] * (d["max_caption_len"] - 1)
    per_step = sum(counts.bound_s(0.0, f)
                   for f in counts.loss_ops(lfm2.loss_dims(d), n_rows).values())
    return 100.0 * steps * per_step / spent
