"""The share of the card's time in the traced window spent in the routed
experts' own kernels: the router's top-k and sort by expert
(``moe_route_kernel``) and the grouped products, forward and backward, whose
loads gather the token rows (``grouped_wgmma_kernel``, ``grouped_dw_kernel``);
over the device time
of every operation in the window. Moves ``train_samples_per_s``."""

from benchlib.readings import ident

KERNELS = ("moe_route_kernel", "grouped_wgmma_kernel", "grouped_dw_kernel")


def read(ctx, out):
    trace = out.trace
    if trace is None:
        return None
    total = sum(dur for _, _, dur in trace.ops)
    mine = sum(dur for name, _, dur in trace.ops if ident(name) in KERNELS)
    if total <= 0 or mine <= 0:
        return None
    return 100.0 * mine / total
