"""K1's share of its roofline (%): the least time of the forward blends
of one step (the first check step's inputs, `blend_bounds.forward_bound`)
over their kernel time per step in the profiled window."""

from kernel_share import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "blend_forward_kernel")
