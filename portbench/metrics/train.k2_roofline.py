"""K2's share of its roofline (%): the least time of the backward blends
of one step (the first check step's inputs, `blend_bounds.backward_bound`)
over their kernel time per step in the profiled window."""

from kernel_share import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "blend_backward_kernel")
