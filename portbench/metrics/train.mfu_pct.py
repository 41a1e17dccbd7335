"""The whole step's share of the card's f32 peak (%): the step's
arithmetic as `step_flops.step_ops` counts it, over the mean step time of
the traced window, against 67 TFLOP/s."""

from blend_bounds import PEAK_F32_OPS
from step_flops import step_ops


def read(ctx):
    steps = ctx.result.step_s
    ops = step_ops(ctx)
    if not steps or ops is None:
        return None
    return 100.0 * ops / (sum(steps) / len(steps)) / PEAK_F32_OPS
