"""95th percentile of the step time (ms): the host clock between whole
steps, each ended by a synchronise, over the traced run's window; nothing
where the window has fewer than 200 steps (ten beyond the 95th)."""

import numpy as np

MIN_STEPS = 200


def read(ctx):
    steps = ctx.result.step_s
    if len(steps) < MIN_STEPS:
        return None
    return float(np.percentile(np.asarray(steps) * 1e3, 95))
