"""Device time of the losses and the update per step (ms, over the
profiled window): the union of the kernels launched inside the program's
`step.loss` and `step.update` spans (the photometric losses; the
densification statistics and Adam)."""

from harness.trace import merge
from spans import launched_in, profiled

SPANS = ("step.loss", "step.update")


def read(ctx):
    sp = profiled(ctx)
    if sp is None or not all(n in sp.ranges for n in SPANS):
        return None
    busy = merge(launched_in(sp, SPANS))
    return sum(t - s for s, t in busy) / sp.steps * 1e3
