"""Device idle inside the render forward per step (ms, over the profiled
window): the length of the program's `step.render` spans less the union
of device activity inside them."""

from spans import overlap, profiled


def read(ctx):
    sp = profiled(ctx)
    if sp is None or "step.render" not in sp.ranges:
        return None
    idle = sum((t - s) - overlap(sp.busy, s, t)
               for s, t in sp.ranges["step.render"])
    return idle / sp.steps * 1e3
