"""Kernels launched by the render forward per step (over the profiled
window): device kernels whose launch, matched by correlation id, lies
inside the program's `step.render` spans."""

from spans import launched_in, profiled


def read(ctx):
    sp = profiled(ctx)
    if sp is None or "step.render" not in sp.ranges:
        return None
    return len(launched_in(sp, ["step.render"])) / sp.steps
