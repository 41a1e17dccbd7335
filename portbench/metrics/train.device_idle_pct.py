"""Share of the profiled window (%) in which no operation ran on the
device: 100 × (1 − busy / window), from torch.profiler's device
activity over whole steps."""


def read(ctx):
    prof = ctx.profile
    if prof is None or prof.window_s <= 0 or prof.busy_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
