"""The blend kernels' least time on the first check step's inputs and
their share of it in the profiled window, shared by the roofline and MFU
readers."""

from blend_bounds import backward_bound, forward_bound

KERNELS = {"blend_forward_kernel": (5, forward_bound),
           "blend_backward_kernel": (7, backward_bound)}


def kernel_bounds(ctx) -> dict:
    """{kernel: (least seconds, operations)} summed over the step's
    launches (each camera's K1 and K2), computed once per run."""
    if "bounds" not in ctx.cache:
        out = {}
        for name, (n_args, bound) in KERNELS.items():
            calls = [bound(a) for a in ctx.result.kernel_args
                     if len(a) == n_args]
            if calls:
                out[name] = (sum(c[0] for c in calls),
                             sum(c[1] for c in calls))
        ctx.cache["bounds"] = out
    return ctx.cache["bounds"]


def kernel_s_per_step(ctx, kernel: str):
    prof = ctx.profile
    if prof is None or prof.steps == 0:
        return None
    total = sum(s for name, s in prof.kernel_s.items() if kernel in name)
    return total / prof.steps if total > 0 else None


def roofline_pct(ctx, kernel: str):
    """100 × least time / kernel time, per step; nothing where the kernel
    did not run in the window or on the captured step."""
    bounds = kernel_bounds(ctx)
    spent = kernel_s_per_step(ctx, kernel)
    if kernel not in bounds or spent is None:
        return None
    return 100.0 * bounds[kernel][0] / spent
