"""The arithmetic one training step needs, in f32 operations, counted
from its shapes and from what the blend kernels' walks need:

- preprocess and its backward, per gaussian and camera: the 4D rotor and
  covariance, the temporal slice, projection and EWA splat, the conic and
  footprint, and the 48-coefficient spherindrical colour (PRE_FORWARD),
  the backward about twice the forward;
- K1's and K2's pair operations, as their bounds count them;
- the rigid loss's neighbour search, where the configuration has one:
  KNN_PASSES sweeps of every point against 2·KNN_SPAN sorted candidates,
  KNN_PAIR operations per distance (the program's `_motion_losses`);
- the photometric loss: five separable 11-tap blurs of SSIM and its map
  per pixel and channel, forward and backward;
- Adam: ADAM operations per parameter element.
"""

from kernel_share import kernel_bounds

PRE_FORWARD = 830
BACKWARD_FACTOR = 2.0
KNN_SPAN, KNN_PASSES, KNN_PAIR = 8192, 2, 8
SSIM_FORWARD = 5 * 2 * 11 * 2 + 30
ADAM = 14
PARAMS_PER_GAUSSIAN = 3 + 1 + 3 + 1 + 4 + 4 + 3 + 1   # plus the SH rest


def step_ops(ctx):
    """Operations of one step, or None where the kernels' counts are
    missing."""
    bounds = kernel_bounds(ctx)
    if len(bounds) < 2:
        return None
    cfg = ctx.cell.config["config"]
    args = [a for a in ctx.result.kernel_args if len(a) == 5]
    cameras = len(args)
    p = args[0][0].shape[0]
    tiles = args[0][2].numel()
    pixels = tiles * 256
    deg = cfg["ModelParams"]["sh_degree"]
    coeffs = (deg + 1) ** 2 * (3 if cfg["PipelineParams"]["eval_shfs_4d"]
                               else 1)
    ops = cameras * p * PRE_FORWARD * (1 + BACKWARD_FACTOR)
    ops += sum(b[1] for b in bounds.values())
    ops += cameras * pixels * 3 * SSIM_FORWARD * (1 + BACKWARD_FACTOR)
    if cfg["OptimizationParams"]["lambda_rigid"] > 0:
        ops += KNN_PASSES * p * min(2 * KNN_SPAN, p) * KNN_PAIR
    ops += p * (PARAMS_PER_GAUSSIAN + 3 * (coeffs - 1)) * ADAM
    return ops
