"""Backward through the blends and preprocess per step (ms, median over
the traced window): CUDA events from the first blend backward (K2) to the
end of the backward."""

import statistics


def read(ctx):
    stages = [s["blend_backward"] for s in ctx.result.stages
              if "blend_backward" in s]
    return statistics.median(stages) if stages else None
