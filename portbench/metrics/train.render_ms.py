"""Render forward per step (ms, median over the traced window): CUDA
events at train_step's marks, from the step's start through each camera's
preprocess, binning and blend (K1) marks."""

import statistics


def read(ctx):
    stages = ctx.result.stages
    return statistics.median(s["render"] for s in stages) if stages else None
