"""The rigid loss per step (ms, median over the traced window): CUDA
events from the photometric loss's mark to the motion losses' mark, the
k nearest neighbours' sweep and the velocity terms. Nothing where the
configuration has no rigid loss."""

import statistics


def read(ctx):
    if ctx.cell.config["config"]["OptimizationParams"]["lambda_rigid"] <= 0:
        return None
    stages = ctx.result.stages
    return statistics.median(s["knn"] for s in stages) if stages else None
