"""Host time per step waiting for the next batch (ms, median over the
stage-marks window): the program's `batch_wait_ns` counter, the loop's
`next(stream)` and the gather from the device image cache."""

import statistics

from spans import window_counts


def read(ctx):
    entries = window_counts(ctx)
    waits = [c["batch_wait_ns"] for c in entries or ()
             if "batch_wait_ns" in c]
    return statistics.median(waits) * 1e-6 if waits else None
