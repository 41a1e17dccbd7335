"""Device-to-host reads per step (mean over the stage-marks window): the
program's `host_reads.<site>` counters summed, each a wait for the
device (binning's instance count per camera, the loss, the logging
reads)."""

from spans import window_counts


def read(ctx):
    entries = window_counts(ctx)
    if not entries:
        return None
    return sum(v for c in entries for k, v in c.items()
               if k.startswith("host_reads.")) / len(entries)
