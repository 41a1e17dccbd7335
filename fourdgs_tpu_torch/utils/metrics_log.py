"""Training metrics logging: the TensorBoard-writer role of the reference
(`train.py:254-298`: EMA loss terms, total_points, iter_time, eval
scalars) as JSONL, one JSON object per line with `step` and `wall_s`. The
JAX package's `fourdgs_tpu/utils/metrics_log.py`, but for one thing: a
tensor's value is read through `tracing.read`, which counts the host
read."""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch

from . import tracing


class MetricsLogger:
    def __init__(self, model_path: Optional[str],
                 filename: str = "metrics.jsonl"):
        self.path = None
        self._f = None
        if model_path:
            os.makedirs(model_path, exist_ok=True)
            self.path = os.path.join(model_path, filename)
            self._f = open(self.path, "a", buffering=1)
        self._t0 = time.perf_counter()

    def log(self, step: int, **scalars) -> None:
        if self._f is None:
            return
        rec = {"step": step,
               "wall_s": round(time.perf_counter() - self._t0, 3)}
        for k, v in scalars.items():
            if isinstance(v, torch.Tensor):
                v = tracing.read("metrics_jsonl", v)
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
