"""Checkpointing: the full training state as a pickled tree of numpy
arrays, written by this package or by the JAX package.

PyTorch counterpart of `fourdgs_tpu/engine/checkpoint.py` (reference
`capture()/restore()`, `scene/gaussian_model.py:99-177`): params, Adam
moments, densification accumulators, active count, env map, step.
`save_checkpoint` pickles the port's own NamedTuples of host numpy arrays.
`fourdgs_tpu.engine.checkpoint.save_checkpoint` pickles the JAX package's
NamedTuples; unpickling them plainly would import that package, and JAX
with it, so `load_checkpoint` maps those classes to the port's NamedTuples
of the same fields and refuses any other class of the JAX package. It
reads both formats.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..models.envmap import EnvMapState
from ..models.gaussians import (AdamState, GaussianParams, GaussianState,
                                as_tensors)

JAX_PACKAGE = "fourdgs_tpu"


_CLASSES = {
    ("fourdgs_tpu.models.gaussians", "GaussianParams"): GaussianParams,
    ("fourdgs_tpu.models.gaussians", "AdamState"): AdamState,
    ("fourdgs_tpu.models.gaussians", "GaussianState"): GaussianState,
    ("fourdgs_tpu.models.envmap", "EnvMapState"): EnvMapState,
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        cls = _CLASSES.get((module, name))
        if cls is not None:
            return cls
        # An exact package test: "fourdgs_tpu_torch" also starts with
        # "fourdgs_tpu".
        if module == JAX_PACKAGE or module.startswith(JAX_PACKAGE + "."):
            raise pickle.UnpicklingError(
                f"checkpoint holds {module}.{name}, which has no counterpart "
                "in fourdgs_tpu_torch")
        return super().find_class(module, name)


def _to_numpy(tree):
    """A NamedTuple tree of tensors → the same tree of host numpy arrays."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_numpy(x) for x in tree))
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, gauss: GaussianState,
                    env: EnvMapState | None, step: int, extra=None,
                    io_pool=None):
    """Atomic checkpoint save (tmp file + os.replace). The device → host
    copy happens here; with `io_pool` (an Executor) pickling and disk IO
    run in the background and the Future is returned."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "gauss": _to_numpy(gauss),
        "env": None if env is None else _to_numpy(env),
        "step": int(step),
        "extra": extra or {},
    }

    def write():
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=4)
        os.replace(tmp, path)

    if io_pool is not None:
        return io_pool.submit(write)
    write()
    return None


def load_checkpoint(path: str, device="cuda"):
    """Returns (GaussianState, EnvMapState | None, step, extra), the
    arrays as tensors on `device` (floats f32, integers int64)."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    gauss = as_tensors(payload["gauss"], device)
    env = (None if payload["env"] is None
           else as_tensors(payload["env"], device))
    return gauss, env, payload["step"], payload.get("extra", {})
