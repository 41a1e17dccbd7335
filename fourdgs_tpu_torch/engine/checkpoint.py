"""Read checkpoints written by the JAX package.

`fourdgs_tpu.engine.checkpoint.save_checkpoint` pickles a dict whose
values are the JAX package's NamedTuples of numpy arrays. Unpickling them
plainly would import that package, and JAX with it; `load_checkpoint` maps
those classes to the port's own NamedTuples of the same fields instead, and
refuses any other class of the JAX package.
"""

from __future__ import annotations

import pickle
from typing import Any, NamedTuple

from ..models.gaussians import (AdamState, GaussianParams, GaussianState,
                                as_tensors)

JAX_PACKAGE = "fourdgs_tpu"


class EnvMapState(NamedTuple):
    """The environment-map state a JAX checkpoint stores."""
    texture: Any    # (res, res, 3)
    mu: Any
    nu: Any
    count: Any


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


def load_checkpoint(path: str, device="cuda"):
    """Returns (GaussianState, EnvMapState | None, step, extra), the
    arrays as tensors on `device` (floats f32, integers int64)."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    gauss = as_tensors(payload["gauss"], device)
    env = (None if payload["env"] is None
           else as_tensors(payload["env"], device))
    return gauss, env, payload["step"], payload.get("extra", {})
