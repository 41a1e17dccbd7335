"""Import and export of the reference's torch checkpoints (.pth).

PyTorch counterpart of `fourdgs_tpu/models/torch_import.py`. A reference
training run saves `torch.save((gaussians.capture(), iter), chkpntN.pth)`
(reference `train.py:226-228`); `capture()` packs the raw
(pre-activation) parameter tensors, the densify statistics and the torch
Adam `state_dict()` (`gaussian_model.py:99-136`). The tensors map 1:1
onto `GaussianParams` (the same raw semantics), the Adam moments map by
param-group NAME (`gaussian_model.py:336-351`) and the env map transposes
(3, R, R) → (R, R, 3). The state takes the checkpoint's true size: no
capacity and no padding rows, as everywhere in the port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .gaussians import AdamState, GaussianParams, GaussianState

# capture() tuple fields (gaussian_model.py:115-136, 4D layout).
_4D_FIELDS = ("active_sh_degree", "xyz", "f_dc", "f_rest", "scaling",
              "rotation", "opacity", "max_radii2d", "xyz_grad_accum",
              "t_grad_accum", "denom", "opt_state", "spatial_lr_scale",
              "t", "scaling_t", "rotation_r", "rot_4d", "env_map",
              "active_sh_degree_t")
# 3D layout (gaussian_model.py:100-114): no t, scaling_t or rotation_r.
_3D_FIELDS = ("active_sh_degree", "xyz", "f_dc", "f_rest", "scaling",
              "rotation", "opacity", "max_radii2d", "xyz_grad_accum",
              "denom", "opt_state", "spatial_lr_scale")

# torch param-group name → GaussianParams field (gaussian_model.py:336-351).
_GROUP_FIELD = {"xyz": "xyz", "f_dc": "f_dc", "f_rest": "f_rest",
                "opacity": "opacity", "scaling": "scaling",
                "rotation": "rotation", "t": "t", "scaling_t": "scaling_t",
                "rotation_r": "rotation_r"}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def load_reference_pth(path: str) -> Tuple[dict, int]:
    """torch.load a reference checkpoint → (named capture dict, iter)."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    capture, iteration = payload if isinstance(payload, tuple) and \
        len(payload) == 2 and isinstance(payload[1], int) else (payload, 0)
    fields = _4D_FIELDS if len(capture) == len(_4D_FIELDS) else _3D_FIELDS
    if len(capture) != len(fields):
        raise ValueError(
            f"unrecognized capture tuple of length {len(capture)} in {path}")
    return dict(zip(fields, capture)), int(iteration)


def _param_rows(cap: dict, n: int, duration: float) -> GaussianParams:
    """Raw arrays from the capture dict, 3D checkpoints given the 4D
    defaults (scale_t = log sqrt(duration/5), t = 0, identity right
    rotation)."""
    if "t" in cap:
        t = _np(cap["t"]).reshape(n, 1)
        st = _np(cap["scaling_t"]).reshape(n, 1)
        rr = _np(cap["rotation_r"]).reshape(n, 4)
    else:
        t = np.zeros((n, 1), np.float32)
        st = np.full((n, 1), np.log(np.sqrt(max(duration, 1e-6) / 5)),
                     np.float32)
        rr = np.tile(np.asarray([[1, 0, 0, 0]], np.float32), (n, 1))
    return GaussianParams(
        xyz=_np(cap["xyz"]).reshape(n, 3), t=t,
        scaling=_np(cap["scaling"]).reshape(n, 3), scaling_t=st,
        rotation=_np(cap["rotation"]).reshape(n, 4), rotation_r=rr,
        f_dc=_np(cap["f_dc"]).reshape(n, 1, 3),
        f_rest=_np(cap["f_rest"]).reshape(n, -1, 3),
        opacity=_np(cap["opacity"]).reshape(n, 1))


def _adam_from_state_dict(opt_state: Dict[str, Any],
                          template: GaussianParams
                          ) -> Optional[Tuple[GaussianParams, GaussianParams,
                                              int]]:
    """(mu, nu, step) of a torch Adam state_dict, mapped by group name
    onto arrays shaped as `template`; None without param groups."""
    try:
        groups = opt_state["param_groups"]
        state = opt_state["state"]
    except (KeyError, TypeError):
        return None
    fields = _GROUP_FIELD.values()
    mu = {f: np.zeros_like(getattr(template, f)) for f in fields}
    nu = {f: np.zeros_like(getattr(template, f)) for f in fields}
    step = 0
    for g in groups:
        field = _GROUP_FIELD.get(g.get("name"))
        if field is None or not g.get("params"):
            continue
        st = state.get(g["params"][0])
        if st is None:
            continue
        shape = mu[field].shape
        mu[field] = _np(st["exp_avg"]).reshape(shape)
        nu[field] = _np(st["exp_avg_sq"]).reshape(shape)
        s = st.get("step", 0)
        step = max(step, int(_np(s).item() if hasattr(s, "item") else s))
    return GaussianParams(**mu), GaussianParams(**nu), step


def import_reference_pth(path: str, *, duration: float = 1.0,
                         with_optimizer: bool = True, device="cuda"
                         ) -> Tuple[GaussianState, dict]:
    """Reference .pth → (GaussianState of exactly its rows on `device`,
    meta: iteration, active SH degrees, spatial_lr_scale, rot_4d and the
    env map as a (R, R, 3) f32 array or None). Without `with_optimizer`,
    or without optimizer state in the file, Adam starts fresh."""
    cap, iteration = load_reference_pth(path)
    n = _np(cap["xyz"]).shape[0]
    raw = _param_rows(cap, n, duration)

    adam = _adam_from_state_dict(cap.get("opt_state") or {}, raw) \
        if with_optimizer else None
    if adam is None:
        adam = tuple(GaussianParams(*(np.zeros_like(x) for x in raw))
                     for _ in range(2)) + (0,)
    mu, nu, step = adam

    def tensors(tree):
        return GaussianParams(*(torch.as_tensor(x, device=device)
                                for x in tree))

    def stat(key):
        a = (_np(cap[key]).reshape(-1)[:n] if key in cap
             else np.zeros(n, np.float32))
        return torch.as_tensor(a, device=device)

    gauss = GaussianState(
        params=tensors(raw),
        adam=AdamState(tensors(mu), tensors(nu),
                       torch.tensor(step, dtype=torch.int64, device=device)),
        n_active=torch.tensor(n, dtype=torch.int64, device=device),
        xyz_grad_accum=stat("xyz_grad_accum"),
        t_grad_accum=stat("t_grad_accum"),
        denom=stat("denom"), max_radii2d=stat("max_radii2d"))

    env = cap.get("env_map")
    meta = {
        "iteration": iteration,
        "active_sh_degree": int(cap.get("active_sh_degree", 0)),
        "active_sh_degree_t": int(cap.get("active_sh_degree_t", 0) or 0),
        "spatial_lr_scale": float(cap.get("spatial_lr_scale", 1.0)),
        "env_map": None if env is None else _np(env).transpose(1, 2, 0),
        "rot_4d": bool(cap.get("rot_4d", "rotation_r" in cap)),
    }
    return gauss, meta


def export_reference_pth(path: str, gauss: GaussianState, *,
                         iteration: int = 0, active_sh_degree: int = 3,
                         active_sh_degree_t: int = 2, rot_4d: bool = True,
                         spatial_lr_scale: float = 1.0,
                         env_map=None) -> None:
    """Write a reference-format torch checkpoint (the 4D capture() tuple,
    `gaussian_model.py:115-136`) so that a cloud trained here loads in the
    upstream code via `--start_checkpoint` / `create_from_pth`. Only the
    active rows are written; the optimizer state_dict is left empty (the
    reference re-runs training_setup and overwrites it on restore).
    `env_map`: (R, R, 3), a tensor or an array, or None."""
    n = int(gauss.n_active)

    def tt(a, *shape):
        return a.detach()[:n].to("cpu", torch.float32).reshape(
            *shape).clone()

    p = gauss.params
    env = None
    if env_map is not None:
        env = torch.from_numpy(
            _np(env_map).transpose(2, 0, 1).copy())
    capture = (
        int(active_sh_degree),
        tt(p.xyz, n, 3), tt(p.f_dc, n, 1, 3),
        tt(p.f_rest, n, -1, 3), tt(p.scaling, n, 3),
        tt(p.rotation, n, 4), tt(p.opacity, n, 1),
        tt(gauss.max_radii2d, n),
        tt(gauss.xyz_grad_accum, n, 1), tt(gauss.t_grad_accum, n, 1),
        tt(gauss.denom, n, 1),
        {},                       # optimizer state (reference rebuilds)
        float(spatial_lr_scale),
        tt(p.t, n, 1), tt(p.scaling_t, n, 1), tt(p.rotation_r, n, 4),
        bool(rot_4d),
        env,
        int(active_sh_degree_t),
    )
    torch.save((capture, int(iteration)), path)
