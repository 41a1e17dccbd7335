"""PLY import/export of trained gaussian clouds.

PyTorch counterpart of `fourdgs_tpu/models/ply_io.py`: the standard 3DGS
attribute layout (x y z [t] nx ny nz f_dc_* f_rest_* opacity scale_*
[scale_t] rot_* [rot_r_*]), so that static 3DGS viewers open gaussian_dim=3
exports, extended with the 4D fields when present. Files written by either
package read back in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.pointcloud import _PLY_DTYPES  # the header parser's dtypes
from .gaussians import GaussianParams, GaussianState, new_state


def export_gaussians_ply(path: str, state: GaussianState,
                         gaussian_dim: int = 4, rot_4d: bool = True) -> None:
    n = int(state.n_active)
    p = GaussianParams(*(x[:n].detach().cpu().numpy() for x in state.params))
    cols = [("x", p.xyz[:, 0]), ("y", p.xyz[:, 1]), ("z", p.xyz[:, 2])]
    if gaussian_dim == 4:
        cols.append(("t", p.t[:, 0]))
    for axis in "xyz":
        cols.append((f"n{axis}", np.zeros(n, np.float32)))
    for i in range(3):
        cols.append((f"f_dc_{i}", p.f_dc[:, 0, i]))
    flat = p.f_rest.transpose(0, 2, 1).reshape(n, -1)  # channel-major (3DGS)
    for i in range(flat.shape[1]):
        cols.append((f"f_rest_{i}", flat[:, i]))
    cols.append(("opacity", p.opacity[:, 0]))
    for i in range(3):
        cols.append((f"scale_{i}", p.scaling[:, i]))
    if gaussian_dim == 4:
        cols.append(("scale_t", p.scaling_t[:, 0]))
    for i in range(4):
        cols.append((f"rot_{i}", p.rotation[:, i]))
    if gaussian_dim == 4 and rot_4d:
        for i in range(4):
            cols.append((f"rot_r_{i}", p.rotation_r[:, i]))

    arr = np.zeros(n, dtype=np.dtype([(name, "<f4") for name, _ in cols]))
    for name, data in cols:
        arr[name] = data.astype(np.float32)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {name}" for name, _ in cols]
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(arr.tobytes())


def import_gaussians_ply(path: str, device="cuda") -> GaussianState:
    """Read a gaussian cloud PLY back into a GaussianState of exactly its
    rows, all active, with a fresh optimizer and statistics (like the
    reference's create_from_pth, `gaussian_model.py:302-329`). Fields the
    file lacks (a 3D export has no t, scale_t, rot_r_*) take the JAX
    package's padding values: t = 0, log scale_t = 0, identity rot_r."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        props, n, fmt = [], 0, None
        while True:
            tok = f.readline().decode("ascii").split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                n = int(tok[2])
            elif tok[0] == "property":
                props.append((tok[-1], _PLY_DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported gaussian PLY format {fmt}")
        dt = np.dtype([(name, "<" + d) for name, d in props])
        data = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)

    names = {name for name, _ in props}
    n_rest = sum(1 for name in names if name.startswith("f_rest_"))

    def cols(*fields):
        return np.stack([np.asarray(data[c], np.float32) for c in fields], 1)

    identity = np.tile(np.float32([1, 0, 0, 0]), (n, 1))
    rest = (cols(*(f"f_rest_{i}" for i in range(n_rest)))
            .reshape(n, 3, n_rest // 3).transpose(0, 2, 1)
            if n_rest else np.zeros((n, 0, 3), np.float32))
    is_4d = "t" in names
    params = GaussianParams(
        xyz=cols("x", "y", "z"),
        t=cols("t") if is_4d else np.zeros((n, 1), np.float32),
        scaling=cols("scale_0", "scale_1", "scale_2"),
        scaling_t=cols("scale_t") if is_4d else np.zeros((n, 1), np.float32),
        rotation=cols("rot_0", "rot_1", "rot_2", "rot_3"),
        rotation_r=(cols("rot_r_0", "rot_r_1", "rot_r_2", "rot_r_3")
                    if "rot_r_0" in names else identity),
        f_dc=cols("f_dc_0", "f_dc_1", "f_dc_2")[:, None, :],
        f_rest=rest,
        opacity=cols("opacity"))
    return new_state(GaussianParams(*(
        torch.as_tensor(np.ascontiguousarray(x), device=device)
        for x in params)), n)
