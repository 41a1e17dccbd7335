"""Point-cloud container + self-contained PLY I/O (no plyfile dependency).
PyTorch-port counterpart of `fourdgs_tpu/data/pointcloud.py` (numpy only).

Parity targets: `scene/dataset_readers.py:118-148` (fetchPly/storePly —
xyz, rgb u8, optional normals, optional per-point `time` field).
Supports binary_little_endian and ascii PLY, the only variants those
datasets produce.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


@dataclasses.dataclass
class PointCloud:
    points: np.ndarray                      # (N, 3) float
    colors: np.ndarray                      # (N, 3) float in [0, 1]
    normals: Optional[np.ndarray] = None    # (N, 3)
    times: Optional[np.ndarray] = None      # (N, 1)


def read_ply(path: str) -> PointCloud:
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        props = []  # (name, numpy dtype str) for the vertex element
        counts = {}
        current = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tokens = line.decode("ascii", "replace").split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                current = tokens[1]
                counts[current] = int(tokens[2])
            elif tokens[0] == "property" and current == "vertex":
                if tokens[1] == "list":
                    raise ValueError("list properties unsupported on vertex")
                props.append((tokens[-1], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        n = counts.get("vertex", 0)
        if fmt == "binary_little_endian":
            dt = np.dtype([(name, "<" + d) for name, d in props])
            data = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
        elif fmt == "ascii":
            dt = np.dtype([(name, d) for name, d in props])
            rows = [f.readline().split()[: len(props)] for _ in range(n)]
            arr = np.array(rows, dtype=np.float64)
            data = np.zeros(n, dtype=dt)
            for i, (name, _) in enumerate(props):
                data[name] = arr[:, i]
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    names = {name for name, _ in props}
    pts = np.stack([data["x"], data["y"], data["z"]], 1).astype(np.float32)
    if {"red", "green", "blue"} <= names:
        cols = np.stack([data["red"], data["green"], data["blue"]], 1)
        cols = cols.astype(np.float32)
        if cols.max() > 1.0 + 1e-6:
            cols = cols / 255.0
    else:
        cols = np.full((len(pts), 3), 0.5, np.float32)
    normals = (np.stack([data["nx"], data["ny"], data["nz"]], 1).astype(np.float32)
               if {"nx", "ny", "nz"} <= names else np.zeros_like(pts))
    times = (np.asarray(data["time"], np.float32)[:, None]
             if "time" in names else None)
    return PointCloud(points=pts, colors=cols, normals=normals, times=times)


def write_ply(path: str, points: np.ndarray, colors_u8: np.ndarray,
              normals: np.ndarray | None = None,
              times: np.ndarray | None = None) -> None:
    """Binary PLY with the storePly layout (x y z nx ny nz red green blue
    [+ time])."""
    n = points.shape[0]
    if normals is None:
        normals = np.zeros_like(points)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
              ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
              ("red", "u1"), ("green", "u1"), ("blue", "u1")]
    if times is not None:
        fields.append(("time", "<f4"))
    arr = np.zeros(n, dtype=np.dtype(fields))
    arr["x"], arr["y"], arr["z"] = points.T.astype(np.float32)
    arr["nx"], arr["ny"], arr["nz"] = normals.T.astype(np.float32)
    cu8 = np.clip(colors_u8, 0, 255).astype(np.uint8)
    arr["red"], arr["green"], arr["blue"] = cu8.T
    if times is not None:
        arr["time"] = np.asarray(times, np.float32).reshape(n)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    types = {"<f4": "float", "u1": "uchar"}
    for name, d in fields:
        header.append(f"property {types[d]} {name}")
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(arr.tobytes())
