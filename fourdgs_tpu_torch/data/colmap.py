"""COLMAP sparse-reconstruction parsers (binary + text), numpy-native.
PyTorch-port counterpart of `fourdgs_tpu/data/colmap.py` (numpy and struct).

Re-implements the subset of the COLMAP model format the reference consumes
(`scene/colmap_loader.py`): cameras(.bin/.txt), images(.bin/.txt),
points3D(.bin/.txt). Per-image 2D tracks are skipped over, not stored —
the trainer never uses them (`colmap_loader.py` keeps them; dead weight).
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict

import numpy as np

# model_id -> (name, num_params); COLMAP src/base/camera_models.h order.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray   # (4,) wxyz
    tvec: np.ndarray   # (3,)
    camera_id: int
    name: str


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> rotation matrix (COLMAP convention)."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(fid, fmt: str):
    size = struct.calcsize("<" + fmt)
    return struct.unpack("<" + fmt, fid.read(size))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "d" * n_params))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            out[int(e[0])] = ColmapCamera(
                int(e[0]), e[1], int(e[2]), int(e[3]),
                np.array([float(v) for v in e[4:]]))
    return out


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            vals = _read(f, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts2d,) = _read(f, "Q")
            f.seek(24 * n_pts2d, os.SEEK_CUR)  # skip (x, y, point3D_id)
            out[image_id] = ColmapImage(image_id, qvec, tvec, camera_id,
                                        name.decode("utf-8"))
    return out


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        while True:
            meta = f.readline()
            if not meta:
                break
            meta = meta.strip()
            if not meta or meta.startswith("#"):
                continue
            e = meta.split()
            out[int(e[0])] = ColmapImage(
                int(e[0]), np.array([float(v) for v in e[1:5]]),
                np.array([float(v) for v in e[5:8]]), int(e[8]), e[9])
            f.readline()  # the 2D point list — may be a blank line
    return out


def read_points3d_binary(path: str):
    """Returns (xyz (N,3) f64, rgb (N,3) u8, error (N,) f64)."""
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        for i in range(n):
            vals = _read(f, "QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(f, "Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return xyz, rgb, err


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            xyz.append([float(v) for v in e[1:4]])
            rgb.append([int(v) for v in e[4:7]])
            err.append(float(e[7]))
    return (np.array(xyz), np.array(rgb, np.uint8), np.array(err))


def read_model(sparse_dir: str):
    """Auto-detect binary vs text model files in `sparse_dir`."""
    if os.path.exists(os.path.join(sparse_dir, "images.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
    return cams, imgs


def read_points3d(sparse_dir: str):
    if os.path.exists(os.path.join(sparse_dir, "points3D.bin")):
        return read_points3d_binary(os.path.join(sparse_dir, "points3D.bin"))
    return read_points3d_text(os.path.join(sparse_dir, "points3D.txt"))
