"""Camera math and containers.

PyTorch counterpart of `fourdgs_tpu/data/cameras.py`: world→view and
projection matrices with the reference's conventions
(`utils/graphics_utils.py:32-98`, `scene/cameras.py:59-73`), stored
un-transposed so they apply as M @ [x; 1]. The matrices are built in numpy
on the host; `Camera.arrays(device)` hands them to the renderer as tensors.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.preprocess import CameraArrays

ZNEAR = 0.01
ZFAR = 100.0


def world_to_view(rot: np.ndarray, trans: np.ndarray,
                  translate=np.zeros(3), scale: float = 1.0) -> np.ndarray:
    """(3,3) camera rotation (COLMAP convention: world→cam is Rᵀ) + (3,)
    translation → (4,4) world→view (`graphics_utils.py:39-50`)."""
    rt = np.zeros((4, 4), dtype=np.float64)
    rt[:3, :3] = rot.T
    rt[:3, 3] = trans
    rt[3, 3] = 1.0
    c2w = np.linalg.inv(rt)
    c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
    return np.linalg.inv(c2w).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """Symmetric pinhole projection (`graphics_utils.py:52-72`)."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    top, right = tan_y * znear, tan_x * znear
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = znear / right
    p[1, 1] = znear / top
    p[3, 2] = 1.0
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    return p


def projection_matrix_center_shift(znear, zfar, cx, cy, fl_x, fl_y, w,
                                   h) -> np.ndarray:
    """Asymmetric projection for real intrinsics (`graphics_utils.py:74-92`)."""
    top = cy / fl_y * znear
    bottom = -(h - cy) / fl_y * znear
    left = -(w - cx) / fl_x * znear
    right = cx / fl_x * znear
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = 2.0 * znear / (right - left)
    p[1, 1] = 2.0 * znear / (top - bottom)
    p[0, 2] = (right + left) / (right - left)
    p[1, 2] = (top + bottom) / (top - bottom)
    p[3, 2] = 1.0
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    return p


def _to_arrays(viewmatrix, projmatrix, campos, focal, tanfov, timestamp,
               device) -> CameraArrays:
    as_t = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=device)
    return CameraArrays(viewmatrix=as_t(viewmatrix),
                        projmatrix=as_t(projmatrix), campos=as_t(campos),
                        focal=as_t(focal), tanfov=as_t(tanfov),
                        timestamp=as_t(timestamp))


@dataclasses.dataclass
class Camera:
    """Host-side camera record (numpy); `.arrays(device)` yields the
    renderer's tensors."""
    uid: int
    rot: np.ndarray           # (3, 3) cam→world rotation (COLMAP R)
    trans: np.ndarray         # (3,) world→cam translation (COLMAP T)
    fovx: float
    fovy: float
    width: int
    height: int
    timestamp: float = 0.0
    cx: float = -1.0
    cy: float = -1.0
    fl_x: float = -1.0
    fl_y: float = -1.0

    def __post_init__(self):
        self.viewmatrix = world_to_view(self.rot, self.trans)
        if self.cx > 0:
            self.projmat = projection_matrix_center_shift(
                ZNEAR, ZFAR, self.cx, self.cy, self.fl_x, self.fl_y,
                self.width, self.height)
        else:
            self.projmat = projection_matrix(ZNEAR, ZFAR, self.fovx,
                                             self.fovy)
        self.full_proj = (self.projmat @ self.viewmatrix).astype(np.float32)
        self.campos = np.linalg.inv(self.viewmatrix)[:3, 3].astype(np.float32)

    def arrays(self, device="cuda") -> CameraArrays:
        tanx = math.tan(self.fovx / 2)
        tany = math.tan(self.fovy / 2)
        if self.fl_x > 0:
            focal = [self.fl_x, self.fl_y]
        else:
            focal = [self.width / (2 * tanx), self.height / (2 * tany)]
        return _to_arrays(self.viewmatrix, self.full_proj, self.campos,
                          focal, [tanx, tany], self.timestamp, device)


def camera_from_matrices(width: int, height: int, fovx: float, fovy: float,
                         viewmatrix: np.ndarray, full_proj: np.ndarray,
                         timestamp: float = 0.0,
                         device="cuda") -> CameraArrays:
    """CameraArrays straight from matrices (the reference's MiniCam,
    `scene/cameras.py:91-103`)."""
    viewmatrix = np.asarray(viewmatrix, np.float32)
    campos = np.linalg.inv(viewmatrix)[:3, 3]
    tanx, tany = math.tan(fovx / 2), math.tan(fovy / 2)
    focal = [width / (2 * tanx), height / (2 * tany)]
    return _to_arrays(viewmatrix, full_proj, campos, focal, [tanx, tany],
                      timestamp, device)
