"""Scene assembly: dataset detection, camera list construction, point-cloud
initialization, and the nerf++ normalization radius. PyTorch-port
counterpart of `fourdgs_tpu/data/scene.py`: host-side numpy; Pillow is
imported inside the functions that read or resize images.

Parity targets (reference `scene/__init__.py`, `scene/dataset_readers.py`,
`utils/camera_utils.py`):
  * Blender/DNeRF: transforms_{train,test}.json with optional per-frame
    `time`, OpenGL->COLMAP axis flip, white-background alpha compositing,
    per-frame or global fl_x/fl_y/cx/cy intrinsics
    (`dataset_readers.py:212-308`).
  * COLMAP: sparse/0 model, PINHOLE/SIMPLE_PINHOLE only, every-8th-view
    eval holdout, points3D -> ply conversion (`dataset_readers.py:150-210`).
  * Random init inside [-1.3, 1.3]^3 for synthetic scenes, subsample to
    num_pts with a uniform-with-replacement mask + time filter, extra
    background-sphere points at R=60 (`dataset_readers.py:326-384`).
  * nerf++ norm: radius = 1.1 * max distance to mean camera center
    (`dataset_readers.py:56-77`).
  * Resolution: divisor in {1,2,3,4,8} or width cap 1600 / explicit target
    width (`camera_utils.py:19-46`).
"""

from __future__ import annotations

import dataclasses
import json

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from . import colmap as colmap_io
from .cameras import Camera, focal2fov, fov2focal
from .pointcloud import PointCloud, read_ply, write_ply
from ..ops.sh import C0


@dataclasses.dataclass
class SceneInfo:
    point_cloud: Optional[PointCloud]
    train_cameras: List[Camera]
    test_cameras: List[Camera]
    translate: np.ndarray
    radius: float          # = cameras_extent (spatial_lr_scale)
    ply_path: str


def nerfpp_norm(cams: List[Camera]):
    centers = np.stack([c.campos for c in cams], axis=0)
    center = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - center, axis=1).max()
    return -center, float(diagonal * 1.1)


def _sh2rgb(sh):
    return sh * C0 + 0.5


def load_image_composited(path: str, white_background: bool):
    """RGBA load + background compositing. Returns (rgb (H,W,3) f32,
    alpha (H,W) f32 or None)."""
    from PIL import Image

    with Image.open(path) as im:
        data = np.asarray(im.convert("RGBA"), np.float32) / 255.0
    bg = 1.0 if white_background else 0.0
    a = data[..., 3:4]
    rgb = data[..., :3] * a + bg * (1.0 - a)
    alpha = a[..., 0] if a.min() < 1.0 else None
    return rgb, alpha


def compute_resolution_scale(orig_w: int, orig_h: int, resolution: int,
                             resolution_scale: float = 1.0):
    """loadCam's resolution logic -> ((w, h), scale)."""
    if resolution in (1, 2, 3, 4, 8):
        scale = resolution_scale * resolution
        return (round(orig_w / scale), round(orig_h / scale)), scale
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return (int(orig_w / scale), int(orig_h / scale)), scale


def resize_image(img: np.ndarray, wh) -> np.ndarray:
    """PIL bilinear resize of an (H, W, C) or (H, W) float image."""
    if (img.shape[1], img.shape[0]) == tuple(wh):
        return img.astype(np.float32)
    from PIL import Image

    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    out = np.asarray(pil.resize(tuple(wh)), np.float32) / 255.0
    return out


def read_blender_cameras(
    path: str, transformsfile: str, white_background: bool,
    extension: str = ".png", time_duration=None, frame_ratio: int = 1,
    dataloader: bool = False,
) -> List[Camera]:
    from PIL import Image

    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx_global = contents.get("camera_angle_x")
    intr_global = {k: contents[k] for k in ("fl_x", "fl_y", "cx", "cy")
                   if k in contents}

    def load_frame(idx_frame):
        idx, frame = idx_frame
        timestamp = frame.get("time", 0.0)
        if frame_ratio > 1:
            timestamp /= frame_ratio
        if (time_duration is not None and "time" in frame
                and not (time_duration[0] <= timestamp <= time_duration[1])):
            return None
        fp = frame["file_path"]
        if not os.path.splitext(fp)[1]:
            fp = fp + extension
        image_path = os.path.join(path, fp)

        c2w = np.array(frame["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL/Blender -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        rot = np.transpose(w2c[:3, :3])
        trans = w2c[:3, 3]

        image = alpha = None
        if dataloader:
            with Image.open(image_path) as im:
                width, height = im.size
        else:
            image, alpha = load_image_composited(image_path, white_background)
            height, width = image.shape[:2]

        intr = {k: frame[k] for k in ("fl_x", "fl_y", "cx", "cy")
                if k in frame}
        if len(intr) < 4:
            intr = intr_global
        if len(intr) == 4:
            fovx = fovy = -1.0
            fl_x, fl_y = intr["fl_x"], intr["fl_y"]
            cx, cy = intr["cx"], intr["cy"]
        else:
            fovx = fovx_global
            fovy = focal2fov(fov2focal(fovx, width), height)
            fl_x = fl_y = cx = cy = -1.0
        return Camera(
            uid=idx, rot=rot, trans=trans, fovx=fovx, fovy=fovy,
            width=width, height=height, timestamp=timestamp,
            image_name=os.path.splitext(os.path.basename(fp))[0],
            image_path=image_path, image=image, alpha_mask=alpha,
            cx=cx, cy=cy, fl_x=fl_x, fl_y=fl_y, meta_only=dataloader)

    with ThreadPoolExecutor(max_workers=16) as pool:
        cams = list(pool.map(load_frame, enumerate(contents["frames"])))
    return [c for c in cams if c is not None]


def read_colmap_cameras(path: str, images_dir: str = "images") -> List[Camera]:
    from PIL import Image

    sparse = os.path.join(path, "sparse", "0")
    cams, imgs = colmap_io.read_model(sparse)
    out = []
    for key in imgs:
        extr = imgs[key]
        intr = cams[extr.camera_id]
        if intr.model == "SIMPLE_PINHOLE":
            fx = fy = intr.params[0]
        elif intr.model == "PINHOLE":
            fx, fy = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                f"COLMAP camera model {intr.model} not supported "
                "(undistort to PINHOLE first)")
        rot = np.transpose(colmap_io.qvec2rotmat(extr.qvec))
        image_path = os.path.join(path, images_dir, os.path.basename(extr.name))
        with Image.open(image_path) as im:
            rgb = np.asarray(im.convert("RGB"), np.float32) / 255.0
        out.append(Camera(
            uid=intr.id, rot=rot, trans=np.array(extr.tvec),
            fovx=focal2fov(fx, intr.width), fovy=focal2fov(fy, intr.height),
            width=intr.width, height=intr.height,
            image_name=os.path.splitext(os.path.basename(extr.name))[0],
            image_path=image_path, image=rgb))
    out.sort(key=lambda c: c.image_name)
    return out


def scale_cameras(cams: List[Camera], resolution: int,
                  resolution_scale: float = 1.0) -> List[Camera]:
    """Apply the loadCam resolution policy, rescaling intrinsics and any
    eagerly-loaded images. Lazy (meta_only) cameras keep the scale so the
    loader resizes at fetch time."""
    out = []
    for c in cams:
        (w, h), scale = compute_resolution_scale(
            c.width, c.height, resolution, resolution_scale)
        img = resize_image(c.image, (w, h)) if c.image is not None else None
        am = resize_image(c.alpha_mask, (w, h)) if c.alpha_mask is not None else None
        out.append(dataclasses.replace(
            c, width=w, height=h, image=img, alpha_mask=am,
            cx=c.cx / scale if c.cx > 0 else c.cx,
            cy=c.cy / scale if c.cy > 0 else c.cy,
            fl_x=c.fl_x / scale if c.fl_x > 0 else c.fl_x,
            fl_y=c.fl_y / scale if c.fl_y > 0 else c.fl_y))
    return out


def build_synthetic_pointcloud(
    ply_path: str, num_pts: int, time_duration, num_extra_pts: int = 0,
    rng: np.random.Generator | None = None,
) -> PointCloud:
    """Random-or-ply init with num_pts subsampling, time filter, and
    background sphere (`dataset_readers.py:326-384`)."""
    rng = rng or np.random.default_rng(0)
    if os.path.exists(ply_path):
        pcd = read_ply(ply_path)
    else:
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        colors = _sh2rgb(rng.random((num_pts, 3)) / 255.0)
        pcd = PointCloud(points=xyz.astype(np.float32),
                         colors=colors.astype(np.float32),
                         normals=np.zeros((num_pts, 3), np.float32))
        write_ply(ply_path, pcd.points, pcd.colors * 255)
        # Re-read the (uint8-quantized) ply like the reference does
        # (`dataset_readers.py:333-340` storePly -> fetchPly) — otherwise
        # the FIRST run trains on unquantized colors and every later run
        # on the ply, breaking same-seed determinism across runs.
        pcd = read_ply(ply_path)

    if pcd.points.shape[0] > num_pts:
        mask = rng.integers(0, pcd.points.shape[0], num_pts)
        pts, cols = pcd.points[mask], pcd.colors[mask]
        times = pcd.times[mask] if pcd.times is not None else None
        if times is not None and time_duration is not None:
            tm = ((times[:, 0] > time_duration[0])
                  & (times[:, 0] < time_duration[1]))
            pts, cols, times = pts[tm], cols[tm], times[tm]
        pcd = PointCloud(points=pts, colors=cols,
                         normals=np.zeros_like(pts), times=times)

    if num_extra_pts > 0:
        radius = 60.0
        phi = 2.0 * np.pi * rng.random(num_extra_pts)
        theta = np.arccos(2.0 * rng.random(num_extra_pts) - 1.0)
        extra = np.stack([radius * np.sin(theta) * np.cos(phi),
                          radius * np.sin(theta) * np.sin(phi),
                          radius * np.cos(theta)], axis=1).astype(np.float32)
        pts = np.concatenate([pcd.points, extra])
        cols = np.concatenate(
            [pcd.colors, np.full((num_extra_pts, 3), 0.5, np.float32)])
        times = pcd.times
        if times is not None:
            mid = (time_duration[0] + time_duration[1]) / 2
            times = np.concatenate(
                [times, np.full((num_extra_pts, 1), mid, np.float32)])
        pcd = PointCloud(points=pts, colors=cols,
                         normals=np.zeros_like(pts), times=times)
    return pcd


def load_scene(
    source_path: str,
    *,
    images: str = "images",
    white_background: bool = False,
    eval_holdout: bool = True,
    extension: str = ".png",
    num_pts: int = 100_000,
    num_pts_ratio: float = 1.0,
    time_duration=(0.0, 1.0),
    num_extra_pts: int = 0,
    frame_ratio: int = 1,
    dataloader: bool = False,
    resolution: int = -1,
    llffhold: int = 8,
    seed: int = 0,
) -> SceneInfo:
    """Detect dataset type and assemble the scene (reference
    `Scene.__init__`, `scene/__init__.py:27-89`)."""
    rng = np.random.default_rng(seed)
    if os.path.exists(os.path.join(source_path, "sparse")):
        train, test, pcd, ply_path = _load_colmap(
            source_path, images, eval_holdout, llffhold, num_pts_ratio, rng)
    elif os.path.exists(os.path.join(source_path, "transforms_train.json")):
        train = read_blender_cameras(
            source_path, "transforms_train.json", white_background, extension,
            time_duration, frame_ratio, dataloader)
        test_file = ("transforms_val.json"
                     if source_path.rstrip("/").endswith("lego")
                     else "transforms_test.json")
        test = read_blender_cameras(
            source_path, test_file, white_background, extension,
            time_duration, frame_ratio, dataloader)
        if not eval_holdout:
            train = train + test
            test = []
        ply_path = os.path.join(source_path, "points3d.ply")
        pcd = build_synthetic_pointcloud(
            ply_path, num_pts, time_duration, num_extra_pts, rng)
    else:
        raise ValueError(f"Could not recognize scene type at {source_path}")

    translate, radius = nerfpp_norm(train)
    train = scale_cameras(train, resolution)
    test = scale_cameras(test, resolution)
    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     translate=translate, radius=radius, ply_path=ply_path)


def _load_colmap(source_path, images, eval_holdout, llffhold,
                 num_pts_ratio, rng):
    cams = read_colmap_cameras(source_path, images)
    if eval_holdout:
        train = [c for i, c in enumerate(cams) if i % llffhold != 0]
        test = [c for i, c in enumerate(cams) if i % llffhold == 0]
    else:
        train, test = cams, []
    sparse = os.path.join(source_path, "sparse", "0")
    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        xyz, rgb, _ = colmap_io.read_points3d(sparse)
        write_ply(ply_path, xyz, rgb)
    pcd = read_ply(ply_path)
    if num_pts_ratio > 1.001:
        n_extra = int((num_pts_ratio - 1) * pcd.points.shape[0])
        mean_xyz = pcd.points.mean(axis=0)
        lo = mean_xyz - np.array([0.5, 0.5, 0.5])
        hi = mean_xyz + np.array([0.5, 2.0, 0.5])
        extra = rng.random((n_extra, 3)) * (hi - lo) + lo
        pcd = PointCloud(
            points=np.concatenate([pcd.points, extra.astype(np.float32)]),
            colors=np.concatenate(
                [pcd.colors, _sh2rgb(rng.random((n_extra, 3)) / 255.0)
                 .astype(np.float32)]),
            normals=np.concatenate([pcd.normals, np.zeros((n_extra, 3),
                                                          np.float32)]),
            times=pcd.times)
    return train, test, pcd, ply_path
