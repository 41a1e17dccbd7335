"""DyNeRF / Neural-3D-Video (N3V) preprocessing: the reference's offline
`scripts/n3v2blender.py`. A copy of `fourdgs_tpu/data/n3v.py`, which is
pure numpy; it reads and writes through the port's `data/colmap.py` and
`data/pointcloud.py`.

  1. ffmpeg frame extraction per camera video (`n3v2blender.py:234-236`),
  2. LLFF `poses_bounds.npy` -> NeRF-convention c2w with colmap2nerf-style
     recentering (closest-point-of-view-rays) and rescaling of the average
     camera radius to 4.0 (`n3v2blender.py:242-296`),
  3. transforms_{train,test}.json with `time = frame / 30` and cam00 held
     out for test (`n3v2blender.py:298-334`),
  4. a COLMAP known-pose triangulation for points3d.ply
     (`n3v2blender.py:336-410`) — requires the external `colmap` binary;
     when unavailable the trainer falls back to random init.

Steps 2-3 are pure numpy and always available; 1 and 4 shell out and are
gated on the external tools being installed:

    python3 -m fourdgs_tpu_torch.data.n3v <scene dir> [--test_cam_index 0]
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess

import numpy as np

FRAME_RATE = 30.0
TARGET_RADIUS = 4.0


def _rotmat_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector a to unit vector b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-10:
        return np.eye(3) if c > 0 else -np.eye(3)
    s = np.linalg.norm(v)
    kmat = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + kmat + kmat @ kmat * ((1 - c) / (s ** 2))


def _closest_point_two_lines(oa, da, ob, db):
    """Point closest to two rays + a confidence weight (colmap2nerf)."""
    da = da / np.linalg.norm(da)
    db = db / np.linalg.norm(db)
    c = np.cross(da, db)
    denom = np.linalg.norm(c) ** 2
    t = ob - oa
    ta = np.linalg.det([t, db, c]) / (denom + 1e-10)
    tb = np.linalg.det([t, da, c]) / (denom + 1e-10)
    ta = max(ta, 0.0)
    tb = max(tb, 0.0)
    return (oa + ta * da + ob + tb * db) * 0.5, denom


def convert_llff_poses(poses_bounds: np.ndarray):
    """LLFF (N, 17) poses_bounds -> recentered/rescaled c2w (N, 4, 4),
    plus (H, W, focal)."""
    poses = poses_bounds[:, :15].reshape(-1, 3, 5)
    n = poses.shape[0]
    h, w, fl = poses[0, :, -1]

    # LLFF's [down, right, back] -> [right, down, back] column order,
    # then the colmap2nerf basis flips.
    poses = np.concatenate(
        [poses[..., 1:2], poses[..., 0:1], -poses[..., 2:3], poses[..., 3:4]],
        axis=-1)
    bottom = np.tile(np.array([0, 0, 0, 1.0]), (n, 1, 1))
    poses = np.concatenate([poses, bottom], axis=1)
    poses[:, 0:3, 1] *= -1
    poses[:, 0:3, 2] *= -1
    poses = poses[:, [1, 0, 2, 3], :]
    poses[:, 2, :] *= -1

    up = poses[:, 0:3, 1].sum(0)
    r3 = _rotmat_between(up, np.array([0.0, 0.0, 1.0]))
    r4 = np.eye(4)
    r4[:3, :3] = r3
    poses = np.einsum("ij,njk->nik", r4, poses)

    # Recenter at the weighted closest point of all view rays.
    totw, totp = 0.0, np.zeros(3)
    for i in range(n):
        mi = poses[i, :3, :]
        for j in range(i + 1, n):
            mj = poses[j, :3, :]
            point, weight = _closest_point_two_lines(
                mi[:, 3], mi[:, 2], mj[:, 3], mj[:, 2])
            if weight > 0.01:
                totp += point * weight
                totw += weight
    if totw > 0:
        poses[:, :3, 3] -= totp / totw

    avglen = np.linalg.norm(poses[:, :3, 3], axis=-1).mean()
    poses[:, :3, 3] *= TARGET_RADIUS / avglen
    return poses, int(h), int(w), float(fl)


def extract_frames(path: str) -> bool:
    """ffmpeg frame extraction for every *.mp4 (cam video) in `path`."""
    if shutil.which("ffmpeg") is None:
        return False
    images_path = os.path.join(path, "images")
    os.makedirs(images_path, exist_ok=True)
    for video in sorted(glob.glob(os.path.join(path, "*.mp4"))):
        cam = os.path.splitext(os.path.basename(video))[0]
        subprocess.run(
            ["ffmpeg", "-y", "-i", video, "-start_number", "0",
             os.path.join(images_path, f"{cam}_%04d.png")],
            check=True, capture_output=True)
    return True


def write_transforms(path: str, test_cam_index: int = 0,
                     frame_rate: float = FRAME_RATE) -> None:
    """Pose conversion + transforms_{train,test}.json writing (pure)."""
    images = sorted(
        f for f in os.listdir(os.path.join(path, "images"))
        if f.lower().endswith((".png", ".jpg", ".jpeg")))
    cams = sorted({im.split("_")[0] for im in images})
    poses_bounds = np.load(os.path.join(path, "poses_bounds.npy"))
    if poses_bounds.shape[0] != len(cams):
        raise ValueError(
            f"{poses_bounds.shape[0]} poses != {len(cams)} cameras")
    poses, h, w, fl = convert_llff_poses(poses_bounds)

    train_frames, test_frames = [], []
    for i, cam in enumerate(cams):
        frames = []
        for im in images:
            if not im.startswith(cam + "_"):
                continue
            stem = os.path.splitext(im)[0]
            frame_no = int(stem.split("_")[-1])
            frames.append({
                "file_path": f"images/{stem}",
                "transform_matrix": poses[i].tolist(),
                "time": frame_no / frame_rate,
            })
        if i == test_cam_index:
            test_frames += frames
        else:
            train_frames += frames

    meta = {"w": w, "h": h, "fl_x": fl, "fl_y": fl,
            "cx": w // 2, "cy": h // 2}
    with open(os.path.join(path, "transforms_train.json"), "w") as f:
        json.dump({**meta, "frames": train_frames}, f, indent=2)
    with open(os.path.join(path, "transforms_test.json"), "w") as f:
        json.dump({**meta, "frames": test_frames}, f, indent=2)


# NeRF/Blender camera convention -> OpenCV (flip y/z), used when handing
# the known poses to COLMAP (`n3v2blender.py:337`).
BLENDER2OPENCV = np.diag([1.0, -1.0, -1.0, 1.0])


def rotmat_to_qvec(r: np.ndarray) -> np.ndarray:
    """World-to-cam rotation -> COLMAP (qw, qx, qy, qz) quaternion."""
    qw = 0.5 * np.sqrt(max(1.0 + r[0, 0] + r[1, 1] + r[2, 2], 1e-12))
    return np.array([
        qw,
        (r[2, 1] - r[1, 2]) / (4 * qw),
        (r[0, 2] - r[2, 0]) / (4 * qw),
        (r[1, 0] - r[0, 1]) / (4 * qw),
    ])


def write_known_pose_model(path: str, ws: str) -> list[str]:
    """Write the COLMAP `created/sparse` text model (shared PINHOLE camera
    + known w2c poses for the time==0 train frames + empty points3D) and
    symlink those frames into `ws/images`. Pure file I/O — unit-testable
    without the colmap binary. Mirrors `n3v2blender.py:338-370`.

    Returns the frame file names registered in the model."""
    with open(os.path.join(path, "transforms_train.json")) as f:
        meta = json.load(f)
    created = os.path.join(ws, "created", "sparse")
    imgdir = os.path.join(ws, "images")
    os.makedirs(created, exist_ok=True)
    os.makedirs(imgdir, exist_ok=True)

    with open(os.path.join(created, "cameras.txt"), "w") as f:
        f.write(f"1 PINHOLE {int(meta['w'])} {int(meta['h'])} "
                f"{meta['fl_x']} {meta['fl_y']} {meta['cx']} {meta['cy']}")

    fnames = []
    with open(os.path.join(created, "images.txt"), "w") as f:
        idx = 1
        for frame in meta["frames"]:
            if frame["time"] != 0:
                continue
            stem = frame["file_path"].split("/")[-1]
            fname = stem + ".png"
            c2w = np.array(frame["transform_matrix"]) @ BLENDER2OPENCV
            r = np.linalg.inv(c2w[:3, :3])
            t = -r @ c2w[:3, 3]
            q = rotmat_to_qvec(r)
            f.write(f"{idx} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]} 1 {fname}\n\n")
            src = os.path.abspath(os.path.join(path, "images", fname))
            dst = os.path.join(imgdir, fname)
            if not os.path.exists(dst):
                os.symlink(src, dst)
            fnames.append(fname)
            idx += 1

    with open(os.path.join(created, "points3D.txt"), "w") as f:
        f.write("")
    return fnames


def _set_db_cameras(db_path: str, cameras_txt: str) -> None:
    """Overwrite the feature-extractor's auto-guessed intrinsics in the
    COLMAP database with the known ones (`camTodatabase`,
    `n3v2blender.py:130-200`): every image shares PINHOLE camera 1."""
    import sqlite3

    from .colmap import MODEL_NAME_TO_ID as models

    conn = sqlite3.connect(db_path)
    with open(cameras_txt) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), models[parts[1]]
            width, height = int(parts[2]), int(parts[3])
            params = np.asarray(parts[4:], np.float64).tobytes()
            conn.execute(
                "UPDATE cameras SET model=?, width=?, height=?, params=?, "
                "prior_focal_length=1 WHERE camera_id=?",
                (model, width, height, params, cam_id))
    conn.commit()
    conn.close()


def _colmap(*args: str) -> None:
    subprocess.run(["colmap", *args], check=True, capture_output=True)


def triangulate_points(path: str) -> bool:
    """COLMAP *known-pose* triangulation -> `points3d.ply`, mirroring
    `n3v2blender.py:336-410`: feature extraction over the time-0 frames,
    known intrinsics forced into the database, exhaustive matching,
    `point_triangulator` against the created pose model, then dense
    patch-match stereo + fusion. When the dense stage is unavailable
    (no CUDA), falls back to exporting the triangulated sparse points.

    Returns True only if `points3d.ply` was actually produced."""
    if shutil.which("colmap") is None:
        return False
    ws = os.path.join(path, "colmap_tmp")
    out_ply = os.path.join(path, "points3d.ply")
    try:
        write_known_pose_model(path, ws)
        db = os.path.join(ws, "database.db")
        imgs = os.path.join(ws, "images")
        created = os.path.join(ws, "created", "sparse")
        tri = os.path.join(ws, "triangulated", "sparse")
        os.makedirs(tri, exist_ok=True)
        _colmap("feature_extractor", "--database_path", db,
                "--image_path", imgs)
        _set_db_cameras(db, os.path.join(created, "cameras.txt"))
        _colmap("exhaustive_matcher", "--database_path", db)
        _colmap("point_triangulator", "--database_path", db,
                "--image_path", imgs, "--input_path", created,
                "--output_path", tri)
        try:
            dense = os.path.join(ws, "dense")
            os.makedirs(dense, exist_ok=True)
            _colmap("image_undistorter", "--image_path", imgs,
                    "--input_path", tri, "--output_path", dense)
            _colmap("patch_match_stereo", "--workspace_path", dense)
            _colmap("stereo_fusion", "--workspace_path", dense,
                    "--output_path", out_ply)
        except (subprocess.CalledProcessError, OSError):
            # Dense stereo needs CUDA; export the sparse triangulation.
            from .colmap import read_points3d
            from .pointcloud import write_ply
            xyz, rgb, _err = read_points3d(tri)
            if xyz.shape[0] == 0:
                return False
            print("[n3v] dense stereo unavailable — writing sparse "
                  f"triangulated points ({xyz.shape[0]})")
            write_ply(out_ply, xyz, rgb)
    except (subprocess.CalledProcessError, OSError) as exc:
        print(f"[n3v] colmap triangulation failed: {exc}")
        return False
    finally:
        shutil.rmtree(ws, ignore_errors=True)
        vis = out_ply + ".vis"
        if os.path.exists(vis):
            os.remove(vis)
    return os.path.exists(out_ply)


def preprocess_n3v(path: str, test_cam_index: int = 0) -> None:
    """The whole offline preprocessing: frames, transforms, points."""
    if not os.path.isdir(os.path.join(path, "images")):
        if not extract_frames(path):
            raise RuntimeError(
                "no images/ directory and ffmpeg unavailable for "
                "frame extraction")
    write_transforms(path, test_cam_index)
    if not os.path.exists(os.path.join(path, "points3d.ply")):
        if not triangulate_points(path):
            print("[n3v] colmap unavailable — trainer will fall back to "
                  "random point initialization")


if __name__ == "__main__":  # CLI parity with scripts/n3v2blender.py:221-232
    import argparse

    _p = argparse.ArgumentParser(
        description="N3V/DyNeRF scene preprocessing: ffmpeg frame "
        "extraction, LLFF poses -> transforms_{train,test}.json, COLMAP "
        "known-pose triangulation -> points3d.ply")
    _p.add_argument("path", help="scene dir with *.mp4 + poses_bounds.npy")
    _p.add_argument("--test_cam_index", type=int, default=0,
                    help="camera held out for eval (reference: cam00)")
    _a = _p.parse_args()
    preprocess_n3v(_a.path, _a.test_cam_index)
