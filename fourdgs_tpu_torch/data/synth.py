"""Self-contained synthetic dynamic-scene benchmark: a known moving scene,
its ground-truth renders and a Blender/DNeRF-format dataset on disk.

PyTorch counterpart of `fourdgs_tpu/data/synth.py`. The scene, the poses,
the times and the sky are that module's numpy code, copied as it is, so
that the same seed gives the same scene bit for bit. The ground truth is
rendered by the port's brute-force oracle (`ops/reference_renderer.py`,
not the tile pipeline under test) on `device`, and the files written
(PNGs, transforms_{train,test}.json, gt_cloud.npz, synth_manifest.json)
are the JAX generator's, so that either package's dataset feeds either
trainer. Used by `python -m fourdgs_tpu_torch.gen_synth_dataset`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from typing import List

import numpy as np
import torch

from ..ops.preprocess import RenderOptions
from ..ops.reference_renderer import render_reference
from ..ops.sh import C0
from .cameras import Camera



# --------------------------------------------------------------- sampling

def _fibonacci_sphere(n: int) -> np.ndarray:
    """(n, 3) roughly-uniform points on the unit sphere."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = math.pi * (3.0 - math.sqrt(5.0)) * i
    z = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def _sunflower_disk(n: int) -> np.ndarray:
    """(n, 2) roughly-uniform points on the unit disk."""
    i = np.arange(n, dtype=np.float64) + 0.5
    r = np.sqrt(i / n)
    phi = math.pi * (3.0 - math.sqrt(5.0)) * i
    return np.stack([r * np.cos(phi), r * np.sin(phi)], axis=1)


def _box_surface(n: int, half: np.ndarray, rng) -> np.ndarray:
    """(n, 3) uniform points on the surface of a box with half-extents."""
    hx, hy, hz = half
    areas = np.array([hy * hz, hy * hz, hx * hz, hx * hz, hx * hy, hx * hy])
    face = rng.choice(6, size=n, p=areas / areas.sum())
    u = rng.uniform(-1, 1, n)
    v = rng.uniform(-1, 1, n)
    pts = np.empty((n, 3))
    sign = np.where(face % 2 == 0, 1.0, -1.0)
    ax = face // 2          # 0:x faces, 1:y faces, 2:z faces
    pts[ax == 0] = np.stack([sign[ax == 0] * hx, u[ax == 0] * hy,
                             v[ax == 0] * hz], axis=1)
    pts[ax == 1] = np.stack([u[ax == 1] * hx, sign[ax == 1] * hy,
                             v[ax == 1] * hz], axis=1)
    pts[ax == 2] = np.stack([u[ax == 2] * hx, v[ax == 2] * hy,
                             sign[ax == 2] * hz], axis=1)
    return pts


def _axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    c, s = math.cos(angle), math.sin(angle)
    x, y, z = axis
    return np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ])


# ------------------------------------------------------------------ scene

@dataclasses.dataclass
class Body:
    """One rigid body: local surface points + a smooth trajectory."""
    local: np.ndarray      # (n, 3) local-frame points
    colors: np.ndarray     # (n, 3) in [0, 1]
    scale: float           # per-point gaussian scale (isotropic)
    center0: np.ndarray    # (3,) base position
    orbit_amp: np.ndarray  # (3,) sinusoid amplitudes per axis
    orbit_freq: np.ndarray  # (3,) cycles over the unit duration
    orbit_phase: np.ndarray  # (3,)
    spin_axis: np.ndarray  # (3,) rotation axis
    spin_rate: float       # radians over the unit duration

    def positions_at(self, u: float) -> np.ndarray:
        """World positions at normalized time u in [0, 1]."""
        rot = _axis_angle(self.spin_axis, self.spin_rate * u)
        center = self.center0 + self.orbit_amp * np.sin(
            2 * math.pi * self.orbit_freq * u + self.orbit_phase)
        return self.local @ rot.T + center


@dataclasses.dataclass
class SynthScene:
    bodies: List[Body]

    @property
    def n_points(self) -> int:
        return sum(b.local.shape[0] for b in self.bodies)

    def colors(self) -> np.ndarray:
        return np.concatenate([b.colors for b in self.bodies]).astype(np.float32)

    def scales(self) -> np.ndarray:
        return np.concatenate([np.full(b.local.shape[0], b.scale)
                               for b in self.bodies]).astype(np.float32)

    def positions_at(self, u: float) -> np.ndarray:
        return np.concatenate([b.positions_at(u)
                               for b in self.bodies]).astype(np.float32)


def _smooth_colors(pts: np.ndarray, base: np.ndarray, k: np.ndarray,
                   amp: float = 0.28) -> np.ndarray:
    """Low-frequency per-point color field around a base color."""
    phase = pts @ k.T                      # (n, 3)
    return np.clip(base + amp * np.sin(phase), 0.03, 0.97)


def make_scene(points_scale: float = 1.0, seed: int = 0) -> SynthScene:
    """Three bobbing/orbiting balls + a spinning box over a static disk.

    All geometry stays inside [-1.3, 1.3]^3 so the reference's random
    init volume (`dataset_readers.py:326-333`) covers it. Motion is a
    fraction of a unit over the duration — representable by temporally
    sliced 4D gaussians with linear per-slice velocity.
    """
    rng = np.random.default_rng(seed)
    ns = max(1, int(round(1800 * points_scale)))

    def sphere_body(n, radius, center, amp, freq, phase, hue, k):
        local = _fibonacci_sphere(n) * radius
        spacing = math.sqrt(4 * math.pi * radius * radius / n)
        return Body(local=local,
                    colors=_smooth_colors(local / radius, hue, k),
                    scale=0.75 * spacing,
                    center0=np.asarray(center, np.float64),
                    orbit_amp=np.asarray(amp, np.float64),
                    orbit_freq=np.asarray(freq, np.float64),
                    orbit_phase=np.asarray(phase, np.float64),
                    spin_axis=np.array([0.0, 0.0, 1.0]), spin_rate=0.0)

    bodies = [
        # Ground disk (static, slight warm checker-like shading).
        Body(local=np.concatenate(
                [_sunflower_disk(ns) * 1.05,
                 np.zeros((ns, 1))], axis=1),
             colors=_smooth_colors(
                 np.concatenate([_sunflower_disk(ns) * 1.05,
                                 np.zeros((ns, 1))], axis=1),
                 np.array([0.62, 0.55, 0.45]),
                 np.array([[4.1, 1.3, 0.0], [1.1, 4.7, 0.0],
                           [2.9, 2.9, 0.0]])),
             scale=0.75 * math.sqrt(math.pi * 1.05 ** 2 / ns),
             center0=np.array([0.0, 0.0, -0.55]),
             orbit_amp=np.zeros(3), orbit_freq=np.zeros(3),
             orbit_phase=np.zeros(3),
             spin_axis=np.array([0.0, 0.0, 1.0]), spin_rate=0.0),
        sphere_body(int(round(900 * points_scale)) or 1, 0.30,
                    center=[-0.55, -0.15, 0.05],
                    amp=[0.12, 0.12, 0.38], freq=[1.0, 1.0, 1.0],
                    phase=[0.0, math.pi / 2, 0.0],
                    hue=np.array([0.75, 0.25, 0.20]),
                    k=np.array([[3.0, 0.5, 0.5], [0.5, 3.0, 0.5],
                                [0.5, 0.5, 3.0]])),
        sphere_body(int(round(650 * points_scale)) or 1, 0.24,
                    center=[0.50, 0.25, -0.10],
                    amp=[0.10, 0.10, 0.34], freq=[1.0, 1.0, 1.0],
                    phase=[math.pi, 3 * math.pi / 2, math.pi / 2],
                    hue=np.array([0.20, 0.55, 0.80]),
                    k=np.array([[2.5, 1.0, 0.0], [0.0, 2.5, 1.0],
                                [1.0, 0.0, 2.5]])),
        sphere_body(int(round(420 * points_scale)) or 1, 0.18,
                    center=[0.05, 0.55, 0.30],
                    amp=[0.35, 0.35, 0.10], freq=[0.5, 0.5, 1.0],
                    phase=[0.0, math.pi / 2, math.pi],
                    hue=np.array([0.25, 0.70, 0.30]),
                    k=np.array([[4.0, 0.0, 1.0], [1.0, 4.0, 0.0],
                                [0.0, 1.0, 4.0]])),
    ]
    # Spinning box with face-varying color.
    nb = max(1, int(round(900 * points_scale)))
    half = np.array([0.28, 0.20, 0.16])
    local = _box_surface(nb, half, rng)
    spacing = math.sqrt(2 * (half[0] * half[1] + half[1] * half[2]
                             + half[0] * half[2]) * 4 / nb)
    bodies.append(Body(
        local=local,
        colors=_smooth_colors(local / half, np.array([0.80, 0.65, 0.20]),
                              np.array([[1.8, 0.4, 0.4], [0.4, 1.8, 0.4],
                                        [0.4, 0.4, 1.8]]), amp=0.22),
        scale=0.80 * spacing,
        center0=np.array([0.05, -0.50, 0.38]),
        orbit_amp=np.array([0.0, 0.0, 0.12]),
        orbit_freq=np.array([0.0, 0.0, 1.0]),
        orbit_phase=np.array([0.0, 0.0, math.pi / 3]),
        spin_axis=np.array([0.3, 0.5, 0.8]), spin_rate=math.pi))
    return SynthScene(bodies=bodies)


# ---------------------------------------------------------------- cameras

FOVX = 0.6911112070083618  # blender-synthetic camera_angle_x


def look_at_pose(eye: np.ndarray, target=None, up=None):
    """Returns (rot, trans) in the repo Camera convention (COLMAP: rot is
    cam→world rotation, trans is world→cam translation) plus the OpenGL
    c2w matrix to store in transforms json (the reader flips it back,
    `scene/dataset_readers.py:224-229` / data/scene.py:119-123)."""
    target = np.zeros(3) if target is None else np.asarray(target, np.float64)
    up = np.array([0.0, 0.0, 1.0]) if up is None else np.asarray(up, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    r_w2c = np.stack([right, down, fwd])           # rows: COLMAP x,y,z
    trans = -r_w2c @ eye
    c2w = np.eye(4)
    c2w[:3, :3] = r_w2c.T
    c2w[:3, 3] = eye
    c2w_gl = c2w.copy()
    c2w_gl[:3, 1:3] *= -1                           # COLMAP → OpenGL axes
    return r_w2c.T, trans, c2w_gl


def sample_train_poses(n: int, seed: int, radius: float = 4.2):
    """Random upper-hemisphere poses + stratified-shuffled times."""
    rng = np.random.default_rng(seed + 17)
    az = rng.uniform(0, 2 * math.pi, n)
    el = rng.uniform(0.25, 1.15, n)
    rad = radius + rng.uniform(-0.25, 0.25, n)
    times = (np.arange(n) + rng.uniform(0, 1, n)) / n
    rng.shuffle(times)
    eyes = np.stack([rad * np.cos(el) * np.cos(az),
                     rad * np.cos(el) * np.sin(az),
                     rad * np.sin(el)], axis=1)
    return eyes, times


def sample_test_poses(n: int, radius: float = 4.2):
    """Evenly spaced ring at fixed elevation, evenly spaced times offset
    from the train grid."""
    az = np.linspace(0, 2 * math.pi, n, endpoint=False) + 0.13
    el = np.full(n, 0.62)
    eyes = np.stack([radius * np.cos(el) * np.cos(az),
                     radius * np.cos(el) * np.sin(az),
                     radius * np.sin(el)], axis=1)
    times = (np.arange(n) + 0.5) / n
    return eyes, times

# -------------------------------------------------------------- rendering

@contextlib.contextmanager
def _ieee_f32_matmul():
    """Matrix products in full f32, never TF32, on a CUDA device: the
    oracle's colour is a product (`render_reference`'s w @ feat)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def render_frames(scene: SynthScene, eyes, times, width: int, height: int,
                  white_background: bool = True, device="cuda"):
    """Oracle-render each (pose, time) on `device` (in the oracle's bands
    of tile rows). Per frame the scene is evaluated to a
    static 3D cloud (positions at that time) and rendered with
    gaussian_dim=3, opacity 0.92, identity rotations and the colour
    through the DC SH term (rgb = C0 * sh + 0.5, ops/sh.py) — GT never
    touches the 4D production path under test. Yields ((H, W, 3) colour
    clipped to [0, 1], (H, W) alpha) as f32 numpy arrays."""
    p = scene.n_points
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    sh = ((scene.colors() - 0.5) / C0).astype(np.float32)[:, None, :]
    quat = np.zeros((p, 4), np.float32)
    quat[:, 0] = 1.0
    fixed = dict(
        t=as_t(np.zeros(p, np.float32)),
        scales=as_t(np.repeat(scene.scales()[:, None], 3, axis=1)),
        scales_t=as_t(np.ones(p, np.float32)),
        rotations=as_t(quat), rotations_r=as_t(quat),
        opacity=as_t(np.full(p, 0.92, np.float32)), sh=as_t(sh),
        active=as_t(np.ones(p, bool)),
        bg=as_t(np.float32([1.0, 1.0, 1.0] if white_background
                           else [0.0] * 3)),
        opts=RenderOptions(height=height, width=width, gaussian_dim=3,
                           rot_4d=False))
    fovy = 2 * math.atan(math.tan(FOVX / 2) * height / width)
    for eye, u in zip(eyes, times):
        rot, trans, _ = look_at_pose(np.asarray(eye))
        cam = Camera(uid=0, rot=rot, trans=trans, fovx=FOVX, fovy=fovy,
                     width=width, height=height)
        with torch.no_grad(), _ieee_f32_matmul():
            color, _, _, alpha = render_reference(
                means3d=as_t(scene.positions_at(float(u))),
                camera=cam.arrays(device), **fixed)
            color = torch.clamp(color, 0.0, 1.0)
        yield color.cpu().numpy(), alpha.cpu().numpy()

def _sky_texture(res: int = 256, seed: int = 0) -> np.ndarray:
    """(res, res, 3) dim procedural equirect sky: smooth elevation
    gradient + low-frequency azimuth bands. Deliberately dark (<~0.35):
    the loader's alpha-mask convention multiplies GT rgb by alpha
    (`fetch_gt`, mirroring reference `scene/cameras.py:53-56`), so the
    sky's supervised target is near-black — a dim true sky keeps the
    dataset self-consistent."""
    rng = np.random.default_rng(seed + 91)
    v = np.linspace(0.0, 1.0, res)[:, None]
    u = np.linspace(0.0, 2 * np.pi, res)[None, :]
    base = 0.28 * (1.0 - v) + 0.04
    bands = 0.06 * np.sin(3 * u + rng.uniform(0, 6.3)) \
        + 0.04 * np.sin(7 * u + rng.uniform(0, 6.3))
    tex = np.stack([base + bands * 0.5,
                    base * 0.9 + bands,
                    base * 1.15 + bands * 0.3], axis=-1)
    return np.clip(tex, 0.0, 0.4).astype(np.float32)


def rig_poses(n_cams: int, radius: float = 4.2, seed: int = 0):
    """Fixed multi-camera rig (DyNeRF-style): cameras on an upper-
    hemisphere ring with deterministic jitter, all aimed at the scene.
    Camera 0 is the held-out test view (the N3V convention,
    `scripts/n3v2blender.py` / data/n3v.py)."""
    rng = np.random.default_rng(seed + 31)
    az = np.linspace(0, 2 * math.pi, n_cams, endpoint=False) \
        + rng.uniform(-0.12, 0.12, n_cams)
    el = 0.62 + rng.uniform(-0.22, 0.22, n_cams)
    rad = radius + rng.uniform(-0.3, 0.3, n_cams)
    return np.stack([rad * np.cos(el) * np.cos(az),
                     rad * np.cos(el) * np.sin(az),
                     rad * np.sin(el)], axis=1)


def _manifest_matches(man_path: str, manifest: dict) -> bool:
    if not os.path.exists(man_path):
        return False
    with open(man_path) as f:
        return json.load(f) == manifest


def _save_png(path: str, img: np.ndarray):
    """An image in [0, 1] as 8-bit PNG, truncated as the JAX generator
    quantises: (x * 255).astype(uint8)."""
    from PIL import Image
    Image.fromarray((img * 255).astype(np.uint8)).save(path)


def _report(tag: str, frames: int, t0: float, verbose: bool):
    if verbose:
        s = time.perf_counter() - t0
        print(f"[{tag}] {frames} frames in {s:.2f} s "
              f"({s / max(frames, 1) * 1e3:.1f} ms/frame)", flush=True)


def generate_dataset_dynerf(
        out_dir: str, *, n_cams: int = 15, n_frames: int = 60,
        n_test_frames: int = 20, width: int = 400, height: int = 400,
        points_scale: float = 1.0, seed: int = 0, duration: float = 10.0,
        verbose: bool = False, device="cuda") -> str:
    """DyNeRF-modality synthetic dataset: a FIXED rig of `n_cams`
    cameras each capturing `n_frames` video frames over [0, duration],
    written as Blender transforms with absolute `time` values. Camera 0
    is held out as the test view. Frames are RGBA: rgb = oracle render
    + (1 - alpha) * procedural sky (sampled through the trainable env
    map's own math, models/envmap.py), alpha = oracle coverage. Renders
    on `device`; skips regeneration when a matching manifest exists.
    Returns out_dir."""
    from ..models import envmap as envmap_lib

    manifest = dict(kind="dynerf", n_cams=n_cams, n_frames=n_frames,
                    n_test_frames=n_test_frames, width=width,
                    height=height, points_scale=points_scale, seed=seed,
                    duration=duration, version=1)
    man_path = os.path.join(out_dir, "synth_manifest.json")
    if _manifest_matches(man_path, manifest):
        return out_dir

    t0 = time.perf_counter()
    scene = make_scene(points_scale=points_scale, seed=seed)
    eyes = rig_poses(n_cams, seed=seed)
    sky = _sky_texture(seed=seed)
    sky_t = torch.as_tensor(sky, device=device)
    train_times = (np.arange(n_frames) + 0.5) / n_frames * duration
    test_times = (np.arange(n_test_frames) + 0.25) / n_test_frames \
        * duration

    splits = {
        "train": [(c, t) for c in range(1, n_cams) for t in train_times],
        "test": [(0, t) for t in test_times],
    }
    fovy = 2 * math.atan(math.tan(FOVX / 2) * height / width)
    total = 0
    for split, pairs in splits.items():
        img_dir = os.path.join(out_dir, split)
        os.makedirs(img_dir, exist_ok=True)
        frames = []
        done = 0
        for cam_i in sorted({c for c, _ in pairs}):
            times = [t for c, t in pairs if c == cam_i]
            eye = eyes[cam_i]
            rot, trans, c2w_gl = look_at_pose(np.asarray(eye))
            cam = Camera(uid=cam_i, rot=rot, trans=trans, fovx=FOVX,
                         fovy=fovy, width=width, height=height)
            # Sky is per-camera constant (static rig): sample once.
            intr = np.array([
                width / (2 * math.tan(FOVX / 2)),
                height / (2 * math.tan(fovy / 2)),
                width / 2.0, height / 2.0], np.float32)
            with torch.no_grad():
                origin, dirs = envmap_lib.camera_rays(
                    torch.as_tensor(cam.viewmatrix, device=device),
                    torch.as_tensor(intr, device=device), height, width)
                sky_img = envmap_lib.sample_sky(sky_t, origin,
                                                dirs).cpu().numpy()
            renders = render_frames(scene, [eye] * len(times),
                                    np.asarray(times) / duration,
                                    width, height, white_background=False,
                                    device=device)
            for t, (color, alpha) in zip(times, renders):
                rgb = np.clip(color + (1.0 - alpha)[..., None] * sky_img,
                              0.0, 1.0)
                rgba = np.concatenate(
                    [rgb, np.clip(alpha, 0, 1)[..., None]], axis=-1)
                name = f"cam{cam_i:02d}_f{done:04d}"
                _save_png(os.path.join(img_dir, name + ".png"), rgba)
                frames.append({"file_path": f"./{split}/{name}",
                               "time": float(t),
                               "transform_matrix": c2w_gl.tolist()})
                done += 1
                if verbose and done % 40 == 0:
                    print(f"[synth-dynerf] {split}: {done}/{len(pairs)}",
                          flush=True)
        total += done
        with open(os.path.join(out_dir, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": FOVX, "frames": frames}, f)
    np.savez(os.path.join(out_dir, "gt_cloud.npz"),
             colors=scene.colors(), scales=scene.scales(),
             positions_t0=scene.positions_at(0.0),
             positions_t1=scene.positions_at(1.0),
             sky=sky)
    with open(man_path, "w") as f:
        json.dump(manifest, f)
    _report("synth-dynerf", total, t0, verbose)
    return out_dir


def generate_dataset(out_dir: str, *, n_train: int = 100, n_test: int = 20,
                     width: int = 400, height: int = 400,
                     points_scale: float = 1.0, seed: int = 0,
                     verbose: bool = False, device="cuda") -> str:
    """Write the full Blender/DNeRF-format dataset, rendered on `device`.
    Returns out_dir. Skips regeneration when a matching manifest already
    exists."""
    manifest = dict(n_train=n_train, n_test=n_test, width=width,
                    height=height, points_scale=points_scale, seed=seed,
                    version=1)
    man_path = os.path.join(out_dir, "synth_manifest.json")
    if _manifest_matches(man_path, manifest):
        return out_dir

    t0 = time.perf_counter()
    scene = make_scene(points_scale=points_scale, seed=seed)
    splits = {
        "train": sample_train_poses(n_train, seed),
        "test": sample_test_poses(n_test),
    }
    for split, (eyes, times) in splits.items():
        img_dir = os.path.join(out_dir, split)
        os.makedirs(img_dir, exist_ok=True)
        frames = []
        renders = render_frames(scene, eyes, times, width, height,
                                device=device)
        for i, ((color, _alpha), u) in enumerate(zip(renders, times)):
            name = f"r_{i:03d}"
            _save_png(os.path.join(img_dir, name + ".png"), color)
            _, _, c2w_gl = look_at_pose(np.asarray(eyes[i]))
            frames.append({"file_path": f"./{split}/{name}",
                           "time": float(u),
                           "transform_matrix": c2w_gl.tolist()})
            if verbose and (i + 1) % 20 == 0:
                print(f"[synth] {split}: {i + 1}/{len(times)} frames",
                      flush=True)
        with open(os.path.join(out_dir, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": FOVX, "frames": frames}, f)
    np.savez(os.path.join(out_dir, "gt_cloud.npz"),
             colors=scene.colors(), scales=scene.scales(),
             positions_t0=scene.positions_at(0.0),
             positions_t1=scene.positions_at(1.0))
    with open(man_path, "w") as f:
        json.dump(manifest, f)
    _report("synth", n_train + n_test, t0, verbose)
    return out_dir
