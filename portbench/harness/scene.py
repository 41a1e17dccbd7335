"""The inputs of a training cell, made from the run's seed: the dataset's
cameras, its images, and the training state at the traffic's start
iteration (the gaussians, their Adam moments, the environment map).

Nothing here imports the program. The dataset kinds follow the published
datasets' layouts: "dnerf" (Blender transforms, images held in memory,
a transparent background) and "n3v" (a rig of video cameras with pixel
intrinsics, frames read from PNG files as the scene loader's lazy
dataloader reads them).
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.gs4d import SH_C0, Pose, knn_exact

SEED_MOD = 1 << 63


class Frame(NamedTuple):
    """One training image: its pose and where its pixels come from (an
    index into `Data.images`, or a PNG path)."""
    pose: Pose
    name: str
    image: int = -1
    path: str = ""


class Data(NamedTuple):
    frames: list           # [Frame] of the train split
    images: np.ndarray | None   # (N, H, W, 3) f32 colour, in-memory sets
    alphas: np.ndarray | None   # (N, H, W) f32 coverage
    params: dict           # raw leaves, on the device
    env: torch.Tensor | None    # (R, R, 3) environment map texture


def generators(seed: int, device):
    """(numpy Generator, torch Generator on `device`) of the run's seed."""
    seed = int(seed) % SEED_MOD
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return np.random.default_rng(seed), g


def look_at(eye, target, up) -> tuple[np.ndarray, np.ndarray]:
    """COLMAP (rot, trans) of a camera at `eye` looking at `target`, from
    the Blender/OpenGL camera-to-world matrix a transforms file holds
    (its y and z axes flipped, as the Blender reader does)."""
    fwd = np.asarray(target, float) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (right, true_up, -fwd,
                                                      eye)
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    return np.transpose(w2c[:3, :3]), w2c[:3, 3]


def scaled_size(size, resolution: int):
    """The scene loader's size for a resolution divisor in {1,2,3,4,8}."""
    return round(size[0] / resolution), round(size[1] / resolution)


def dnerf_frames(ds: dict, resolution: int, rng) -> list:
    """D-NeRF's train split: views on the upper hemisphere at the
    dataset's camera distance, one per time step of [0, 1]."""
    w, h = scaled_size(ds["image_size"], resolution)
    n = ds["train_views"]
    fovx = ds["camera_angle_x"]
    focal = ds["image_size"][0] / (2 * math.tan(fovx / 2))
    fovy = 2 * math.atan(ds["image_size"][1] / (2 * focal))
    lo, hi = np.radians(ds["elevation_deg"])
    frames = []
    for i in range(n):
        az = rng.uniform(0, 2 * math.pi)
        el = rng.uniform(lo, hi)
        eye = ds["camera_distance"] * np.array(
            [math.cos(el) * math.cos(az), math.cos(el) * math.sin(az),
             math.sin(el)])
        rot, trans = look_at(eye, np.zeros(3), np.array([0.0, 0.0, 1.0]))
        pose = Pose(rot, trans, w, h, i / max(n - 1, 1), fovx, fovy)
        frames.append(Frame(pose, f"r_{i:03d}", image=i))
    return frames


def n3v_frames(ds: dict, resolution: int, rng, pool: list) -> list:
    """N3V's train split: a rig of cameras on an arc facing the scene
    (cam00 held out), every frame of the clip at the dataset's frame
    rate; each frame's pixels are one of the PNGs of `pool`, drawn from
    the seed."""
    full_w, full_h = ds["image_size"]
    w, h = scaled_size(ds["image_size"], resolution)
    s = full_w / w
    lo, hi = np.radians(ds["rig_azimuth_deg"])
    frames = []
    for c in range(ds["cameras"]):
        if c == ds["test_camera"]:
            continue
        az = lo + (hi - lo) * c / (ds["cameras"] - 1) + rng.normal(0, 0.01)
        el = math.radians(ds["rig_elevation_deg"]) + rng.normal(0, 0.02)
        eye = ds["rig_radius"] * np.array(
            [math.sin(az) * math.cos(el), -math.cos(az) * math.cos(el),
             math.sin(el)])
        rot, trans = look_at(eye, np.zeros(3), np.array([0.0, 0.0, 1.0]))
        pick = rng.integers(0, len(pool), ds["frames"])
        for f in range(ds["frames"]):
            pose = Pose(rot, trans, w, h, f / ds["fps"], -1.0, -1.0,
                        fl_x=ds["focal"] / s, fl_y=ds["focal"] / s,
                        cx=(full_w // 2) / s, cy=(full_h // 2) / s)
            frames.append(Frame(pose, f"cam{c:02d}_{f:04d}",
                                path=pool[pick[f]]))
    return frames


def png_pool(ds: dict, root: str) -> list:
    """The dataset's pool of full-size PNG frames under `root`, written
    once and kept: smooth colour fields with pixel noise, so that a frame
    decodes like a camera's. Their content does not depend on the run's
    seed; which frame shows which is drawn from it."""
    from PIL import Image

    w, h = ds["image_size"]
    n = ds["png_pool"]
    os.makedirs(root, exist_ok=True)
    paths = [os.path.join(root, f"frame_{i:03d}.png") for i in range(n)]

    def write(i):
        if os.path.exists(paths[i]):
            return
        rng = np.random.default_rng(1000 + i)
        coarse = (rng.random((h // 64, w // 64, 3)) * 255).astype(np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((w, h),
                                                        Image.BICUBIC))
        img = img.astype(np.int16) + rng.integers(-3, 4, img.shape)
        tmp = f"{paths[i]}.{os.getpid()}.tmp"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            tmp, format="PNG")
        os.replace(tmp, paths[i])

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(write, range(n)))
    return paths


def dnerf_images(n: int, w: int, h: int, gen: torch.Generator, device):
    """(colour (N, H, W, 3), coverage (N, H, W)) of an object on a
    transparent background: smooth colour fields under a soft disc."""
    coarse = torch.rand((n, 3, 12, 12), generator=gen, device=device)
    rgb = F.interpolate(coarse, size=(h, w), mode="bicubic",
                        align_corners=False).clamp(0, 1)
    centre = 0.5 + 0.1 * (torch.rand((n, 2, 1, 1), generator=gen,
                                     device=device) - 0.5)
    radius = 0.3 + 0.1 * torch.rand((n, 1, 1), generator=gen, device=device)
    ys = (torch.arange(h, device=device) + 0.5) / h
    xs = (torch.arange(w, device=device) + 0.5) / w
    d = torch.sqrt((xs[None, None, :] - centre[:, 0]) ** 2
                   + (ys[None, :, None] - centre[:, 1]) ** 2)
    alpha = torch.clamp((radius - d) * 40.0 + 0.5, 0.0, 1.0)
    return (rgb.permute(0, 2, 3, 1).contiguous().cpu().numpy(),
            alpha.cpu().numpy())


def initial_params(cloud: dict, cfg: dict, num_sh: int, gen,
                   device) -> dict:
    """The raw leaves of `cfg`'s num_pts gaussians, drawn on the device:
    means uniform in the cloud's box; times over 1.2 × the duration (as
    the initial cloud's); log-scales of √ the mean squared distance to the
    3 nearest points (as the initial cloud's) and log √(duration / 5) in
    time; rotation pairs near the identity, so that the 4D rotor couples
    space and time as training makes it; opacities uniform in
    [0.05, 0.95]; colours uniform, higher SH coefficients small."""
    p = cfg["num_pts"]
    t0, t1 = cfg["time_duration"]
    dur = t1 - t0
    lo = torch.tensor(cloud["lo"], device=device)
    hi = torch.tensor(cloud["hi"], device=device)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    xyz = lo + (hi - lo) * rand(p, 3)
    _, d2 = knn_exact(xyz, 3)
    dist2 = torch.clamp(d2.mean(dim=1), min=1e-7)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    opacity = 0.05 + 0.9 * rand(p, 1)
    return dict(
        xyz=xyz,
        t=(rand(p, 1) * 1.2 - 0.1) * dur + t0,
        scaling=torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3),
        scaling_t=torch.full((p, 1), math.log(math.sqrt(dur / 5.0)),
                             device=device),
        rotation=ident + cloud["rotation_noise"] * randn(p, 4),
        rotation_r=ident + cloud["rotation_noise"] * randn(p, 4),
        f_dc=((rand(p, 1, 3) - 0.5) / SH_C0),
        f_rest=cloud["sh_rest_std"] * randn(p, num_sh - 1, 3),
        opacity=torch.log(opacity / (1.0 - opacity)))


def env_texture(res: int, gen, device) -> torch.Tensor:
    coarse = torch.rand((1, 3, 8, 8), generator=gen, device=device)
    tex = F.interpolate(coarse, size=(res, res), mode="bicubic",
                        align_corners=False).clamp(0, 1)
    return tex[0].permute(1, 2, 0).contiguous()


def num_sh_channels(cfg: dict) -> int:
    """Coefficients per colour of the 4D spherindrical basis: (deg+1)² ×
    (deg_t+1), deg_t 2 with eval_shfs_4d."""
    deg = cfg["ModelParams"]["sh_degree"]
    deg_t = 2 if cfg["PipelineParams"]["eval_shfs_4d"] else 0
    if deg_t == 0:
        return (1, 6, 16, 33)[deg]
    return (deg + 1) ** 2 * (deg_t + 1)


def make_data(config: dict, seed: int, device, pool_root: str) -> Data:
    """Everything a run of `config` trains on, from `seed`."""
    cfg, ds = config["config"], config["dataset"]
    rng, gen = generators(seed, device)
    res = cfg["ModelParams"]["resolution"]
    images = alphas = None
    if ds["kind"] == "dnerf":
        frames = dnerf_frames(ds, res, rng)
        w, h = scaled_size(ds["image_size"], res)
        images, alphas = dnerf_images(len(frames), w, h, gen, device)
    elif ds["kind"] == "n3v":
        frames = n3v_frames(ds, res, rng, png_pool(ds, pool_root))
    else:
        raise ValueError(f"unknown dataset kind {ds['kind']!r}")
    params = initial_params(config["cloud"], cfg, num_sh_channels(cfg), gen,
                            device)
    env_res = cfg["PipelineParams"]["env_map_res"]
    env = env_texture(env_res, gen, device) if env_res > 0 else None
    return Data(frames, images, alphas, params, env)


def ground_truth(data: Data, frame: Frame, white_background: bool):
    """(colour (H, W, 3), coverage (H, W)) f32 numpy of one frame as the
    scene loader delivers it: in-memory images composited by their
    coverage; PNG frames decoded, composited on the background and resized
    to the frame's size through 8 bits with PIL's default filter."""
    if frame.image >= 0:
        alpha = data.alphas[frame.image]
        return data.images[frame.image] * alpha[..., None], alpha
    from PIL import Image

    with Image.open(frame.path) as im:
        rgba = np.asarray(im.convert("RGBA"), np.float32) / 255.0
    a = rgba[..., 3:4]
    bg = 1.0 if white_background else 0.0
    rgb = rgba[..., :3] * a + bg * (1.0 - a)
    size = (frame.pose.width, frame.pose.height)
    if (rgb.shape[1], rgb.shape[0]) != size:
        u8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        rgb = np.asarray(Image.fromarray(u8).resize(size), np.float32) / 255.0
    return rgb.astype(np.float32), np.ones(rgb.shape[:2], np.float32)
