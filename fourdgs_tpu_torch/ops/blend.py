"""Forward tile blend: the CUDA kernel K1, its plain PyTorch version, and
the output assembly.

PyTorch counterpart of the forward half of `fourdgs_tpu/ops/blend.py` and
`fourdgs_tpu/ops/pallas_blend.py` (`blend_forward_pallas`,
`_blend_pallas_forward`). `blend_forward` launches the hand-written kernel
`csrc/blend_forward.cu` on CUDA tensors and runs `blend_forward_plain` on
CPU tensors only. Per-gaussian data travels as one (P, 12) f32 record
table: [0:2] xy, [2:5] conic (a, b, c), [5] opacity, [6:12] feat (rgb,
depth, flow); the kernel gathers records through the sorted gaussian ids.
The JAX package's `blend` is here `blend_forward` followed by
`assemble_outputs`, which `render.render` calls as two stages.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build
from . import gaussmath as gm
from .preprocess import TILE, ProcessedGaussians, RenderOptions

PIX = TILE * TILE  # 256 pixels per tile
NUM_FEAT = 6       # rgb(3) + depth(1) + flow(2)
REC = 12           # xy(2) + conic(3) + opacity(1) + feat(6)
PLAIN_CHUNK = 32   # ranks per gather step of the plain version


def _tile_pixel_coords(num_tiles: int, tiles_x: int, device):
    """(num_tiles, PIX) integer pixel x/y coordinates as f32; in-tile order
    is row-major (p = yy·16 + xx)."""
    tids = torch.arange(num_tiles, device=device)[:, None]
    pp = torch.arange(PIX, device=device)[None, :]
    px = ((tids % tiles_x) * TILE + pp % TILE).to(torch.float32)
    py = ((tids // tiles_x) * TILE + pp // TILE).to(torch.float32)
    return px, py


def blend_forward_plain(rec: torch.Tensor, gauss_id: torch.Tensor,
                        tile_start: torch.Tensor, tile_count: torch.Tensor,
                        tiles_x: int, pair_counts: dict | None = None):
    """Plain PyTorch version of the kernel: the same function with the
    same f32 operations in the same order.

    Walks every tile's instances in chunks of PLAIN_CHUNK ranks: the falloff
    terms of a chunk are computed for all tiles at once, then the
    transmittance recursion steps through the chunk's ranks one at a time.
    Returns (accum (T, 6, 256), t_final (T, 256), n_contrib (T, 256) i32).

    If `pair_counts` is a dict, it receives the number of (pixel, instance)
    pairs these inputs need, by how far each goes: "evaluated" (the pixel
    is not done yet), "power_ok" (power <= 0), "alpha_ok" (alpha >= 1/255)
    and "used" (the pixel composites it).
    """
    device = rec.device
    num_tiles = tile_start.shape[0]
    px, py = _tile_pixel_coords(num_tiles, tiles_x, device)
    t = torch.ones((num_tiles, PIX), dtype=torch.float32, device=device)
    acc = torch.zeros((num_tiles, NUM_FEAT, PIX), dtype=torch.float32,
                      device=device)
    done = torch.zeros((num_tiles, PIX), dtype=torch.bool, device=device)
    ncon = torch.zeros((num_tiles, PIX), dtype=torch.int32, device=device)
    max_count = int(tile_count.max())
    chunk = PLAIN_CHUNK
    ranks = torch.arange(chunk, device=device)
    start = tile_start.to(torch.int64)[:, None]
    count = tile_count.to(torch.int64)[:, None]
    n_pairs = torch.zeros(4, dtype=torch.int64, device=device)
    for c0 in range(0, max_count, chunk):
        in_range = (c0 + ranks)[None, :] < count                # (T, K)
        idx = torch.where(in_range, start + c0 + ranks[None, :], 0)
        r = rec[gauss_id[idx].to(torch.int64)]                 # (T, K, 12)
        dx = r[:, :, 0:1] - px[:, None, :]                     # (T, K, PIX)
        dy = r[:, :, 1:2] - py[:, None, :]
        power = (-0.5 * (r[:, :, 2:3] * dx * dx + r[:, :, 4:5] * dy * dy)
                 - r[:, :, 3:4] * dx * dy)
        alpha = torch.clamp(r[:, :, 5:6] * torch.exp(power),
                            max=gm.ALPHA_CLAMP)
        valid = (in_range[:, :, None] & (power <= 0.0)
                 & (alpha >= gm.ALPHA_MIN))
        for k in range(chunk):
            a = alpha[:, k]
            live = valid[:, k] & ~done
            test_t = t * (1.0 - a)
            fail = live & (test_t < gm.T_EPS)
            used = live & ~fail
            if pair_counts is not None:
                seen = in_range[:, k, None] & ~done
                n_pairs += torch.stack([
                    seen.sum(), (seen & (power[:, k] <= 0.0)).sum(),
                    live.sum(), used.sum()])
            w = torch.where(used, a * t, 0.0)
            acc += r[:, k, 6:12, None] * w[:, None, :]
            t = torch.where(used, test_t, t)
            ncon = torch.where(used, c0 + k + 1, ncon).to(torch.int32)
            done = done | fail
        if bool(done.all()):
            break
    if pair_counts is not None:
        pair_counts.update(zip(("evaluated", "power_ok", "alpha_ok", "used"),
                               n_pairs.tolist()))
    return acc, t, ncon


def _check(x: torch.Tensor, name: str, dtype, ndim: int):
    if x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")


def blend_forward(rec: torch.Tensor, gauss_id: torch.Tensor,
                  tile_start: torch.Tensor, tile_count: torch.Tensor,
                  tiles_x: int):
    """Forward tile blend (kernel K1). CPU tensors take the plain version;
    CUDA tensors launch the kernel, which raises if it cannot build or
    launch. Returns (accum (T, 6, 256), t_final (T, 256), n_contrib
    (T, 256) i32)."""
    if rec.device.type == "cpu":
        return blend_forward_plain(rec, gauss_id, tile_start, tile_count,
                                   tiles_x)
    out = launch_kernel(rec, gauss_id, tile_start, tile_count, tiles_x)
    blend_forward.launches += 1
    return out


blend_forward.launches = 0


@functools.cache
def _kernel(flags: tuple[str, ...] | None):
    fn = cuda_build.load("blend_forward", flags).blend_forward_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def launch_kernel(rec, gauss_id, tile_start, tile_count, tiles_x: int,
                  flags: tuple[str, ...] | None = None):
    """Launch the kernel, built with nvcc `flags` (default: its own), on
    PyTorch's current stream. Counts no launch: `blend_forward` does."""
    if rec.device.type != "cuda":
        raise ValueError(f"blend_forward: unsupported device {rec.device}")
    _check(rec, "rec", torch.float32, 2)
    _check(gauss_id, "gauss_id", torch.int32, 1)
    _check(tile_start, "tile_start", torch.int32, 1)
    _check(tile_count, "tile_count", torch.int32, 1)
    if rec.shape[1] != REC or rec.data_ptr() % 16:
        raise ValueError("rec must be a 16-byte aligned (P, 12) table")
    for x in (gauss_id, tile_start, tile_count):
        if x.device != rec.device:
            raise ValueError("blend_forward: tensors on different devices")
    num_tiles = tile_start.shape[0]
    accum = torch.empty((num_tiles, NUM_FEAT, PIX), dtype=torch.float32,
                        device=rec.device)
    t_final = torch.empty((num_tiles, PIX), dtype=torch.float32,
                          device=rec.device)
    n_contrib = torch.empty((num_tiles, PIX), dtype=torch.int32,
                            device=rec.device)
    stream = torch.cuda.current_stream(rec.device).cuda_stream
    err = _kernel(flags)(
        rec.data_ptr(), gauss_id.data_ptr(), tile_start.data_ptr(),
        tile_count.data_ptr(), num_tiles, tiles_x, accum.data_ptr(),
        t_final.data_ptr(), n_contrib.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"blend_forward kernel launch failed: CUDA error "
                           f"{err}")
    return accum, t_final, n_contrib


def build_records(proc: ProcessedGaussians) -> torch.Tensor:
    """(P, 12) f32 record table [xy, conic, opacity, rgb, depth, flow] of
    the preprocessed gaussians, in one copy."""
    return torch.cat([proc.xy, proc.conic, proc.opacity[:, None], proc.rgb,
                      proc.depth[:, None], proc.flow], dim=1)


def ctiles_to_image(x: torch.Tensor, opts: RenderOptions) -> torch.Tensor:
    """Channel-major tiles (T, C, 256) → (H, W, C), cropping partial tiles."""
    c = x.shape[1]
    img = x.reshape(opts.tiles_y, opts.tiles_x, c, TILE, TILE)
    img = img.permute(0, 3, 1, 4, 2)
    img = img.reshape(opts.tiles_y * TILE, opts.tiles_x * TILE, c)
    return img[: opts.height, : opts.width]


def assemble_outputs(accum, t_final, bg, opts: RenderOptions):
    """Kernel outputs → (color (H,W,3) with bg composited through T_final,
    depth (H,W), flow (H,W,2), alpha (H,W) = 1 − T_final)."""
    color = ctiles_to_image(
        accum[:, 0:3, :] + t_final[:, None, :] * bg[None, :, None], opts)
    depth = ctiles_to_image(accum[:, 3:4, :], opts)[..., 0]
    flow = ctiles_to_image(accum[:, 4:6, :], opts)
    alpha = ctiles_to_image((1.0 - t_final)[:, None, :], opts)[..., 0]
    return color, depth, flow, alpha
