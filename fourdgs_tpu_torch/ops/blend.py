"""Tile blend: the CUDA kernels K1 (forward) and K2 (backward), their
plain PyTorch versions, and the differentiable `Blend` that joins them.

PyTorch counterpart of `fourdgs_tpu/ops/blend.py` and
`fourdgs_tpu/ops/pallas_blend.py` (`blend_forward_pallas`,
`blend_backward_pallas` and the VJP `_blend_pallas_fwd` /
`_blend_pallas_bwd`). `blend_forward` and `blend_backward` launch the
hand-written kernels `csrc/blend_forward.cu` and `csrc/blend_backward.cu`
on CUDA tensors and run `blend_forward_plain` / `blend_backward_plain` on
CPU tensors only. Per-gaussian data travels as one (P, 12) f32 record
table: [0:2] xy, [2:5] conic (a, b, c), [5] opacity, [6:12] feat (rgb,
depth, flow); the kernels gather records through the sorted gaussian ids,
and K2 adds its gradients per gaussian into a (P, 12) table of the same
layout. The JAX package's `blend` is here `Blend.apply`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build
from . import gaussmath as gm
from .binning import TileBins
from .preprocess import TILE, ProcessedGaussians, RenderOptions

PIX = TILE * TILE  # 256 pixels per tile
NUM_FEAT = 6       # rgb(3) + depth(1) + flow(2)
REC = 12           # xy(2) + conic(3) + opacity(1) + feat(6)
NUM_GRAD = 10      # record columns K2 differentiates: all but the flow
COT = NUM_FEAT + 1  # per-pixel backward inputs: dc(6) + tf_term
WARP = 32
PLAIN_CHUNK = 32   # ranks per gather step of the plain versions


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
    out = launch_forward(rec, gauss_id, tile_start, tile_count, tiles_x)
    blend_forward.launches += 1
    return out


blend_forward.launches = 0

_VOID, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "blend_forward": [_VOID] * 4 + [_INT] * 2 + [_VOID] * 4,
    "blend_backward": [_VOID] * 6 + [_INT] * 2 + [_VOID] * 2,
}


@functools.cache
def _kernel(name: str):
    fn = getattr(cuda_build.load(name), f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_launch(name: str, rec: torch.Tensor, ints: dict, floats: dict):
    """Device, type, shape and contiguity checks before a kernel launch."""
    if rec.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {rec.device}")
    _check(rec, "rec", torch.float32, 2)
    if rec.shape[1] != REC or rec.data_ptr() % 16:
        raise ValueError("rec must be a 16-byte aligned (P, 12) table")
    for group, dtype in ((ints, torch.int32), (floats, torch.float32)):
        for arg, (x, ndim) in group.items():
            _check(x, arg, dtype, ndim)
            if x.device != rec.device:
                raise ValueError(f"{name}: tensors on different devices")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def launch_forward(rec, gauss_id, tile_start, tile_count, tiles_x: int):
    """Launch K1 on PyTorch's current stream. Counts no launch:
    `blend_forward` does."""
    _check_launch("blend_forward", rec,
                  dict(gauss_id=(gauss_id, 1), tile_start=(tile_start, 1),
                       tile_count=(tile_count, 1)), {})
    num_tiles = tile_start.shape[0]
    accum = torch.empty((num_tiles, NUM_FEAT, PIX), dtype=torch.float32,
                        device=rec.device)
    t_final = torch.empty((num_tiles, PIX), dtype=torch.float32,
                          device=rec.device)
    n_contrib = torch.empty((num_tiles, PIX), dtype=torch.int32,
                            device=rec.device)
    stream = torch.cuda.current_stream(rec.device).cuda_stream
    _raise_on(_kernel("blend_forward")(
        rec.data_ptr(), gauss_id.data_ptr(), tile_start.data_ptr(),
        tile_count.data_ptr(), num_tiles, tiles_x, accum.data_ptr(),
        t_final.data_ptr(), n_contrib.data_ptr(), stream), "blend_forward")
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


def image_to_ctiles(img: torch.Tensor, opts: RenderOptions) -> torch.Tensor:
    """(H, W, C) → channel-major tiles (T, C, 256), zero-padding partial
    tiles."""
    c = img.shape[2]
    img = torch.nn.functional.pad(
        img, (0, 0, 0, opts.tiles_x * TILE - img.shape[1],
              0, opts.tiles_y * TILE - img.shape[0]))
    img = img.reshape(opts.tiles_y, TILE, opts.tiles_x, TILE, c)
    return img.permute(0, 2, 4, 1, 3).reshape(opts.num_tiles, c, PIX)


def blend_cotangents(d_color, d_depth, d_flow, d_alpha, t_final, bg,
                     opts: RenderOptions):
    """Image cotangents → K2's per-pixel inputs (`_blend_pallas_bwd`,
    pallas_blend.py:1079-1093): dcot (T, 7, 256) = [dc(6), tf_term] with
    tf_term = (dC_rgb·bg − dα)·T_final, and d_bg (3,) = Σ T_final·dC_rgb.
    Pixels past the image edge get zero cotangents."""
    dc = image_to_ctiles(torch.cat([d_color, d_depth[..., None], d_flow],
                                   dim=-1), opts)                  # (T, 6, 256)
    dt_total = (torch.einsum("tcp,c->tp", dc[:, 0:3], bg)
                - image_to_ctiles(d_alpha[..., None], opts)[:, 0])
    tf_term = dt_total * t_final
    d_bg = torch.einsum("tp,tcp->c", t_final, dc[:, 0:3])
    return torch.cat([dc, tf_term[:, None]], dim=1), d_bg


def blend_backward_plain(rec: torch.Tensor, gauss_id: torch.Tensor,
                         tile_start: torch.Tensor, t_final: torch.Tensor,
                         n_contrib: torch.Tensor, dcot: torch.Tensor,
                         tiles_x: int, pair_counts: dict | None = None):
    """Plain PyTorch version of kernel K2: the same per-pixel f32
    operations in the same order; only the per-gaussian sums are taken in
    another order (over the tile's pixels, then `index_add_`).

    Walks every tile back to front in chunks of PLAIN_CHUNK ranks, from
    the tile's largest n_contrib: the falloff terms of a chunk are
    computed for all tiles at once, then the transmittance and suffix
    recursions step through the chunk's ranks one at a time. Returns the
    per-gaussian gradient table d_rec (P, 12) in the record layout; the
    flow columns stay zero.

    If `pair_counts` is a dict, it receives the number of (pixel,
    instance) pairs these inputs need, by how far each goes: "evaluated"
    (the rank is below the pixel's n_contrib), "power_ok" (power <= 0),
    "used" (alpha >= 1/255: the pair K1 composited), and "warp_active",
    the (32-pixel warp, instance) pairs with a used pixel, which pay the
    atomics.
    """
    device = rec.device
    num_tiles = tile_start.shape[0]
    px, py = _tile_pixel_coords(num_tiles, tiles_x, device)
    dc = [dcot[:, f] for f in range(NUM_FEAT)]                 # (T, PIX)
    tf = dcot[:, NUM_FEAT]
    t = t_final.clone()
    sigma = torch.zeros_like(t)
    d_rec = torch.zeros_like(rec)
    ncon = n_contrib.to(torch.int64)
    max_rank = ncon.max(dim=1).values                           # (T,)
    top = int(max_rank.max())
    chunk = PLAIN_CHUNK
    ranks = torch.arange(chunk, device=device)
    start = tile_start.to(torch.int64)[:, None]
    n_pairs = torch.zeros(4, dtype=torch.int64, device=device)
    for c0 in reversed(range(0, top, chunk)):
        rank = c0 + ranks
        in_range = rank[None, :] < max_rank[:, None]            # (T, K)
        gid = gauss_id[torch.where(in_range, start + rank[None, :], 0)]
        gid = gid.to(torch.int64)
        r = rec[gid]                                            # (T, K, 12)
        dx = r[:, :, 0:1] - px[:, None, :]                      # (T, K, PIX)
        dy = r[:, :, 1:2] - py[:, None, :]
        power = (-0.5 * (r[:, :, 2:3] * dx * dx + r[:, :, 4:5] * dy * dy)
                 - r[:, :, 3:4] * dx * dy)
        g = torch.exp(power)
        raw = r[:, :, 5:6] * g
        alpha = torch.clamp(raw, max=gm.ALPHA_CLAMP)
        evaluated = rank[None, :, None] < ncon[:, None, :]
        power_ok = evaluated & (power <= 0.0)
        used = power_ok & (alpha >= gm.ALPHA_MIN)
        if pair_counts is not None:
            n_pairs += torch.stack([
                evaluated.sum(), power_ok.sum(), used.sum(),
                used.reshape(num_tiles, chunk, PIX // WARP, WARP)
                .any(dim=-1).sum()])
        grads = torch.zeros((num_tiles, chunk, REC), dtype=rec.dtype,
                            device=device)
        for k in reversed(range(chunk)):
            u = used[:, k]
            a = alpha[:, k]
            f = r[:, k, 6:12, None]                             # (T, 6, 1)
            one_m = 1.0 - a
            t_before = torch.where(u, t / one_m, t)
            w = torch.where(u, a * t_before, 0.0)
            gdot = (dc[0] * f[:, 0] + dc[1] * f[:, 1] + dc[2] * f[:, 2]
                    + dc[3] * f[:, 3] + dc[4] * f[:, 4] + dc[5] * f[:, 5])
            d_alpha = torch.where(
                u, t_before * gdot - (sigma + tf) / one_m, 0.0)
            sigma = torch.where(u, sigma + w * gdot, sigma)
            t = t_before
            # Masked again: exp(power) may overflow where power > 0.
            d_power = torch.where(u, raw[:, k] * d_alpha, 0.0)
            d_opa = torch.where(u, g[:, k] * d_alpha, 0.0)
            ddx, ddy = dx[:, k], dy[:, k]
            ca, cb, cc = r[:, k, 2:3], r[:, k, 3:4], r[:, k, 4:5]
            sx = ca * ddx + cb * ddy
            sy = cb * ddx + cc * ddy
            terms = torch.stack([
                -sx * d_power, -sy * d_power,
                -0.5 * ddx * ddx * d_power, -ddx * ddy * d_power,
                -0.5 * ddy * ddy * d_power, d_opa,
                w * dc[0], w * dc[1], w * dc[2], w * dc[3]], dim=1)
            grads[:, k, :NUM_GRAD] = terms.sum(dim=-1)
        d_rec.index_add_(0, gid[in_range], grads[in_range])
    if pair_counts is not None:
        pair_counts.update(zip(("evaluated", "power_ok", "used",
                                "warp_active"), n_pairs.tolist()))
    return d_rec


def blend_backward(rec: torch.Tensor, gauss_id: torch.Tensor,
                   tile_start: torch.Tensor, t_final: torch.Tensor,
                   n_contrib: torch.Tensor, dcot: torch.Tensor,
                   tiles_x: int):
    """Backward tile blend (kernel K2): per-gaussian gradients d_rec
    (P, 12) of the records, from K1's t_final and n_contrib and the
    per-pixel cotangents `dcot` (T, 7, 256) of `blend_cotangents`. CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    raises if it cannot build or launch. `blend_backward.observer`, if
    set, is called with (the arguments, the result) of every call."""
    args = (rec, gauss_id, tile_start, t_final, n_contrib, dcot, tiles_x)
    if rec.device.type == "cpu":
        out = blend_backward_plain(*args)
    else:
        out = launch_backward(*args)
        blend_backward.launches += 1
    if blend_backward.observer is not None:
        blend_backward.observer(args, out)
    return out


blend_backward.launches = 0
# A caller that checks K2 on the inputs of a real training step sets this
# (chip_smoke.py does); nothing in the package does.
blend_backward.observer = None


def launch_backward(rec, gauss_id, tile_start, t_final, n_contrib, dcot,
                    tiles_x: int):
    """Launch K2 on PyTorch's current stream, into a zeroed (P, 12)
    table. Counts no launch: `blend_backward` does."""
    _check_launch("blend_backward", rec,
                  dict(gauss_id=(gauss_id, 1), tile_start=(tile_start, 1),
                       n_contrib=(n_contrib, 2)),
                  dict(t_final=(t_final, 2), dcot=(dcot, 3)))
    num_tiles = tile_start.shape[0]
    if (tuple(t_final.shape) != (num_tiles, PIX)
            or n_contrib.shape != t_final.shape
            or tuple(dcot.shape) != (num_tiles, COT, PIX)):
        raise ValueError("blend_backward: t_final, n_contrib must be "
                         "(T, 256) and dcot (T, 7, 256)")
    d_rec = torch.zeros_like(rec)
    stream = torch.cuda.current_stream(rec.device).cuda_stream
    _raise_on(_kernel("blend_backward")(
        rec.data_ptr(), gauss_id.data_ptr(), tile_start.data_ptr(),
        t_final.data_ptr(), n_contrib.data_ptr(), dcot.data_ptr(),
        num_tiles, tiles_x, d_rec.data_ptr(), stream), "blend_backward")
    return d_rec


class Blend(torch.autograd.Function):
    """The differentiable blend (`blend_pallas`'s custom VJP): forward
    through K1, backward through K2.

    Inputs: the (P, 12) record table and bg (3,), both differentiable; the
    tile bins and the render options, which are not. Outputs: color
    (H, W, 3) with bg composited through T_final, depth (H, W), flow
    (H, W, 2), alpha (H, W). The backward returns d_rec (P, 12), whose
    flow columns are zero (flow is a zeros constant in training, as in
    the JAX package), and d_bg (3,). t_final and n_contrib are kept from
    the forward, not recomputed.
    """

    @staticmethod
    def forward(ctx, rec: torch.Tensor, bg: torch.Tensor, bins: TileBins,
                opts: RenderOptions):
        accum, t_final, n_contrib = blend_forward(
            rec, bins.gauss_id, bins.tile_start, bins.tile_count,
            opts.tiles_x)
        ctx.save_for_backward(rec, bg, bins.gauss_id, bins.tile_start,
                              t_final, n_contrib)
        ctx.opts = opts
        return assemble_outputs(accum, t_final, bg, opts)

    @staticmethod
    def backward(ctx, d_color, d_depth, d_flow, d_alpha):
        rec, bg, gauss_id, tile_start, t_final, n_contrib = ctx.saved_tensors
        dcot, d_bg = blend_cotangents(d_color, d_depth, d_flow, d_alpha,
                                      t_final, bg, ctx.opts)
        d_rec = blend_backward(rec, gauss_id, tile_start, t_final,
                               n_contrib, dcot, ctx.opts.tiles_x)
        return d_rec, d_bg, None, None
