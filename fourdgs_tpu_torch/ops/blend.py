"""Tile blend: the CUDA kernels K1 (forward), K2 (backward) and K3 (packed
inference forward), their plain PyTorch versions, and the differentiable
`Blend` that joins K1 and K2.

PyTorch counterpart of `fourdgs_tpu/ops/blend.py` and
`fourdgs_tpu/ops/pallas_blend.py` (`blend_forward_pallas`,
`blend_backward_pallas`, the VJP `_blend_pallas_fwd` / `_blend_pallas_bwd`
and `blend_pallas_infer`). `blend_forward`, `blend_backward` and
`blend_infer` launch the hand-written kernels `csrc/blend_forward.cu`,
`csrc/blend_backward.cu` and `csrc/blend_infer.cu` on CUDA tensors and run
`blend_forward_plain` / `blend_backward_plain` / `blend_infer_plain` on
CPU tensors only. Per-gaussian data travels as one (P, 12) f32 record
table: [0:2] xy, [2:5] conic (a, b, c), [5] opacity, [6:12] feat (rgb,
depth, flow); the kernels gather records through the sorted gaussian ids,
and K2 adds its gradients per gaussian into a (P, 12) table of the same
layout. K3 reads a packed (P, 8) int32 table instead
(`pack_records_infer`): xy and conic as f32 bits, opacity, rgb and depth
rounded to bf16 pairs. The JAX package's `blend` is here `Blend.apply`.

The three kernels give each warp a block of a tile's pixels (K2 8x4, one
pixel per thread; K1 and K3 8x8, two per thread) and let it skip the
instances that cannot reach alpha >= 1/255 anywhere in that block. The
test is `warp_cull_keep`, written here once more in PyTorch (the kernels'
is `cull_keep` in `csrc/alpha_terms.cuh`); the plain versions use it only
to count, under `pair_counts`, what the kernels' walks visit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build
from ..utils import tracing
from . import gaussmath as gm
from .binning import TileBins
from .preprocess import TILE, ProcessedGaussians, RenderOptions

PIX = TILE * TILE  # 256 pixels per tile
NUM_FEAT = 6       # rgb(3) + depth(1) + flow(2)
REC = 12           # xy(2) + conic(3) + opacity(1) + feat(6)
REC_INFER = 8      # packed 32-bit words per gaussian of the inference table
NUM_FEAT_INFER = 4  # rgb(3) + depth(1): what the inference blend composites
NUM_GRAD = 10      # record columns K2 differentiates: all but the flow
COT = NUM_FEAT + 1  # per-pixel backward inputs: dc(6) + tf_term
WARP = 32
WARP_W, WARP_H = 8, 4   # the lanes of a warp: 8 across, 4 down
FORWARD_ROWS = 2   # pixels per thread of K1, WARP_H rows apart; K2 has 1
PLAIN_CHUNK = 32   # ranks per gather step of the plain versions
# Margins of the two tests that skip work and decide nothing
# (csrc/alpha_terms.cuh: kSkipMargin, kCullRel).
SKIP_MARGIN = 1e-3
CULL_REL = 1e-5


def _tile_pixel_coords(num_tiles: int, tiles_x: int, device):
    """(num_tiles, PIX) integer pixel x/y coordinates as f32; in-tile order
    is row-major (p = yy·16 + xx)."""
    tids = torch.arange(num_tiles, device=device)[:, None]
    pp = torch.arange(PIX, device=device)[None, :]
    px = ((tids % tiles_x) * TILE + pp % TILE).to(torch.float32)
    py = ((tids // tiles_x) * TILE + pp // TILE).to(torch.float32)
    return px, py


def by_warp(x: torch.Tensor, rows: int = 1) -> torch.Tensor:
    """(..., 256) per-pixel values in tile order → (..., warps, 32·rows)
    grouped by the warp that owns the pixel, where a thread owns `rows`
    pixels of one column, 4 rows apart: warp w covers the block 8 wide and
    4·rows tall at column (w % 2)·8 and row (w // 2)·4·rows."""
    lead = x.shape[:-1]
    tall = WARP_H * rows
    x = x.reshape(*lead, TILE // tall, tall, TILE // WARP_W, WARP_W)
    return x.transpose(-3, -2).reshape(*lead, PIX // (WARP * rows),
                                       WARP * rows)


def warp_rects(num_tiles: int, tiles_x: int, device, rows: int = 1):
    """Bounds (x0, x1, y0, y1), each (num_tiles, warps) f32 and inclusive,
    of the pixel coordinates of every warp's block (see `by_warp`)."""
    tall = WARP_H * rows
    tids = torch.arange(num_tiles, device=device)[:, None]
    w = torch.arange(PIX // (WARP * rows), device=device)[None, :]
    x0 = ((tids % tiles_x) * TILE
          + (w % (TILE // WARP_W)) * WARP_W).to(torch.float32)
    y0 = ((tids // tiles_x) * TILE
          + (w // (TILE // WARP_W)) * tall).to(torch.float32)
    return x0, x0 + (WARP_W - 1), y0, y0 + (tall - 1)


def skip_threshold(opacity: torch.Tensor) -> torch.Tensor:
    """log(1 / (255·opacity)) − SKIP_MARGIN: a pair whose power is below it
    cannot reach alpha >= 1/255, whatever expf and the product round to.
    +inf for opacity 0, NaN (which skips nothing) for a negative one."""
    return -torch.log(255.0 * opacity) - SKIP_MARGIN


def _edge_min(s, b, f, e, lo, hi):
    """Least s·e² + 2·b·e·t + f·t² over t in [lo, hi], for f > 0."""
    be = b * e
    t = torch.minimum(torch.maximum(-be / f, lo), hi)
    return s * e * e + 2.0 * be * t + f * t * t


def rect_power_bound(rec: torch.Tensor, x0, x1, y0, y1):
    """(bound, mag): the largest power of the instance `rec[..., 0:5]`
    over the rectangle [x0, x1] x [y0, y1] of pixel coordinates, for a
    positive definite conic, and the largest magnitude that the power's
    terms can have there. The bound is 0 if the centre lies
    inside; else minus half the least value of a·dx² + 2·b·dx·dy + c·dy²
    on an edge that faces the centre (at most one per axis: the one at
    the offset nearest to 0 where the rectangle's span on that axis
    excludes 0), a clamped one-dimensional minimum."""
    x, y, a, b, c = (rec[..., i] for i in range(5))
    dx_lo, dx_hi, dy_lo, dy_hi = x - x1, x - x0, y - y1, y - y0
    zero = torch.zeros((), dtype=rec.dtype, device=rec.device)
    ex = torch.minimum(torch.maximum(zero, dx_lo), dx_hi)
    ey = torch.minimum(torch.maximum(zero, dy_lo), dy_hi)
    inf = float("inf")
    qx = torch.where(ex != 0, _edge_min(a, b, c, ex, dy_lo, dy_hi), inf)
    qy = torch.where(ey != 0, _edge_min(c, b, a, ey, dx_lo, dx_hi), inf)
    bound = torch.where((ex != 0) | (ey != 0),
                        -0.5 * torch.minimum(qx, qy), 0.0)
    mx = torch.maximum(dx_lo.abs(), dx_hi.abs())
    my = torch.maximum(dy_lo.abs(), dy_hi.abs())
    return bound, a * mx * mx + c * my * my + 2.0 * b.abs() * mx * my


def warp_cull_keep(rec: torch.Tensor, x0, x1, y0, y1) -> torch.Tensor:
    """The kernels' warp cull (`cull_keep`, csrc/alpha_terms.cuh), the same
    f32 formula: False only where no pixel of the rectangle can pass
    alpha >= 1/255 for the instance `rec[..., 0:6]`: where
    `rect_power_bound`, plus CULL_REL of the terms' largest magnitude,
    stays under `skip_threshold`. Conics that are not positive definite
    and non-finite terms keep."""
    bound, mag = rect_power_bound(rec, x0, x1, y0, y1)
    a, b, c = rec[..., 2], rec[..., 3], rec[..., 4]
    reject = ((a > 0) & (c > 0) & (a * c > b * b)
              & (bound + CULL_REL * mag < skip_threshold(rec[..., 5])))
    return ~reject


def shared_power(rec: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """power of the instances `rec` (N, >= 5) at the pixels xs (W,) x ys
    (H,), as (N, H, W), from the terms that K1 computes once per column
    ((a·dx)·dx, b·dx) and once per row ((c·dy)·dy) of a thread's pixels:
    the plain versions' power, bit for bit."""
    dx = rec[:, 0:1] - xs[None, :]                              # (N, W)
    dy = rec[:, 1:2] - ys[None, :]                              # (N, H)
    adx2 = rec[:, 2:3] * dx * dx
    bdx = rec[:, 3:4] * dx
    cdy2 = rec[:, 4:5] * dy * dy
    return (-0.5 * (adx2[:, None, :] + cdy2[:, :, None])
            - bdx[:, None, :] * dy[:, :, None])


def _warp_counts(seen, keep_k, used, rows):
    """Counts of one rank of a plain walk, by warp: (warp, instance) pairs
    with a pixel that evaluates the instance (`seen` (T, 256)), those of
    them that pass the cull (`keep_k` (T, warps)), the evaluated pairs in
    these, and the (warp, instance) pairs with a used pixel."""
    seen_w = by_warp(seen, rows)
    kept = seen_w.any(dim=-1) & keep_k
    return [seen_w.any(dim=-1).sum(), kept.sum(),
            (seen_w & kept[..., None]).sum(),
            by_warp(used, rows).any(dim=-1).sum()]


WARP_COUNT_NAMES = ("warp_live", "warp_kept", "kept_evaluated",
                    "warp_active")


def blend_forward_plain(rec: torch.Tensor, gauss_id: torch.Tensor,
                        tile_start: torch.Tensor, tile_count: torch.Tensor,
                        tiles_x: int, pair_counts: dict | None = None):
    """Plain PyTorch version of the kernel: the same function with the
    same f32 operations in the same order. `rec` is (P, 6 + F): F = 6
    features for K1's table, 4 for the unpacked inference table.

    Walks every tile's instances in chunks of PLAIN_CHUNK ranks: the falloff
    terms of a chunk are computed for all tiles at once, then the
    transmittance recursion steps through the chunk's ranks one at a time.
    Returns (accum (T, F, 256), t_final (T, 256), n_contrib (T, 256) i32).

    If `pair_counts` is a dict, it receives the number of (pixel, instance)
    pairs these inputs need, by how far each goes: "evaluated" (the pixel
    is not done yet), "power_ok" (power <= 0), "alpha_ok" (alpha >= 1/255)
    and "used" (the pixel composites it); and what the warps (8x8 blocks)
    of K1, or of K3 on the unpacked table, visit: "warp_live" ((warp,
    instance) pairs with a pixel that is not done), "warp_kept" (those
    that pass `warp_cull_keep`), "kept_evaluated" (the evaluated pairs in
    these) and "warp_active" ((warp, instance) pairs with a used pixel).
    """
    device = rec.device
    num_tiles = tile_start.shape[0]
    px, py = _tile_pixel_coords(num_tiles, tiles_x, device)
    t = torch.ones((num_tiles, PIX), dtype=torch.float32, device=device)
    acc = torch.zeros((num_tiles, rec.shape[1] - 6, PIX),
                      dtype=torch.float32, device=device)
    done = torch.zeros((num_tiles, PIX), dtype=torch.bool, device=device)
    ncon = torch.zeros((num_tiles, PIX), dtype=torch.int32, device=device)
    max_count = int(tile_count.max())
    chunk = PLAIN_CHUNK
    ranks = torch.arange(chunk, device=device)
    start = tile_start.to(torch.int64)[:, None]
    count = tile_count.to(torch.int64)[:, None]
    n_pairs = torch.zeros(8, dtype=torch.int64, device=device)
    if pair_counts is not None:
        rects = [b[:, None, :] for b in warp_rects(num_tiles, tiles_x,
                                                   device, FORWARD_ROWS)]
    for c0 in range(0, max_count, chunk):
        in_range = (c0 + ranks)[None, :] < count                # (T, K)
        idx = torch.where(in_range, start + c0 + ranks[None, :], 0)
        r = rec[gauss_id[idx].to(torch.int64)]                 # (T, K, 6+F)
        if pair_counts is not None:
            keep = warp_cull_keep(r[:, :, None, :], *rects)     # (T, K, 8)
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
                    live.sum(), used.sum(),
                    *_warp_counts(seen, keep[:, k], used, FORWARD_ROWS)])
            w = torch.where(used, a * t, 0.0)
            acc += r[:, k, 6:, None] * w[:, None, :]
            t = torch.where(used, test_t, t)
            ncon = torch.where(used, c0 + k + 1, ncon).to(torch.int32)
            done = done | fail
        if bool(done.all()):
            break
    if pair_counts is not None:
        pair_counts.update(zip(("evaluated", "power_ok", "alpha_ok", "used")
                               + WARP_COUNT_NAMES, n_pairs.tolist()))
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
    (T, 256) i32); a launch counts as `launches.k1` (`utils/tracing.py`).
    `blend_forward.observer`, if set, is called with (the arguments, the
    result) of every call."""
    args = (rec, gauss_id, tile_start, tile_count, tiles_x)
    if rec.device.type == "cpu":
        out = blend_forward_plain(*args)
    else:
        out = launch_forward(*args)
        tracing.count("launches.k1")
    if blend_forward.observer is not None:
        blend_forward.observer(args, out)
    return out


# As `blend_backward.observer`: set by a caller that checks K1 on the
# inputs of a real training step (chip_smoke.py); nothing in the package.
blend_forward.observer = None

_VOID, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "blend_forward": [_VOID] * 4 + [_INT] * 2 + [_VOID] * 4,
    "blend_backward": [_VOID] * 6 + [_INT] * 2 + [_VOID] * 2,
    "blend_infer": [_VOID] * 4 + [_INT] * 2 + [_VOID] * 3,
}


@functools.cache
def _kernel(name: str):
    fn = getattr(cuda_build.load(name), f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_launch(name: str, rec: torch.Tensor, ints: dict, floats: dict,
                  rec_dtype=torch.float32, rec_cols: int = REC):
    """Device, type, shape, contiguity and alignment checks before a
    kernel launch (the kernels read a record with 16-byte loads)."""
    if rec.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {rec.device}")
    _check(rec, "rec", rec_dtype, 2)
    if rec.shape[1] != rec_cols or rec.data_ptr() % 16:
        raise ValueError(
            f"{name}: rec must be a 16-byte aligned (P, {rec_cols}) table")
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


def assemble_outputs_infer(accum, t_final, bg, opts: RenderOptions):
    """Kernel outputs → (color (H,W,3) with bg composited through T_final,
    depth (H,W), alpha (H,W) = 1 − T_final), as `blend_pallas_infer`
    (pallas_blend.py:1135-1139). Reads the first 4 features of `accum`."""
    color = ctiles_to_image(
        accum[:, 0:3, :] + t_final[:, None, :] * bg[None, :, None], opts)
    depth = ctiles_to_image(accum[:, 3:4, :], opts)[..., 0]
    alpha = ctiles_to_image((1.0 - t_final)[:, None, :], opts)[..., 0]
    return color, depth, alpha


def assemble_outputs(accum, t_final, bg, opts: RenderOptions):
    """Kernel outputs → (color, depth, flow (H,W,2), alpha), the first two
    and the last as `assemble_outputs_infer`."""
    color, depth, alpha = assemble_outputs_infer(accum, t_final, bg, opts)
    flow = ctiles_to_image(accum[:, 4:6, :], opts)
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
    "used" (alpha >= 1/255: the pair K1 composited); and what K2's warps
    (8x4 blocks) visit: "warp_live" ((warp, instance) pairs below the
    warp's largest n_contrib), "warp_kept" (those that pass
    `warp_cull_keep`),
    "kept_evaluated" (the evaluated pairs in these), "warp_active" ((warp,
    instance) pairs with a used pixel, which pay the warp sum and the
    shared-memory adds) and "tile_active" ((tile, instance) pairs with a
    used pixel, which pay the atomics on the output).
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
    n_pairs = torch.zeros(8, dtype=torch.int64, device=device)
    if pair_counts is not None:
        rects = [b[:, None, :] for b in warp_rects(num_tiles, tiles_x,
                                                   device)]
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
                *_warp_counts(evaluated,
                              warp_cull_keep(r[:, :, None, :], *rects), used,
                              1),
                used.any(dim=-1).sum()])
        # Only the transmittance and suffix recursions run rank by rank;
        # every other term is elementwise and is taken for the whole chunk
        # (the same f32 operations in the same order).
        one_m = 1.0 - alpha
        f = [r[:, :, 6 + i, None] for i in range(NUM_FEAT)]     # (T, K, 1)
        gdot = (dc[0][:, None] * f[0] + dc[1][:, None] * f[1]
                + dc[2][:, None] * f[2] + dc[3][:, None] * f[3]
                + dc[4][:, None] * f[4] + dc[5][:, None] * f[5])
        w = torch.empty_like(alpha)
        d_alpha = torch.empty_like(alpha)
        for k in reversed(range(chunk)):
            u = used[:, k]
            t_before = torch.where(u, t / one_m[:, k], t)
            w[:, k] = torch.where(u, alpha[:, k] * t_before, 0.0)
            d_alpha[:, k] = torch.where(
                u, t_before * gdot[:, k] - (sigma + tf) / one_m[:, k], 0.0)
            sigma = torch.where(u, sigma + w[:, k] * gdot[:, k], sigma)
            t = t_before
        # Masked again: exp(power) may overflow where power > 0.
        d_power = torch.where(used, raw * d_alpha, 0.0)
        d_opa = torch.where(used, g * d_alpha, 0.0)
        ca, cb, cc = r[:, :, 2:3], r[:, :, 3:4], r[:, :, 4:5]
        sx = ca * dx + cb * dy
        sy = cb * dx + cc * dy
        terms = (-sx * d_power, -sy * d_power, -0.5 * dx * dx * d_power,
                 -dx * dy * d_power, -0.5 * dy * dy * d_power, d_opa,
                 w * dc[0][:, None], w * dc[1][:, None], w * dc[2][:, None],
                 w * dc[3][:, None])
        grads = torch.zeros((num_tiles, chunk, REC), dtype=rec.dtype,
                            device=device)
        for i, term in enumerate(terms):                      # (T, K, PIX)
            grads[:, :, i] = term.sum(dim=-1)
        d_rec.index_add_(0, gid[in_range], grads[in_range])
    if pair_counts is not None:
        pair_counts.update(zip(("evaluated", "power_ok", "used")
                               + WARP_COUNT_NAMES + ("tile_active",),
                               n_pairs.tolist()))
    return d_rec


def blend_backward(rec: torch.Tensor, gauss_id: torch.Tensor,
                   tile_start: torch.Tensor, t_final: torch.Tensor,
                   n_contrib: torch.Tensor, dcot: torch.Tensor,
                   tiles_x: int):
    """Backward tile blend (kernel K2): per-gaussian gradients d_rec
    (P, 12) of the records, from K1's t_final and n_contrib and the
    per-pixel cotangents `dcot` (T, 7, 256) of `blend_cotangents`. CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    raises if it cannot build or launch; a launch counts as `launches.k2`
    (`utils/tracing.py`). `blend_backward.observer`, if set, is called
    with (the arguments, the result) of every call."""
    args = (rec, gauss_id, tile_start, t_final, n_contrib, dcot, tiles_x)
    if rec.device.type == "cpu":
        out = blend_backward_plain(*args)
    else:
        out = launch_backward(*args)
        tracing.count("launches.k2")
    if blend_backward.observer is not None:
        blend_backward.observer(args, out)
    return out


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
    if d_rec.data_ptr() % 16:
        raise ValueError("blend_backward: the gradient table must be "
                         "16-byte aligned (the kernel adds rows with "
                         "vector atomics)")
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


# --------------------------------------------------------------------------
# Packed inference blend (kernel K3): forward only, no gradient
# --------------------------------------------------------------------------

def _pack2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two (P,) f32 columns → one (P,) int32 word: bf16(hi) in the high
    half, bf16(lo) in the low half (`pallas_blend._pack2`). The conversion
    rounds to nearest even; the pair is viewed as one little-endian word,
    so the low half comes first in memory."""
    pair = torch.stack([lo, hi], dim=-1).to(torch.bfloat16)
    return pair.view(torch.int32)[:, 0]


def pack_records_infer(proc: ProcessedGaussians) -> torch.Tensor:
    """(P, 8) int32 packed record table of the preprocessed gaussians (the
    source rows of `_build_inst_data_infer`, pallas_blend.py:1008-1015):
    words 0–4 the f32 bits of xy and conic, 5 opacity | red, 6 green |
    blue, 7 depth | 0 as bf16 pairs (first name in the high half)."""
    geom = torch.cat([proc.xy, proc.conic], dim=1).view(torch.int32)
    rgb = proc.rgb
    words = torch.stack([
        _pack2(proc.opacity, rgb[:, 0]), _pack2(rgb[:, 1], rgb[:, 2]),
        _pack2(proc.depth, torch.zeros_like(proc.depth))], dim=1)
    return torch.cat([geom, words], dim=1)


def unpack_records_infer(packed: torch.Tensor) -> torch.Tensor:
    """The packed table as (P, 10) f32 records [xy, conic, opacity, rgb,
    depth]: what kernel K3 decodes (a bf16 is the high half of an f32, so
    the decode is exact)."""
    geom = packed[:, 0:5].contiguous().view(torch.float32)
    # (P, 6) halves of words 5..7, low half first: r, opa, b, g, 0, depth.
    halves = packed[:, 5:8].contiguous().view(torch.bfloat16).to(
        torch.float32)
    return torch.cat([geom, halves[:, [1, 0, 3, 2, 5]]], dim=1)


def blend_infer_plain(packed: torch.Tensor, gauss_id: torch.Tensor,
                      tile_start: torch.Tensor, tile_count: torch.Tensor,
                      tiles_x: int, pair_counts: dict | None = None):
    """Plain PyTorch version of kernel K3: unpacks the (P, 8) table and
    runs the sequential f32 compositing of `blend_forward_plain` on its 4
    features. Returns (accum (T, 4, 256), t_final (T, 256)); `pair_counts`
    as in `blend_forward_plain`."""
    accum, t_final, _ = blend_forward_plain(
        unpack_records_infer(packed), gauss_id, tile_start, tile_count,
        tiles_x, pair_counts=pair_counts)
    return accum, t_final


def blend_infer(packed: torch.Tensor, gauss_id: torch.Tensor,
                tile_start: torch.Tensor, tile_count: torch.Tensor,
                tiles_x: int):
    """Packed inference tile blend (kernel K3), forward only and not
    differentiable. CPU tensors take the plain version; CUDA tensors launch
    the kernel, which raises if it cannot build or launch; a launch counts
    as `launches.k3` (`utils/tracing.py`). Returns (accum (T, 4, 256),
    t_final (T, 256))."""
    if packed.device.type == "cpu":
        return blend_infer_plain(packed, gauss_id, tile_start, tile_count,
                                 tiles_x)
    out = launch_infer(packed, gauss_id, tile_start, tile_count, tiles_x)
    tracing.count("launches.k3")
    return out


def launch_infer(packed, gauss_id, tile_start, tile_count, tiles_x: int):
    """Launch K3 on PyTorch's current stream. Counts no launch:
    `blend_infer` does."""
    _check_launch("blend_infer", packed,
                  dict(gauss_id=(gauss_id, 1), tile_start=(tile_start, 1),
                       tile_count=(tile_count, 1)), {},
                  rec_dtype=torch.int32, rec_cols=REC_INFER)
    num_tiles = tile_start.shape[0]
    accum = torch.empty((num_tiles, NUM_FEAT_INFER, PIX),
                        dtype=torch.float32, device=packed.device)
    t_final = torch.empty((num_tiles, PIX), dtype=torch.float32,
                          device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    _raise_on(_kernel("blend_infer")(
        packed.data_ptr(), gauss_id.data_ptr(), tile_start.data_ptr(),
        tile_count.data_ptr(), num_tiles, tiles_x, accum.data_ptr(),
        t_final.data_ptr(), stream), "blend_infer")
    return accum, t_final
