"""The least time of the blend kernels K1 (forward) and K2 (backward) on
given inputs, from what their walks need: a frozen copy of the port's
plain walks' pair counting (`ops/blend.py`) and of its operation counts
per pair (`chip_smoke.py:201-236`, `558-620`), against the H100's
published f32 and memory peaks.

A pair is charged what the cheapest scheme now known computes for it, and
a test that only skips work as if its margin were zero, so that no count
exceeds what the kernels do. The walks visit only the tiles that still
have work; tiles that are done add nothing to any count.
"""

from __future__ import annotations

import torch

PEAK_F32_OPS = 67e12        # f32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM bytes/s
TILE, PIX, WARP = 16, 256, 32
WARP_W, WARP_H = 8, 4
FORWARD_ROWS = 2            # pixels per thread of K1, 4 rows apart
REC, NUM_FEAT, NUM_GRAD = 12, 6, 10
CHUNK = 32
ALPHA_CLAMP, ALPHA_MIN, T_EPS = 0.99, 1.0 / 255.0, 1e-4
SKIP_MARGIN, CULL_REL = 1e-3, 1e-5

# Per (warp, instance) pair that a warp tests: the cull on one lane.
OPS_CULL = 55
# Per evaluated pair that passes the cull: K1 shares the column terms
# between a thread's two pixels; K2 has one pixel per thread.
OPS_KEPT_FORWARD = 11
OPS_KEPT_BACKWARD = 13
# alpha >= 1/255: expf (6), opa·e, the clamp, the test.
OPS_EXP = 9
# K1: 1 − alpha, T·(1 − alpha), the 1e-4 test; its used pair: w and 6
# feature multiply-adds.
OPS_ALPHA_OK = 3
OPS_USED = 13
# K2's used pair after expf: the recursion, the colour dot, the alpha,
# power, conic and opacity gradients and 4 feature gradients.
OPS_BWD_USED = 42


def tile_pixels(num_tiles: int, tiles_x: int, device):
    tids = torch.arange(num_tiles, device=device)[:, None]
    pp = torch.arange(PIX, device=device)[None, :]
    return (((tids % tiles_x) * TILE + pp % TILE).to(torch.float32),
            ((tids // tiles_x) * TILE + pp // TILE).to(torch.float32))


def by_warp(x, rows: int = 1):
    """(..., 256) tile-order values → (..., warps, 32·rows) by the warp
    that owns the pixel (8 wide, 4·rows tall blocks)."""
    lead = x.shape[:-1]
    tall = WARP_H * rows
    x = x.reshape(*lead, TILE // tall, tall, TILE // WARP_W, WARP_W)
    return x.transpose(-3, -2).reshape(*lead, PIX // (WARP * rows),
                                       WARP * rows)


def warp_rects(tiles, tiles_x: int, rows: int = 1):
    """Inclusive pixel bounds (x0, x1, y0, y1) of each warp's block of
    the tiles `tiles`, each (len(tiles), warps)."""
    tall = WARP_H * rows
    tids = tiles[:, None]
    w = torch.arange(PIX // (WARP * rows), device=tiles.device)[None, :]
    x0 = ((tids % tiles_x) * TILE
          + (w % (TILE // WARP_W)) * WARP_W).to(torch.float32)
    y0 = ((tids // tiles_x) * TILE
          + (w // (TILE // WARP_W)) * tall).to(torch.float32)
    return x0, x0 + (WARP_W - 1), y0, y0 + (tall - 1)


def _edge_min(s, b, f, e, lo, hi):
    be = b * e
    t = torch.minimum(torch.maximum(-be / f, lo), hi)
    return s * e * e + 2.0 * be * t + f * t * t


def warp_cull_keep(rec, x0, x1, y0, y1):
    """False only where no pixel of the rectangle can reach alpha >= 1/255
    for the instance `rec[..., 0:6]` (the kernels' `cull_keep`)."""
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
    mag = a * mx * mx + c * my * my + 2.0 * b.abs() * mx * my
    skip = -torch.log(255.0 * rec[..., 5]) - SKIP_MARGIN
    reject = ((a > 0) & (c > 0) & (a * c > b * b)
              & (bound + CULL_REL * mag < skip))
    return ~reject


def _warp_counts(seen, keep_k, used, rows):
    seen_w = by_warp(seen, rows)
    kept = seen_w.any(dim=-1) & keep_k
    return [seen_w.any(dim=-1).sum(), kept.sum(),
            (seen_w & kept[..., None]).sum(),
            by_warp(used, rows).any(dim=-1).sum()]


def forward_counts(rec, gauss_id, tile_start, tile_count, tiles_x: int):
    """What K1's walk visits on these inputs: warp_live, warp_kept,
    kept_evaluated, alpha_ok and used pairs."""
    dev = rec.device
    num_tiles = tile_start.shape[0]
    px_all, py_all = tile_pixels(num_tiles, tiles_x, dev)
    t_all = torch.ones((num_tiles, PIX), device=dev)
    done_all = torch.zeros((num_tiles, PIX), dtype=torch.bool, device=dev)
    ranks = torch.arange(CHUNK, device=dev)
    count_all = tile_count.to(torch.int64)
    n = torch.zeros(6, dtype=torch.int64, device=dev)
    for c0 in range(0, int(tile_count.max()), CHUNK):
        sel = torch.nonzero((count_all > c0) & ~done_all.all(dim=1))[:, 0]
        if sel.numel() == 0:
            break
        px, py, t, done = px_all[sel], py_all[sel], t_all[sel], done_all[sel]
        rects = [b[:, None, :] for b in warp_rects(sel, tiles_x,
                                                   FORWARD_ROWS)]
        in_range = (c0 + ranks)[None, :] < count_all[sel, None]
        idx = torch.where(in_range, tile_start.to(torch.int64)[sel, None]
                          + c0 + ranks[None, :], 0)
        r = rec[gauss_id[idx].to(torch.int64)]
        keep = warp_cull_keep(r[:, :, None, :], *rects)
        dx = r[:, :, 0:1] - px[:, None, :]
        dy = r[:, :, 1:2] - py[:, None, :]
        power = (-0.5 * (r[:, :, 2:3] * dx * dx + r[:, :, 4:5] * dy * dy)
                 - r[:, :, 3:4] * dx * dy)
        alpha = torch.clamp(r[:, :, 5:6] * torch.exp(power), max=ALPHA_CLAMP)
        valid = in_range[:, :, None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        for k in range(CHUNK):
            live = valid[:, k] & ~done
            test_t = t * (1.0 - alpha[:, k])
            fail = live & (test_t < T_EPS)
            used = live & ~fail
            seen = in_range[:, k, None] & ~done
            n += torch.stack([live.sum(), used.sum(),
                              *_warp_counts(seen, keep[:, k], used,
                                            FORWARD_ROWS)])
            t = torch.where(used, test_t, t)
            done = done | fail
        t_all[sel], done_all[sel] = t, done
    return dict(zip(("alpha_ok", "used", "warp_live", "warp_kept",
                     "kept_evaluated", "warp_active"), n.tolist()))


def backward_counts(rec, gauss_id, tile_start, n_contrib, tiles_x: int):
    """What K2's walk visits on these inputs: used pairs, tile_active
    ((tile, instance) pairs with a used pixel, which pay the atomics),
    warp_live, warp_kept, kept_evaluated and warp_active."""
    dev = rec.device
    num_tiles = tile_start.shape[0]
    px_all, py_all = tile_pixels(num_tiles, tiles_x, dev)
    ncon_all = n_contrib.to(torch.int64)
    max_rank_all = ncon_all.max(dim=1).values
    ranks = torch.arange(CHUNK, device=dev)
    n = torch.zeros(6, dtype=torch.int64, device=dev)
    for c0 in range(0, int(max_rank_all.max()), CHUNK):
        sel = torch.nonzero(max_rank_all > c0)[:, 0]
        px, py, ncon = px_all[sel], py_all[sel], ncon_all[sel]
        rects = [b[:, None, :] for b in warp_rects(sel, tiles_x)]
        rank = c0 + ranks
        in_range = rank[None, :] < max_rank_all[sel, None]
        gid = gauss_id[torch.where(in_range, tile_start.to(torch.int64)[
            sel, None] + rank[None, :], 0)].to(torch.int64)
        r = rec[gid]
        dx = r[:, :, 0:1] - px[:, None, :]
        dy = r[:, :, 1:2] - py[:, None, :]
        power = (-0.5 * (r[:, :, 2:3] * dx * dx + r[:, :, 4:5] * dy * dy)
                 - r[:, :, 3:4] * dx * dy)
        alpha = torch.clamp(r[:, :, 5:6] * torch.exp(power), max=ALPHA_CLAMP)
        evaluated = rank[None, :, None] < ncon[:, None, :]
        used = evaluated & (power <= 0.0) & (alpha >= ALPHA_MIN)
        n += torch.stack([used.sum(), used.any(dim=-1).sum(),
                          *_warp_counts(evaluated,
                                        warp_cull_keep(r[:, :, None, :],
                                                       *rects), used, 1)])
    return dict(zip(("used", "tile_active", "warp_live", "warp_kept",
                     "kept_evaluated", "warp_active"), n.tolist()))


def bound_s(ops: float, nbytes: float) -> float:
    """The larger of the operations against the f32 peak and the bytes
    against the memory peak."""
    return max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES)


def forward_ops(c: dict) -> float:
    return (c["warp_live"] * OPS_CULL + c["kept_evaluated"] * OPS_KEPT_FORWARD
            + c["alpha_ok"] * (OPS_EXP + OPS_ALPHA_OK) + c["used"] * OPS_USED)


def forward_bound(args) -> tuple[float, float]:
    """(seconds, operations) of K1 on its arguments (rec, gauss_id,
    tile_start, tile_count, tiles_x): the walk's operations, or the bytes
    (48-byte records, the ids, the tiles' ranges and 8 output planes, each
    once), whichever bounds."""
    rec, gauss_id, tile_start, tile_count, tiles_x = args
    c = forward_counts(rec, gauss_id, tile_start, tile_count, tiles_x)
    tiles = tile_start.numel()
    nbytes = (rec.shape[0] * REC * 4 + gauss_id.numel() * 4 + tiles * 8
              + tiles * PIX * 8 * 4)
    ops = forward_ops(c)
    return bound_s(ops, nbytes), ops


def backward_ops(c: dict) -> float:
    return (c["warp_live"] * OPS_CULL
            + c["kept_evaluated"] * OPS_KEPT_BACKWARD
            + c["used"] * (OPS_EXP + OPS_BWD_USED)
            + (c["used"] - c["tile_active"]) * NUM_GRAD)


def backward_bound(args) -> tuple[float, float]:
    """(seconds, operations) of K2 on its arguments (rec, gauss_id,
    tile_start, t_final, n_contrib, dcot, tiles_x): the walk's operations,
    or the bytes (records read and gradients written, ids, tile starts,
    T_final, n_contrib, the cotangents, and a 40-byte row per (tile,
    instance) pair that the atomics add), whichever bounds."""
    rec, gauss_id, tile_start, t_final, n_contrib, dcot, tiles_x = args
    c = backward_counts(rec, gauss_id, tile_start, n_contrib, tiles_x)
    nbytes = (2 * rec.numel() * 4 + gauss_id.numel() * 4
              + tile_start.numel() * 4 + t_final.numel() * 8
              + dcot.numel() * 4 + c["tile_active"] * NUM_GRAD * 4)
    ops = backward_ops(c)
    return bound_s(ops, nbytes), ops
