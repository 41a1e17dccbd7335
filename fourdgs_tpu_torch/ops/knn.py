"""k nearest neighbours of the gaussian means: the rigid loss's `knn` and
the initial scales' `mean_dist2_to_3nn`.

PyTorch counterpart of `fourdgs_tpu/ops/knn.py:knn` (the reference's
pointops `knnquery`, `utils/general_utils.py:170-184`): exact for small N;
for large N a block-exact sweep over a Morton-sorted cloud, in `passes`
rotated orders merged by distance. Morton codes are int64 here (PyTorch's
uint32 support is thin), and every top-k is `torch.topk`, which is exact
where the JAX package may use `approx_min_k` on a TPU.
"""

from __future__ import annotations

import numpy as np
import torch

EXACT_MAX = 2048   # the exact O(N²) path up to this many points
GROUP_PAIRS = 1 << 27  # distance-matrix floats of one group of sweep blocks
NN3_PAIRS = 1 << 26    # distance-matrix floats of one row chunk of the 3-NN


def mean_dist2_to_3nn(points: torch.Tensor) -> torch.Tensor:
    """(N,) mean squared distance of each of the (N, 3) `points` to its 3
    nearest other points (the reference's simple-knn `distCUDA2`,
    `gaussian_model.py:274`; the JAX package's `native.mean_dist2_to_3nn`).
    Exact: every pair, in row chunks of about `NN3_PAIRS` distances,
    each summed difference-first as dx² + dy² + dz², and the mean of the
    three smallest as (d0 + d1 + d2) / 3. Duplicate points are each
    other's neighbours at distance 0. Up to 4 points: 1e-4 each, as the
    JAX package's native path gives."""
    n = points.shape[0]
    if n <= 4:
        return torch.full((n,), 1e-4, dtype=points.dtype,
                          device=points.device)
    rows = max(1, NN3_PAIRS // n)
    out = []
    for r0 in range(0, n, rows):
        blk = points[r0:r0 + rows]
        d2 = sum((blk[:, None, a] - points[None, :, a]) ** 2
                 for a in range(3))
        own = torch.arange(blk.shape[0], device=points.device)
        d2[own, r0 + own] = float("inf")
        near = torch.topk(d2, 3, dim=1, largest=False).values
        out.append((near[:, 0] + near[:, 1] + near[:, 2]) / 3.0)
    return torch.cat(out)


def _pass_rotation(p: int) -> np.ndarray:
    """Fixed decorrelating rotation of sweep pass `p` (0: the identity):
    the JAX package's, from the same numpy seed."""
    if p == 0:
        return np.eye(3, dtype=np.float32)
    rng = np.random.default_rng(1000 + p)
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    return (q * np.sign(np.diag(r))).astype(np.float32)


def _spread_bits(x: torch.Tensor) -> torch.Tensor:
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) of (N, 3) points on a 1024³ grid over
    their bounding box."""
    lo = points.min(dim=0).values
    hi = points.max(dim=0).values
    q = (points - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0
    q = torch.clamp(q, 0, 1023).to(torch.int64)
    return (_spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << 1)
            | (_spread_bits(q[:, 2]) << 2))


def knn(points: torch.Tensor, k: int = 20, span: int = 32768,
        valid: torch.Tensor | None = None, row_block: int = 2048,
        passes: int = 2):
    """k nearest neighbours of each point among `points` (N, 3).

    Returns (idx (N, k) int64, dist2 (N, k) f32), nearest first, self
    excluded. `valid` (N,) masks padding rows: they are never returned as
    neighbours. Up to EXACT_MAX points every pair is compared; above, each block of `row_block` Morton-sorted rows is
    compared exactly with the 2·`span` sorted columns around it, in
    `passes` rotated Morton orders merged by distance (the JAX package's
    design and defaults)."""
    n = points.shape[0]
    big = float("inf")
    if n <= EXACT_MAX:
        d2 = torch.sum((points[:, None, :] - points[None, :, :]) ** 2, -1)
        d2 = d2.fill_diagonal_(big)
        if valid is not None:
            d2 = torch.where(valid[None, :], d2, big)
        neg, idx = torch.topk(-d2, k, dim=1)
        return idx, -neg

    if passes > 1 and 2 * span < n:
        res = [_knn_sweep(points @ torch.as_tensor(
                   _pass_rotation(p), device=points.device).T,
                   k, span, valid, row_block)
               for p in range(passes)]
        idx_all = torch.cat([r[0] for r in res], dim=1)
        d2_all = torch.cat([r[1] for r in res], dim=1)
        # Dedup (the same neighbour found by several passes): sort pairs
        # by index, stably, kill repeats, then re-select the k nearest.
        idx_s, order = torch.sort(idx_all, dim=1, stable=True)
        d2_s = torch.gather(d2_all, 1, order)
        dup = torch.zeros_like(idx_s, dtype=torch.bool)
        dup[:, 1:] = idx_s[:, 1:] == idx_s[:, :-1]
        d2_s = torch.where(dup, big, d2_s)
        neg, j = torch.topk(-d2_s, k, dim=1)
        return torch.gather(idx_s, 1, j), -neg
    return _knn_sweep(points, k, span, valid, row_block)


def _knn_sweep(points: torch.Tensor, k: int, span: int,
               valid: torch.Tensor | None, row_block: int):
    """One block-exact Morton-window sweep (see `knn`)."""
    n = points.shape[0]
    device = points.device
    big = float("inf")
    code = morton_codes(points)
    if valid is not None:
        code = torch.where(valid, code, 0xFFFFFFFF)
    order = torch.sort(code, stable=True).indices

    r = row_block
    n_pad = (n + r - 1) // r * r
    # Padding rows sit past the real points with +inf coordinates (never
    # selected as neighbours; their own results are discarded).
    sp = torch.full((n_pad, 3), big, dtype=points.dtype, device=device)
    sp[:n] = points[order]
    if valid is not None:
        sval = torch.zeros(n_pad, dtype=torch.bool, device=device)
        sval[:n] = valid[order]
        sp = torch.where(sval[:, None], sp, big)
    w = min(2 * span, n_pad)
    n_blocks = n_pad // r

    # Blocks in groups, so that a group's distance matrix stays near
    # GROUP_PAIRS floats.
    group = max(1, GROUP_PAIRS // (r * w))
    parts = [_sweep_blocks(sp, b0, min(b0 + group, n_blocks), r, w, k)
             for b0 in range(0, n_blocks, group)]
    vals = torch.cat([v for v, _ in parts])
    gidx = torch.cat([g for _, g in parts])
    vals = vals.reshape(n_pad, k)[:n]
    gidx = torch.clamp(gidx.reshape(n_pad, k)[:n], 0, n - 1)
    # Un-sort: sorted row i holds original point order[i].
    idx = torch.empty((n, k), dtype=torch.int64, device=device)
    idx[order] = order[gidx]
    dist2 = torch.empty((n, k), dtype=points.dtype, device=device)
    dist2[order] = torch.where(torch.isfinite(vals), vals, big)
    return idx, dist2


def _sweep_blocks(sp: torch.Tensor, b0: int, b1: int, r: int, w: int,
                  k: int):
    """Blocks [b0, b1) of the sweep over the sorted points `sp` (n_pad, 3):
    (dist2 (nb, r, k), sorted-space column index (nb, r, k))."""
    device = sp.device
    big = float("inf")
    nb = b1 - b0
    row0 = (b0 + torch.arange(nb, device=device)) * r
    start = torch.clamp(row0 + r // 2 - w // 2, 0, sp.shape[0] - w)
    rows = sp[b0 * r:b1 * r].reshape(nb, r, 3)
    cols = sp[start[:, None] + torch.arange(w, device=device)]  # (nb, w, 3)
    # Centre on the row block: |xi|² + |xj|² − 2 xi·xj loses ~all
    # mantissa bits for close pairs unless coordinates are local.
    finite = torch.isfinite(rows)
    c = (torch.where(finite, rows, 0.0).sum(dim=1)
         / finite.sum(dim=1))                                  # (nb, 3)
    c = torch.where(torch.isfinite(c), c, 0.0)[:, None, :]
    rz = torch.where(finite, rows - c, 1e17)
    cz = torch.where(torch.isfinite(cols), cols - c, 1e17)
    cross = torch.bmm(rz, cz.transpose(1, 2))                  # (nb, r, w)
    d2 = ((rz * rz).sum(-1)[:, :, None] + (cz * cz).sum(-1)[:, None, :]
          - 2.0 * cross)
    gcol = start[:, None] + torch.arange(w, device=device)     # (nb, w)
    own = row0[:, None] + torch.arange(r, device=device)       # (nb, r)
    d2 = torch.where(gcol[:, None, :] == own[:, :, None], big,
                     torch.clamp(d2, min=0.0))
    _, j = torch.topk(-d2, k, dim=2)                           # (nb, r, k)
    # The matmul form loses about half the mantissa to cancellation for
    # close pairs: recompute the k winners' distances difference-first.
    win = torch.gather(cz, 1, j.reshape(nb, r * k, 1).expand(-1, -1, 3))
    win = win.reshape(nb, r, k, 3)
    vals = torch.zeros(j.shape, dtype=sp.dtype, device=device)
    for a in range(3):
        vals = vals + (win[..., a] - rz[:, :, None, a]) ** 2
    return vals, torch.gather(gcol[:, None, :].expand(-1, r, -1), 2, j)
