"""Tile binning: expand gaussians into per-tile instances, sort by
(tile, depth), and compute per-tile ranges.

PyTorch counterpart of `fourdgs_tpu/ops/binning.py:bin_gaussians` (the
reference pipeline `rasterizer_impl.cu:199-364`: InclusiveSum →
duplicateWithKeys → 64-bit radix sort → identifyTileRanges). The JAX
version works inside a static instance capacity; here the instance list is
sized from the true `num_rendered`, read once on the host, so nothing is
ever dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import tracing
from .preprocess import ProcessedGaussians, RenderOptions


class TileBins(NamedTuple):
    gauss_id: torch.Tensor      # (R,) int32, instance → gaussian, sorted
    #                             by (tile, depth, expansion slot)
    tile_start: torch.Tensor    # (num_tiles,) int32 first instance of tile
    tile_count: torch.Tensor    # (num_tiles,) int32 instances of tile
    num_rendered: int           # R, the true instance count (host value)
    max_per_tile: torch.Tensor  # () int32 densest tile population
    dropped: int                # instances not rendered: 0 by construction


def bin_gaussians(proc: ProcessedGaussians, opts: RenderOptions) -> TileBins:
    """Build the sorted (tile, depth) instance list.

    Instances are laid out in expansion order (gaussian index, then
    row-major over the gaussian's tile rect) and sorted STABLY on the key
    (tile << 32) | float_bits(depth): every binned gaussian is in front of
    the near plane (depth > 0.2), and positive float bits order as
    integers, so ties in depth keep expansion order as the JAX sort's
    explicit slot key does.
    """
    device = proc.depth.device
    counts_g = proc.tiles_touched.to(torch.int64)
    offsets = torch.cumsum(counts_g, dim=0)               # inclusive
    num_rendered = (tracing.read("binning", offsets[-1])
                    if offsets.numel() else 0)

    gid = torch.repeat_interleave(
        torch.arange(counts_g.numel(), device=device), counts_g,
        output_size=num_rendered)
    local = (torch.arange(num_rendered, device=device)
             - (offsets - counts_g)[gid])
    rect = proc.rect.to(torch.int64)[gid]
    width = torch.clamp(rect[:, 2] - rect[:, 0], min=1)
    row = torch.div(local, width, rounding_mode="floor")
    tile = (rect[:, 1] + row) * opts.tiles_x + rect[:, 0] + local - row * width

    depth_bits = proc.depth[gid].view(torch.int32)
    key = (tile << 32) | depth_bits.to(torch.int64)
    _, order = torch.sort(key, stable=True)

    counts = torch.bincount(tile, minlength=opts.num_tiles)
    start = torch.cumsum(counts, dim=0) - counts
    return TileBins(
        gauss_id=gid[order].to(torch.int32),
        tile_start=start.to(torch.int32),
        tile_count=counts.to(torch.int32),
        num_rendered=num_rendered,
        max_per_tile=counts.max().to(torch.int32),
        dropped=0,
    )
