"""One frame as horizontal strips, rendered one by one or on different
ranks and joined into the full frame.

PyTorch counterpart of `fourdgs_tpu/parallel/strips.py`. A frame of
height H splits into n strips of H/n rows. The JAX package renders strip
s as a camera of its own: height H/n, the principal point moved up by
s·H/n rows (cy' = cy − s·H/n, the centre-shift projection of the
reference's real intrinsics, `graphics_utils.py:74-92`); `strip_cameras`,
`strip_batch_arrays`, `split_image` and `join_strips` make those cameras
and images here too, for parity with the JAX package's API (its tests
hold them to JAX's); the port's own paths do not use them. The port renders
strip s as a WINDOW of the frame instead (`strip_windows`): the frame's
own camera, rows from s·H/n rounded down to the 16-row tile grid,
positions projected in the frame and shifted by the window's first row
(exact in f32, `ops/preprocess.py:RenderOptions.row0`). A strip camera
of its own bins on a grid shifted from the frame's where H/n is not a
multiple of 16 (a gaussian reaches the pixels of every tile its rect
touches, beyond its radius), and it rounds positions differently, which
the blend's 1/255 alpha floor and 1e-4 transmittance stop turn into
jumps of the order of 1/255 at some pixels. The window's rows, cut to
the strip (`window_rows`), are the full frame's bit for bit
(`tests/test_torch_strips.py`), save where a gaussian far above the
window makes the shift inexact. Binning and blending touch only the
window's tiles. The strips of a frame spread over the ranks of a process
group (`engine/step.py:train_step` with a mesh, `engine/evaluator.py`);
in one process the Trainer and the Evaluator render the full frame,
which the strips equal at n times the preprocess.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

from ..data.cameras import Camera, stack_cameras
from ..ops.preprocess import TILE, CameraArrays, RenderOptions


def strip_cameras(cam: Camera, n_strips: int) -> List[Camera]:
    """Split a camera into n horizontal strip cameras, top to bottom. The
    height must divide by n. A FoV camera becomes explicit fl_x, fl_y, cx,
    cy first."""
    if cam.height % n_strips != 0:
        raise ValueError(f"height {cam.height} not divisible by {n_strips}")
    sh = cam.height // n_strips
    if cam.fl_x > 0:
        fl_x, fl_y, cx, cy = cam.fl_x, cam.fl_y, cam.cx, cam.cy
    else:
        fl_x = cam.width / (2 * math.tan(cam.fovx / 2))
        fl_y = cam.height / (2 * math.tan(cam.fovy / 2))
        cx, cy = cam.width / 2.0, cam.height / 2.0
    return [dataclasses.replace(cam, height=sh, fl_x=fl_x, fl_y=fl_y, cx=cx,
                                cy=cy - s * sh, image=None, alpha_mask=None)
            for s in range(n_strips)]


def strip_batch_arrays(cam: Camera, n_strips: int,
                       device="cuda") -> CameraArrays:
    """Stacked CameraArrays of the strip cameras (leading axis = strip)."""
    return stack_cameras(strip_cameras(cam, n_strips), device)


def strip_options(opts: RenderOptions, n_strips: int) -> RenderOptions:
    """The render options of one strip."""
    if opts.height % n_strips != 0:
        raise ValueError(f"height {opts.height} not divisible by {n_strips}")
    return opts._replace(height=opts.height // n_strips)


def window_rows(height: int, n_strips: int) -> List[int]:
    """Rows of each strip's window above the strip, (s·H/n) mod 16: the
    rows to cut from the top of its render."""
    sh = height // n_strips
    return [(s * sh) % TILE for s in range(n_strips)]


def strip_windows(opts: RenderOptions,
                  n_strips: int) -> List[RenderOptions]:
    """The render options of each strip's window of the frame `opts`:
    rows [s·H/n − window_rows[s], (s + 1)·H/n) of the frame, rendered with
    the frame's camera."""
    sh = strip_options(opts, n_strips).height
    return [opts._replace(height=(s + 1) * sh - (s * sh - o),
                          frame_height=opts.height, row0=s * sh - o)
            for s, o in enumerate(window_rows(opts.height, n_strips))]


def window_intrinsics(intrinsics: torch.Tensor,
                      window: RenderOptions) -> torch.Tensor:
    """[fl_x, fl_y, cx, cy] of the frame → the window's (cy − row0), for
    the env map's rays."""
    if not window.row0:
        return intrinsics
    return intrinsics - intrinsics.new_tensor([0.0, 0.0, 0.0,
                                               float(window.row0)])


def split_image(img: torch.Tensor, n_strips: int) -> torch.Tensor:
    """(H, W, ...) → (n, H/n, W, ...) strip batch."""
    h = img.shape[0]
    return img.reshape((n_strips, h // n_strips) + tuple(img.shape[1:]))


def join_strips(strips: torch.Tensor) -> torch.Tensor:
    """(n, H/n, W, ...) → (H, W, ...)."""
    s = strips.shape
    return strips.reshape((s[0] * s[1],) + tuple(s[2:]))
