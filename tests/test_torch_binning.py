"""The port's tile binning against the JAX package's `bin_gaussians` and
`bin_gaussians_aligned`, on the same preprocessed gaussians: per-tile
depth-ordered gaussian ids, `num_rendered` and `max_per_tile` agree
exactly, and the port never drops an instance."""

import jax.numpy as jnp
import numpy as np
import pytest

from fourdgs_tpu.ops import binning as jax_binning
from fourdgs_tpu.ops import preprocess as jax_pre
from fourdgs_tpu_torch.ops import binning as port_binning
from fourdgs_tpu_torch.ops import preprocess as port_pre

from torch_helpers import corner_scene, saturated_scene, to_torch
from utils import look_at_camera, random_scene

OPTS = dict(height=48, width=40, gaussian_dim=4, rot_4d=True,
            time_duration=1.0)


def _jax_proc(scene, dup_depths):
    cam = look_at_camera(width=OPTS["width"], height=OPTS["height"])
    proc = jax_pre.preprocess(
        **{k: jnp.asarray(v) for k, v in scene.items()}, camera=cam.arrays(),
        opts=jax_pre.RenderOptions(**OPTS))
    if dup_depths:
        # Coarse depths: many exact ties, which must keep expansion order.
        proc = proc._replace(depth=jnp.round(proc.depth))
    return proc


def _port_lists(bins, num_tiles):
    ids = bins.gauss_id.numpy()
    start, count = bins.tile_start.numpy(), bins.tile_count.numpy()
    return [ids[start[t]:start[t] + count[t]].tolist()
            for t in range(num_tiles)]


def _jax_lists(bins, num_tiles):
    ids = np.asarray(bins.gauss_id)
    start, stop = np.asarray(bins.tile_start), np.asarray(bins.tile_stop)
    return [ids[start[t]:stop[t]].tolist() for t in range(num_tiles)]


def _aligned_lists(abins, num_tiles, p):
    ids = np.asarray(jax_binning.aligned_gauss_ids(abins))
    start, count = np.asarray(abins.tile_start), np.asarray(abins.tile_count)
    return [[g for g in ids[start[t]:start[t] + count[t]] if g < p]
            for t in range(num_tiles)]


SCENES = {
    "random": lambda rng: random_scene(rng, p=120),
    "saturated": saturated_scene,
    "corner": corner_scene,
}


@pytest.mark.parametrize("dup_depths", [False, True])
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_tile_lists_match_jax(rng, scene_name, dup_depths):
    scene = SCENES[scene_name](rng)
    jproc = _jax_proc(scene, dup_depths)
    opts = port_pre.RenderOptions(**OPTS)
    nt = opts.num_tiles
    p = scene["means3d"].shape[0]

    port = port_binning.bin_gaussians(
        port_pre.ProcessedGaussians(*to_torch(jproc)), opts)
    ref = jax_binning.bin_gaussians(jproc, jax_pre.RenderOptions(**OPTS),
                                    capacity=16384)
    aligned = jax_binning.bin_gaussians_aligned(
        jproc, jax_pre.RenderOptions(**OPTS), capacity=16384, k=128)

    assert port.num_rendered == int(ref.num_rendered) > 0
    assert int(port.max_per_tile) == int(ref.max_per_tile)
    assert port.dropped == 0 == int(ref.dropped) == int(aligned.dropped)
    assert port.gauss_id.shape == (port.num_rendered,)
    lists = _port_lists(port, nt)
    assert lists == _jax_lists(ref, nt)
    assert lists == _aligned_lists(aligned, nt, p)


def test_empty_cloud_bins_nothing():
    opts = port_pre.RenderOptions(**OPTS)
    scene = to_torch(random_scene(np.random.default_rng(1), p=16))
    scene["active"][:] = False
    from torch_helpers import port_camera

    cam = port_camera(look_at_camera(width=OPTS["width"],
                                     height=OPTS["height"]))
    proc = port_pre.preprocess(**scene, camera=cam, opts=opts)
    bins = port_binning.bin_gaussians(proc, opts)
    assert bins.num_rendered == 0 and bins.gauss_id.numel() == 0
    assert int(bins.tile_count.sum()) == 0 and int(bins.max_per_tile) == 0
