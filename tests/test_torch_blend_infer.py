"""The port's packed inference blend (the plain PyTorch version of kernel
K3, which the wrapper runs for CPU tensors) against the JAX package: the
packed table bit for bit against `pallas_blend._pack2` and the source rows
of `_build_inst_data_infer`; the compositing against the JAX exact blend fed
the same bf16-rounded values; `render(infer=True)` against the JAX
`render(backend="pallas_interpret", infer=True)`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import binning as jax_binning
from fourdgs_tpu.ops import pallas_blend
from fourdgs_tpu.ops import preprocess as jax_pre
from fourdgs_tpu.render import render as jax_render
from fourdgs_tpu_torch.ops import binning as port_binning
from fourdgs_tpu_torch.ops import blend as port_blend
from fourdgs_tpu_torch.utils import tracing
from fourdgs_tpu_torch.ops import preprocess as port_pre
from fourdgs_tpu_torch.render import render

from torch_helpers import (check_cull_against_exact_test, corner_scene,
                           cull_records, port_camera, saturated_scene,
                           to_torch, walk_pair_counts)
from utils import look_at_camera, random_scene

OPTS = dict(height=48, width=40, gaussian_dim=4, rot_4d=True,
            time_duration=1.0)
KW = dict(capacity=16384, max_per_tile=1024, chunk=32)
BG = np.array([0.1, 0.2, 0.3], np.float32)

SCENES = {
    "partial_tiles": lambda rng: random_scene(rng, p=56),
    "saturated": saturated_scene,
    "empty_tiles": corner_scene,
}


def _jax_proc(scene):
    cam = look_at_camera(width=OPTS["width"], height=OPTS["height"])
    return cam, jax_pre.preprocess(
        **{k: jnp.asarray(v) for k, v in scene.items()}, camera=cam.arrays(),
        opts=jax_pre.RenderOptions(**OPTS))


def _port_inputs(jproc):
    opts = port_pre.RenderOptions(**OPTS)
    proc = port_pre.ProcessedGaussians(*to_torch(jproc))
    return opts, proc, port_binning.bin_gaussians(proc, opts)


def _bf16(x):
    """Round-to-nearest-even to bf16 and back, by JAX."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _edge_values():
    """f32 values whose bf16 rounding is delicate: zeros of both signs,
    negatives, ties to even (0x3F808000 → down, 0x3F818000 → up), values
    that round up into the next exponent (0x3FFFFFFF → 2.0), the largest
    finite f32 values below the bf16 overflow, subnormals."""
    bits = np.array([0x00000000, 0x80000000, 0x3F808000, 0x3F818000,
                     0x3F808001, 0x3FFFFFFF, 0xBFFFFFFF, 0x3F7FFFFF,
                     0x7F7F7FFF, 0x00000001, 0x80012345, 0x477FE000,
                     0xC2F6E979, 0x3B808081], np.uint32)
    return bits.view(np.float32)


def test_pack2_bit_for_bit(rng):
    """`blend._pack2` equals `pallas_blend._pack2` on every bit, on random
    values and on the rounding edge cases. Tolerance: none."""
    a = np.concatenate([_edge_values(),
                        rng.normal(0, 3, 500).astype(np.float32),
                        (rng.random(500) * 1e-3).astype(np.float32)])
    b = np.concatenate([_edge_values()[::-1],
                        rng.normal(0, 100, 1000).astype(np.float32)])
    want = np.asarray(pallas_blend._pack2(jnp.asarray(a), jnp.asarray(b)))
    got = port_blend._pack2(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_pack_records_infer_bit_for_bit(rng, scene_name):
    """The (P, 8) table equals the source rows of `_build_inst_data_infer`
    (pallas_blend.py:1008-1015) bit for bit, and unpacking it gives the
    bf16-rounded columns exactly. Tolerance: none."""
    _, jproc = _jax_proc(SCENES[scene_name](rng))
    feat = jnp.concatenate([jproc.rgb, jproc.depth[:, None]], axis=-1)
    p = jproc.xy.shape[0]
    bits = jax.lax.bitcast_convert_type(
        jnp.concatenate([jproc.xy, jproc.conic], axis=1), jnp.uint32)
    want = np.asarray(jnp.concatenate([
        bits,
        pallas_blend._pack2(jproc.opacity, feat[:, 0])[:, None],
        pallas_blend._pack2(feat[:, 1], feat[:, 2])[:, None],
        pallas_blend._pack2(feat[:, 3], jnp.zeros((p,), jnp.float32))[:, None],
    ], axis=1))
    _, proc, _ = _port_inputs(jproc)
    packed = port_blend.pack_records_infer(proc)
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (p, 8)
    assert packed.is_contiguous()
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), want)

    rec = port_blend.unpack_records_infer(packed).numpy()
    np.testing.assert_array_equal(rec[:, 0:2], np.asarray(jproc.xy))
    np.testing.assert_array_equal(rec[:, 2:5], np.asarray(jproc.conic))
    np.testing.assert_array_equal(rec[:, 5], _bf16(jproc.opacity))
    np.testing.assert_array_equal(rec[:, 6:9], _bf16(jproc.rgb))
    np.testing.assert_array_equal(rec[:, 9], _bf16(jproc.depth))


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_infer_plain_matches_exact_pallas_on_rounded_values(rng, scene_name):
    """`blend_infer_plain` against the JAX exact blend (`blend_pallas`,
    interpret mode, f32 rows) fed the same bf16-rounded opacity, rgb and
    depth: this isolates the packing from the TPU kernel's single-pass
    bf16 prefix sum. Colour and alpha rtol 1e-4 / atol 1e-5, depth rtol
    1e-3 / atol 1e-4 (tests/test_pallas_blend.py)."""
    _, jproc = _jax_proc(SCENES[scene_name](rng))
    opts, proc, bins = _port_inputs(jproc)
    accum, t_final = port_blend.blend_infer(
        port_blend.pack_records_infer(proc), bins.gauss_id, bins.tile_start,
        bins.tile_count, opts.tiles_x)
    assert tuple(accum.shape) == (opts.num_tiles, 4, 256)
    color, depth, alpha = (x.numpy() for x in
                           port_blend.assemble_outputs_infer(
                               accum, t_final, torch.as_tensor(BG), opts))

    jopts = jax_pre.RenderOptions(**OPTS)
    abins = jax_binning.bin_gaussians_aligned(
        jproc, jopts, KW["capacity"], pallas_blend.CHUNK)
    cfg = pallas_blend.PallasBlendConfig(
        height=jopts.height, width=jopts.width, tiles_x=jopts.tiles_x,
        tiles_y=jopts.tiles_y, interpret=True, inst_capacity=KW["capacity"])
    feat = jnp.concatenate([jnp.asarray(_bf16(jproc.rgb)),
                            jnp.asarray(_bf16(jproc.depth))[:, None],
                            jproc.flow], axis=-1)
    ref_color, ref_depth, _, ref_alpha = pallas_blend.blend_pallas(
        cfg, jproc.xy, jproc.conic, jnp.asarray(_bf16(jproc.opacity)), feat,
        jnp.asarray(BG), abins)
    np.testing.assert_allclose(color, np.asarray(ref_color), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(depth, np.asarray(ref_depth), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(alpha, np.asarray(ref_alpha), rtol=1e-4,
                               atol=1e-5)
    if scene_name == "saturated":
        assert int(bins.max_per_tile) > 256 and alpha[20:28, 16:24].min() > 0.999
    if scene_name == "empty_tiles":
        assert int((bins.tile_count == 0).sum()) > 0
        assert alpha[:16, :16].max() == 0.0 and alpha.max() > 0.05


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_render_infer_matches_jax_infer(rng, scene_name):
    """`render(infer=True)` against the JAX `render(backend=
    "pallas_interpret", infer=True)`, whose transmittance is a single-pass
    bf16 prefix sum: atol 1.5e-2, depth scaled by its largest value
    (tests/test_pallas_blend.py:270-289). Flow is zeros, num_rendered
    equal, and the port's fast path stays within the same tolerance of
    its own exact path."""
    scene = SCENES[scene_name](rng)
    cam = look_at_camera(width=OPTS["width"], height=OPTS["height"])
    kw = dict(camera=port_camera(cam), bg=torch.as_tensor(BG),
              opts=port_pre.RenderOptions(**OPTS))
    out = render(**to_torch(scene), **kw, infer=True)
    exact = render(**to_torch(scene), **kw)
    ref = jax_render(**{k: jnp.asarray(v) for k, v in scene.items()},
                     camera=cam.arrays(), bg=jnp.asarray(BG),
                     opts=jax_pre.RenderOptions(**OPTS),
                     backend="pallas_interpret", infer=True, **KW)
    for other_color, other_alpha, other_depth in (
            (np.asarray(ref.color), np.asarray(ref.alpha),
             np.asarray(ref.depth)),
            (exact.color.numpy(), exact.alpha.numpy(), exact.depth.numpy())):
        np.testing.assert_allclose(out.color.numpy(), other_color,
                                   atol=1.5e-2)
        np.testing.assert_allclose(out.alpha.numpy(), other_alpha,
                                   atol=1.5e-2)
        np.testing.assert_allclose(
            out.depth.numpy(), other_depth,
            atol=1.5e-2 * max(1.0, np.abs(other_depth).max()))
    assert tuple(out.flow.shape) == (OPTS["height"], OPTS["width"], 2)
    assert np.all(out.flow.numpy() == 0.0)
    assert out.num_rendered == int(ref.num_rendered) == exact.num_rendered > 0
    assert out.instances_dropped == 0
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(ref.radii))


def test_render_infer_carries_no_graph(rng):
    """The packed path is not differentiable: with parameters that require
    a gradient its outputs carry no graph, while the exact path's do."""
    scene = to_torch(random_scene(rng, p=24))
    scene["means3d"].requires_grad_()
    cam = port_camera(look_at_camera(width=32, height=32))
    kw = dict(camera=cam, bg=torch.as_tensor(BG),
              opts=port_pre.RenderOptions(height=32, width=32))
    assert not render(**scene, **kw, infer=True).color.requires_grad
    assert render(**scene, **kw).color.requires_grad
    assert torch.is_grad_enabled()


@pytest.mark.parametrize("scene_name", ["partial_tiles", "saturated"])
def test_infer_plain_pair_counts(rng, scene_name):
    """`blend_infer_plain`'s pair counts against a pixel-by-pixel walk in
    numpy over the unpacked (rounded) records, by pair and by K3's 8x8
    warp rectangle: what its walk culls, evaluates and uses. Tolerance:
    none."""
    _, jproc = _jax_proc(SCENES[scene_name](rng))
    opts, proc, bins = _port_inputs(jproc)
    packed = port_blend.pack_records_infer(proc)
    counts = {}
    port_blend.blend_infer_plain(packed, bins.gauss_id, bins.tile_start,
                                 bins.tile_count, opts.tiles_x,
                                 pair_counts=counts)
    want = walk_pair_counts(port_blend.unpack_records_infer(packed), bins,
                            opts)
    assert counts == want
    assert want["used"] > 0
    assert want["warp_active"] <= want["warp_kept"] < want["warp_live"]


@pytest.mark.parametrize("kind", ["random", "near_threshold", "correlated",
                                  "degenerate"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_cull_never_rejects_a_used_pair_on_packed_records(kind, seed):
    """K3's cull and expf pre-test on the records it decodes: the cull
    tests' records (random, opacities near 1/255, thin correlated conics,
    degenerate conics) packed into the (P, 8) table (`_pack2`: opacity and
    the features to bf16) and unpacked as the kernel decodes them. On every
    8x8 warp rectangle of a 48x40 image with partial tiles, wherever the
    exact test on the decoded record accepts a pixel, `skip_threshold` of
    the decoded opacity does not skip it and `warp_cull_keep` keeps it;
    on the random kind the cull is not vacuous."""
    rng = np.random.default_rng(seed)
    rec = torch.as_tensor(cull_records(rng, kind, 600))
    feat = torch.as_tensor(rng.random((600, 4)).astype(np.float32))
    packed = torch.cat([
        rec[:, 0:5].contiguous().view(torch.int32),
        torch.stack([port_blend._pack2(rec[:, 5], feat[:, 0]),
                     port_blend._pack2(feat[:, 1], feat[:, 2]),
                     port_blend._pack2(feat[:, 3], torch.zeros(600))], 1)], 1)
    decoded = port_blend.unpack_records_infer(packed)
    assert torch.equal(decoded[:, 0:5], rec[:, 0:5])
    np.testing.assert_array_equal(decoded[:, 5].numpy(),
                                  _bf16(rec[:, 5].numpy()))
    # The rounding moves most opacities (the degenerate kind sets a
    # quarter to 0, 1 or 1.5, which bf16 holds), and so their thresholds.
    assert float((decoded[:, 5] != rec[:, 5]).float().mean()) > 0.7
    check_cull_against_exact_test(decoded, (port_blend.FORWARD_ROWS,),
                                  nonvacuous=kind == "random")


def test_infer_wrapper_never_runs_plain_off_cpu():
    """Only CPU tensors reach the plain version: any other device goes to
    the kernel path, which raises here (no CUDA), and counts nothing; the
    plain path counts no launch either."""
    before = tracing.totals().get("launches.k3", 0)
    meta = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")  # noqa: E731
    with pytest.raises((ValueError, RuntimeError)):
        port_blend.blend_infer(meta(4, 8), meta(3), meta(6), meta(6), 3)
    port_blend.blend_infer(
        torch.zeros((4, 8), dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), torch.zeros(6, dtype=torch.int32),
        torch.zeros(6, dtype=torch.int32), 3)
    assert tracing.totals().get("launches.k3", 0) == before
