"""The port's synthetic-scene generator (fourdgs_tpu_torch/data/synth.py
and `python -m fourdgs_tpu_torch.gen_synth_dataset`) against the JAX
package's, on the CPU at small sizes.

Tolerances: the scene, the poses, the times, the sky, the transforms JSON,
the manifests and gt_cloud.npz exact; the ground-truth renders within atol
1e-5 on colour and alpha (two oracles, one f32 arithmetic); the 8-bit PNGs
within 1 level on at most 0.5% of the pixels (truncation can flip a level
where the renders differ in the last bits); the oracle's bands of tile
rows bit-exact against the whole frame."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from fourdgs_tpu.data import synth as jax_synth
from fourdgs_tpu_torch import gen_synth_dataset
from fourdgs_tpu_torch.data import synth
from fourdgs_tpu_torch.data.cameras import Camera
from fourdgs_tpu_torch.ops import reference_renderer
from fourdgs_tpu_torch.ops.preprocess import TILE, RenderOptions
from fourdgs_tpu_torch.ops.reference_renderer import render_reference

from torch_helpers import one_torch_thread  # noqa: F401

BODY_FIELDS = ("local", "colors", "scale", "center0", "orbit_amp",
               "orbit_freq", "orbit_phase", "spin_axis", "spin_rate")


@pytest.mark.parametrize("points_scale,seed", [(0.05, 0), (1.0, 0),
                                               (0.3, 7)])
def test_scene_equals_jax(points_scale, seed):
    port = synth.make_scene(points_scale=points_scale, seed=seed)
    ref = jax_synth.make_scene(points_scale=points_scale, seed=seed)
    assert port.n_points == ref.n_points
    for bp, br in zip(port.bodies, ref.bodies, strict=True):
        for f in BODY_FIELDS:
            np.testing.assert_array_equal(getattr(bp, f), getattr(br, f),
                                          err_msg=f)
    for u in (0.0, 0.37, 1.0):
        np.testing.assert_array_equal(port.positions_at(u),
                                      ref.positions_at(u))
    np.testing.assert_array_equal(port.colors(), ref.colors())
    np.testing.assert_array_equal(port.scales(), ref.scales())


def test_poses_sky_and_rig_equal_jax():
    assert synth.FOVX == jax_synth.FOVX
    for n, seed in ((7, 0), (120, 0), (5, 3)):
        for a, b in zip(synth.sample_train_poses(n, seed),
                        jax_synth.sample_train_poses(n, seed)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(synth.sample_test_poses(n),
                        jax_synth.sample_test_poses(n)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(synth.rig_poses(n, seed=seed),
                                      jax_synth.rig_poses(n, seed=seed))
    eye = synth.sample_train_poses(3, 0)[0][1]
    for a, b in zip(synth.look_at_pose(eye), jax_synth.look_at_pose(eye)):
        np.testing.assert_array_equal(a, b)
    for res, seed in ((256, 0), (16, 5)):
        np.testing.assert_array_equal(synth._sky_texture(res, seed),
                                      jax_synth._sky_texture(res, seed))


@pytest.mark.parametrize("white", [True, False], ids=["white", "black"])
def test_render_frames_match_jax(white):
    scene = synth.make_scene(points_scale=0.05, seed=0)
    eyes, times = synth.sample_train_poses(2, 0)
    port = list(synth.render_frames(scene, eyes, times, 48, 48,
                                    white_background=white, device="cpu"))
    ref = list(jax_synth.render_frames(
        jax_synth.make_scene(points_scale=0.05, seed=0), eyes, times, 48,
        48, white_background=white))
    assert len(port) == len(ref) == 2
    for (color, alpha), (rc, ra) in zip(port, ref):
        assert color.dtype == np.float32 and color.shape == (48, 48, 3)
        assert alpha.shape == (48, 48)
        assert 0.0 <= color.min() and color.max() <= 1.0
        np.testing.assert_allclose(color, rc, rtol=0, atol=1e-5)
        np.testing.assert_allclose(alpha, ra, rtol=0, atol=1e-5)
        assert 0.05 < alpha.mean() < 0.95      # the scene is in view


@pytest.mark.parametrize("tile_rows", [1, 2])
def test_banded_oracle_equals_whole_frame(tile_rows, monkeypatch):
    """Bands of tile rows (the last one short with 2 of 3), set through the
    pair budget, give the whole frame's result bit for bit, colour, depth,
    flow and alpha."""
    scene = synth.make_scene(points_scale=0.05, seed=1)
    p = scene.n_points
    rng = np.random.default_rng(0)
    eye = synth.sample_test_poses(4)[0][1]
    rot, trans, _ = synth.look_at_pose(eye)
    cam = Camera(uid=0, rot=rot, trans=trans, fovx=synth.FOVX,
                 fovy=synth.FOVX, width=40, height=44, timestamp=0.3)
    quat = rng.normal(size=(p, 4)).astype(np.float32)
    args = dict(
        means3d=torch.as_tensor(scene.positions_at(0.3)),
        t=torch.as_tensor(rng.uniform(0, 1, p).astype(np.float32)),
        scales=torch.as_tensor(np.repeat(scene.scales()[:, None], 3, 1)),
        scales_t=torch.full((p,), 0.5), rotations=torch.as_tensor(quat),
        rotations_r=torch.as_tensor(quat[::-1].copy()),
        opacity=torch.as_tensor(rng.uniform(0.2, 0.99, p).astype(
            np.float32)),
        sh=torch.as_tensor(rng.normal(0, 0.5, (p, 16, 3)).astype(
            np.float32)),
        active=torch.ones(p, dtype=torch.bool), camera=cam.arrays("cpu"),
        bg=torch.tensor([0.2, 0.3, 0.4]),
        opts=RenderOptions(height=44, width=40, gaussian_dim=4))
    assert reference_renderer.band_tile_rows(p, 40) >= 3   # one band
    whole = render_reference(**args)
    monkeypatch.setattr(reference_renderer, "BAND_PAIRS",
                        tile_rows * TILE * 48 * p)
    assert reference_renderer.band_tile_rows(p, 40) == tile_rows
    banded = render_reference(**args)
    for a, b in zip(whole, banded, strict=True):
        assert torch.equal(a, b)
    assert float(whole[3].max()) > 0.5


def test_band_tile_rows():
    # 400 px wide, 4,670 points: 4 tile rows (120M pairs) per band.
    assert reference_renderer.band_tile_rows(4670, 400) == 4
    assert reference_renderer.band_tile_rows(10 ** 9, 400) == 1
    assert reference_renderer.band_tile_rows(10, 48) >= 3


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_dataset(port_dir, jax_dir):
    """Same file list; JSON byte-equal; gt_cloud.npz arrays equal; PNGs
    within 1 level on at most 0.5% of the pixels."""
    files = _files(port_dir)
    assert files == _files(jax_dir)
    pngs = [f for f in files if f.endswith(".png")]
    assert pngs
    for name in files:
        a, b = os.path.join(port_dir, name), os.path.join(jax_dir, name)
        if name.endswith(".json"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
        elif name.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for key in za.files:
                    np.testing.assert_array_equal(za[key], zb[key])
    flipped = total = 0
    for name in pngs:
        a = np.asarray(Image.open(os.path.join(port_dir, name)), np.int16)
        b = np.asarray(Image.open(os.path.join(jax_dir, name)), np.int16)
        assert a.shape == b.shape, name
        diff = np.abs(a - b)
        assert diff.max() <= 1, name
        flipped += int((diff > 0).any(-1).sum())
        total += diff.shape[0] * diff.shape[1]
    assert flipped <= 0.005 * total, f"{flipped} of {total} pixels differ"
    return files


def test_generate_dataset_equals_jax(tmp_path):
    kw = dict(n_train=3, n_test=2, width=48, height=48, points_scale=0.05,
              seed=0)
    port = synth.generate_dataset(str(tmp_path / "port"), device="cpu", **kw)
    ref = jax_synth.generate_dataset(str(tmp_path / "jax"), **kw)
    files = _same_dataset(port, ref)
    assert "train/r_002.png" in files and "test/r_001.png" in files
    with open(os.path.join(port, "transforms_train.json")) as f:
        frames = json.load(f)["frames"]
    assert [fr["file_path"] for fr in frames] == [
        f"./train/r_{i:03d}" for i in range(3)]


def test_generate_dataset_dynerf_equals_jax(tmp_path):
    kw = dict(n_cams=3, n_frames=2, n_test_frames=2, width=32, height=32,
              points_scale=0.05, seed=0)
    port = synth.generate_dataset_dynerf(str(tmp_path / "port"),
                                         device="cpu", **kw)
    ref = jax_synth.generate_dataset_dynerf(str(tmp_path / "jax"), **kw)
    files = _same_dataset(port, ref)
    # Cameras 1 and 2 train (2 frames each), camera 0 is the test view.
    assert len([f for f in files if f.startswith("train/")]) == 4
    assert len([f for f in files if f.startswith("test/cam00_")]) == 2
    rgba = np.asarray(Image.open(os.path.join(port, "test",
                                              "cam00_f0001.png")))
    assert rgba.shape == (32, 32, 4)


def test_generator_cli_needs_a_card_or_cpu(tmp_path, capsys):
    parser = gen_synth_dataset.build_parser()
    defaults = parser.parse_args([])
    assert (defaults.out, defaults.n_train, defaults.n_test, defaults.size,
            defaults.points_scale, defaults.seed, defaults.n_cams,
            defaults.n_frames, defaults.device, defaults.dynerf) == (
        "datasets/synth_quality", 120, 20, 400, 1.0, 0, 15, 60, "cuda",
        False)
    out = tmp_path / "ds"
    argv = ["--out", str(out), "--n_train", "2", "--n_test", "1",
            "--size", "32", "--points_scale", "0.05"]
    if not torch.cuda.is_available():
        assert gen_synth_dataset.main(argv) == 2
        assert "no CUDA device" in capsys.readouterr().err
        assert not out.exists()
    assert gen_synth_dataset.main(argv + ["--device", "cpu"]) == 0
    assert "dataset ready" in capsys.readouterr().out
    manifest = out / "synth_manifest.json"
    stamp = manifest.stat().st_mtime_ns
    assert gen_synth_dataset.main(argv + ["--device", "cpu"]) == 0
    assert manifest.stat().st_mtime_ns == stamp       # manifest matched
    assert len(list((out / "train").iterdir())) == 2


def test_generator_cli_dynerf_default_out(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert gen_synth_dataset.main(
        ["--dynerf", "--device", "cpu", "--n_cams", "2", "--n_frames", "1",
         "--n_test", "1", "--size", "16", "--points_scale", "0.05"]) == 0
    with open(tmp_path / "datasets" / "synth_dynerf"
              / "synth_manifest.json") as f:
        assert json.load(f)["kind"] == "dynerf"
