"""The port's data layer against the JAX package's on the same files:
`load_scene` on tests/fixtures/synth_gate (cameras, matrices, timestamps,
images, point cloud), the COLMAP readers on bytes written here, the
resolution policy, PLY round trips. Both are host-side numpy, so the
tolerance is none (equality) unless a test says otherwise."""

import dataclasses
import json
import os
import shutil
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from fourdgs_tpu.data import cameras as jax_cameras
from fourdgs_tpu.data import colmap as jax_colmap
from fourdgs_tpu.data import pointcloud as jax_pc
from fourdgs_tpu.data import scene as jax_scene
from fourdgs_tpu_torch.data import cameras as port_cameras
from fourdgs_tpu_torch.data import colmap as port_colmap
from fourdgs_tpu_torch.data import pointcloud as port_pc
from fourdgs_tpu_torch.data import scene as port_scene

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "synth_gate")
CAMERA_FIELDS = ("uid", "fovx", "fovy", "width", "height", "timestamp",
                 "image_name", "image_path", "cx", "cy", "fl_x", "fl_y",
                 "meta_only")
CAMERA_ARRAYS = ("rot", "trans", "viewmatrix", "projmat", "full_proj",
                 "campos")


def _assert_cameras_equal(port, ref):
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        for f in CAMERA_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        for f in CAMERA_ARRAYS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        for f in ("image", "alpha_mask"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y, f)
        arrays, ref_arrays = a.arrays("cpu"), b.arrays()
        for f in ref_arrays._fields:
            np.testing.assert_array_equal(getattr(arrays, f).numpy(),
                                          np.asarray(getattr(ref_arrays, f)),
                                          f)


def _assert_scenes_equal(port, ref):
    _assert_cameras_equal(port.train_cameras, ref.train_cameras)
    if ref.test_cameras:
        _assert_cameras_equal(port.test_cameras, ref.test_cameras)
    assert port.test_cameras == [] or len(port.test_cameras) == len(
        ref.test_cameras)
    np.testing.assert_array_equal(port.translate, ref.translate)
    assert port.radius == ref.radius
    for f in ("points", "colors", "normals", "times"):
        x, y = getattr(port.point_cloud, f), getattr(ref.point_cloud, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, f)


@pytest.mark.parametrize("kw", [
    dict(resolution=1), dict(resolution=2, white_background=True),
    dict(resolution=1, dataloader=True, time_duration=(0.0, 0.6)),
    dict(resolution=48, eval_holdout=False, num_extra_pts=7)],
    ids=["full", "half_white", "lazy_time_filter", "width48_no_holdout"])
def test_load_scene_synth_gate_equals_jax(kw):
    args = dict(num_pts=300, time_duration=(0.0, 1.0), seed=3)
    args.update(kw)
    port = port_scene.load_scene(FIXTURE, **args)
    ref = jax_scene.load_scene(FIXTURE, **args)
    _assert_scenes_equal(port, ref)
    assert port.train_cameras[0].width == (96 if kw["resolution"] == 1
                                           else 48)


def test_random_pointcloud_and_lazy_fetch_equal_jax(tmp_path):
    """A scene without points3d.ply: both packages draw the same random
    cloud from the seed, write it, and read the same quantised colours."""
    roots = []
    for name in ("port", "jax"):
        root = tmp_path / name
        shutil.copytree(FIXTURE, root,
                        ignore=shutil.ignore_patterns("points3d.ply"))
        roots.append(str(root))
    args = dict(num_pts=200, time_duration=(0.0, 1.0), resolution=1, seed=5,
                dataloader=True)
    port = port_scene.load_scene(roots[0], **args)
    ref = jax_scene.load_scene(roots[1], **args)
    np.testing.assert_array_equal(port.point_cloud.points,
                                  ref.point_cloud.points)
    np.testing.assert_array_equal(port.point_cloud.colors,
                                  ref.point_cloud.colors)
    assert os.path.exists(os.path.join(roots[0], "points3d.ply"))
    img, alpha = port_scene.load_image_composited(
        port.test_cameras[0].image_path, True)
    ref_img, ref_alpha = jax_scene.load_image_composited(
        ref.test_cameras[0].image_path, True)
    np.testing.assert_array_equal(img, ref_img)
    assert (alpha is None) == (ref_alpha is None)
    np.testing.assert_array_equal(port_scene.resize_image(img, (40, 30)),
                                  jax_scene.resize_image(ref_img, (40, 30)))


@pytest.mark.parametrize("args", [(800, 600, 2), (3200, 1600, -1),
                                  (800, 600, -1), (1352, 1014, 400),
                                  (1000, 750, 3), (641, 479, 8)])
def test_resolution_policy_equals_jax(args):
    assert (port_scene.compute_resolution_scale(*args)
            == jax_scene.compute_resolution_scale(*args))


def test_camera_helpers_equal_jax(rng):
    for fov, px in ((0.7, 800), (1.2, 1352)):
        assert port_cameras.fov2focal(fov, px) == jax_cameras.fov2focal(fov,
                                                                        px)
        f = port_cameras.fov2focal(fov, px)
        assert port_cameras.focal2fov(f, px) == jax_cameras.focal2fov(f, px)
    cams = port_scene.load_scene(FIXTURE, num_pts=50, resolution=1
                                 ).test_cameras
    ref = jax_scene.load_scene(FIXTURE, num_pts=50, resolution=1).test_cameras
    stacked = port_cameras.stack_cameras(cams, device="cpu")
    want = jax_cameras.stack_cameras(ref)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(stacked, f).numpy(),
                                      getattr(want, f), f)
    assert stacked.viewmatrix.shape == (len(cams), 4, 4)
    scaled = port_scene.scale_cameras(
        [dataclasses.replace(cams[0], fl_x=100.0, fl_y=101.0, cx=48.0,
                             cy=47.0)], 2)[0]
    assert (scaled.width, scaled.fl_x, scaled.cy) == (48, 50.0, 23.5)
    assert scaled.image.shape == (48, 48, 3)


def _write_colmap_model(sparse, binary=True):
    os.makedirs(sparse, exist_ok=True)
    if not binary:
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            f.write("# comment\n1 PINHOLE 32 24 30.0 31.0 16.0 12.0\n"
                    "2 SIMPLE_PINHOLE 32 24 29.0 16.0 12.0\n")
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            f.write("# comment\n")
            for i in range(3):
                f.write(f"{i + 1} 0.9 0.1 {0.1 * i} 0.2 {0.1 * i} 0 4.0 "
                        f"{1 + i % 2} img_{i}.png\n1.0 2.0 -1\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as f:
            f.write("# comment\n")
            for i in range(4):
                f.write(f"{i} {0.1 * i} 0.2 0.3 200 100 {50 + i} 0.5 1 0\n")
        return
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 32, 24))  # PINHOLE
        f.write(struct.pack("<dddd", 30.0, 31.0, 16.0, 12.0))
        f.write(struct.pack("<iiQQ", 2, 0, 32, 24))  # SIMPLE_PINHOLE
        f.write(struct.pack("<ddd", 29.0, 16.0, 12.0))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", 3))
        for i in range(3):
            f.write(struct.pack("<idddddddi", i + 1, 0.9, 0.1, 0.1 * i, 0.2,
                                0.1 * i, 0, 4.0, 1 + i % 2))
            f.write(f"img_{i}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ddqddq", 1.0, 2.0, -1, 3.0, 4.0, 7))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 4))
        for i in range(4):
            f.write(struct.pack("<QdddBBBd", i, 0.1 * i, 0.2, 0.3,
                                200, 100, 50 + i, 0.5))
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<iiii", 1, 0, 2, 1))


@pytest.mark.parametrize("binary", [True, False], ids=["bin", "txt"])
def test_colmap_readers_equal_jax(tmp_path, binary):
    sparse = str(tmp_path / "sparse" / "0")
    _write_colmap_model(sparse, binary)
    cams, imgs = port_colmap.read_model(sparse)
    ref_cams, ref_imgs = jax_colmap.read_model(sparse)
    assert set(cams) == set(ref_cams) == {1, 2}
    assert set(imgs) == set(ref_imgs) == {1, 2, 3}
    for k, rc in ref_cams.items():
        assert (cams[k].model, cams[k].width, cams[k].height) == (
            rc.model, rc.width, rc.height)
        np.testing.assert_array_equal(cams[k].params, rc.params)
    for k, ri in ref_imgs.items():
        assert (imgs[k].name, imgs[k].camera_id) == (ri.name, ri.camera_id)
        np.testing.assert_array_equal(imgs[k].qvec, ri.qvec)
        np.testing.assert_array_equal(imgs[k].tvec, ri.tvec)
        np.testing.assert_array_equal(port_colmap.qvec2rotmat(imgs[k].qvec),
                                      jax_colmap.qvec2rotmat(ri.qvec))
    for got, want in zip(port_colmap.read_points3d(sparse),
                         jax_colmap.read_points3d(sparse)):
        np.testing.assert_array_equal(got, want)
    assert cams[2].model == "SIMPLE_PINHOLE" and imgs[3].name == "img_2.png"


def test_colmap_scene_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    for name in ("port", "jax"):
        _write_colmap_model(str(tmp_path / name / "sparse" / "0"))
        os.makedirs(tmp_path / name / "images")
    for i in range(3):
        arr = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
        for name in ("port", "jax"):
            Image.fromarray(arr).save(tmp_path / name / "images"
                                      / f"img_{i}.png")
    for kw in (dict(eval_holdout=False), dict(eval_holdout=True),
               dict(eval_holdout=False, num_pts_ratio=2.0, seed=4)):
        port = port_scene.load_scene(str(tmp_path / "port"), resolution=1,
                                     **kw)
        ref = jax_scene.load_scene(str(tmp_path / "jax"), resolution=1, **kw)
        assert [c.image_name for c in port.train_cameras] == [
            c.image_name for c in ref.train_cameras]
        for a, b in zip(port.train_cameras + port.test_cameras,
                        ref.train_cameras + ref.test_cameras):
            np.testing.assert_array_equal(a.viewmatrix, b.viewmatrix)
            np.testing.assert_array_equal(a.full_proj, b.full_proj)
            np.testing.assert_array_equal(a.image, b.image)
            assert (a.fovx, a.fovy) == (b.fovx, b.fovy)
        np.testing.assert_array_equal(port.point_cloud.points,
                                      ref.point_cloud.points)
        np.testing.assert_array_equal(port.point_cloud.colors,
                                      ref.point_cloud.colors)
        assert port.radius == ref.radius
    with pytest.raises(ValueError, match="Could not recognize"):
        port_scene.load_scene(str(tmp_path / "nothing_here"))


@pytest.mark.parametrize("with_times", [True, False])
def test_ply_round_trip_across_packages(tmp_path, rng, with_times):
    """A PLY written by either package reads back equal in the other."""
    pts = rng.normal(size=(17, 3)).astype(np.float32)
    cols = rng.random((17, 3)) * 255
    times = rng.random((17, 1)).astype(np.float32) if with_times else None
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    port_pc.write_ply(a, pts, cols, times=times)
    jax_pc.write_ply(b, pts, cols, times=times)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    got, want = port_pc.read_ply(b), jax_pc.read_ply(a)
    np.testing.assert_array_equal(got.points, pts)
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    if with_times:
        np.testing.assert_array_equal(got.times, times)
    else:
        assert got.times is None and want.times is None


def test_ascii_ply_reads_equal(tmp_path):
    path = tmp_path / "a.ply"
    path.write_text(
        "ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
        "property float y\nproperty float z\nproperty uchar red\n"
        "property uchar green\nproperty uchar blue\nend_header\n"
        "0.5 1.5 -2 255 0 128\n1 2 3 10 20 30\n")
    got, want = port_pc.read_ply(str(path)), jax_pc.read_ply(str(path))
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.points[0].tolist() == [0.5, 1.5, -2.0]


def test_camera_arrays_default_device_is_cuda():
    """Entry points run on the card unless asked otherwise: with no CUDA
    device here, `arrays()` without a device raises."""
    cam = port_cameras.Camera(uid=0, rot=np.eye(3), trans=np.zeros(3),
                              fovx=1.0, fovy=1.0, width=8, height=8)
    if torch.cuda.is_available():
        assert cam.arrays().viewmatrix.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            cam.arrays()
    assert json.dumps(cam.arrays("cpu").viewmatrix.tolist())
