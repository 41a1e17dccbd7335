"""The port's auxiliary modules against the JAX package's, on the CPU:
`ops/pointops.py` (every function, on the same numpy inputs; nearest and
furthest-point ties to the lowest index), `utils/lpips.py` (the AlexNet
LPIPS on the synthetic weights of tests/test_lpips.py) and `data/n3v.py`
(poses, transforms_*.json, the known-pose COLMAP model, and the failure
without colmap).

Tolerances: indices and files equal; distances, features and logits
rtol 1e-5 / atol 1e-6 (f32 gathers and sums in another order); LPIPS
atol 1e-5."""

import json
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.data import n3v as jax_n3v
from fourdgs_tpu.ops import pointops as jax_pointops
from fourdgs_tpu.utils import lpips as jax_lpips
from fourdgs_tpu_torch.data import n3v as port_n3v
from fourdgs_tpu_torch.ops import pointops as port_pointops
from fourdgs_tpu_torch.utils import lpips as port_lpips

from torch_helpers import one_torch_thread  # noqa: F401


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def both(fn, *args, **kw):
    """(port result, JAX result) of the function `fn` of each package on
    the same numpy inputs."""
    def call(mod, to):
        conv = lambda a: to(a) if isinstance(a, np.ndarray) else a  # noqa
        return getattr(mod, fn)(*map(conv, args),
                                **{k: conv(v) for k, v in kw.items()})

    return call(port_pointops, torch.as_tensor), call(jax_pointops,
                                                      jnp.asarray)


def grid_cloud(rng):
    """Points on an integer grid, many of them at equal distances from
    each other (ties), plus duplicates."""
    pts = rng.integers(-3, 4, (60, 3)).astype(np.float32)
    pts[50:] = pts[:10]
    return pts


def test_knn_and_fps_match_jax_with_ties(rng):
    pts = grid_cloud(rng)
    src = np.stack([pts, pts[::-1].copy()])
    x = np.stack([pts[:20], pts[20:40]])
    (idx, dist), (jidx, jdist) = both("knn", x, src, 7)
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (2, 20, 7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    close(dist, jdist)
    for k in (1, 5, 17):
        got, want = both("fps", pts, k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_knn_self_matches_jax(rng):
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    valid = np.arange(300) < 280
    (idx, d2), (jidx, jd2) = both("knn_self", pts, 6, valid=valid)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    close(d2, jd2)


def test_grouping_interpolation_subtraction_aggregation_match_jax(rng):
    src = rng.normal(size=(40, 3)).astype(np.float32)
    dst = rng.normal(size=(25, 3)).astype(np.float32)
    feats = rng.normal(size=(40, 6)).astype(np.float32)
    idx = rng.integers(0, 40, (25, 4)).astype(np.int32)
    weights = rng.random((25, 4)).astype(np.float32)
    a = rng.normal(size=(25, 6)).astype(np.float32)
    close(*both("grouping", feats, idx))
    close(*both("interpolation", src, dst, feats, k=3))
    # Interpolating at grid points with ties among the nearest three.
    grid = grid_cloud(rng)
    close(*both("interpolation", grid, grid[:30], rng.normal(
        size=(60, 2)).astype(np.float32), k=3))
    close(*both("subtraction", a, feats, idx))
    close(*both("aggregation", feats, weights, idx))


def test_attention_ops_match_jax(rng):
    n, h, d, m, tab = 12, 2, 4, 30, 5
    q, k, v = (rng.normal(size=(n, h, d)).astype(np.float32)
               for _ in range(3))
    index0 = np.sort(rng.integers(0, n, m)).astype(np.int32)
    index1 = rng.integers(0, n, m).astype(np.int32)
    attn = rng.normal(size=(m, h)).astype(np.float32)
    table = rng.normal(size=(tab, h, d, 3)).astype(np.float32)
    table_k = rng.normal(size=(tab, h, d, 3)).astype(np.float32)
    rel_idx = rng.integers(0, tab, (m, 3)).astype(np.int32)
    offsets = np.searchsorted(index0, np.arange(n + 1)).astype(np.int32)
    close(*both("attention_step1", q, k, index0, index1))
    close(*both("attention_step2", attn, v, index0, index1))
    close(*both("attention_step2", attn, v, index0, index1, n=n + 3))
    close(*both("dot_prod_with_idx", q, index0, table, rel_idx))
    close(*both("attention_step2_with_rel_pos_value", attn, v, index0,
                index1, table, rel_idx))
    close(*both("attention_step1_v2", q, k, index1, offsets, n_max=8))
    close(*both("attention_step2_v2", attn, v, index0, index1))
    close(*both("dot_prod_with_idx_v2", q, index0, k, index1, table,
                table_k, rel_idx))
    close(*both("dot_prod_with_idx_v3", q, offsets, 8, k, index1, table,
                table_k, rel_idx))
    close(*both("attention_step2_with_rel_pos_value_v2", attn, v, offsets,
                8, index1, table, rel_idx))


def synthetic_weights(rng):
    """Random LPIPS(alex) weights (tests/test_lpips.py:10-19)."""
    w = {}
    cin = 3
    for i, (cout, k, *_rest) in enumerate(jax_lpips._ALEX_CONVS):
        w[f"conv{i}_w"] = rng.normal(0, 0.05, (k, k, cin, cout)).astype(
            np.float32)
        w[f"conv{i}_b"] = np.zeros(cout, np.float32)
        w[f"lin{i}_w"] = rng.random(cout).astype(np.float32)
        cin = cout
    return w


def test_lpips_matches_jax(rng, tmp_path):
    w = synthetic_weights(rng)
    path = str(tmp_path / "lpips_alex.npz")
    np.savez(path, **w)
    a = rng.random((67, 73, 3)).astype(np.float32)    # odd sizes
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    batch = np.stack([a, b])
    port_lpips.load_weights(path)
    jax_lpips._WEIGHTS = w
    try:
        for x, y in ((a, b), (batch, batch[::-1].copy())):
            got = float(port_lpips.lpips(torch.as_tensor(x),
                                         torch.as_tensor(y)))
            want = float(jax_lpips.lpips(jnp.asarray(x), jnp.asarray(y)))
            assert want > 0
            np.testing.assert_allclose(got, want, atol=1e-5)
        assert float(port_lpips.lpips(torch.as_tensor(a),
                                      torch.as_tensor(a))) < 1e-6
    finally:
        port_lpips._WEIGHTS = None
        jax_lpips._WEIGHTS = None


def test_lpips_needs_weights(rng, monkeypatch):
    monkeypatch.setenv("FOURDGS_LPIPS_WEIGHTS", "")
    port_lpips._WEIGHTS = None
    assert not port_lpips.weights_available()
    a = torch.as_tensor(rng.random((32, 32, 3)).astype(np.float32))
    with pytest.raises(RuntimeError, match="LPIPS weights not found"):
        port_lpips.lpips(a, a)


def ring_poses_bounds(n=4):
    """LLFF poses_bounds of n cameras on a ring facing the origin
    (tests/test_aux_modules.py:63-82)."""
    poses = np.zeros((n, 3, 5))
    for i in range(n):
        theta = 2 * np.pi * i / n
        pos = np.array([3 * np.sin(theta), 0.2, 3 * np.cos(theta)])
        back = pos / np.linalg.norm(pos)
        right = np.cross(np.array([0, 1, 0]), -back)
        right /= np.linalg.norm(right)
        down = np.cross(-back, right)
        poses[i, :, 0], poses[i, :, 1], poses[i, :, 2] = down, right, back
        poses[i, :, 3] = pos
        poses[i, :, 4] = [480, 640, 500.0]
    return np.concatenate([poses.reshape(n, 15),
                           np.tile([[1.0, 10.0]], (n, 1))], axis=1)


def scene_dir(root, pb, frames=3):
    os.makedirs(root / "images")
    for cam in range(pb.shape[0]):
        for f in range(frames):
            (root / "images" / f"cam{cam:02d}_{f:04d}.png").write_bytes(b"")
    np.save(root / "poses_bounds.npy", pb)
    return root


def files_of(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            out[rel] = (os.readlink(path).replace(str(root), "<root>")
                        if os.path.islink(path)
                        else open(path, "rb").read())
    return out


def test_n3v_poses_transforms_and_model_match_jax(tmp_path):
    pb = ring_poses_bounds()
    poses, h, w, fl = port_n3v.convert_llff_poses(pb)
    jposes, jh, jw, jfl = jax_n3v.convert_llff_poses(pb)
    np.testing.assert_array_equal(poses, jposes)
    assert (h, w, fl) == (jh, jw, jfl) == (480, 640, 500.0)

    dirs = {}
    for name, mod in (("port", port_n3v), ("jax", jax_n3v)):
        root = scene_dir(tmp_path / name, pb)
        mod.write_transforms(str(root), test_cam_index=1)
        # Time-0 frames into the known-pose model (frames stand in for
        # extracted PNGs: symlinks only).
        mod.write_known_pose_model(str(root), str(root / "ws"))
        dirs[name] = files_of(root)
    assert dirs["port"] == dirs["jax"]
    with open(tmp_path / "port" / "transforms_test.json") as f:
        test = json.load(f)
    assert [fr["file_path"] for fr in test["frames"]] == [
        f"images/cam01_{i:04d}" for i in range(3)]


def test_n3v_triangulation_fails_without_colmap(tmp_path, monkeypatch):
    for mod in (port_n3v, jax_n3v):
        monkeypatch.setattr(mod.shutil, "which", lambda _: None)
        assert mod.triangulate_points(str(tmp_path)) is False
    root = tmp_path / "scene"
    os.makedirs(root / "images")
    with open(root / "transforms_train.json", "w") as f:
        json.dump({"w": 8, "h": 8, "fl_x": 4.0, "fl_y": 4.0, "cx": 4,
                   "cy": 4, "frames": []}, f)

    def boom(*a, **k):
        raise subprocess.CalledProcessError(1, a)

    monkeypatch.setattr(port_n3v.shutil, "which", lambda _: "/bin/colmap")
    monkeypatch.setattr(port_n3v.subprocess, "run", boom)
    assert port_n3v.triangulate_points(str(root)) is False
    assert not (root / "colmap_tmp").exists()
    assert not (root / "points3d.ply").exists()
    # preprocess_n3v says so when neither frames nor ffmpeg are there.
    monkeypatch.setattr(port_n3v.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="ffmpeg unavailable"):
        port_n3v.preprocess_n3v(str(tmp_path / "empty"))
