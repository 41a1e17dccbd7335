"""The port's density control and initial cloud against the JAX package,
on the CPU: `densify_and_prune` (clone, split, prune), `prune_only`,
`reset_opacity`, `init_from_pcd` and the exact 3-NN distances.

The same numpy state goes through both packages: a JAX `GaussianState`
with padding rows past n_active and a denom of 0 on some rows, and the
port's state from it (`from_jax_state`). The split draws are the JAX
package's (`_split_children`'s keys, `jax.random.normal`, `fold_in(·, 1)`
for the time draw), handed to the port as its `noise` argument.
Tolerances: counts, row order, kept and cloned rows and their moments, the
zeroed moments and statistics, `prune_only`, `reset_opacity` and
`init_from_pcd` exact; split children rtol 1e-6 with atol 1e-7, an ulp
of a unit coordinate (the same f32 operations, but XLA and torch may sum
the rotation's products in another order: a child's xyz = parent + delta
keeps that ulp where it nears 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.models import densify as jax_densify
from fourdgs_tpu.models import gaussians as jax_gaussians
from fourdgs_tpu_torch.models import densify as port_densify
from fourdgs_tpu_torch.models import gaussians as port_gaussians
from fourdgs_tpu_torch.ops import knn as port_knn

FIELDS = jax_gaussians.GaussianParams._fields
STATS = ("xyz_grad_accum", "t_grad_accum", "denom", "max_radii2d")
EXTENT = 3.0


def _state(rng, n=400, capacity=840, channels=48):
    """A JAX GaussianState (numpy leaves): n active rows whose sizes
    straddle percent_dense · extent (0.03) and 0.1 · extent, opacities on
    both sides of min_opacity, gradient norms on both sides of the
    threshold, a denom of 0 on about a sixth of the rows; the JAX package's
    padding rows after them, with random statistics."""
    pad = jax_gaussians.empty_params(capacity, channels)
    raw = dict(
        xyz=rng.normal(0, 1, (n, 3)), t=rng.random((n, 1)),
        scaling=rng.normal(np.log(0.04), 1.0, (n, 3)),
        scaling_t=rng.normal(np.log(0.2), 0.3, (n, 1)),
        rotation=rng.normal(size=(n, 4)), rotation_r=rng.normal(size=(n, 4)),
        f_dc=rng.normal(size=(n, 1, 3)),
        f_rest=rng.normal(0, 0.1, (n, channels - 1, 3)),
        opacity=rng.normal(-2.0, 2.5, (n, 1)))
    params = jax_gaussians.GaussianParams(**{
        k: np.concatenate([v.astype(np.float32),
                           np.asarray(getattr(pad, k))[n:]])
        for k, v in raw.items()})

    def moment():
        return jax_gaussians.GaussianParams(*(
            np.abs(rng.normal(0, 1e-3, x.shape)).astype(np.float32)
            for x in params))

    denom = rng.integers(0, 6, capacity).astype(np.float32)
    return jax_gaussians.GaussianState(
        params=params,
        adam=jax_gaussians.AdamState(moment(), moment(), np.int32(7)),
        n_active=np.int32(n),
        xyz_grad_accum=(rng.random(capacity) * 4e-4 * np.maximum(denom, 1))
        .astype(np.float32),
        t_grad_accum=rng.normal(size=capacity).astype(np.float32),
        denom=denom, max_radii2d=rng.integers(0, 40, capacity)
        .astype(np.float32))


def _jax_draws(key, rows, split_n, rot_4d, gaussian_dim):
    """`_split_children`'s normal draws (fourdgs_tpu/models/densify.py:86-
    106) as the port's `noise`: (rows, 4) rot_4d, (rows, 3) + the (rows, 1)
    time draw in 4D without rot_4d, (rows, 3) in 3D."""
    keys = jax.random.split(key, split_n)
    out = []
    for j in range(split_n):
        if rot_4d:
            eps = jax.random.normal(keys[j], (rows, 4), jnp.float32)
        else:
            eps = jax.random.normal(keys[j], (rows, 3), jnp.float32)
            if gaussian_dim == 4:
                eps = jnp.concatenate([eps, jax.random.normal(
                    jax.random.fold_in(keys[j], 1), (rows, 1),
                    jnp.float32)], axis=1)
        out.append(torch.as_tensor(np.array(eps)))
    return out


@pytest.mark.parametrize("use_size", [False, True])
@pytest.mark.parametrize("gaussian_dim", [4, 3])
@pytest.mark.parametrize("rot_4d", [True, False])
def test_densify_and_prune_matches_jax(rng, rot_4d, gaussian_dim, use_size):
    state = _state(rng)
    cfg = port_densify.DensifyConfig()
    key = jax.random.PRNGKey(11)
    rows = state.params.xyz.shape[0]
    jnew, jinfo = jax_densify.densify_and_prune(
        jax.tree.map(jnp.asarray, state), key, jnp.float32(EXTENT),
        cfg=jax_densify.DensifyConfig(), rot_4d=rot_4d,
        gaussian_dim=gaussian_dim, use_size_threshold=use_size)
    new, info = port_densify.densify_and_prune(
        port_gaussians.from_jax_state(state, device="cpu"),
        _jax_draws(key, rows, cfg.split_n, rot_4d, gaussian_dim), EXTENT,
        cfg=cfg, rot_4d=rot_4d, gaussian_dim=gaussian_dim,
        use_size_threshold=use_size)

    n = info.n_active
    assert int(jinfo.n_needed) == int(jinfo.n_active) == n
    assert (info.n_cloned, info.n_split, info.n_pruned) == (
        int(jinfo.n_cloned), int(jinfo.n_split), int(jinfo.n_pruned))
    assert info.n_cloned > 0 and info.n_split > 0 and info.n_pruned > 0
    assert int(new.n_active) == n and new.params.xyz.shape[0] == n
    assert int(new.adam.count) == 7
    n_fresh = info.n_cloned + 2 * info.n_split
    n_old = n - n_fresh
    n_kept = n_old + info.n_cloned            # old rows, then clones
    for f in FIELDS:
        got = getattr(new.params, f).numpy()
        want = np.asarray(getattr(jnew.params, f))[:n]
        np.testing.assert_array_equal(got[:n_kept], want[:n_kept],
                                      err_msg=f)
        np.testing.assert_allclose(got[n_kept:], want[n_kept:], rtol=1e-6,
                                   atol=1e-7, err_msg=f)
        for moments, jmoments in ((new.adam.mu, jnew.adam.mu),
                                  (new.adam.nu, jnew.adam.nu)):
            m = getattr(moments, f).numpy()
            np.testing.assert_array_equal(
                m, np.asarray(getattr(jmoments, f))[:n], err_msg=f)
            assert not m[n_old:].any(), f
    for f in STATS:
        assert not getattr(new, f).numpy().any(), f
        assert not np.asarray(getattr(jnew, f)).any(), f


@pytest.mark.parametrize("use_size", [True, False])
def test_prune_only_matches_jax(rng, use_size):
    state = _state(rng)
    jnew, jn = jax_densify.prune_only(
        jax.tree.map(jnp.asarray, state), jnp.float32(EXTENT),
        cfg=jax_densify.DensifyConfig(), use_size_threshold=use_size)
    new, n = port_densify.prune_only(
        port_gaussians.from_jax_state(state, device="cpu"), EXTENT,
        cfg=port_densify.DensifyConfig(), use_size_threshold=use_size)
    assert n == int(jn) == int(new.n_active) == new.params.xyz.shape[0]
    assert 0 < n < int(state.n_active)
    for f in FIELDS:
        for got, want in ((new.params, jnew.params), (new.adam.mu,
                                                      jnew.adam.mu),
                          (new.adam.nu, jnew.adam.nu)):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f))[:n],
                                          err_msg=f)
    for f in STATS:             # compacted with the rows, not zeroed
        got = getattr(new, f).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(jnew, f))[:n],
                                      err_msg=f)
        assert got.any(), f


def test_reset_opacity_matches_jax(rng):
    state = _state(rng)
    jnew = jax_densify.reset_opacity(jax.tree.map(jnp.asarray, state))
    new = port_densify.reset_opacity(
        port_gaussians.from_jax_state(state, device="cpu"))
    op = new.params.opacity.numpy()
    np.testing.assert_array_equal(op, np.asarray(jnew.params.opacity))
    assert (op < state.params.opacity).any() and (op <= -4.59).all()
    for f in FIELDS:
        for got, want in ((new.params, jnew.params), (new.adam.mu,
                                                      jnew.adam.mu),
                          (new.adam.nu, jnew.adam.nu)):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
    assert not new.adam.mu.opacity.numpy().any()
    assert new.adam.mu.xyz.numpy().any()


def _points_with_duplicates(rng, n):
    pts = rng.normal(0, 1, (n, 3)).astype(np.float32)
    pts[10:14] = pts[3]            # five copies of one point
    pts[40] = pts[41]
    return pts


def _brute_force_3nn(pts):
    """Every pair's dx² + dy² + dz² in f32, self excluded, the mean of the
    three smallest as (d0 + d1 + d2) / 3."""
    d = pts[:, None, :] - pts[None, :, :]
    d2 = d[..., 0] ** 2 + d[..., 1] ** 2 + d[..., 2] ** 2
    np.fill_diagonal(d2, np.inf)
    near = np.sort(d2, axis=1)[:, :3]
    return (near[:, 0] + near[:, 1] + near[:, 2]) / np.float32(3.0)


@pytest.mark.parametrize("chunk_pairs", [port_knn.NN3_PAIRS, 2000])
def test_mean_dist2_to_3nn_is_brute_force(rng, monkeypatch, chunk_pairs):
    pts = _points_with_duplicates(rng, 300)
    monkeypatch.setattr(port_knn, "NN3_PAIRS", chunk_pairs)
    got = port_knn.mean_dist2_to_3nn(torch.as_tensor(pts)).numpy()
    want = _brute_force_3nn(pts)
    np.testing.assert_array_equal(got, want)
    assert got[10] == 0.0 and got[40] > 0.0
    np.testing.assert_array_equal(
        port_knn.mean_dist2_to_3nn(torch.as_tensor(pts[:4])).numpy(),
        np.full(4, 1e-4, np.float32))


@pytest.mark.parametrize("with_times", [False, True])
def test_init_from_pcd_matches_jax(rng, with_times):
    n = 300
    pts = _points_with_duplicates(rng, n)
    colors = rng.random((n, 3)).astype(np.float32)
    times = rng.random((n, 1)).astype(np.float32) if with_times else None
    dist2 = _brute_force_3nn(pts)
    kw = dict(sh_channels=48, time_duration=(-0.5, 1.5), times=times,
              seed=5)
    jstate = jax_gaussians.init_from_pcd(pts, colors, capacity=n,
                                         mean_knn_dist2=dist2, **kw)
    state = port_gaussians.init_from_pcd(pts, colors, mean_knn_dist2=dist2,
                                         device="cpu", **kw)
    # The port's own 3-NN gives the same cloud.
    own = port_gaussians.init_from_pcd(pts, colors, device="cpu", **kw)
    assert int(state.n_active) == int(jstate.n_active) == n
    for f in FIELDS:
        want = np.asarray(getattr(jstate.params, f))
        for s in (state, own):
            got = getattr(s.params, f)
            assert got.dtype == torch.float32 and got.shape == want.shape, f
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
        assert not state.adam.mu[FIELDS.index(f)].numpy().any()
    assert int(state.adam.count) == 0
    for f in STATS:
        assert not getattr(state, f).numpy().any()
