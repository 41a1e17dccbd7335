"""The port's k-nearest-neighbour search (the rigid loss's) against the
JAX package's `knn` on the same numpy points: the exact path (n <= 2048)
and the Morton block sweep (n ≈ 4096, small span, 2 rotated passes), with
and without padding rows. Distances at rtol 1e-5 (atol 1e-7 for
distances near 0); neighbour index sets equal on every row whose k-th
and (k+1)-th candidate distances are not tied within that tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import knn as jax_knn
from fourdgs_tpu_torch.ops import knn as port_knn

K = 19


def _cloud(rng, n):
    """Clustered points (trained clouds are clustered): 40 blobs."""
    centres = rng.uniform(-1.0, 1.0, (40, 3))
    pts = centres[rng.integers(0, 40, n)] + rng.normal(0.0, 0.05, (n, 3))
    return pts.astype(np.float32)


def _compare(rng, n, valid, **kw):
    pts = _cloud(rng, n)
    idx, d2 = port_knn.knn(torch.as_tensor(pts), k=K,
                           valid=None if valid is None
                           else torch.as_tensor(valid), **kw)
    jidx, jd2 = jax_knn.knn(jnp.asarray(pts), k=K,
                            valid=None if valid is None
                            else jnp.asarray(valid), **kw)
    idx, d2 = idx.numpy(), d2.numpy()
    jidx, jd2 = np.asarray(jidx), np.asarray(jd2)
    rows = np.arange(n) if valid is None else np.flatnonzero(valid)
    np.testing.assert_allclose(d2[rows], jd2[rows], rtol=1e-5, atol=1e-7)
    # Rows with a clear gap after the k-th neighbour (exact distances)
    # have one right answer for the index set.
    full = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(full, np.inf)
    if valid is not None:
        full[:, ~valid] = np.inf
    kth = np.sort(full, axis=1)[:, K - 1:K + 1]
    clear = rows[(kth[rows, 1] - kth[rows, 0]) > 1e-5 * kth[rows, 1]]
    assert len(clear) > 0.9 * len(rows)
    same = [set(idx[r]) == set(jidx[r]) for r in clear]
    assert all(same), f"{len(same) - sum(same)} rows differ"
    if valid is not None:
        assert valid[idx[rows]].all()
    return idx, d2


@pytest.mark.parametrize("with_padding", [False, True])
def test_exact_path_matches_jax(rng, with_padding):
    n = 700
    valid = None
    if with_padding:
        valid = np.ones(n, bool)
        valid[rng.choice(n, 60, replace=False)] = False
    _compare(rng, n, valid)


@pytest.mark.parametrize("with_padding", [False, True])
def test_sweep_path_matches_jax(rng, with_padding):
    n = 4100
    valid = None
    if with_padding:
        valid = np.ones(n, bool)
        valid[-100:] = False
    _compare(rng, n, valid, span=512, row_block=256, passes=2)


def test_morton_codes_match_jax(rng):
    pts = _cloud(rng, 3000)
    np.testing.assert_array_equal(
        port_knn.morton_codes(torch.as_tensor(pts)).numpy(),
        np.asarray(jax_knn.morton_codes(jnp.asarray(pts))).astype(np.int64))
