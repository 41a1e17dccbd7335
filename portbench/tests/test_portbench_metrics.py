"""The metric arithmetic on synthetic runs and traces, against recounts:
the window's rate, the p95 and its sample count, the idle share and its
attribution, the blend kernels' pair counts, rooflines and the step's
operation count."""

import math

import numpy as np
import pytest
import torch

from harness import registry, runner, trace, training

ALPHA_MIN, T_EPS = 1.0 / 255.0, 1e-4


def run_result(**kw):
    base = dict(setup_s=12.5, window_s=40.2, steps=201,
                memory_window=3 << 30, memory_run=4 << 30, finite=True,
                check=None, step_s=[], stages=[], profile=None,
                kernel_args=[])
    base.update(kw)
    return training.RunResult(**base)


def test_end_to_end_arithmetic():
    e2e = runner.end_to_end(run_result())
    assert e2e["train_step_ms"] == pytest.approx(40.2 / 201 * 1e3)
    assert e2e["peak_mem_gib"] == 3.0
    assert e2e["setup_s"] == 12.5


def ctx(cells, name="lego.train", **kw):
    prof = kw.pop("profile", None)
    return runner.Context(cells[name], run_result(**kw), prof, {})


def test_p95_needs_ten_samples_beyond(cells):
    rng = np.random.default_rng(3)
    steps = list(rng.uniform(0.15, 0.25, 200))
    reader = registry.metric_reader("train.step_ms_p95")
    got = reader.read(ctx(cells, step_s=steps))
    assert got == pytest.approx(np.percentile(np.array(steps) * 1e3, 95))
    assert sum(s * 1e3 > got for s in steps) == 10
    assert reader.read(ctx(cells, step_s=steps[:199])) is None


def test_stage_medians(cells):
    stages = [dict(render=r, knn=k, blend_backward=b)
              for r, k, b in [(30, 120, 40), (32, 125, 41), (90, 130, 45)]]
    c = ctx(cells, stages=stages)
    assert registry.metric_reader("train.render_ms").read(c) == 32
    assert registry.metric_reader("train.knn_ms").read(c) == 125
    assert registry.metric_reader("train.backward_ms").read(c) == 41
    flame = ctx(cells, "flame_salmon.train", stages=stages)
    assert registry.metric_reader("train.knn_ms").read(flame) is None


def test_idle_share_and_attribution(cells):
    busy = trace.merge([(0.0, 0.2), (0.1, 0.3), (0.5, 0.6), (0.9, 1.0)])
    assert busy == [[0.0, 0.3], [0.5, 0.6], [0.9, 1.0]]
    host = [(0.3, 0.45, "aten::mul"), (0.3, 0.5, "Optimizer.step"),
            (0.35, 0.4, "cudaLaunchKernel")]
    idle = trace.idle_by_host(busy, (0.0, 1.0), host)
    assert idle["cudaLaunchKernel"] == pytest.approx(0.2)    # mid 0.4
    assert idle[trace.IDLE_NONE] == pytest.approx(0.3)       # mid 0.75
    prof = trace.Profile(window_s=1.0, busy_s=0.5, steps=4, kernel_s={},
                         idle_s=idle)
    got = registry.metric_reader("train.device_idle_pct").read(
        ctx(cells, profile=prof))
    assert got == pytest.approx(50.0)


def tiny_blend(seed=0, p=24, tiles_x=2, tiles_y=2):
    """Records and tile bins of `p` gaussians, every gaussian in every
    tile, by depth."""
    rng = np.random.default_rng(seed)
    h, w = 16 * tiles_y, 16 * tiles_x
    rec = np.zeros((p, 12), np.float32)
    rec[:, 0] = rng.uniform(0, w, p)
    rec[:, 1] = rng.uniform(0, h, p)
    sx, sy = rng.uniform(2, 9, p), rng.uniform(2, 9, p)
    rho = rng.uniform(-0.5, 0.5, p)
    cov = np.stack([sx * sx, rho * sx * sy, sy * sy], 1)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    rec[:, 2], rec[:, 3], rec[:, 4] = (cov[:, 2] / det, -cov[:, 1] / det,
                                       cov[:, 0] / det)
    rec[:, 5] = rng.uniform(0.05, 0.99, p)
    rec[:, 6:9] = rng.uniform(0, 1, (p, 3))
    order = np.argsort(rng.uniform(1, 5, p))
    n_tiles = tiles_x * tiles_y
    gid = np.tile(order, n_tiles).astype(np.int32)
    start = (np.arange(n_tiles) * p).astype(np.int32)
    count = np.full(n_tiles, p, np.int32)
    return rec, gid, start, count, tiles_x


def naive_walk(rec, gid, start, count, tiles_x):
    """Per tile, pixel by pixel: which (rank, pixel) pairs were seen, had
    alpha >= 1/255 while live, and were used; and n_contrib."""
    out = []
    for t in range(len(start)):
        ty, tx = divmod(t, tiles_x)
        seen = np.zeros((count[t], 256), bool)
        live = np.zeros_like(seen)
        used = np.zeros_like(seen)
        ncon = np.zeros(256, np.int64)
        for pix in range(256):
            px, py = tx * 16 + pix % 16, ty * 16 + pix // 16
            tr, done = 1.0, False
            for r in range(count[t]):
                if done:
                    continue
                seen[r, pix] = True
                g = rec[gid[start[t] + r]]
                dx, dy = np.float32(g[0] - px), np.float32(g[1] - py)
                power = -0.5 * (g[2] * dx * dx + g[4] * dy * dy) \
                    - g[3] * dx * dy
                alpha = min(np.float32(0.99), g[5] * np.exp(power))
                if power > 0 or alpha < ALPHA_MIN:
                    continue
                live[r, pix] = True
                test = tr * (1.0 - alpha)
                if test < T_EPS:
                    done = True
                    continue
                used[r, pix] = True
                tr = test
                ncon[pix] = r + 1
        out.append((seen, live, used, ncon))
    return out


def blocks(mask, w, h):
    """(ranks, blocks) any() of (ranks, 256) over w × h pixel blocks."""
    m = mask.reshape(mask.shape[0], 16 // h, h, 16 // w, w)
    return m.any(axis=(2, 4)).reshape(mask.shape[0], -1)


def test_pair_counts_against_a_pixel_walk():
    from blend_bounds import backward_counts, forward_counts

    rec, gid, start, count, tiles_x = tiny_blend()
    walk = naive_walk(rec, gid, start, count, tiles_x)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    fwd = forward_counts(t(rec), t(gid), t(start), t(count), tiles_x)
    assert fwd["alpha_ok"] == sum(w[1].sum() for w in walk)
    assert fwd["used"] == sum(w[2].sum() for w in walk)
    assert fwd["warp_live"] == sum(blocks(w[0], 8, 8).sum() for w in walk)
    assert fwd["warp_active"] == sum(blocks(w[2], 8, 8).sum() for w in walk)
    assert 0 < fwd["warp_kept"] <= fwd["warp_live"]
    assert fwd["kept_evaluated"] <= sum(w[0].sum() for w in walk)

    ncon = t(np.stack([w[3] for w in walk]).astype(np.int32))
    bwd = backward_counts(t(rec), t(gid), t(start), ncon, tiles_x)
    evaluated = [np.arange(c)[:, None] < w[3][None, :]
                 for c, w in zip(count, walk)]
    assert bwd["used"] == sum(w[2].sum() for w in walk)
    assert bwd["tile_active"] == sum(w[2].any(axis=1).sum() for w in walk)
    assert bwd["warp_live"] == sum(blocks(e, 8, 4).sum() for e in evaluated)
    assert bwd["warp_active"] == sum(blocks(w[2], 8, 4).sum() for w in walk)


def test_rooflines_and_mfu(cells):
    import blend_bounds as bb
    import step_flops as sf

    rec, gid, start, count, tiles_x = tiny_blend(1)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    k1 = (t(rec), t(gid), t(start), t(count), tiles_x)
    acc, t_final, ncon = (torch.zeros((4, 6, 256)), torch.rand((4, 256)),
                          torch.randint(0, 24, (4, 256), dtype=torch.int32))
    k2 = (t(rec), t(gid), t(start), t_final, ncon,
          torch.zeros((4, 7, 256)), tiles_x)
    fb, fops = bb.forward_bound(k1)
    bbnd, bops = bb.backward_bound(k2)
    c1 = bb.forward_counts(*k1)
    assert fops == (c1["warp_live"] * 55 + c1["kept_evaluated"] * 11
                    + c1["alpha_ok"] * 12 + c1["used"] * 13)
    nbytes = 24 * 48 + gid.size * 4 + 4 * 8 + 4 * 256 * 32
    assert fb == max(fops / 67e12, nbytes / 3.35e12)

    prof = trace.Profile(window_s=2.0, busy_s=1.0, steps=4, kernel_s={
        "blend_forward_kernel(float4 const*, int const*)": 4 * 2 * fb * 10,
        "blend_backward_kernel(float4 const*)": 4 * 2 * bbnd * 4,
        "void at::native::elementwise": 1.0}, idle_s={})
    c = ctx(cells, kernel_args=[k1, k2, k1, k2], profile=prof,
            step_s=[0.2, 0.2])
    assert registry.metric_reader("train.k1_roofline").read(c) == \
        pytest.approx(10.0)
    assert registry.metric_reader("train.k2_roofline").read(c) == \
        pytest.approx(25.0)

    p = 24
    ops = (2 * p * 830 * 3 + 2 * fops + 2 * bops
           + 2 * 4 * 256 * 3 * sf.SSIM_FORWARD * 3
           + 2 * p * min(16384, p) * 8 + p * (20 + 3 * 47) * 14)
    assert sf.step_ops(c) == pytest.approx(ops)
    got = registry.metric_reader("train.mfu_pct").read(c)
    assert got == pytest.approx(100 * ops / 0.2 / 67e12)
    assert math.isfinite(got)
