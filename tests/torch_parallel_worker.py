"""One rank of the port's 2-process gloo tests (no test_ prefix: launched
by tests/test_torch_parallel.py as a subprocess per rank, like
tests/multihost_worker.py). Imports the port, torch and numpy only.

    python tests/torch_parallel_worker.py RANK WORLD PORT OUT_JSON

Every rank makes the same inputs from numpy seed 0 and runs, on the CPU:
the data-parallel step (`parallel/mesh.py`) against the single-process
`train_step` on the same inputs, for batch 2 (one camera per rank), batch
1 as 2 strips (the camera's strips on different ranks: the strip colours
all-gathered with their gradients) and batch 2 as 2 strips of 24 rows
with the env map and the opacity-mask loss; an Evaluator's strip view
spread over the ranks against the one rendered alone; a batch that does
not divide, for the step and for the Trainer; and the multihost helpers. Rank 0 writes the largest
differences as JSON for the parent to hold to its bounds."""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fourdgs_tpu_torch.data.cameras import Camera  # noqa: E402
from fourdgs_tpu_torch.engine import step as port_step  # noqa: E402
from fourdgs_tpu_torch.engine.evaluator import camera_intrinsics  # noqa: E402
from fourdgs_tpu_torch.models import envmap, gaussians  # noqa: E402
from fourdgs_tpu_torch.ops.preprocess import RenderOptions  # noqa: E402
from fourdgs_tpu_torch.parallel import (make_mesh,  # noqa: E402
                                        make_sharded_train_step, multihost)

CASES = {
    # name: (batch, strips, height, env map, opacity-mask loss)
    "batch2": (2, 1, 48, False, False),
    "strips2_straddle": (1, 2, 48, False, False),
    "strips2_env_opa": (2, 2, 48, True, True),
}
STATS = ("xyz_grad_accum", "t_grad_accum", "denom", "max_radii2d")


def inputs(case):
    """The same cloud, cameras, targets and env map on every rank."""
    b, n, h, env_on, opa = CASES[case]
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (150, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    state = gaussians.init_from_pcd(
        pts, rng.random((150, 3)).astype(np.float32), sh_channels=48,
        device="cpu")
    opts = RenderOptions(height=h, width=32)
    cams = [Camera(uid=i, rot=np.eye(3), trans=np.zeros(3), fovx=1.0,
                   fovy=1.2, width=32, height=h, timestamp=0.3 + 0.4 * i)
            for i in range(b)]
    gt = torch.as_tensor(rng.random((b, h, 32, 3)).astype(np.float32))
    mask = torch.as_tensor((rng.random((b, h, 32)) > 0.3).astype(np.float32))
    cfg = port_step.StepConfig(sh_degree=3, sh_degree_t=2, lambda_rigid=1.0,
                               lambda_opa_mask=0.1 if opa else 0.0,
                               env_map_res=8 if env_on else 0)
    env = None
    if env_on:
        env = envmap.init_envmap(8, device="cpu")._replace(
            texture=torch.as_tensor(rng.random((8, 8, 3)).astype(np.float32)))
    intr = torch.as_tensor(np.stack([camera_intrinsics(c) for c in cams]))
    return (state, [c.arrays("cpu") for c in cams], gt, mask, cfg, opts,
            env, intr, b, n)


def max_rel(a, b):
    """max |a - b| / max(|b|.max(), 1e-12)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-12))


def compare_step(case, mesh):
    state, cams, gt, mask, cfg, opts, env, intr, b, n = inputs(case)
    bg = torch.zeros(3)
    want, want_env, wm = port_step.train_step(
        state, 10, cams, gt, mask, bg, cfg, opts, env=env, intrinsics=intr,
        strips=n)
    step_fn = make_sharded_train_step(opts, cfg, mesh, batch_size=b,
                                      strips=n)
    got, got_env, gm = step_fn(state, 10, cams, gt, mask, bg, env=env,
                               intrinsics=intr)
    out = {f"metric_{f}": max_rel(torch.as_tensor(float(getattr(gm, f))),
                                  torch.as_tensor(float(getattr(wm, f))))
           for f in ("loss", "l1", "ssim_loss", "psnr", "rigid")}
    out["counts_equal"] = (gm.num_rendered == wm.num_rendered
                           and int(gm.max_per_tile) == int(wm.max_per_tile)
                           and gm.instances_dropped == 0)
    # The gradients, read from Adam's first moments (0.1·g after a step
    # from zero moments), and the statistics.
    out["grad"] = max(max_rel(x, y) for x, y in zip(got.adam.mu,
                                                    want.adam.mu))
    out["params"] = max(max_rel(x, y) for x, y in zip(got.params,
                                                      want.params))
    out["stats"] = max(max_rel(getattr(got, f), getattr(want, f))
                       for f in STATS)
    if env is not None:
        out["env_grad"] = max_rel(got_env.mu, want_env.mu)
    # Every rank holds the same new state.
    flat = torch.cat([x.reshape(-1) for x in got.params]
                     + [getattr(got, f) for f in STATS])
    parts = [torch.empty_like(flat) for _ in range(mesh.size)]
    torch.distributed.all_gather(parts, flat)
    out["ranks_equal"] = all(torch.equal(parts[0], x) for x in parts)
    return out


FIXTURE = os.path.join(ROOT, "tests", "fixtures", "synth_gate")


def fixture_config(**overrides):
    from fourdgs_tpu_torch.config import load_config

    return load_config(None, overrides=dict(
        gaussian_dim=4, rot_4d=True, time_duration=[0.0, 1.0], num_pts=300,
        model=dict(source_path=FIXTURE, resolution=2, eval=True),
        **overrides))


def eval_strips(mesh, alone_mesh):
    """An Evaluator's 2-strip view spread over the ranks against the same
    view's strips rendered by one rank alone (a mesh of one rank), against
    its full frame, and against the view with no mesh (the full frame)."""
    from fourdgs_tpu_torch.engine.evaluator import Evaluator

    ev = Evaluator(fixture_config(strips=2), device="cpu", verbose=False)
    pcd = ev.scene.point_cloud
    ev.gauss = gaussians.init_from_pcd(
        pcd.points, pcd.colors, sh_channels=48, time_duration=(0.0, 1.0),
        times=pcd.times, device="cpu")
    ev.n_active = int(ev.gauss.n_active)
    cam = ev.scene.test_cameras[0]
    no_mesh = ev.render_view(cam)
    ev.mesh = alone_mesh
    alone = ev.render_view(cam)
    counts = dict(ev.last_counts)
    ev.mesh = mesh
    spread = ev.render_view(cam)
    counts_equal = ev.last_counts == counts
    ev.cfg.strips, ev.mesh = 1, None
    full = ev.render_view(cam)

    def diff(xs, ys):
        return max(float((a - b).abs().max()) for a, b in zip(xs, ys))

    return dict(spread_vs_alone=diff(spread, alone),
                spread_vs_full=diff(spread, full),
                no_mesh_vs_full=diff(no_mesh, full),
                counts_equal=counts_equal)


def trainer_refusals():
    """A Trainer on two ranks that cannot train data-parallel: the error
    of each such config."""
    from fourdgs_tpu_torch.engine.trainer import Trainer

    out = {}
    for name, overrides in (("data_axis_1", dict(data_axis=1,
                                                 batch_size=2)),
                            ("batch_1", dict(batch_size=1))):
        try:
            Trainer(fixture_config(**overrides), device="cpu",
                    verbose=False).close()
            out[name] = "no error"
        except ValueError as e:
            out[name] = f"ValueError: {e}"
    return out


def main():
    rank, world, port, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=world, process_id=rank, device="cpu")
    mesh = multihost.global_mesh()
    assert (mesh.rank, mesh.size) == (rank, world)
    result = {case: compare_step(case, mesh) for case in CASES}
    # Every rank makes every group, in the same order.
    alone = [torch.distributed.new_group([r]) for r in range(world)]
    result["eval_strips"] = eval_strips(
        mesh, make_mesh(group=alone[rank]))
    result["trainer_refuses"] = trainer_refusals()
    try:
        make_sharded_train_step(RenderOptions(height=48, width=32),
                                port_step.StepConfig(), mesh, batch_size=3)
        result["bad_batch"] = "no error"
    except ValueError as e:
        result["bad_batch"] = f"ValueError: {e}"
    result["batch_indices"] = {
        "12": multihost.process_batch_indices(list(range(12))),
        "5": multihost.process_batch_indices([5, 2, 9, 7, 1])}
    local = multihost.shard_host_local_batch(
        mesh, {"gt": np.full((2, 3), rank, np.float32)})
    result["local_batch"] = local["gt"].tolist()
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(result, f)
    print(f"RANK{rank} OK", flush=True)


if __name__ == "__main__":
    main()
