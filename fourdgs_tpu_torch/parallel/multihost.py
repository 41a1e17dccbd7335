"""Multi-process helpers: the process group and the per-process batch.

PyTorch counterpart of `fourdgs_tpu/parallel/multihost.py`. Each process
drives one device and feeds its own share of the global camera batch;
`parallel.mesh`'s step sums the gradients over the group (NCCL over
NVLink or the network between CUDA devices, gloo between CPU processes).
torch has no global array: a process keeps its local tensors on its own
device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> None:
    """Open the default process group (nothing when one is open): at
    tcp://`coordinator_address` ("host:port") with `num_processes` and this
    `process_id`, or from the environment that torchrun sets (env://) when
    no address is given. The backend is NCCL for CUDA devices and gloo for
    the CPU."""
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator_address is not None:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")


def global_mesh() -> Mesh:
    """The data axis over every rank of the world."""
    return make_mesh()


def process_batch_indices(global_indices: Sequence[int]) -> list:
    """This process's slice of a global camera-index batch (all of it
    without a process group). Every process must pass the SAME global
    list (use a seed-synchronised sampler)."""
    n_proc, pid = ((dist.get_world_size(), dist.get_rank())
                   if dist.is_initialized() else (1, 0))
    per = len(global_indices) // n_proc
    return list(global_indices[pid * per: (pid + 1) * per])


def shard_host_local_batch(mesh: Mesh, local_arrays):
    """The process's local batch arrays (a dict, a NamedTuple or a
    sequence) as tensors on the mesh's device. torch has no global array
    to assemble them into: each rank keeps its own share."""
    def put(a):
        return torch.as_tensor(a).to(mesh.device)
    if isinstance(local_arrays, dict):
        return {k: put(v) for k, v in local_arrays.items()}
    if hasattr(local_arrays, "_fields"):             # a NamedTuple
        return type(local_arrays)(*(put(v) for v in local_arrays))
    return [put(v) for v in local_arrays]
