"""Several processes, the port of tbz/parallel/distributed.py:
torch.distributed process groups (NCCL for CUDA, gloo for the CPU) and a
global mesh whose 'dp' axis spans processes. The sequence-sharded
checksums of parallel/shard.py all-gather their partials over the mesh's
group; the mesh-wide resolve batch runs each process's rows on its own
devices.

Nothing on a machine tells a process of its cluster: the caller gives
the coordinator's address, the number of processes and this process's
rank.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from .mesh import Mesh, as_device, cuda_devices, grid

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# how long a process waits for the others to join and in a collective
TIMEOUT = datetime.timedelta(seconds=60)


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device_type: str = "cuda",
               force: bool = False) -> None:
    """Join a torch.distributed process group at `coordinator`
    ("host:port") as rank `process_id` of `num_processes`, waiting at
    most TIMEOUT for the others: NCCL for device_type "cuda" (this
    process then drives card process_id % device_count), gloo for "cpu".
    A no-op for one process unless `force` (a group of one, whose
    collectives still run on the card)."""
    if (num_processes is None or num_processes <= 1) and not force:
        return
    import torch.distributed as dist
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {sorted(BACKENDS)}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("an NCCL group needs a CUDA device")
        torch.cuda.set_device((process_id or 0) % torch.cuda.device_count())
    if coordinator is None:
        raise ValueError("a process group needs the coordinator's address")
    addr = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(BACKENDS[device_type], init_method=addr,
                            world_size=num_processes or 1,
                            rank=process_id or 0,
                            timeout=TIMEOUT)


def global_mesh(dp: int | None = None, sp: int = 1,
                local_devices=None) -> Mesh:
    """Mesh over ALL processes' devices, in rank order: dp spans
    processes, then each process's devices. `local_devices` are this
    process's entries (default: its current card under NCCL, the CPU
    under gloo). The lists are gathered once, here, with
    all_gather_object. Without a process group: a mesh of the local
    devices (default every CUDA card)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        local = cuda_devices() if local_devices is None else local_devices
        devs = [as_device(d) for d in local]
        return _reshape(devs, [0] * len(devs), dp, sp, None)
    if local_devices is None:
        local_devices = ([torch.device("cuda", torch.cuda.current_device())]
                         if dist.get_backend() == "nccl"
                         else [torch.device("cpu")])
    mine = [str(as_device(d)) for d in local_devices]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    devices = [torch.device(d) for ds in every for d in ds]
    ranks = [r for r, ds in enumerate(every) for _ in ds]
    return _reshape(devices, ranks, dp, sp, dist.group.WORLD)


def _reshape(devices, ranks, dp, sp, group) -> Mesh:
    n = len(devices)
    if dp is None:
        dp = n // sp
    if dp < 1 or dp * sp != n:
        raise ValueError(f"a ({dp}, {sp}) mesh needs {dp * sp} devices, "
                         f"got {n}")
    return Mesh(grid(devices, dp, sp),
                np.asarray(ranks, np.int64).reshape(dp, sp), group)


def assign_members(sizes: list[int], n_shards: int) -> list[list[int]]:
    """Greedy balanced assignment of streams to shards by compressed
    size (longest-processing-time heuristic): keeps per-host decode
    time even."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    loads = [0] * n_shards
    out: list[list[int]] = [[] for _ in range(n_shards)]
    for i in order:
        k = loads.index(min(loads))
        out[k].append(i)
        loads[k] += sizes[i]
    return out
