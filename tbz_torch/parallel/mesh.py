"""Device mesh, the port of tbz/parallel/mesh.py.

A mesh is a (dp, sp) array of torch devices with the axis names
("dp", "sp"): data parallelism over independent streams on 'dp',
sequence parallelism over the bytes of one stream on 'sp'. Beside each
entry it records the rank of the process that owns it, and the
torch.distributed group its collectives run over (None for a mesh of one
process's devices, which needs no collective).

`dp_spec`, `NamedSharding` and `P` of tbz are JAX's sharding vocabulary.
The port cuts rows and byte ranges over the mesh itself
(parallel/shard.py), so it needs no counterpart for them.
"""

from __future__ import annotations

import numpy as np
import torch

AXES = ("dp", "sp")


def as_device(d) -> torch.device:
    """`d` as a torch.device; a bare "cuda" names the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def cuda_devices() -> list:
    """Every local CUDA card; raises RuntimeError without one (a mesh
    never falls back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh needs a CUDA device; pass "
                           "devices=['cpu', ...] for a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def process_rank() -> int:
    """This process's rank in the default torch.distributed group (0
    when no group was initialized)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


class Mesh:
    """devices: (dp, sp) object array of torch.device; ranks: (dp, sp)
    int array of the owning processes; group: the process group of a
    mesh built over torch.distributed (distributed.global_mesh), else
    None. `.shape` maps axis names to sizes and `.devices` is the array,
    as on jax.sharding.Mesh. An entry may repeat a device: a mesh of
    ["cuda:0"] * 4 runs four shards on one card."""

    axis_names = AXES

    def __init__(self, devices, ranks=None, group=None):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2:
            raise ValueError("mesh devices must be a (dp, sp) array")
        self.ranks = (np.full(self.devices.shape, process_rank())
                      if ranks is None else np.asarray(ranks, np.int64))
        if self.ranks.shape != self.devices.shape:
            raise ValueError("one owning rank per mesh entry")
        self.group = group

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def is_local(self) -> bool:
        """Whether this process owns every entry."""
        return bool((self.ranks == process_rank()).all())

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={self.devices.tolist()}, "
                f"ranks={self.ranks.tolist()})")


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              sp: int | None = None, *, devices=None) -> Mesh:
    """Mesh with ('dp', 'sp') axes over `devices` (default: every local
    CUDA card; raises RuntimeError without one). Defaults for dp and sp
    come from Config (mesh_dp / mesh_sp, settable via TBZ_TORCH_MESH_DP /
    TBZ_TORCH_MESH_SP); with no config either, all devices go on 'dp'.
    A CPU mesh is asked for by name: devices=["cpu"] * 8 stands in for
    tbz's 8 virtual CPU devices."""
    from ..utils.config import get_config
    cfg = get_config()
    if sp is None:
        sp = cfg.mesh_sp or 1
    devs = [as_device(d) for d in (cuda_devices() if devices is None
                                   else devices)]
    n = n_devices or len(devs)
    if not 0 < n <= len(devs):
        raise ValueError(f"n_devices={n} of {len(devs)} devices")
    if dp is None:
        dp = cfg.mesh_dp if cfg.mesh_dp and cfg.mesh_dp * sp <= n else n // sp
    if dp < 1 or sp < 1 or dp * sp > n:
        raise ValueError(f"a ({dp}, {sp}) mesh needs dp * sp <= {n}")
    return Mesh(grid(devs[:dp * sp], dp, sp))


def grid(devices, dp: int, sp: int) -> np.ndarray:
    """The (dp, sp) object array of a row-major device list."""
    arr = np.empty((dp, sp), dtype=object)
    for i, d in enumerate(devices):
        arr[i // sp, i % sp] = d
    return arr


__all__ = ["AXES", "Mesh", "as_device", "cuda_devices", "grid",
           "make_mesh", "process_rank"]
