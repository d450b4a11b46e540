"""The process mesh of the sharded map (JAX counterpart: parallel/mesh.py).

The JAX package row-shards the Gaussian map over a 1-D ``"gauss"`` device
mesh inside one program. The port runs one process per rank under
`torch.distributed` (multi-controller): every rank runs the whole frame loop
on the same frames, holds its own rows of the map and their Adam moments,
and the collectives below carry what crosses ranks.

    torchrun --standalone --nproc_per_node W -m mm3dgs_slam_torch --config <yml>

with ``tpu.mesh_devices: W`` in the config. The backend follows the layout,
never a failure: gloo on the CPU or when ranks share a card (NCCL refuses
two ranks on one card), NCCL when each rank has a card of its own; a rank's
device is ``cuda:(LOCAL_RANK % device_count)``.

Every collective is a `dist.all_reduce` (a sum): a gather is the all-reduce
of a zero-padded buffer that each rank fills at its own offset, which is
exact (x + 0 = x) and needs nothing that gloo lacks for CUDA tensors.
Sums whose result every rank keeps (the pose gradient, row counts) are
gathered that way and added in rank order, so all ranks get the same bits.

One process is the mesh of size 1 (`SINGLE`, or `make_mesh(1)`): every
collective is the identity and the window is the whole grid, so the SLAM
runs one code path whatever ``mesh_devices`` is, and at 1 it makes the
single-process launches and arithmetic.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from ..ops.camera import Camera

GAUSS_AXIS = "gauss"   # the JAX mesh's axis name; the port's ranks are that axis


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of `size` ranks; this process is rank `rank` on `device`."""

    size: int
    rank: int
    device: torch.device | None   # None: the caller's (size 1 only)
    backend: str | None           # None: no process group (size 1)
    group: object = None   # the process group (None: the default group)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks in place; returns it."""
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def stack(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's `t` in rank order, on every rank."""
        buf = torch.zeros((self.size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        buf[self.rank] = t
        return self.all_reduce(buf)

    def sum_replicated(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's `t`, added in rank order: the same bits on
        every rank."""
        if self.size == 1:
            return t
        s = self.stack(t)
        out = s[0].clone()
        for r in range(1, self.size):
            out = out + s[r]
        return out

    def row_counts(self, n: int) -> list[int]:
        """Every rank's row count, in rank order."""
        if self.size == 1:
            return [n]
        return [int(c) for c in self.stack(torch.tensor(n, dtype=torch.int64,
                                                        device=self.device)).tolist()]

    def window(self, cam: Camera) -> tuple[int, int]:
        """This rank's tile window: (first global tile, tiles)."""
        n_local = tiles_per_shard(cam, self.size)
        return self.rank * n_local, n_local


SINGLE = Mesh(size=1, rank=0, device=None, backend=None)   # one process


def tiles_per_shard(cam: Camera, n_dev: int) -> int:
    """Tiles in each rank's window, the last one padded past the grid (JAX
    tile_sharded.tiles_per_shard)."""
    return math.ceil(cam.n_tiles / n_dev)


def make_mesh(n: int, device: str | torch.device = "cuda", rank: int | None = None,
              init_method: str | None = None, timeout_s: float = 600.0) -> Mesh:
    """Join (or start) the process group of an n-rank mesh.

    Without `rank`, the rank, world size and local rank come from torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE) and the
    rendezvous from MASTER_ADDR/MASTER_PORT; a world size other than `n`
    raises ValueError, as the JAX package refuses a mesh larger than its
    devices. Tests pass `rank` and an `init_method` (``file://...`` or
    ``tcp://localhost:<port>``) themselves, all ranks on one host. `device`
    "cpu" runs the ranks on the CPU; otherwise each rank takes card
    LOCAL_RANK % device_count and a missing card raises. n = 1 starts no
    process group: the size-1 mesh on `device`."""
    if n == 1:
        return Mesh(size=1, rank=0, device=torch.device(device), backend=None)
    if rank is None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != n:
            raise ValueError(
                f"tpu.mesh_devices={n} but the world size is {world}; launch with "
                f"torchrun --standalone --nproc_per_node {n} -m mm3dgs_slam_torch ...")
        rank = int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        init_method = init_method or "env://"
    else:
        local_rank, local_size = rank, n
        if init_method is None:
            raise ValueError("an explicit rank needs an init_method")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh was requested but torch.cuda.is_available() "
                               "is False; pass device cpu to run the ranks on the CPU")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_size <= n_cards else "gloo"
        why = ("a card per rank" if backend == "nccl"
               else f"{local_size} ranks share {n_cards} card(s)")
    else:
        backend, why = "gloo", "CPU ranks"
    if dist.is_initialized():
        if dist.get_world_size() != n or dist.get_rank() != rank:
            raise ValueError(f"a process group of {dist.get_world_size()} ranks is "
                             f"already running (rank {dist.get_rank()})")
        if dist.get_backend() != backend:
            raise ValueError(f"the running process group's backend is "
                             f"{dist.get_backend()}, this layout needs {backend}")
    else:
        dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
    print(f"[mesh] rank {rank}/{n}: backend {backend} ({why}), device {dev}", flush=True)
    return Mesh(size=n, rank=rank, device=dev, backend=backend)
