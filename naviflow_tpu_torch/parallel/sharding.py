"""Process bring-up and the rank mesh of the distributed solver (port of
``naviflow_tpu/parallel/sharding.py``).

The JAX package shards over a 2-D ``jax.sharding.Mesh`` of devices inside
one program.  Here each rank is a process (``torchrun --nproc_per_node N``
on one host, or spawned processes in the tests) holding one block of the
staggered fields, and the halo exchanges and reductions of
``parallel/decompose.py`` are ``torch.distributed`` calls: NCCL between
cards, gloo between CPU processes.

:class:`RankMesh` is the counterpart of the JAX ``Mesh``: the mesh shape
``(mx, my)``, this rank's block ``(bx, by)``, the process group and the
device.  Rank ``r`` of the group sits at ``(r // my, r % my)``, the order of
the JAX package's ``reshape(shape)`` of its device list, so block ``(bx,
by)`` here holds what device ``(bx, by)`` holds there.

The JAX module's GSPMD placement helpers (``field_sharding``,
``replicated``, ``best_effort_sharding``, ``shard_state``) place whole
arrays and let XLA's partitioner insert the halo exchanges.  PyTorch has no
such partitioner, so they have no counterpart here: everything they serve
is reached through the explicit decomposition (``parallel/decompose.py``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def initialize_pod(device="cuda", init_method: Optional[str] = None,
                   world_size: Optional[int] = None, rank: Optional[int] = None) -> bool:
    """Multi-process bring-up.  Arguments default to torchrun's environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT`` through ``init_method='env://'``).

    Returns ``False`` in a single process (a no-op) and ``True`` once the
    default process group is up: NCCL when ``device`` is a CUDA device
    (each rank on card ``LOCAL_RANK``), gloo only when the caller asks for
    the CPU.  A CUDA request on a machine without a card raises: NCCL is
    never quietly replaced by gloo.
    """
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size <= 1:
        return False
    if dist.is_initialized():
        return True
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_pod: a CUDA device was asked for and none is "
                               "available; pass device='cpu' for gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize_pod: no backend for device {device}")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def most_square(n: int) -> Tuple[int, int]:
    """The most-square factorization ``(px, n // px)``, ``px <= n // px``."""
    px = int(math.floor(math.sqrt(n)))
    while n % px:
        px -= 1
    return px, n // px


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This rank's place in a 2-D ``(mx, my)`` mesh of ranks.

    ``group`` is the process group (``None``: a one-rank mesh with no
    process group, where every collective is the identity); ``device`` is
    where this rank's blocks live."""

    shape: Tuple[int, int]
    bx: int
    by: int
    device: torch.device
    group: Optional[object] = None

    axis_names = ("x", "y")  # the JAX mesh's axis names

    @property
    def named_shape(self) -> dict:
        """``{'x': mx, 'y': my}``: the JAX package's ``dict(mesh.shape)``."""
        return dict(zip(self.axis_names, self.shape))

    @property
    def rank(self) -> int:
        return self.bx * self.shape[1] + self.by

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def peer(self, axis: int, step: int) -> int:
        """The global rank of the neighbour ``step`` blocks away along mesh
        ``axis`` (0: x, 1: y)."""
        r = self.rank + step * (self.shape[1] if axis == 0 else 1)
        if self.group is None or self.group is dist.group.WORLD:
            return r
        return dist.get_global_rank(self.group, r)


def make_device_mesh(n: Optional[int] = None, shape: Optional[Tuple[int, int]] = None, *,
                     group=None, device=None) -> RankMesh:
    """This rank's :class:`RankMesh` over the ranks of ``group`` (default:
    the default process group when one is up, else a single rank with no
    group).  ``shape`` defaults to the most-square factorization of ``n``
    (the group's size), which keeps the halo surface small.  ``device``
    defaults to this rank's card under NCCL and to the CPU under gloo; a
    single rank with no group defaults to the card."""
    if dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        backend = dist.get_backend(group)
    else:
        group, world, rank, backend = None, 1, 0, None
    n = world if n is None else n
    if n != world:
        raise ValueError(f"make_device_mesh: n={n} but the group has {world} ranks")
    if shape is None:
        shape = most_square(n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != rank count {n}")
    if device is None:
        if backend == "gloo":
            device = torch.device("cpu")
        else:
            device = torch.device("cuda", torch.cuda.current_device()
                                  if torch.cuda.is_available() else 0)
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("make_device_mesh: an NCCL group needs CUDA blocks")
    mesh = RankMesh(shape=tuple(shape), bx=rank // shape[1], by=rank % shape[1],
                    device=device, group=group)
    if group is not None:
        # every rank joins this first collective, so the communicator is up
        # before the first point-to-point batch (NCCL's rule for
        # batch_isend_irecv)
        dist.all_reduce(torch.zeros(1, device=device), group=group)
    return mesh
