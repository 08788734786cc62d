"""Meshes for the row-sharded index (``core/sharded.py``).

A :class:`Mesh` names its axes and their sizes, as a JAX mesh does, and says
which of its shards this process holds.  Shards are not devices here: one
process may hold several shards of an axis on one device, one after another
in its rows, and run them one after another.

* Without an initialised ``torch.distributed`` process group, one process
  holds every shard: the reference's global view.
* With ``P`` processes, the axes take processes outermost first, each
  ``gcd(P left, size)``; a process then holds ``size / procs`` consecutive
  shards along each axis.  Ranks lie row-major over the process grid, as
  devices do over a JAX mesh.
* An axis that no function shards over (``model``) is replicated: it adds
  no shards, and within one process it is computed once.
* Every axis gets the ``torch.distributed`` group of the processes that
  differ only along it (a group of one where the axis spans one process),
  so the collectives make the same calls on one process as on several.
  ``dist.new_group`` is collective: every rank builds its meshes in the
  same order.  NCCL serves CUDA tensors; on a gloo group the collectives
  move CUDA tensors through the host, which is how gloo works.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.util import resolve_device

# How long a collective of a mesh's groups waits for its peers.
GROUP_TIMEOUT = datetime.timedelta(seconds=120)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    shape: tuple[int, ...]       # shards along each axis
    axes: tuple[str, ...]
    device: torch.device
    procs: tuple[int, ...]       # processes along each axis
    coords: tuple[int, ...]      # this process's place in the process grid
    groups: dict                 # axis -> process group (empty without a process group)

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]

    def local(self, axis: str) -> int:
        """Shards of ``axis`` this process holds."""
        a = self.axes.index(axis)
        return self.shape[a] // self.procs[a]

    def start(self, axis: str) -> int:
        """Index along ``axis`` of this process's first shard."""
        return self.coords[self.axes.index(axis)] * self.local(axis)

    def peer(self, axis: str, step: int) -> int:
        """Global rank of the process ``step`` places on along ``axis``."""
        a = self.axes.index(axis)
        c = list(self.coords)
        c[a] = (c[a] + step) % self.procs[a]
        return int(np.ravel_multi_index(c, self.procs))

    def local_shards(self, axes) -> list[int]:
        """This process's shards over ``axes``, as flat row-major shard
        numbers in ascending order (the order of its rows)."""
        axes = tuple(axes)
        ranges = [range(self.start(a), self.start(a) + self.local(a)) for a in axes]
        dims = [self.size(a) for a in axes]
        return [int(np.ravel_multi_index(c, dims)) for c in itertools.product(*ranges)]


def is_rank0() -> bool:
    """Whether this process is rank 0 of the process group, or the only
    process (no group): the one that prints and writes files."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _process_grid(shape: tuple[int, ...], world: int) -> tuple[int, ...]:
    procs, left = [], world
    for s in shape:
        p = math.gcd(left, s)
        procs.append(p)
        left //= p
    if left != 1:
        raise ValueError(f"{world} processes do not tile the mesh {shape}")
    return tuple(procs)


def make_mesh(shape, axes, *, device=None) -> Mesh:
    """A mesh of ``shape`` shards over ``axes`` on ``device`` (``None`` =
    the card).  Collective over the process group when there is one."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    dev = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(shape, axes, dev, (1,) * len(shape), (0,) * len(shape), {})
    procs = _process_grid(shape, dist.get_world_size())
    coords = tuple(int(c) for c in np.unravel_index(dist.get_rank(), procs))
    groups = {}
    for a, axis in enumerate(axes):
        others = [range(p) for b, p in enumerate(procs) if b != a]
        for rest in itertools.product(*others):
            ranks = []
            for j in range(procs[a]):
                c = list(rest)
                c.insert(a, j)
                ranks.append(int(np.ravel_multi_index(c, procs)))
            g = dist.new_group(ranks, timeout=GROUP_TIMEOUT)
            if dist.get_rank() in ranks:
                groups[axis] = g
    return Mesh(shape, axes, dev, procs, coords, groups)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16×16 single pod or 2×16×16 two-pod, the reference's layouts."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(model_parallel: int = 1, *, device=None) -> Mesh:
    """Whatever this host offers, ``(n/mp, mp)`` over ``("data", "model")``:
    ``n`` is the number of processes (one without a process group), each
    holding one shard."""
    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    mp = model_parallel
    while n % mp:
        mp -= 1
    return make_mesh((n // mp, mp), ("data", "model"), device=device)
