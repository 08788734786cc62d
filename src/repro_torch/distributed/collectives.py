"""Ring collectives over a mesh axis, for processes that hold several shards.

The port's counterpart of the reference's ``distributed/collectives.py``
(``ppermute`` rings under ``shard_map``).  A per-shard array is a tensor
whose leading dimension runs over this process's consecutive shards of the
axis (:meth:`Mesh.local` of them).  Everything is built on one ring hop
(:func:`ring_hop`): shard ``i`` passes its block to shard ``i + 1``, which
is a local roll of the process's own blocks plus one
``dist.batch_isend_irecv`` of the boundary block to the next process.  After
``t`` hops shard ``me`` holds the block of shard ``(me − t) mod size``, as
in the reference.

:func:`all_gather` is the one-shot gather of the search merge.  On a gloo
group CUDA tensors go through the host; NCCL takes them as they are.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh

_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through the host on ``group`` (CUDA on gloo)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every process's ``t`` along ``axis``, stacked on a new leading
    dimension in the axis's order: ``(procs along axis, *t.shape)``.
    Without a process group that is ``t[None]``."""
    group = mesh.groups.get(axis)
    if group is None:
        return t[None]
    stage = _staged(t, group)
    src = (t.cpu() if stage else t).contiguous()[None]
    out = src.new_empty((dist.get_world_size(group),) + tuple(t.shape))
    _all_gather_single(out, src, group=group)
    return out.to(t.device) if stage else out


def all_reduce_max(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the processes along ``axis``."""
    group = mesh.groups.get(axis)
    if group is None:
        return t
    stage = _staged(t, group)
    out = t.cpu() if stage else t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out.to(t.device) if stage else out


def ring_hop(blocks: tuple[torch.Tensor, ...], mesh: Mesh, axis: str) -> tuple[torch.Tensor, ...]:
    """One hop around the ring of ``axis``: each tensor's per-shard block
    ``i`` moves to shard ``i + 1`` (mod the axis size)."""
    if mesh.procs[mesh.axes.index(axis)] == 1:
        return tuple(torch.roll(b, 1, dims=0) for b in blocks)
    group = mesh.groups[axis]
    nxt, prv = mesh.peer(axis, 1), mesh.peer(axis, -1)
    stage = [_staged(b, group) for b in blocks]
    sends = [(b[-1].cpu() if s else b[-1]).contiguous() for b, s in zip(blocks, stage)]
    recvs = [torch.empty_like(x) for x in sends]
    ops = [dist.P2POp(dist.isend, x, nxt, group=group) for x in sends]
    ops += [dist.P2POp(dist.irecv, x, prv, group=group) for x in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(torch.cat([r.to(b.device)[None], b[:-1]]) for b, r in zip(blocks, recvs))


def _me(mesh: Mesh, axis: str) -> list[int]:
    """Ring positions of this process's shards of ``axis``."""
    return [mesh.start(axis) + i for i in range(mesh.local(axis))]


def ring_all_gather(x: torch.Tensor, mesh: Mesh, axis: str):
    """All-gather along ``axis`` as ``size − 1`` ring hops.

    ``x`` is ``(local, *blk)``.  Returns ``(size, blocks)`` with ``blocks``
    ``(local, size, *blk)`` in ring order from each shard's own block:
    ``blocks[i, t]`` is the block of shard ``(me_i − t) mod size``."""
    size = mesh.size(axis)
    out, blk = [], x
    for t in range(size):
        out.append(blk)
        if t + 1 < size:
            (blk,) = ring_hop((blk,), mesh, axis)
    return size, torch.stack(out, dim=1)


def ring_reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Reduce-scatter (sum) along the ring: ``x`` is ``(local, size,
    *chunk)``; shard ``r`` ends with the sum over shards of chunk ``r``,
    added in the reference's order (chunk ``c`` starts at shard ``c + 1``
    and completes at shard ``c`` after ``size − 1`` hops)."""
    size = mesh.size(axis)
    me = _me(mesh, axis)
    acc = torch.stack([x[i, (m - 1) % size] for i, m in enumerate(me)])
    for k in range(size - 1):
        (acc,) = ring_hop((acc,), mesh, axis)
        acc = acc + torch.stack([x[i, (m - k - 2) % size] for i, m in enumerate(me)])
    return acc


def ring_all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """All-reduce (sum) along the ring: ``x`` is ``(local, *shape)``; every
    shard ends with the sum over all shards, as :func:`ring_reduce_scatter`
    of the flattened arrays in ``size`` chunks (the last zero-padded) and
    :func:`ring_all_gather` of the sums.  Each chunk is added in the
    reduce-scatter's order, so the bits do not depend on how many
    processes hold the shards."""
    size, local = mesh.size(axis), x.shape[0]
    n = x[0].numel()
    pad = (-n) % size
    flat = torch.nn.functional.pad(x.reshape(local, n), (0, pad)).view(local, size, -1)
    _, blocks = ring_all_gather(ring_reduce_scatter(flat, mesh, axis), mesh, axis)
    # blocks[i, t] holds chunk (me_i - t) mod size: put the chunks in order
    order = torch.stack([torch.tensor([(m - c) % size for c in range(size)])
                         for m in _me(mesh, axis)]).to(x.device)
    out = torch.gather(blocks, 1, order[:, :, None].expand(-1, -1, blocks.shape[-1]))
    return out.reshape(local, -1)[:, :n].reshape(x.shape)


def ring_streamed_map(
    blocks: tuple[torch.Tensor, ...],
    mesh: Mesh,
    axis: str,
    fold: Callable,
    init: list,
) -> list:
    """Stream every shard's block past every other shard (the KNN-build
    pattern).

    ``blocks`` is a tuple of ``(local, ...)`` tensors that travel together;
    ``init`` holds one accumulator a local shard.  ``fold(acc, visiting,
    src) -> acc`` runs once a hop for each local shard, with ``visiting``
    that shard's tuple of visiting blocks and ``src`` the shard they came
    from.  Returns the accumulators."""
    size = mesh.size(axis)
    me = _me(mesh, axis)
    accs = list(init)
    for t in range(size):
        accs = [fold(acc, tuple(b[i] for b in blocks), (me[i] - t) % size)
                for i, acc in enumerate(accs)]
        if t + 1 < size:
            blocks = ring_hop(blocks, mesh, axis)
    return accs
