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
:func:`ordered_sum` is the tensor-parallel sum over ``model``: every
shard's partial, added in shard order.

:data:`COUNTS` adds up, by the reference's five collective types, the
operand bytes this process hands to collectives that span more than one
process: an all-gather's operand is the block it sends, a reduce-scatter's
and an all-reduce's the whole contribution, a ring hop's (a
collective-permute) the block it passes on, an all-to-all's its send
buffer (``models/moe.py``).  A collective made inside another (the ring
hops of a reduce-scatter) counts as part of the outer one.
``launch/hlo_analysis.py`` plans the same counts for a step.

An axis whose group is a :class:`Planned` moves nothing: each collective
runs its local ops and stands every peer's block in by this process's own
(``launch/dryrun.py`` runs one card's step of a large mesh so).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh

_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

COUNTS: dict[str, int] = {}      # collective type -> operand bytes, since the last reset
_LOCK = threading.Lock()
_DEPTH = threading.local()


def reset_counts() -> None:
    with _LOCK:
        COUNTS.clear()


def counts() -> dict[str, int]:
    """A copy of :data:`COUNTS`."""
    with _LOCK:
        return dict(COUNTS)


def spans(mesh: Mesh, axis: str) -> bool:
    """Whether ``axis`` spans more than one process."""
    return mesh.procs[mesh.axes.index(axis)] > 1


@contextlib.contextmanager
def counted(kind: str, nbytes: int, across: bool):
    """Count ``nbytes`` under ``kind`` for the block when ``across`` (the
    collective spans processes) and no collective around it counts."""
    depth = getattr(_DEPTH, "n", 0)
    if across and depth == 0:
        with _LOCK:
            COUNTS[kind] = COUNTS.get(kind, 0) + int(nbytes)
    _DEPTH.n = depth + 1
    try:
        yield
    finally:
        _DEPTH.n = depth


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Planned:
    """The process group of an axis whose collectives are planned and not
    run: no data moves, and a peer's block is this process's own."""


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through the host on ``group`` (CUDA on gloo)."""
    return t.is_cuda and not isinstance(group, Planned) and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every process's ``t`` along ``axis``, stacked on a new leading
    dimension in the axis's order: ``(procs along axis, *t.shape)``.
    Where the axis spans one process (or without a process group) that is
    ``t[None]``, with no ``torch.distributed`` call: the mesh step's data
    shards call it from threads of their own (``train/step.py``)."""
    group = mesh.groups.get(axis)
    if group is None or not spans(mesh, axis):
        return t[None]
    with counted("all-gather", _nbytes(t), spans(mesh, axis)):
        stage = _staged(t, group)
        src = (t.cpu() if stage else t).contiguous()[None]
        procs = mesh.procs[mesh.axes.index(axis)]
        if isinstance(group, Planned):
            return src.expand((procs,) + tuple(t.shape))
        out = src.new_empty((procs,) + tuple(t.shape))
        _all_gather_single(out, src, group=group)
    return out.to(t.device) if stage else out


def all_reduce_max(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the processes along ``axis``
    (``t`` itself where the axis spans one process)."""
    group = mesh.groups.get(axis)
    if group is None or not spans(mesh, axis):
        return t
    with counted("all-reduce", _nbytes(t), spans(mesh, axis)):
        stage = _staged(t, group)
        out = t.cpu() if stage else t.clone()
        if not isinstance(group, Planned):
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out.to(t.device) if stage else out


def ordered_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over every shard of ``axis`` of its partial, added in shard
    order (``((p₀ + p₁) + p₂) + …``): ``x`` is ``(local, *shape)``, this
    process's shards' partials; every process gets the ``shape`` sum.  An
    all-gather of the partials, then the ordered sum, so the bits do not
    depend on how many processes hold the shards.  Counted as an
    all-reduce of the partials."""
    with counted("all-reduce", _nbytes(x), spans(mesh, axis)):
        parts = all_gather(x, mesh, axis).flatten(0, 1)        # (size, *shape)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def ring_hop(blocks: tuple[torch.Tensor, ...], mesh: Mesh, axis: str) -> tuple[torch.Tensor, ...]:
    """One hop around the ring of ``axis``: each tensor's per-shard block
    ``i`` moves to shard ``i + 1`` (mod the axis size)."""
    if mesh.procs[mesh.axes.index(axis)] == 1:
        return tuple(torch.roll(b, 1, dims=0) for b in blocks)
    group = mesh.groups[axis]
    nxt, prv = mesh.peer(axis, 1), mesh.peer(axis, -1)
    with counted("collective-permute", _nbytes(*(b[-1] for b in blocks)), True):
        stage = [_staged(b, group) for b in blocks]
        sends = [(b[-1].cpu() if s else b[-1]).contiguous() for b, s in zip(blocks, stage)]
        recvs = sends
        if not isinstance(group, Planned):
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
    with counted("all-gather", _nbytes(x), spans(mesh, axis)):
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
    with counted("reduce-scatter", _nbytes(x), spans(mesh, axis)):
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
    flat = x.new_zeros((local, size, (n + pad) // size))
    flat.view(local, -1)[:, :n].view(x.shape).copy_(x)       # one pass, whatever x's strides
    with counted("all-reduce", _nbytes(x), spans(mesh, axis)):
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
