"""Sharding plans, and the blocks a process holds under them.

The plans are the reference's (``launch/shardings.py``): parameters take
their 2-D (fsdp × tp) specs from the model's logical axes
(``models/common.py``); this module adds the step-level plans — the
batch's spec, the decode states' specs (KV caches etc.) with the
long-context rule (when the request batch cannot be split over the data
axes, the cache's **sequence** axis takes them) — and the token spec.  A
"sharding" is the pair (mesh, spec), :class:`~repro_torch.models.common.
NamedSharding`.

What ``jax.device_put`` under a ``NamedSharding`` does, the port does with
:func:`shard_leaf` and :func:`gather_leaf` (:func:`shard_tree` and
:func:`gather_tree` for a parameter tree or a decode state).  The
decoders' split serve step (``launch/dryrun.py``) holds a process's block
of the decode cache under :func:`decode_state_specs`; where the cache's
sequence is split, :func:`sequence_block` gives the offset and length of
the process's positions.  A process holds
``Mesh.local(axis)`` consecutive shards of each axis, so its **block** of a
leaf holds, along each dimension, that dimension's shards this process
holds, in ascending order, one after another.  A dimension split over two
axes (``("pod", "data")``: shard ``pod · D + data``) may give a process
shards that are not consecutive (shards 1 and 4 of 6 for a process holding
pods 0–1 and data shard 1 of 3); the block still holds them in ascending
order.  Internally a dimension split over axes ``(a, b)`` is viewed as
``(size a, size b, rest)``: each axis then has a sub-dimension of its own,
over which this process's shards are consecutive.

:func:`reduce_blocks` sums per-shard contributions to a leaf over mesh axes
(the ring collectives' fixed order, so the bits do not depend on how many
processes hold the shards) and leaves each process its block.  The
tensor-parallel step (``train/step.py``) gathers a leaf along the data axes
only (``gather_leaf(..., axes=)``), so its contributions are already this
process's block along ``model`` (``reduce_blocks(..., held=("model",))``),
and a leaf replicated along ``model`` that feeds split compute comes with
one partial contribution a ``model`` shard, summed in shard order before
the data axes (``partial=``).  A leaf it gathers along ``model`` too (the
MoE router, ``gather_tree(..., whole=)``) computes whole on every shard, so
its contributions are complete and the block's part of them is taken
(``held=()``); one gathered and then read a shard's columns at a time
(Mamba2's ``w_in`` and ``conv_w``) is partial as well: its contributions
are summed over ``model`` first, then its block taken (``partial=`` and
``held=()``).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.distributed.collectives import (
    all_gather, ordered_sum, ring_all_reduce, ring_reduce_scatter,
)
from repro_torch.models.common import (
    ModelConfig, NamedSharding, P, PartitionSpec, batch_spec, mesh_shape,
)


def _dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axes)


def _dp_size(mesh) -> int:
    return math.prod(mesh.size(a) for a in _dp_axes(mesh))


def _tp_ok(mesh, dim: int) -> bool:
    return "model" in mesh.axes and dim % mesh.size("model") == 0


def batch_shardings(mesh) -> NamedSharding:
    return NamedSharding(mesh, batch_spec(mesh))


def _kv_plan(cfg: ModelConfig, mesh, B: int, S: int, kv_heads: int):
    """Decide (bdim, sdim, kvdim) for a (L, B, S, KV, hd) cache.

    Preference order: batch over the data axes, heads over the model axis;
    every mesh axis that can't be used there lands on the **sequence** axis
    (distributed flash-decode: the shards' partial softmaxes merge)."""
    dp = _dp_axes(mesh)
    dpsz = _dp_size(mesh)
    tp = mesh_shape(mesh).get("model", 1)
    spare = []
    if B % dpsz == 0 and dpsz > 1:
        bdim = dp
    else:
        bdim = None
        spare.extend(dp)
    if kv_heads % tp == 0 and tp > 1:
        kvdim = "model"
    else:
        kvdim = None
        spare.append("model")
    spare = [a for a in spare if a in mesh.axes]
    ssz = math.prod(mesh.size(a) for a in spare) if spare else 1
    sdim = tuple(spare) if spare and S % ssz == 0 else None
    return bdim, sdim, kvdim


def decode_state_specs(cfg: ModelConfig, mesh, B: int, S: int):
    """The decode state's specs, in the family's state type (the tree of
    ``Model.init_decode_state``)."""
    from repro_torch.models import encdec, rwkv_model, transformer, zamba

    dp = _dp_axes(mesh)
    dpsz = _dp_size(mesh)
    b_ok = B % dpsz == 0 and dpsz > 1
    bdim = dp if b_ok else None
    blen = P(dp) if b_ok else P()

    if cfg.family == "decoder":
        if cfg.mla:
            # latent cache has no head axis: all spare capacity on S
            bd, sd, _ = _kv_plan(cfg, mesh, B, S, kv_heads=1)
            c = P(None, bd, sd, None)
            r = P(None, bd, sd, None)
            return transformer.DecodeState((c, r), blen)
        bd, sd, kvd = _kv_plan(cfg, mesh, B, S, cfg.n_kv_heads)
        kv = P(None, bd, sd, kvd, None)
        return transformer.DecodeState((kv, kv), blen)

    if cfg.family == "rwkv6":
        H = cfg.n_heads if cfg.n_heads else cfg.d_model // 64
        h_tp = "model" if _tp_ok(mesh, H) else None
        d_tp = "model" if _tp_ok(mesh, cfg.d_model) else None
        return rwkv_model.RwkvState(
            P(None, bdim, h_tp, None, None),
            P(None, bdim, None, d_tp),
            P(None, bdim, None, d_tp),
            blen,
        )

    if cfg.family == "zamba2":
        di = 2 * cfg.d_model
        H = di // 64
        h_tp = "model" if _tp_ok(mesh, H) else None
        ch_tp = "model" if _tp_ok(mesh, di + 2 * cfg.ssm_state) else None
        bd, sd, kvd = _kv_plan(cfg, mesh, B, S, cfg.n_kv_heads)
        kv = P(None, bd, sd, kvd, None)
        return zamba.ZambaState(
            P(None, bdim, h_tp, None, None),
            P(None, bdim, None, ch_tp),
            (kv, kv),
            blen,
        )

    if cfg.family == "encdec":
        bd, sd, kvd = _kv_plan(cfg, mesh, B, S, cfg.n_kv_heads)
        kv = P(None, bd, sd, kvd, None)
        xkv = P(None, bd, None, kvd, None)
        return encdec.EncDecState((kv, kv), (xkv, xkv), blen)

    raise ValueError(cfg.family)


def sequence_block(cfg: ModelConfig, mesh, B: int, S: int) -> tuple[int, int]:
    """``(offset, length)`` of this process's block of the decode cache's
    sequence under :func:`decode_state_specs` (``(0, S)`` where the
    sequence is not split).  Raises ``ValueError`` where the process's
    shards of the sequence's axes are not consecutive positions."""
    spec = decode_state_specs(cfg, mesh, B, S).cache[0]
    axes = dim_axes(spec, len(spec))[2]
    if not axes:
        return 0, S
    shards = mesh.local_shards(axes)
    if shards != list(range(shards[0], shards[0] + len(shards))):
        raise ValueError(f"the process's shards {shards} of the sequence over {axes} are not "
                         "consecutive")
    n = S // math.prod(mesh.size(a) for a in axes)
    return shards[0] * n, len(shards) * n


def map_specs(fn, tree):
    """``tree`` (named tuples, tuples, dicts) with every spec replaced by
    ``fn(spec)``."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [map_specs(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    raise TypeError(f"not a tree of specs: {tree!r}")


def decode_state_shardings(cfg: ModelConfig, mesh, B: int, S: int):
    return map_specs(lambda s: NamedSharding(mesh, s), decode_state_specs(cfg, mesh, B, S))


def token_sharding(mesh, B: int) -> NamedSharding:
    dp = _dp_axes(mesh)
    ok = B % _dp_size(mesh) == 0
    return NamedSharding(mesh, P(dp if ok else None, None))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def dim_axes(spec: Sequence, ndim: int) -> list[tuple[str, ...]]:
    """Each dimension's mesh axes (a spec shorter than the array leaves the
    last dimensions whole)."""
    out = []
    for i in range(ndim):
        e = spec[i] if i < len(spec) else None
        out.append(() if e is None else ((e,) if isinstance(e, str) else tuple(e)))
    return out


def expanded(shape: Sequence[int], mesh, spec, sizes_of) -> tuple[list[int], dict[str, int]]:
    """The view of a leaf with a sub-dimension an axis: ``(shape, {axis:
    position})``; ``sizes_of(axis)`` is the sub-dimension's size (the axis's
    size for a full leaf, this process's shards of it for a block)."""
    exp, pos = [], {}
    for n, axes in zip(shape, dim_axes(spec, len(shape))):
        held = math.prod(sizes_of(a) for a in axes)
        if n % held:
            raise ValueError(f"dimension {n} does not split over {axes} ({held} shards)")
        for a in axes:
            pos[a] = len(exp)
            exp.append(sizes_of(a))
        exp.append(n // held)
    return exp, pos


def block_shape(shape: Sequence[int], mesh, spec) -> tuple[int, ...]:
    """The shape of this process's block of a leaf of ``shape``."""
    out = []
    for n, axes in zip(shape, dim_axes(spec, len(shape))):
        whole = math.prod(mesh.size(a) for a in axes)
        if n % whole:
            raise ValueError(f"dimension {n} does not split over {axes} ({whole} shards)")
        out.append(n // whole * math.prod(mesh.local(a) for a in axes))
    return tuple(out)


def shard_leaf(full: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This process's block of ``full`` under ``spec``, a new tensor on
    ``full``'s device."""
    exp, pos = expanded(full.shape, mesh, spec, mesh.size)
    t = full.reshape(exp)
    for a, p in pos.items():
        t = t.narrow(p, mesh.start(a), mesh.local(a))
    return t.reshape(block_shape(full.shape, mesh, spec)).clone()


def _rescaled(shape: Sequence[int], mesh, spec, have, want) -> tuple[int, ...]:
    """``shape``, each dimension's shards of its spec's axes rescaled from
    ``have(axis)`` to ``want(axis)``."""
    return tuple(n // math.prod(have(a) for a in axes) * math.prod(want(a) for a in axes)
                 for n, axes in zip(shape, dim_axes(spec, len(shape))))


def gather_leaf(block: torch.Tensor, mesh, spec, axes: Sequence[str] | None = None
                ) -> torch.Tensor:
    """The full leaf from every process's block (collective over the
    spec's axes that span several processes; ``block`` itself when this
    process holds every shard).  ``axes`` gathers only those of the spec's
    axes, the others left as this process's block (the tensor-parallel
    step gathers along the data axes only)."""
    todo = [a for d in dim_axes(spec, block.ndim) for a in d
            if (axes is None or a in axes) and mesh.local(a) != mesh.size(a)]
    if not todo:
        return block
    exp, pos = expanded(block.shape, mesh, spec, mesh.local)
    t = block.reshape(exp)
    for a, p in pos.items():
        if a not in todo:
            continue
        g = all_gather(t, mesh, a)                    # (procs along a, *t.shape)
        t = g.movedim(0, p).flatten(p, p + 1)
    return t.reshape(_rescaled(block.shape, mesh, spec, mesh.local,
                               lambda a: mesh.size(a) if a in todo else mesh.local(a)))


def reduce_blocks(contribs: torch.Tensor, mesh, spec, axes: Sequence[str], *,
                  held: Sequence[str] = (), partial: str | None = None) -> torch.Tensor:
    """This process's block of the sum of every shard's contribution to a
    leaf, summed over the shards along ``axes``.

    ``contribs`` is ``(local along axes[0], ..., local along axes[-1],
    *leaf)``: the contribution of each of this process's shards along
    ``axes`` (row-major over them), each the whole leaf, or along the spec
    axes in ``held`` this process's block of it (the tensor-parallel
    step's ``model``).  A spec axis outside ``axes`` and ``held`` holds
    equal contributions along it (compute replicated there): the block's
    part of it is taken, nothing summed.  ``partial`` names an axis along
    which the leaf is replicated but each shard's contribution is partial
    (a leaf that feeds split compute): ``contribs`` then has, after the
    ``axes`` dimensions, one of this process's shards along it, summed
    first with :func:`~repro_torch.distributed.collectives.ordered_sum`.
    Each axis of ``axes`` that splits the leaf is summed with
    :func:`ring_reduce_scatter` over its sub-dimension; an axis that does
    not, with :func:`ring_all_reduce`.  The axes are summed last to
    first."""
    axes = tuple(axes)
    k = len(axes)
    if partial is not None:
        contribs = ordered_sum(contribs.movedim(k, 0), mesh, partial)
    shape = contribs.shape[k:]
    exp, pos = expanded(shape, mesh, spec, lambda a: mesh.local(a) if a in held else mesh.size(a))
    t = contribs.reshape(contribs.shape[:k] + tuple(exp))
    for a, p in pos.items():
        if a not in axes and a not in held:
            t = t.narrow(k + p, mesh.start(a), mesh.local(a))
    for j in range(k - 1, -1, -1):
        a = axes[j]
        t = t.movedim(j, 0)                          # (local a, other locals, *exp)
        if a in pos:
            t = t.movedim(j + 1 + pos[a], 1)         # (local a, size a, ...)
            t = ring_reduce_scatter(t, mesh, a)      # (local a, ...): its sub-dimension
            t = t.movedim(0, j + pos[a])
        else:
            t = ring_all_reduce(t, mesh, a)[0]
    return t.reshape(_rescaled(shape, mesh, spec,
                               lambda a: mesh.local(a) if a in held else mesh.size(a),
                               mesh.local))


def shard_tree(tree, mesh, specs):
    """:func:`shard_leaf` of every leaf of a tree of nested dicts, tuples
    and named tuples (a parameter tree, or a decode state under
    :func:`decode_state_specs`), ``specs`` a tree of the same shape."""
    return _map_paths(lambda path, leaf: shard_leaf(leaf, mesh, _at(specs, path)), tree)


def gather_tree(tree, mesh, specs, axes: Sequence[str] | None = None, whole=()):
    """:func:`gather_leaf` of every leaf of a tree as :func:`shard_tree`
    takes it, along ``axes``; the leaves whose paths are in ``whole`` along
    every axis."""
    return _map_paths(lambda path, leaf: gather_leaf(leaf, mesh, _at(specs, path),
                                                     None if path in whole else axes), tree)


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _map_paths(fn, tree, path: tuple = ()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_map_paths(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(path, tree)
