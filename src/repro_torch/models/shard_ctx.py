"""The active mesh of model internals, and the tensor-parallel context.

Model code is mesh-agnostic; a caller ``activate(mesh)``s (or enters
``use_mesh(mesh)``) before it runs a model function under a mesh.  Two
things read it: :func:`dp_size` and :func:`tp_size`, which decide the MoE
layer's path (``models/moe.py``: the expert-parallel path when the shapes
divide, else the local path with one dispatch group a data shard), and the
expert-parallel path itself, which reads the mesh's shards and groups.
As in the reference, the training step does not activate a mesh (its MoE
dispatch stays global); the dry-run and the expert-parallel checks do.

**Tensor parallelism** (Megatron's column/row split; what XLA's
partitioner does with the reference's ``model`` axis).  The mesh train
step of the decoder family (``train/step.py``) runs the model under
:func:`tensor_parallel`, a :class:`TensorParallel` that says which
``model`` shards the computation covers (``Mesh.local("model")`` of them
from ``Mesh.start("model")``) and which product groups the parameters'
specs split: ``"heads"`` (``wq``, ``wo``, MLA's up-projections),
``"kv_heads"`` (``wk``/``wv``), ``"mlp"`` (the MLP's columns, the shared
expert's too), ``"vocab"``, ``"expert"`` (the MoE layer's experts,
``E / model`` of them a shard: the dispatch buffer's rows, the three
expert products and the combine of that shard's slots; the router's
columns split with them in storage, while its product runs whole,
``models/moe.py``) and ``"expert_mlp"`` (where ``E`` does not divide
``model``: every expert's ``d_ff`` columns, each shard dispatching all
the experts' slots).  The model then
sees, for a split leaf, this process's block along ``model``
(:meth:`TensorParallel.shards` cuts it a shard at a time), and for a leaf
that is replicated along ``model`` but feeds split compute (the
``partial`` leaves: norm gammas inside attention, replicated ``wk``/``wv``,
MLA's latent projections) one copy a local shard on a dimension after the
layer dimension (:meth:`TensorParallel.copies`), so that each shard's
gradient stays its own until the step sums them in shard order.

A split region starts at :meth:`TensorParallel.enter` (identity forward;
backward, the ordered sum of the shards' input gradients over ``model``)
and ends at :meth:`TensorParallel.leave` (forward, the ordered sum of the
shards' partials; identity backward), both over
``distributed.collectives.ordered_sum``: every
shard's term added in shard order, so 1, 2 or 4 processes give the same
bits.  A process holding several ``model`` shards runs them one after
another within each region, each on its own tensors: no threads (an
autograd backward on the card runs every thread's nodes on one worker
thread, where a collective could deadlock).

Without a context (or for a group it does not split), :func:`split`
returns :data:`WHOLE`, one shard covering everything: ``enter`` gives
``(x,)``, ``leave`` its one part, ``shards`` and ``copies`` the leaf
itself, with no autograd node and no copy, so the one-device path and
every other family compute what they did.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Iterable

import torch

_MESH = None  # the port's launch.mesh.Mesh when active
_TP = None    # the active TensorParallel


def activate(mesh) -> None:
    global _MESH
    _MESH = mesh


def deactivate() -> None:
    global _MESH
    _MESH = None


@contextlib.contextmanager
def use_mesh(mesh):
    activate(mesh)
    try:
        yield
    finally:
        deactivate()


def active() -> bool:
    return _MESH is not None


def mesh():
    """The active mesh, or ``None``."""
    return _MESH


def dp_size() -> int:
    """Product of the data-parallel axes (1 when inactive)."""
    if _MESH is None:
        return 1
    return math.prod(s for a, s in zip(_MESH.axes, _MESH.shape) if a in ("pod", "data"))


def tp_size() -> int:
    if _MESH is None:
        return 1
    return dict(zip(_MESH.axes, _MESH.shape)).get("model", 1)


def constrain(x, dims: Iterable, *, divisible: bool = True):
    """Returns ``x``.  In the reference this is
    ``with_sharding_constraint``: a hint to XLA's partitioner of where a
    tensor's shards should live, which changes the layout of a computation
    and never its values.  The port has no partitioner to hint: a tensor
    lives where the code that made it put it."""
    return x


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------
GROUPS = ("heads", "kv_heads", "mlp", "vocab", "expert", "expert_mlp")


@contextlib.contextmanager
def _untimed(name: str):
    yield


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """The ``model`` shards a computation covers (``local`` of ``size``
    from ``start``) and the product groups its parameters split (see the
    module docstring).  ``timed(name)`` wraps each model-axis sum (the
    mesh step's seconds under ``tp_s``)."""

    mesh: Any
    split: frozenset
    timed: Callable = _untimed

    @property
    def size(self) -> int:
        return self.mesh.size("model") if self.mesh is not None else 1

    @property
    def start(self) -> int:
        return self.mesh.start("model") if self.mesh is not None else 0

    @property
    def local(self) -> int:
        return self.mesh.local("model") if self.mesh is not None else 1

    def shard(self, j: int) -> int:
        """The global ``model`` shard of local shard ``j``."""
        return self.start + j

    def enter(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``x`` (replicated along ``model``) as one input a local shard."""
        if self.mesh is None:
            return (x,)
        return _Enter.apply(x, self)

    def leave(self, parts) -> torch.Tensor:
        """The ordered sum over every ``model`` shard of the local shards'
        partials (replicated along ``model`` after it)."""
        if self.mesh is None:
            (out,) = parts
            return out
        return _Leave.apply(self, *parts)

    def shards(self, w: torch.Tensor, dim: int) -> list[torch.Tensor]:
        """A split leaf's block cut into its local shards along ``dim``,
        each contiguous (the tensor a process holding only that shard has)."""
        if self.local == 1:
            return [w]
        return [c.contiguous() for c in torch.chunk(w, self.local, dim)]

    def copies(self, w: torch.Tensor) -> list[torch.Tensor]:
        """A partial leaf's copies, one a local shard (its leading
        dimension; the leaf itself for :data:`WHOLE`)."""
        if self.mesh is None:
            return [w]
        return list(w.unbind(0))

    def max(self, parts) -> torch.Tensor:
        """The elementwise maximum over every ``model`` shard of the local
        shards' tensors (no gradient)."""
        from repro_torch.distributed.collectives import all_reduce_max

        out = torch.stack([p.detach() for p in parts]).amax(0)
        if self.mesh is None:
            return out
        with self.timed("tp_s"):
            return all_reduce_max(out, self.mesh, "model")

    def sum(self, stacked: torch.Tensor) -> torch.Tensor:
        """:func:`~repro_torch.distributed.collectives.ordered_sum` over
        ``model`` of ``(local, ...)`` partials."""
        from repro_torch.distributed.collectives import ordered_sum

        with self.timed("tp_s"):
            return ordered_sum(stacked, self.mesh, "model")


WHOLE = TensorParallel(None, frozenset(GROUPS))


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tuple(x.view_as(x) for _ in range(tp.local))

    @staticmethod
    def backward(ctx, *grads):
        return ctx.tp.sum(torch.stack(grads)), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, *parts):
        ctx.n = len(parts)
        return tp.sum(torch.stack(parts))

    @staticmethod
    def backward(ctx, g):
        return (None,) + (g,) * ctx.n


@contextlib.contextmanager
def tensor_parallel(tp: TensorParallel):
    """Runs the block's model functions under ``tp``."""
    global _TP
    was, _TP = _TP, tp
    try:
        yield tp
    finally:
        _TP = was


def split(group: str) -> TensorParallel:
    """The active context when it splits ``group``, else :data:`WHOLE`."""
    return _TP if _TP is not None and group in _TP.split else WHOLE
