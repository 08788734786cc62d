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
step (``train/step.py``) runs the model under
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

The other families (``rwkv6``, ``zamba2``, ``encdec``) describe their
split products as groups (:class:`Group`), which :func:`plan_groups` resolves
against the specs: ``"heads"`` (RWKV6's time-mix heads with ``w_g``'s
columns; the attention of the shared block, the encoder and the decoder,
cross attention too), ``"kv_heads"``, ``"ssm_heads"`` (Mamba2's heads,
their ``gn`` and ``w_out`` channels), ``"mlp"`` (RWKV6's channel-mix,
the SwiGLU MLPs) and ``"vocab"``.  A group splits only where every leaf
of it splits along ``model`` as its computation reads it; otherwise its
split leaves are gathered whole along ``model`` and it runs whole on
every process, its gradient complete there.  A leaf a split group reads
whole although its spec splits it contiguously (Mamba2's ``w_in`` and
``conv_w``, whose column blocks are not a shard's heads) is gathered,
then handed over as a partial leaf.

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

**Serving** (``launch/dryrun.py``'s ``prefill_step`` and ``serve_step``,
the decoder family) runs the same split products under a context whose
``split`` may also name ``"sequence"``: the decode cache's sequence is
split along ``model`` (where the kv heads do not divide it, and for MLA's
latent cache), each local shard holding its block of positions of every
kv head.  A decode step then gathers the queries of every head along
``model`` (:meth:`TensorParallel.gather`), scores them against each
shard's positions and merges the shards' partial softmaxes
(:meth:`TensorParallel.merge`); the next token is the argmax over the
vocab split along ``model`` (:meth:`TensorParallel.argmax`).  Both end in
``ordered_sum`` or a maximum, so 1, 2 or 4 processes give the same bits.

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
GROUPS = ("heads", "kv_heads", "ssm_heads", "mlp", "vocab", "expert", "expert_mlp")
# the serve step's decode cache split along model by its sequence (not a product group)
SEQUENCE = "sequence"


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

    def gather(self, parts, dim: int) -> torch.Tensor:
        """Every ``model`` shard's part concatenated along ``dim`` in shard
        order, from the local shards' ``parts`` (no gradient; one
        all-gather of the stacked parts)."""
        from repro_torch.distributed.collectives import all_gather

        if self.mesh is None:
            (out,) = parts
            return out
        stacked = torch.stack([p.detach() for p in parts])
        with self.timed("tp_s"):
            every = all_gather(stacked, self.mesh, "model").flatten(0, 1)   # (size, ...)
        return torch.cat(list(every.unbind(0)), dim=dim)

    def merge(self, parts) -> torch.Tensor:
        """The attention output from each local shard's partial softmax over
        its block of positions, ``(m, l, acc)``: the row maximum ``m``
        (``-inf`` where the block holds no valid position), ``l = Σ exp(s −
        m)`` and ``acc = Σ exp(s − m) · v`` (last dimension the values').
        The maximum over every ``model`` shard, each shard's ``l`` and
        ``acc`` rescaled to it, and their :meth:`sum` in shard order; then
        ``acc / l``."""
        m = self.max([p[0] for p in parts])
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        scaled = []
        for mj, lj, aj in parts:
            c = torch.where(torch.isfinite(mj), torch.exp(mj - m_safe), 0.0)
            scaled.append(torch.cat([(lj * c)[..., None], aj * c[..., None]], dim=-1))
        total = scaled[0] if self.mesh is None else self.sum(torch.stack(scaled))
        return total[..., 1:] / total[..., :1].clamp_min(1e-30)

    def argmax(self, parts) -> torch.Tensor:
        """The index of the largest entry over the last dimension split along
        ``model`` (each local shard's part its block of the columns, all of
        equal width), the lowest index among equal values, as
        ``torch.argmax`` keeps the first: the maximum over every shard, then
        the least global index among the shards that hold it (a maximum of
        the negated indices).  int64, no gradient."""
        if self.mesh is None:
            (out,) = parts
            return torch.argmax(out, dim=-1)
        width = parts[0].shape[-1]
        # exact in float32 for bf16 and float32 logits; float64 stays float64
        vals = [p.detach().to(torch.promote_types(p.dtype, torch.float32)) for p in parts]
        best = [v.max(dim=-1) for v in vals]
        m = self.max([b.values for b in best])
        big = torch.iinfo(torch.int64).max
        cand = [torch.where(b.values == m, b.indices + self.shard(j) * width, big)
                for j, b in enumerate(best)]
        return -self.max([-c for c in cand])

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


# ---------------------------------------------------------------------------
# Planning the other families' split
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Group:
    """Leaves that one computation reads together along ``model``.

    ``dims``: each leaf whose block the computation reads, with the
    dimension its spec must split along ``model``; ``partial``: leaves
    replicated along ``model`` that feed the split computation (one copy a
    local shard); ``gathered``: leaves the split computation reads whole
    (gathered along ``model``, then partial); ``within``: the group whose
    split computation this one's leaves feed (the kv heads of the query
    heads): it splits only with that group, and where that group splits
    without it its leaves are gathered, then partial."""

    name: str
    dims: dict
    partial: tuple = ()
    gathered: tuple = ()
    within: str | None = None


def model_dims(spec) -> list[int]:
    """The dimensions of ``spec`` that ``model`` splits."""
    return [i for i, e in enumerate(spec)
            if e == "model" or (isinstance(e, tuple) and "model" in e)]


def plan_groups(groups: Iterable[Group], specs: dict, whole: Iterable = ()
                ) -> tuple[frozenset, frozenset, frozenset]:
    """``(split groups, partial leaves, leaves gathered whole)`` of
    ``groups`` under ``specs`` (``{path: spec}``).  ``whole``: leaves whose
    computation always runs whole (gathered where their spec splits
    them).  Raises ``ValueError`` naming a leaf that ``model`` splits and
    no group reads."""
    groups = list(groups)
    split_at = {path: dim for g in groups for path, dim in g.dims.items()}
    read = set(split_at) | {p for g in groups for p in g.gathered} | set(whole)
    for path, spec in specs.items():
        if model_dims(spec) and path not in read:
            raise ValueError(f"the tensor-parallel step cannot serve {'/'.join(path)} under "
                             f"its spec {spec}")

    def usable(g: Group) -> bool:
        return all(model_dims(specs[p]) == [d] and specs[p][d] == "model"
                   for p, d in g.dims.items())

    def splits(name: str, outer) -> bool:       # every group of the name is usable
        of = [g for g in groups if g.name == name]
        return all(usable(g) and (g.within is None or g.within in outer) for g in of)

    names = {g.name for g in groups if g.within is None}
    names = {n for n in names if splits(n, ())}
    names |= {g.name for g in groups if g.within is not None and splits(g.name, names)}
    partial, gathered = set(), set()
    for g in groups:
        if g.name in names:
            partial.update(g.partial + g.gathered)
            gathered.update(g.gathered)
        elif g.within in names:            # its leaves feed the other group's split whole
            partial.update(tuple(g.dims) + g.partial + g.gathered)
            gathered.update(tuple(g.dims) + g.gathered)
        else:
            gathered.update(tuple(g.dims) + g.gathered)
    gathered.update(whole)
    return (frozenset(names), frozenset(partial),
            frozenset(p for p in gathered if model_dims(specs[p])))
