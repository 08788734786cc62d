"""The active mesh of model internals.

Model code is mesh-agnostic; a caller ``activate(mesh)``s (or enters
``use_mesh(mesh)``) before it runs a model function under a mesh.  Two
things read it: :func:`dp_size` and :func:`tp_size`, which decide the MoE
layer's path (``models/moe.py``: the expert-parallel path when the shapes
divide, else the local path with one dispatch group a data shard), and the
expert-parallel path itself, which reads the mesh's shards and groups.
Nothing else changes under a mesh.  As in the reference, the training step
does not activate a mesh (its MoE dispatch stays global); the dry-run and
the expert-parallel checks do.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterable

_MESH = None  # the port's launch.mesh.Mesh when active


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
