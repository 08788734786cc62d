"""Gradient compression: int8 quantized all-reduce with error feedback.

For cross-pod data parallelism the data-parallel all-reduce crosses the
slow links; int8 block quantization cuts those bytes 4× (bf16 → int8 plus
a float32 scale per block).  Error feedback (Seide et al.; the 1-bit SGD
lineage) keeps the quantization noise from biasing convergence: the
residual between the true and the quantized gradient is carried into the
next step.

The reference calls :func:`compressed_psum` inside ``shard_map``; here a
leaf is a per-shard array, ``(local, *shape)`` with its leading dimension
over this process's shards of the axis (``distributed/collectives.py``'s
convention).  The quantization is the reference's to the bit, as XLA
compiles it (the reference always runs it under ``jit``/``shard_map``):
XLA's simplifier turns ``max|x| / 127`` into a product with the float32
reciprocal of 127, and contracts the residual ``flat − q·scale`` into one
rounding (a fused multiply-add); the port computes the scale so and the
residual exactly (the product ``q·scale`` is exact in float64) before one
rounding to float32.  The rounding is round-half-to-even in both
packages (``torch.round``, ``jnp.round``).  So the int8 payload, the
scales and the residual are the reference's values.  The sum over the
shards is
:func:`~repro_torch.distributed.collectives.ring_all_reduce` of the
dequantized payloads (the reference models the same numerics by a
``psum`` of the dequantized values); its order of addition is the ring's,
so that sum is held to the reference within float32 rounding.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import ring_all_reduce
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train.optim import tree_from_paths

BLOCK = 256
_INV_127 = float(np.float32(1.0) / np.float32(127.0))   # the float32 reciprocal XLA multiplies by


class EFState(NamedTuple):
    residual: Any  # same tree as the gradients, float32


def init_ef(grads_template) -> EFState:
    return EFState(tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                  device=g.device), grads_template))


def _quantize(x: torch.Tensor):
    """Per-block symmetric int8 quantization of a flat float32 vector:
    ``(q (blocks, BLOCK) int8, scale (blocks, 1) float32, n)``."""
    n = x.shape[0]
    xp = F.pad(x, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    scale = xp.abs().amax(dim=1, keepdim=True) * _INV_127 + 1e-12
    q = torch.clamp(torch.round(xp / scale), -127, 127).to(torch.int8)
    return q, scale.float(), n


def _dequantize(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)[:n]


def _residual(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """``x − q·scale`` with one rounding, as XLA's fused multiply-add gives
    it: ``q·scale`` is exact in float64 (8 and 24 significant bits), and
    ``x`` lies within half a step of it, so their difference is exact in
    float64 too."""
    prod = (q.double() * scale.double()).reshape(-1)[:n]
    return (x.double() - prod).float()


def compressed_psum(grads, ef: EFState, mesh, axis: str):
    """int8 all-reduce with error feedback over ``axis``.

    ``grads`` and ``ef.residual`` are trees of per-shard arrays.  Returns
    (the mean gradients, a per-shard array a leaf, every shard's equal; the
    new EF state).  On the wire the reference's hardware moves the int8
    payload and one float32 scale per 256 elements (≈ 4.06× fewer bytes
    than float32, 2.03× fewer than bf16)."""
    size = mesh.size(axis)
    res = dict(tree_leaves(ef.residual))
    mean, new_res = {}, {}
    for path, g in tree_leaves(grads):
        g32 = g.float() + res[path]
        flat = g32.reshape(g.shape[0], -1)
        deq, resid = [], []
        for row in flat:
            q, scale, n = _quantize(row)
            deq.append(_dequantize(q, scale, n))
            resid.append(_residual(row, q, scale, n))  # error feedback residual
        total = ring_all_reduce(torch.stack(deq), mesh, axis)
        mean[path] = (total / size).reshape(g.shape).to(g.dtype)
        new_res[path] = torch.stack(resid).reshape(g.shape)
    return tree_from_paths(grads, mean), EFState(tree_from_paths(grads, new_res))


def compression_ratio(n_elements: int) -> float:
    """Bytes(bf16) / bytes(int8 + scales) for an n-element tensor."""
    bf16 = 2 * n_elements
    blocks = (n_elements + BLOCK - 1) // BLOCK
    comp = n_elements + 4 * blocks
    return bf16 / comp
