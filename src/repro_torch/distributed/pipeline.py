"""Pipeline parallelism: GPipe-style microbatch pipelining over a mesh axis.

Layers are split into ``n_stages`` contiguous stages laid out along a mesh
axis; microbatches flow stage to stage one :func:`~repro_torch.distributed.
collectives.ring_hop` a tick.  The schedule is the reference's GPipe loop
of ``n_micro + n_stages − 1`` ticks — every stage computes its resident
microbatch, then passes activations one hop right — so the bubble fraction
is ``(S − 1) / (M + S − 1)`` and a tick's traffic is one boundary
activation per stage pair.

As in the reference this is forward pipelining (the serving stack's deep
embedding towers).  Where one process holds every stage the ring hop is a
local roll and autograd differentiates through it; across processes the
hop's send and receive carry no gradient.

Stage weights are per-shard arrays: a tree whose leaves are ``(local
stages, ...)``, this process's consecutive stages of the axis (all
``n_stages`` where one process holds the axis).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed.collectives import all_gather, ring_hop
from repro_torch.models.common import tree_map


def pipeline_forward(
    mesh,
    axis: str,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,          # tree, leaves (local stages, ...)
    x_micro: torch.Tensor,      # (n_micro, mb, ...) microbatched input, on every process
):
    """Run ``stage_fn(params_stage, x) -> x`` through all stages.

    Returns the (n_micro, mb, ...) outputs the last stage produced, on every
    process."""
    n_stages = mesh.size(axis)
    local, start = mesh.local(axis), mesh.start(axis)
    n_micro = x_micro.shape[0]
    params = [tree_map(lambda a, i=i: a[i], stage_params) for i in range(local)]
    buf = torch.zeros((local,) + tuple(x_micro.shape[1:]), dtype=x_micro.dtype,
                      device=x_micro.device)
    outs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        held = []
        for i in range(local):
            sid = start + i
            b = buf[i]
            if sid == 0 and t < n_micro:             # stage 0 ingests microbatch t
                b = x_micro[t]
            if 0 <= t - sid < n_micro:               # stage s works on microbatch t - s
                b = stage_fn(params[i], b)
            if sid == n_stages - 1 and t - n_stages + 1 >= 0:
                outs[t - n_stages + 1] = b           # the last stage retires one
            held.append(b)
        (buf,) = ring_hop((torch.stack(held),), mesh, axis)   # one stage right
    if start + local == n_stages:
        done = torch.stack(outs)
    else:
        done = torch.zeros_like(x_micro)
    # only the last stage's process holds the outputs: every process takes them
    return all_gather(done, mesh, axis)[-1]


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """GPipe bubble overhead: (S − 1) / (M + S − 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
