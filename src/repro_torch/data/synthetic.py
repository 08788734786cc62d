"""Synthetic vector corpora with interval attributes (the index half of the
reference's data pipeline).

Gaussian-mixture embeddings plus the paper's uniform interval model (§3.2)
and the short/long/mixed/point query workloads of Exp-1/Exp-3.  Everything
is drawn from a ``torch.Generator`` seeded with ``seed`` on the target
device, so a corpus is made in bulk where it is used; the numbers differ
from the reference's ``jax.random`` draws.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.util import resolve_device


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    n: int
    dim: int
    n_clusters: int = 32
    cluster_std: float = 0.35
    seed: int = 0
    interval_mode: str = "uniform"   # uniform | point (RFANN datasets)


def make_corpus(cfg: CorpusConfig, device=None):
    """Returns (x (n, d) f32, intervals (n, 2) f32 in [0, 1]) on ``device``
    (``None`` = the card)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(cfg.seed)
    centers = torch.randn(cfg.n_clusters, cfg.dim, generator=g, device=dev)
    assign = torch.randint(0, cfg.n_clusters, (cfg.n,), generator=g, device=dev)
    noise = torch.randn(cfg.n, cfg.dim, generator=g, device=dev) * cfg.cluster_std
    x = centers[assign] + noise
    if cfg.interval_mode == "point":
        a = torch.rand(cfg.n, 1, generator=g, device=dev)
        intervals = torch.cat([a, a], dim=1)
    else:
        intervals = torch.sort(torch.rand(cfg.n, 2, generator=g, device=dev), dim=1).values
    return x.to(torch.float32), intervals.to(torch.float32)


def make_queries(cfg: CorpusConfig, nq: int, *, workload: str = "uniform",
                 seed: int = 100, device=None):
    """Query vectors + intervals per the paper's workloads.

    short: narrow windows (half-width 0.10); long: wide (0.35); mixed: half
    and half; point: degenerate ``[t, t]`` (RSANN); uniform: half-widths
    drawn from U(0.1, 0.45)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn(cfg.n_clusters, cfg.dim, generator=g, device=dev)
    assign = torch.randint(0, cfg.n_clusters, (nq,), generator=g, device=dev)
    qv = centers[assign] + torch.randn(nq, cfg.dim, generator=g, device=dev) * cfg.cluster_std
    c = torch.rand(nq, 1, generator=g, device=dev)
    if workload == "point":
        qi = torch.cat([c, c], dim=1)
    else:
        if workload == "short":
            half = torch.full((nq, 1), 0.10, device=dev)
        elif workload == "long":
            half = torch.full((nq, 1), 0.35, device=dev)
        elif workload == "mixed":
            even = (torch.arange(nq, device=dev)[:, None] % 2) == 0
            half = torch.where(even, 0.10, 0.35)
        elif workload == "uniform":
            half = 0.1 + 0.35 * torch.rand(nq, 1, generator=g, device=dev)
        else:
            raise ValueError(f"unknown workload {workload!r}")
        qi = torch.cat([torch.clamp_min(c - half, 0.0), torch.clamp_max(c + half, 1.0)], dim=1)
    return qv.to(torch.float32), qi.to(torch.float32)
