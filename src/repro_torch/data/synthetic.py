"""Deterministic synthetic data: LM batches and vector corpora with interval
attributes.

Everything is a pure function of its seeds, so a restart resumes from a
checkpointed cursor with the same data.  Two product lines:

* **LM batches** — ``tokens``/``labels``/``mask`` (and encoder ``frames``)
  at any (batch, seq) shape, with a Zipf-ish marginal so losses are
  non-degenerate.  A batch is a pure function of ``(seed, step)``: it is
  drawn on the CPU from a ``torch.Generator`` seeded with
  :func:`lm_seed` and then moved, so the card and the CPU see the same
  batches;
* **Vector corpora** — Gaussian-mixture embeddings plus the paper's
  uniform interval model (§3.2) and the short/long/mixed/point query
  workloads of Exp-1/Exp-3, drawn from a ``torch.Generator`` seeded with
  ``seed`` on the target device, so a corpus is made in bulk where it is
  used.

The numbers differ from the reference's ``jax.random`` draws.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from repro_torch.kernels.util import resolve_device


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    batch: int            # global batch
    seq: int
    seed: int = 0


def lm_seed(seed: int, step: int) -> int:
    """The generator seed of step ``step``'s batch:
    ``(seed · 2654435761 + step) mod 2³²``.  The CPU generator keeps 32
    bits of its seed, so the rule folds both into 32: every step of one
    seed gets its own stream (for ``step < 2³²``)."""
    if step < 0 or seed < 0:
        raise ValueError(f"lm_batch takes a non-negative seed and step (seed {seed}, "
                         f"step {step})")
    return (seed * 2654435761 + step) % 2 ** 32


def lm_batch(cfg: LMDataConfig, step: int, *, frames_dim: int = 0, frames_len: int = 0,
             device=None) -> dict:
    """The global LM batch of one step, on ``device`` (``None`` = the card).

    Tokens are ``(u · u · (vocab − 1))`` truncated to int32 for uniform
    ``u`` (squaring skews them toward low ids), ``seq + 1`` a row;
    ``tokens``/``labels`` are the row shifted by one, ``mask`` is ones,
    and ``frames`` (when ``frames_dim``) are standard normal
    ``(batch, frames_len, frames_dim)`` float32."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(lm_seed(cfg.seed, step))
    u = torch.rand((cfg.batch, cfg.seq + 1), generator=g, dtype=torch.float32)
    toks = (u * u * (cfg.vocab - 1)).to(torch.int32)
    batch = {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:],
        "mask": torch.ones((cfg.batch, cfg.seq), dtype=torch.float32),
    }
    if frames_dim:
        batch["frames"] = torch.randn((cfg.batch, frames_len, frames_dim), generator=g,
                                      dtype=torch.float32)
    return {k: v.contiguous().to(dev) for k, v in batch.items()}


def lm_batches(cfg: LMDataConfig, start_step: int = 0, **kw) -> Iterator[dict]:
    step = start_step
    while True:
        yield lm_batch(cfg, step, **kw)
        step += 1


def host_slice(global_batch: dict, host_id: int, n_hosts: int) -> dict:
    """Host ``host_id``'s rows of a global batch (of nested dicts): each
    leaf's ``[host_id · per, (host_id + 1) · per)`` rows, ``per`` its rows
    over ``n_hosts``."""
    def sl(a):
        if isinstance(a, dict):
            return {k: sl(v) for k, v in a.items()}
        per = a.shape[0] // n_hosts
        return a[host_id * per:(host_id + 1) * per]

    return sl(global_batch)


# ---------------------------------------------------------------------------
# Vector + interval corpora (paper benchmarks)
# ---------------------------------------------------------------------------


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
