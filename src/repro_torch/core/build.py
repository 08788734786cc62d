"""Iterative UG construction (paper Alg. 2) with repair sets.

Each iteration refines the candidate pool of every node by merging the
previously retained neighbors with the repair candidates produced when edges
were pruned (the pruned endpoint ``v`` is offered to its witness ``w``, so
the monotone continuation path through ``w`` can be explored next round).

Repair sets are fixed-width per-node buffers filled by the sort-by-witness
segment scatter; the pruning sweep runs over ``cfg.block``-row tiles, each
through ``unified_prune`` and the ``prune_sweep`` kernel.  The only
device→host sync in :func:`build_ug` is the trailing-column trim at the end.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.candidates import generate_candidates
from repro_torch.core.exact import DenseGraph
from repro_torch.core.prune import unified_prune
from repro_torch.kernels.util import pad_rows, pad_to, segment_scatter


@dataclasses.dataclass(frozen=True)
class UGConfig:
    """Build hyper-parameters; defaults follow the paper's §5.1 (scaled names).

    Paper defaults: ef_spatial=128, ef_attribute=300, max_edges_IF =
    max_edges_IS = 256, 5 refinement iterations.
    """

    ef_spatial: int = 128
    ef_attribute: int = 300
    max_edges_if: int = 256
    max_edges_is: int = 256
    iterations: int = 5
    repair_width: int = 32          # W_max: bounded repair set per node
    alpha: float = 1.0              # RNG slack (1.0 = paper-faithful)
    unified: bool = True            # False = classical interval-agnostic RNG
    nnd_iters: int = 6
    exact_spatial: bool = False     # exact KNN candidates (small n oracle)
    block: int = 1024               # nodes pruned per sweep launch
    prune_backend: str | None = None  # cuda | torch (None = by device)


def scatter_repairs(w_ids: torch.Tensor, v_ids: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """Fixed-width repair sets W(w) from flat (w, v) pairs (Alg. 2 l.11-12)."""
    return segment_scatter(w_ids, v_ids, n, width)


def _prune_all(x, intervals, cand, cfg: UGConfig, keep: int, backend: str | None):
    """One full pruning sweep (Alg. 2 lines 8-9) over all nodes, in
    ``cfg.block``-row tiles.  Returns compacted neighbors/status plus the
    flat repair pairs (w, v) in the reference's order: tile by tile, each
    tile's IF pairs then its IS pairs, row-major."""
    n, C = cand.shape
    dev = x.device
    n_pad = pad_to(n, cfg.block)
    ids = torch.arange(n_pad, dtype=torch.int32, device=dev)
    u_pad = torch.where(ids < n, ids, 0)            # pad rows prune an empty pool
    cand_pad = pad_rows(cand, n_pad, -1)
    nbrs_out, stat_out, w_w, w_v = [], [], [], []
    for s in range(0, n_pad, cfg.block):
        u = u_pad[s : s + cfg.block]
        res = unified_prune(
            u, cand_pad[s : s + cfg.block], x, intervals,
            m_if=cfg.max_edges_if, m_is=cfg.max_edges_is,
            alpha=cfg.alpha, unified=cfg.unified, backend=backend,
        )
        # Compact retained neighbors to the front (ascending distance).
        score = torch.where(res.status > 0, res.dist, torch.inf)
        score_s, order = torch.sort(score, dim=-1, stable=True)
        order = order[:, :keep]
        live = torch.isfinite(score_s[:, :keep])
        nbrs_out.append(torch.where(live, torch.gather(res.order, -1, order), -1))
        stat_out.append(torch.where(live, torch.gather(res.status, -1, order), 0))
        # Repair pairs (w, v): the witness gets the pruned endpoint.
        w_w += [res.repair_if.reshape(-1), res.repair_is.reshape(-1)]
        w_v += [torch.where(res.repair_if >= 0, res.order, -1).reshape(-1),
                torch.where(res.repair_is >= 0, res.order, -1).reshape(-1)]
    return (torch.cat(nbrs_out)[:n], torch.cat(stat_out)[:n],
            torch.cat(w_w), torch.cat(w_v))


def refine_candidates(x, intervals, cand, cfg: UGConfig, backend: str | None = None):
    """The T-iteration Alg. 2 refinement over a prepared candidate pool:
    pruning sweep + repair-set scatter per round.  Returns ``(nbrs, stat,
    deg_means)`` at full ``keep`` width (untrimmed)."""
    n = x.shape[0]
    repair = torch.full((n, cfg.repair_width), -1, dtype=torch.int32, device=x.device)
    nbrs = stat = None
    deg_means = []
    for t in range(cfg.iterations):
        pool = cand if t == 0 else torch.cat([cand, repair], dim=1)
        keep = min(cfg.max_edges_if + cfg.max_edges_is, pool.shape[1])
        nbrs, stat, w_w, w_v = _prune_all(x, intervals, pool, cfg, keep, backend)
        cand = nbrs  # retained neighbors seed the next round (Alg. 2 line 10)
        repair = scatter_repairs(w_w, w_v, n, cfg.repair_width)
        deg_means.append((nbrs >= 0).sum(dim=1).float().mean())
    return nbrs, stat, torch.stack(deg_means)


def build_ug(
    gen: torch.Generator,
    x: torch.Tensor,
    intervals: torch.Tensor,
    cfg: UGConfig = UGConfig(),
    progress: Callable[[str], None] | None = None,
) -> DenseGraph:
    """Paper Alg. 1 + Alg. 2: candidate generation then T pruning iterations.

    ``gen`` is a ``torch.Generator`` on ``x``'s device; only NN-descent
    draws from it."""
    cand = generate_candidates(
        gen, x, intervals,
        ef_spatial=cfg.ef_spatial, ef_attribute=cfg.ef_attribute,
        nnd_iters=cfg.nnd_iters, exact_spatial=cfg.exact_spatial,
    )
    if progress is not None:
        progress(f"candidates: shape {tuple(cand.shape)}")
    nbrs, stat, deg_means = refine_candidates(x, intervals, cand, cfg, cfg.prune_backend)
    # One device→host sync: per-iteration degree stats + the trailing trim.
    live_cols = int(max(int((nbrs >= 0).sum(dim=1).max()), 1))
    if progress is not None:
        for t, dm in enumerate(deg_means.tolist()):
            progress(f"iter {t + 1}/{cfg.iterations}: mean degree {dm:.1f}")
    return DenseGraph(nbrs[:, :live_cols].contiguous(), stat[:, :live_cols].contiguous())
