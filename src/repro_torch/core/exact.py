"""Exact URNG / RNG constructions (paper Def. 3.1, Thm 3.8) and the dense
graph container.

These are the O(n³) oracles of the tests and the benchmark ground truth.
They evaluate the URNG definition exactly: per node, the candidates are all
other nodes in ascending-distance order with unbounded degree budgets.
Thm 4.1 shows that this is ``UnifiedPrune`` at ``M = ∞`` over the full
candidate graph, so :func:`build_exact` runs the port's
:func:`~repro_torch.core.prune.unified_prune` (and its ``prune_sweep``
kernel) at ``C = n``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import intervals as iv


@dataclasses.dataclass(frozen=True)
class DenseGraph:
    """Dense directed graph: per-node neighbor ids + semantic bitmask."""

    nbrs: torch.Tensor    # (n, M) int32, -1 padded, ascending distance
    status: torch.Tensor  # (n, M) uint8 semantic bitmask

    @property
    def n(self) -> int:
        return self.nbrs.shape[0]

    @property
    def max_degree(self) -> int:
        return self.nbrs.shape[1]

    def degree(self, flag: int) -> torch.Tensor:
        return (((self.status.int() & flag) > 0) & (self.nbrs >= 0)).sum(dim=1)

    def projection(self, sem: iv.Semantics) -> "DenseGraph":
        """Semantic projection G^σ (Thm 3.3): keep only σ-active edges."""
        active = ((self.status.int() & sem.flag) > 0) & (self.nbrs >= 0)
        return DenseGraph(torch.where(active, self.nbrs, -1),
                          torch.where(active, self.status, 0))

    def induced(self, node_mask) -> "DenseGraph":
        """Induced subgraph on ``node_mask`` (both endpoints valid)."""
        mask = torch.as_tensor(node_mask, dtype=torch.bool, device=self.nbrs.device)
        ok = (self.nbrs >= 0) & mask[self.nbrs.clamp(0, self.n - 1).long()] & mask[:, None]
        return DenseGraph(torch.where(ok, self.nbrs, -1), torch.where(ok, self.status, 0))


def build_exact(
    x,
    intervals,
    *,
    unified: bool = True,
    alpha: float = 1.0,
    node_mask=None,
    block: int = 128,
    backend: str | None = None,
    device=None,
) -> DenseGraph:
    """Exact URNG (``unified=True``) or classical RNG (``unified=False``) on
    ``device`` (``None`` = the card).

    ``node_mask`` restricts the construction to a subset of nodes: building
    on the masked set must equal inducing the full graph onto it (the
    structural-heredity tests, Thm 3.5/4.1).  ``backend`` picks the pruning
    sweep (``cuda`` | ``torch``, ``None`` = by device); both give the same
    graph bit for bit."""
    from repro_torch.core.prune import unified_prune  # prune imports the kernels
    from repro_torch.core.store import as_tensor
    from repro_torch.kernels.util import no_tf32, resolve_device

    dev = resolve_device(device)
    no_tf32()
    x = as_tensor(x, torch.float32, dev)
    intervals = as_tensor(intervals, torch.float32, dev)
    n = x.shape[0]
    if node_mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        mask = torch.as_tensor(node_mask).to(device=dev, dtype=torch.bool)
    valid_ids = torch.nonzero(mask).flatten().to(torch.int32)
    # The full candidate row: every valid node (unified_prune drops self).
    cand_row = torch.full((n,), -1, dtype=torch.int32, device=dev)
    cand_row[: valid_ids.shape[0]] = valid_ids

    nbrs_out = torch.full((n, n), -1, dtype=torch.int32, device=dev)
    stat_out = torch.zeros((n, n), dtype=torch.uint8, device=dev)
    for s in range(0, valid_ids.shape[0], block):
        u_blk = valid_ids[s : s + block]
        cand = cand_row[None, :].expand(u_blk.shape[0], n).contiguous()
        res = unified_prune(u_blk, cand, x, intervals, m_if=n, m_is=n, alpha=alpha,
                            unified=unified, backend=backend)
        nbrs_out[u_blk.long()] = res.order
        stat_out[u_blk.long()] = res.status

    # Fully pruned edges carry no semantics: drop them from the adjacency,
    # then move each row's live edges to the front in column order.
    live = (stat_out > 0) & (nbrs_out >= 0)
    max_deg = max(int(live.sum(dim=1).max()), 1) if n else 1
    order = torch.sort((~live).to(torch.uint8), dim=1, stable=True).indices[:, :max_deg]
    keep = torch.gather(live, 1, order)
    nbrs = torch.where(keep, torch.gather(nbrs_out, 1, order), -1)
    status = torch.where(keep, torch.gather(stat_out, 1, order), 0)
    return DenseGraph(nbrs.contiguous(), status.contiguous())


def greedy_monotonic_path(graph: DenseGraph, x, sem: iv.Semantics, src: int, dst: int,
                          max_steps: int | None = None) -> list[int]:
    """Greedy walk toward ``dst`` along σ-active edges, moving only to
    strictly closer neighbors (Def. 3.2), in float64 on the host.  Returns
    the visited path; reaching ``dst`` certifies a monotonic path (Thm 3.3 /
    Cor. 3.4 check)."""
    as_np = lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    xn = as_np(x).astype(np.float64)
    nbrs = as_np(graph.nbrs)
    stat = as_np(graph.status)
    tgt = xn[dst]
    cur = src
    path = [cur]
    for _ in range(max_steps or graph.n + 1):
        if cur == dst:
            return path
        row = nbrs[cur]
        ok = (row >= 0) & ((stat[cur] & sem.flag) > 0)
        if not ok.any():
            return path
        cand = row[ok]
        d = ((xn[cand] - tgt) ** 2).sum(axis=1)
        j = int(np.argmin(d))
        if d[j] >= ((xn[cur] - tgt) ** 2).sum():  # no strictly closer neighbor: stuck
            return path
        cur = int(cand[j])
        path.append(cur)
    return path
