"""Unified interval-aware pruning (paper Alg. 3 / Def. 3.1).

:func:`unified_prune` runs the paper's ``UnifiedPrune`` for a block of
nodes at once.  This module owns the fixed-shape preprocessing (dedup,
distance sort, vector and interval gathers) and hands the scan itself to
``ops.prune_sweep`` (kernels/prune_sweep.py): the CUDA kernel on the card,
its bitwise plain version on the CPU.  Classical RNG pruning is the same
routine with the semantic witness conditions forced to true
(``unified=False``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import intervals as iv
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class PruneResult:
    """Per-node pruning output, aligned to distance-sorted candidate order."""

    order: torch.Tensor      # (B, C) int32 candidate ids sorted by δ(u, ·); -1 pad
    dist: torch.Tensor       # (B, C) f32 squared distance to u (+inf for pads)
    status: torch.Tensor     # (B, C) uint8 semantic bitmask (0 = fully pruned)
    repair_if: torch.Tensor  # (B, C) int32 global id of the IF witness or -1
    repair_is: torch.Tensor  # (B, C) int32 global id of the IS witness or -1


def squared_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """‖a−b‖² over the last axis via the matmul identity, batched over the
    leading axes: (..., i, d) × (..., j, d) → (..., i, j).  float32
    throughout; TF32 stays off (``kernels.util.no_tf32``)."""
    a32 = a.to(torch.float32)
    b32 = b.to(torch.float32)
    an = (a32 * a32).sum(-1)
    bn = (b32 * b32).sum(-1)
    ip = torch.matmul(a32, b32.transpose(-1, -2))
    d = an[..., :, None] + bn[..., None, :] - 2.0 * ip
    return torch.clamp_min(d, 0.0)


def _dedup_sorted_by_distance(cand: torch.Tensor, dist: torch.Tensor):
    """Per row: mask duplicate candidate ids (keep the closest copy), then
    sort by distance.

    ``cand`` is (B, C) int32 with -1 padding.  Among copies of one id the
    minimum-distance one survives, ties broken by scan position; masked
    copies and pads sort to the back as +inf and come out as id -1."""
    dist = torch.where(cand < 0, torch.inf, dist)
    # lexsort by (id, dist): a stable sort by dist, then a stable sort by id
    _, o1 = torch.sort(dist, dim=-1, stable=True)
    sorted_ids, o2 = torch.sort(torch.gather(cand, -1, o1), dim=-1, stable=True)
    id_order = torch.gather(o1, -1, o2)
    dup_sorted = torch.zeros_like(sorted_ids, dtype=torch.bool)
    dup_sorted[:, 1:] = (sorted_ids[:, 1:] == sorted_ids[:, :-1]) & (sorted_ids[:, 1:] >= 0)
    dup = torch.zeros_like(dup_sorted).scatter_(-1, id_order, dup_sorted)
    dist = torch.where(dup, torch.inf, dist)
    out_d, order = torch.sort(dist, dim=-1, stable=True)
    out_c = torch.where(torch.isfinite(out_d), torch.gather(cand, -1, order), -1)
    return out_c, out_d


def unified_prune(
    u_ids: torch.Tensor,     # (B,) int32 node ids of this block
    cand: torch.Tensor,      # (B, C) int32 candidate ids, -1 padded
    x: torch.Tensor,         # (n, d) corpus vectors
    intervals: torch.Tensor, # (n, 2) corpus intervals
    *,
    m_if: int,
    m_is: int,
    alpha: float = 1.0,
    unified: bool = True,
    backend: str | None = None,
) -> PruneResult:
    """Vectorised Alg. 3 over a block of ``B`` nodes.

    Returns neighbor sets in ascending-distance order with the semantic
    bitmask of every surviving edge and the repair pairs ``(w, v)`` for
    Alg. 2's next iteration."""
    B, C = cand.shape
    n = x.shape[0]
    u_long = u_ids.long()
    xu = x[u_long]                                        # (B, d)
    xc = x[cand.clamp(0, n - 1).long()]                   # (B, C, d)
    d_uc = squared_dist(xu[:, None, :], xc)[:, 0, :]      # (B, C)
    d_uc = torch.where((cand < 0) | (cand == u_ids[:, None]), torch.inf, d_uc)
    cand_sorted, d_sorted = _dedup_sorted_by_distance(cand, d_uc)

    safe_sorted = cand_sorted.clamp(0, n - 1).long()
    xs = x[safe_sorted].to(torch.float32)                 # (B, C, d)
    i_c = intervals[safe_sorted]                          # (B, C, 2)
    i_u = intervals[u_long]                               # (B, 2)

    valid = (cand_sorted >= 0) & torch.isfinite(d_sorted)
    if unified:
        overlap = ~iv.is_empty(iv.intersection(i_u[:, None, :], i_c))
    else:
        overlap = torch.ones((B, C), dtype=torch.bool, device=x.device)

    status, rep_if, rep_is = ops.prune_sweep(
        i_u.contiguous(), xs.contiguous(), i_c.contiguous(), d_sorted.contiguous(),
        valid, overlap,
        m_if=m_if, m_is=m_is, alpha=alpha, unified=unified, backend=backend,
    )

    def to_global(rep):
        g = torch.gather(cand_sorted, -1, rep.clamp(0, C - 1).long())
        return torch.where(rep >= 0, g, -1)

    return PruneResult(cand_sorted, d_sorted, status.to(torch.uint8),
                       to_global(rep_if), to_global(rep_is))
