"""Dense graph container (per-node neighbor ids + semantic bitmask).

The exact URNG oracles of the reference (``build_exact``,
``greedy_monotonic_path``) are not ported yet (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses

import torch


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
