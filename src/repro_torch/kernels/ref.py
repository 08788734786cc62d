"""Plain oracles for the kernels, used by the tests.

They compute the same functions by another route than the plain versions
beside the kernels: a lexsort for the merge, a whole ``(B, C, d)`` gather
with ``torch.sum`` for the scores.
"""
from __future__ import annotations

import torch


def beam_merge(beam_d, beam_p, cand_d, cand_p):
    """Sorted-beam partial merge oracle: the ``E`` smallest of the beam ∪
    candidate union under the total order ``(dist, payload)``.

    A lexsort (payload first, then a stable sort by distance) realises the
    network's total order, so the oracle is bitwise equal to it."""
    E = beam_d.shape[-1]
    d = torch.cat([beam_d, cand_d], dim=-1)
    p = torch.cat([beam_p, cand_p], dim=-1)
    _, o1 = torch.sort(p, dim=-1, stable=True)
    _, o2 = torch.sort(torch.gather(d, -1, o1), dim=-1, stable=True)
    order = torch.gather(o1, -1, o2)[..., :E]
    return torch.gather(d, -1, order), torch.gather(p, -1, order)


def gather_sq_dist(x, idx, q):
    """Beam-expansion scoring: x (n, d), idx (B, M), q (B, d) -> (B, M);
    ``+inf`` where ``idx < 0``."""
    n = x.shape[0]
    rows = x[idx.clamp(0, n - 1).long()].to(torch.float32)
    diff = rows - q[:, None, :].to(torch.float32)
    return torch.where(idx >= 0, (diff * diff).sum(-1), torch.inf)
