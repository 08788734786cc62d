"""Plain oracles for the kernels, used by the tests.

They compute the same functions by another route than the plain versions
beside the kernels: a lexsort for the merge, a whole ``(B, C, d)`` gather
with ``torch.sum`` for the scores, a ``torch.matmul`` for the pairwise
distances and one stable sort of the whole masked ``(nq, nx)`` matrix for
the filtered top-k.
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


def pairwise_sq_dist(q, x):
    """(nq, d) × (nx, d) -> (nq, nx) squared L2 by the matmul identity, fp32
    (TF32 off: ``kernels.util.no_tf32``)."""
    q32 = q.to(torch.float32)
    x32 = x.to(torch.float32)
    qn = (q32 * q32).sum(-1)
    xn = (x32 * x32).sum(-1)
    return torch.clamp_min(qn[:, None] + xn[None, :] - 2.0 * (q32 @ x32.T), 0.0)


def filtered_topk(q, x, obj_int, q_int, *, is_filter: bool, k: int):
    """Predicate-masked exact top-k (the pre-filter scan): the whole masked
    distance matrix, a stable sort (lower id first on ties, as the
    reference's ``lax.top_k``) and a slice; ``+inf``/``-1`` pads."""
    d = pairwise_sq_dist(q, x)
    o, qq = obj_int[None, :, :], q_int[:, None, :]
    if is_filter:
        ok = (o[..., 0] >= qq[..., 0]) & (o[..., 1] <= qq[..., 1])
    else:
        ok = (o[..., 0] <= qq[..., 0]) & (o[..., 1] >= qq[..., 1])
    d = torch.where(ok, d, torch.inf)
    pad = max(k - d.shape[1], 0)
    d = torch.cat([d, torch.full((d.shape[0], pad), torch.inf, device=d.device)], dim=1)
    vals, idx = torch.sort(d, dim=1, stable=True)
    vals = vals[:, :k]
    return vals, torch.where(torch.isfinite(vals), idx[:, :k], -1).to(torch.int32)
