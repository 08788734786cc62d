"""Initial candidate generation for UG (paper Alg. 1).

Two complementary sources:

* **spatial** candidates from NN-descent with budget ``ef_spatial``, the
  navigational backbone;
* **attribute** candidates from the four interval-derived sort keys
  ``{l, r, mid, len}``, ``ef_attribute / 8`` adjacent nodes per side per
  key: likely IF/IS witnesses under interval constraints.

NN-descent keeps fixed-width neighbor tensors; the local join is blocked
gathers plus matmul distances, and reverse edges come from the shared
sort-by-segment scatter.  Its random draws come from a ``torch.Generator``,
so its graph differs from the reference's; builds through it are compared
by recall.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.prune import squared_dist
from repro_torch.kernels.util import segment_scatter


@dataclasses.dataclass(frozen=True)
class KnnState:
    ids: torch.Tensor    # (n, K) int32 neighbor ids, ascending distance, -1 pad
    dist: torch.Tensor   # (n, K) f32 squared distances (+inf pad)


def merge_topk(ids_a, d_a, ids_b, d_b, k: int):
    """Merge two candidate lists per row, dedup ids, keep the k closest
    (ties by position: stable sorts throughout)."""
    ids = torch.cat([ids_a, ids_b], dim=-1)
    d = torch.cat([d_a, d_b], dim=-1)
    d = torch.where(ids < 0, torch.inf, d)
    si, io = torch.sort(ids, dim=-1, stable=True)
    dup_sorted = torch.zeros_like(si, dtype=torch.bool)
    dup_sorted[..., 1:] = (si[..., 1:] == si[..., :-1]) & (si[..., 1:] >= 0)
    dup = torch.zeros_like(dup_sorted).scatter_(-1, io, dup_sorted)
    d = torch.where(dup, torch.inf, d)
    out_d, order = torch.sort(d, dim=-1, stable=True)
    out_d = out_d[..., :k]
    out_ids = torch.gather(ids, -1, order[..., :k])
    out_ids = torch.where(torch.isfinite(out_d), out_ids, -1)
    return out_ids, out_d


def _smallest(d: torch.Tensor, k: int):
    """The k smallest per row, ties to the lower index (``lax.top_k`` of
    ``-d`` in the reference)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _block_knn_scan(x: torch.Tensor, queries: torch.Tensor, k: int, block: int = 4096):
    """Exact top-k of ``queries`` against corpus ``x`` by streaming blocks."""
    nq = queries.shape[0]
    ids = torch.full((nq, k), -1, dtype=torch.int32, device=x.device)
    d = torch.full((nq, k), torch.inf, dtype=torch.float32, device=x.device)
    n = x.shape[0]
    for s in range(0, n, block):
        xb = x[s : s + block]
        db = squared_dist(queries, xb)
        vals, idx = _smallest(db, min(k, xb.shape[0]))
        ids, d = merge_topk(ids, d, (idx + s).to(torch.int32), vals, k)
    return ids, d


def brute_force_knn(x: torch.Tensor, k: int, block: int = 2048) -> KnnState:
    """Exact KNN graph (self excluded): the small-n oracle."""
    n = x.shape[0]
    ids_all, d_all = [], []
    for s in range(0, n, block):
        q = x[s : s + block]
        ids, d = _block_knn_scan(x, q, k + 1)
        self_ids = torch.arange(s, s + q.shape[0], dtype=torch.int32, device=x.device)[:, None]
        d = torch.where(ids == self_ids, torch.inf, d)
        d, order = torch.sort(d, dim=-1, stable=True)
        ids_all.append(torch.gather(ids, -1, order[:, :k]))
        d_all.append(d[:, :k])
    return KnnState(torch.cat(ids_all), torch.cat(d_all))


def _reverse_candidates(ids: torch.Tensor, r_max: int) -> torch.Tensor:
    """Reverse edges: for each edge u→v, offer u to v."""
    n, k = ids.shape
    src = torch.arange(n, dtype=torch.int32, device=ids.device)[:, None].expand(n, k).reshape(-1)
    return segment_scatter(ids.reshape(-1), src, n, r_max)


def _blocked_refine(x, ids, dist, cand, k: int, block: int):
    """Score ``cand`` against its rows and merge into the top-k state, one
    ``block``-row tile at a time."""
    n = x.shape[0]
    out_i = torch.empty((n, k), dtype=torch.int32, device=x.device)
    out_d = torch.empty((n, k), dtype=torch.float32, device=x.device)
    for s in range(0, n, block):
        e = min(s + block, n)
        u = torch.arange(s, e, dtype=torch.int32, device=x.device)
        c_b = cand[s:e]
        xc = x[c_b.clamp(0, n - 1).long()]
        db = squared_dist(x[s:e, None, :], xc)[:, 0, :]
        db = torch.where((c_b < 0) | (c_b == u[:, None]), torch.inf, db)
        out_i[s:e], out_d[s:e] = merge_topk(ids[s:e], dist[s:e], c_b, db, k)
    return out_i, out_d


def nn_descent(
    gen: torch.Generator,
    x: torch.Tensor,
    k: int,
    *,
    iters: int = 6,
    sample: int = 8,
    block: int = 4096,
) -> KnnState:
    """Fixed-width NN-descent: local join over forward, reverse and random
    candidates, merged with blocked matmul distances.  ``gen`` lives on
    ``x``'s device."""
    n = x.shape[0]
    dev = x.device
    init_ids = torch.randint(0, n, (n, k), generator=gen, device=dev, dtype=torch.int32)
    empty = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    ids, dist = _blocked_refine(
        x, empty, torch.full((n, k), torch.inf, device=dev), init_ids, k, block)
    for _ in range(iters):
        fwd = ids[:, :sample]                                       # (n, S)
        non = ids[fwd.clamp(0, n - 1).long(), :sample].reshape(n, sample * sample)
        non = torch.where(fwd[:, :1] < 0, -1, non)
        rev = _reverse_candidates(ids, sample)
        rnd = torch.randint(0, n, (n, 4), generator=gen, device=dev, dtype=torch.int32)
        cand = torch.cat([non, rev, rnd], dim=1)
        ids, dist = _blocked_refine(x, ids, dist, cand, k, block)
    return KnnState(ids, dist)


def attribute_width(ef_attribute: int) -> int:
    """Total attribute-candidate columns: 2 sides × ``ef_attribute/8`` per
    side × 4 sort keys (Alg. 1 lines 3-10)."""
    return 8 * max(ef_attribute // 8, 1)


def candidate_pool_width(ef_spatial: int, ef_attribute: int) -> int:
    """Iteration-0 candidate-pool width of :func:`generate_candidates`."""
    return ef_spatial + attribute_width(ef_attribute)


def attribute_candidates(intervals: torch.Tensor, ef_attribute: int) -> torch.Tensor:
    """Alg. 1 lines 3-10: neighbors in the four interval-derived sort orders."""
    n = intervals.shape[0]
    dev = intervals.device
    w = attribute_width(ef_attribute) // 8
    l = intervals[:, 0]
    r = intervals[:, 1]
    keys = [l, r, (l + r) * 0.5, r - l]
    offsets = torch.cat([torch.arange(-w, 0, device=dev), torch.arange(1, w + 1, device=dev)])
    outs = []
    for kv in keys:
        order = torch.sort(kv, stable=True).indices               # rank -> id
        inv = torch.empty_like(order)
        inv[order] = torch.arange(n, device=dev)
        pos = inv[:, None] + offsets[None, :]                       # (n, 2w)
        ok = (pos >= 0) & (pos < n)
        nb = order[pos.clamp(0, n - 1)].to(torch.int32)
        outs.append(torch.where(ok, nb, -1))
    return torch.cat(outs, dim=1)                                   # (n, 8w)


def generate_candidates(
    gen: torch.Generator,
    x: torch.Tensor,
    intervals: torch.Tensor,
    *,
    ef_spatial: int,
    ef_attribute: int,
    nnd_iters: int = 6,
    exact_spatial: bool = False,
) -> torch.Tensor:
    """Paper Algorithm 1: spatial ∪ attribute candidates, self-free.

    ``exact_spatial=True`` swaps NN-descent for the exact KNN oracle."""
    if exact_spatial:
        spa = brute_force_knn(x, ef_spatial).ids
    else:
        spa = nn_descent(gen, x, ef_spatial, iters=nnd_iters).ids
    attr = attribute_candidates(intervals, ef_attribute)
    cand = torch.cat([spa, attr], dim=1)
    self_ids = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)[:, None]
    return torch.where(cand == self_ids, -1, cand)
