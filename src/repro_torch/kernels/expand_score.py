"""Expand-score kernel for the beam-search hot loop (Alg. 4 inner step).

Every fused search step scores the ``C = W·M`` neighbor candidates of the
``W`` expanded frontier nodes against the query: squared L2 between ``q[b]``
and corpus row ``x[idx[b, c]]``, ``+inf`` where ``idx < 0``.  The CUDA kernel
(``csrc/expand_score.cu``) gathers one row per candidate with a warp and
never forms the ``(B, C, d)`` candidate tensor; the plain version
(:func:`expand_score_torch`) walks ``CHUNK``-wide candidate slices, so its
peak intermediate is ``(B, CHUNK, d)``.

Both sum the square differences in one fixed order
(:func:`sq_dist_fixed_order`), the one the kernel's warps use, so the kernel
and the plain version are bitwise equal on any float input.  Against the
reference (``jnp.sum`` over ``d``, XLA's order) they agree bitwise on
integer-valued data, where every sum is exact, and to rounding otherwise.
Per-row results do not depend on ``B``, ``C``, the chunk width or the batch
composition, which lets one mixed-semantics batch return bit-identical
distances to four per-semantics batches.

Also here: the sort-based per-row first-occurrence dedup the search step
uses (plain PyTorch, as it is plain XLA in the reference), and the
quadratic pairwise dedup that is its test oracle.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_lib

LANES = 32
CHUNK = 32          # candidates per slice of the plain version


def sq_dist_fixed_order(diff: torch.Tensor) -> torch.Tensor:
    """Square-difference sum over the last axis in the kernels' order.

    ``d`` is zero-padded to a multiple of 32 and viewed as ``(d/32, 32)``:
    lane ``l`` sums elements ``l, l+32, …`` in sequence, then an xor
    butterfly (offsets 16, 8, 4, 2, 1) combines the 32 lane sums.  Every step
    is a separate elementwise op, so nothing contracts into an FMA."""
    d = diff.shape[-1]
    dp = ((d + LANES - 1) // LANES) * LANES
    if dp != d:
        diff = F.pad(diff, (0, dp - d))
    sq = diff * diff
    sq = sq.view(*sq.shape[:-1], dp // LANES, LANES)
    acc = sq[..., 0, :]
    for i in range(1, dp // LANES):
        acc = acc + sq[..., i, :]
    w = LANES
    while w > 1:
        w //= 2
        acc = acc[..., :w] + acc[..., w:]
    return acc[..., 0]


def expand_score_torch(x: torch.Tensor, idx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`expand_score`: the same arithmetic over
    ``CHUNK``-wide candidate slices (peak intermediate ``(B, CHUNK, d)``)."""
    B, C = idx.shape
    n = x.shape[0]
    q32 = q.to(torch.float32)
    safe = idx.clamp(0, n - 1).long()
    out = torch.empty((B, C), dtype=torch.float32, device=x.device)
    for s in range(0, C, CHUNK):
        rows = x[safe[:, s:s + CHUNK]].to(torch.float32)      # (B, CHUNK, d)
        out[:, s:s + CHUNK] = sq_dist_fixed_order(q32[:, None, :] - rows)
    return torch.where(idx >= 0, out, torch.inf)


def expand_score_cuda(x: torch.Tensor, idx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: one warp per candidate gathers ``x[idx[b, c]]`` and sums
    in the fixed order; ``+inf`` where ``idx < 0``."""
    n, d = x.shape
    B, C = idx.shape
    cuda_lib.require(x, torch.float32, (n, d), "expand_score x")
    cuda_lib.require(idx, torch.int32, (B, C), "expand_score idx")
    cuda_lib.require(q, torch.float32, (B, d), "expand_score q")
    if n == 0:
        raise ValueError("expand_score: empty corpus")
    out = torch.empty((B, C), dtype=torch.float32, device=x.device)
    if B * C == 0:
        return out
    lib = cuda_lib.lib()
    err = lib.repro_expand_score(
        x.data_ptr(), idx.data_ptr(), q.data_ptr(), out.data_ptr(),
        n, d, B, C, cuda_lib.stream_ptr(x))
    cuda_lib.check(err, "expand_score")
    cuda_lib.launches["expand_score"] += 1
    return out


# ------------------------------------------------------------------- dedup
def dedup_first(ids: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """Per row, keep ``flag`` only on the first (lowest-index) flagged slot
    carrying each id: a stable id sort, a run-start mask, and an unsort.

    Unflagged slots neither survive nor suppress later duplicates (they sort
    behind an id sentinel).  The stable sort breaks equal-id ties by slot,
    so "first of each sorted run" is "lowest original index", matching
    :func:`dedup_first_quadratic` bit for bit."""
    sentinel = torch.iinfo(torch.int32).max
    key = torch.where(flag, ids.to(torch.int32), sentinel)
    sk, order = torch.sort(key, dim=-1, stable=True)
    run_start = torch.ones_like(sk, dtype=torch.bool)
    run_start[..., 1:] = sk[..., 1:] != sk[..., :-1]
    keep_sorted = run_start & (sk != sentinel)
    out = torch.empty_like(keep_sorted)
    return out.scatter_(-1, order, keep_sorted)


def dedup_first_quadratic(ids: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """The ``O(C²)`` pairwise-mask dedup: the oracle :func:`dedup_first`
    must match bit for bit."""
    C = ids.shape[-1]
    same = ids[..., :, None] == ids[..., None, :]
    slot = torch.arange(C, device=ids.device)
    earlier = slot[:, None] > slot[None, :]
    return flag & ~torch.any(same & earlier & flag[..., None, :], dim=-1)
