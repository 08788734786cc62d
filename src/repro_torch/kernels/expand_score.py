"""Expand-score kernels for the beam-search hot loop (Alg. 4 inner step).

Every fused search step scores the ``C = W·M`` neighbor candidates of the
``W`` expanded frontier nodes against the query: squared L2 between ``q[b]``
and corpus row ``x[idx[b, c]]``, ``+inf`` where ``idx < 0``.  One kernel per
vector plane (core/store.py), each in ``csrc/`` with its plain version here:

* f32 and bf16 planes: :func:`expand_score_cuda` (``csrc/expand_score.cu``,
  two entry points; a bf16 row is widened to f32 in registers);
* int8 plane: :func:`expand_score_q_cuda` (``csrc/expand_score_q.cu``), the
  row dequantized as ``x·scale + zero`` with two roundings;
* pq plane: :func:`expand_score_pq_cuda` (``csrc/expand_score_pq.cu``), the
  ADC sum of ``m`` lookups in per-query ``(m, 256)`` tables that
  :func:`pq_lut` builds once per batch, folded left to right over ``m``.

The kernels gather one row (or code row) per candidate and never form the
``(B, C, d)`` candidate tensor; the plain versions walk candidate slices at
most ``CHUNK`` (and less than ``C``) wide, so their peak intermediate is
``(B, CHUNK, d)``.

The f32, bf16 and int8 versions sum the square differences in one fixed
order (:func:`sq_dist_fixed_order`), the one the kernels' warps use, and the
pq versions fold in one fixed order (:func:`fold_sum_m`), so each kernel and
its plain version are bitwise equal on any input.  Against the reference
(``jnp.sum`` over ``d``, XLA's order) they agree bitwise on integer-valued
data, where every sum is exact, and to rounding otherwise.  Per-row results
do not depend on ``B``, ``C``, the chunk width or the batch composition,
which lets one mixed-semantics batch return bit-identical distances to four
per-semantics batches.

Also here: the legacy baselines that materialise the ``(B, C, d)`` gather
(and, for pq, the decoded ``(n, d)`` corpus) and score with the matmul
identity, kept for the search-step memory profile only; the sort-based
per-row first-occurrence dedup the search step uses (plain PyTorch, as it is
plain XLA in the reference); and the quadratic pairwise dedup that is its
test oracle.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_lib

LANES = 32
CHUNK = 32          # candidates per slice of the plain version
PQ_TABLE = 256      # centroids per pq subspace: one uint8 code each
MAX_SHARED_BYTES = 232_448  # dynamic shared memory one H100 block may use


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


def _chunk(C: int) -> int:
    """Candidates per slice of the plain versions: ``CHUNK``, but never all
    ``C`` at once (that slice would be the ``(B, C, d)`` gather)."""
    return max(min(CHUNK, (C + 1) // 2), 1)


def expand_score_torch(x: torch.Tensor, idx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`expand_score_cuda`: the same arithmetic over
    candidate slices (peak intermediate ``(B, CHUNK, d)``)."""
    B, C = idx.shape
    n = x.shape[0]
    q32 = q.to(torch.float32)
    safe = idx.clamp(0, n - 1).long()
    out = torch.empty((B, C), dtype=torch.float32, device=x.device)
    ch = _chunk(C)
    for s in range(0, C, ch):
        rows = x[safe[:, s:s + ch]].to(torch.float32)          # (B, ch, d)
        out[:, s:s + ch] = sq_dist_fixed_order(q32[:, None, :] - rows)
    return torch.where(idx >= 0, out, torch.inf)


def expand_score_cuda(x: torch.Tensor, idx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: one warp per candidate gathers ``x[idx[b, c]]`` (f32, or
    bf16 widened in registers) and sums in the fixed order; ``+inf`` where
    ``idx < 0``."""
    n, d = x.shape
    B, C = idx.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"expand_score x: expected float32 or bfloat16, got {x.dtype}")
    cuda_lib.require(x, x.dtype, (n, d), "expand_score x")
    cuda_lib.require(idx, torch.int32, (B, C), "expand_score idx")
    cuda_lib.require(q, torch.float32, (B, d), "expand_score q")
    if n == 0:
        raise ValueError("expand_score: empty corpus")
    out = torch.empty((B, C), dtype=torch.float32, device=x.device)
    if B * C == 0:
        return out
    lib = cuda_lib.lib()
    name = "expand_score" if x.dtype == torch.float32 else "expand_score_bf16"
    err = getattr(lib, "repro_" + name)(
        x.data_ptr(), idx.data_ptr(), q.data_ptr(), out.data_ptr(),
        n, d, B, C, cuda_lib.stream_ptr(x))
    cuda_lib.check(err, name)
    cuda_lib.launches[name] += 1
    return out


# ------------------------------------------------------------------- int8
def expand_score_q_torch(x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                         idx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`expand_score_q_cuda`: each gathered int8 row
    is dequantized as ``x·scale`` then ``+ zero`` (two roundings, two ops),
    then summed in the fixed order."""
    B, C = idx.shape
    n = x.shape[0]
    q32 = q.to(torch.float32)
    s32 = scale.to(torch.float32)
    z32 = zero.to(torch.float32)
    safe = idx.clamp(0, n - 1).long()
    out = torch.empty((B, C), dtype=torch.float32, device=x.device)
    ch = _chunk(C)
    for s in range(0, C, ch):
        rows = x[safe[:, s:s + ch]].to(torch.float32) * s32     # (B, ch, d)
        rows = rows + z32
        out[:, s:s + ch] = sq_dist_fixed_order(q32[:, None, :] - rows)
    return torch.where(idx >= 0, out, torch.inf)


def expand_score_q_cuda(x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                        idx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: the f32 kernel's warp-per-candidate gather on an int8
    row, dequantized in registers; ``+inf`` where ``idx < 0``."""
    n, d = x.shape
    B, C = idx.shape
    cuda_lib.require(x, torch.int8, (n, d), "expand_score_q x")
    cuda_lib.require(scale, torch.float32, (d,), "expand_score_q scale")
    cuda_lib.require(zero, torch.float32, (d,), "expand_score_q zero")
    cuda_lib.require(idx, torch.int32, (B, C), "expand_score_q idx")
    cuda_lib.require(q, torch.float32, (B, d), "expand_score_q q")
    if n == 0:
        raise ValueError("expand_score_q: empty corpus")
    out = torch.empty((B, C), dtype=torch.float32, device=x.device)
    if B * C == 0:
        return out
    err = cuda_lib.lib().repro_expand_score_q(
        x.data_ptr(), scale.data_ptr(), zero.data_ptr(), idx.data_ptr(), q.data_ptr(),
        out.data_ptr(), n, d, B, C, cuda_lib.stream_ptr(x))
    cuda_lib.check(err, "expand_score_q")
    cuda_lib.launches["expand_score_q"] += 1
    return out


# --------------------------------------------------------------------- pq
def pq_lut(codebooks: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-query subspace distance tables: ``lut[b, j, k]`` is the squared
    L2 between query ``b``'s ``j``-th subvector and centroid ``k`` of
    subspace ``j``, built once per batch (ADC, Jégou et al. 2011).

    The sum over the ``d/m`` subspace dims is an explicit left-to-right fold
    of separate elementwise adds, never a library reduction, whose strategy
    (and so whose bits) on the card may depend on the tensor's size: every
    entry is then independent of ``B`` and of the batch composition.  The
    fold also never forms the ``(B, m, 256, d/m)`` difference tensor (1.3 GB
    at ``B`` = 10,000, d = 128); its transients are ``(B, m, 256)``."""
    m, _, dsub = codebooks.shape
    B = q.shape[0]
    qs = q.to(torch.float32).reshape(B, m, dsub)
    cb = codebooks.to(torch.float32)
    acc = None
    for t in range(dsub):
        diff = qs[:, :, None, t] - cb[None, :, :, t]             # (B, m, K)
        sq = diff * diff
        acc = sq if acc is None else acc + sq
    return acc


def fold_sum_m(vals: torch.Tensor) -> torch.Tensor:
    """Strict left-to-right sum over the last (subspace) axis: the order of
    the pq kernel's ``__fadd_rn`` chain."""
    out = vals[..., 0]
    for j in range(1, vals.shape[-1]):
        out = out + vals[..., j]
    return out


def expand_score_pq_torch(codes: torch.Tensor, codebooks: torch.Tensor, idx: torch.Tensor,
                          q: torch.Tensor, *, lut: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`expand_score_pq_cuda`: per candidate slice,
    gather the ``(B, ch, m)`` code rows, look them up in the query's tables
    and fold over ``m``."""
    B, C = idx.shape
    n, m = codes.shape
    if lut is None:
        lut = pq_lut(codebooks, q)
    K = lut.shape[-1]
    flat = lut.reshape(B, m * K)
    offs = torch.arange(m, device=codes.device) * K
    safe = idx.clamp(0, n - 1).long()
    out = torch.empty((B, C), dtype=torch.float32, device=codes.device)
    ch = _chunk(C)
    for s in range(0, C, ch):
        rows = codes[safe[:, s:s + ch]].long() + offs              # (B, ch, m)
        vals = torch.gather(flat, 1, rows.reshape(B, -1)).reshape(rows.shape)
        out[:, s:s + ch] = fold_sum_m(vals)
    return torch.where(idx >= 0, out, torch.inf)


def expand_score_pq_cuda(codes: torch.Tensor, codebooks: torch.Tensor, idx: torch.Tensor,
                         q: torch.Tensor, *, lut: torch.Tensor | None = None) -> torch.Tensor:
    """CUDA kernel: one block per query stages its ``(m, 256)`` table in
    shared memory; its threads stride over the candidates, each folding
    ``m`` lookups; ``+inf`` where ``idx < 0``."""
    n, m = codes.shape
    B, C = idx.shape
    if lut is None:
        lut = pq_lut(codebooks, q)
    cuda_lib.require(codes, torch.uint8, (n, m), "expand_score_pq codes")
    cuda_lib.require(lut, torch.float32, (B, m, PQ_TABLE), "expand_score_pq lut")
    cuda_lib.require(idx, torch.int32, (B, C), "expand_score_pq idx")
    if n == 0:
        raise ValueError("expand_score_pq: empty corpus")
    smem = m * PQ_TABLE * 4
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"expand_score_pq: m = {m} needs {smem} bytes of shared memory "
                         f"a block, above the card's {MAX_SHARED_BYTES}")
    out = torch.empty((B, C), dtype=torch.float32, device=codes.device)
    if B * C == 0:
        return out
    err = cuda_lib.lib().repro_expand_score_pq(
        codes.data_ptr(), lut.data_ptr(), idx.data_ptr(), out.data_ptr(),
        n, m, B, C, cuda_lib.stream_ptr(codes))
    cuda_lib.check(err, "expand_score_pq")
    cuda_lib.launches["expand_score_pq"] += 1
    return out


# ------------------------------------------------------------------ legacy
def expand_score_legacy(x: torch.Tensor, idx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Pre-fusion baseline: materialise the ``(B, C, d)`` gather and score
    with the matmul identity.  Allclose only; the memory profile's A/B."""
    n = x.shape[0]
    q32 = q.to(torch.float32)
    qn = (q32 * q32).sum(-1)
    x32 = x.to(torch.float32)
    xn = (x32 * x32).sum(-1)
    safe = idx.clamp(0, n - 1).long()
    rows = x32[safe]                                             # (B, C, d) gather
    ip = torch.einsum("bcd,bd->bc", rows, q32)
    dist = torch.clamp_min(xn[safe] + qn[:, None] - 2.0 * ip, 0.0)
    return torch.where(idx >= 0, dist, torch.inf)


def expand_score_q_legacy(x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                          idx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Pre-fusion baseline on the int8 plane: the dequantized ``(B, C, d)``
    gather and the matmul identity."""
    n = x.shape[0]
    q32 = q.to(torch.float32)
    qn = (q32 * q32).sum(-1)
    safe = idx.clamp(0, n - 1).long()
    rows = x[safe].to(torch.float32) * scale.to(torch.float32) + zero.to(torch.float32)
    xn = (rows * rows).sum(-1)
    ip = torch.einsum("bcd,bd->bc", rows, q32)
    dist = torch.clamp_min(xn + qn[:, None] - 2.0 * ip, 0.0)
    return torch.where(idx >= 0, dist, torch.inf)


def expand_score_pq_legacy(codes: torch.Tensor, codebooks: torch.Tensor, idx: torch.Tensor,
                           q: torch.Tensor) -> torch.Tensor:
    """Pre-fusion baseline on the pq plane: decode the whole corpus to
    ``(n, d)`` f32, then :func:`expand_score_legacy`."""
    n, m = codes.shape
    K, dsub = codebooks.shape[1:]
    flat = codebooks.reshape(m * K, dsub)
    offs = torch.arange(m, device=codes.device) * K
    dec = flat[codes.long() + offs].reshape(n, m * dsub)
    return expand_score_legacy(dec, idx, q)


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
