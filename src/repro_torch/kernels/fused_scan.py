"""Interval-filtered exact top-k in one pass over the corpus.

For each query, the ``k`` smallest squared distances to the objects whose
interval passes the predicate (``is_filter=True``, IF/RF: the object lies
within the query window; ``False``, IS/RS: the object covers it), ascending
under the total order ``(distance, id)`` and padded with ``(+inf, -1)``: the
paper's pre-filter scan and the ground truth, with no ``(nq, nx)`` matrix in
device memory.

:func:`filtered_topk_torch` is the plain version: ``kernels/l2dist.py``'s
plain distance block per corpus slice, a stable sort and a slice, folded
with ``merge_topk``.  The CUDA kernel (``csrc/fused_scan.cu``) computes its
distance tiles on the tensor cores (``csrc/mma_tile.cuh``, the tile of
``pairwise_sq_dist``: 3×TF32 for f32, one bf16 product for bf16), as the
reference's Pallas kernel computes its product on the TPU's matrix unit,
and keeps each query's running top-k in a sorted list per corpus range.
Both keep the lower id first on equal distances, as the reference's oracle
(``lax.top_k``) and its ``brute_force`` do.

The tensor cores sum the inner product in their own order, so the kernel is
held to a stated rule, not to bitwise equality (:func:`rule_violations`):
every kernel distance lies within ``(d + 4)·2⁻²³·(‖q_i‖² + ‖x_j‖²)`` of the
plain one (``l2dist.tolerance``), so with ``tol_i = (d + 4)·2⁻²³·(‖q_i‖² +
max_j ‖x_j‖²)`` the ``+inf`` pattern is the plain version's, the sorted
values agree within ``tol_i``, and every id the kernel returns passes the
predicate and lies within ``2·tol_i`` of the plain k-th distance.  On
integer-valued data with ``|v| ≤ 8`` and ``d ≤ 256`` every sum is exact and
the two agree bitwise, values and ids.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.l2dist import (BLOCK_COLS, fold_sq_norms, operands, sq_dist_block,
                                        tolerance_terms)

MAX_K = 256            # entries of a list: 8 a lane of the kernel's warp
MAX_SPLITS = 32        # corpus ranges a query's lists are merged from (one warp)
QUERY_TILE = 128       # query rows per block of the kernel
CORPUS_TILE = 128      # corpus rows per step of the kernel
BLOCKS_PER_SM = 2      # blocks of the kernel an SM holds (its registers)
FILL = 0.9             # share of the card's block slots the ranges must fill


def check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"filtered_topk: k = {k} is outside 1..{MAX_K}")


def passes(obj_int: torch.Tensor, q_int: torch.Tensor, is_filter: bool) -> torch.Tensor:
    """``(nq, nx)`` predicate of query windows ``q_int`` against object
    intervals ``obj_int``, compared as float32."""
    return pair_passes(obj_int[None, :, :], q_int[:, None, :], is_filter)


def pair_passes(o: torch.Tensor, w: torch.Tensor, is_filter: bool) -> torch.Tensor:
    """The predicate of object intervals ``o`` against query windows ``w``,
    ``(..., 2)`` each, broadcast against each other."""
    if is_filter:
        return (o[..., 0] >= w[..., 0]) & (o[..., 1] <= w[..., 1])
    return (o[..., 0] <= w[..., 0]) & (o[..., 1] >= w[..., 1])


def _intervals(a: torch.Tensor, n: int, name: str) -> torch.Tensor:
    a = a.to(torch.float32).contiguous()
    if tuple(a.shape) != (n, 2):
        raise ValueError(f"filtered_topk {name}: expected shape ({n}, 2), got {tuple(a.shape)}")
    return a


def filtered_topk_torch(q, x, obj_int, q_int, *, is_filter: bool, k: int):
    """Plain version of :func:`filtered_topk_cuda`: per corpus slice of
    ``BLOCK_COLS`` rows, the distance block, the predicate, a stable sort and
    a slice, folded into the running top-k with ``merge_topk``.  Returns
    ``(values (nq, k) f32, ids (nq, k) int32)``."""
    from repro_torch.core.candidates import merge_topk  # core imports the kernels

    check_k(k)
    q, x = operands(q, x, "filtered_topk")
    nq, nx = q.shape[0], x.shape[0]
    obj_int = _intervals(obj_int, nx, "obj_int")
    q_int = _intervals(q_int, nq, "q_int")
    q32 = q.to(torch.float32)
    qn = fold_sq_norms(q32)
    ids = torch.full((nq, k), -1, dtype=torch.int32, device=q.device)
    vals = torch.full((nq, k), torch.inf, dtype=torch.float32, device=q.device)
    for s in range(0, nx, BLOCK_COLS):
        xb = x[s : s + BLOCK_COLS].to(torch.float32)
        db = sq_dist_block(q32, qn, xb, fold_sq_norms(xb))
        db = torch.where(passes(obj_int[s : s + BLOCK_COLS], q_int, is_filter), db, torch.inf)
        v, o = torch.sort(db, dim=1, stable=True)
        take = min(k, xb.shape[0])
        ids, vals = merge_topk(ids, vals, (o[:, :take] + s).to(torch.int32), v[:, :take], k)
    return vals, torch.where(torch.isfinite(vals), ids, -1)


def rule_violations(q, x, obj_int, q_int, *, is_filter: bool, got, want) -> list[str]:
    """The clauses of the kernel's rule that ``got`` breaks against the plain
    version's ``want`` (both ``(values, ids)`` of one call); empty when it
    holds.  With ``tol_i = (d + 4)·2⁻²³·(‖q_i‖² + max_j ‖x_j‖²)``
    (``l2dist.tolerance_terms``, the folded norms):

    (a) the ``+inf`` pattern is equal, and ids are ``-1`` exactly there;
    (b) the sorted values agree elementwise within ``tol_i``;
    (c) the ids of a row are distinct and pass the predicate, and each one's
        plain distance lies within ``tol_i`` of its kernel value and at most
        the plain k-th value + 2·``tol_i``.

    Compared in float64; a block of 1,000 queries at a time."""
    gv, gi = got
    wv = want[0]
    q, x = operands(q, x, "filtered_topk")
    nq, nx = q.shape[0], x.shape[0]
    obj_int = _intervals(obj_int, nx, "obj_int")
    q_int = _intervals(q_int, nq, "q_int")
    if gv.shape != wv.shape or gi.shape != gv.shape or gv.shape[0] != nq:
        return ["(a) the shapes differ"]
    factor, qn, xn = tolerance_terms(q, x)
    tol = factor * (qn.double()[:, None] + (float(xn.max()) if nx else 0.0))
    found = []
    fin = torch.isfinite(gv)
    if not torch.equal(fin, torch.isfinite(wv)) or not torch.equal(gi >= 0, fin):
        found.append("(a) the +inf pattern differs")
    if not bool((gv[:, 1:] >= gv[:, :-1]).all()):
        found.append("(b) the values are not ascending")
    if not bool(((gv.double() - wv.double()).abs() <= tol)[fin & torch.isfinite(wv)].all()):
        found.append("(b) a sorted value lies outside tol_i of the plain one")
    if bool(((gi >= nx) | (gi < -1)).any()):
        return found + ["(c) an id lies outside the corpus"]
    slot = torch.arange(gi.shape[1], device=gi.device)
    key = torch.sort(torch.where(gi >= 0, gi.long(), -1 - slot), dim=1).values   # pads differ
    if bool((key[:, 1:] == key[:, :-1]).any()):
        found.append("(c) an id repeats in a row")
    q32 = q.to(torch.float32)
    for r in range(0, nq, 1000):
        rows = slice(r, r + 1000)
        live = gi[rows] >= 0
        ids = gi[rows].long().clamp_min(0)
        if not bool(pair_passes(obj_int[ids], q_int[rows, None, :], is_filter)[live].all()):
            found.append("(c) an id fails the predicate")
        # each (query, id) pair's plain distance: the plain version's fold
        xs = x[ids].to(torch.float32)                                    # (rows, k, d)
        ip = torch.zeros(ids.shape, dtype=torch.float32, device=q.device)
        for c in range(q.shape[1]):
            ip += q32[rows, c : c + 1] * xs[..., c]
        pd = torch.clamp_min((qn[rows, None] + xn[ids]) - 2.0 * ip, 0.0).double()
        t = tol[rows]
        if not bool(((pd - gv[rows].double()).abs() <= t)[live].all()):
            found.append("(c) an id's plain distance lies outside tol_i of its value")
        if not bool((pd <= wv[rows, -1:].double() + 2 * t)[live].all()):
            found.append("(c) an id lies beyond the plain k-th value + 2 tol_i")
    return sorted(set(found))


def splits_for(nq: int, nx: int, device: torch.device) -> int:
    """Corpus ranges per query tile: the fewest (at most ``MAX_SPLITS``, at
    most one a corpus tile) whose blocks fill at least ``FILL`` of the
    block slots of the waves they take (``BLOCKS_PER_SM`` an SM), else the
    count that fills most.  The blocks of one wave end together, so a last
    wave that is mostly empty costs as much as a full one.  The answer does
    not depend on it."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return splits_for_slots(nq, nx, BLOCKS_PER_SM * sms)


def splits_for_slots(nq: int, nx: int, slots: int) -> int:
    """:func:`splits_for` on a card with ``slots`` block slots."""
    q_tiles = (nq + QUERY_TILE - 1) // QUERY_TILE
    x_tiles = (nx + CORPUS_TILE - 1) // CORPUS_TILE

    def filled(s):
        blocks = q_tiles * s
        return blocks / (-(-blocks // slots) * slots)

    options = range(1, max(1, min(MAX_SPLITS, x_tiles)) + 1)
    return next((s for s in options if filled(s) >= FILL), max(options, key=filled))


def filtered_topk_cuda(q, x, obj_int, q_int, *, is_filter: bool, k: int):
    """CUDA kernel: a block per (128-query tile, corpus range) streams the
    range in 128-row tiles through the tensor cores and keeps each query's
    top-k of the range in a sorted list; a second kernel merges a query's
    ranges, one warp a query."""
    check_k(k)
    q, x = operands(q, x, "filtered_topk")
    (nq, d), nx = q.shape, x.shape[0]
    cuda_lib.require(q, q.dtype, (nq, d), "filtered_topk q")
    cuda_lib.require(x, q.dtype, (nx, d), "filtered_topk x")
    obj_int = _intervals(obj_int, nx, "obj_int")
    q_int = _intervals(q_int, nq, "q_int")
    cuda_lib.require(obj_int, torch.float32, (nx, 2), "filtered_topk obj_int")
    cuda_lib.require(q_int, torch.float32, (nq, 2), "filtered_topk q_int")
    if nx >= 2**31 or nq >= 2**31 // 32:
        raise ValueError(f"filtered_topk: shape ({nq}, {nx}) is beyond the kernel's ids")
    dev = q.device
    vals = torch.full((nq, k), torch.inf, dtype=torch.float32, device=dev)
    ids = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    if nq == 0 or nx == 0:
        return vals, ids
    splits = splits_for(nq, nx, dev)
    part_d = torch.empty((splits, nq, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, nq, k), dtype=torch.int32, device=dev)
    lib = cuda_lib.lib()
    fn = lib.repro_filtered_topk if q.dtype == torch.float32 else lib.repro_filtered_topk_bf16
    err = fn(q.data_ptr(), x.data_ptr(), obj_int.data_ptr(), q_int.data_ptr(),
             part_d.data_ptr(), part_i.data_ptr(), vals.data_ptr(), ids.data_ptr(),
             nq, nx, d, k, int(bool(is_filter)), splits, cuda_lib.stream_ptr(q))
    cuda_lib.check(err, "filtered_topk")
    cuda_lib.launches["filtered_topk"] += 1
    return vals, ids
