"""Interval-filtered exact top-k in one pass over the corpus.

For each query, the ``k`` smallest squared distances to the objects whose
interval passes the predicate (``is_filter=True``, IF/RF: the object lies
within the query window; ``False``, IS/RS: the object covers it), ascending
under the total order ``(distance, id)`` and padded with ``(+inf, -1)``: the
paper's pre-filter scan and the ground truth, with no ``(nq, nx)`` matrix in
device memory.  Distances are those of ``kernels/l2dist.py``'s plain
version, folded in the same fixed order: the CUDA kernel computes them on
the SIMT tile of ``csrc/sq_dist_tile.cuh``, not on ``pairwise_sq_dist``'s
tensor-core tile.

The CUDA kernel (``csrc/fused_scan.cu``) streams the corpus through shared
memory a 128-row tile at a time and keeps each query's running top-k there;
:func:`filtered_topk_torch` is its plain version, a stable sort and a slice
per corpus slice folded with ``merge_topk``.  Both keep the lower id first
on equal distances, as the reference's oracle (``lax.top_k``) and its
``brute_force`` do, so the two agree bitwise on any input.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.l2dist import BLOCK_COLS, fold_sq_norms, operands, sq_dist_block

MAX_K = 256            # the kernel keeps k entries a query in shared memory
MAX_SPLITS = 32        # corpus ranges a query's lists are merged from (one warp)
QUERY_TILE = 64        # query rows per block of the kernel
CORPUS_TILE = 128      # corpus rows per step of the kernel
BLOCKS_PER_SM = 8      # blocks the wrapper aims to put in flight per SM


def check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"filtered_topk: k = {k} is outside 1..{MAX_K}")


def passes(obj_int: torch.Tensor, q_int: torch.Tensor, is_filter: bool) -> torch.Tensor:
    """``(nq, nx)`` predicate of query windows ``q_int`` against object
    intervals ``obj_int``, compared as float32."""
    o, q = obj_int[None, :, :], q_int[:, None, :]
    if is_filter:
        return (o[..., 0] >= q[..., 0]) & (o[..., 1] <= q[..., 1])
    return (o[..., 0] <= q[..., 0]) & (o[..., 1] >= q[..., 1])


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


def splits_for(nq: int, nx: int, device: torch.device) -> int:
    """Corpus ranges per query tile: enough blocks to fill the card
    (``BLOCKS_PER_SM`` a multiprocessor), at most ``MAX_SPLITS`` and at most
    one a corpus tile.  The answer does not depend on it."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = (nq + QUERY_TILE - 1) // QUERY_TILE
    x_tiles = (nx + CORPUS_TILE - 1) // CORPUS_TILE
    want = (BLOCKS_PER_SM * sms + q_tiles - 1) // q_tiles
    return max(1, min(MAX_SPLITS, x_tiles, want))


def filtered_topk_cuda(q, x, obj_int, q_int, *, is_filter: bool, k: int):
    """CUDA kernel: a block per (64-query tile, corpus range) streams the
    range in 128-row tiles and keeps each query's top-k in shared memory; a
    second kernel merges a query's ranges, one warp a query."""
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
