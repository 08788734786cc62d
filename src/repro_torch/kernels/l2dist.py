"""Pairwise squared-L2 distances, ``(nq, d) × (nx, d) → (nq, nx)``.

``‖q − x‖² = max((‖q‖² + ‖x‖²) − 2·qᵀx, 0)`` in float32 for float32 or
bfloat16 rows.  :func:`pairwise_sq_dist_torch` is the plain version: it
folds each norm and each inner product over ``d`` from ``k = 0`` upwards,
starting from ``+0``, one separately rounded multiply and add per ``k``
(:func:`fold_sq_norms`, :func:`fold_inner`), and never calls
``torch.matmul``, whose sum order is the library's.

The CUDA kernel (``csrc/l2dist.cu``) runs the inner product on the tensor
cores, as the reference's Pallas kernel runs it on the TPU's matrix unit:
f32 rows through 3×TF32 (each operand split into a TF32 part and a TF32
remainder, three products accumulated in f32), this card's fp32-accurate
form of a tensor-core product; bf16 rows through one bf16 product, exact
in f32.  Its norms are folded in the plain version's order and are
bitwise the plain version's; its inner products are summed in the tensor
cores' order.  So the kernel is held to a stated bound, not to bitwise
equality: elementwise

    |kernel − plain| ≤ (d + 4) · 2⁻²³ · (‖q_i‖² + ‖x_j‖²)

(:func:`tolerance`: the ≈ 2⁻²¹ relative error of 3×TF32 plus ``d`` f32
roundings of either sum, over ``Σ|q_k x_k| ≤ (‖q‖² + ‖x‖²)/2``, times 2 for
the ``−2·ip``).  On integer-valued data with ``|v| ≤ 8`` and ``d ≤ 256``
every product and partial sum is an integer below 2²⁴, the remainders are
0, and the two are bitwise equal.  Against the reference (XLA's sums, a
norm partial per 512-wide ``d`` tile) the plain version agrees to rounding,
and bitwise on small integer data, where every sum is exact.

``kernels/fused_scan.py``'s kernel runs the same tile, and its top-k is
held to the rule this bound implies (``fused_scan.rule_violations``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib

BLOCK_COLS = 8192      # corpus rows per slice of the plain version
MAX_GRID_Y = 65_535    # CUDA's limit on the grid's y dimension (query tiles)
TILE_ROWS = 128        # query rows per block of the kernel


def operands(q: torch.Tensor, x: torch.Tensor, name: str):
    """``q`` and ``x`` in one element type, float32 or bfloat16: a bf16
    operand beside an f32 one is widened to f32, which is exact."""
    for t, what in ((q, "q"), (x, "x")):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name} {what}: expected float32 or bfloat16, got {t.dtype}")
    if q.dtype != x.dtype:
        q, x = q.to(torch.float32), x.to(torch.float32)
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: expected (nq, d) and (nx, d), got "
                         f"{tuple(q.shape)} and {tuple(x.shape)}")
    return q.contiguous(), x.contiguous()


def fold_sq_norms(a32: torch.Tensor) -> torch.Tensor:
    """``‖a_r‖²`` of every row, folded over ``d`` in the kernels' order."""
    acc = torch.zeros(a32.shape[0], dtype=torch.float32, device=a32.device)
    for k in range(a32.shape[1]):
        col = a32[:, k]
        acc = acc + col * col
    return acc


def fold_inner(q32: torch.Tensor, x32: torch.Tensor) -> torch.Tensor:
    """``qᵀx`` as an ``(nq, nx)`` matrix, folded over ``d`` in the kernels'
    order: one ``(nq, nx)`` product and one add per ``k``, never fused."""
    xt = x32.t().contiguous()
    acc = torch.zeros((q32.shape[0], x32.shape[0]), dtype=torch.float32, device=q32.device)
    for k in range(q32.shape[1]):
        acc += q32[:, k : k + 1] * xt[k]
    return acc


def sq_dist_block(q32, qn, x32, xn) -> torch.Tensor:
    """The distance block of f32 rows ``q32`` and ``x32`` with their folded
    norms: ``max((qn + xn) − 2·ip, 0)``, the reference's grouping."""
    d = (qn[:, None] + xn[None, :]) - 2.0 * fold_inner(q32, x32)
    return torch.clamp_min(d, 0.0)


def pairwise_sq_dist_torch(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`pairwise_sq_dist_cuda`, in corpus slices of
    ``BLOCK_COLS`` rows (the peak intermediate is ``(nq, BLOCK_COLS)``)."""
    q, x = operands(q, x, "pairwise_sq_dist")
    q32 = q.to(torch.float32)
    qn = fold_sq_norms(q32)
    out = torch.empty((q.shape[0], x.shape[0]), dtype=torch.float32, device=q.device)
    for s in range(0, x.shape[0], BLOCK_COLS):
        xb = x[s : s + BLOCK_COLS].to(torch.float32)
        out[:, s : s + BLOCK_COLS] = sq_dist_block(q32, qn, xb, fold_sq_norms(xb))
    return out


def tolerance_terms(q: torch.Tensor, x: torch.Tensor) -> tuple[float, torch.Tensor, torch.Tensor]:
    """The terms of :func:`tolerance`: the factor ``(d + 4) · 2⁻²³`` and the
    folded norms ``‖q_i‖²``, ``‖x_j‖²``, for a caller that takes the bound a
    block of rows at a time."""
    q, x = operands(q, x, "pairwise_sq_dist")
    qn, xn = fold_sq_norms(q.to(torch.float32)), fold_sq_norms(x.to(torch.float32))
    return (q.shape[1] + 4) * 2.0**-23, qn, xn


def tolerance(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The elementwise bound of ``|kernel − plain|``, ``(nq, nx)``:
    ``(d + 4) · 2⁻²³ · (‖q_i‖² + ‖x_j‖²)`` with the folded norms."""
    factor, qn, xn = tolerance_terms(q, x)
    return factor * (qn[:, None] + xn[None, :])


def pairwise_sq_dist_cuda(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: one block of 256 threads per ``(128, 128)`` output tile,
    128-byte K-slices of both operands staged through two shared-memory
    stages, the product on the tensor cores (3×TF32 for f32, one bf16
    product for bf16), the norms folded in the plain version's order."""
    q, x = operands(q, x, "pairwise_sq_dist")
    (nq, d), nx = q.shape, x.shape[0]
    cuda_lib.require(q, q.dtype, (nq, d), "pairwise_sq_dist q")
    cuda_lib.require(x, q.dtype, (nx, d), "pairwise_sq_dist x")
    if nx >= 2**31 or (nq + TILE_ROWS - 1) // TILE_ROWS > MAX_GRID_Y:
        raise ValueError(f"pairwise_sq_dist: shape ({nq}, {nx}) is beyond the kernel's grid")
    out = torch.empty((nq, nx), dtype=torch.float32, device=q.device)
    if nq * nx == 0:
        return out
    lib = cuda_lib.lib()
    fn = lib.repro_pairwise_sq_dist if q.dtype == torch.float32 else lib.repro_pairwise_sq_dist_bf16
    err = fn(q.data_ptr(), x.data_ptr(), out.data_ptr(), nq, nx, d, cuda_lib.stream_ptr(q))
    cuda_lib.check(err, "pairwise_sq_dist")
    cuda_lib.launches["pairwise_sq_dist"] += 1
    return out
