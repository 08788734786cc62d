"""Unified-prune sweep (paper Alg. 3) over a block of nodes.

For every node ``u`` the candidates are scanned in ascending-distance
order; candidate ``t`` survives unless an already-retained ``w < t``
witnesses it, geometrically (``α²·δ²(t, w) < δ²(u, t)``) and semantically
(``Φ_IF`` / ``Φ_IS``, Def. 3.1).  Nothing of shape ``(·, C, C)`` is formed:
each scan step recomputes the distance row ``δ²(t, ·)`` and the Φ rows for
the current ``t`` only.

The CUDA kernel (``csrc/prune_sweep.cu``) runs the scan per row in one
block, in chunks of 32 candidates whose pairs are computed in parallel
ahead of a short sequential pass over bitmasks; the plain version
:func:`sweep_block` runs it candidate by candidate over the whole batch as
tensor ops.  Every float that enters a comparison is a square-difference sum
in the kernels' fixed order (:func:`sq_dist_fixed_order`), and everything
else is boolean and integer algebra, so the two agree bitwise on any input.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import intervals as iv
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.expand_score import MAX_SHARED_BYTES, sq_dist_fixed_order


def cand_row_dist(xs: torch.Tensor, t: int) -> torch.Tensor:
    """Distance row ``δ²(c_t, c_w)`` for all ``w``: (B, C, d) → (B, C)."""
    return sq_dist_fixed_order(xs - xs[:, t : t + 1, :])


def _alpha2(alpha: float) -> float:
    """``α²`` rounded to float32, as the reference computes it."""
    return float(np.float32(alpha) * np.float32(alpha))


def sweep_block(
    i_u: torch.Tensor,      # (B, 2)  node intervals
    xs: torch.Tensor,       # (B, C, d) candidate vectors (distance-sorted)
    i_c: torch.Tensor,      # (B, C, 2) candidate intervals
    d_uc: torch.Tensor,     # (B, C) sorted δ²(u, ·), +inf pads
    valid: torch.Tensor,    # (B, C) live candidate mask
    overlap: torch.Tensor,  # (B, C) I_u ∩ I_c ≠ ∅ (all-True when not unified)
    *,
    m_if: int,
    m_is: int,
    alpha: float,
    unified: bool,
):
    """Plain version of the Alg. 3 scan; Φ rows computed per step.

    Returns ``(status int32 (B, C), rep_if, rep_is)`` with repair slots
    local to the candidate axis (-1 = kept / invalid)."""
    B, C = d_uc.shape
    dev = d_uc.device
    valid = valid.bool()
    overlap = overlap.bool()
    alpha2 = torch.tensor(_alpha2(alpha), dtype=torch.float32, device=dev)
    col_idx = torch.arange(C, device=dev)[None, :]
    act_if = torch.zeros((B, C), dtype=torch.bool, device=dev)
    act_is = torch.zeros((B, C), dtype=torch.bool, device=dev)
    cnt_if = torch.zeros((B,), dtype=torch.int32, device=dev)
    cnt_is = torch.zeros((B,), dtype=torch.int32, device=dev)
    rep_if = torch.full((B, C), -1, dtype=torch.int32, device=dev)
    rep_is = torch.full((B, C), -1, dtype=torch.int32, device=dev)
    for t in range(C):
        d_row = cand_row_dist(xs, t)
        if unified:
            i_t = i_c[:, t]
            hull_l = torch.minimum(i_u[:, 0], i_t[:, 0])
            hull_r = torch.maximum(i_u[:, 1], i_t[:, 1])
            phi_if = (hull_l[:, None] <= i_c[..., 0]) & (i_c[..., 1] <= hull_r[:, None])
            int_l = torch.maximum(i_u[:, 0], i_t[:, 0])
            int_r = torch.minimum(i_u[:, 1], i_t[:, 1])
            nonempty = int_l <= int_r
            phi_is = (nonempty[:, None] & (i_c[..., 0] <= int_l[:, None])
                      & (i_c[..., 1] >= int_r[:, None]))
        else:
            phi_if = phi_is = torch.ones((B, C), dtype=torch.bool, device=dev)

        s_if = valid[:, t]
        s_is = s_if & overlap[:, t]
        geo = (col_idx < t) & (alpha2 * d_row < d_uc[:, t : t + 1])
        wit_if = geo & act_if & phi_if
        wit_is = geo & act_is & phi_is
        pruned_if = wit_if.any(dim=1)
        pruned_is = wit_is.any(dim=1)
        j_if = wit_if.int().argmax(dim=1).int()   # first witness
        j_is = wit_is.int().argmax(dim=1).int()

        keep_if = s_if & ~pruned_if & (cnt_if < m_if)
        keep_is = s_is & ~pruned_is & (cnt_is < m_is)
        cnt_if = cnt_if + keep_if.int()
        cnt_is = cnt_is + keep_is.int()
        act_if[:, t] = keep_if
        act_is[:, t] = keep_is
        rep_if[:, t] = torch.where(s_if & pruned_if, j_if, -1)
        rep_is[:, t] = torch.where(s_is & pruned_is, j_is, -1)
    status = act_if.int() * iv.FLAG_IF + act_is.int() * iv.FLAG_IS
    return status, rep_if, rep_is


def prune_sweep_torch(i_u, xs, i_c, d_uc, valid, overlap, *, m_if, m_is, alpha, unified):
    """Plain version over the whole batch (:func:`sweep_block`)."""
    return sweep_block(i_u, xs.to(torch.float32), i_c, d_uc, valid, overlap,
                       m_if=m_if, m_is=m_is, alpha=alpha, unified=unified)


def prune_sweep_cuda(i_u, xs, i_c, d_uc, valid, overlap, *, m_if, m_is, alpha, unified):
    """CUDA kernel: one block per row scans the candidates in chunks of 32.
    It stages the row (vectors, intervals, ``d_uc``) in shared memory where
    that fits and reads it through L2 otherwise; the state it always keeps
    there is 4.5 bytes a candidate, so ``C`` is at most 51,536 on an H100
    (``build_exact`` runs it at ``C = n``).  Masks cross into C as int32."""
    B, C, d = xs.shape
    cuda_lib.require(i_u, torch.float32, (B, 2), "prune_sweep i_u")
    cuda_lib.require(xs, torch.float32, (B, C, d), "prune_sweep xs")
    cuda_lib.require(i_c, torch.float32, (B, C, 2), "prune_sweep i_c")
    cuda_lib.require(d_uc, torch.float32, (B, C), "prune_sweep d_uc")
    valid = valid.to(torch.int32).contiguous()
    overlap = overlap.to(torch.int32).contiguous()
    cuda_lib.require(valid, torch.int32, (B, C), "prune_sweep valid")
    cuda_lib.require(overlap, torch.int32, (B, C), "prune_sweep overlap")
    lib = cuda_lib.lib()
    stage = int(lib.repro_prune_sweep_smem(C, d, 1) <= MAX_SHARED_BYTES)
    need = lib.repro_prune_sweep_smem(C, d, stage)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"prune_sweep: C = {C} candidates need {need} bytes of shared "
                         f"memory a block, above the {MAX_SHARED_BYTES} an H100 block may use")
    outs = [torch.empty((B, C), dtype=torch.int32, device=xs.device) for _ in range(3)]
    if B * C == 0:
        return tuple(outs)
    err = lib.repro_prune_sweep(
        i_u.data_ptr(), xs.data_ptr(), i_c.data_ptr(), d_uc.data_ptr(),
        valid.data_ptr(), overlap.data_ptr(), *[o.data_ptr() for o in outs],
        B, C, d, int(m_if), int(m_is), _alpha2(alpha), int(bool(unified)), stage,
        cuda_lib.stream_ptr(xs))
    cuda_lib.check(err, "prune_sweep")
    cuda_lib.launches["prune_sweep"] += 1
    return tuple(outs)
