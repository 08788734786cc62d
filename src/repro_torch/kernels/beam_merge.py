"""Bitonic partial merge for the fused beam search.

Every search step folds the freshly scored candidates into the sorted
``E``-beam (``E = next_pow2(ef)``):

1. bitonic-sort the ``L`` candidates (padded to a power of two) ascending;
2. keep the best ``E``, reverse them, and take the elementwise minimum
   against the sorted beam: the first stage of a bitonic merge of the
   ``2E`` concatenation, which leaves the ``E`` smallest of the union as a
   bitonic sequence;
3. ``log E`` merge stages re-sort that sequence.

Keys are f32 distances, each carrying one int32 payload (``id << 1 |
expanded`` in the search).  Every comparison uses the total order
``(dist, payload)``, so ties are deterministic.  The network has only
compares and selects: the CUDA kernel (``csrc/beam_merge.cu``), the plain
version here and the reference agree bitwise on any input.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda_lib

PAD_PAYLOAD = -2  # (id=-1) << 1 | 0: what empty beam/candidate slots carry
_MAX_BYTES = 48 * 1024  # (2L + 2E) * 4: the shapes the kernel takes (max(L, E) <= 4096)


def next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def _cmp_swap(d, p, j: int, asc):
    """One compare-exchange stage between lanes ``i`` and ``i ^ j`` under the
    total order ``(d, p)``; ``asc`` (bool or bool tensor) is the direction of
    the block each element belongs to."""
    idx = torch.arange(d.shape[-1], device=d.device)
    is_lo = (idx & j) == 0
    pd = torch.where(is_lo, torch.roll(d, -j, dims=-1), torch.roll(d, j, dims=-1))
    pp = torch.where(is_lo, torch.roll(p, -j, dims=-1), torch.roll(p, j, dims=-1))
    le = (d < pd) | ((d == pd) & (p <= pp))   # self <= partner
    ge = (d > pd) | ((d == pd) & (p >= pp))   # self >= partner
    in_order = torch.where(is_lo, le, ge)     # pair already ascending
    take_partner = in_order != asc
    return torch.where(take_partner, pd, d), torch.where(take_partner, pp, p)


def _bitonic_sort(d, p):
    """Full ascending bitonic sort along the last axis (power-of-two length)."""
    L = d.shape[-1]
    idx = torch.arange(L, device=d.device)
    k = 2
    while k <= L:
        asc = (idx & k) == 0
        j = k // 2
        while j >= 1:
            d, p = _cmp_swap(d, p, j, asc)
            j //= 2
        k *= 2
    return d, p


def _merge_block(beam_d, beam_p, cand_d, cand_p):
    """Merge the sorted beam (..., E) with unsorted candidates (..., L):
    the E smallest of the union, ascending in the ``(d, p)`` order."""
    E = beam_d.shape[-1]
    L = cand_d.shape[-1]
    cand_d, cand_p = _bitonic_sort(cand_d, cand_p)
    if L >= E:
        cand_d = cand_d[..., :E]
        cand_p = cand_p[..., :E]
    else:
        cand_d = torch.nn.functional.pad(cand_d, (0, E - L), value=torch.inf)
        cand_p = torch.nn.functional.pad(cand_p, (0, E - L), value=PAD_PAYLOAD)
    rd = torch.flip(cand_d, dims=(-1,))
    rp = torch.flip(cand_p, dims=(-1,))
    le = (beam_d < rd) | ((beam_d == rd) & (beam_p <= rp))
    md = torch.where(le, beam_d, rd)
    mp = torch.where(le, beam_p, rp)
    j = E // 2
    while j >= 1:
        md, mp = _cmp_swap(md, mp, j, True)
        j //= 2
    return md, mp


def _pad_candidates(cand_d, cand_p):
    """Pad the candidate width to a power of two (pad slots sort last)."""
    L = cand_d.shape[-1]
    Lp = next_pow2(max(L, 2))
    if Lp != L:
        cand_d = torch.nn.functional.pad(cand_d, (0, Lp - L), value=torch.inf)
        cand_p = torch.nn.functional.pad(cand_p, (0, Lp - L), value=PAD_PAYLOAD)
    return cand_d, cand_p


def _check_width(E: int) -> None:
    if E & (E - 1):
        raise ValueError(f"beam width must be a power of two, got {E}")


def beam_merge_torch(beam_d, beam_p, cand_d, cand_p):
    """Plain version: the identical network as PyTorch tensor ops."""
    _check_width(beam_d.shape[-1])
    cand_d, cand_p = _pad_candidates(cand_d, cand_p)
    return _merge_block(beam_d, beam_p, cand_d, cand_p)


def beam_merge_cuda(beam_d, beam_p, cand_d, cand_p):
    """CUDA kernel: the network in registers, one warp a row (several where
    ``max(L, E) > 256``), strides across lanes by warp shuffles."""
    B, E = beam_d.shape
    L_in = cand_d.shape[1]
    _check_width(E)
    cuda_lib.require(beam_d, torch.float32, (B, E), "beam_merge beam_d")
    cuda_lib.require(beam_p, torch.int32, (B, E), "beam_merge beam_p")
    cuda_lib.require(cand_d, torch.float32, (B, L_in), "beam_merge cand_d")
    cuda_lib.require(cand_p, torch.int32, (B, L_in), "beam_merge cand_p")
    L = next_pow2(max(L_in, 2))
    if (2 * L + 2 * E) * 4 > _MAX_BYTES:
        raise ValueError(f"beam_merge: E={E}, L={L} exceed the kernel's shapes")
    out_d = torch.empty((B, E), dtype=torch.float32, device=beam_d.device)
    out_p = torch.empty((B, E), dtype=torch.int32, device=beam_d.device)
    if B == 0:
        return out_d, out_p
    lib = cuda_lib.lib()
    err = lib.repro_beam_merge(
        beam_d.data_ptr(), beam_p.data_ptr(), cand_d.data_ptr(), cand_p.data_ptr(),
        out_d.data_ptr(), out_p.data_ptr(), B, E, L_in, L, 0, cuda_lib.stream_ptr(beam_d))
    cuda_lib.check(err, "beam_merge")
    cuda_lib.launches["beam_merge"] += 1
    return out_d, out_p


# -------------------------------------------------------------- cost model
def merge_comparator_count(ef: int, M: int, *, width: int = 1, fused: bool = True) -> float:
    """Comparator ops per expansion of the beam-maintenance step.

    Legacy: one bitonic sort of the padded ``ef + M`` concatenation per
    single-node expansion.  Fused: a sort of ``L = next_pow2(width·M)``
    candidates plus one partial merge into the ``E = next_pow2(ef)`` beam,
    amortised over ``width`` expansions."""
    def bitonic_sort_cost(n: int) -> float:
        lg = max(int(math.ceil(math.log2(n))), 1)
        return n / 2 * lg * (lg + 1) / 2

    if not fused:
        return bitonic_sort_cost(next_pow2(ef + M))
    E = next_pow2(ef)
    L = next_pow2(max(width * M, 2))
    merge = E + (E / 2) * max(int(math.log2(E)), 1)
    return (bitonic_sort_cost(L) + merge) / width
