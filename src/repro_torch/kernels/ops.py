"""Dispatch for the port's kernels, and their launch counters.

Backend policy (:func:`repro_torch.kernels.util.resolve_backend`): ``None``
launches the hand-written CUDA kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors; ``"cuda"`` on CPU tensors raises;
``"torch"`` is an explicit request for the plain version on any device.  A
kernel that fails to build or launch raises: there is no fallback.
"""
from __future__ import annotations

from repro_torch.kernels import beam_merge as beam_merge_mod
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import expand_score as expand_score_mod
from repro_torch.kernels import prune_sweep as prune_sweep_mod
from repro_torch.kernels.util import resolve_backend

# Launch counts of the CUDA kernels since the last reset.
launches = cuda_lib.launches
reset_launches = cuda_lib.reset_launches


def expand_score(x, idx, q, *, backend: str | None = None):
    """Squared L2 between ``q[b]`` and ``x[idx[b, c]]`` (``+inf`` where
    ``idx < 0``)."""
    if resolve_backend(backend, x) == "cuda":
        return expand_score_mod.expand_score_cuda(x, idx, q)
    return expand_score_mod.expand_score_torch(x, idx, q)


def expand_score_plane(plane, idx, q, *, backend: str | None = None):
    """Expand-score against a vector plane (core/store.py).  Only the f32
    plane is ported so far."""
    if plane.tag != "f32":
        raise NotImplementedError(
            f"{plane.tag} plane scoring is not ported yet (ROADMAP.md queue 1, "
            "item 6 'Quantized planes')")
    return expand_score(plane.data, idx, q, backend=backend)


def prune_sweep(
    i_u, xs, i_c, d_uc, valid, overlap,
    *,
    m_if: int,
    m_is: int,
    alpha: float = 1.0,
    unified: bool = True,
    backend: str | None = None,
):
    """Unified interval-aware pruning sweep (Alg. 3) over a node block.

    Returns ``(status int32, rep_if, rep_is)`` with repair slots local to
    the candidate axis."""
    kw = dict(m_if=m_if, m_is=m_is, alpha=alpha, unified=unified)
    if resolve_backend(backend, xs) == "cuda":
        return prune_sweep_mod.prune_sweep_cuda(i_u, xs, i_c, d_uc, valid, overlap, **kw)
    return prune_sweep_mod.prune_sweep_torch(i_u, xs, i_c, d_uc, valid, overlap, **kw)


def beam_merge(beam_d, beam_p, cand_d, cand_p, *, backend: str | None = None):
    """Bitonic partial merge of scored candidates into the sorted beam."""
    if resolve_backend(backend, beam_d) == "cuda":
        return beam_merge_mod.beam_merge_cuda(beam_d, beam_p, cand_d, cand_p)
    return beam_merge_mod.beam_merge_torch(beam_d, beam_p, cand_d, cand_p)
