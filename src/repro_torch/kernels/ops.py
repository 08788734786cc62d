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
from repro_torch.kernels import fused_scan, l2dist
from repro_torch.kernels import prune_sweep as prune_sweep_mod
from repro_torch.kernels.util import resolve_backend

# Launch counts of the CUDA kernels since the last reset.
launches = cuda_lib.launches
reset_launches = cuda_lib.reset_launches


def pairwise_sq_dist(q, x, *, backend: str | None = None):
    """``(nq, d) × (nx, d) → (nq, nx)`` squared L2 distances, float32 out;
    ``q`` and ``x`` are float32 or bfloat16."""
    if resolve_backend(backend, x) == "cuda":
        return l2dist.pairwise_sq_dist_cuda(q, x)
    return l2dist.pairwise_sq_dist_torch(q, x)


def filtered_topk(q, x, obj_int, q_int, *, is_filter: bool, k: int,
                  backend: str | None = None):
    """Interval predicate, distances and exact top-k in one corpus pass:
    ``(values (nq, k) f32, ids (nq, k) int32)``, ascending under
    ``(distance, id)``, ``+inf``/``-1`` where fewer than ``k`` objects pass.
    ``is_filter=True`` keeps ``obj ⊆ q`` (IF/RF), ``False`` keeps
    ``obj ⊇ q`` (IS/RS); ``k`` is at most ``fused_scan.MAX_K``."""
    fn = fused_scan.filtered_topk_cuda if resolve_backend(backend, x) == "cuda" \
        else fused_scan.filtered_topk_torch
    return fn(q, x, obj_int, q_int, is_filter=is_filter, k=k)


def expand_score(x, idx, q, *, backend: str | None = None):
    """Squared L2 between ``q[b]`` and ``x[idx[b, c]]`` (``+inf`` where
    ``idx < 0``); ``x`` is float32 or bfloat16."""
    if resolve_backend(backend, x) == "cuda":
        return expand_score_mod.expand_score_cuda(x, idx, q)
    return expand_score_mod.expand_score_torch(x, idx, q)


def gather_sq_dist(x, idx, q, *, backend: str | None = None):
    """:func:`expand_score` under its historical name (the reference's
    absorbed ``kernels/gather_dist.py``)."""
    return expand_score(x, idx, q, backend=backend)


def pq_lut(plane, q):
    """Per-query ``(m, 256)`` pq distance tables for ``plane`` (``None`` for
    planes that are not pq).  The fused search loop builds them once per
    batch and hands them to every :func:`expand_score_plane` step."""
    if plane.tag != "pq":
        return None
    return expand_score_mod.pq_lut(plane.codebooks, q)


def expand_score_plane(plane, idx, q, *, backend: str | None = None, lut=None):
    """Expand-score against a vector plane (core/store.py), dispatched on its
    tag: ``f32`` and ``bf16`` go to :func:`expand_score`, ``int8`` to the
    dequantizing kernel, ``pq`` to the table-lookup kernel (``lut`` from
    :func:`pq_lut`, built here when not given).  ``backend="legacy"`` runs
    the pre-fusion baselines, which materialise the ``(B, C, d)`` gather
    (the memory profile's A/B only).  ``plane`` is duck-typed
    (``tag``/``data``/``scale``/``zero``/``codebooks``)."""
    es = expand_score_mod
    if backend == "legacy":
        if plane.tag == "pq":
            return es.expand_score_pq_legacy(plane.data, plane.codebooks, idx, q)
        if plane.tag == "int8":
            return es.expand_score_q_legacy(plane.data, plane.scale, plane.zero, idx, q)
        return es.expand_score_legacy(plane.data, idx, q)
    if plane.tag == "pq":
        fn = es.expand_score_pq_cuda if resolve_backend(backend, plane.data) == "cuda" \
            else es.expand_score_pq_torch
        return fn(plane.data, plane.codebooks, idx, q, lut=lut)
    if plane.tag == "int8":
        fn = es.expand_score_q_cuda if resolve_backend(backend, plane.data) == "cuda" \
            else es.expand_score_q_torch
        return fn(plane.data, plane.scale, plane.zero, idx, q)
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
