"""Dispatch for the port's kernels, and their launch counters.

Backend policy (:func:`repro_torch.kernels.util.resolve_backend`): ``None``
launches the hand-written CUDA kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors; ``"cuda"`` on CPU tensors raises;
``"torch"`` is an explicit request for the plain version on any device.  A
kernel that fails to build or launch raises: there is no fallback.
``"legacy"``, where an entry point takes it, runs the pre-fusion baseline in
plain PyTorch on any device (the A/B yardstick of the memory profiles and
the bench); it is taken here, before the policy above, which stays strict.

Each entry carries its kernel's cost (:func:`~repro_torch.kernels.util.
metered`), the one rule for both the dry-run's tally and ``chip_smoke.py``'s
bound column: the products' FLOPs (``2·m·n·d`` a product, whatever route
runs it; none for a kernel without products), its other operations (fp32
arithmetic and compare-exchanges outside the tensor cores) and the bytes it
must move, each input read once and each output written once.  Where they
depend on the data (masked candidates, the sweep's retained pairs) they are
this call's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import beam_merge as beam_merge_mod
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import expand_score as expand_score_mod
from repro_torch.kernels import fused_scan, l2dist
from repro_torch.kernels import prune_sweep as prune_sweep_mod
from repro_torch.kernels.beam_merge import next_pow2
from repro_torch.kernels.util import metered, resolve_backend

# Launch counts of the CUDA kernels since the last reset.
launches = cuda_lib.launches
reset_launches = cuda_lib.reset_launches


# ------------------------------------------------- each kernel's own work
# Each returns ``(product FLOPs, other operations, bytes[, kernel name])``.
def _l2_cost(out, q, x, **_):
    """The ``(nq, nx, d)`` product, and the norms' adds an entry."""
    nq, d = q.shape
    nx = x.shape[0]
    return 2 * nq * nx * d, 3 * nq * nx, (nq + nx) * d * x.element_size() + nq * nx * 4


def _scan_cost(out, q, x, obj_int, q_int, *, k, **_):
    nq, d = q.shape
    n = x.shape[0]
    io = (nq + n) * 2 * 4 + nq * k * 8            # intervals in, top-k out
    return 2 * nq * n * d, 0, (nq + n) * d * x.element_size() + io


def _plane_cost(tag: str, data, idx, q) -> tuple[int, int, int, str]:
    """Scoring ``idx``'s valid rows of a plane: each row read once, its
    operations; the ids in, the distances out and the queries (pq: the
    per-query tables) read.  Also the kernel's name."""
    n_valid = int((idx >= 0).sum())
    B, C = idx.shape
    d = q.shape[1]
    io = B * C * 8 + B * d * 4
    if tag == "pq":
        m = data.shape[1]
        return 0, n_valid * m, n_valid * m + io + B * m * 256 * 4 - B * d * 4, "expand_score_pq"
    if tag == "int8":      # and the scale and zero
        return 0, n_valid * 5 * d, n_valid * d + io + 2 * d * 4, "expand_score_q"
    name = "expand_score_bf16" if data.dtype == torch.bfloat16 else "expand_score"
    return 0, n_valid * 3 * d, n_valid * d * data.element_size() + io, name


def _score_cost(out, x, idx, q, **_):
    return _plane_cost("f32", x, idx, q)


def _score_plane_cost(out, plane, idx, q, **_):
    return _plane_cost(plane.tag, plane.data, idx, q)


def _sweep_cost(out, i_u, xs, i_c, d_uc, valid, overlap, **_):
    """The pairs ``(t, w)`` the scan needs: valid ``t`` against retained
    ``w < t``, a distance each."""
    B, C, d = xs.shape
    kept = (out[0] > 0).int()
    before = torch.cumsum(kept, dim=1) - kept          # retained w < t for each t
    pairs = int((before * valid.int()).sum())
    return 0, pairs * 3 * d, B * (2 + C * d + 2 * C + C + 2 * C) * 4 + 3 * B * C * 4


def _merge_cost(out, beam_d, beam_p, cand_d, cand_p, **_):
    """The bitonic network's compare-exchanges, two operations each."""
    B, E = beam_d.shape
    L = cand_d.shape[1]
    lg, le = next_pow2(max(L, 2)).bit_length() - 1, next_pow2(E).bit_length() - 1
    compare_exchanges = L // 2 * lg * (lg + 1) // 2 + E + E // 2 * le
    return 0, B * compare_exchanges * 2, B * (2 * E + 2 * L) * 4 + B * 2 * E * 4


@metered("pairwise_sq_dist", _l2_cost)
def pairwise_sq_dist(q, x, *, backend: str | None = None):
    """``(nq, d) × (nx, d) → (nq, nx)`` squared L2 distances, float32 out;
    ``q`` and ``x`` are float32 or bfloat16."""
    if resolve_backend(backend, x) == "cuda":
        return l2dist.pairwise_sq_dist_cuda(q, x)
    return l2dist.pairwise_sq_dist_torch(q, x)


@metered("filtered_topk", _scan_cost)
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


@metered("expand_score", _score_cost)
def expand_score(x, idx, q, *, backend: str | None = None):
    """Squared L2 between ``q[b]`` and ``x[idx[b, c]]`` (``+inf`` where
    ``idx < 0``); ``x`` is float32 or bfloat16.  ``backend="legacy"`` is the
    pre-fusion ``(B, C, d)`` gather and matmul identity (allclose only)."""
    if backend == "legacy":
        return expand_score_mod.expand_score_legacy(x, idx, q)
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


@metered("expand_score", _score_plane_cost)
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


@metered("prune_sweep", _sweep_cost)
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
    the candidate axis.  ``backend="legacy"`` materialises the ``(B, C, C)``
    distance and Φ tensors before the scan; all three give the same bits."""
    kw = dict(m_if=m_if, m_is=m_is, alpha=alpha, unified=unified)
    if backend == "legacy":
        return prune_sweep_mod.prune_sweep_legacy(i_u, xs, i_c, d_uc, valid, overlap, **kw)
    if resolve_backend(backend, xs) == "cuda":
        return prune_sweep_mod.prune_sweep_cuda(i_u, xs, i_c, d_uc, valid, overlap, **kw)
    return prune_sweep_mod.prune_sweep_torch(i_u, xs, i_c, d_uc, valid, overlap, **kw)


@metered("beam_merge", _merge_cost)
def beam_merge(beam_d, beam_p, cand_d, cand_p, *, backend: str | None = None):
    """Bitonic partial merge of scored candidates into the sorted beam."""
    if resolve_backend(backend, beam_d) == "cuda":
        return beam_merge_mod.beam_merge_cuda(beam_d, beam_p, cand_d, cand_p)
    return beam_merge_mod.beam_merge_torch(beam_d, beam_p, cand_d, cand_p)
