"""Interval-aware beam search over the unified graph (paper Alg. 4).

The per-query priority queues of the paper become a fixed-width ``(B, E)``
beam that the whole batch advances together; the visited set is an exact
per-query bitmap updated with one deduplicated scatter-add per step.  Each
step expands the ``W`` best unexpanded frontier nodes of every query,
scores all ``W·M`` of their neighbors through the expand-score kernel (no
``(B, C, d)`` candidate tensor), dedups candidate ids with the sort-based
``dedup_first`` (no ``(B, C, C)`` tensor), and folds them into the sorted
beam with the bitonic partial-merge kernel.

Query semantics are runtime state: every query carries an int32 flag
(``FLAG_IF`` for IF/RF, ``FLAG_IS`` for IS/RS), so one batch can mix all
four semantics.  Every per-row quantity is computed row-independently, so
each row's answer is bitwise independent of the rest of the batch: a mixed
batch returns exactly the per-semantics answers.

A quantized scan plane (bf16, int8, pq) steers the traversal; with an f32
rerank plane the surviving beam is re-scored exactly before the top-k.  On
a store with an ``alive`` mask (streaming updates, ``core/updates.py``)
tombstoned nodes are scored and traversed but never surface.  The
reference's one-node-per-step ``legacy`` loop is not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import intervals as iv
from repro_torch.core.candidates import merge_topk
from repro_torch.core.entry import get_entry_batch_flags
from repro_torch.core.store import PQ_K, VectorPlane, default_pq_m
from repro_torch.kernels import ops
from repro_torch.kernels.beam_merge import PAD_PAYLOAD, next_pow2
from repro_torch.kernels.expand_score import dedup_first, dedup_first_quadratic
from repro_torch.kernels.util import resolve_backend

# 1 << b as int32 words: bit 31 is negative in two's complement, which is
# harmless because adding distinct bits to a word equals or-ing them.
_BITS = (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32)


def bit_table(device) -> torch.Tensor:
    """The 32 one-bit int32 words, on ``device``."""
    return torch.as_tensor(_BITS, device=device)


@dataclasses.dataclass(frozen=True)
class SearchResult:
    ids: torch.Tensor    # (B, k) int32 node ids, ascending distance, -1 pad
    dist: torch.Tensor   # (B, k) f32 squared distances (+inf pad)
    steps: torch.Tensor  # (B,) int32 expansion count
    # Iterations of the batch-synchronous loop (None where not applicable):
    # the batch's latency is iterations × per-step latency.
    iters: int | None = None


def _bitmap_test(bitmap: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per row: is bit ``ids[b, c]`` set in ``bitmap[b]``?  Words are int32
    with the ``id >> 5``, ``id & 31`` layout."""
    ids = ids.clamp(min=0)
    words = torch.gather(bitmap, 1, (ids >> 5).long())
    return ((words >> (ids & 31)) & 1).bool()


def _bitmap_set(bitmap: torch.Tensor, ids: torch.Tensor, fresh: torch.Tensor,
                bits: torch.Tensor) -> None:
    """OR the bits of ``ids[fresh]`` into ``bitmap`` (in place) with one
    scatter-add.  ``fresh`` holds only ids whose bit is clear and no id
    twice in a row, so add == or; the other slots add 0 to word 0.
    ``bits`` is :func:`bit_table` on the bitmap's device."""
    bits = bits[(ids & 31).long()]
    word = torch.where(fresh, ids >> 5, 0).long()
    bitmap.scatter_add_(1, word, torch.where(fresh, bits, 0))


def _make_fused_step(plane, intervals, nbrs, status, q32, q_int, sem_flags, *, W: int, backend: str):
    """Build ``(step, score, merge)`` for the fused hot loop.

    ``step`` advances ``(beam_d, beam_p, visited, steps)`` by one
    multi-expansion; ``visited`` is updated in place.  With
    ``backend="legacy"`` the step scores with the pre-fusion baselines
    (``(B, C, d)`` gather + matmul) and dedups with the ``O(C²)`` pairwise
    mask: the A/B of :func:`search_step_memory_profile` only."""
    n = plane.data.shape[0]
    M = nbrs.shape[1]
    B = q32.shape[0]
    C = W * M
    bits = bit_table(q32.device)
    merge_backend = "torch" if backend == "legacy" else backend
    dedup = dedup_first_quadratic if backend == "legacy" else dedup_first
    # pq plane: the per-query (m, 256) tables are built here, once per
    # batch, and every step reuses them (None for other planes).
    lut = ops.pq_lut(plane, q32)

    def score(ids_c, valid):
        """Squared distances of the masked candidate ids (+inf where invalid)."""
        idx = torch.where(valid, ids_c, -1).to(torch.int32).contiguous()
        return ops.expand_score_plane(plane, idx, q32, backend=backend, lut=lut)

    def merge(beam_d, beam_p, cand_d, cand_p):
        return ops.beam_merge(beam_d, beam_p, cand_d.contiguous(), cand_p.contiguous(),
                              backend=merge_backend)

    def step(beam_d, beam_p, visited, steps):
        # ExtractMin_W: the W best unexpanded entries, ties to the lower slot.
        sel_d = torch.where((beam_p & 1) == 0, beam_d, torch.inf)
        sel_v, sel_idx = torch.sort(sel_d, dim=-1, stable=True)
        sel_idx = sel_idx[:, :W]
        sel_ok = torch.isfinite(sel_v[:, :W])
        u = torch.gather(beam_p >> 1, 1, sel_idx)
        mark = torch.zeros_like(beam_p).scatter_reduce_(
            1, sel_idx, sel_ok.to(torch.int32), "amax")
        beam_p = beam_p | mark

        u_c = u.clamp(0, n - 1).long()
        nb = torch.where(sel_ok[..., None], nbrs[u_c], -1).reshape(B, C)
        st = status[u_c].reshape(B, C)
        present = nb >= 0
        nb_c = nb.clamp(0, n - 1)
        seen = _bitmap_test(visited, nb_c) | ~present

        sem_ok = (st.to(torch.int32) & sem_flags[:, None]) > 0
        pred_ok = iv.predicate_by_flag(sem_flags[:, None], intervals[nb_c.long()],
                                       q_int[:, None, :])
        cand_ok = present & ~seen & sem_ok & pred_ok
        # Mark scored and node-dead candidates, never edge-masked ones; one
        # id may repeat across the W lists, so only its first eligible
        # occurrence is scored and marked (the scatter-add stays an OR).
        valid = dedup(nb_c, cand_ok)
        to_mark = dedup(nb_c, present & ~seen & (cand_ok | ~pred_ok))
        _bitmap_set(visited, nb_c, to_mark, bits)

        cand_d = score(nb_c, valid)
        cand_p = torch.where(valid, nb_c << 1, PAD_PAYLOAD).to(torch.int32)
        beam_d, beam_p = merge(beam_d, beam_p, cand_d, cand_p)
        steps = steps + sel_ok.sum(dim=-1, dtype=torch.int32)
        return beam_d, beam_p, visited, steps

    return step, score, merge


def _beam_search_fused(plane, rerank, intervals, nbrs, status, entry_ids, q_v, q_int,
                       sem_flags, alive, *, ef: int, k: int, max_steps: int, width: int,
                       backend: str) -> SearchResult:
    """Fused multi-expansion Alg. 4.

    The beam is ``E = next_pow2(ef)`` wide (``+inf``/``PAD_PAYLOAD``
    padded) and kept ascending under the total order ``(dist, payload)``;
    each payload packs ``id << 1 | expanded``.  The loop runs while any row
    has an unexpanded finite entry, one host sync per iteration.

    With a rerank plane the scan plane's distances steer the traversal
    only: the surviving beam is re-scored against the exact f32 plane
    (``E`` row fetches per query, once) before the top-k.  ``alive``
    (``(n,)`` bool or ``None``) keeps tombstoned beam entries out of the
    result: the reference's top-k of the negated masked distances becomes a
    stable ascending sort and a slice, which keep the lowest slot first on
    ties, so an all-live mask gives the static path's result bit for bit."""
    n = plane.data.shape[0]
    B = q_v.shape[0]
    dev = q_v.device
    W = max(min(width, ef), 1)
    E = next_pow2(ef)
    nwords = (n + 31) // 32

    q32 = q_v.to(torch.float32).contiguous()
    step, score, merge = _make_fused_step(plane, intervals, nbrs, status, q32, q_int,
                                          sem_flags, W=W, backend=backend)

    ent_valid = entry_ids >= 0
    ent_c = entry_ids.clamp(0, n - 1)
    ent_d = score(ent_c, ent_valid)
    ent_p = torch.where(ent_valid, ent_c << 1, PAD_PAYLOAD).to(torch.int32)
    beam_d = torch.full((B, E), torch.inf, dtype=torch.float32, device=dev)
    beam_p = torch.full((B, E), PAD_PAYLOAD, dtype=torch.int32, device=dev)
    beam_d, beam_p = merge(beam_d, beam_p, ent_d, ent_p)
    visited = torch.zeros((B, nwords), dtype=torch.int32, device=dev)
    _bitmap_set(visited, ent_c, ent_valid, bit_table(dev))

    iters_cap = (max_steps + W - 1) // W
    steps = torch.zeros((B,), dtype=torch.int32, device=dev)
    it = 0
    while it < iters_cap and bool((((beam_p & 1) == 0) & torch.isfinite(beam_d)).any()):
        beam_d, beam_p, visited, steps = step(beam_d, beam_p, visited, steps)
        it += 1

    if rerank is not None:
        # The re-scored beam is no longer sorted: a stable ascending sort
        # and a slice, which keep the lowest slot first on ties as the
        # reference's top_k of the negated distances does.
        all_ids = beam_p >> 1
        ok = torch.isfinite(beam_d)
        idx = torch.where(ok, all_ids, -1).to(torch.int32).contiguous()
        beam_d = ops.expand_score(rerank.data, idx, q32, backend=backend)
        if alive is not None:
            ok = ok & alive[all_ids.clamp(0, n - 1).long()]
        return _masked_topk(all_ids, beam_d, ok, steps, it, k)
    if alive is None:
        dist = beam_d[:, :k]                               # the beam is sorted
        ids = torch.where(torch.isfinite(dist), beam_p[:, :k] >> 1, -1)
        return SearchResult(ids, dist, steps, it)
    # Tombstoned entries routed the search but never surface.
    all_ids = beam_p >> 1
    ok = torch.isfinite(beam_d) & alive[all_ids.clamp(0, n - 1).long()]
    return _masked_topk(all_ids, beam_d, ok, steps, it, k)


def _masked_topk(all_ids, beam_d, ok, steps, it, k: int) -> SearchResult:
    """The ``k`` smallest of ``beam_d`` where ``ok``, ids ``-1`` where fewer
    pass: a stable ascending sort and a slice."""
    vals, sel = torch.sort(torch.where(ok, beam_d, torch.inf), dim=-1, stable=True)
    dist = vals[:, :k]
    ids = torch.where(torch.isfinite(dist), torch.gather(all_ids, 1, sel[:, :k]), -1)
    return SearchResult(ids, dist, steps, it)


def beam_search_flags(store, entry_ids, q_v, q_int, sem_flags, *, ef: int, k: int,
                      max_steps: int = 0, backend: str | None = None,
                      width: int = 4) -> SearchResult:
    """Batched Alg. 4 with runtime per-query semantics over an
    :class:`~repro_torch.core.store.IndexStore`.

    ``entry_ids`` is ``(B,)`` or ``(B, We)`` int32 (Alg. 5); ``max_steps=0``
    derives the default cap 8·ef+32 expansions; ``width`` is the frontier
    width W; ``backend`` picks the kernels (``cuda`` | ``torch``, ``None``
    = by device).  A store's ``alive`` mask keeps tombstoned nodes out of
    the result."""
    backend = resolve_backend(backend, store.nbrs)
    steps_cap = max_steps if max_steps > 0 else 8 * ef + 32
    ent = entry_ids[:, None] if entry_ids.ndim == 1 else entry_ids
    return _beam_search_fused(
        store.plane, store.rerank, store.intervals, store.nbrs, store.status,
        ent.to(torch.int32),
        q_v, q_int.to(torch.float32), sem_flags.to(torch.int32), store.alive,
        ef=ef, k=k, max_steps=steps_cap, width=width, backend=backend,
    )


def beam_search(store, entry_ids, q_v, q_int, *, sem: iv.Semantics, ef: int, k: int,
                max_steps: int = 0, backend: str | None = None, width: int = 4) -> SearchResult:
    """Single-semantics Alg. 4: ``sem`` broadcast to a flag tensor."""
    flags = iv.as_sem_flags(sem, q_v.shape[0], device=q_v.device)
    return beam_search_flags(store, entry_ids, q_v, q_int, flags, ef=ef, k=k,
                             max_steps=max_steps, backend=backend, width=width)


def search_mixed(store, q_v, q_int, sem_flags, *, ef: int, k: int, max_steps: int = 0,
                 backend: str | None = None, width: int = 4) -> SearchResult:
    """Entry acquisition (Alg. 5) + beam search (Alg. 4) for a batch whose
    queries each carry their own semantics.  ``sem_flags`` takes one
    :class:`Semantics`, a per-query sequence, or a ``(B,)`` flag tensor."""
    if store.entry is None:
        raise ValueError(
            "store has no entry structure; build one (make_store/"
            "build_entry_index) or pass entry ids to beam_search_flags")
    flags = iv.as_sem_flags(sem_flags, q_v.shape[0], device=q_v.device)
    entry_ids = get_entry_batch_flags(store.entry, q_int, flags, width=width)
    return beam_search_flags(store, entry_ids, q_v, q_int, flags, ef=ef, k=k,
                             max_steps=max_steps, backend=backend, width=width)


def search(store, q_v, q_int, *, sem: iv.Semantics, ef: int, k: int, max_steps: int = 0,
           backend: str | None = None, width: int = 4) -> SearchResult:
    """Entry acquisition (Alg. 5) + interval-aware beam search (Alg. 4)."""
    return search_mixed(store, q_v, q_int, sem, ef=ef, k=k, max_steps=max_steps,
                        backend=backend, width=width)


# ------------------------------------------------------------ memory profile
class _OutputShapes(TorchDispatchMode):
    """Records ``(shape, dtype, bytes)`` of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.seen.append((tuple(t.shape), t.dtype, t.numel() * t.element_size()))
        return out


def search_step_memory_profile(backend: str = "torch", *, B: int = 8, n: int = 2048,
                               d: int = 24, M: int = 16, width: int = 4, ef: int = 32,
                               dtype: str = "f32", seed: int = 0) -> dict:
    """Run one fused search step on the CPU and report its intermediates.

    The step (and its pq tables) runs under a dispatch mode that records the
    shape of every tensor an op returns.  Returns ``{"peak_bytes",
    "bcd_gather", "cc_pairwise", "decoded_nd"}``: the largest such tensor,
    and whether a ``(B, C, d)`` candidate gather, a ``(·, C, C)`` pairwise
    dedup tensor, or (on an int8 or pq plane) a decoded ``(n, d)`` f32
    corpus appeared.  ``backend="torch"`` runs the plain versions of the
    fused kernels and must show none of them; ``"legacy"`` runs the
    pre-fusion scorers and dedup, which show the gather and the pairwise
    tensor, and on pq the decoded corpus."""
    g = torch.Generator().manual_seed(seed)
    W = max(min(width, ef), 1)
    C = W * M
    E = next_pow2(ef)
    x = torch.randn(n, d, generator=g)
    if dtype == "int8":
        plane = VectorPlane("int8", torch.randint(-127, 128, (n, d), generator=g).to(torch.int8),
                            torch.rand(d, generator=g) + 0.5, torch.randn(d, generator=g))
    elif dtype == "pq":
        m = default_pq_m(d)
        plane = VectorPlane("pq", torch.randint(0, PQ_K, (n, m), generator=g).to(torch.uint8),
                            codebooks=torch.randn(m, PQ_K, d // m, generator=g))
    else:
        plane = VectorPlane.encode(x, dtype)
    intervals = torch.sort(torch.rand(n, 2, generator=g), dim=-1).values
    nbrs = torch.randint(0, n, (n, M), generator=g, dtype=torch.int32)
    status = torch.randint(1, 4, (n, M), generator=g).to(torch.uint8)
    q_v = torch.randn(B, d, generator=g)
    q_int = torch.sort(torch.rand(B, 2, generator=g), dim=-1).values
    flags = torch.randint(1, 3, (B,), generator=g, dtype=torch.int32)
    beam_d = torch.sort(torch.rand(B, E, generator=g), dim=-1).values
    beam_p = torch.randint(0, n, (B, E), generator=g, dtype=torch.int32) << 1
    visited = torch.zeros((B, (n + 31) // 32), dtype=torch.int32)
    steps = torch.zeros((B,), dtype=torch.int32)
    with _OutputShapes() as rec:
        step, _, _ = _make_fused_step(plane, intervals, nbrs, status, q_v, q_int, flags,
                                      W=W, backend=backend)
        step(beam_d, beam_p, visited, steps)
    return {
        "peak_bytes": max(nbytes for _, _, nbytes in rec.seen),
        "bcd_gather": any(len(s) >= 3 and s[-2:] == (C, d) for s, _, _ in rec.seen),
        "cc_pairwise": any(len(s) >= 2 and s[-2:] == (C, C) for s, _, _ in rec.seen),
        "decoded_nd": dtype in ("int8", "pq") and any(
            s[-2:] == (n, d) and dt == torch.float32 for s, dt, _ in rec.seen),
    }


# ----------------------------------------------------------------- exact
def brute_force(x, intervals, q_v, q_int, *, sem: iv.Semantics, k: int,
                block: int = 8192, alive=None) -> SearchResult:
    """Exact predicate-filtered top-k (the ground truth): one matmul-identity
    ``(nq, block)`` distance tile per corpus block, the predicate mask, the
    block's k smallest, folded into the running top-k.  ``alive`` (``(n,)``
    bool) keeps tombstoned and free slots out of the truth set."""
    nq = q_v.shape[0]
    n = x.shape[0]
    dev = x.device
    q32 = q_v.to(torch.float32)
    qn = (q32 * q32).sum(-1)
    is_filter = sem in (iv.Semantics.IF, iv.Semantics.RF)
    ids = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    d = torch.full((nq, k), torch.inf, dtype=torch.float32, device=dev)
    for s in range(0, n, block):
        xb = x[s : s + block].to(torch.float32)
        ib = intervals[s : s + block]
        xn = (xb * xb).sum(-1)
        db = torch.clamp_min(qn[:, None] + xn[None, :] - 2.0 * (q32 @ xb.T), 0.0)
        if is_filter:
            ok = iv.contains(q_int[:, None, :], ib[None, :, :])
        else:
            ok = iv.contains(ib[None, :, :], q_int[:, None, :])
        if alive is not None:
            ok = ok & alive[None, s : s + block]
        db = torch.where(ok, db, torch.inf)
        vals, idx = torch.sort(db, dim=-1, stable=True)
        take = min(k, xb.shape[0])
        ids, d = merge_topk(ids, d, (idx[:, :take] + s).to(torch.int32), vals[:, :take], k)
    ids = torch.where(torch.isfinite(d), ids, -1)
    return SearchResult(ids, d, torch.zeros((nq,), dtype=torch.int32, device=dev))
