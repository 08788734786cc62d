"""Streaming index maintenance: batched insert, delete and repair, compact.

The paper builds the UG once; a service sees churn (listings expire, prices
move, validity windows shift).  This module keeps the index up to date in
batches, on the card's kernels, as the reference's ``core/updates.py`` does:

* **slot allocator**: the :class:`~repro_torch.core.store.IndexStore`
  arrays are sized to ``capacity`` slots; ``alive`` marks live nodes and
  ``free`` the slots the allocator may hand out (``masks``/``widen_rows``/
  ``grow`` on the store).  New rows are encoded into every plane under its
  frozen parameters; pruning distances run over the best-precision f32
  view (the rerank plane when present, else the decoded scan plane);
* **insert_batch**: candidate acquisition through the fused beam search
  (spatial) and the four Alg. 1 interval sort orders (attribute),
  ``UnifiedPrune`` for the new rows' out-edges through ``ops.prune_sweep``,
  and reverse offers ``u → new`` appended under the per-semantics degree
  budgets.  The reference runs the offers as a ``lax.scan`` over the batch;
  here they run in rounds by each target's rank in step order, which is the
  same computation (:func:`_offer_rounds`);
* **delete_batch**: tombstones (``alive=False``): search routes through
  them but never surfaces them.  With ``repair=True`` the repair sweep then
  re-wires every in-neighbor of a deleted node through that node's
  neighborhood: bridge candidates scored a row at a time by
  ``ops.expand_score``, witness-filtered by ``ops.prune_sweep``, appended
  under what is left of the degree budgets, a block of rows at a time;
  ``repair_iters > 1`` adds Alg. 2 rounds over the affected rows;
* **compact**: drops dead slots and remaps the graph.

No path re-prunes an existing edge: inserts append reverse offers into free
columns, and repair keeps every surviving edge verbatim and filters only
the bridges it appends.  Every update returns a new :class:`UGIndex` and
leaves the one it was given usable: rows are written into copies, never into
the caller's tensors.  A ``mode="drop"`` scatter of the reference (index
``cap`` means "drop") writes into a scratch row ``cap`` that is sliced off.
Ties are broken as the reference breaks them (stable sorts, ``top_k`` as a
stable ascending sort and a slice), so on exact data the port's arrays equal
the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import intervals as ivm
from repro_torch.core.build import UGConfig, scatter_repairs
from repro_torch.core.entry import build_entry_index, get_entry_batch_flags
from repro_torch.core.index import UGIndex
from repro_torch.core.prune import unified_prune
from repro_torch.core.search import beam_search_flags
from repro_torch.core.store import IndexStore, VectorPlane, as_tensor
from repro_torch.kernels import ops
from repro_torch.kernels.expand_score import dedup_first
from repro_torch.kernels.util import OutputShapes, pad_to, resolve_device

# Query window every finite interval satisfies under IF: acquisition searches
# the IF projection with it, an unconstrained spatial ANN over the live set.
_WIDE = 1e30
_KEY_MAX = torch.iinfo(torch.int32).max


def _set_rows(a: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """A copy of ``a`` with ``a[idx[j]] = vals[j]``; index ``len(a)`` drops
    its row (it lands in a scratch row that is sliced off)."""
    out = torch.cat([a, a.new_zeros((1,) + tuple(a.shape[1:]))])
    out[idx.long()] = vals.to(a.dtype)
    return out[:-1]


# ------------------------------------------------------------------- insert
def _offer_rounds(nbrs, status, ivs, slots, offer_ids, new_iv, *, m_if: int, m_is: int) -> int:
    """Reverse offers ``u → slots[j]`` for every target ``u`` of
    ``offer_ids[j]``, written into ``nbrs``/``status`` in place; returns the
    number of rounds.

    The reference scans the batch (one step per new row; within a step the
    targets are distinct).  A target's row, its IF/IS counts and its first
    free column change only through offers to that target, so each target
    may take its offers in step order independently of the others: round
    ``r`` takes every target's ``r``-th offer, and within a round every
    target appears once, so the scatter is conflict-free.  The rounds are as
    many as the most offers one target gets."""
    cap = nbrs.shape[0]
    b, k_off = offer_ids.shape
    dev = nbrs.device
    tgt = offer_ids.reshape(-1).long()
    step = torch.arange(b, device=dev).repeat_interleave(k_off)
    present = (tgt >= 0) & (slots[step] < cap)
    key_s, order = torch.sort(torch.where(present, tgt, cap), stable=True)   # step order kept
    rank = torch.arange(key_s.numel(), device=dev) - torch.searchsorted(key_s, key_s)
    n_present = int(present.sum())
    rank_s, by_rank = torch.sort(rank[:n_present], stable=True)
    pairs = order[:n_present][by_rank]
    counts = torch.bincount(rank_s).tolist() if n_present else []
    start = 0
    for cnt in counts:
        p = pairs[start:start + cnt]
        start += cnt
        u, j = tgt[p], step[p]
        nid = slots[j]
        urow = nbrs[u]
        ustat = status[u].to(torch.int32)
        already = (urow == nid[:, None]).any(dim=1)
        empty = urow < 0
        has_free = empty.any(dim=1)
        fcol = torch.argmax(empty.to(torch.int32), dim=1)
        cnt_if = (((ustat & ivm.FLAG_IF) > 0) & ~empty).sum(dim=1)
        cnt_is = (((ustat & ivm.FLAG_IS) > 0) & ~empty).sum(dim=1)
        iv_u, niv = ivs[u], new_iv[j]
        overlap = torch.maximum(iv_u[:, 0], niv[:, 0]) <= torch.minimum(iv_u[:, 1], niv[:, 1])
        bits = (torch.where(cnt_if < m_if, ivm.FLAG_IF, 0)
                | torch.where((cnt_is < m_is) & overlap, ivm.FLAG_IS, 0))
        do = ~already & has_free & (bits > 0)
        nbrs[u, fcol] = torch.where(do, nid, urow.gather(1, fcol[:, None])[:, 0])
        status[u, fcol] = torch.where(do, bits.to(status.dtype), status[u, fcol])
    return len(counts)


def _insert_core(store: IndexStore, new_x, new_iv, valid, *, cfg: UGConfig,
                 backend: str | None, search_backend: str | None, ef: int, width: int,
                 stats: dict | None = None):
    """One insert step over a ``b``-row batch; returns ``(store, slots)``.

    ``store`` has materialised masks and enough free slots (``grow``).  Pad
    rows (``valid=False``) flow through every stage with slot ``cap`` and are
    dropped by every scatter, so a padded batch equals the unpadded one.
    Acquisition searches the scan plane (a quantized index acquires through
    the kernels it serves with); pruning and offers use the f32 view."""
    x = store.vectors_f32()
    ivs, nbrs, status = store.intervals, store.nbrs, store.status
    alive, free = store.alive, store.free
    cap = x.shape[0]
    b = new_x.shape[0]
    M = nbrs.shape[1]
    dev = nbrs.device

    # ---- slot allocation: the j-th valid row takes the j-th free slot
    free_slots = torch.full((b,), cap, dtype=torch.int64, device=dev)
    found = torch.nonzero(free).flatten()[:b]
    free_slots[:found.numel()] = found
    rank = torch.cumsum(valid.to(torch.int64), 0) - 1
    slots = torch.where(valid, free_slots[rank.clamp(0, b - 1)], cap).to(torch.int32)
    slot_c = slots.clamp(0, cap - 1)

    alive_old = alive                        # candidates = the pre-insert live set
    new32 = new_x.to(torch.float32)
    x2 = _set_rows(x, slots, new32)
    iv2 = _set_rows(ivs, slots, new_iv)
    alive2 = _set_rows(alive, slots, torch.ones(b, dtype=torch.bool, device=dev))
    free2 = _set_rows(free, slots, torch.zeros(b, dtype=torch.bool, device=dev))

    # ---- planes: new rows encoded under each plane's frozen parameters;
    # an f32 scan plane that is the pruning view takes ``x2`` itself
    if store.plane.tag == "f32" and store.rerank is None:
        plane2, rerank2 = dataclasses.replace(store.plane, data=x2), None
    else:
        plane2 = dataclasses.replace(store.plane, data=_set_rows(
            store.plane.data, slots, store.plane.encode_rows(new32)))
        rerank2 = None if store.rerank is None else dataclasses.replace(store.rerank, data=x2)

    # ---- (1a) spatial candidates: two fused searches of the pre-insert
    # graph, the IF projection under a window every interval satisfies and
    # the IS projection stabbed at the new interval's midpoint
    eidx_old = build_entry_index(ivs, node_mask=alive_old)
    wide = torch.tensor([-_WIDE, _WIDE], dtype=torch.float32, device=dev).expand(b, 2)
    mid = ((new_iv[:, 0] + new_iv[:, 1]) * 0.5).to(torch.float32)
    point = torch.stack([mid, mid], dim=1)
    k_spa = min(cfg.ef_spatial, ef)
    spas = []
    for flag, q_int in ((ivm.FLAG_IF, wide), (ivm.FLAG_IS, point)):
        flags = torch.full((b,), flag, dtype=torch.int32, device=dev)
        res_s = beam_search_flags(
            store, get_entry_batch_flags(eidx_old, q_int, flags, width=width),
            new32, q_int, flags, ef=ef, k=k_spa, backend=search_backend, width=width)
        spas.append(res_s.ids.to(torch.int32))

    # ---- (1b) attribute candidates: the four Alg. 1 sort orders over the
    # live set (dead slots keyed +inf, so they sort behind every rank)
    l_o, r_o = ivs[:, 0], ivs[:, 1]
    l_n, r_n = new_iv[:, 0], new_iv[:, 1]
    pairs = [(l_o, l_n), (r_o, r_n), ((l_o + r_o) * 0.5, (l_n + r_n) * 0.5),
             (r_o - l_o, r_n - l_n)]
    hi = (alive_old.sum() - 1).clamp_min(0)
    w = max(cfg.ef_attribute // 8, 1)
    offs = torch.arange(-w, w + 1, device=dev)
    attrs = []
    for k_old, k_new in pairs:
        key_s, order = torch.sort(torch.where(alive_old, k_old, torch.inf), stable=True)
        pos = torch.searchsorted(key_s, k_new.contiguous(), side="left")
        attr_pos = torch.minimum((pos[:, None] + offs).clamp_min(0), hi)
        attrs.append(order[attr_pos].to(torch.int32))
    cand = torch.cat(spas + attrs, dim=1)
    cand = torch.where((cand >= 0) & alive_old[cand.clamp(0, cap - 1).long()], cand, -1)

    # ---- (2) the new rows' out-edges (fused witness sweep)
    res = unified_prune(slot_c, cand, x2, iv2, m_if=cfg.max_edges_if, m_is=cfg.max_edges_is,
                        alpha=cfg.alpha, unified=cfg.unified, backend=backend)
    keep = min(M, res.order.shape[1])
    score_s, sel = torch.sort(torch.where(res.status > 0, res.dist, torch.inf), dim=1, stable=True)
    sel = sel[:, :keep]
    new_nbrs = torch.where(torch.isfinite(score_s[:, :keep]), res.order.gather(1, sel), -1)
    new_stat = torch.where(new_nbrs >= 0, res.status.gather(1, sel), 0)
    if keep < M:
        new_nbrs = torch.cat([new_nbrs, new_nbrs.new_full((b, M - keep), -1)], dim=1)
        new_stat = torch.cat([new_stat, new_stat.new_zeros((b, M - keep))], dim=1)
    nbrs2 = _set_rows(nbrs, slots, new_nbrs)
    status2 = _set_rows(status, slots, new_stat)

    # ---- (3) reverse offers to the distance-sorted candidate prefix (2M
    # closest), the streaming stand-in for the symmetric KNN of Alg. 1
    k_off = min(2 * M, res.order.shape[1])
    rounds = _offer_rounds(nbrs2, status2, iv2, slots, res.order[:, :k_off], new_iv,
                           m_if=cfg.max_edges_if, m_is=cfg.max_edges_is)
    if stats is not None:
        stats["offer_rounds"] = rounds

    out = store.replace(plane=plane2, rerank=rerank2, intervals=iv2, nbrs=nbrs2,
                        status=status2, entry=build_entry_index(iv2, node_mask=alive2),
                        alive=alive2, free=free2)
    return out, slots


def _rows2d(a, dev, dtype) -> torch.Tensor:
    t = as_tensor(a, dtype, dev)
    return t[None] if t.ndim == 1 else t


def insert_batch(index: UGIndex, new_x, new_intervals, *, valid=None, ef: int | None = None,
                 width: int = 4, backend: str | None = None,
                 search_backend: str | None = None, stats: dict | None = None) -> UGIndex:
    """Insert a batch of objects; returns a new UGIndex.

    ``valid`` masks pad rows of a shape-bucketed batch; ``ef`` is the
    acquisition beam width (default ``max(2·ef_spatial, 48)``); ``backend``
    picks the prune-sweep kernel (default: the config's) and
    ``search_backend`` the acquisition search's kernels (``cuda`` |
    ``torch``, ``None`` = by device).  A ``stats`` dict, where given, gets
    ``offer_rounds``.

    Rows of one batch do not see each other during acquisition: candidates
    and offer targets come from the pre-insert live set.  Keep the batch
    small against the live corpus."""
    dev = index.device
    new_x = _rows2d(new_x, dev, torch.float32)
    new_iv = _rows2d(new_intervals, dev, torch.float32)
    b = new_x.shape[0]
    cfg = index.config
    valid = (torch.ones(b, dtype=torch.bool, device=dev) if valid is None
             else as_tensor(valid, torch.bool, dev).reshape(-1))
    need = int(valid.sum())
    store = index.store.grow(need, cfg.max_edges_if + cfg.max_edges_is)
    if ef is None:
        ef = max(2 * cfg.ef_spatial, 48)
    store2, _ = _insert_core(
        store, new_x, new_iv, valid, cfg=cfg,
        backend=backend if backend is not None else cfg.prune_backend,
        search_backend=search_backend, ef=ef, width=width, stats=stats)
    return index.with_store(store2)


def insert(index: UGIndex, new_x, new_intervals) -> UGIndex:
    """One batched insert with the defaults."""
    return insert_batch(index, new_x, new_intervals)


# ------------------------------------------------------------------- delete
def _merge_repair_rows(u, surv_ids, surv_st, cand, x, ivs, *, m_if, m_is, alpha, unified,
                       backend, M):
    """Witness repair of a block of rows.

    Surviving edges (``surv_ids``/``surv_st``, -1 holes) are kept verbatim.
    The pool (survivors ∪ bridges) runs through the fused Φ sweep, so a
    bridge is accepted only if no closer pool member witnesses it; accepted
    bridges are appended by distance under what is left of the budgets.
    Returns ``(nbrs_rows, stat_rows, w_flat, v_flat)`` with ``(w, v)`` the
    Alg. 2 repair pairs in global ids."""
    res = unified_prune(u, cand, x, ivs, m_if=m_if, m_is=m_is, alpha=alpha,
                        unified=unified, backend=backend)
    st32 = res.status.to(torch.int32)
    surv32 = surv_st.to(torch.int32)
    surv_ok = surv_ids >= 0
    # a bridge is a pool member that survived the sweep and is no existing
    # edge: an (·, P, M) integer compare, nothing of shape (·, C, C)
    is_surv = (res.order[:, :, None] == torch.where(surv_ok, surv_ids, -2)[:, None, :]).any(-1)
    acc0 = (st32 > 0) & ~is_surv & (res.order >= 0)
    bif = acc0 & ((st32 & ivm.FLAG_IF) > 0)
    bis = acc0 & ((st32 & ivm.FLAG_IS) > 0)
    cnt_if = (((surv32 & ivm.FLAG_IF) > 0) & surv_ok).sum(dim=1)
    cnt_is = (((surv32 & ivm.FLAG_IS) > 0) & surv_ok).sum(dim=1)
    if_keep = bif & (torch.cumsum(bif.to(torch.int32), 1) - 1 + cnt_if[:, None] < m_if)
    is_keep = bis & (torch.cumsum(bis.to(torch.int32), 1) - 1 + cnt_is[:, None] < m_is)
    bits = (torch.where(if_keep, ivm.FLAG_IF, 0)
            | torch.where(is_keep, ivm.FLAG_IS, 0)).to(torch.int32)
    bridge_ids = torch.where(bits > 0, res.order, -1)
    # survivors first (their column order and bits), then the accepted
    # bridges; one stable sort compacts the -1 holes out
    ids_cat = torch.cat([surv_ids, bridge_ids], dim=1)
    st_cat = torch.cat([surv32, bits], dim=1)
    prio = torch.arange(ids_cat.shape[1], device=ids_cat.device).expand_as(ids_cat)
    key_s, order = torch.sort(torch.where(ids_cat >= 0, prio, _KEY_MAX), dim=1, stable=True)
    order = order[:, :M]
    dead = key_s[:, :M] == _KEY_MAX
    nb_rows = torch.where(dead, -1, ids_cat.gather(1, order))
    st_rows = torch.where(dead, 0, st_cat.gather(1, order))
    w_flat = torch.cat([res.repair_if.reshape(-1), res.repair_is.reshape(-1)])
    v_flat = torch.cat([torch.where(res.repair_if >= 0, res.order, -1).reshape(-1),
                        torch.where(res.repair_is >= 0, res.order, -1).reshape(-1)])
    return nb_rows, st_rows, w_flat, v_flat


def _repair_blocks(one_block, nbrs, status, rows, block: int):
    """Run ``one_block(u, ok)`` over the ``block``-row tiles of ``rows``
    (``-1`` pads), every tile reading the unmodified ``nbrs``/``status``,
    then scatter the new rows; returns ``(nbrs, status, w, v)``."""
    cap, M = nbrs.shape
    rows_c = rows.clamp(0, cap - 1)
    row_ok = rows >= 0
    nb_new = torch.empty((rows.shape[0], M), dtype=torch.int32, device=nbrs.device)
    st_new = torch.empty_like(nb_new)
    w_w, w_v = [], []
    for s in range(0, rows.shape[0], block):
        u, ok = rows_c[s:s + block], row_ok[s:s + block]
        nb_rows, st_rows, w_flat, v_flat, width = one_block(u)
        # untouched pad rows keep their contents
        nb_new[s:s + block] = torch.where(ok[:, None], nb_rows, nbrs[u.long()])
        st_new[s:s + block] = torch.where(ok[:, None], st_rows, status[u.long()].to(torch.int32))
        # (w, v) layout: [IF half | IS half] per block, blocks in order
        w_w.append(torch.where(ok.repeat_interleave(width).repeat(2), w_flat, -1))
        w_v.append(v_flat)
    tgt = torch.where(row_ok, rows_c, cap)
    return (_set_rows(nbrs, tgt, nb_new), _set_rows(status, tgt, st_new),
            torch.cat(w_w), torch.cat(w_v))


def _repair_core(x, ivs, nbrs, status, del_mask, in_sets, rows, *, m_if: int, m_is: int,
                 alpha: float, unified: bool, backend: str | None, P: int, block: int):
    """Repair round 1: re-wire the touched rows through the deleted nodes'
    neighborhoods, a block of rows at a time.

    For each touched row ``u`` the pool is its surviving out-edges and the
    out-rows and in-neighbor lists of its deleted neighbors (ids only),
    deduped with the sort-based ``dedup_first``, scored a row at a time by
    ``ops.expand_score`` (the ``(B, M+2M², d)`` bridge gather never forms),
    cut to the ``P`` closest and witness-filtered by the fused Φ sweep."""
    cap, M = nbrs.shape

    def one_block(u):
        ul = u.long()
        own = nbrs[ul]
        own_c = own.clamp(0, cap - 1).long()
        own_del = (own >= 0) & del_mask[own_c]
        own_ids = torch.where((own >= 0) & ~own_del, own, -1)
        own_st = torch.where(own_ids >= 0, status[ul], 0)
        bridge = torch.where(own_del[:, :, None],
                             torch.cat([nbrs[own_c], in_sets[own_c]], dim=-1), -1)
        bridge = bridge.reshape(u.shape[0], 2 * M * M)
        bridge = torch.where((bridge >= 0) & ~del_mask[bridge.clamp(0, cap - 1).long()], bridge, -1)
        cand0 = torch.cat([own_ids, bridge], dim=1)
        cand0 = torch.where(cand0 == u[:, None], -1, cand0)
        cand0 = torch.where(dedup_first(cand0, cand0 >= 0), cand0, -1).contiguous()
        # the reference's top_k(-d0, P): a stable ascending sort and a slice
        d0 = ops.expand_score(x, cand0, x[ul], backend=backend)
        vals, sel = torch.sort(d0, dim=1, stable=True)
        cand = torch.where(torch.isfinite(vals[:, :P]), cand0.gather(1, sel[:, :P]), -1)
        out = _merge_repair_rows(u, own_ids, own_st, cand, x, ivs, m_if=m_if, m_is=m_is,
                                 alpha=alpha, unified=unified, backend=backend, M=M)
        return (*out, P)

    return _repair_blocks(one_block, nbrs, status, rows, block)


def _repair_round(x, ivs, nbrs, status, del_mask, repair_sets, rows, *, m_if: int, m_is: int,
                  alpha: float, unified: bool, backend: str | None, block: int):
    """Repair rounds ≥ 2 (Alg. 2 over the affected rows): the pool is the
    current out-edges and the witness repair set, pruned by the fused sweep
    and scattered back."""
    cap, M = nbrs.shape

    def one_block(u):
        ul = u.long()
        own = nbrs[ul]
        own_ids = torch.where((own >= 0) & ~del_mask[own.clamp(0, cap - 1).long()], own, -1)
        own_st = torch.where(own_ids >= 0, status[ul], 0)
        cand = torch.cat([own_ids, repair_sets[ul]], dim=1)
        cand = torch.where((cand >= 0) & ~del_mask[cand.clamp(0, cap - 1).long()], cand, -1)
        cand = torch.where(cand == u[:, None], -1, cand)
        cand = torch.where(dedup_first(cand, cand >= 0), cand, -1)
        out = _merge_repair_rows(u, own_ids, own_st, cand, x, ivs, m_if=m_if, m_is=m_is,
                                 alpha=alpha, unified=unified, backend=backend, M=M)
        return (*out, cand.shape[1])

    return _repair_blocks(one_block, nbrs, status, rows, block)


def _pad_rows_1d(idx: torch.Tensor, block: int) -> torch.Tensor:
    """Row ids padded with ``-1`` to a whole number of blocks."""
    out = torch.full((pad_to(max(idx.numel(), 1), block),), -1, dtype=torch.int32,
                     device=idx.device)
    out[:idx.numel()] = idx
    return out


def repair_deleted(index: UGIndex, *, repair_iters: int = 1, pool: int | None = None,
                   backend: str | None = None, block: int = 256,
                   stats: dict | None = None) -> UGIndex:
    """Detach every tombstoned node that is still routable.

    Re-wires all in-neighbors of tombstoned nodes through the tombstones'
    neighborhoods (surviving edges kept verbatim, witness-filtered bridges
    refill the freed budget), then clears the tombstoned rows and marks
    their slots free.  ``pool`` caps the per-row candidate pool (default
    ``4·M``); ``repair_iters`` adds Alg. 2 witness-repair rounds.  One host
    sync for the touched rows, one for each extra round.  A ``stats`` dict,
    where given, gets ``touched_rows``, ``repair_blocks`` and
    ``repair_rounds``."""
    store = index.store
    alive, free = store.masks()
    cfg = index.config
    cap = store.capacity
    widened = store.widen_rows(cfg.max_edges_if + cfg.max_edges_is)
    nbrs, status = widened.nbrs, widened.status
    x = store.vectors_f32()
    M = nbrs.shape[1]
    del_mask = ~alive & ~free
    backend = backend if backend is not None else cfg.prune_backend
    kw = dict(m_if=cfg.max_edges_if, m_is=cfg.max_edges_is, alpha=cfg.alpha,
              unified=cfg.unified, backend=backend)

    to_del = (nbrs >= 0) & del_mask[nbrs.clamp(0, cap - 1).long()]
    t_idx = torch.nonzero(to_del.any(dim=1) & alive).flatten()
    blocks = rounds = 0
    if t_idx.numel():
        P = pool if pool is not None else min(4 * M, M + 2 * M * M)
        rows = _pad_rows_1d(t_idx, block)
        blocks, rounds = rows.numel() // block, 1
        # in-neighbor lists of the deleted nodes (the other half of their
        # neighborhood): one segment scatter over the edge list
        src = torch.arange(cap, dtype=torch.int32, device=nbrs.device)[:, None].expand_as(nbrs)
        in_sets = scatter_repairs(torch.where(to_del, nbrs, -1).reshape(-1),
                                  torch.where(to_del, src, -1).reshape(-1), cap, M)
        nbrs, status, w_w, w_v = _repair_core(x, store.intervals, nbrs, status, del_mask,
                                              in_sets, rows, P=P, block=block, **kw)
        for _ in range(1, repair_iters):
            rep = scatter_repairs(w_w, w_v, cap, cfg.repair_width)
            a_idx = torch.nonzero((rep >= 0).any(dim=1) & alive).flatten()
            if a_idx.numel() == 0:
                break
            rows = _pad_rows_1d(a_idx, block)
            blocks, rounds = blocks + rows.numel() // block, rounds + 1
            nbrs, status, w_w, w_v = _repair_round(x, store.intervals, nbrs, status, del_mask,
                                                   rep, rows, block=block, **kw)

    if stats is not None:
        stats.update(touched_rows=t_idx.numel(), repair_blocks=blocks, repair_rounds=rounds)
    # detached: clear the dead rows and hand their slots to the allocator
    nbrs = torch.where(del_mask[:, None], -1, nbrs)
    status = torch.where(del_mask[:, None], 0, status)
    return index.with_store(store.replace(nbrs=nbrs, status=status, free=free | del_mask))


def delete_batch(index: UGIndex, ids, *, repair: bool = True, repair_iters: int = 1,
                 pool: int | None = None, backend: str | None = None,
                 block: int = 256, stats: dict | None = None) -> UGIndex:
    """Delete a batch of node ids; returns a new UGIndex.

    The nodes are tombstoned at once (search routes through them but never
    surfaces them; the entry structure is rebuilt over the live nodes).
    With ``repair=True`` the repair sweep then detaches them so their slots
    are reusable; ``repair=False`` leaves that to a later
    :func:`repair_deleted` or :func:`compact`.  Ids outside ``[0, cap)`` are
    ignored; ``stats`` goes to the repair."""
    store = index.store
    cap = store.capacity
    ids = as_tensor(ids, torch.int32, store.device).reshape(-1)
    alive, free = store.masks()
    tgt = torch.where((ids >= 0) & (ids < cap), ids, cap)
    del_mask = _set_rows(torch.zeros(cap, dtype=torch.bool, device=store.device), tgt,
                         torch.ones_like(tgt, dtype=torch.bool)) & alive
    alive2 = alive & ~del_mask
    out = index.with_store(store.replace(
        entry=build_entry_index(store.intervals, node_mask=alive2), alive=alive2, free=free))
    if repair:
        out = repair_deleted(out, repair_iters=repair_iters, pool=pool, backend=backend,
                             block=block, stats=stats)
    return out


# ------------------------------------------------------------------ compact
def compact(index: UGIndex) -> UGIndex:
    """Drop dead slots: gather the live rows, remap neighbor ids, trim the
    trailing all-dead columns, rebuild the entry structure.  Returns a
    static UGIndex.  Unrepaired tombstones are still routable, so the repair
    sweep runs first where any exist."""
    if index.alive is None:
        return index
    alive0, free0 = index.store.masks()
    if bool((~alive0 & ~free0).any()):
        index = repair_deleted(index)
    store = index.store
    cap = store.capacity
    old_ids = torch.nonzero(store.alive).flatten()
    remap = torch.full((cap,), -1, dtype=torch.int32, device=store.device)
    remap[old_ids] = torch.arange(old_ids.numel(), dtype=torch.int32, device=store.device)
    nb = store.nbrs[old_ids]
    nb2 = torch.where(nb >= 0, remap[nb.clamp(0, cap - 1).long()], -1)
    st2 = torch.where(nb2 >= 0, store.status[old_ids], 0)
    _, order = torch.sort((nb2 < 0).to(torch.int32), dim=1, stable=True)    # holes to the back
    nb2, st2 = nb2.gather(1, order), st2.gather(1, order)
    live_cols = max(int((nb2 >= 0).sum(dim=1).max()) if nb2.numel() else 1, 1)
    ivs = store.intervals[old_ids]
    gather_plane = lambda p: None if p is None else dataclasses.replace(p, data=p.data[old_ids])
    return index.with_store(store.replace(
        plane=gather_plane(store.plane), rerank=gather_plane(store.rerank), intervals=ivs,
        nbrs=nb2[:, :live_cols].contiguous(), status=st2[:, :live_cols].contiguous(),
        entry=build_entry_index(ivs), alive=None, free=None))


# ----------------------------------------------------------- memory profile
def update_memory_profile(backend: str, *, b: int = 8, cap: int = 1024, d: int = 16,
                          M: int = 16, P: int = 48, width: int = 4, ef: int = 32,
                          seed: int = 0) -> dict:
    """Run one insert step and one repair sweep at a small size and report
    their intermediates: ``{"peak_bytes", "quadratic_cc", "gather_bcd"}``.

    Every op's output shape is recorded (``kernels/util.py::OutputShapes``).
    ``quadratic_cc`` says whether a square ``(·, C, C)`` tensor appeared over
    the insert pool width, the search candidate width ``W·M``, the repair
    pool ``P`` or the raw bridge width ``M+2M²``; ``gather_bcd`` whether a
    ``(·, W·M, d)`` search gather or a ``(·, M+2M², d)`` bridge gather did.
    The ``(·, P, d)`` and ``(·, C_pool, d)`` gathers that feed the prune
    sweep are its inputs and allowed.  ``backend="torch"`` (and ``"legacy"``)
    run on the CPU, ``"cuda"`` on the card; the fused two must show neither.
    ``"legacy"`` runs the pre-fusion baselines (the legacy sweep, the
    one-node-per-step search, the ``(B, C, d)`` gather scorer) and shows
    both."""
    dev = resolve_device("cuda" if backend == "cuda" else "cpu")
    g = torch.Generator().manual_seed(seed)
    cfg = UGConfig(ef_spatial=16, ef_attribute=32, max_edges_if=M, max_edges_is=M,
                   iterations=1, repair_width=8, exact_spatial=True)
    k_spa = min(cfg.ef_spatial, ef)
    w = max(cfg.ef_attribute // 8, 1)
    c_pool = 2 * k_spa + 4 * (2 * w + 1)      # insert candidate-pool width
    c_search = max(min(width, ef), 1) * M     # fused search candidate width
    c_bridge = M + 2 * M * M                  # raw repair bridge width

    n_live = cap - 2 * b                      # the last 2b slots are free
    x = torch.randn(cap, d, generator=g)
    ints = torch.sort(torch.rand(cap, 2, generator=g), dim=-1).values
    nbrs = torch.randint(0, n_live, (cap, M), generator=g, dtype=torch.int32)
    status = torch.randint(1, 4, (cap, M), generator=g).to(torch.uint8)
    alive = torch.arange(cap) < n_live
    store = IndexStore(plane=VectorPlane("f32", x.to(dev)), rerank=None,
                       intervals=ints.to(dev), nbrs=nbrs.to(dev), status=status.to(dev),
                       entry=None, alive=alive.to(dev), free=(~alive).to(dev))
    new_x = torch.randn(b, d, generator=g).to(dev)
    new_iv = torch.sort(torch.rand(b, 2, generator=g), dim=-1).values.to(dev)
    del_mask = torch.zeros(cap, dtype=torch.bool)
    del_mask[torch.randperm(n_live, generator=g)[:b]] = True
    in_sets = torch.randint(0, n_live, (cap, M), generator=g, dtype=torch.int32)
    rows = torch.randperm(n_live, generator=g)[:b].to(torch.int32)
    with OutputShapes() as rec:
        _insert_core(store, new_x, new_iv, torch.ones(b, dtype=torch.bool, device=dev),
                     cfg=cfg, backend=backend, search_backend=backend, ef=ef, width=width)
        _repair_core(x.to(dev), ints.to(dev), nbrs.to(dev), status.to(dev), del_mask.to(dev),
                     in_sets.to(dev), rows.to(dev), m_if=M, m_is=M, alpha=1.0, unified=True,
                     backend=backend, P=P, block=b)
    banned_sq = {c_pool, c_search, c_bridge, P}
    return {
        "peak_bytes": rec.peak_bytes(),
        "quadratic_cc": any(len(s) >= 2 and s[-1] == s[-2] and s[-1] in banned_sq
                            for s, _, _ in rec.seen),
        "gather_bcd": any(len(s) >= 3 and s[-2:] in ((c_search, d), (c_bridge, d))
                          for s, _, _ in rec.seen),
    }
