"""Distributed (row-sharded) unified index: the production serving path.

The corpus is sharded row-wise over the index axes of a
:class:`~repro_torch.launch.mesh.Mesh`.  Structural heredity (Thm 3.5/4.1)
is what makes shard-local graphs sound: each shard's sub-index is a valid
unified graph over its rows, so shard-local beam search plus a global top-k
merge is a correct decomposition of the query.

A :class:`ShardedIndex` is the same :class:`IndexStore` the single-host path
serves, holding this process's rows (all of them in one process), with the
shard-local → global id map; quantization parameters are shared by every
shard.  A process holds its shards' rows one shard after another and runs
them one after another.

Merge schedule:

* flat: one gather of the per-shard top-k over every index axis, then a
  stable sort of the shard-major concatenation;
* hierarchical: the inner axis first, so only ``k`` candidates per pod
  cross the outer (``pod``) axis.

Construction: :func:`build_sharded_store` builds every shard's graph on the
device: the own-shard ring-KNN bootstrap (:func:`_ring_knn_step_fn`),
shard-local attribute candidates, and the same prune/repair iterations the
single-host build runs (``build.refine_candidates``).
:func:`build_sharded_index_host` is the serial reference (one ``build_ug``
a shard) the parity checks compare against.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import intervals as iv
from repro_torch.core.build import build_ug, refine_candidates
from repro_torch.core.candidates import _smallest, attribute_candidates, merge_topk
from repro_torch.core.entry import build_entry_index, get_entry_batch_flags
from repro_torch.core.prune import squared_dist
from repro_torch.core.search import beam_search_flags
from repro_torch.core.store import (
    IndexStore, VectorPlane, as_tensor, quantization_params, train_pq_codebooks,
)
from repro_torch.distributed import all_gather, all_reduce_max, ring_streamed_map
from repro_torch.kernels.util import no_tf32, resolve_device
from repro_torch.launch.mesh import Mesh

# Distance-matrix elements the ring scores at once (a 2 GB f32 block): at
# 1M rows the whole (rows, block) matrix of one shard would be 250 GB.
_RING_CHUNK_ELEMS = 1 << 29


@dataclasses.dataclass(frozen=True)
class ShardedIndex:
    """This process's rows of a row-sharded :class:`IndexStore` and their
    global ids.

    ``store`` carries ``entry=None`` (each shard builds its entry structure
    over its own rows at search time) and ``alive=None`` (liveness is
    ``global_ids >= 0``: a pad or shard-level tombstone has gid ``-1``)."""

    store: IndexStore
    global_ids: torch.Tensor  # (rows,) int32 shard-local row -> global id, -1 = pad
    mesh: Mesh


def _local_rows(mesh: Mesh, index_axes, total: int) -> torch.Tensor:
    """Row numbers, in the global sharded order, of this process's shards."""
    shards = mesh.local_shards(index_axes)
    n_shards = int(np.prod([mesh.size(a) for a in index_axes]))
    if total % n_shards:
        raise ValueError(f"{total} rows do not split into {n_shards} shards")
    per = total // n_shards
    rows = np.concatenate([np.arange(s * per, (s + 1) * per) for s in shards])
    return torch.as_tensor(rows, device=mesh.device)


def shard_index(
    mesh: Mesh,
    index_axes: Sequence[str],
    x,
    intervals,
    nbrs,
    status,
    global_ids,
    *,
    dtype: str = "f32",
    rerank: bool = False,
    qparams=None,
) -> ShardedIndex:
    """This process's rows of host arrays (all ``S·per`` rows, in shard
    order) as a :class:`ShardedIndex` on ``mesh.device``.

    ``dtype``/``rerank`` encode the vector planes as the single-host store
    does; quantization parameters come from the real rows of every shard
    (``global_ids >= 0``: zero pad rows would widen the int8 ranges), or
    from ``qparams``."""
    dev = mesh.device
    x = as_tensor(x, torch.float32, dev)
    gids = as_tensor(global_ids, torch.int32, dev)
    if dtype in ("int8", "pq") and qparams is None:
        xr = x[gids >= 0]
        qparams = quantization_params(xr) if dtype == "int8" else train_pq_codebooks(xr)
    rows = _local_rows(mesh, index_axes, x.shape[0])
    xl = x[rows]
    store = IndexStore(
        plane=VectorPlane.encode(xl, dtype, qparams),
        rerank=VectorPlane.encode(xl, "f32") if rerank else None,
        intervals=as_tensor(intervals, torch.float32, dev)[rows],
        nbrs=as_tensor(nbrs, torch.int32, dev)[rows],
        status=as_tensor(status, torch.uint8, dev)[rows],
        entry=None,
    )
    return ShardedIndex(store, gids[rows], mesh)


def _local_search(store: IndexStore, gids, q_v, q_int, sem_flags, *, ef: int, k: int,
                  backend: str | None, width: int, max_steps: int = 0):
    """One shard's search, as the reference runs it inside ``shard_map``:
    an entry structure over the shard's live rows, Alg. 5, Alg. 4 with the
    same liveness mask, and the ids mapped to global ids.

    Rows with gid ``< 0`` (pads, shard-level tombstones) are kept out of the
    entry structure, so Alg. 5 never certifies them (Lemma 4.3), and out of
    the result; they still route traffic through their edges.  ``max_steps``
    caps the expansions (0: ``beam_search_flags``'s default)."""
    alive = gids >= 0
    eidx = build_entry_index(store.intervals, node_mask=alive)
    st = store.replace(entry=eidx, alive=alive)
    entry = get_entry_batch_flags(eidx, q_int, sem_flags, width=width)
    res = beam_search_flags(st, entry, q_v, q_int, sem_flags, ef=ef, k=k,
                            max_steps=max_steps, backend=backend, width=width)
    nloc = store.capacity
    g = torch.where(res.ids >= 0, gids[res.ids.clamp(0, nloc - 1).long()], -1)
    return g.to(torch.int32), res.dist


def _merge_dims(ids, dist, dims: tuple[int, ...], k: int):
    """Merge the per-shard top-k held along ``dims`` of ``(..., B, k)``
    tensors: per query, a stable sort of the shard-major concatenation (as
    the reference's ``argsort``), the first ``k`` kept; ``dims`` keep
    extent 1."""
    lead = ids.ndim - 2
    rest = [d for d in range(lead) if d not in dims]
    perm = rest + [lead] + list(dims) + [lead + 1]
    gi = ids.permute(perm)
    gd = dist.permute(perm)
    shape = gi.shape[: len(rest) + 1]
    gi = gi.reshape(*shape, -1)
    gd, order = torch.sort(gd.reshape(*shape, -1), dim=-1, stable=True)
    gi = torch.gather(gi, -1, order[..., :k])
    gd = gd[..., :k]
    for d in sorted(dims):
        gi, gd = gi.unsqueeze(d), gd.unsqueeze(d)
    return gi, gd


def _gather_dim(t: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """``t`` with dimension ``dim`` (this process's shards of ``axis``)
    widened to the whole axis, in the axis's order."""
    g = all_gather(t, mesh, axis)                       # (procs, *t.shape)
    g = g.movedim(0, dim)                               # procs just before the local shards
    return g.reshape(*t.shape[:dim], -1, *t.shape[dim + 1:])


def make_sharded_search_fn(
    mesh: Mesh,
    *,
    index_axes: Sequence[str] = ("data",),
    replicated_axes: Sequence[str] = ("model",),
    sem: iv.Semantics = iv.Semantics.IF,
    ef: int = 64,
    k: int = 10,
    hierarchical: bool = True,
    backend: str | None = None,
    width: int = 4,
    mixed: bool = False,
    plane_tag: str = "f32",
    has_rerank: bool = False,
    max_steps: int = 0,
) -> Callable:
    """The sharded search step over a :class:`ShardedIndex`.

    Every shard runs Alg. 5 + Alg. 4 on its rows through the same
    store-based ``beam_search_flags`` the single-host path serves, then the
    per-shard top-k are merged across the index axes.  With
    ``hierarchical=True`` and two index axes (pod, data) the merge reduces
    along the inner axis first.  ``backend``/``width`` select the
    shard-local search's kernels and frontier width, ``max_steps`` caps
    its expansions (0: ``beam_search_flags``'s default).  ``replicated_axes``
    hold replicas, which add no shards.

    With ``mixed=True`` the function takes a trailing ``(B,)`` int32
    semantic-flag tensor; otherwise the flags are ``sem``'s.  ``plane_tag``
    and ``has_rerank`` declare the store's layout; a store of another
    layout raises.  The queries are the same on every process, and so are
    the returned ``(ids, dist)``."""
    index_axes = tuple(index_axes)
    for a in index_axes:
        if a not in mesh.axes:
            raise ValueError(f"index axis {a!r} is not an axis of the mesh {mesh.axes}")
    local = tuple(mesh.local(a) for a in index_axes)

    def sharded(sidx: ShardedIndex, q_v, q_int, sem_flags):
        st = sidx.store
        if st.plane.tag != plane_tag or (st.rerank is not None) != has_rerank:
            raise ValueError(
                f"store holds a {st.plane.tag} plane (rerank {st.rerank is not None}); "
                f"the step was made for {plane_tag} (rerank {has_rerank})")
        n_local = int(np.prod(local))
        outs = [_local_search(store, gids, q_v, q_int, sem_flags, ef=ef, k=k,
                              backend=backend, width=width, max_steps=max_steps)
                for store, gids in (local_shard_view(sidx, s, n_local) for s in range(n_local))]
        ids = torch.stack([o[0] for o in outs]).reshape(*local, *outs[0][0].shape)
        dist = torch.stack([o[1] for o in outs]).reshape(*local, *outs[0][1].shape)
        m = len(index_axes)
        if hierarchical:
            # innermost (fast, intra-pod) axis first, then the outer axes
            for j in reversed(range(m)):
                ids = _gather_dim(ids, mesh, index_axes[j], j)
                dist = _gather_dim(dist, mesh, index_axes[j], j)
                ids, dist = _merge_dims(ids, dist, (j,), k)
        else:
            for j in range(m):
                ids = _gather_dim(ids, mesh, index_axes[j], j)
                dist = _gather_dim(dist, mesh, index_axes[j], j)
            ids, dist = _merge_dims(ids, dist, tuple(range(m)), k)
        return ids.reshape(ids.shape[m:]), dist.reshape(dist.shape[m:])

    if mixed:
        def fn(sidx, q_v, q_int, sem_flags):
            return sharded(sidx, q_v, q_int, sem_flags.to(torch.int32))
    else:
        def fn(sidx, q_v, q_int):
            flags = iv.as_sem_flags(sem, q_v.shape[0], device=q_v.device)
            return sharded(sidx, q_v, q_int, flags)
    return fn


def local_shard_view(sidx: ShardedIndex, s: int, n_shards: int):
    """Shard ``s``'s row block of the ``n_shards`` this process holds, as a
    standalone ``(IndexStore, global_ids)`` pair (rows ``[s·per,
    (s+1)·per)``; quantization parameters shared).  Searching it alone
    reproduces exactly what shard ``s`` computes in the sharded step."""
    cap = sidx.store.capacity
    if cap % n_shards:
        raise ValueError(f"capacity {cap} not divisible by {n_shards} shards")
    per = cap // n_shards
    sl = slice(s * per, (s + 1) * per)
    st = sidx.store
    cut = lambda pl: None if pl is None else dataclasses.replace(pl, data=pl.data[sl])
    store = IndexStore(
        plane=cut(st.plane), rerank=cut(st.rerank),
        intervals=st.intervals[sl], nbrs=st.nbrs[sl], status=st.status[sl], entry=None,
    )
    return store, sidx.global_ids[sl]


def make_shard_probe_fns(
    sidx: ShardedIndex,
    n_shards: int,
    *,
    ef: int = 64,
    k: int = 10,
    backend: str | None = None,
    width: int = 4,
) -> list[Callable]:
    """Per-shard local-search callables for straggler probing.

    Shard ``s``'s callable runs the same shard-local program the sharded
    step runs (entry structure over its own rows, ``beam_search_flags``, gid
    mapping) on shard ``s``'s row block alone, so timing one call isolates
    that shard's step cost.  These are the callables
    :meth:`~repro_torch.serve.runtime.FleetServeMonitor.probe` times.
    Returns a list of ``fn(q_v, q_int, sem_flags) -> (global_ids, dist)``."""
    def bind(store, gids):
        return lambda q_v, q_int, sem_flags: _local_search(
            store, gids, q_v, q_int, sem_flags.to(torch.int32), ef=ef, k=k,
            backend=backend, width=width)

    return [bind(*local_shard_view(sidx, s, n_shards)) for s in range(n_shards)]


# --------------------------------------------------------------------------
# Ring-streamed exact KNN (distributed candidate bootstrap)
# --------------------------------------------------------------------------
def _smallest_stable(d: torch.Tensor, k: int):
    """The ``k`` smallest of each row in ascending order, ties to the lower
    column: what a stable sort gives (``lax.top_k`` of ``-d`` in the
    reference), without sorting whole rows.

    ``torch.topk`` finds the k-th value; where no other entry equals it, the
    picks are exactly the entries up to it, ordered here by (value,
    column).  Rows with more ties at the k-th value than places left are
    stably sorted in full."""
    if k >= d.shape[-1]:
        return _smallest(d, k)
    vals, idx = torch.topk(d, k, dim=-1, largest=False, sorted=False)
    kth = vals.amax(dim=-1, keepdim=True)
    tied = (d <= kth).sum(dim=-1) > k
    idx, o = torch.sort(idx, dim=-1)
    vals, o2 = torch.sort(torch.gather(vals, -1, o), dim=-1, stable=True)
    idx = torch.gather(idx, -1, o2)
    rows = torch.nonzero(tied).flatten()
    if rows.numel():
        vals[rows], idx[rows] = _smallest(d[rows], k)
    return vals, idx


def _fold_block(x, gids, me, blk_x, blk_ids, best_i, best_d, k: int, same_shard_of):
    """Score this shard's rows against one visiting block and fold the
    ``k`` best into the running top-k (``merge_topk``: the running best
    ahead of the block).

    The reference scores every column and masks: pads, the row itself and,
    with ``same_shard_of``, other shards' rows.  Here the columns masked for
    every row are dropped first (order kept, so ties still go to the lower
    column) and a block with none left is skipped; its candidates would all
    be ``-1``/``+inf``, which leave a merged top-k as it is.  The rows are
    scored in chunks."""
    ok = blk_ids >= 0
    if same_shard_of is not None:
        ok = ok & ((blk_ids % same_shard_of) == me)
        pool = blk_ids // same_shard_of                 # shard-local ids
    else:
        pool = blk_ids
    cols = torch.nonzero(ok).flatten()
    if cols.numel() == 0:
        return best_i, best_d
    bx, bid, bpool = blk_x[cols], blk_ids[cols], pool[cols]
    take = min(k, cols.numel())
    step = max(1, _RING_CHUNK_ELEMS // cols.numel())
    out_i, out_d = torch.empty_like(best_i), torch.empty_like(best_d)
    for r in range(0, x.shape[0], step):
        d = squared_dist(x[r:r + step], bx)
        d.masked_fill_(bid[None, :] == gids[r:r + step, None], torch.inf)
        vals, idx = _smallest_stable(d, take)
        cand = torch.where(torch.isfinite(vals), bpool[idx], -1).to(torch.int32)
        out_i[r:r + step], out_d[r:r + step] = merge_topk(
            best_i[r:r + step], best_d[r:r + step], cand, vals, k)
    return out_i, out_d


def _ring_knn_step_fn(mesh: Mesh, axis: str, k: int, *, same_shard_of: int | None = None):
    """The ring pass: every shard scores its rows against the visiting
    block and folds the result into its running top-k; the block then moves
    one hop around the ring.

    ``same_shard_of=None`` keeps every candidate (global exact KNN);
    ``same_shard_of=S`` keeps only candidates of the caller's own shard
    under the round-robin layout (``gid % S == me``) and returns their
    shard-local ids (``gid // S``): the bootstrap of the on-device sharded
    build, where a shard's graph may only reference its own rows.  The
    returned ``ring(x, gids)`` takes and gives this process's rows."""

    def ring(x, gids):
        no_tf32()
        L = mesh.local(axis)
        nloc = x.shape[0] // L
        xb = x.to(torch.float32).reshape(L, nloc, -1)
        gb = gids.to(torch.int32).reshape(L, nloc)
        me0 = mesh.start(axis)

        def fold(acc, visiting, src):
            s, bi, bd = acc
            bi, bd = _fold_block(xb[s], gb[s], me0 + s, *visiting, bi, bd, k, same_shard_of)
            return s, bi, bd

        init = [(s, torch.full((nloc, k), -1, dtype=torch.int32, device=x.device),
                 torch.full((nloc, k), torch.inf, dtype=torch.float32, device=x.device))
                for s in range(L)]
        accs = ring_streamed_map((xb, gb), mesh, axis, fold, init)
        return torch.cat([a[1] for a in accs]), torch.cat([a[2] for a in accs])

    return ring


def make_ring_knn_fn(mesh: Mesh, *, axis: str = "data", k: int = 32) -> Callable:
    """Exact KNN graph over a row-sharded corpus through a ring of hops.

    Each step every shard scores its rows against the visiting block and
    folds the result into its running top-k; the block then moves one hop.
    After ``size`` steps every pair has been scored.  Returns ``fn(x,
    gids) -> (ids, dist)`` over this process's rows (global ids, ``-1`` pad
    rows never chosen)."""
    return _ring_knn_step_fn(mesh, axis, k)


# --------------------------------------------------------------------------
# Construction
# --------------------------------------------------------------------------
def _round_robin_layout(n: int, S: int):
    """Round-robin partition: shard ``s`` slot ``j`` ↔ global id ``s + j·S``
    (the host reference's).  Returns the flat ``(S·per,)`` gid array with
    ``-1`` pads (at most one a shard) and ``per``."""
    per = (n + S - 1) // S
    gid = (np.arange(S)[:, None] + np.arange(per)[None, :] * S).reshape(-1)
    return np.where(gid < n, gid, -1).astype(np.int32), per


def build_sharded_store(
    mesh: Mesh,
    x,
    intervals,
    cfg,
    *,
    index_axes: Sequence[str] = ("data",),
    dtype: str = "f32",
    rerank: bool = False,
    backend: str | None = None,
    progress: Callable[[str], None] | None = None,
) -> ShardedIndex:
    """On-device sharded build: this process builds the graphs of its
    shards.

    Per shard: the own-shard ring-KNN bootstrap (exact KNN over the shard's
    rows through the ring; no shard holds more than one visiting block)
    supplies the spatial candidates, shard-local attribute sort orders the
    Alg. 1 interval candidates, and ``build.refine_candidates`` (the same
    prune/repair iterations as ``build_ug``, prune kernel by ``backend``)
    refines them.  Rows partition round-robin as in
    :func:`build_sharded_index_host`.  The neighbour columns are trimmed to
    the widest row over every shard (a maximum across processes).
    Quantization parameters come from the original ``x``.  ``progress``
    gets a message after the ring, the attribute candidates and the
    refinement."""
    if len(index_axes) != 1:
        raise NotImplementedError(
            "the on-device sharded build rings over one index axis; flatten "
            "multi-axis meshes into the data axis for construction")
    axis = index_axes[0]
    S = mesh.size(axis)
    dev = mesh.device
    x = as_tensor(x, torch.float32, dev)
    intervals = as_tensor(intervals, torch.float32, dev)
    n = x.shape[0]
    gids_all, per = _round_robin_layout(n, S)
    L, start = mesh.local(axis), mesh.start(axis)
    gids = torch.as_tensor(gids_all[start * per:(start + L) * per], device=dev)
    valid = gids >= 0
    safe = gids.clamp(0, n - 1).long()
    xs = torch.where(valid[:, None], x[safe], 0.0)
    # pads: an inverted interval, which no predicate matches
    dead = torch.tensor([2.0, -2.0], dtype=torch.float32, device=dev)
    its = torch.where(valid[:, None], intervals[safe], dead)
    note = progress or (lambda msg: None)

    # (1) spatial candidates: the ring-KNN bootstrap masked to the own shard
    spa, _ = _ring_knn_step_fn(mesh, axis, int(cfg.ef_spatial), same_shard_of=S)(xs, gids)
    note(f"ring: {L} shards of {per} rows")
    # (2) attribute candidates: shard-local Alg. 1 sort orders
    blocks = [slice(s * per, (s + 1) * per) for s in range(L)]
    attr = [attribute_candidates(its[b], cfg.ef_attribute) for b in blocks]
    note("attribute candidates")
    # (3) the prune/repair iterations of build_ug, shard by shard
    self_ids = torch.arange(per, dtype=torch.int32, device=dev)[:, None]
    nbrs, stat = [], []
    for b, a in zip(blocks, attr):
        ok = valid[b]
        cand = torch.cat([spa[b], a], dim=1)
        cand = torch.where(cand == self_ids, -1, cand)
        cand = torch.where((cand >= 0) & ok[cand.clamp(0, per - 1).long()], cand, -1)
        nb, st, _ = refine_candidates(xs[b], its[b], cand, cfg, backend)
        nb = torch.where(ok[:, None] & (nb >= 0), nb, -1)
        nbrs.append(nb)
        stat.append(torch.where(nb >= 0, st, 0).to(torch.uint8))
    nbrs, stat = torch.cat(nbrs), torch.cat(stat)
    widest = (nbrs >= 0).sum(dim=1).max().reshape(1)
    live_cols = max(int(all_reduce_max(widest, mesh, axis)[0]), 1)
    note(f"refinement: {live_cols} columns")

    qparams = None
    if dtype == "int8":
        qparams = quantization_params(x)
    elif dtype == "pq":
        qparams = train_pq_codebooks(x)
    store = IndexStore(
        plane=VectorPlane.encode(xs, dtype, qparams),
        rerank=VectorPlane.encode(xs, "f32") if rerank else None,
        intervals=its, nbrs=nbrs[:, :live_cols].contiguous(),
        status=stat[:, :live_cols].contiguous(), entry=None,
    )
    return ShardedIndex(store, gids, mesh)


def build_sharded_index_host(x, intervals, n_shards: int, cfg, seed: int = 0, *,
                             device=None):
    """Serial reference: partition rows round-robin and build one UG a
    shard with ``build_ug`` on ``device`` (``None`` = the card), shard
    ``s`` from a ``torch.Generator`` seeded ``seed + s``.  Returns numpy
    arrays ``(x, intervals, nbrs, status, global_ids)`` of all ``S·per``
    rows, padded to a common width, ready for :func:`shard_index`.
    NN-descent draws differ from the reference's, so only
    ``exact_spatial=True`` builds compare bit for bit."""
    dev = resolve_device(device)
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    intervals = (intervals.cpu().numpy() if isinstance(intervals, torch.Tensor)
                 else np.asarray(intervals))
    n = x.shape[0]
    per = (n + n_shards - 1) // n_shards
    shards, max_m = [], 1
    for s in range(n_shards):
        rows = np.arange(s, n, n_shards)[:per]
        gen = torch.Generator(device=dev).manual_seed(seed + s)
        g = build_ug(gen, as_tensor(x[rows], torch.float32, dev),
                     as_tensor(intervals[rows], torch.float32, dev), cfg)
        shards.append((rows, g))
        max_m = max(max_m, g.nbrs.shape[1])
    xs, its, nbs, sts, gid = [], [], [], [], []
    for rows, g in shards:
        m, nloc = g.nbrs.shape[1], rows.shape[0]
        nb = np.full((per, max_m), -1, np.int32)
        st = np.zeros((per, max_m), np.uint8)
        nb[:nloc, :m] = g.nbrs.cpu().numpy()
        st[:nloc, :m] = g.status.cpu().numpy()
        xpad = np.zeros((per, x.shape[1]), x.dtype)
        xpad[:nloc] = x[rows]
        # pad rows get inverted intervals so no predicate ever matches
        ipad = np.zeros((per, 2), intervals.dtype)
        ipad[:, 0], ipad[:, 1] = 2.0, -2.0
        ipad[:nloc] = intervals[rows]
        gpad = np.full((per,), -1, np.int32)
        gpad[:nloc] = rows
        xs.append(xpad), its.append(ipad), nbs.append(nb), sts.append(st), gid.append(gpad)
    cat = lambda arrs: np.concatenate(arrs, axis=0)
    return cat(xs), cat(its), cat(nbs), cat(sts), cat(gid)
