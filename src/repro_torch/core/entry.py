"""Entry-node acquisition (paper Alg. 5, Lemma 4.3).

Nodes are sorted by interval left endpoint; the suffix minimum and prefix
maximum of the right endpoints (with their arg node ids) let a valid entry
node be found in O(log n) for IF and IS queries, or NULL certified when no
valid node exists.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import intervals as iv


@dataclasses.dataclass(frozen=True)
class EntryIndex:
    node_id: torch.Tensor        # (n,) int32, node ids sorted by left endpoint
    l_sorted: torch.Tensor       # (n,) f32, sorted left endpoints
    suffmin_r_val: torch.Tensor  # (n,) f32, min right endpoint over the suffix
    suffmin_r_id: torch.Tensor   # (n,) int32, arg node id of that minimum
    prefmax_r_val: torch.Tensor  # (n,) f32, max right endpoint over the prefix
    prefmax_r_id: torch.Tensor   # (n,) int32, arg node id of that maximum

    def arrays(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


def _argscan(vals: torch.Tensor, ids: torch.Tensor, op: str, reverse: bool):
    """Running min/max scan carrying (value, arg id) pairs.

    The incumbent wins ties, as in the reference's associative scan (strict
    compares): the arg is the first element, in scan order, that reached the
    running extreme.  ``torch.cummin``/``cummax`` give the values; their own
    indices follow another tie rule, so the args come from the positions
    that strictly beat everything before them ("records")."""
    v = vals.flip(0) if reverse else vals
    i = ids.flip(0) if reverse else ids
    run = (torch.cummin(v, 0) if op == "min" else torch.cummax(v, 0)).values
    rec = torch.ones_like(v, dtype=torch.bool)
    rec[1:] = (v[1:] < run[:-1]) if op == "min" else (v[1:] > run[:-1])
    pos = torch.arange(v.shape[0], device=v.device)
    last_rec = torch.cummax(torch.where(rec, pos, -1), 0).values
    arg = i[last_rec]
    if reverse:
        run, arg = run.flip(0), arg.flip(0)
    return run, arg


def build_entry_index(
    intervals: torch.Tensor, node_mask: torch.Tensor | None = None
) -> EntryIndex:
    """Sort by left endpoint and precompute suffix-min / prefix-max of rights.

    ``node_mask`` excludes nodes (masked rows get ``l=+inf`` so they sort
    last, and sentinel rights so they never win a scan)."""
    l = intervals[:, 0].to(torch.float32)
    r = intervals[:, 1].to(torch.float32)
    if node_mask is not None:
        l = torch.where(node_mask, l, torch.inf)
        r_for_min = torch.where(node_mask, r, torch.inf)
        r_for_max = torch.where(node_mask, r, -torch.inf)
    else:
        r_for_min = r_for_max = r
    l_s, order = torch.sort(l, stable=True)
    order = order.to(torch.int32)
    sv, si = _argscan(r_for_min[order.long()], order, "min", reverse=True)
    pv, pi = _argscan(r_for_max[order.long()], order, "max", reverse=False)
    return EntryIndex(order, l_s, sv, si, pv, pi)


def _entry_if(eidx: EntryIndex, ql: torch.Tensor, qr: torch.Tensor) -> torch.Tensor:
    """IF/RF branch of Alg. 5: the first position with ``l ≥ q.l``; its
    suffix-min right endpoint certifies a valid node or NULL (Lemma 4.3)."""
    n = eidx.l_sorted.shape[0]
    i = torch.searchsorted(eidx.l_sorted, ql.contiguous(), side="left")
    ok = i < n
    ic = i.clamp(0, n - 1)
    ok = ok & (eidx.suffmin_r_val[ic] <= qr)
    return torch.where(ok, eidx.suffmin_r_id[ic], -1).to(torch.int32)


def _entry_is(eidx: EntryIndex, ql: torch.Tensor, qr: torch.Tensor) -> torch.Tensor:
    """IS/RS branch of Alg. 5 (dual: the prefix max over ``l ≤ q.l``)."""
    n = eidx.l_sorted.shape[0]
    i = torch.searchsorted(eidx.l_sorted, ql.contiguous(), side="right") - 1
    ok = i >= 0
    ic = i.clamp(0, n - 1)
    ok = ok & (eidx.prefmax_r_val[ic] >= qr)
    return torch.where(ok, eidx.prefmax_r_id[ic], -1).to(torch.int32)


def get_entry_flags(eidx: EntryIndex, q_interval: torch.Tensor,
                    sem_flags: torch.Tensor) -> torch.Tensor:
    """Alg. 5 with runtime per-query semantics: ``sem_flags`` (…,) int32
    picks the IF or IS branch per query; each lane equals the static path's."""
    ql, qr = q_interval[..., 0], q_interval[..., 1]
    return torch.where(iv.is_filter_flag(sem_flags), _entry_if(eidx, ql, qr),
                       _entry_is(eidx, ql, qr)).to(torch.int32)


def get_entry(eidx: EntryIndex, q_interval: torch.Tensor, sem: iv.Semantics) -> torch.Tensor:
    """Alg. 5 for a batch of query intervals (…, 2) → (…,) int32 ids, -1
    where no valid node exists (the NULL case of Lemma 4.3)."""
    ql, qr = q_interval[..., 0], q_interval[..., 1]
    if sem in (iv.Semantics.IF, iv.Semantics.RF):
        return _entry_if(eidx, ql, qr)
    return _entry_is(eidx, ql, qr)


def get_entry_batch(eidx: EntryIndex, q_interval: torch.Tensor, sem: iv.Semantics,
                    width: int = 1) -> torch.Tensor:
    """Widened Alg. 5 for one semantics: up to ``width`` distinct valid
    entries per query, ``-1``-padded; column 0 equals :func:`get_entry`."""
    width = max(int(width), 1)
    if sem in (iv.Semantics.IF, iv.Semantics.RF):
        ids = _entry_batch_if(eidx, q_interval, width)
    else:
        ids = _entry_batch_is(eidx, q_interval, width)
    return _mask_duplicate_entries(ids)


def _entry_batch_if(eidx: EntryIndex, q_interval: torch.Tensor, width: int) -> torch.Tensor:
    n = eidx.l_sorted.shape[0]
    ql = q_interval[..., 0].contiguous()
    qr = q_interval[..., 1]
    offs = torch.arange(width, device=ql.device)
    i = torch.searchsorted(eidx.l_sorted, ql, side="left")
    pos = i[..., None] + offs
    ok = pos < n
    pc = pos.clamp(0, n - 1)
    ok = ok & (eidx.suffmin_r_val[pc] <= qr[..., None])
    return torch.where(ok, eidx.suffmin_r_id[pc], -1)


def _entry_batch_is(eidx: EntryIndex, q_interval: torch.Tensor, width: int) -> torch.Tensor:
    n = eidx.l_sorted.shape[0]
    ql = q_interval[..., 0].contiguous()
    qr = q_interval[..., 1]
    offs = torch.arange(width, device=ql.device)
    i = torch.searchsorted(eidx.l_sorted, ql, side="right") - 1
    pos = i[..., None] - offs
    ok = pos >= 0
    pc = pos.clamp(0, n - 1)
    ok = ok & (eidx.prefmax_r_val[pc] >= qr[..., None])
    return torch.where(ok, eidx.prefmax_r_id[pc], -1)


def _mask_duplicate_entries(ids: torch.Tensor) -> torch.Tensor:
    """Mask repeated arg nodes to -1, first occurrence kept (the width is
    small, so the O(width²) pairwise mask is fine here)."""
    width = ids.shape[-1]
    offs = torch.arange(width, device=ids.device)
    dup = (ids[..., :, None] == ids[..., None, :]) & (ids[..., None, :] >= 0)
    earlier = offs[:, None] > offs[None, :]
    return torch.where(torch.any(dup & earlier, dim=-1), -1, ids).to(torch.int32)


def get_entry_batch_flags(
    eidx: EntryIndex, q_interval: torch.Tensor, sem_flags: torch.Tensor, width: int = 1
) -> torch.Tensor:
    """Widened Alg. 5 with runtime per-query semantics: up to ``width``
    distinct valid entries per query, ``-1``-padded.

    For an IF query every position ``p ≥ i`` of the left-endpoint order
    whose suffix-min right endpoint is ``≤ q.r`` certifies a valid entry;
    dually for IS with the prefix max over ``p ≤ i``.  Both walks are
    computed and selected per query, then duplicates are masked.  Column 0
    is plain Alg. 5."""
    width = max(int(width), 1)
    ids = torch.where(
        iv.is_filter_flag(sem_flags)[..., None],
        _entry_batch_if(eidx, q_interval, width),
        _entry_batch_is(eidx, q_interval, width),
    )
    return _mask_duplicate_entries(ids)
