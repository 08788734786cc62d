"""Interval algebra for interval-aware ANN search (paper §2.1, §3).

Every object carries an interval ``I_o = [l, r]``; every query carries
``q.I = [a_l, a_r]``.  The four query semantics reduce to two predicates:

* IFANN:  ``I_o ⊆ q.I``   (interval-filtered)
* ISANN:  ``q.I ⊆ I_o``   (interval-stabbing)
* RFANN:  IFANN with point object intervals ``I_o = [a, a]``
* RSANN:  ISANN with a point query interval ``q.I = [t, t]``

The URNG witness conditions (Def. 3.1) are:

* ``Φ_IF(u, v, w): I_w ⊆ I_u ∪ I_v``   with ``∪`` the hull
* ``Φ_IS(u, v, w): I_u ∩ I_v ⊆ I_w``   considered only when ``I_u ∩ I_v ≠ ∅``

All functions broadcast: intervals are tensors whose last axis has size 2
(``[..., 0] = l``, ``[..., 1] = r``).
"""
from __future__ import annotations

import enum

import torch

# Semantic bit layout of the per-edge status byte (paper Def. 3.1 bitmask).
FLAG_IF = 1  # bit 0: edge active for interval-filtered (IF) semantics
FLAG_IS = 2  # bit 1: edge active for interval-stabbing (IS) semantics
FLAG_BOTH = FLAG_IF | FLAG_IS


class Semantics(enum.Enum):
    """Query semantics; RF/RS are degenerate IF/IS (paper §2.1)."""

    IF = "IF"
    IS = "IS"
    RF = "RF"  # scalar-attribute filtering == IF with point object intervals
    RS = "RS"  # stabbing == IS with point query interval

    @property
    def flag(self) -> int:
        return FLAG_IF if self in (Semantics.IF, Semantics.RF) else FLAG_IS


def hull(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Interval hull ``a ∪ b = [min(l_a, l_b), max(r_a, r_b)]``."""
    lo = torch.minimum(a[..., 0], b[..., 0])
    hi = torch.maximum(a[..., 1], b[..., 1])
    return torch.stack([lo, hi], dim=-1)


def intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Interval intersection (may be empty: ``l > r``)."""
    lo = torch.maximum(a[..., 0], b[..., 0])
    hi = torch.minimum(a[..., 1], b[..., 1])
    return torch.stack([lo, hi], dim=-1)


def is_empty(a: torch.Tensor) -> torch.Tensor:
    return a[..., 0] > a[..., 1]


def contains(outer: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    """``inner ⊆ outer``."""
    return (outer[..., 0] <= inner[..., 0]) & (inner[..., 1] <= outer[..., 1])


def phi_if(iu: torch.Tensor, iv: torch.Tensor, iw: torch.Tensor) -> torch.Tensor:
    """IF witness condition ``I_w ⊆ I_u ∪ I_v`` (Def. 3.1)."""
    return contains(hull(iu, iv), iw)


def phi_is(iu: torch.Tensor, iv: torch.Tensor, iw: torch.Tensor) -> torch.Tensor:
    """IS witness condition ``I_u ∩ I_v ⊆ I_w``, false where the
    intersection is empty (Alg. 3 clears the IS bit there)."""
    inter = intersection(iu, iv)
    nonempty = ~is_empty(inter)
    return nonempty & (iw[..., 0] <= inter[..., 0]) & (iw[..., 1] >= inter[..., 1])


def predicate(sem: Semantics, obj: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Query validity predicate; ``obj`` broadcasts against ``query``."""
    if sem in (Semantics.IF, Semantics.RF):
        return contains(query, obj)
    return contains(obj, query)


def query_valid_mask(sem: Semantics, intervals: torch.Tensor, q_interval: torch.Tensor) -> torch.Tensor:
    """Validity of every object for one query: (n, 2) x (2,) -> (n,) bool."""
    return predicate(sem, intervals, q_interval[None, :])


def as_sem_flags(sem, batch_size: int, device=None) -> torch.Tensor:
    """Normalise a semantics spec to a ``(batch_size,)`` int32 flag tensor.

    Accepts one :class:`Semantics` (broadcast), a sequence of
    ``Semantics``/flag ints (one per query), or a flag tensor or array.
    Every flag must be ``FLAG_IF`` or ``FLAG_IS``: flag 0 would fail every
    edge gate, flag 3 would traverse both semantics."""
    if isinstance(sem, Semantics):
        return torch.full((batch_size,), sem.flag, dtype=torch.int32, device=device)
    if isinstance(sem, (list, tuple)):
        sem = [s.flag if isinstance(s, Semantics) else int(s) for s in sem]
    arr = torch.as_tensor(sem, device=device).to(torch.int32)
    bad = sorted(set(torch.unique(arr).tolist()) - {FLAG_IF, FLAG_IS})
    if bad:
        raise ValueError(
            f"sem flags must be FLAG_IF ({FLAG_IF}) or FLAG_IS ({FLAG_IS}), got {bad}")
    if arr.ndim != 1 or arr.shape[0] != batch_size:
        raise ValueError(f"sem flags shape {tuple(arr.shape)} != ({batch_size},)")
    return arr


def is_filter_flag(flags: torch.Tensor) -> torch.Tensor:
    """True where the flag selects the containment direction of IF/RF."""
    return (flags & FLAG_IF) > 0


def predicate_by_flag(flags: torch.Tensor, obj: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Flag-driven :func:`predicate`: ``flags`` broadcasts against the
    leading dims of ``obj``/``query``.  Both directions are evaluated and
    selected per element, so a uniform-flag batch equals :func:`predicate`."""
    return torch.where(is_filter_flag(flags), contains(query, obj), contains(obj, query))


def query_valid_mask_by_flag(flags: torch.Tensor, intervals: torch.Tensor,
                             q_intervals: torch.Tensor) -> torch.Tensor:
    """Per-query validity of every object: (B,) x (n, 2) x (B, 2) -> (B, n)."""
    return predicate_by_flag(flags[:, None], intervals[None, :, :], q_intervals[:, None, :])


def sample_uniform_intervals(gen: torch.Generator, n: int,
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Uniform interval model of the paper's analysis (§3.2, App. A): two
    i.i.d. U(0, 1) endpoints per object, sorted, on ``gen``'s device."""
    pts = torch.rand((n, 2), generator=gen, dtype=dtype, device=gen.device)
    return torch.sort(pts, dim=-1).values


def sample_point_intervals(gen: torch.Generator, n: int,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Point intervals ``[a, a]``, ``a ~ U(0, 1)``: the RFANN special case."""
    a = torch.rand((n, 1), generator=gen, dtype=dtype, device=gen.device)
    return torch.cat([a, a], dim=-1)
