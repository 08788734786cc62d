"""AdamW with dtype-configurable moment states (the reference's optimizer,
written out: no library optimizer).

``state_dtype`` lets the large MoE configs halve optimizer memory (bf16
moments with float32 update math).  :func:`update` does its math in float32
in the reference's order; with ``inplace=True`` it writes each leaf's new
value into the leaf's own storage, a slice of at most
:data:`SLICE_ELEMENTS` elements at a time, so its float32 temporaries stay
a few GB however large a leaf is (qwen1.5-4b's ``embed`` holds 389 M).
The functional path runs the same slices into new tensors: the arithmetic
is elementwise, so both give the same bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map

SLICE_ELEMENTS = 64 * 2 ** 20      # elements of one slice of the update's leaf pass


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"         # cosine | linear | constant
    state_dtype: Any = torch.float32  # bf16 halves optimizer memory on big MoE


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    m: Any
    v: Any


def init(cfg: AdamWConfig, params) -> AdamWState:
    """Zero moments at ``state_dtype`` on each leaf's device; step 0."""
    dev = tree_leaves(params)[0][1].device
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)  # noqa: E731
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), tree_map(zeros, params),
                      tree_map(zeros, params))


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step``: linear warm-up, then the schedule's
    decay to ``total_steps``; a float32 scalar on ``step``'s device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0, 1)
    if cfg.schedule == "linear":
        decay = 1.0 - frac
    elif cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}: cosine, linear or constant")
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (float32), the leaves summed
    in sorted-key order (``jax.tree.leaves``'s), each leaf in slices of at
    most :data:`SLICE_ELEMENTS` elements, so no float32 copy of a whole
    leaf is made.

    The leaves are first scaled by ``2^-k``, the power of two at or above
    the largest ``|leaf|``, and the norm scaled back by ``2^k``.  A power
    of two scales every square and partial sum exactly (terms whose squares
    fall below float32's normal range aside, which lie far under the sum's
    last bit), so where the plain sum of squares stays in range the result
    is the reference's formula to float32 rounding; where it would overflow
    it is still finite, and the clip still scales the gradients down.  The
    reference's own init at full width gives gradients that overflow it:
    ROADMAP, "Reference quirks"."""
    leaves = [leaf.detach().contiguous() for _, leaf in tree_leaves(tree)]
    inv, back = pow2_scale(abs_max(leaves))
    sq = sum(sum_squares(leaf, inv) for leaf in leaves)
    return torch.sqrt(sq) * back


def abs_max(leaves) -> torch.Tensor:
    """The largest ``|x|`` over contiguous tensors, in float32."""
    return torch.stack([s.abs().amax().float() for leaf in leaves
                        for s in _slices(leaf)]).amax()


def pow2_scale(amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(2^-k, 2^k)``, ``2^k`` the power of two at or above ``amax`` (1
    where ``amax`` is 0 or not finite): :func:`global_norm`'s scaling."""
    ok = torch.isfinite(amax) & (amax > 0)
    k = torch.where(ok, torch.ceil(torch.log2(torch.where(ok, amax, 1.0))), 0.0)
    return torch.exp2(-k), torch.exp2(k)


def sum_squares(t: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``Σ (t · inv)²`` of a contiguous tensor in float32, added a slice of
    :data:`SLICE_ELEMENTS` at a time."""
    return sum(torch.sum(torch.square(s.float() * inv)) for s in _slices(t))


def tree_from_paths(template, by_path: dict, path: tuple = ()):
    """A tree shaped like ``template`` (nested dicts) whose leaf at each path
    is ``by_path[path]``.  (A module function: a recursive closure would
    hold ``by_path``, and the tensors in it, in a reference cycle until the
    cyclic collector runs.)"""
    if isinstance(template, dict):
        return {k: tree_from_paths(v, by_path, path + (k,)) for k, v in template.items()}
    return by_path[path]


def _slices(t: torch.Tensor):
    """``t`` as consecutive flat slices of at most SLICE_ELEMENTS elements."""
    flat = t.view(-1)              # a contiguous leaf: the slices are its storage
    for s in range(0, flat.numel(), SLICE_ELEMENTS):
        yield flat[s:s + SLICE_ELEMENTS]


@torch.no_grad()
def update(cfg: AdamWConfig, state: AdamWState, params, grads, *, inplace: bool = False,
           gnorm: torch.Tensor | None = None):
    """One AdamW step (float32 math, moments stored at ``state_dtype``).

    Returns ``(new_params, new_state, {"grad_norm", "lr"})``.  ``inplace``
    writes the new parameters and moments into the given tensors and
    returns the same trees (the caller must not keep the old values, as
    under JAX's donation); otherwise new tensors are returned.  ``gnorm``
    is the gradients' global norm when the caller has it (the mesh step,
    whose ``grads`` are this process's blocks); by default
    :func:`global_norm` of ``grads``.  The update is elementwise, so blocks
    of the leaves update as the whole leaves would."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
             if cfg.grad_clip else 1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g32 = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        new_p = p.float() - lr * delta
        return new_p.to(p.dtype), m32.to(cfg.state_dtype), v32.to(cfg.state_dtype)

    g_of = dict(tree_leaves(grads))
    m_of = dict(tree_leaves(state.m))
    v_of = dict(tree_leaves(state.v))
    out = {}
    for path, p in tree_leaves(params):
        g, m, v = g_of[path], m_of[path], v_of[path]
        for t in (p, g, m, v):
            if not t.is_contiguous():
                raise ValueError(f"AdamW needs contiguous leaves: {'/'.join(path)}")
        targets = (p, m, v) if inplace else (torch.empty_like(p), torch.empty_like(m),
                                             torch.empty_like(v))
        for ps, gs, ms, vs, *dst in zip(*(_slices(t) for t in (p, g, m, v) + targets)):
            for d, new in zip(dst, upd(ps, gs, ms, vs)):
                d.copy_(new)
        out[path] = targets

    if inplace:
        return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}
    new_params, new_m, new_v = (tree_from_paths(params, {p: t[k] for p, t in out.items()})
                                for k in range(3))
    return new_params, AdamWState(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr}
