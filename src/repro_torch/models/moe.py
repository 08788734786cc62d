"""Mixture-of-Experts FFN: top-k router + sort-based capacity dispatch.

``moe_ffn`` takes one of three paths, as the reference's does:

* the **local** path (``_moe_ffn_local``): the dispatch grouped by data
  shard, ``G = shard_ctx.dp_size()`` groups (1 without an active mesh),
  each group with its own capacity; the path of every serve call and of
  the one-device train step (under the serve step's tensor-parallel
  context a card routes its rows as one group and computes its experts);
* the **expert-parallel** path (``_moe_ffn_ep``), under an active mesh
  (``shard_ctx.use_mesh``) when the shapes divide (the reference's exact
  conditions): each (data, model) token shard dispatches its own tokens
  with a per-shard capacity; two all-to-alls over ``model``
  (:class:`AllToAll`, ``dist.all_to_all_single`` on the axis's group, a
  local permutation where one process holds the axis) move the slots to
  the experts' owners and back; the router, the experts' FSDP shards and
  the shared expert are gathered once a layer (:class:`Gathered`).  Under
  a mesh, ``p`` holds this process's blocks of the layer's leaves (their
  specs from ``build_moe_params`` in ``spec`` mode) and ``x`` its block of
  the ``(B, S, d)`` residual under ``(dp, model, None)``: the full tensors
  when one process holds every shard;
* the **global dispatch of the mesh train step** (``train/step.py``): the
  step runs each data shard's rows as one call of a dispatch over the
  whole batch, as the reference's partitioned step does (G = 1 over all
  ``B · S`` tokens): capacity from the global token count, an assignment's
  rank in its expert counting the same-expert assignments of the shards
  before it, the Switch aux from the global ``frac`` and ``mean_p``.  The
  step gives each shard's thread a :func:`data_shard` context whose
  exchange all-gathers one ``(2, E)`` count vector a shard and a layer.
  On a mesh whose ``model`` axis has several shards the step splits the
  experts along it (tensor parallelism, ``models/shard_ctx.py``): the
  routing runs whole, once a process, and each ``model`` shard
  dispatches, computes and combines only its ``E / model`` experts'
  slots; the partials are summed over ``model`` in shard order.

The backward passes through the router's top-k values and the gate
renormalisation to the router, and through ``mean_p`` in the Switch aux;
the expert choices and the capacity drops carry no gradient, as in the
reference.  The dispatch ``xt[t_s]`` and the combine ``contrib[slot]``
differentiate to float scatter-adds, made deterministic on the card by
PyTorch's deterministic mode (``train/step.py::deterministic``).

Router aux loss follows Switch (load-balance: E · Σ_e f_e · p_e).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.models import shard_ctx
from repro_torch.models.common import ModelConfig, P, ParamBuilder, swiglu


def build_moe_params(cfg: ModelConfig, b, prefix_layers: bool = True):
    L = (cfg.n_layers,) if prefix_layers else ()
    lax_ = ("layers",) if prefix_layers else ()
    dff = cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": b(L + (cfg.d_model, cfg.n_experts), lax_ + ("embed", "expert")),
        "experts": {
            "w_gate": b(L + (cfg.n_experts, cfg.d_model, dff), lax_ + ("expert", "embed", "mlp")),
            "w_up": b(L + (cfg.n_experts, cfg.d_model, dff), lax_ + ("expert", "embed", "mlp")),
            "w_down": b(L + (cfg.n_experts, dff, cfg.d_model), lax_ + ("expert", "mlp", "embed")),
        },
    }
    if cfg.n_shared_experts:
        sdff = dff * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": b(L + (cfg.d_model, sdff), lax_ + ("embed", "mlp")),
            "w_up": b(L + (cfg.d_model, sdff), lax_ + ("embed", "mlp")),
            "w_down": b(L + (sdff, cfg.d_model), lax_ + ("mlp", "embed")),
        }
    return p


def top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row and their indices, the lowest
    index first among equal values, as ``lax.top_k`` orders them
    (``torch.topk`` does not keep that order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(cfg: ModelConfig, xt, router_w):
    """Top-k routing + Switch aux terms.  xt (T, d), router_w (d, E).
    Returns (gate_idx (T, K), renormalised gate_vals (T, K), the top-1
    dispatch fraction (E,), the mean router probability (E,))."""
    logits = xt.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k_stable(probs, cfg.top_k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    frac = F.one_hot(gate_idx[..., 0], cfg.n_experts).float().mean(dim=0)
    return gate_idx, gate_vals, frac, probs.mean(dim=0)


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert holds for a call over ``tokens`` tokens: the
    reference's Python float arithmetic, in its order (``int`` truncates)."""
    E, K = cfg.n_experts, cfg.top_k
    return min(max(int(tokens * K / max(E, 1) * cfg.capacity_factor) + 1, 4), tokens * K)


def _sorted_assignments(gate_idx, C: int, offset=None):
    """The block's assignments sorted by expert (stably): ``(order, e_s,
    t_s, rank, keep)``.  An assignment's rank is its place among the
    block's assignments to its expert, plus ``offset[e]`` (assignments to
    ``e`` that come before the block, for the global dispatch); it is kept
    when that is below ``C``."""
    T, K = gate_idx.shape
    N = T * K
    dev = gate_idx.device
    flat_e = gate_idx.reshape(N)
    order = torch.argsort(flat_e, stable=True)
    e_s = flat_e[order]
    t_s = torch.arange(T, device=dev).repeat_interleave(K)[order]
    first = torch.searchsorted(e_s, e_s, side="left")
    rank = torch.arange(N, device=dev) - first
    keep = (rank + offset[e_s] if offset is not None else rank) < C
    return order, e_s, t_s, rank, keep


def _local_dispatch(xt, gate_idx, gate_vals, E: int, C: int, offset=None, *,
                    experts: tuple[int, int] | None = None, assigned=None):
    """Sort-based capacity dispatch over one token block.

    xt (T, d); gate_idx/vals (T, K).  Returns (buf (E, C, d), t_of_slot
    (E, C), w_of_slot (E, C), slot_of (T, K)): the reference's slot maps,
    and each token's slots in ascending expert order (the scratch slot
    ``E · C`` for a dropped assignment), which the combine reads.  A kept
    assignment (:func:`_sorted_assignments`; ``assigned`` is their result
    when the caller has it) takes slot ``e · C`` + its rank.  ``experts =
    (e0, e1)`` builds only those experts' rows (``E`` is then ``e1 − e0``
    in the shapes above, their slots counted from ``e0``): every other
    assignment goes to the scratch slot, as a dropped one does."""
    T, K = gate_idx.shape
    order, e_s, t_s, rank, keep = assigned or _sorted_assignments(gate_idx, C, offset)
    w_s = gate_vals.reshape(T * K)[order]
    if experts is not None:
        e0, e1 = experts
        keep = keep & (e_s >= e0) & (e_s < e1)
        e_s, E = e_s - e0, e1 - e0
    # slot e * C + rank; a dropped assignment goes to the scratch slot E * C,
    # which is sliced off (the reference's mode="drop" scatter)
    slot = torch.where(keep, e_s * C + rank, E * C)
    buf = torch.zeros((E * C + 1, xt.shape[-1]), dtype=xt.dtype, device=xt.device)
    buf[slot] = xt[t_s]
    t_of = torch.zeros(E * C + 1, dtype=torch.long, device=xt.device)
    t_of[slot] = t_s
    w_of = torch.zeros(E * C + 1, dtype=torch.float32, device=xt.device)
    w_of[slot] = torch.where(keep, w_s, 0.0)
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot                                      # (t, j) -> its slot
    slot_of = torch.gather(slot_of.reshape(T, K), 1,
                           torch.argsort(gate_idx, dim=-1, stable=True))
    return (buf[: E * C].reshape(E, C, -1), t_of[: E * C].reshape(E, C),
            w_of[: E * C].reshape(E, C), slot_of)


def _combine(y_slots, w_of, slot_of, dtype):
    """Each token adds its kept slots in ascending expert order, from zeros
    in ``dtype``, each add rounded to ``dtype`` (the order of the
    reference's scatter-add, without float atomics)."""
    E, C, d = y_slots.shape
    contrib = y_slots.reshape(E * C, d) * w_of.reshape(E * C, 1).to(dtype)
    contrib = torch.cat([contrib, contrib.new_zeros((1, d))])  # the scratch slot: 0
    y = torch.zeros((slot_of.shape[0], d), dtype=dtype, device=y_slots.device)
    for j in range(slot_of.shape[1]):
        y = y + contrib[slot_of[:, j]]
    return y


def _experts(buf, w_gate, w_up, w_down, dtype):
    """The experts' SwiGLU over their slots: buf (E, C, d) -> (E, C, d)."""
    hg = torch.bmm(buf, w_gate)
    hu = torch.bmm(buf, w_up)
    h = F.silu(hg.float()).to(dtype) * hu
    return torch.bmm(h, w_down)


def _dispatch_ffn(cfg, ex, xt, gate_idx, gate_vals, C: int, assigned=None):
    """One token block's dispatch, expert compute and combine: y (T, d).
    ``assigned``: the block's :func:`_sorted_assignments` (made here
    without an offset when ``None``).  Under a tensor-parallel context that
    splits ``"expert"`` (``shard_ctx``) each local ``model`` shard
    dispatches, computes and combines its ``E / model`` experts' slots;
    where the experts split by their ``d_ff`` columns (``"expert_mlp"``)
    each shard dispatches every expert's slots to its columns; the
    partials are summed over ``model`` in shard order (a token's slots
    summed within each shard, the shards added in order)."""
    E = cfg.n_experts
    assigned = assigned or _sorted_assignments(gate_idx, C)
    tp = shard_ctx.split("expert")
    by_columns = tp.mesh is None and shard_ctx.split("expert_mlp").mesh is not None
    if by_columns:
        tp = shard_ctx.split("expert_mlp")
    E_loc = E if by_columns else E // tp.size
    ws = [tp.shards(ex[k], dim) for k, dim in
          zip(("w_gate", "w_up", "w_down"), (-1, -1, -2) if by_columns else (0, 0, 0))]
    parts = []
    for j, (xj, gj, wg, wu, wd) in enumerate(zip(tp.enter(xt), tp.enter(gate_vals), *ws)):
        e0 = 0 if by_columns else tp.shard(j) * E_loc
        buf, _, w_of, slot_of = _local_dispatch(xj, gate_idx, gj, E, C, experts=(e0, e0 + E_loc),
                                                assigned=assigned)
        parts.append(_combine(_experts(buf, wg, wu, wd, xt.dtype), w_of, slot_of, xt.dtype))
    return tp.leave(parts)


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    shard = _data_shard_of(p)
    if shard is not None:
        return _moe_ffn_data_shard(cfg, p, x, shard)
    if shard_ctx.active():
        mesh = shard_ctx.mesh()
        dpsz, tpsz = shard_ctx.dp_size(), shard_ctx.tp_size()
        B, S = _global_tokens(mesh, x)
        if (
            dpsz * tpsz > 1
            and B % max(dpsz, 1) == 0
            and S % max(tpsz, 1) == 0
            and cfg.n_experts % max(tpsz, 1) == 0
            and (B * S) // (dpsz * tpsz) >= 4
        ):
            return _moe_ffn_ep(cfg, p, x)
        if not _holds_every_shard(mesh):
            raise ValueError("the local MoE path under a mesh that spans processes: the "
                             "expert-parallel path's conditions do not hold for "
                             f"x {tuple(x.shape)} on {dict(zip(mesh.axes, mesh.shape))}")
    return _moe_ffn_local(cfg, p, x)


def dropped_assignments(cfg: ModelConfig, gate_idx: torch.Tensor) -> int:
    """Assignments a call over ``gate_idx`` (T, K) drops: each expert keeps
    its first ``capacity(cfg, T)`` (a host sync: for reports)."""
    counts = torch.bincount(gate_idx.reshape(-1), minlength=cfg.n_experts)
    return int((counts - capacity(cfg, gate_idx.shape[0])).clamp_min(0).sum())


def _moe_ffn_local(cfg: ModelConfig, p, x: torch.Tensor):
    """The local path: ``G = shard_ctx.dp_size()`` dispatch groups (1 when
    inactive or when they do not divide the tokens), each with its own
    capacity; the aux from the means over every token.  The serve step
    (``launch/dryrun.py``) runs it for a card's rows, one group, under a
    tensor-parallel context: the routing whole (the router gathered along
    ``model``), each local ``model`` shard its experts (:func:`_dispatch_ffn`)."""
    B, S, d = x.shape
    T = B * S
    E = cfg.n_experts
    G = shard_ctx.dp_size()
    if G <= 0 or T % G:
        G = 1
    Tg = T // G
    xt = x.reshape(T, d)

    gate_idx, gate_vals, frac, mean_p = _router(cfg, xt, p["router"])
    aux = E * torch.sum(frac * mean_p) * cfg.router_aux_weight

    C = capacity(cfg, Tg)
    ys = [_dispatch_ffn(cfg, p["experts"], xt[g * Tg:(g + 1) * Tg],
                        gate_idx[g * Tg:(g + 1) * Tg], gate_vals[g * Tg:(g + 1) * Tg], C)
          for g in range(G)]
    y = ys[0] if G == 1 else torch.cat(ys)

    if cfg.n_shared_experts:
        sp = p["shared"]
        y = y + swiglu(xt, sp["w_gate"], sp["w_up"], sp["w_down"])
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# The mesh train step's global dispatch
# ---------------------------------------------------------------------------
class _Shard(threading.local):
    ctx = None


_SHARD = _Shard()            # the data shard the calling thread computes
_SEEN: dict = {}             # id(router leaf) -> (leaf, shard, counts) of a call made


@dataclasses.dataclass
class DataShard:
    """One data shard's place in the mesh step's global dispatch: its index
    among ``n`` shards of a call over ``tokens`` global tokens, and the
    exchange that all-gathers a ``(2, E)`` count tensor from every shard
    (``(n, 2, E)`` in shard order).  ``dropped`` collects the dropped
    assignments of each router call (as tensors)."""

    index: int
    n: int
    tokens: int
    exchange: Callable
    dropped: list = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def data_shard(shard: DataShard):
    """Within the block, this thread's ``moe_ffn`` calls dispatch as
    ``shard`` of a global call (see the module docstring)."""
    _SHARD.ctx = shard
    try:
        yield shard
    finally:
        _SHARD.ctx = None


def forget_calls() -> None:
    """Drop the record of the global dispatch's calls (the mesh step calls
    this when a step's backward is done)."""
    _SEEN.clear()


def _data_shard_of(p):
    """The global dispatch's record of this layer's call when this call is
    its recompute (the checkpointed block runs again in the backward,
    perhaps on autograd's device thread), else the calling thread's
    ``DataShard`` (or ``None``)."""
    seen = _SEEN.get(id(p["router"]))
    if seen is not None and seen[0] is p["router"]:
        return seen
    return _SHARD.ctx


def _moe_ffn_data_shard(cfg: ModelConfig, p, x: torch.Tensor, shard):
    """One data shard's part of the mesh step's global dispatch.  Under a
    tensor-parallel context that splits ``"expert"`` (``shard_ctx``) the
    routing runs whole, once a process (the router gathered along
    ``model``); ``xt`` and the gate values enter the split region, each
    local ``model`` shard dispatches, computes and combines its ``E /
    model`` experts' slots, and the partials are summed over ``model`` in
    shard order (a token's slots summed within each shard, the shards
    added in order).  Where the experts split by their ``d_ff`` columns
    (``"expert_mlp"``) each shard dispatches every expert's slots to its
    columns, and the partials are summed the same way."""
    B, S, d = x.shape
    T = B * S
    E = cfg.n_experts
    xt = x.reshape(T, d)
    gate_idx, gate_vals, frac, mean_p = _router(cfg, xt, p["router"])
    if isinstance(shard, tuple):                     # a recompute: the forward's counts
        _, shard, counts = shard
        record = False
    else:
        with torch.no_grad():
            mine = torch.stack([torch.bincount(gate_idx.reshape(-1), minlength=E),
                                torch.bincount(gate_idx[:, 0], minlength=E)])
            counts = shard.exchange(mine)            # (n, 2, E), every shard's
        _SEEN[id(p["router"])] = (p["router"], shard, counts)
        record = True
    offset = counts[: shard.index, 0].sum(dim=0)
    frac_g = counts[:, 1].sum(dim=0).float() / shard.tokens
    # this shard's part of E * sum(frac * mean_p) * w over the global tokens
    aux = E * torch.sum(frac_g * (mean_p * (T / shard.tokens))) * cfg.router_aux_weight
    C = capacity(cfg, shard.tokens)
    assigned = _sorted_assignments(gate_idx, C, offset)
    y = _dispatch_ffn(cfg, p["experts"], xt, gate_idx, gate_vals, C, assigned)
    if record:                                       # the assignments past capacity
        shard.dropped.append(torch.sum(~assigned[-1]))
    if cfg.n_shared_experts:
        sp = p["shared"]
        y = y + swiglu(xt, sp["w_gate"], sp["w_up"], sp["w_down"])
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# The expert-parallel path
# ---------------------------------------------------------------------------
# what the expert-parallel calls did: the bytes their all-to-alls sent to
# other processes, and the assignments their per-shard capacity dropped
EP_STATS = {"a2a_bytes_sent": 0, "dropped": 0}


def _holds_every_shard(mesh) -> bool:
    return all(mesh.local(a) == mesh.size(a) for a in mesh.axes)


def _global_tokens(mesh, x) -> tuple[int, int]:
    """(B, S) of the global residual whose block under (dp, model) is x."""
    dp = [a for a in ("pod", "data") if a in mesh.axes]
    B = x.shape[0] // math.prod(mesh.local(a) for a in dp) * math.prod(mesh.size(a) for a in dp)
    S = x.shape[1]
    if "model" in mesh.axes:
        S = S // mesh.local("model") * mesh.size("model")
    return B, S


class Gathered(torch.autograd.Function):
    """The leaf gathered over ``spec``'s axes, once for each of ``copies``
    of this process's shards (one copy each, so each shard's gradient
    stays its own); backward: the copies' gradients summed over the shards
    along ``axes`` in the ring collectives' order
    (``launch.shardings.reduce_blocks``), this process's block of the sum."""

    @staticmethod
    def forward(ctx, block, mesh, spec, axes, copies: int):
        from repro_torch.launch.shardings import gather_leaf

        ctx.mesh, ctx.spec, ctx.axes = mesh, spec, axes
        ctx.locals = [mesh.local(a) for a in axes]
        full = gather_leaf(block, mesh, spec)
        ctx.full = (full.shape, full.dtype, full.device)
        return tuple(full.clone() for _ in range(copies))

    @staticmethod
    def backward(ctx, *grads):
        from repro_torch.launch.shardings import reduce_blocks

        shape, dtype, dev = ctx.full
        g = torch.stack([torch.zeros(shape, dtype=dtype, device=dev) if t is None else t
                         for t in grads])
        g = g.reshape(tuple(ctx.locals) + tuple(g.shape[1:]))
        return reduce_blocks(g, ctx.mesh, ctx.spec, ctx.axes), None, None, None, None


def _transpose_shards(t, mesh, axis: str):
    """``out[k, j] = t[j, k]`` over the shards of ``axis``: ``t`` is
    ``(local, size, *chunk)``, this process's shards' chunks for every
    shard; the result holds, for each of its shards, every shard's chunk
    for it.  ``dist.all_to_all_single`` on the axis's group (CUDA tensors
    through the host on gloo), a local transpose where one process holds
    the axis."""
    import torch.distributed as dist

    a = mesh.axes.index(axis)
    procs, L, size = mesh.procs[a], mesh.local(axis), mesh.size(axis)
    if procs == 1:
        return t.transpose(0, 1).contiguous()
    chunk = t.shape[2:]
    x = t.reshape((L, procs, L) + chunk).transpose(0, 1).transpose(1, 2).contiguous()
    from repro_torch.distributed.collectives import counted

    group = mesh.groups[axis]
    stage = t.is_cuda and dist.get_backend(group) == "gloo"
    src = x.cpu() if stage else x
    out = torch.empty_like(src)
    with counted("all-to-all", src.numel() * src.element_size(), True):
        dist.all_to_all_single(out, src, group=group)
    EP_STATS["a2a_bytes_sent"] += src.numel() * src.element_size() * (procs - 1) // procs
    out = out.to(t.device) if stage else out
    # out[p, k, j'] is process p's shard j' chunk for my shard k
    return out.transpose(0, 1).reshape((L, size) + chunk)


class AllToAll(torch.autograd.Function):
    """:func:`_transpose_shards` with its gradient: the reverse all-to-all
    (the same transposition of the gradient's shards)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _transpose_shards(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _transpose_shards(g.contiguous(), ctx.mesh, ctx.axis), None, None


class ShardSum(torch.autograd.Function):
    """The sum over every shard of ``axes`` of one scalar a shard, over the
    gathered scalars in shard order (the same bits whichever process holds
    which shard):
    ``parts`` is this process's shards' scalars, ``(local along axes[0],
    ...)``.  Backward: each part's gradient is the sum's."""

    @staticmethod
    def forward(ctx, parts, mesh, axes):
        from repro_torch.launch.shardings import gather_leaf

        ctx.shape = parts.shape
        return gather_leaf(parts.detach(), mesh, P(*axes)).sum()

    @staticmethod
    def backward(ctx, g):
        return g.expand(ctx.shape).clone(), None, None


def _only(spec, axes) -> P:
    """``spec`` with every mesh axis outside ``axes`` dropped (the leaf's
    dimensions over the other axes stay this process's blocks)."""
    out = []
    for e in spec:
        kept = tuple(a for a in ((e,) if isinstance(e, str) else (e or ())) if a in axes)
        out.append(kept or None)
    return P(*out)


def _moe_ffn_ep(cfg: ModelConfig, p, x: torch.Tensor):
    """The expert-parallel path (the reference's ``shard_map`` body, run
    for each of this process's (data, model) token shards)."""
    from repro_torch.launch.shardings import gather_leaf

    mesh = shard_ctx.mesh()
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.axes)
    tp = mesh.size("model") if "model" in mesh.axes else 1
    tp_axes = ("model",) if tp > 1 else ()
    all_axes = dp_axes + tp_axes
    B, S = _global_tokens(mesh, x)
    n_shards = shard_ctx.dp_size() * tp
    T_dev = B * S // n_shards
    E, K = cfg.n_experts, cfg.top_k
    E_loc = E // tp
    C = min(max(int(T_dev * K / max(E, 1) * cfg.capacity_factor) + 1, 4), T_dev * K)
    d = x.shape[-1]

    # this process's token shards: rows over the data axes, columns over model
    dp_loc = [mesh.local(a) for a in dp_axes]
    tp_loc = mesh.local("model") if tp > 1 else 1
    n_dp = math.prod(dp_loc)
    rows, cols = B // shard_ctx.dp_size(), S // tp
    xs = x.reshape(n_dp, rows, tp_loc, cols, d).transpose(1, 2).reshape(n_dp, tp_loc,
                                                                          rows * cols, d)
    specs = build_moe_params(cfg, ParamBuilder(cfg, "spec", mesh=mesh), prefix_layers=False)

    n_local = n_dp * tp_loc
    router = Gathered.apply(p["router"], mesh, _only(specs["router"], all_axes),
                            all_axes, n_local)
    ex = {k: Gathered.apply(p["experts"][k], mesh, _only(specs["experts"][k], dp_axes),
                            dp_axes, n_dp) for k in ("w_gate", "w_up", "w_down")}
    if cfg.n_shared_experts:
        shared = {k: Gathered.apply(p["shared"][k], mesh, _only(specs["shared"][k],
                                                                     all_axes),
                                    all_axes, n_local) for k in ("w_gate", "w_up", "w_down")}

    fracs, mean_ps, dispatched = [], [], []
    for i in range(n_dp):
        for j in range(tp_loc):
            s = i * tp_loc + j
            gate_idx, gate_vals, frac, mean_p = _router(cfg, xs[i, j], router[s])
            fracs.append(frac)
            mean_ps.append(mean_p)
            dispatched.append(_local_dispatch(xs[i, j], gate_idx, gate_vals, E, C))
            EP_STATS["dropped"] += int(torch.sum(dispatched[-1][3] == E * C))
    with torch.no_grad():                            # the pmean of frac (no gradient)
        every = gather_leaf(torch.stack(fracs).reshape(dp_loc + [tp_loc, E]), mesh,
                            P(*all_axes))
        aux_f = every.reshape(n_shards, E).sum(dim=0) / n_shards
    parts = torch.stack([E * torch.sum(aux_f * mp) * cfg.router_aux_weight / n_shards
                         for mp in mean_ps])
    aux = ShardSum.apply(parts.reshape(dp_loc + [tp_loc]), mesh, all_axes)

    ys = []
    for i in range(n_dp):
        bufs = torch.stack([dispatched[i * tp_loc + j][0] for j in range(tp_loc)])
        send = bufs.reshape(tp_loc, tp, E_loc, C, d)     # [my shard][owner shard]
        recv = AllToAll.apply(send, mesh, "model") if tp > 1 else send
        outs = []
        for k in range(tp_loc):                          # each expert owner's slots
            tok_in = recv[k].transpose(0, 1).reshape(E_loc, tp * C, d)
            w = {n: ex[n][i][k * E_loc:(k + 1) * E_loc] for n in ex}
            y_sl = _experts(tok_in, w["w_gate"], w["w_up"], w["w_down"], x.dtype)
            outs.append(y_sl.reshape(E_loc, tp, C, d).transpose(0, 1))   # [to shard]
        back = torch.stack(outs)                          # [my owner shard][to shard]
        mine = AllToAll.apply(back, mesh, "model") if tp > 1 else back
        for j in range(tp_loc):
            s = i * tp_loc + j
            _, _, w_of, slot_of = dispatched[s]
            y_tok = _combine(mine[j].reshape(E, C, d), w_of, slot_of, x.dtype)
            if cfg.n_shared_experts:
                sp = {n: shared[n][s] for n in shared}
                y_tok = y_tok + swiglu(xs[i, j], sp["w_gate"], sp["w_up"], sp["w_down"])
            ys.append(y_tok)
    y = torch.stack(ys).reshape(n_dp, tp_loc, rows, cols, d).transpose(1, 2)
    return y.reshape(x.shape), aux
