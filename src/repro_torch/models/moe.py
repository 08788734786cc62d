"""Mixture-of-Experts FFN: top-k router + capacity dispatch, one shard.

The reference groups the dispatch by data shard and, under an active mesh,
takes an expert-parallel path with two all-to-alls over its ``model`` axis
(``_moe_ffn_ep``).  One card holds one shard, so ``moe_ffn`` is the
reference's local path with one group (``G = 1``), the path every serve
call and every train step of the reference runs without a mesh; the
expert-parallel path and its ``_local_dispatch`` come with the mesh half of
training (ROADMAP.md queue 1, item 9, slice 4).

The backward passes through the router's top-k values and the gate
renormalisation to the router, and through ``mean_p`` in the Switch aux;
the expert choices and the capacity drops carry no gradient, as in the
reference.  The dispatch ``xt[t_s]`` and the combine ``contrib[slot]``
differentiate to float scatter-adds, made deterministic on the card by
PyTorch's deterministic mode (``train/step.py::deterministic``).

Router aux loss follows Switch (load-balance: E · Σ_e f_e · p_e).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, swiglu


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


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    return _moe_ffn_local(cfg, p, x)


def dropped_assignments(cfg: ModelConfig, gate_idx: torch.Tensor) -> int:
    """Assignments a call over ``gate_idx`` (T, K) drops: each expert keeps
    its first ``capacity(cfg, T)`` (a host sync: for reports)."""
    counts = torch.bincount(gate_idx.reshape(-1), minlength=cfg.n_experts)
    return int((counts - capacity(cfg, gate_idx.shape[0])).clamp_min(0).sum())


def _moe_ffn_local(cfg: ModelConfig, p, x: torch.Tensor):
    """Single-shard path: sort-based capacity dispatch, all experts at once,
    a deterministic combine."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    dev = x.device
    xt = x.reshape(T, d)

    gate_idx, gate_vals, frac, mean_p = _router(cfg, xt, p["router"])
    aux = E * torch.sum(frac * mean_p) * cfg.router_aux_weight

    # ---- sort-based dispatch: rank of each assignment within its expert ----
    C = capacity(cfg, T)
    N = T * K
    flat_e = gate_idx.reshape(N)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    e_s = flat_e[order]
    t_s = flat_t[order]
    w_s = gate_vals.reshape(N)[order]
    first = torch.searchsorted(e_s, e_s, side="left")
    rank = torch.arange(N, device=dev) - first
    keep = rank < C
    # slot e * C + rank; a dropped assignment goes to the scratch slot E * C,
    # which is sliced off (the reference's mode="drop" scatter)
    slot = torch.where(keep, e_s * C + rank, E * C)

    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = xt[t_s]
    w_of_slot = torch.zeros(E * C + 1, dtype=torch.float32, device=dev)
    w_of_slot[slot] = torch.where(keep, w_s, 0.0)
    buf = buf[: E * C].reshape(E, C, d)

    # ---- expert compute: all experts at once ----
    ex = p["experts"]
    hg = torch.bmm(buf, ex["w_gate"])
    hu = torch.bmm(buf, ex["w_up"])
    h = F.silu(hg.float()).to(x.dtype) * hu
    y_slots = torch.bmm(h, ex["w_down"])                       # (E, C, d)

    # ---- combine: each token adds its kept slots in ascending expert
    # order, from zeros in x.dtype, each add rounded to x.dtype (the order
    # of the reference's scatter-add, without float atomics) ----
    contrib = y_slots.reshape(E * C, d) * w_of_slot[: E * C, None].to(x.dtype)
    contrib = torch.cat([contrib, contrib.new_zeros((1, d))])  # the scratch slot: 0
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot                                      # (t, j) -> its slot
    slot_of = slot_of.reshape(T, K)
    by_expert = torch.argsort(gate_idx, dim=-1, stable=True)
    slot_of = torch.gather(slot_of, 1, by_expert)
    y = torch.zeros((T, d), dtype=x.dtype, device=dev)
    for j in range(K):
        y = y + contrib[slot_of[:, j]]

    if cfg.n_shared_experts:
        sp = p["shared"]
        y = y + swiglu(xt, sp["w_gate"], sp["w_up"], sp["w_down"])
    return y.reshape(B, S, d), aux
