"""Decoder-only transformer LM covering 8 of the 10 assigned archs: GQA
with qkv-bias or qk-norm, MLA, SwiGLU or plain GELU MLP, MoE (with
llama4's interleaved dense/MoE super-layers), early-fusion embeddings.

Layers are stacked (a leading ``n_layers`` axis on every block parameter,
as the reference stacks them for its ``lax.scan``) and run one after
another on the per-layer trees :func:`unstack` takes with one
``torch.unbind`` a leaf.  With ``cfg.remat`` each block is checkpointed
(``common.checkpointed``): the backward recomputes it from its input.
``lm_loss`` is chunked cross-entropy whose ``(B, C, vocab)`` logits exist
one chunk at a time, in the forward and, recomputed, in the backward.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.util import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import shard_ctx
from repro_torch.models.common import (
    ModelConfig, checkpointed, remat, rms_norm, swiglu, tree_leaves, tree_map,
)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _build_blocks(cfg: ModelConfig, b, n_layers: int, *, moe: bool, d_ff: int):
    import dataclasses

    L = (n_layers,)
    lax_ = ("layers",)
    cfg_l = dataclasses.replace(cfg, n_layers=n_layers)
    blocks: dict[str, Any] = {
        "ln1": b(L + (cfg.d_model,), lax_ + ("embed",), init="ones"),
        "ln2": b(L + (cfg.d_model,), lax_ + ("embed",), init="ones"),
    }
    if cfg.mla:
        blocks["attn"] = attn.build_mla_params(cfg_l, b)
    else:
        blocks["attn"] = attn.build_gqa_params(cfg_l, b)
    if moe:
        blocks["moe"] = moe_lib.build_moe_params(cfg_l, b)
    elif cfg.gated_mlp:
        blocks["mlp"] = {
            "w_gate": b(L + (cfg.d_model, d_ff), lax_ + ("embed", "mlp")),
            "w_up": b(L + (cfg.d_model, d_ff), lax_ + ("embed", "mlp")),
            "w_down": b(L + (d_ff, cfg.d_model), lax_ + ("mlp", "embed")),
        }
    else:  # plain 2-matrix GELU MLP (starcoder2 / GPT-BigCode style)
        blocks["mlp"] = {
            "w_up": b(L + (cfg.d_model, d_ff), lax_ + ("embed", "mlp")),
            "w_down": b(L + (d_ff, cfg.d_model), lax_ + ("mlp", "embed")),
        }
    return blocks


def interleaved(cfg: ModelConfig) -> bool:
    """llama4-style stacks: each super-layer is ``moe_every - 1`` dense
    blocks (``dense_blocks``, at ``dense_d_ff``) followed by one MoE block
    (``blocks``)."""
    return cfg.moe and cfg.moe_every > 1


def build_params(cfg: ModelConfig, b):
    if interleaved(cfg):
        n_super = cfg.n_layers // cfg.moe_every
        blocks = _build_blocks(cfg, b, n_super, moe=True, d_ff=cfg.d_ff)
        dense = _build_blocks(cfg, b, n_super * (cfg.moe_every - 1), moe=False,
                              d_ff=cfg.dense_d_ff or cfg.d_ff)
    else:
        blocks = _build_blocks(cfg, b, cfg.n_layers, moe=cfg.moe, d_ff=cfg.d_ff)
        dense = None
    params = {
        "embed": b((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=0.02),
        "blocks": blocks,
        "ln_f": b((cfg.d_model,), ("embed",), init="ones"),
    }
    if dense is not None:
        params["dense_blocks"] = dense
    if not cfg.tie_embeddings:
        params["unembed"] = b((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return params


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------
def _stacks(cfg: ModelConfig) -> tuple[str, ...]:
    """The stacked block trees of ``cfg``'s parameters."""
    if cfg.family == "decoder":
        return ("blocks", "dense_blocks") if interleaved(cfg) else ("blocks",)
    return {"rwkv6": ("blocks",), "zamba2": ("mamba",), "encdec": ("encoder", "decoder")}[
        cfg.family]


def tp_copy_dim(cfg: ModelConfig, path: tuple) -> int:
    """Where the tensor-parallel step puts a partial leaf's copies, one a
    local ``model`` shard: after its layer dimension (a stacked leaf), else
    first (zamba2's shared block)."""
    return 1 if path[0] in _stacks(cfg) else 0


def _family_plan(cfg: ModelConfig, specs) -> tuple[frozenset, frozenset, frozenset]:
    """``shard_ctx.plan_groups`` of rwkv6's, zamba2's or encdec's groups."""
    from repro_torch.models import encdec, rwkv_model, zamba

    groups, whole = {"rwkv6": rwkv_model.tp_groups, "zamba2": zamba.tp_groups,
                     "encdec": encdec.tp_groups}[cfg.family](cfg)
    return shard_ctx.plan_groups(groups, dict(tree_leaves(specs)), whole)


def _split_dims(cfg: ModelConfig, by_columns: bool = False) -> dict[tuple, tuple[str, int]]:
    """Each leaf a tensor-parallel step may split along ``model``: its
    product group (``shard_ctx.GROUPS``) and the dimension of the split
    (an MoE config's experts along their expert dimension, or
    ``by_columns`` along each expert's ``d_ff`` columns)."""
    dims = {("embed",): ("vocab", 0), ("unembed",): ("vocab", 1)}
    for stack in _stacks(cfg):
        a, m = (stack, "attn"), (stack, "mlp")
        dims.update({a + ("wo",): ("heads", 1), m + ("w_up",): ("mlp", 2),
                     m + ("w_down",): ("mlp", 1), m + ("w_gate",): ("mlp", 2)})
        if cfg.mla:
            dims.update({a + (k,): ("heads", 2) for k in ("w_uq", "w_uk", "w_uv")})
        else:
            dims.update({a + ("wq",): ("heads", 2), a + ("wk",): ("kv_heads", 2),
                         a + ("wv",): ("kv_heads", 2), a + ("bq",): ("heads", 1),
                         a + ("bk",): ("kv_heads", 1), a + ("bv",): ("kv_heads", 1)})
    if cfg.moe:
        e, sh = ("blocks", "moe", "experts"), ("blocks", "moe", "shared")
        dims.update({e + (k,): ("expert_mlp", d) if by_columns else ("expert", 1)
                     for k, d in (("w_gate", 3), ("w_up", 3), ("w_down", 2))})
        dims.update({("blocks", "moe", "router"): ("expert", 2), sh + ("w_gate",): ("mlp", 2),
                     sh + ("w_up",): ("mlp", 2), sh + ("w_down",): ("mlp", 1)})
    return dims


def tp_plan(cfg: ModelConfig, specs, mesh) -> tuple[frozenset, frozenset] | None:
    """How the mesh step splits ``cfg``'s products over ``mesh``'s ``model``
    axis: ``None`` unless ``model`` has several shards; else ``(split
    groups, partial leaves)`` under the parameters' ``specs``: the product
    groups whose leaves the specs split along ``model``, and the paths of
    the leaves that feed split compute whole (their shards' gradients are
    partial: the attention's norm gammas, ``wk``/``wv`` and their biases
    where the kv heads are not split, MLA's latent projections; RWKV6's
    mixes and ``decay_lora_a``; Mamba2's ``w_bc``, ``w_in`` and
    ``conv_w``).  Every one of the ten archs has a plan: the dense
    decoders (qwen1.5-4b, qwen3-32b, starcoder2-15b, chameleon-34b,
    minicpm3-4b) and the MoE archs (qwen3-moe-235b-a22b,
    llama4-maverick-400b-a17b) as below; rwkv6-1.6b, zamba2-2.7b and
    seamless-m4t-medium by their groups (``rwkv_model``, ``zamba``,
    ``encdec``'s ``tp_groups``; ``shard_ctx.plan_groups``), a group split
    only where every leaf of it splits as its computation reads it, else
    run whole with its split leaves gathered (:func:`tp_gathered`).  An
    MoE config's
    experts split along their expert dimension (group ``"expert"``: ``E /
    model`` experts a shard; its router, split with them, is gathered whole,
    :func:`tp_gathered`), or where ``E`` does not divide ``model`` and the
    specs split each expert's ``d_ff`` columns, along those (group
    ``"expert_mlp"``), as XLA's partitioner serves that spec; experts split
    along neither are a spec it cannot serve.  The decoders' serve step
    (``launch/dryrun.py``'s ``prefill_step``/``serve_step``) splits the
    same groups: ``"heads"`` (with ``"kv_heads"`` where they divide),
    ``"mlp"`` (the shared expert's too), ``"vocab"`` (the embedding rows and
    the logits' columns) and ``"expert"``/``"expert_mlp"``, the router
    gathered whole; it adds ``"sequence"`` where its cache splits along
    ``model`` by position.  Raises ``ValueError`` naming a leaf whose spec
    the tensor-parallel path cannot serve."""
    if "model" not in mesh.axes or mesh.size("model") == 1:
        return None
    if cfg.family != "decoder":
        return _family_plan(cfg, specs)[:2]
    by_columns = False
    if cfg.moe:
        ex = specs["blocks"]["moe"]["experts"]
        by_columns = ex["w_gate"][1] != "model"
        for k, col in (("w_gate", 3), ("w_up", 3), ("w_down", 2)):
            if ex[k][col if by_columns else 1] != "model":
                raise ValueError(f"the tensor-parallel step cannot serve blocks/moe/experts/{k} "
                                 f"under its spec {ex[k]}: its {cfg.n_experts} experts split "
                                 f"along model ({mesh.size('model')} shards) by neither their "
                                 "experts nor their columns")
    dims = _split_dims(cfg, by_columns)
    seen: dict[str, bool] = {}
    for path, spec in tree_leaves(specs):
        at = [i for i, e in enumerate(spec)
              if e == "model" or (isinstance(e, tuple) and "model" in e)]
        group, dim = dims.get(path, (None, None))
        if at and (group is None or at != [dim] or spec[dim] != "model"):
            raise ValueError(f"the tensor-parallel step cannot serve {'/'.join(path)} under "
                             f"its spec {spec}")
        if group is not None and seen.setdefault(group, bool(at)) != bool(at):
            raise ValueError(f"the tensor-parallel step cannot serve {'/'.join(path)} under "
                             f"its spec {spec}: the other {group} leaves are "
                             f"{'' if seen[group] else 'not '}split along model")
    split = frozenset(g for g, s in seen.items() if s)
    if "kv_heads" in split and "heads" not in split:
        raise ValueError("the tensor-parallel step cannot serve blocks/attn/wk: its kv heads "
                         "are split along model, its query heads are not")
    names: tuple = ()
    if "heads" in split and cfg.mla:
        names = ("w_dq", "q_norm", "w_dkv", "kv_norm")
    elif "heads" in split:
        names = ("q_norm", "k_norm") if cfg.qk_norm else ()
        if "kv_heads" not in split:
            names += ("wk", "wv") + (("bk", "bv") if cfg.qkv_bias else ())
    return split, frozenset((stack, "attn", k) for stack in _stacks(cfg) for k in names)


def tp_gathered(cfg: ModelConfig, specs=None) -> frozenset:
    """The leaves the tensor-parallel step gathers along ``model`` as well:
    an MoE config's router, whose softmax and top-k need every expert's
    logit; for rwkv6, zamba2 and encdec (under ``specs``) the split leaves
    of each group that runs whole, the leaves that always run whole
    (RWKV6's ``w_ffn_r``, encdec's ``frame_proj``) and Mamba2's ``w_in``
    and ``conv_w``.  Their compute runs whole on every shard, so each
    process's gradient of them is complete, but for those the plan also
    lists as partial (Mamba2's two: each shard reads its heads' columns),
    which are summed over ``model``."""
    if cfg.family != "decoder":
        return _family_plan(cfg, specs)[2]
    return frozenset({("blocks", "moe", "router")}) if cfg.moe else frozenset()


def layer(blocks, i: int):
    """The parameters (or cache) of layer ``i`` of a stacked tree."""
    if isinstance(blocks, tuple):
        return tuple(a[i] for a in blocks)
    return tree_map(lambda a: a[i], blocks)


def unstack(blocks) -> list:
    """Every layer's tree of a stacked tree (nested dicts or a tuple), by one
    ``torch.unbind`` of each leaf.  Its backward stacks the layers'
    gradients once; a select ``a[i]`` a layer would add a zero tensor of
    the whole ``(L, ...)`` leaf per layer in the backward."""
    if isinstance(blocks, (dict, tuple)):
        keys = sorted(blocks) if isinstance(blocks, dict) else range(len(blocks))
        parts = {k: unstack(blocks[k]) for k in keys}
        n = len(parts[next(iter(keys))])
        if isinstance(blocks, dict):
            return [{k: parts[k][i] for k in blocks} for i in range(n)]
        return [tuple(parts[k][i] for k in keys) for i in range(n)]
    return list(torch.unbind(blocks, 0))


def _stack(per_layer: list):
    """Per-layer (a, b) cache pairs as one stacked (L, ...) pair."""
    return tuple(torch.stack(parts) for parts in zip(*per_layer))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _ffn(cfg: ModelConfig, p_l, h):
    # dispatch on the block's own parameters: interleaved configs mix dense
    # and MoE blocks under one cfg
    if "moe" in p_l:
        return moe_lib.moe_ffn(cfg, p_l["moe"], h)
    mlp = p_l["mlp"]
    if "w_gate" not in mlp:
        # jax.nn.gelu's default is the tanh approximation; under a context
        # that splits "mlp", w_up is column- and w_down row-parallel
        tp = shard_ctx.split("mlp")
        parts = []
        for hj, wu, wd in zip(tp.enter(h), tp.shards(mlp["w_up"], -1),
                              tp.shards(mlp["w_down"], -2)):
            a = F.gelu((hj @ wu).float(), approximate="tanh").to(h.dtype)
            parts.append(a @ wd)
        return tp.leave(parts), 0.0
    return swiglu(h, mlp["w_gate"], mlp["w_up"], mlp["w_down"]), 0.0


def block_train(cfg: ModelConfig, p_l, x, positions):
    """One decoder block, full-sequence causal.  Returns (x, aux, kv)."""
    h = rms_norm(x, p_l["ln1"], cfg.norm_eps)
    if cfg.mla:
        a, kv = attn.mla_attend_train(cfg, p_l["attn"], h, positions)
    else:
        a, kv = attn.gqa_attend(cfg, p_l["attn"], h, positions, causal=True)
    x = x + a
    h = rms_norm(x, p_l["ln2"], cfg.norm_eps)
    f, aux = _ffn(cfg, p_l, h)
    return x + f, aux, kv


def block_decode(cfg: ModelConfig, p_l, x, positions, cache_l, cache_len):
    """One decoder block, one step against its cache: (x, aux, new cache).
    Under the serve step's tensor-parallel context ``cache_l`` is the
    process's block of the layer's cache (``attention``'s module
    docstring) and the attention and FFN compute its shards' heads,
    columns and experts."""
    h = rms_norm(x, p_l["ln1"], cfg.norm_eps)
    if cfg.mla:
        a, new_cache = attn.mla_attend_decode(cfg, p_l["attn"], h, positions, cache_l, cache_len)
    else:
        a, new_cache = attn.gqa_attend(cfg, p_l["attn"], h, positions, cache=cache_l,
                                       cache_len=cache_len)
    x = x + a
    h = rms_norm(x, p_l["ln2"], cfg.norm_eps)
    f, aux = _ffn(cfg, p_l, h)
    return x + f, aux, new_cache


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------
def layer_order(cfg: ModelConfig, params) -> list:
    """Each layer's parameters in the order the layers run: for interleaved
    configs, super-layer by super-layer, its dense blocks then its MoE
    block (the order the caches are stacked in, ``(L, ...)``)."""
    if not interleaved(cfg):
        return unstack(params["blocks"])
    me = cfg.moe_every
    moe_layers, dense = unstack(params["blocks"]), unstack(params["dense_blocks"])
    order = []
    for s in range(cfg.n_layers // me):
        order += dense[s * (me - 1):(s + 1) * (me - 1)]
        order.append(moe_layers[s])
    return order


def embed_tokens(cfg: ModelConfig, params, tokens, embeds=None):
    """The token rows of ``embed``.  Under a context that splits "vocab"
    each local shard looks up the ids in its rows (0 for the others) and
    the rows are summed over ``model``: exactly one shard adds a non-zero
    row, so the sum is exact."""
    tp = shard_ctx.split("vocab")
    if tp.mesh is None:
        x = params["embed"][tokens.long()]
    else:
        parts = []
        for j, w in enumerate(tp.shards(params["embed"], 0)):
            local, inside = _vocab_ids(tokens, tp.shard(j), w.shape[0])
            parts.append(torch.where(inside[..., None], w[local], 0.0))
        x = tp.leave(parts)
    if embeds is not None:
        # early fusion: precomputed modality embeddings are prepended
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x


def forward(cfg: ModelConfig, params, tokens, *, embeds=None, collect_cache=False):
    """Full causal forward.  Returns (hidden, aux, caches|None); ``aux`` is
    the MoE blocks' router loss summed over layers (0.0 without MoE)."""
    x = embed_tokens(cfg, params, tokens, embeds)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    body = remat(cfg, lambda xx, p_l: block_train(cfg, p_l, xx, positions))
    aux = 0.0
    caches = []
    for p_l in layer_order(cfg, params):
        x, a, kv = body(x, p_l)
        aux = aux + a
        if collect_cache:
            caches.append(kv)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, aux, (_stack(caches) if collect_cache else None)


def unembed(cfg: ModelConfig, params, h):
    """The logits of ``h``: every vocab column, or under a tensor-parallel
    context that splits ``"vocab"`` the columns of the process's block of
    ``unembed`` (``embed``'s rows where tied), its local shards' in order."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return h @ w


def _chunk_ce(hc, yc, mc, w):
    """``Σ (logsumexp − gold logit) · mask`` of one (B, C) chunk, the logits
    in float32."""
    logits = (hc @ w).float()                                  # (B, C, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yc.long()[..., None])[..., 0]
    return torch.sum((lse - gold) * mc)


def _vocab_ids(ids, shard: int, rows: int):
    """``ids`` as rows of vocab shard ``shard`` (``rows`` a shard), clamped
    into it, and whether each lies in it."""
    local = ids.long() - shard * rows
    inside = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1), inside


def _chunk_ce_split(tp, hc, yc, mc, w):
    """:func:`_chunk_ce` with the vocab split over ``model``: each local
    shard's (B, C, V/size) float32 logits; the max over every shard
    (detached: the logsumexp's gradient does not depend on it); the
    shards' sums of ``exp(logit − max)`` and their gold logits (the shard
    that holds a label gives its logit, the others 0), summed over
    ``model`` in shard order."""
    logits = [(hj @ wj).float() for hj, wj in zip(tp.enter(hc), tp.shards(w, -1))]
    m = tp.max([lg.amax(dim=-1) for lg in logits])
    parts = []
    for j, lg in enumerate(logits):
        local, inside = _vocab_ids(yc, tp.shard(j), lg.shape[-1])
        gold = torch.gather(lg, -1, local[..., None])[..., 0]
        parts.append(torch.stack([torch.exp(lg - m[..., None]).sum(dim=-1),
                                  torch.where(inside, gold, 0.0)]))
    s, gold = tp.leave(parts)
    return torch.sum((m + torch.log(s) - gold) * mc)


def lm_loss(cfg: ModelConfig, params, hidden, labels, mask):
    """Chunked cross-entropy: the sequence in ``logits_chunk`` chunks (the
    last padded), each chunk's masked sum added in chunk order, over
    ``max(Σ mask, 1)``.  Each chunk is checkpointed, so its (B, C, vocab)
    logits are recomputed in the backward and never saved."""
    B, S, d = hidden.shape
    C = min(cfg.logits_chunk, S)
    n = (S + C - 1) // C
    pad = n * C - S
    h = F.pad(hidden, (0, 0, 0, pad)).reshape(B, n, C, d)
    y = F.pad(labels, (0, pad)).reshape(B, n, C)
    m = F.pad(mask, (0, pad)).reshape(B, n, C)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    tp = shard_ctx.split("vocab")
    chunk = _chunk_ce if tp.mesh is None else functools.partial(_chunk_ce_split, tp)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        total = total + checkpointed(chunk, h[:, i], y[:, i], m[:, i], w)
    return total / torch.clamp_min(torch.sum(mask), 1.0)


def loss_fn(cfg: ModelConfig, params, batch):
    """Scalar training loss (LM cross-entropy + MoE aux) and ``{"ce", "aux"}``;
    the early-fusion ``embeds`` positions carry no labels."""
    embeds = batch.get("embeds")
    hidden, aux, _ = forward(cfg, params, batch["tokens"], embeds=embeds)
    if embeds is not None:
        hidden = hidden[:, embeds.shape[1]:]
    ce = lm_loss(cfg, params, hidden, batch["labels"], batch["mask"])
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    cache: Any                  # per-layer stacked KV (or MLA latent) cache
    cache_len: torch.Tensor     # (B,) int32


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> tuple[tuple[int, ...], ...]:
    """The shapes of the decode cache's two leaves: (L, B, S, KV, hd) keys
    and values, or MLA's latent (L, B, S, r) and rotary (L, B, S, rd)."""
    L = cfg.n_layers
    if cfg.mla:
        return (L, batch, max_len, cfg.kv_lora_rank), (L, batch, max_len, cfg.rope_head_dim)
    return ((L, batch, max_len, cfg.n_kv_heads, cfg.hd),) * 2


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *, device=None):
    """An empty decode cache on ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    cache = tuple(torch.zeros(s, dtype=dtype, device=dev)
                  for s in cache_shapes(cfg, batch, max_len))
    return DecodeState(cache, torch.zeros((batch,), dtype=torch.int32, device=dev))


def prefill(cfg: ModelConfig, params, tokens, *, embeds=None):
    """Forward over the prompt; returns the hidden states and the caches.
    Under the serve step's tensor-parallel context the caches are the
    process's block in ``launch/shardings.py::decode_state_specs``'s
    layout (its kv heads, or its blocks of positions of every kv head)."""
    hidden, _, caches = forward(cfg, params, tokens, embeds=embeds, collect_cache=True)
    return hidden, caches


def decode_step(cfg: ModelConfig, params, state: DecodeState, tokens):
    """One decode step for the whole batch: tokens (B, 1) -> logits (B, V).
    Under the serve step's tensor-parallel context ``state`` holds the
    process's cache block and the logits are its vocab columns
    (:func:`unembed`)."""
    x = embed_tokens(cfg, params, tokens)
    positions = state.cache_len[:, None]
    caches = []
    for i, p_l in enumerate(layer_order(cfg, params)):
        x, _, nc = block_decode(cfg, p_l, x, positions, layer(state.cache, i), state.cache_len)
        caches.append(nc)
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = unembed(cfg, params, h)[:, 0]
    return DecodeState(_stack(caches), state.cache_len + 1), logits
