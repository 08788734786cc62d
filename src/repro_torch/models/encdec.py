"""Encoder-decoder transformer (seamless-m4t backbone).

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d_model).  The decoder is a causal
stack with cross-attention whose K/V come from the encoder output (made
once, by ``init_state`` for decoding; decode never grows them).  The
cross-attention queries are roped at the decoder's positions, its keys at
the encoder's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import shard_ctx
from repro_torch.models.common import ModelConfig, remat, rms_norm, swiglu
from repro_torch.models.transformer import (
    _stack, embed_tokens, layer, lm_loss, unembed, unstack,
)


def _ffn_params(cfg, b, L, lax_):
    return {
        "w_gate": b(L + (cfg.d_model, cfg.d_ff), lax_ + ("embed", "mlp")),
        "w_up": b(L + (cfg.d_model, cfg.d_ff), lax_ + ("embed", "mlp")),
        "w_down": b(L + (cfg.d_ff, cfg.d_model), lax_ + ("mlp", "embed")),
    }


def build_params(cfg: ModelConfig, b):
    enc_l = cfg.enc_layers or cfg.n_layers
    Le, Ld = (enc_l,), (cfg.n_layers,)
    lax_ = ("layers",)
    enc = {
        "ln1": b(Le + (cfg.d_model,), lax_ + ("embed",), init="ones"),
        "attn": attn.build_gqa_params(dataclasses.replace(cfg, n_layers=enc_l), b),
        "ln2": b(Le + (cfg.d_model,), lax_ + ("embed",), init="ones"),
        "mlp": _ffn_params(cfg, b, Le, lax_),
    }
    dec = {
        "ln1": b(Ld + (cfg.d_model,), lax_ + ("embed",), init="ones"),
        "self_attn": attn.build_gqa_params(cfg, b),
        "ln_x": b(Ld + (cfg.d_model,), lax_ + ("embed",), init="ones"),
        "cross_attn": attn.build_gqa_params(cfg, b),
        "ln2": b(Ld + (cfg.d_model,), lax_ + ("embed",), init="ones"),
        "mlp": _ffn_params(cfg, b, Ld, lax_),
    }
    return {
        "frame_proj": b((cfg.d_model, cfg.d_model), ("embed", "mlp")),
        "embed": b((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=0.02),
        "encoder": enc,
        "decoder": dec,
        "ln_enc": b((cfg.d_model,), ("embed",), init="ones"),
        "ln_f": b((cfg.d_model,), ("embed",), init="ones"),
        "unembed": b((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


def tp_groups(cfg: ModelConfig) -> tuple[list[shard_ctx.Group], tuple]:
    """The groups the tensor-parallel step may split along ``model``
    (``shard_ctx.plan_groups``), and the leaves that always run whole: the
    encoder's, the decoder's and the cross attention's heads, the MLPs'
    columns, the vocab; ``frame_proj``, whose columns are the encoder
    input's channels, whole (as RWKV6's ``w_ffn_r``)."""
    mlp = {}
    for stack in ("encoder", "decoder"):
        m = (stack, "mlp")
        mlp.update({m + ("w_gate",): 2, m + ("w_up",): 2, m + ("w_down",): 1})
    return ([g for prefix in (("encoder", "attn"), ("decoder", "self_attn"),
                              ("decoder", "cross_attn"))
             for g in attn.tp_groups(cfg, prefix, stacked=True)]
            + [shard_ctx.Group("mlp", mlp),
               shard_ctx.Group("vocab", {("embed",): 0, ("unembed",): 1})],
            (("frame_proj",),))


def _ffn(p_l, h):
    return swiglu(h, p_l["mlp"]["w_gate"], p_l["mlp"]["w_up"], p_l["mlp"]["w_down"])


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device).expand(B, S)


def encode(cfg: ModelConfig, params, frames):
    """frames (B, S_enc, d_model) -> encoder output (B, S_enc, d_model);
    non-causal self-attention."""
    x = frames.to(cfg.dtype) @ params["frame_proj"]
    positions = _positions(x)

    def blk(xx, p_l):
        h = rms_norm(xx, p_l["ln1"], cfg.norm_eps)
        a, _ = attn.gqa_attend(cfg, p_l["attn"], h, positions, causal=False)
        xx = xx + a
        return xx + _ffn(p_l, rms_norm(xx, p_l["ln2"], cfg.norm_eps))

    body = remat(cfg, blk)
    for p_l in unstack(params["encoder"]):
        x = body(x, p_l)
    return rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _dec_block(cfg, p_l, x, positions, enc_kvs, self_cache=None, cache_len=None):
    """One decoder layer; ``enc_kvs``: its cross attention's (K, V), one
    pair a local shard (``attention.cross_kv_shards``)."""
    h = rms_norm(x, p_l["ln1"], cfg.norm_eps)
    if self_cache is None:
        a, kv = attn.gqa_attend(cfg, p_l["self_attn"], h, positions, causal=True)
    else:
        a, kv = attn.gqa_attend(cfg, p_l["self_attn"], h, positions, cache=self_cache,
                                cache_len=cache_len)
    x = x + a
    h = rms_norm(x, p_l["ln_x"], cfg.norm_eps)
    x = x + attn.gqa_cross(cfg, p_l["cross_attn"], h, positions, enc_kvs)
    x = x + _ffn(p_l, rms_norm(x, p_l["ln2"], cfg.norm_eps))
    return x, kv


def cross_kv(cfg: ModelConfig, params, enc_out):
    """Every decoder layer's cross-attention (K, V) of the encoder output,
    stacked (L, B, S_enc, KV, hd); K roped at the encoder's positions."""
    positions = _positions(enc_out)
    kvs = [attn.cross_kv_shards(cfg, p_l["cross_attn"], [enc_out], positions)[0]
           for p_l in unstack(params["decoder"])]
    return tuple(torch.stack(t) for t in zip(*kvs))


def decode_train(cfg: ModelConfig, params, tokens, enc_out):
    """The decoder over ``tokens`` reading ``enc_out``.  ``enc_out`` enters
    the context that splits "heads" once, and each layer's cross attention
    makes and reads only the local shards' kv heads' K/V."""
    x = embed_tokens(cfg, params, tokens)
    positions = _positions(x)
    dec = unstack(params["decoder"])
    source, enc_pos = shard_ctx.split("heads").enter(enc_out), _positions(enc_out)
    enc_kvs = [attn.cross_kv_shards(cfg, p_l["cross_attn"], source, enc_pos) for p_l in dec]
    body = remat(cfg, lambda xx, p_l, ekv: _dec_block(cfg, p_l, xx, positions, ekv)[0])
    for p_l, ekv in zip(dec, enc_kvs):
        x = body(x, p_l, ekv)
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def loss_fn(cfg: ModelConfig, params, batch):
    """The decoder's cross-entropy over ``batch["frames"]`` encoded; no aux."""
    enc_out = encode(cfg, params, batch["frames"])
    hidden = decode_train(cfg, params, batch["tokens"], enc_out)
    ce = lm_loss(cfg, params, hidden, batch["labels"], batch["mask"])
    return ce, {"ce": ce, "aux": 0.0}


class EncDecState(NamedTuple):
    self_cache: Any           # (k, v), each (L, B, max_len, KV, hd)
    enc_kvs: Any              # (k, v), each (L, B, S_enc, KV, hd)
    cache_len: torch.Tensor   # (B,)


def init_state(cfg: ModelConfig, params, frames, batch: int, max_len: int) -> EncDecState:
    """Encodes ``frames`` once and keeps the cross K/V; an empty self-attention
    cache on the parameters' device."""
    enc_out = encode(cfg, params, frames)
    enc_kvs = cross_kv(cfg, params, enc_out)
    dev = params["embed"].device
    kv_shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    cache = (torch.zeros(kv_shape, dtype=cfg.dtype, device=dev),
             torch.zeros(kv_shape, dtype=cfg.dtype, device=dev))
    return EncDecState(cache, enc_kvs, torch.zeros((batch,), dtype=torch.int32, device=dev))


def decode_step(cfg: ModelConfig, params, state: EncDecState, tokens):
    x = params["embed"][tokens.long()]
    positions = state.cache_len[:, None]
    caches = []
    for i in range(cfg.n_layers):
        x, nc = _dec_block(cfg, layer(params["decoder"], i), x, positions,
                           [layer(state.enc_kvs, i)], self_cache=layer(state.self_cache, i),
                           cache_len=state.cache_len)
        caches.append(nc)
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = unembed(cfg, params, h)[:, 0]
    return EncDecState(_stack(caches), state.enc_kvs, state.cache_len + 1), logits
