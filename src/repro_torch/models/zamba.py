"""Zamba2 hybrid: Mamba2 (SSD) backbone + one SHARED attention block applied
after every group of ``L // sites`` mamba layers (weight reuse is the Zamba
signature).

As in the reference: a single shared transformer block without
per-invocation LoRA deltas, applied after each group, seeing the raw
residual stream; each site keeps its own KV cache.  Layers that do not fill
a group (``L - sites * per``) run after the last site.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.kernels.util import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import shard_ctx, ssm
from repro_torch.models.common import ModelConfig, remat, rms_norm, swiglu
from repro_torch.models.transformer import (
    _stack, embed_tokens, layer, lm_loss, unembed, unstack,
)


def _d_inner(cfg: ModelConfig) -> int:
    return 2 * cfg.d_model


def n_attn_sites(cfg: ModelConfig) -> int:
    return max(cfg.n_layers // cfg.attn_every, 1)


def build_params(cfg: ModelConfig, b):
    di = _d_inner(cfg)
    shared = {
        "ln1": b((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn.build_gqa_params(cfg, b, prefix_layers=False),
        "ln2": b((cfg.d_model,), ("embed",), init="ones"),
        "mlp": {
            "w_gate": b((cfg.d_model, cfg.d_ff), ("embed", "mlp")),
            "w_up": b((cfg.d_model, cfg.d_ff), ("embed", "mlp")),
            "w_down": b((cfg.d_ff, cfg.d_model), ("mlp", "embed")),
        },
    }
    return {
        "embed": b((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=0.02),
        "mamba": ssm.build_mamba2_params(cfg, b, di),
        "shared_attn": shared,
        "ln_f": b((cfg.d_model,), ("embed",), init="ones"),
        "unembed": b((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


def tp_groups(cfg: ModelConfig) -> tuple[list[shard_ctx.Group], tuple]:
    """The groups the tensor-parallel step may split along ``model``
    (``shard_ctx.plan_groups``): the Mamba2 heads (``w_in`` and
    ``conv_w`` gathered, then partial; ``w_bc`` partial), the shared
    block's attention heads and MLP columns (its leaves have no layer
    dimension), the vocab."""
    m = lambda k: ("mamba", k)  # noqa: E731
    mlp = ("shared_attn", "mlp")
    ssm_heads = {m(k): 1 for k in ("dt_bias", "a_log", "d_skip", "gn", "w_out")}
    ssm_heads[m("w_dt")] = 2
    return ([shard_ctx.Group("ssm_heads", ssm_heads, partial=(m("w_bc"),),
                             gathered=(m("w_in"), m("conv_w"))),
             *attn.tp_groups(cfg, ("shared_attn", "attn"), stacked=False),
             shard_ctx.Group("mlp", {mlp + ("w_gate",): 1, mlp + ("w_up",): 1,
                                     mlp + ("w_down",): 0}),
             shard_ctx.Group("vocab", {("embed",): 0, ("unembed",): 1})], ())


def _shared_block(cfg, p, x, positions, cache=None, cache_len=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cache is None:
        a, kv = attn.gqa_attend(cfg, p["attn"], h, positions, causal=True)
    else:
        a, kv = attn.gqa_attend(cfg, p["attn"], h, positions, cache=cache, cache_len=cache_len)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"]), kv


def _groups(cfg: ModelConfig) -> tuple[int, int, int]:
    """(sites, mamba layers a group, trailing layers after the last site)."""
    sites = n_attn_sites(cfg)
    per = cfg.n_layers // sites
    return sites, per, cfg.n_layers - sites * per


def forward(cfg: ModelConfig, params, tokens, *, collect_cache=False):
    """Training/prefill forward.  Returns (hidden, 0.0, attn_kv_caches|None),
    the caches a (k, v) pair of (sites, B, S, KV, hd)."""
    di = _d_inner(cfg)
    x = embed_tokens(cfg, params, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    sites, per, rem = _groups(cfg)
    # the reference's remat sites: the mamba body and the shared block
    mamba_body = remat(cfg, lambda xx, p_l: ssm.mamba2_block(cfg, p_l, xx, di)[0])
    shared_body = remat(cfg, lambda xx, p: _shared_block(cfg, p, xx, positions))
    mamba = unstack(params["mamba"])
    kvs = []
    for g in range(sites):
        for p_l in mamba[g * per:(g + 1) * per]:
            x = mamba_body(x, p_l)
        x, kv = shared_body(x, params["shared_attn"])
        kvs.append(kv)
    for p_l in mamba[sites * per:sites * per + rem]:
        x = mamba_body(x, p_l)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, 0.0, (_stack(kvs) if collect_cache else None)


def loss_fn(cfg: ModelConfig, params, batch):
    hidden, aux, _ = forward(cfg, params, batch["tokens"])
    ce = lm_loss(cfg, params, hidden, batch["labels"], batch["mask"])
    return ce + aux, {"ce": ce, "aux": aux}


class ZambaState(NamedTuple):
    ssm_state: Any            # (L, B, H, N, 64) stacked mamba states, float32
    conv_state: Any           # (L, B, 3, channels)
    attn_cache: Any           # per-site KV: (sites, B, S, KV, hd) ×2
    cache_len: torch.Tensor   # (B,)


def init_state(cfg: ModelConfig, batch: int, max_len: int, *, device=None) -> ZambaState:
    """An empty decode state on ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    di = _d_inner(cfg)
    H = di // ssm.MAMBA_HEAD
    kv_shape = (n_attn_sites(cfg), batch, max_len, cfg.n_kv_heads, cfg.hd)
    return ZambaState(
        torch.zeros((cfg.n_layers, batch, H, cfg.ssm_state, ssm.MAMBA_HEAD),
                    dtype=torch.float32, device=dev),
        torch.zeros((cfg.n_layers, batch, 3, di + 2 * cfg.ssm_state), dtype=cfg.dtype,
                    device=dev),
        (torch.zeros(kv_shape, dtype=cfg.dtype, device=dev),
         torch.zeros(kv_shape, dtype=cfg.dtype, device=dev)),
        torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def decode_step(cfg: ModelConfig, params, state: ZambaState, tokens):
    di = _d_inner(cfg)
    x = params["embed"][tokens.long()]
    positions = state.cache_len[:, None]
    sites, per, rem = _groups(cfg)
    new_ssm, new_conv, new_kv = [], [], []

    def mamba(i, xx):
        y, (s, c) = ssm.mamba2_block(cfg, layer(params["mamba"], i), xx, di,
                                     state=state.ssm_state[i], conv_state=state.conv_state[i])
        new_ssm.append(s)
        new_conv.append(c)
        return y

    for g in range(sites):
        for i in range(g * per, (g + 1) * per):
            x = mamba(i, x)
        x, kv = _shared_block(cfg, params["shared_attn"], x, positions,
                              cache=layer(state.attn_cache, g), cache_len=state.cache_len)
        new_kv.append(kv)
    for i in range(sites * per, sites * per + rem):
        x = mamba(i, x)

    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = unembed(cfg, params, h)[:, 0]
    return ZambaState(torch.stack(new_ssm), torch.stack(new_conv), _stack(new_kv),
                      state.cache_len + 1), logits
