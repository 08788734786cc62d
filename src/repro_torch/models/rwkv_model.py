"""RWKV6 (Finch) full model: attention-free LM with O(1) decode state.

The layers run one after another on the per-layer trees of the stacked
blocks (``transformer.unstack``), each checkpointed with ``cfg.remat`` as
the reference's scan body is.  The decode path runs the same block with ``S = 1`` and the carried state
(``chunked_linear_attention`` with chunk 1), as the reference's does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.util import resolve_device
from repro_torch.models import shard_ctx, ssm
from repro_torch.models.common import ModelConfig, remat, rms_norm
from repro_torch.models.transformer import embed_tokens, layer, lm_loss, unembed, unstack


def tp_groups(cfg: ModelConfig) -> tuple[list[shard_ctx.Group], tuple]:
    """The groups the tensor-parallel step may split along ``model``
    (``shard_ctx.plan_groups``), and the leaves that always run whole: the
    time-mix heads with ``w_g``'s columns (the mixes and ``decay_lora_a``
    partial), the channel-mix's columns, the vocab; ``w_ffn_r``, whose
    columns are the residual's channels, whole (gathering the leaf moves
    fewer bytes than gathering its output's columns)."""
    b = lambda k: ("blocks", k)  # noqa: E731
    time_mix = {b(k): 2 for k in ("w_r", "w_k", "w_v", "w_g", "decay_lora_b")}
    time_mix.update({b(k): 1 for k in ("w_o", "decay_base", "bonus", "gn")})
    return ([shard_ctx.Group("heads", time_mix,
                             partial=tuple(b(k) for k in ssm.TIME_MIX_COPIES)),
             shard_ctx.Group("mlp", {b("w_ffn_k"): 2, b("w_ffn_v"): 1}),
             shard_ctx.Group("vocab", {("embed",): 0, ("unembed",): 1})],
            (b("w_ffn_r"),))


def forward(cfg: ModelConfig, params, tokens):
    """Returns (hidden, 0.0, None): no aux loss, no cache."""
    x = embed_tokens(cfg, params, tokens)
    body = remat(cfg, lambda xx, p_l: ssm.rwkv6_block(cfg, p_l, xx)[0])
    for p_l in unstack(params["blocks"]):
        x = body(x, p_l)
    return rms_norm(x, params["ln_out"], cfg.norm_eps), 0.0, None


def loss_fn(cfg: ModelConfig, params, batch):
    hidden, aux, _ = forward(cfg, params, batch["tokens"])
    ce = lm_loss(cfg, params, hidden, batch["labels"], batch["mask"])
    return ce + aux, {"ce": ce, "aux": aux}


class RwkvState(NamedTuple):
    wkv: torch.Tensor        # (L, B, H, hd, hd) float32
    shift_a: torch.Tensor    # (L, B, 1, d)
    shift_b: torch.Tensor    # (L, B, 1, d)
    cache_len: torch.Tensor  # (B,) position counter (no KV growth — O(1) state)


def init_state(cfg: ModelConfig, batch: int, max_len: int = 0, *, device=None) -> RwkvState:
    """An empty decode state on ``device`` (``None`` = the card); ``max_len``
    is taken and unused: the state does not grow."""
    dev = resolve_device(device)
    d = cfg.d_model
    H, hd = ssm.rwkv6_heads(cfg)
    L = cfg.n_layers
    return RwkvState(
        torch.zeros((L, batch, H, hd, hd), dtype=torch.float32, device=dev),
        torch.zeros((L, batch, 1, d), dtype=cfg.dtype, device=dev),
        torch.zeros((L, batch, 1, d), dtype=cfg.dtype, device=dev),
        torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def decode_step(cfg: ModelConfig, params, state: RwkvState, tokens):
    """One token through all layers; the recurrent state replaces any KV."""
    x = params["embed"][tokens.long()]           # (B, 1, d)
    wkv, sa, sb = [], [], []
    for i in range(cfg.n_layers):
        x, (nw, nsa, nsb) = ssm.rwkv6_block(
            cfg, layer(params["blocks"], i), x,
            state=(state.wkv[i], state.shift_a[i], state.shift_b[i]))
        wkv.append(nw)
        sa.append(nsa)
        sb.append(nsb)
    h = rms_norm(x, params["ln_out"], cfg.norm_eps)
    logits = unembed(cfg, params, h)[:, 0]
    return RwkvState(torch.stack(wkv), torch.stack(sa), torch.stack(sb),
                     state.cache_len + 1), logits
