"""Model API: one surface over the four architecture families.

``Model`` bundles the family-dispatched functions every launcher needs:
``init``/``shapes``/``specs``/``shardings``/``loss``/``forward`` (the
train path) and the serve
path ``prefill``/``init_decode_state``/``decode_step``, over the decoder
(dense and MoE), rwkv6, zamba2 and encdec families.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import encdec, rwkv_model, transformer, zamba
from repro_torch.models.common import ModelConfig, init_params, param_shardings, param_specs


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator) -> Any:
        """Parameters drawn from ``generator``, on its device."""
        return init_params(self.cfg, mode="init", generator=generator)

    def shapes(self) -> Any:
        """The parameter tree as ``meta`` tensors (no memory)."""
        return init_params(self.cfg, mode="shape")

    def specs(self, mesh, rules=None) -> Any:
        """Each leaf's spec over ``mesh`` (``common.param_specs``)."""
        return param_specs(self.cfg, mesh, rules)

    def shardings(self, mesh, rules=None) -> Any:
        """Each leaf's ``NamedSharding`` over ``mesh``."""
        return param_shardings(self.cfg, mesh, rules)

    # ------------------------------------------------------------- train
    def loss(self, params, batch):
        """``(scalar loss, {"ce", "aux"})`` of one batch: ``tokens``,
        ``labels``, ``mask`` (and ``frames`` for the encdec family)."""
        f = {
            "decoder": transformer.loss_fn,
            "encdec": encdec.loss_fn,
            "rwkv6": rwkv_model.loss_fn,
            "zamba2": zamba.loss_fn,
        }[self.cfg.family]
        return f(self.cfg, params, batch)

    def forward(self, params, tokens, **kw):
        """Token-only forward: (hidden, aux, caches|None).  The encdec family
        has none (its decoder needs the encoder's frames), as in the
        reference."""
        f = {
            "decoder": transformer.forward,
            "rwkv6": rwkv_model.forward,
            "zamba2": zamba.forward,
        }.get(self.cfg.family)
        if f is None:
            raise ValueError(f"the {self.cfg.family} family has no token-only forward: "
                             f"use Model.prefill with frames")
        return f(self.cfg, params, tokens, **kw)

    # ------------------------------------------------------------- serve
    def prefill(self, params, batch):
        cfg = self.cfg
        if cfg.family == "decoder":
            return transformer.prefill(cfg, params, batch["tokens"])
        if cfg.family == "encdec":
            enc_out = encdec.encode(cfg, params, batch["frames"])
            return encdec.decode_train(cfg, params, batch["tokens"], enc_out), None
        if cfg.family == "rwkv6":
            hidden, _, _ = rwkv_model.forward(cfg, params, batch["tokens"])
            return hidden, None
        if cfg.family == "zamba2":
            hidden, _, caches = zamba.forward(cfg, params, batch["tokens"], collect_cache=True)
            return hidden, caches
        raise ValueError(cfg.family)

    def init_decode_state(self, params_or_batch, batch_size: int, max_len: int):
        """An empty decode state on the parameters' device.  The encdec
        family takes ``(params, frames)``: its state holds the encoder's
        cross K/V."""
        cfg = self.cfg
        if cfg.family == "encdec":
            if not isinstance(params_or_batch, tuple):
                raise ValueError("the encdec family's decode state needs (params, frames): "
                                 "its cross-attention reads the encoded frames")
            params, frames = params_or_batch
            return encdec.init_state(cfg, params, frames, batch_size, max_len)
        dev = params_or_batch["embed"].device
        if cfg.family == "decoder":
            return transformer.init_cache(cfg, batch_size, max_len, device=dev)
        if cfg.family == "rwkv6":
            return rwkv_model.init_state(cfg, batch_size, max_len, device=dev)
        if cfg.family == "zamba2":
            return zamba.init_state(cfg, batch_size, max_len, device=dev)
        raise ValueError(cfg.family)

    def decode_step(self, params, state, tokens):
        f = {
            "decoder": transformer.decode_step,
            "encdec": encdec.decode_step,
            "rwkv6": rwkv_model.decode_step,
            "zamba2": zamba.decode_step,
        }[self.cfg.family]
        return f(self.cfg, params, state, tokens)


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
