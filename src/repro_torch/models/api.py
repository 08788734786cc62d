"""Model API: one surface over the architecture families.

``Model`` bundles the functions every launcher needs: ``init``/``shapes``/
``forward`` and the serve path ``prefill``/``init_decode_state``/
``decode_step``.  The decoder family's dense configs are ported; the other
families and MoE blocks raise ``NotImplementedError`` naming ROADMAP.md
queue 1, item 9, slice 2, and ``loss`` names slice 3.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import transformer
from repro_torch.models.common import SLICE_FAMILIES, SLICE_TRAINING, ModelConfig, init_params


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def _ported(self) -> None:
        if self.cfg.family != "decoder":
            raise NotImplementedError(
                f"the {self.cfg.family} family is not ported yet ({SLICE_FAMILIES})")
        if self.cfg.moe:
            raise NotImplementedError(f"MoE blocks are not ported yet ({SLICE_FAMILIES})")

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator) -> Any:
        """Parameters drawn from ``generator``, on its device."""
        self._ported()
        return init_params(self.cfg, mode="init", generator=generator)

    def shapes(self) -> Any:
        """The parameter tree as ``meta`` tensors (no memory)."""
        self._ported()
        return init_params(self.cfg, mode="shape")

    # ------------------------------------------------------------- train
    def loss(self, params, batch):
        raise NotImplementedError(f"the training losses are not ported yet ({SLICE_TRAINING})")

    def forward(self, params, tokens, **kw):
        self._ported()
        return transformer.forward(self.cfg, params, tokens, **kw)

    # ------------------------------------------------------------- serve
    def prefill(self, params, batch):
        self._ported()
        return transformer.prefill(self.cfg, params, batch["tokens"])

    def init_decode_state(self, params, batch_size: int, max_len: int):
        """An empty decode state on the parameters' device."""
        self._ported()
        return transformer.init_cache(self.cfg, batch_size, max_len,
                                      device=params["embed"].device)

    def decode_step(self, params, state, tokens):
        self._ported()
        return transformer.decode_step(self.cfg, params, state, tokens)


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
