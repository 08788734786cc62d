"""Architecture registry + the four assigned input shapes.

``input_specs`` returns the input tree of one (config, shape) cell for the
step the shape runs (train for train_4k, prefill for prefill_32k, a decode
step for decode_*/long_*): zero tensors (``concrete=True``) or ``meta``
tensors (no memory).

Skips: ``long_500k`` needs sub-quadratic attention, so only rwkv6 (SSM,
O(1) state) and zamba2 (hybrid) run it; the 8 pure full-attention archs
skip it.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

_SUBQUADRATIC = {"rwkv6-1.6b", "zamba2-2.7b"}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    module: str
    tag: str             # audio | vlm | moe | dense | ssm | hybrid

    @property
    def config(self) -> ModelConfig:
        return importlib.import_module(f"repro_torch.configs.{self.module}").CONFIG

    @property
    def reduced(self) -> ModelConfig:
        return importlib.import_module(f"repro_torch.configs.{self.module}").reduced()

    def skip_reason(self, shape: str) -> str | None:
        if shape == "long_500k" and self.name not in _SUBQUADRATIC:
            return (
                "long_500k needs sub-quadratic attention; "
                f"{self.name} is pure full-attention (DESIGN.md §5)"
            )
        return None


ARCHS: dict[str, ArchSpec] = {
    s.name: s
    for s in [
        ArchSpec("seamless-m4t-medium", "seamless_m4t_medium", "audio"),
        ArchSpec("chameleon-34b", "chameleon_34b", "vlm"),
        ArchSpec("qwen3-moe-235b-a22b", "qwen3_moe_235b_a22b", "moe"),
        ArchSpec("llama4-maverick-400b-a17b", "llama4_maverick_400b_a17b", "moe"),
        ArchSpec("minicpm3-4b", "minicpm3_4b", "dense"),
        ArchSpec("qwen1.5-4b", "qwen15_4b", "dense"),
        ArchSpec("qwen3-32b", "qwen3_32b", "dense"),
        ArchSpec("starcoder2-15b", "starcoder2_15b", "dense"),
        ArchSpec("rwkv6-1.6b", "rwkv6_16b", "ssm"),
        ArchSpec("zamba2-2.7b", "zamba2_27b", "hybrid"),
    ]
}


def get_arch(name: str) -> ArchSpec:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted(ARCHS)


# ---------------------------------------------------------------------------
# Input specs per (config, shape)
# ---------------------------------------------------------------------------
def input_specs(
    cfg: ModelConfig,
    shape: ShapeSpec,
    *,
    concrete: bool = False,
    batch_override: int | None = None,
    seq_override: int | None = None,
    device=None,
):
    """Input tree for one cell: zero tensors on ``device`` (``None`` = the
    card) with ``concrete=True``, else ``meta`` tensors.

    train   -> {tokens, labels, mask[, frames]}
    prefill -> {"tokens" [, "frames"]}
    decode  -> {"state": DecodeState, "tokens": (B, 1)}
    """
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    dev = _device(concrete, device)

    def mk(s, dtype):
        return torch.zeros(s, dtype=dtype, device=dev)

    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            half = S // 2
            out = {"frames": mk((B, half, cfg.d_model), torch.float32),
                   "tokens": mk((B, half), torch.int32)}
        else:
            out = {"tokens": mk((B, S), torch.int32)}
        if shape.kind == "train":
            S_lab = out["tokens"].shape[1]
            out["labels"] = mk((B, S_lab), torch.int32)
            out["mask"] = mk((B, S_lab), torch.float32)
        return out

    # decode: one new token against a cache of S
    state = decode_state_specs(cfg, B, S, concrete=concrete, device=device)
    return {"state": state, "tokens": mk((B, 1), torch.int32)}


def decode_state_specs(cfg: ModelConfig, B: int, S: int, *, concrete: bool = False,
                       device=None):
    """Decode-state tree: ``meta`` tensors by default, zeros on ``device``
    (``None`` = the card) if concrete."""
    from repro_torch.models import encdec, rwkv_model, transformer, zamba

    dev = _device(concrete, device)
    if cfg.family == "decoder":
        return transformer.init_cache(cfg, B, S, device=dev)
    if cfg.family == "rwkv6":
        return rwkv_model.init_state(cfg, B, S, device=dev)
    if cfg.family == "zamba2":
        return zamba.init_state(cfg, B, S, device=dev)
    if cfg.family == "encdec":
        # self-attn cache at S plus precomputed cross-attn KV over S//8 frames
        kv_shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
        x_shape = (cfg.n_layers, B, max(S // 8, 1), cfg.n_kv_heads, cfg.hd)

        def z(shape):
            return torch.zeros(shape, dtype=cfg.dtype, device=dev)

        return encdec.EncDecState((z(kv_shape), z(kv_shape)), (z(x_shape), z(x_shape)),
                                  torch.zeros((B,), dtype=torch.int32, device=dev))
    raise ValueError(cfg.family)


def _device(concrete: bool, device):
    from repro_torch.kernels.util import resolve_device

    return resolve_device(device) if concrete else torch.device("meta")
