"""chameleon-34b [vlm; arXiv:2405.09818; unverified]: early-fusion decoder,
VQ image tokens share the text vocab.  48L d=8192 64H (kv=8) d_ff=22016
vocab=65536, qk-norm (the chameleon training-stability fix)."""
import dataclasses
import torch
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="decoder",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=65536, qk_norm=True, dtype=torch.bfloat16, logits_chunk=256,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, dtype=torch.float32, logits_chunk=64,
    )
