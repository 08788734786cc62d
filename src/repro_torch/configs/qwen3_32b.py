"""qwen3-32b [dense; hf:Qwen/Qwen3-* family; hf]: 64L d=5120 64H (kv=8,
head_dim=128) d_ff=25600 vocab=151936, qk-norm."""
import dataclasses
import torch
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="decoder",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab=151936, qk_norm=True, dtype=torch.bfloat16,
    logits_chunk=256,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, dtype=torch.float32, logits_chunk=64,
    )
