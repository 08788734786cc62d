"""qwen1.5-4b [dense; hf:Qwen/Qwen1.5-* family; hf]: 40L d=2560 20H (kv=20)
d_ff=6912 vocab=151936 with QKV bias (the qwen1.5 signature)."""
import dataclasses
import torch
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="decoder",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_ff=6912,
    vocab=151936, qkv_bias=True, dtype=torch.bfloat16, logits_chunk=256,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, dtype=torch.float32, logits_chunk=64,
    )
