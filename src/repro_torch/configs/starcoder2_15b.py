"""starcoder2-15b [dense; arXiv:2402.19173; hf]: 40L d=6144 48H (kv=4,
head_dim=128) d_ff=24576 vocab=49152, GQA + RoPE."""
import dataclasses
import torch
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="decoder",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab=49152, gated_mlp=False, dtype=torch.bfloat16,
    logits_chunk=512,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, dtype=torch.float32, logits_chunk=64,
    )
