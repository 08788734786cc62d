"""rwkv6-1.6b 'Finch' [ssm; arXiv:2404.05892; unverified]: attention-free,
24L d=2048 (32 heads of 64) d_ff=7168 vocab=65536, data-dependent decay.
O(1) decode state => runs the long_500k cell."""
import dataclasses
import torch
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="rwkv6",
    n_layers=24, d_model=2048, n_heads=32, d_ff=7168, vocab=65536,
    ssm_chunk=128, dtype=torch.bfloat16, logits_chunk=512,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=512,
        ssm_chunk=16, dtype=torch.float32, logits_chunk=64,
    )
