"""llama4-maverick-400b-a17b [moe; hf:meta-llama/Llama-4-*; unverified]:
48L d=5120 40H (kv=8, head_dim=128) vocab=202048; MoE every other layer with
128 experts top-1 (d_ff=8192) + one shared expert; interleaved dense layers
use d_ff=16384.  Early-fusion vision (VQ-token stub)."""
import dataclasses
import torch
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="decoder",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048,
    moe=True, n_experts=128, top_k=1, moe_d_ff=8192, n_shared_experts=1,
    moe_every=2, dense_d_ff=16384,
    dtype=torch.bfloat16, logits_chunk=128,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, moe_d_ff=64, dense_d_ff=128, n_experts=8, top_k=1,
        vocab=512, dtype=torch.float32, logits_chunk=64,
    )
