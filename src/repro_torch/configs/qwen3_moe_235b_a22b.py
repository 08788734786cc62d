"""qwen3-moe-235b-a22b [moe; hf:Qwen/Qwen3-30B-A3B scaled; hf]: 94L
d=4096 64H (kv=4, head_dim=128) vocab=151936, MoE 128 experts top-8 with
expert d_ff=1536 (fine-grained experts), qk-norm per qwen3."""
import dataclasses
import torch
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="decoder",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, qk_norm=True,
    moe=True, n_experts=128, top_k=8, moe_d_ff=1536,
    dtype=torch.bfloat16, logits_chunk=256,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, moe_d_ff=64, n_experts=8, top_k=2, vocab=512,
        dtype=torch.float32, logits_chunk=64,
    )
