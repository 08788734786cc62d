"""minicpm3-4b [dense; hf:openbmb/MiniCPM3-4B; hf]: 62L d=2560 40H (kv=40)
d_ff=6400 vocab=73448 with MLA (multi-head latent attention): q_lora=768,
kv_lora=256, rope_head_dim=32, nope/v head_dim=64."""
import dataclasses
import torch
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="decoder",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=6400, vocab=73448,
    mla=True, q_lora_rank=768, kv_lora_rank=256, rope_head_dim=32,
    dtype=torch.bfloat16, logits_chunk=512,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
        dtype=torch.float32, logits_chunk=64,
    )
