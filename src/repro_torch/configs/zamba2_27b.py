"""zamba2-2.7b [hybrid; arXiv:2411.15242; hf]: 54L d=2560 Mamba2 backbone
(ssm_state=64) + a SHARED GQA attention block (32H kv=32, d_ff=10240)
applied every 6 layers.  Hybrid => runs the long_500k cell (attention KV
exists only at the 9 shared sites)."""
import dataclasses
import torch
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="zamba2",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, ssm_state=64, ssm_chunk=128, attn_every=6,
    dtype=torch.bfloat16, logits_chunk=512,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, ssm_state=16, ssm_chunk=16, attn_every=2,
        dtype=torch.float32, logits_chunk=64,
    )
