"""seamless-m4t-medium [audio; arXiv:2308.11596; hf]: enc-dec multimodal.
12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.  The speech frontend is
a STUB: input_specs provides precomputed frame embeddings to the encoder."""
import dataclasses
import torch
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, dtype=torch.bfloat16, logits_chunk=128,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, dtype=torch.float32, logits_chunk=64,
    )
