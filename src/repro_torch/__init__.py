"""PyTorch/CUDA port of the unified interval-aware graph index (UG).

Laid out module for module like the JAX package ``repro``, which stays the
reference it is tested against.  Plain tensor code is PyTorch; each Pallas
kernel of the reference on the ported path has a hand-written CUDA kernel
for Hopper (``kernels/csrc``) beside a plain PyTorch version that computes
the same bits.  Entry points run on the card unless ``device="cpu"``.
"""
