"""Hand-written CUDA kernels for Hopper with their plain PyTorch versions.

``ops`` dispatches between them and holds the launch counters; ``ref``
holds the test oracles.  Nothing here builds or touches a card at import.
"""
