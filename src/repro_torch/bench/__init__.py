"""The paper-table bench entry point of the port (``python -m
repro_torch.bench.run``): Exp-1 to Exp-5 and the kernel table, on the card
unless ``--device cpu``."""
