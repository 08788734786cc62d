"""Checkpoints in the reference's step layout, with async save and the
UGIndex round trip (allocator state included)."""
from repro_torch.ckpt.store import (
    AsyncCheckpointer, latest_step, restore, restore_index, save, save_index,
)

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "restore_index", "save",
           "save_index"]
