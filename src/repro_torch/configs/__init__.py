"""Assigned-architecture configs (public literature; see each file's source
tag).  ``registry.get_arch(name)`` is the entry point every ``--arch`` flag
uses."""
from repro_torch.configs.registry import ARCHS, ArchSpec, get_arch, list_archs

__all__ = ["ARCHS", "ArchSpec", "get_arch", "list_archs"]
