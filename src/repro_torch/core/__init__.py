"""The unified interval-aware graph index: build, entry acquisition, search,
streaming updates."""
from repro_torch.core.intervals import FLAG_BOTH, FLAG_IF, FLAG_IS, Semantics, as_sem_flags
from repro_torch.core.build import UGConfig, build_ug
from repro_torch.core.exact import DenseGraph, build_exact, greedy_monotonic_path
from repro_torch.core.entry import (
    EntryIndex, build_entry_index, get_entry, get_entry_batch, get_entry_batch_flags,
    get_entry_flags,
)
from repro_torch.core.store import IndexStore, VectorPlane, make_store
from repro_torch.core.index import UGIndex, recall
from repro_torch.core.search import (
    SearchResult, beam_search, beam_search_flags, brute_force, search, search_mixed,
)
from repro_torch.core.updates import (
    compact, delete_batch, insert, insert_batch, repair_deleted, update_memory_profile,
)

__all__ = [
    "FLAG_BOTH", "FLAG_IF", "FLAG_IS", "Semantics", "as_sem_flags",
    "UGConfig", "build_ug", "DenseGraph", "build_exact", "greedy_monotonic_path",
    "EntryIndex", "build_entry_index", "get_entry", "get_entry_batch",
    "get_entry_batch_flags", "get_entry_flags", "IndexStore", "VectorPlane", "make_store",
    "UGIndex", "recall", "SearchResult", "beam_search", "beam_search_flags",
    "brute_force", "search", "search_mixed",
    "compact", "delete_batch", "insert", "insert_batch", "repair_deleted",
    "update_memory_profile",
]
