"""The unified interval-aware graph index: build, entry acquisition, search."""
from repro_torch.core.intervals import FLAG_BOTH, FLAG_IF, FLAG_IS, Semantics, as_sem_flags
from repro_torch.core.build import UGConfig, build_ug
from repro_torch.core.exact import DenseGraph
from repro_torch.core.entry import EntryIndex, build_entry_index, get_entry_batch_flags
from repro_torch.core.store import IndexStore, VectorPlane, make_store
from repro_torch.core.index import UGIndex, recall
from repro_torch.core.search import (
    SearchResult, beam_search, beam_search_flags, brute_force, search, search_mixed,
)

__all__ = [
    "FLAG_BOTH", "FLAG_IF", "FLAG_IS", "Semantics", "as_sem_flags",
    "UGConfig", "build_ug", "DenseGraph", "EntryIndex", "build_entry_index",
    "get_entry_batch_flags", "IndexStore", "VectorPlane", "make_store",
    "UGIndex", "recall", "SearchResult", "beam_search", "beam_search_flags",
    "brute_force", "search", "search_mixed",
]
