"""IndexStore: the one index structure every layer of the port shares.

It holds a vector plane (the scoring representation of the corpus), the
interval column, the graph (``nbrs``/``status``), the entry structure
(Alg. 5) and the streaming allocator masks.  Only the ``f32`` plane and a
static index (``alive = free = None``, no rerank plane) are ported so far;
the other plane tags raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.entry import EntryIndex, build_entry_index
from repro_torch.core.exact import DenseGraph
from repro_torch.kernels.util import resolve_device

PLANE_TAGS = ("f32", "bf16", "int8", "pq")
_NOT_PORTED = ("plane tag {tag!r} is not ported yet "
               "(ROADMAP.md queue 1, item 6 'Quantized planes')")


@dataclasses.dataclass(frozen=True)
class VectorPlane:
    """One storage representation of the corpus vectors."""

    tag: str                  # only "f32" so far
    data: torch.Tensor        # (cap, d) float32

    @classmethod
    def encode(cls, x: torch.Tensor, tag: str) -> "VectorPlane":
        if tag not in PLANE_TAGS:
            raise ValueError(f"unknown plane tag {tag!r} (choices {PLANE_TAGS})")
        if tag != "f32":
            raise NotImplementedError(_NOT_PORTED.format(tag=tag))
        return cls(tag, x.to(torch.float32).contiguous())

    def decode(self) -> torch.Tensor:
        """The (cap, d) f32 view: the same buffer for ``f32``."""
        return self.data

    def memory_bytes(self) -> int:
        return int(self.data.numel() * self.data.element_size())

    def bytes_per_vector(self, n_live: int | None = None) -> float:
        n = self.data.shape[0] if n_live is None else n_live
        return self.memory_bytes() / max(n, 1)


@dataclasses.dataclass(frozen=True)
class IndexStore:
    """Plane + intervals + graph + entry + allocator masks."""

    plane: VectorPlane
    rerank: VectorPlane | None    # exact f32 plane for final re-scoring
    intervals: torch.Tensor       # (cap, 2) f32
    nbrs: torch.Tensor            # (cap, M) int32, -1 padded
    status: torch.Tensor          # (cap, M) uint8 semantic bitmask
    entry: EntryIndex | None
    alive: torch.Tensor | None = None  # (cap,) bool; None = all live
    free: torch.Tensor | None = None   # (cap,) bool; None = none free

    @property
    def capacity(self) -> int:
        return self.nbrs.shape[0]

    @property
    def device(self) -> torch.device:
        return self.nbrs.device

    @property
    def graph(self) -> DenseGraph:
        """DenseGraph view over the same buffers (no copy)."""
        return DenseGraph(self.nbrs, self.status)

    def vectors_f32(self) -> torch.Tensor:
        """Best-precision f32 vectors: the rerank plane when present, else
        the decoded scan plane (the same buffer for an f32 plane)."""
        if self.rerank is not None:
            return self.rerank.data
        return self.plane.decode()

    def memory_bytes(self) -> dict:
        """Per-component byte counts."""
        nbytes = lambda t: int(t.numel() * t.element_size())
        out = {
            "plane": self.plane.memory_bytes(),
            "rerank": 0 if self.rerank is None else self.rerank.memory_bytes(),
            "graph": nbytes(self.nbrs) + nbytes(self.status),
            "intervals": nbytes(self.intervals),
            "entry": 0 if self.entry is None else sum(nbytes(a) for a in self.entry.arrays()),
            "masks": (0 if self.alive is None else self.capacity)
            + (0 if self.free is None else self.capacity),
        }
        out["total"] = sum(out.values())
        return out


def as_tensor(a, dtype, device) -> torch.Tensor:
    """A contiguous ``dtype`` tensor on ``device`` from a tensor or array."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def make_store(
    x,
    intervals,
    nbrs,
    status,
    *,
    dtype: str = "f32",
    device=None,
) -> IndexStore:
    """Assemble an :class:`IndexStore` from f32 vectors and graph arrays
    (numpy arrays or tensors) on ``device`` (``None`` = the card); the
    entry structure is built from the intervals."""
    dev = resolve_device(device)
    intervals = as_tensor(intervals, torch.float32, dev)
    return IndexStore(
        plane=VectorPlane.encode(as_tensor(x, torch.float32, dev), dtype),
        rerank=None,
        intervals=intervals,
        nbrs=as_tensor(nbrs, torch.int32, dev),
        status=as_tensor(status, torch.uint8, dev),
        entry=build_entry_index(intervals),
    )
