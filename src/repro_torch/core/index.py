"""UGIndex: the user-facing unified interval-aware index (paper §4).

One physical graph with a per-edge semantic bitmask answers IFANN, ISANN,
RFANN and RSANN queries.  The index is a thin host-side handle around one
:class:`~repro_torch.core.store.IndexStore`.

``save``/``load`` use the reference's on-disk format (``index.npz`` +
``meta.json``: ``x`` and ``intervals`` float32, ``nbrs`` int32, ``status``
uint8), so an index crosses between the two packages in either direction.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch.core import intervals as iv
from repro_torch.core.build import UGConfig, build_ug
from repro_torch.core.exact import DenseGraph
from repro_torch.core.search import SearchResult, brute_force
from repro_torch.core.search import search as core_search
from repro_torch.core.search import search_mixed as core_search_mixed
from repro_torch.core.store import IndexStore, as_tensor, make_store
from repro_torch.kernels.util import no_tf32, resolve_device


def _on(a, device) -> torch.Tensor:
    return as_tensor(a, torch.float32, device)


@dataclasses.dataclass
class UGIndex:
    """Unified graph index: one :class:`IndexStore` + its build config."""

    store: IndexStore
    config: UGConfig
    build_seconds: float = 0.0

    # --------------------------------------------------------- store views
    @property
    def x(self) -> torch.Tensor:
        return self.store.vectors_f32()

    @property
    def intervals(self) -> torch.Tensor:
        return self.store.intervals

    @property
    def graph(self) -> DenseGraph:
        return self.store.graph

    @property
    def device(self) -> torch.device:
        return self.store.device

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, x, intervals, config: UGConfig = UGConfig(), seed: int = 0,
              progress=None, *, dtype: str = "f32", device=None) -> "UGIndex":
        """Alg. 1–3 build on ``device`` (``None`` = the card).  NN-descent
        draws from a ``torch.Generator`` seeded with ``seed``."""
        dev = resolve_device(device)
        no_tf32()
        x = _on(x, dev)
        intervals = _on(intervals, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        t0 = time.perf_counter()
        graph = build_ug(gen, x, intervals, config, progress)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        store = make_store(x, intervals, graph.nbrs, graph.status, dtype=dtype, device=dev)
        return cls(store, config, dt)

    # ----------------------------------------------------------------- search
    def search(self, q_v, q_int, *, sem: iv.Semantics = iv.Semantics.IF, ef: int = 64,
               k: int = 10, max_steps: int = 0, backend: str | None = None,
               width: int = 4) -> SearchResult:
        """Alg. 5 + Alg. 4 for one semantics."""
        return core_search(self.store, _on(q_v, self.device), _on(q_int, self.device),
                           sem=sem, ef=ef, k=k, max_steps=max_steps,
                           backend=backend, width=width)

    def search_mixed(self, q_v, q_int, sem_flags, *, ef: int = 64, k: int = 10,
                     max_steps: int = 0, backend: str | None = None,
                     width: int = 4) -> SearchResult:
        """Alg. 5 + Alg. 4 for a batch whose queries each carry their own
        semantics (a sequence of :class:`Semantics`, a flag tensor, or one
        ``Semantics``)."""
        return core_search_mixed(self.store, _on(q_v, self.device), _on(q_int, self.device),
                                 sem_flags, ef=ef, k=k, max_steps=max_steps,
                                 backend=backend, width=width)

    def ground_truth(self, q_v, q_int, *, sem: iv.Semantics, k: int) -> SearchResult:
        """Exact predicate-filtered top-k over the f32 vectors."""
        no_tf32()
        return brute_force(self.x, self.intervals, _on(q_v, self.device),
                           _on(q_int, self.device), sem=sem, k=k)

    # ------------------------------------------------------------------ stats
    @property
    def n(self) -> int:
        return self.store.capacity

    def memory_bytes(self) -> int:
        """Graph + entry + allocator bytes (the index overhead; the vector
        planes are in :meth:`vector_memory_bytes`)."""
        m = self.store.memory_bytes()
        return int(m["graph"] + m["entry"] + m["masks"])

    def vector_memory_bytes(self) -> dict:
        m = self.store.memory_bytes()
        return {
            "plane": m["plane"],
            "rerank": m["rerank"],
            "plane_bytes_per_vector": self.store.plane.bytes_per_vector(self.n),
        }

    def degree_stats(self) -> dict:
        g = self.graph
        d_if = g.degree(iv.FLAG_IF).cpu().numpy()
        d_is = g.degree(iv.FLAG_IS).cpu().numpy()
        return {
            "mean_if": float(d_if.mean()),
            "mean_is": float(d_is.mean()),
            "max_if": int(d_if.max()),
            "max_is": int(d_is.max()),
            "edges": int((g.nbrs >= 0).sum()),
        }

    # ------------------------------------------------------------------- io
    def save(self, path: str | pathlib.Path) -> None:
        """Write ``index.npz`` + ``meta.json`` in the reference's format."""
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        st = self.store
        np.savez_compressed(
            path / "index.npz",
            x=st.plane.data.cpu().numpy().astype(np.float32),
            intervals=st.intervals.cpu().numpy().astype(np.float32),
            nbrs=st.nbrs.cpu().numpy().astype(np.int32),
            status=st.status.cpu().numpy().astype(np.uint8),
        )
        meta = dataclasses.asdict(self.config)
        meta["build_seconds"] = self.build_seconds
        meta["dtype"] = st.plane.tag
        (path / "meta.json").write_text(json.dumps(meta, indent=2))

    @classmethod
    def load(cls, path: str | pathlib.Path, device=None) -> "UGIndex":
        """Read an index the reference (or the port) saved; the entry index is
        rebuilt from the intervals."""
        dev = resolve_device(device)
        path = pathlib.Path(path)
        meta = json.loads((path / "meta.json").read_text())
        build_seconds = meta.pop("build_seconds", 0.0)
        tag = meta.pop("dtype", "f32")
        cfg = UGConfig(**meta)
        with np.load(path / "index.npz") as blob:
            extra = sorted(set(blob.files) - {"x", "intervals", "nbrs", "status"})
            if extra:
                raise NotImplementedError(
                    f"index arrays {extra} (tombstones, rerank or quantized planes) are not "
                    "ported yet (ROADMAP.md queue 1, items 6 and 8)")
            arrays = {k: blob[k] for k in ("x", "intervals", "nbrs", "status")}
        store = make_store(arrays["x"], arrays["intervals"], arrays["nbrs"], arrays["status"],
                           dtype=tag, device=dev)
        return cls(store, cfg, build_seconds)


def recall(result: SearchResult, truth: SearchResult) -> float:
    """recall@k as in the paper §5.1 (set overlap with brute-force truth)."""
    r = result.ids.cpu().numpy()
    t = truth.ids.cpu().numpy()
    hits = 0
    denom = 0
    for i in range(r.shape[0]):
        tset = set(int(v) for v in t[i] if v >= 0)
        if not tset:
            continue
        rset = set(int(v) for v in r[i] if v >= 0)
        hits += len(tset & rset)
        denom += len(tset)
    return hits / max(denom, 1)
