"""UGIndex: the user-facing unified interval-aware index (paper §4).

One physical graph with a per-edge semantic bitmask answers IFANN, ISANN,
RFANN and RSANN queries.  The index is a thin host-side handle around one
:class:`~repro_torch.core.store.IndexStore`.  Its arrays are sized to
``capacity`` slots; after streaming updates (``insert``/``delete``,
``core/updates.py``) ``alive`` marks the live nodes and ``free`` the slots
the allocator may hand out.  A built or loaded static index leaves both
``None``.

The graph is always built from the f32 vectors; ``dtype`` selects the scan
plane the search scores against (``f32``, ``bf16``, ``int8``, ``pq``) and
``rerank`` attaches the exact f32 plane (on by default for int8 and pq).

``save``/``load`` use the reference's on-disk format (``index.npz`` +
``meta.json``): ``x`` holds the scan plane in its own dtype (bf16 as a
uint16 bit view), ``intervals`` float32, ``nbrs`` int32, ``status`` uint8,
and where present ``x_scale``/``x_zero`` (int8), ``x_codebooks`` (pq) and
``rerank`` (f32), and on a mutated index ``alive``/``free`` (bool).  An
index crosses between the two packages in either
direction, and a saved plane is read back, never encoded again.
``meta.json``'s ``prune_backend`` is written under the reference's name for
the same role (:data:`SAVED_BACKEND`) and read back as the port's
(:data:`LOADED_BACKEND`), so either package can go on updating the index.
The index checkpoints of ``ckpt/store.py`` hold the same arrays and config
(:func:`host_arrays`, :func:`store_from_arrays`, :func:`saved_config`).
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
from repro_torch.core.entry import EntryIndex, build_entry_index
from repro_torch.core.store import IndexStore, VectorPlane, as_tensor, make_store
from repro_torch.kernels.util import no_tf32, resolve_device


# prune_backend in meta.json: the port's name -> the reference's for the
# same role (the hand-written kernel, the plain version), and back.
SAVED_BACKEND = {"cuda": "pallas", "torch": "xla", "legacy": "legacy", None: None}
LOADED_BACKEND = {
    "pallas": "cuda", "xla": "torch", "legacy": "legacy",
    "cuda": "cuda", "torch": "torch", None: None,   # as the port wrote them before
}


def _rename_backend(table: dict, name):
    if name not in table:
        raise ValueError(f"unknown prune_backend {name!r} in meta.json "
                         f"(choices {sorted(k for k in table if k)} or null)")
    return table[name]


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
    def entry(self) -> EntryIndex | None:
        return self.store.entry

    @property
    def alive(self) -> torch.Tensor | None:
        return self.store.alive

    @property
    def free(self) -> torch.Tensor | None:
        return self.store.free

    @property
    def device(self) -> torch.device:
        return self.store.device

    @property
    def dtype(self) -> str:
        """Scan-plane tag: ``f32`` | ``bf16`` | ``int8`` | ``pq``."""
        return self.store.plane.tag

    def with_store(self, store: IndexStore) -> "UGIndex":
        return dataclasses.replace(self, store=store)

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, x, intervals, config: UGConfig = UGConfig(), seed: int = 0,
              progress=None, *, dtype: str = "f32", rerank: bool | None = None,
              device=None) -> "UGIndex":
        """Alg. 1–3 build on ``device`` (``None`` = the card), then the plane
        encoding.  NN-descent draws from a ``torch.Generator`` seeded with
        ``seed``.  ``rerank`` defaults to on for int8 and pq."""
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
        if rerank is None:
            rerank = dtype in ("int8", "pq")
        store = make_store(x, intervals, graph.nbrs, graph.status, dtype=dtype,
                           rerank=rerank, device=dev)
        return cls(store, config, dt)

    def with_dtype(self, dtype: str, *, rerank: bool | None = None) -> "UGIndex":
        """Re-encode the vector planes from the best-precision f32 vectors:
        the same graph and ids, another scan plane (``rerank`` defaults to
        on for int8 and pq)."""
        if rerank is None:
            rerank = dtype in ("int8", "pq")
        x = self.store.vectors_f32()
        return self.with_store(self.store.replace(
            plane=VectorPlane.encode(x, dtype),
            rerank=VectorPlane.encode(x, "f32") if rerank else None))

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
        """Exact predicate-filtered top-k over the best-precision vectors
        (the rerank plane when present, else the decoded scan plane)."""
        no_tf32()
        return brute_force(self.x, self.intervals, _on(q_v, self.device),
                           _on(q_int, self.device), sem=sem, k=k, alive=self.alive)

    # ---------------------------------------------------------------- updates
    def insert(self, new_x, new_intervals, **kw) -> "UGIndex":
        """Batched streaming insert (``core/updates.py``); a new UGIndex."""
        from repro_torch.core.updates import insert_batch

        return insert_batch(self, new_x, new_intervals, **kw)

    def delete(self, ids, **kw) -> "UGIndex":
        """Batched tombstone delete and repair; a new UGIndex."""
        from repro_torch.core.updates import delete_batch

        return delete_batch(self, ids, **kw)

    def compact(self) -> "UGIndex":
        """Drop dead slots and remap the graph; a static UGIndex."""
        from repro_torch.core.updates import compact

        return compact(self)

    # ------------------------------------------------------------------ stats
    @property
    def capacity(self) -> int:
        """Allocated slots (live, tombstoned and free)."""
        return self.store.capacity

    @property
    def n(self) -> int:
        """Live node count (the capacity for a static index)."""
        return self.store.live_count()

    def memory_bytes(self) -> int:
        """Graph + entry + allocator bytes (the index overhead; the vector
        planes are in :meth:`vector_memory_bytes`)."""
        m = self.store.memory_bytes()
        return int(m["graph"] + m["entry"] + m["masks"])

    def vector_memory_bytes(self) -> dict:
        """Scan-plane and rerank-plane bytes, and scan-plane bytes per live
        vector (growth must not halve the figure)."""
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
        if self.alive is not None:                          # live rows only
            live = self.alive.cpu().numpy()
            d_if, d_is = d_if[live], d_is[live]
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
        np.savez_compressed(path / "index.npz", **host_arrays(self.store))
        meta = saved_config(self.config)
        meta["build_seconds"] = self.build_seconds
        meta["dtype"] = self.store.plane.tag
        (path / "meta.json").write_text(json.dumps(meta, indent=2))

    @classmethod
    def load(cls, path: str | pathlib.Path, device=None) -> "UGIndex":
        """Read an index the reference (or the port) saved.  The planes are
        taken as stored (never encoded again); the entry index is rebuilt
        from the intervals over the live rows."""
        dev = resolve_device(device)
        path = pathlib.Path(path)
        meta = json.loads((path / "meta.json").read_text())
        build_seconds = meta.pop("build_seconds", 0.0)
        tag = meta.pop("dtype", "f32")
        with np.load(path / "index.npz") as blob:
            arrays = {k: blob[k] for k in blob.files}
        return cls(store_from_arrays(arrays, tag, dev), loaded_config(meta), build_seconds)


def saved_config(config: UGConfig) -> dict:
    """The build config as the reference writes it: its fields, with
    ``prune_backend`` under the reference's name (:data:`SAVED_BACKEND`)."""
    out = dataclasses.asdict(config)
    out["prune_backend"] = _rename_backend(SAVED_BACKEND, out["prune_backend"])
    return out


def loaded_config(fields: dict) -> UGConfig:
    """:func:`saved_config`'s inverse: ``prune_backend`` read back as the
    port's name (:data:`LOADED_BACKEND`)."""
    fields = dict(fields)
    fields["prune_backend"] = _rename_backend(LOADED_BACKEND, fields.get("prune_backend"))
    return UGConfig(**fields)


def host_arrays(store: IndexStore) -> dict[str, np.ndarray]:
    """The store's arrays as the reference saves them (the npz bridge and the
    index checkpoints): ``x`` the scan plane in its own dtype (bf16 as a
    uint16 bit view), ``intervals``, ``nbrs``, ``status``, and where present
    ``x_scale``/``x_zero``, ``x_codebooks``, ``rerank`` and, on a mutated
    index, ``alive``/``free``."""
    npy = lambda t: t.detach().cpu().numpy()
    if store.plane.tag == "bf16":
        # numpy has no bfloat16; CPU torch has no uint16 shifts: go through int16
        x_np = npy(store.plane.data.view(torch.int16)).view(np.uint16)
    else:
        x_np = npy(store.plane.data)
    arrays = dict(x=x_np, intervals=npy(store.intervals), nbrs=npy(store.nbrs),
                  status=npy(store.status))
    if store.plane.scale is not None:
        arrays["x_scale"] = npy(store.plane.scale)
        arrays["x_zero"] = npy(store.plane.zero)
    if store.plane.codebooks is not None:
        arrays["x_codebooks"] = npy(store.plane.codebooks)
    if store.rerank is not None:
        arrays["rerank"] = npy(store.rerank.data)
    if store.alive is not None:
        arrays["alive"] = npy(store.alive)
        arrays["free"] = (np.zeros(arrays["alive"].shape, bool) if store.free is None
                          else npy(store.free))
    return arrays


def store_from_arrays(arrays: dict, tag: str, device) -> IndexStore:
    """:func:`host_arrays`' inverse on ``device``: the planes as stored, the
    entry structure rebuilt from the intervals over the live rows."""
    on = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device)
    if tag == "bf16":                       # stored as a uint16 bit view
        x = on(np.asarray(arrays["x"]).view(np.int16)).view(torch.bfloat16)
    else:
        x = on(arrays["x"])
    opt = lambda k: on(arrays[k]) if k in arrays else None
    plane = VectorPlane(tag, x, opt("x_scale"), opt("x_zero"), opt("x_codebooks"))
    rerank = VectorPlane("f32", on(arrays["rerank"])) if "rerank" in arrays else None
    intervals = as_tensor(arrays["intervals"], torch.float32, device)
    alive = as_tensor(arrays["alive"], torch.bool, device) if "alive" in arrays else None
    free = as_tensor(arrays["free"], torch.bool, device) if "free" in arrays else None
    return IndexStore(plane=plane, rerank=rerank, intervals=intervals,
                      nbrs=as_tensor(arrays["nbrs"], torch.int32, device),
                      status=as_tensor(arrays["status"], torch.uint8, device),
                      entry=build_entry_index(intervals, node_mask=alive),
                      alive=alive, free=free)


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
