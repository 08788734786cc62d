"""Baselines from the paper's experimental section (§2.2, §5.1).

* ``PostFilterIndex``  — an interval-agnostic RNG-style graph (the HNSW /
  NSG / Vamana family's stand-in: the same candidate and prune pipeline with
  the semantic witness conditions off); search retrieves an oversampled
  top-k′ by similarity alone, then drops the objects the predicate rejects.
* ``prefilter_search`` — the pre-filtering strategy: an exact scan of the
  valid subset, O(n) per query.
* ``HiPNGLite``        — a hierarchical interval partition (Hi-PNG style):
  a segment tree over the attribute domain, one graph per tree node, each
  object at the deepest node whose range holds its interval; an IF query
  searches every node whose range meets its window and post-checks.
* ``build_rrng``       — the scalar special case (paper §3.2): point object
  intervals and the IF projection, an RFANN index.

Each index can be built here (on ``device``, ``None`` = the card) or
assembled from arrays built elsewhere, e.g. the reference's graphs.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core import intervals as iv
from repro_torch.core.build import UGConfig, build_ug
from repro_torch.core.candidates import merge_topk
from repro_torch.core.exact import DenseGraph
from repro_torch.core.search import SearchResult, beam_search, brute_force
from repro_torch.core.store import IndexStore, as_tensor, make_store
from repro_torch.kernels.util import no_tf32, resolve_device


def _free_windows(nq: int, device) -> torch.Tensor:
    """``[-inf, inf]`` windows: every edge passes, every node matches."""
    return torch.tensor([[-torch.inf, torch.inf]], device=device).expand(nq, 2).contiguous()


def _graph_bytes(g: DenseGraph) -> int:
    return int(g.nbrs.numel() * g.nbrs.element_size() + g.status.numel() * g.status.element_size())


def _walk_store(x, intervals, graph: DenseGraph) -> IndexStore:
    """The f32 store a baseline's search walks, without an entry structure
    (the baselines pick their own entries)."""
    return make_store(x, intervals, graph.nbrs, graph.status, build_entry=False, device=x.device)


def _post_check(res: SearchResult, intervals: torch.Tensor, q_int: torch.Tensor,
                sem: iv.Semantics):
    """``res.dist`` with ``+inf`` wherever the id is a pad or the object
    fails the predicate."""
    n = intervals.shape[0]
    ok = iv.predicate(sem, intervals[res.ids.clamp(0, n - 1).long()], q_int[:, None, :])
    return torch.where(ok & (res.ids >= 0), res.dist, torch.inf)


# --------------------------------------------------------------------------
# Post-filtering over an interval-agnostic graph
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PostFilterIndex:
    """Interval-agnostic proximity graph + oversample-then-filter search."""

    x: torch.Tensor
    intervals: torch.Tensor
    graph: DenseGraph
    build_seconds: float = 0.0

    @classmethod
    def build(cls, x, intervals, config: UGConfig = UGConfig(), seed: int = 0,
              device=None) -> "PostFilterIndex":
        """Alg. 1–3 with ``unified=False``; NN-descent draws from a
        ``torch.Generator`` seeded with ``seed``."""
        dev = resolve_device(device)
        no_tf32()
        x = as_tensor(x, torch.float32, dev)
        intervals = as_tensor(intervals, torch.float32, dev)
        cfg = dataclasses.replace(config, unified=False)
        t0 = time.perf_counter()
        graph = build_ug(torch.Generator(device=dev).manual_seed(seed), x, intervals, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return cls(x, intervals, graph, time.perf_counter() - t0)

    @property
    def store(self) -> IndexStore:
        """The store the search walks (it enters at node 0); made once."""
        if "_store" not in self.__dict__:
            self._store = _walk_store(self.x, self.intervals, self.graph)
        return self._store

    def memory_bytes(self) -> int:
        return _graph_bytes(self.graph)

    def search(self, q_v, q_int, *, sem: iv.Semantics, ef: int = 64, k: int = 10,
               oversample: int = 4, max_steps: int = 0,
               backend: str | None = None) -> SearchResult:
        """Similarity-only beam search for k′ = min(max(oversample·k, ef),
        ef) from node 0 (the default HNSW entry), then the predicate
        filter and the k best survivors."""
        dev = self.x.device
        q_v = as_tensor(q_v, torch.float32, dev)
        q_int = as_tensor(q_int, torch.float32, dev)
        nq = q_v.shape[0]
        kprime = min(max(k * oversample, ef), ef)
        res = beam_search(self.store, torch.zeros((nq,), dtype=torch.int32, device=dev), q_v,
                          _free_windows(nq, dev), sem=iv.Semantics.IF, ef=ef, k=kprime,
                          max_steps=max_steps, backend=backend)
        d = _post_check(res, self.intervals, q_int, sem)
        d, order = torch.sort(d, dim=-1, stable=True)
        d = d[:, :k]
        ids = torch.gather(res.ids, -1, order[:, :k])
        return SearchResult(torch.where(torch.isfinite(d), ids, -1), d, res.steps)


# --------------------------------------------------------------------------
# Pre-filtering (exact scan over the valid subset)
# --------------------------------------------------------------------------
def prefilter_search(x, intervals, q_v, q_int, *, sem: iv.Semantics, k: int) -> SearchResult:
    """Pre-filtering strategy: exact, O(n·d) per query, on ``x``'s device
    (the port's ``brute_force``, as in the reference)."""
    dev = x.device
    return brute_force(x, intervals, as_tensor(q_v, torch.float32, dev),
                       as_tensor(q_int, torch.float32, dev), sem=sem, k=k)


# --------------------------------------------------------------------------
# Hi-PNG-lite: hierarchical interval partition of sub-graphs
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Partition:
    """One segment-tree node: its range, its objects' global ids, and the
    graph over their rows (``None`` when it holds no object)."""

    lo: float
    hi: float
    node_ids: torch.Tensor          # (m,) int32 global ids
    graph: DenseGraph | None
    x: torch.Tensor | None
    intervals: torch.Tensor | None

    @property
    def store(self) -> IndexStore:
        if "_store" not in self.__dict__:
            self._store = _walk_store(self.x, self.intervals, self.graph)
        return self._store


def segment_ranges(depth: int, domain=(0.0, 1.0)) -> list[tuple[float, float, int]]:
    """``(lo, hi, level)`` of every segment-tree node, level by level."""
    ranges = []
    for level in range(depth + 1):
        cells = 2 ** level
        width = (domain[1] - domain[0]) / cells
        for c in range(cells):
            ranges.append((domain[0] + c * width, domain[0] + (c + 1) * width, level))
    return ranges


def assign_partitions(intervals: torch.Tensor, ranges) -> torch.Tensor:
    """Per object, the deepest range that holds its interval (-1 if none);
    one vectorised pass per range.  Python-float bounds compare in
    float32, as numpy's do against the reference's float32 array."""
    n = intervals.shape[0]
    assign = torch.full((n,), -1, dtype=torch.int64, device=intervals.device)
    best = torch.full((n,), -1, dtype=torch.int64, device=intervals.device)
    for pid, (lo, hi, level) in enumerate(ranges):
        covered = (intervals[:, 0] >= lo) & (intervals[:, 1] <= hi + 1e-12)
        upgrade = covered & (level > best)
        assign = torch.where(upgrade, pid, assign)
        best = torch.where(upgrade, level, best)
    return assign


@dataclasses.dataclass
class HiPNGLite:
    """Segment tree of interval partitions, one sub-graph per tree node.

    Objects live at the deepest tree node whose range contains their
    interval.  An IF query searches every tree node whose range meets its
    window (only their objects can match) and post-checks containment."""

    partitions: list[Partition]
    depth: int
    build_seconds: float = 0.0

    @classmethod
    def build(cls, x, intervals, *, depth: int = 3, config: UGConfig = UGConfig(),
              seed: int = 0, domain=(0.0, 1.0), device=None) -> "HiPNGLite":
        """One ``build_ug`` (``unified=False``) per non-empty partition,
        seeded ``seed + pid``; partitions of at most 8 objects get the
        complete graph."""
        dev = resolve_device(device)
        no_tf32()
        x = as_tensor(x, torch.float32, dev)
        intervals = as_tensor(intervals, torch.float32, dev)
        t0 = time.perf_counter()
        ranges = segment_ranges(depth, domain)
        assign = assign_partitions(intervals, ranges)
        cfg = dataclasses.replace(config, unified=False)
        parts = []
        for pid, (lo, hi, _) in enumerate(ranges):
            rows = torch.nonzero(assign == pid).flatten().to(torch.int32)
            m = rows.shape[0]
            if m == 0:
                parts.append(Partition(lo, hi, rows, None, None, None))
                continue
            xs, ivs = x[rows.long()], intervals[rows.long()]
            if m <= 8:
                graph = DenseGraph(
                    torch.arange(m, dtype=torch.int32, device=dev)[None, :].expand(m, m).contiguous(),
                    torch.full((m, m), iv.FLAG_BOTH, dtype=torch.uint8, device=dev))
            else:
                local = dataclasses.replace(
                    cfg, ef_spatial=min(cfg.ef_spatial, max(m - 1, 1)),
                    ef_attribute=min(cfg.ef_attribute, max(m - 1, 1)),
                    exact_spatial=m <= 2048)
                graph = build_ug(torch.Generator(device=dev).manual_seed(seed + pid),
                                 xs, ivs, local)
            parts.append(Partition(lo, hi, rows, graph, xs, ivs))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return cls(parts, depth, time.perf_counter() - t0)

    @classmethod
    def from_arrays(cls, x, intervals, parts, depth: int, device=None) -> "HiPNGLite":
        """Assemble from per-partition ``(lo, hi, node_ids, nbrs, status)``
        built elsewhere (``nbrs``/``status`` ``None`` for an empty one)."""
        dev = resolve_device(device)
        x = as_tensor(x, torch.float32, dev)
        intervals = as_tensor(intervals, torch.float32, dev)
        out = []
        for lo, hi, node_ids, nbrs, status in parts:
            rows = as_tensor(node_ids, torch.int32, dev)
            if nbrs is None:
                out.append(Partition(lo, hi, rows, None, None, None))
                continue
            graph = DenseGraph(as_tensor(nbrs, torch.int32, dev), as_tensor(status, torch.uint8, dev))
            out.append(Partition(lo, hi, rows, graph, x[rows.long()], intervals[rows.long()]))
        return cls(out, depth)

    @property
    def device(self) -> torch.device:
        return next(p.node_ids.device for p in self.partitions)

    def memory_bytes(self) -> int:
        return sum(_graph_bytes(p.graph) + p.node_ids.numel() * 4
                   for p in self.partitions if p.graph is not None)

    def search(self, q_v, q_int, *, ef: int = 64, k: int = 10,
               backend: str | None = None) -> SearchResult:
        """IFANN search across the partitions that meet the window, merged
        per query with ``merge_topk``; queries a partition does not touch
        enter it nowhere (entry -1)."""
        dev = self.device
        q_v = as_tensor(q_v, torch.float32, dev)
        q_int = as_tensor(q_int, torch.float32, dev)
        nq = q_v.shape[0]
        best_ids = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
        best_d = torch.full((nq, k), torch.inf, dtype=torch.float32, device=dev)
        total_steps = torch.zeros((nq,), dtype=torch.int32, device=dev)
        free = _free_windows(nq, dev)
        for part in self.partitions:
            if part.graph is None:
                continue
            touches = (q_int[:, 0] <= part.hi) & (q_int[:, 1] >= part.lo)
            if not bool(touches.any()):
                continue
            entry = torch.where(touches, 0, -1).to(torch.int32)
            m = part.node_ids.shape[0]
            res = beam_search(part.store, entry, q_v, free, sem=iv.Semantics.IF, ef=ef,
                              k=min(4 * k, m, ef), backend=backend)
            d = _post_check(res, part.intervals, q_int, iv.Semantics.IF)
            gids = part.node_ids[res.ids.clamp(0, m - 1).long()]
            gids = torch.where(torch.isfinite(d), gids, -1)
            best_ids, best_d = merge_topk(best_ids, best_d, gids, d, k)
            total_steps = total_steps + res.steps
        return SearchResult(best_ids, best_d, total_steps)


# --------------------------------------------------------------------------
# RRNG: the scalar / RFANN special case (URNG with point intervals, IF only)
# --------------------------------------------------------------------------
def build_rrng(gen: torch.Generator, x: torch.Tensor, scalars: torch.Tensor,
               config: UGConfig = UGConfig()) -> DenseGraph:
    """RRNG as the degenerate URNG (paper §3.2): ``I_o = [a, a]``.  ``gen``
    is a ``torch.Generator`` on ``x``'s device."""
    a = scalars.reshape(-1, 1).to(torch.float32)
    return build_ug(gen, x, torch.cat([a, a], dim=1), config)
