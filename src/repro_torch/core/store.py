"""IndexStore: the one index structure every layer of the port shares.

It holds a vector plane (the scoring representation of the corpus), an
optional exact f32 rerank plane, the interval column, the graph
(``nbrs``/``status``), the entry structure (Alg. 5) and the streaming
allocator state: ``alive`` marks live rows, ``free`` the slots the allocator
may hand out (``None`` for both on a static index: all live, none free).
The allocator is here (``masks``/``widen_rows``/``grow``); growth doubles
the row capacity, so the arrays change shape O(log n) times over any insert
stream.  The pipelines that use it are in ``core/updates.py``.

Four plane tags: ``f32``; ``bf16`` (2 bytes a dim, widened in registers by
the expand-score kernel); ``int8`` (per-dimension affine
``x ≈ code·scale + zero`` with ``zero = (min + max)/2`` and
``scale = (max - min)/254``, floored at 1e-8, so codes span [-127, 127]);
and ``pq`` (``m`` subspaces of ``d/m`` dims, 256 k-means centroids each, one
uint8 code a subspace, scored through per-query lookup tables).  The int8
parameters and the pq codebooks are frozen at encode time.  The rerank plane
re-scores the final beam so that a quantized scan plane keeps f32-grade
top-k.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.entry import EntryIndex, build_entry_index
from repro_torch.core.exact import DenseGraph
from repro_torch.kernels.beam_merge import next_pow2
from repro_torch.kernels.util import no_tf32, pad_rows, resolve_device

PLANE_TAGS = ("f32", "bf16", "int8", "pq")
_QMAX = 127.0           # int8 code range is [-127, 127]; -128 stays unused (symmetric)
PQ_K = 256              # centroids per subspace: one uint8 code each
_PQ_TRAIN_SAMPLE = 4096
_PQ_TRAIN_ITERS = 10
_PQ_ENCODE_ROWS = 16384  # rows per chunk of pq encoding: (m, 16384, 256) f32 distances


def quantization_params(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-dimension affine ``(scale, zero)`` from the corpus column ranges."""
    x32 = x.to(torch.float32)
    lo = x32.amin(dim=0)
    hi = x32.amax(dim=0)
    zero = (lo + hi) * 0.5
    scale = torch.clamp_min((hi - lo) / (2.0 * _QMAX), 1e-8)
    return scale, zero


def default_pq_m(d: int) -> int:
    """Default subspace count: ~8 dims a subspace, reduced until it divides
    ``d`` (d=24 → m=3, d=16 → m=2, d=12 → m=1)."""
    m = max(d // 8, 1)
    while d % m:
        m -= 1
    return m


def _pq_sq_dists(xs: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """``(m, s, K)`` squared distances from subvectors to centroids."""
    return ((xs * xs).sum(-1)[:, :, None]
            - 2.0 * torch.bmm(xs, cb.transpose(1, 2))
            + (cb * cb).sum(-1)[:, None, :])


def _pq_lloyd(xs: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """``_PQ_TRAIN_ITERS`` Lloyd iterations over every subspace at once.

    Empty clusters keep their previous centroid.  The cluster sums are a
    one-hot product, not ``index_add_``/``scatter_add_``, whose float atomics
    on the card change the order of the sum from run to run: training is
    deterministic on each device."""
    no_tf32()
    K = cb.shape[1]
    for _ in range(_PQ_TRAIN_ITERS):
        assign = torch.argmin(_pq_sq_dists(xs, cb), dim=-1)      # (m, s)
        onehot = F.one_hot(assign, K).to(torch.float32)           # (m, s, K)
        counts = onehot.sum(dim=1)                                # (m, K)
        sums = torch.bmm(onehot.transpose(1, 2), xs)              # (m, K, dsub)
        new = sums / torch.clamp_min(counts[..., None], 1.0)
        cb = torch.where((counts > 0)[..., None], new, cb)
    return cb


def train_pq_codebooks(x: torch.Tensor, m: int | None = None, *, seed: int = 0) -> torch.Tensor:
    """k-means codebooks on ``x``'s device: ``(m, 256, d/m)`` f32.

    Trains on ≤ ``_PQ_TRAIN_SAMPLE`` rows picked by a permutation drawn from
    a CPU ``torch.Generator(seed)``, so the CPU and the card pick the same
    rows; each subspace starts from the first 256 (cycled) sampled rows.
    The reference draws its permutation from ``jax.random``, which torch
    cannot reproduce: port-trained codebooks are held by recall."""
    x32 = x.to(torch.float32)
    n, d = x32.shape
    if m is None:
        m = default_pq_m(d)
    if m < 1 or d % m:
        raise ValueError(f"pq subspace count m={m} must divide d={d}")
    s = max(min(n, _PQ_TRAIN_SAMPLE), 1)
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(max(n, 1), generator=gen)[:s].to(x32.device)
    xs = x32[perm].reshape(s, m, d // m).transpose(0, 1).contiguous()  # (m, s, dsub)
    init = xs[:, torch.arange(PQ_K, device=x32.device) % s, :]          # (m, K, dsub)
    return _pq_lloyd(xs, init)


@dataclasses.dataclass(frozen=True)
class VectorPlane:
    """One storage representation of the corpus vectors."""

    tag: str                                 # "f32" | "bf16" | "int8" | "pq"
    data: torch.Tensor                       # (cap, d) in the plane dtype; pq: (cap, m) uint8
    scale: torch.Tensor | None = None        # (d,) f32, int8 only
    zero: torch.Tensor | None = None         # (d,) f32, int8 only
    codebooks: torch.Tensor | None = None    # (m, 256, d/m) f32, pq only

    # ------------------------------------------------------------- encode
    @classmethod
    def encode(cls, x: torch.Tensor, tag: str, qparams=None) -> "VectorPlane":
        """Encode f32 vectors into a plane.  ``qparams`` overrides the
        derived int8 ``(scale, zero)`` or, for ``pq``, the trained
        ``(m, 256, d/m)`` codebooks (frozen parameters)."""
        if tag not in PLANE_TAGS:
            raise ValueError(f"unknown plane tag {tag!r} (choices {PLANE_TAGS})")
        if tag == "f32":
            return cls(tag, x.to(torch.float32).contiguous())
        if tag == "bf16":
            return cls(tag, x.to(torch.bfloat16).contiguous())
        if tag == "pq":
            cb = train_pq_codebooks(x) if qparams is None else torch.as_tensor(qparams)
            cb = cb.to(device=x.device, dtype=torch.float32).contiguous()
            plane = cls(tag, torch.zeros((0, cb.shape[0]), dtype=torch.uint8, device=x.device),
                        codebooks=cb)
            return dataclasses.replace(plane, data=plane.encode_rows(x))
        scale, zero = quantization_params(x) if qparams is None else qparams
        plane = cls(tag, torch.zeros((0,), dtype=torch.int8, device=x.device),
                    *(torch.as_tensor(a).to(device=x.device, dtype=torch.float32).contiguous()
                      for a in (scale, zero)))
        return dataclasses.replace(plane, data=plane.encode_rows(x))

    def encode_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Encode f32 rows into this plane's dtype under its frozen
        parameters."""
        if self.tag == "f32":
            return rows.to(torch.float32).contiguous()
        if self.tag == "bf16":
            return rows.to(torch.bfloat16).contiguous()
        r32 = rows.to(torch.float32)
        if self.tag == "pq":
            # Chunked over rows: at 1M rows the one-shot (m, n, 256)
            # distance tensor would be 16 GB.  argmin keeps the first of
            # equal minima, as jnp.argmin does.
            no_tf32()
            m, _, dsub = self.codebooks.shape
            out = torch.empty((r32.shape[0], m), dtype=torch.uint8, device=r32.device)
            for s in range(0, r32.shape[0], _PQ_ENCODE_ROWS):
                r = r32[s:s + _PQ_ENCODE_ROWS]
                xs = r.reshape(r.shape[0], m, dsub).transpose(0, 1)
                d2 = _pq_sq_dists(xs, self.codebooks)                  # (m, b, K)
                out[s:s + _PQ_ENCODE_ROWS] = torch.argmin(d2, dim=-1).T.to(torch.uint8)
            return out
        q = torch.round((r32 - self.zero) / self.scale)    # half to even, as jnp.round
        return torch.clamp(q, -_QMAX, _QMAX).to(torch.int8).contiguous()

    # ------------------------------------------------------------- decode
    def _pq_decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """``(b, m)`` uint8 codes → ``(b, d)`` f32 centroid reconstructions."""
        m, k, dsub = self.codebooks.shape
        flat = self.codebooks.reshape(m * k, dsub)
        idx = codes.long() + (torch.arange(m, device=codes.device) * k)[None, :]
        return flat[idx].reshape(codes.shape[0], m * dsub)

    def decode(self) -> torch.Tensor:
        """The ``(cap, d)`` f32 view: the same buffer for ``f32``."""
        if self.tag == "f32":
            return self.data
        if self.tag == "bf16":
            return self.data.to(torch.float32)
        if self.tag == "pq":
            return self._pq_decode_codes(self.data)
        return self.data.to(torch.float32) * self.scale + self.zero

    def decode_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """Gather rows, then decode: the ``(|ids|, d)`` f32 view of a row
        subset without decoding the whole plane."""
        rows = self.data[ids]
        if self.tag == "f32":
            return rows
        if self.tag == "bf16":
            return rows.to(torch.float32)
        if self.tag == "pq":
            return self._pq_decode_codes(rows)
        return rows.to(torch.float32) * self.scale + self.zero

    # -------------------------------------------------------------- stats
    @property
    def dim(self) -> int:
        if self.tag == "pq":
            m, _, dsub = self.codebooks.shape
            return m * dsub
        return self.data.shape[-1]

    def memory_bytes(self) -> int:
        """Plane bytes, int8 parameters and pq codebooks included."""
        return int(sum(a.numel() * a.element_size()
                       for a in (self.data, self.scale, self.zero, self.codebooks)
                       if a is not None))

    def bytes_per_vector(self, n_live: int | None = None) -> float:
        """Amortised plane bytes per stored vector (parameters and codebooks
        included); ``n_live`` defaults to the row capacity."""
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
    def dim(self) -> int:
        return self.plane.dim

    @property
    def graph(self) -> DenseGraph:
        """DenseGraph view over the same buffers (no copy)."""
        return DenseGraph(self.nbrs, self.status)

    def replace(self, **kw) -> "IndexStore":
        return dataclasses.replace(self, **kw)

    def live_count(self) -> int:
        """Number of live rows (the capacity when no alive mask is set)."""
        if self.alive is None:
            return self.capacity
        return int(self.alive.sum())

    def vectors_f32(self) -> torch.Tensor:
        """Best-precision f32 vectors: the rerank plane when present, else
        the decoded scan plane (the same buffer for an f32 plane)."""
        if self.rerank is not None:
            return self.rerank.data
        return self.plane.decode()

    # ---------------------------------------------------- slot allocator
    def masks(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The alive and free masks, materialised where they are ``None``
        (all live, none free)."""
        cap, dev = self.capacity, self.device
        alive = self.alive if self.alive is not None else torch.ones(cap, dtype=torch.bool, device=dev)
        free = self.free if self.free is not None else torch.zeros(cap, dtype=torch.bool, device=dev)
        return alive, free

    def widen_rows(self, m_full: int) -> "IndexStore":
        """Neighbor rows widened to the degree-budget bound ``m_if + m_is``
        with ``-1`` columns: the build trims trailing dead columns, and
        streaming updates need that headroom back."""
        r = m_full - self.nbrs.shape[1]
        if r <= 0:
            return self
        cap, dev = self.capacity, self.device
        return self.replace(
            nbrs=torch.cat([self.nbrs, torch.full((cap, r), -1, dtype=self.nbrs.dtype, device=dev)], 1),
            status=torch.cat([self.status, torch.zeros((cap, r), dtype=self.status.dtype, device=dev)], 1))

    def grow(self, need: int, m_full: int) -> "IndexStore":
        """A store with materialised masks, rows widened to ``m_full`` and
        at least ``need`` free slots.  Growth doubles the capacity (or more,
        to the next power of two that holds ``need``).  Virgin slots get the
        inverted interval ``[2, -2]``, ``-1`` neighbor rows, zero plane codes
        and ``free=True``; they are never alive and no edge points to them.
        The entry structure is dropped (the insert rebuilds it)."""
        alive, free = self.masks()
        out = self.widen_rows(m_full).replace(alive=alive, free=free)
        cap = self.capacity
        n_free = int(free.sum())
        if n_free >= need:
            return out
        new_cap = max(2 * cap, next_pow2(cap + need - n_free))
        pad_plane = lambda p: None if p is None else dataclasses.replace(
            p, data=pad_rows(p.data, new_cap, 0))
        dead_iv = torch.tensor([2.0, -2.0], dtype=self.intervals.dtype, device=self.device)
        return out.replace(
            entry=None,
            plane=pad_plane(out.plane),
            rerank=pad_plane(out.rerank),
            intervals=torch.cat([out.intervals, dead_iv.expand(new_cap - cap, 2)]),
            nbrs=pad_rows(out.nbrs, new_cap, -1),
            status=pad_rows(out.status, new_cap, 0),
            alive=pad_rows(alive, new_cap, False),
            free=pad_rows(free, new_cap, True),
        )

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
    rerank: bool = False,
    build_entry: bool = True,
    device=None,
) -> IndexStore:
    """Assemble an :class:`IndexStore` from f32 vectors and graph arrays
    (numpy arrays or tensors) on ``device`` (``None`` = the card).  ``dtype``
    selects the scan plane, ``rerank=True`` attaches the exact f32 plane;
    the entry structure is built from the intervals, or left ``None`` with
    ``build_entry=False`` (the baselines, which pick their own entries)."""
    dev = resolve_device(device)
    x = as_tensor(x, torch.float32, dev)
    intervals = as_tensor(intervals, torch.float32, dev)
    return IndexStore(
        plane=VectorPlane.encode(x, dtype),
        rerank=VectorPlane.encode(x, "f32") if rerank else None,
        intervals=intervals,
        nbrs=as_tensor(nbrs, torch.int32, dev),
        status=as_tensor(status, torch.uint8, dev),
        entry=build_entry_index(intervals) if build_entry else None,
    )
