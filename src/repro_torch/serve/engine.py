"""Serving substrate: embedding and decoding with an LM tower, retrieval and
streaming updates on an attached :class:`~repro_torch.core.index.UGIndex`.

``embed`` mean-pools a tower's final hidden states and L2-normalises them:
the vectors the paper's unified interval-aware index is built over (the
retrieval deployment in ``launch/serve.py``: embed → UG search under
IF/IS/RF/RS).  ``generate`` decodes greedily or by sampling.  Both serve
every family with a token-only ``Model.forward``: the decoder (dense and
MoE), rwkv6 and zamba2; for encdec, whose decoder needs the encoder's
frames, both raise ``ValueError``, as the reference's calls fail there.
``attach_index`` + ``retrieve`` run interval-aware top-k on the attached
index, embedding token batches unless vectors are given (``q_v=``).
``retrieve_mixed`` is the production mixed-workload path: each request of
a batch carries its own IF/IS/RF/RS semantics, and the batch is padded to a
shape bucket (:data:`BATCH_BUCKETS`), as the reference pads it to reuse its
compiled programs; here the buckets keep the runtime's batches to a few
shapes.  ``upsert``/``remove`` stream inserts and deletes through the
update path (``core/updates.py``) and swap the engine's index reference.
An engine without a model takes vectors only (``q_v=``, ``x=``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core import intervals as iv
from repro_torch.core.index import UGIndex
from repro_torch.core.search import SearchResult, search_mixed
from repro_torch.core.store import as_tensor
from repro_torch.kernels.util import pad_rows
from repro_torch.models.api import Model

# Request-count buckets for ``retrieve_mixed``: a batch of B requests is
# padded to the smallest bucket ≥ B (beyond the table: the next multiple of
# the largest bucket).
BATCH_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)

# The window of a pad row: no interval lies inside ``[2, -2]``, so Alg. 5
# certifies NULL under IF and the row never expands a node.
DEAD_WINDOW = (2.0, -2.0)


def bucket_batch_size(b: int, buckets: Sequence[int] = BATCH_BUCKETS) -> int:
    if b <= 0:
        # A zero-row batch must never reach the card: padding it to the
        # smallest bucket would run an all-no-op 8-row search.  Callers
        # return early on B == 0 instead.
        raise ValueError(f"batch size must be positive, got {b}")
    for s in buckets:
        if b <= s:
            return s
    top = buckets[-1]
    return ((b + top - 1) // top) * top


def upsert_chunk_plan(
    n_live: int, total: int, *, floor: int = 64,
    buckets: Sequence[int] = BATCH_BUCKETS,
) -> list[int]:
    """Chunk sizes for one streaming-insert call, from a single liveness read.

    Rows of one insert chunk do not see each other during candidate
    acquisition (candidates come from the pre-chunk live set), so chunk
    ``i`` is bounded by half the live count *as of chunk i*, tracked on the
    host from the one ``n_live`` read.  Each chunk is rounded **down** to a
    bucket size (or a multiple of the largest bucket), so every chunk lands
    on a :data:`BATCH_BUCKETS` shape.
    """
    if total <= 0:
        return []
    top = buckets[-1]
    sizes: list[int] = []
    live = max(int(n_live), 0)
    left = int(total)
    while left > 0:
        limit = max(live // 2, floor)
        if limit >= top:
            b = (limit // top) * top
        else:
            b = max((s for s in buckets if s <= limit), default=buckets[0])
        b = min(b, left)
        sizes.append(b)
        live += b
        left -= b
    return sizes


def pad_batch(x: torch.Tensor, intervals: torch.Tensor, size: int):
    """Pad a batch of vectors and windows to ``size`` rows with zero vectors
    and the dead window ``[2, -2]``: under IF, Alg. 5 certifies such a query
    NULL; as an insert row (with ``valid=False``) it allocates nothing."""
    pad = size - x.shape[0]
    return (pad_rows(x, size, 0.0),
            torch.cat([intervals, intervals.new_tensor(DEAD_WINDOW).expand(pad, 2)]))


def search_padded(index: UGIndex, q_v: torch.Tensor, q_int: torch.Tensor, flags: torch.Tensor,
                  *, ef: int, k: int, backend: str | None = None,
                  width: int = 4) -> SearchResult:
    """``search_mixed`` of a batch padded to its :data:`BATCH_BUCKETS` size
    with no-op rows (:func:`pad_batch`, the IF flag), sliced back.  Every
    row's answer is independent of the rest of the batch, so the padding
    changes no answer.  ``q_v``, ``q_int`` and ``flags`` lie on the index's
    device."""
    B = q_v.shape[0]
    Bp = bucket_batch_size(B)
    q_v, q_int = pad_batch(q_v, q_int, Bp)
    res = search_mixed(index.store, q_v, q_int, pad_rows(flags, Bp, iv.FLAG_IF), ef=ef, k=k,
                       backend=backend, width=width)
    if Bp == B:
        return res
    return SearchResult(res.ids[:B], res.dist[:B], res.steps[:B], res.iters)


@dataclasses.dataclass
class ServeEngine:
    model: Model | None = None          # the LM tower; None: vectors only
    params: Any = None
    index: UGIndex | None = None
    search_backend: str | None = None   # kernels: cuda | torch, None = by device
    search_width: int = 4               # fused frontier width W

    # ---------------------------------------------------------- retrieval
    def attach_index(self, index: UGIndex, *, backend: str | None = None,
                     width: int | None = None) -> None:
        """Attach a UGIndex; later ``retrieve`` calls run against it.

        The engine holds the index's :class:`IndexStore` **by reference**:
        attaching copies nothing, and every retrieve hands the same device
        buffers to the search.  ``upsert``/``remove`` swap the reference for
        the new index (updates never write into the old one's tensors), so
        readers always see a consistent graph."""
        self.index = index
        if backend is not None:
            self.search_backend = backend
        if width is not None:
            self.search_width = width

    def _attached(self) -> UGIndex:
        if self.index is None:
            raise ValueError("no index attached; call attach_index() first")
        return self.index

    def retrieve(self, query_tokens, q_int, *, sem: iv.Semantics | None = None, ef: int = 64,
                 k: int = 10, mask=None, q_v=None) -> SearchResult:
        """Interval-aware search (Alg. 5 + 4) of the vectors ``q_v`` under
        one semantics (IF by default)."""
        index = self._attached()
        qv = q_v if q_v is not None else self.embed(query_tokens, mask)
        return index.search(qv, q_int, sem=sem if sem is not None else iv.Semantics.IF,
                            ef=ef, k=k, backend=self.search_backend, width=self.search_width)

    def retrieve_mixed(self, query_tokens, q_int, sem_flags, *, ef: int = 64, k: int = 10,
                       mask=None, q_v=None) -> SearchResult:
        """Mixed-workload retrieval: one batch, per-request semantics.

        The vectors, windows and flags are moved to the index's device and
        searched padded to their bucket (:func:`search_padded`)."""
        index = self._attached()
        dev = index.device
        qv = q_v if q_v is not None else self.embed(query_tokens, mask)
        qv = as_tensor(qv, torch.float32, dev)
        q_int = as_tensor(q_int, torch.float32, dev)
        B = qv.shape[0]
        if B == 0:  # empty batch: nothing reaches the card
            return SearchResult(torch.zeros((0, k), dtype=torch.int32, device=dev),
                                torch.zeros((0, k), dtype=torch.float32, device=dev),
                                torch.zeros((0,), dtype=torch.int32, device=dev), 0)
        return search_padded(index, qv, q_int, iv.as_sem_flags(sem_flags, B, device=dev),
                             ef=ef, k=k, backend=self.search_backend, width=self.search_width)

    # ----------------------------------------------------------- streaming
    def upsert(self, doc_tokens, intervals, *, mask=None, x=None) -> int:
        """Insert a batch of documents into the attached index.

        Each chunk is padded to the next :data:`BATCH_BUCKETS` size; pad rows
        carry ``valid=False`` and allocate nothing.  Rows of one insert chunk
        do not see each other during acquisition, so a batch large against
        the live corpus is split into chunks bounded by half the live count.
        The whole plan comes from :func:`upsert_chunk_plan` off a *single*
        liveness read (``self.index.n``: one host sync).  Returns the
        inserted count (B); the engine's index reference is replaced."""
        index = self._attached()
        dev = index.device
        xv = x if x is not None else self.embed(doc_tokens, mask)
        xv = as_tensor(xv, torch.float32, dev)
        ivs = as_tensor(intervals, torch.float32, dev)
        xv = xv[None] if xv.ndim == 1 else xv
        ivs = ivs[None] if ivs.ndim == 1 else ivs
        B = xv.shape[0]
        if B == 0:  # empty batch: nothing reaches the card
            return 0
        s = 0
        for b in upsert_chunk_plan(index.n, B):  # the one liveness read
            Bp = bucket_batch_size(b)
            xc, ic = pad_batch(xv[s:s + b], ivs[s:s + b], Bp)
            valid = torch.arange(Bp, device=dev) < b
            self.index = self.index.insert(xc, ic, valid=valid,
                                           search_backend=self.search_backend,
                                           width=self.search_width)
            s += b
        return B

    def remove(self, ids, *, repair: bool = True) -> int:
        """Delete documents by id from the attached index (tombstone and
        repair; ``repair=False`` defers the repair sweep).  The id batch is
        padded to a bucket with ``-1`` no-op ids."""
        index = self._attached()
        ids = as_tensor(ids, torch.int32, index.device).reshape(-1)
        B = ids.shape[0]
        if B == 0:  # empty batch: nothing reaches the card
            return 0
        Bp = bucket_batch_size(B)
        if Bp != B:
            ids = torch.cat([ids, ids.new_full((Bp - B,), -1)])
        self.index = index.delete(ids, repair=repair)
        return B

    # ------------------------------------------------------------- embed
    def _tower(self) -> Model:
        if self.model is None:
            raise ValueError("this engine has no model: pass precomputed vectors "
                             "(q_v= / x=) in place of tokens")
        return self.model

    @torch.no_grad()
    def embed(self, tokens, mask=None) -> torch.Tensor:
        """(B, S) tokens -> (B, d) float32 embeddings on the parameters'
        device: the mask-weighted mean of the final hidden states (``mask``
        defaults to all ones), L2-normalised in float32 with the norm held
        at least 1e-6.  Raises ``ValueError`` for the encdec family (no
        token-only forward)."""
        model = self._tower()
        dev = self.params["embed"].device
        tokens = as_tensor(tokens, torch.int64, dev)
        mask = (torch.ones(tokens.shape, dtype=torch.float32, device=dev) if mask is None
                else as_tensor(mask, torch.float32, dev))
        hidden, _, _ = model.forward(self.params, tokens)
        m = mask[..., None].to(hidden.dtype)
        pooled = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        pooled = pooled.float()
        # L2-normalised: cosine and euclidean order agree for the index
        return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-6)

    # ------------------------------------------------------------- decode
    @torch.no_grad()
    def generate(self, prompts, max_new: int = 16, *, temperature: float = 0.0,
                 seed: int = 0) -> torch.Tensor:
        """Greedy (``temperature == 0``) or sampled continuation, (B, max_new)
        int32.  The prompt is fed token by token through the decode path;
        only the last prompt step's logits are kept.  Sampling draws from a
        ``torch.Generator`` seeded with ``seed`` (the port's own draws, not
        the reference's).  Raises ``ValueError`` for the encdec family (its
        decode state needs the encoder's frames)."""
        model = self._tower()
        dev = self.params["embed"].device
        prompts = as_tensor(prompts, torch.int32, dev)
        B, S = prompts.shape
        state = model.init_decode_state(self.params, B, S + max_new)
        gen = torch.Generator(device=dev).manual_seed(seed)
        logits = None
        for t in range(S):
            state, logits = model.decode_step(self.params, state, prompts[:, t:t + 1])
        outs = []
        for _ in range(max_new):
            if temperature > 0:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                cur = torch.multinomial(probs, 1, generator=gen).to(torch.int32)
            else:
                cur = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
            outs.append(cur)
            state, logits = model.decode_step(self.params, state, cur)
        return torch.cat(outs, dim=1)
