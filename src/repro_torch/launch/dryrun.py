"""Multi-pod dry-run: every (architecture × input shape × mesh) cell counted
as one card of the mesh runs it, with the card's argument bytes, FLOPs, HBM
bytes and collective bytes for the roofline (``launch/roofline.py``).

Usage::

    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh multi --out results/dryrun.jsonl
    python -m repro_torch.launch.dryrun --index-cell --mesh single   # the paper's
        sharded UG search step as its own dry-run cell (--device cpu off the card)

**One card.**  ``make_production_mesh`` without a process group is one
process holding every shard; a card of the 16×16 (or 2×16×16) mesh holds
one shard of each axis, and :func:`card_view` is the mesh as that card sees
it, its collectives on ``Planned`` groups (their local ops run, no data
moves, a peer's block is the card's own).  A cell counts that card's work:

* ``train``: the port's mesh step (``train/step.py::_MeshStep``) itself,
  from the card's parameter and moment blocks: the card's
  ``global_batch / n_data`` rows.  A decoder runs it tensor-parallel:
  the card computes its ``model`` shard's heads, MLP columns, vocab rows
  and experts (the groups its specs split) with its blocks gathered along
  the data axes, and the planned model-axis sums; an MoE layer routes
  the card's tokens whole and dispatches them, as one shard of the step's
  global dispatch, to the card's experts.  rwkv6, zamba2 and encdec run
  it tensor-parallel too: the card computes its shard's RWKV6 time-mix
  heads and channel-mix columns, Mamba2 heads and the shared block's,
  encoder, decoder and cross attention heads and MLP columns, and vocab
  rows where they divide, the groups that do not divide ``model`` whole
  (``transformer.tp_plan``).  Then
  the gradients' float32 blocks, the global norm and AdamW on the card's
  blocks, with bf16 moments for MoE configs (the reference's
  ``state_dtype``);
* ``prefill``/``decode``: the reference's jitted ``prefill_step`` and
  ``serve_step``, as :func:`prefill_step` and :func:`serve_step` run them
  on the card (the decoder family): its rows of the request batch, its
  parameter blocks gathered along the data axes only (the router whole,
  ``transformer.tp_gathered``), its ``model`` shard's heads, MLP
  columns, experts and vocab columns, and its block of the decode cache
  (``launch/shardings.py::decode_state_specs``: its kv heads where they
  divide ``model``, else its block of positions of every kv head, whose
  partial softmaxes merge over ``model``); a prefill returns the
  last-position logits' columns and the cache block in that layout, a
  decode step the new cache block and the next token, the argmax over the
  vocab split along ``model``.  rwkv6, zamba2 and encdec still count a
  card's rows against the whole parameters and state (their split serve
  step is not ported yet).

The towers' cells run on ``meta`` tensors: nothing is allocated.  A tally is
linear in the depth (every layer runs the same ops), so a cell runs its
stack at one and at two periods (a layer; llama4's dense and MoE pair;
zamba2's ``attn_every`` Mamba layers with their shared attention; encdec's
encoder and decoder layers each) and weights the period's counts by the
depth, as the reference weights a scanned ``while`` body by its trip count
(``loop_trip_counts``).  The count's seconds grow with the Python
iterations a layer makes (attention tiles, scan chunks), not with bytes.

**The index cell** cannot run on ``meta``: the search loop syncs with the
host every iteration.  It runs on real tensors on the resolved device (the
card unless ``--device cpu``): one shard of the cell's store (rows,
neighbour lists and intervals drawn from a seed on the CPU), its Alg. 5
entries and the fused search cut to one and to two iterations; the second
iteration's counts, weighted by ``iters_cap − 1`` (the bound the reference's
``_trip_count`` reads), stand for the rest of the loop.  The step is the
port's sharded search (``core/sharded.py::make_sharded_search_fn``) on the
card's view, so its merge sorts ``size`` copies of the shard's top-k an
index axis.  On the card the step launches ``expand_score`` and
``beam_merge``.

Record keys are the reference's.  ``flops``/``bytes_accessed`` are the
weighted counts, ``xla_flops``/``xla_bytes`` the counted runs' own (each
loop body once, as XLA's ``cost_analysis`` visits it); ``other_ops`` (the
port's own key) the kernels' operations outside products, which no
roofline term reads; ``lower_s`` is the seconds spent building the cell's
stand-ins and plans, ``compile_s`` the counted runs'.  ``mem``:
``argument`` is the card's bytes of the held parameter and moment blocks,
the batch block and the step counter (decode: the state and token
blocks), ``output`` and ``alias`` follow the reference's donation rule,
and ``temp`` and ``generated_code`` are ``null``: no compiler reports
them here.  On the card, ``torch.cuda.max_memory_allocated`` of a real
step stands in for ``temp`` (``chip_smoke.py`` phase 15(b)).

Exit code != 0 on any failed cell.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import sys
import time
import traceback

import torch

from repro_torch.configs.registry import (
    ARCHS, SHAPES, ShapeSpec, decode_state_specs, get_arch, input_specs,
)
from repro_torch.distributed.collectives import Planned
from repro_torch.launch import shardings as shard_lib
from repro_torch.launch.hlo_analysis import (
    CollectivePlan, Counts, HloStats, StepTally, index_merge_collectives,
    mesh_step_collectives, serve_step_collectives,
)
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.api import get_model
from repro_torch.models.common import PartitionSpec, batch_spec, tree_leaves
from repro_torch.train import optim

META = torch.device("meta")


def card_view(mesh: Mesh) -> Mesh:
    """``mesh`` as its first card sees it: one process a shard, this one at
    the origin of every axis, its collectives planned (``Planned`` groups:
    their local ops run, no data moves)."""
    return dataclasses.replace(mesh, procs=mesh.shape, coords=(0,) * len(mesh.shape),
                               groups={a: Planned() for a, n in zip(mesh.axes, mesh.shape)
                                       if n > 1})


def _dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axes)


def _walk(tree) -> list:
    """The leaves of a tree of dicts (sorted keys), tuples and named tuples,
    a spec being a leaf."""
    if isinstance(tree, PartitionSpec) or not isinstance(tree, (dict, tuple)):
        return [tree]
    items = [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else list(tree)
    return [leaf for v in items for leaf in _walk(v)]


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _walk(tree) if isinstance(t, torch.Tensor))


def _block_bytes(t: torch.Tensor, card: Mesh, spec, dtype=None) -> int:
    item = torch.empty((), dtype=dtype or t.dtype).element_size()
    return math.prod(shard_lib.block_shape(t.shape, card, spec)) * item


def _blocks(tree, card: Mesh, specs, dtype=None) -> dict:
    """``meta`` blocks of a parameter tree under ``specs`` (``dtype``: the
    blocks' own, else the leaves')."""
    spec_of = dict(tree_leaves(specs))
    return optim.tree_from_paths(tree, {
        path: torch.empty(shard_lib.block_shape(t.shape, card, spec_of[path]),
                          dtype=dtype or t.dtype, device=META)
        for path, t in tree_leaves(tree)})


def _card_rows(B: int, n_data: int) -> int:
    return B // n_data if B % n_data == 0 else B


# ---------------------------------------------------------------------------
# Tower cells
# ---------------------------------------------------------------------------
def build_cell(arch_name: str, shape_name, mesh: Mesh, *, cfg=None):
    """Returns ``(step, mem, plan)`` of one (arch × shape) cell on ``mesh``:
    ``step()`` runs one card's work on ``meta`` tensors and returns its
    outputs, ``mem`` the card's argument, output and alias bytes, ``plan``
    its :class:`~repro_torch.launch.hlo_analysis.CollectivePlan`.
    ``shape_name`` is a name of ``SHAPES`` or a ``ShapeSpec``; ``cfg``
    replaces the arch's config (reduced configs, cut depths)."""
    cfg = cfg or get_arch(arch_name).config
    shape = shape_name if isinstance(shape_name, ShapeSpec) else SHAPES[shape_name]
    card = card_view(mesh)
    model = get_model(cfg)
    params = model.shapes()
    pspecs = model.specs(mesh)
    spec_of = dict(tree_leaves(pspecs))
    n_data = math.prod(mesh.size(a) for a in _dp_axes(mesh))
    B, S = shape.global_batch, shape.seq_len
    rows = _card_rows(B, n_data)
    p_bytes = sum(_block_bytes(t, card, spec_of[path]) for path, t in tree_leaves(params))

    if shape.kind == "train":
        ocfg = optim.AdamWConfig(state_dtype=torch.bfloat16 if cfg.moe else torch.float32)
        batch = input_specs(cfg, shape)
        bspec = batch_spec(mesh)
        m_bytes = 2 * sum(_block_bytes(t, card, spec_of[path], ocfg.state_dtype)
                          for path, t in tree_leaves(params))
        b_bytes = sum(_block_bytes(t, card, bspec) for t in batch.values())
        donated = p_bytes + m_bytes + 4                   # params, moments, step: aliased
        mem = dict(argument=donated + b_bytes, output=donated + 4, alias=donated)
        dims = tuple(batch["tokens"].shape) + (
            (batch["frames"].shape[1],) if "frames" in batch else ())   # encdec: S_enc
        plan = mesh_step_collectives(model, card, batch=dims)
        return (lambda: _train_step(model, ocfg, card, batch)), mem, plan

    if cfg.family == "decoder":
        return _split_serve_cell(model, shape, mesh, card, params, pspecs, p_bytes)
    plan = CollectivePlan()
    for path, t in tree_leaves(params):
        plan.gather("param_gather", shard_lib.block_shape(t.shape, card, spec_of[path]),
                    t.element_size(), card, spec_of[path])
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)
        bspec = batch_spec(mesh)
        b_bytes = sum(_block_bytes(t, card, bspec) for t in batch.values())
        # the output: the step's own (counted on the card's rows)
        mem = dict(argument=p_bytes + b_bytes, output=None, alias=0)
        rows_batch = {k: v[:rows] for k, v in batch.items()}
        return (lambda: _prefill_step(model, params, rows_batch)), mem, plan

    state = decode_state_specs(cfg, B, S)
    sspecs = shard_lib.decode_state_specs(cfg, mesh, B, S)
    tspec = shard_lib.token_sharding(mesh, B).spec
    s_bytes = sum(_block_bytes(t, card, sp) for t, sp in zip(_walk(state), _walk(sspecs)))
    t_bytes = math.prod(shard_lib.block_shape((B, 1), card, tspec)) * 4
    keep = _dp_axes(mesh) if rows < B else ()         # the card's rows stay its own
    for t, sp in zip(_walk(state), _walk(sspecs)):
        plan.gather("state_gather", shard_lib.block_shape(t.shape, card, sp),
                    t.element_size(), card, sp, keep=keep)
    mem = dict(argument=p_bytes + s_bytes + t_bytes, output=s_bytes + t_bytes, alias=s_bytes)
    rows_state = decode_state_specs(cfg, rows, S)    # the card's rows, the whole cache
    return (lambda: _decode_step(model, params, rows_state)), mem, plan


def _split_serve_cell(model, shape, mesh: Mesh, card: Mesh, params, pspecs, p_bytes: int):
    """:func:`build_cell`'s prefill and decode cells of the decoder family:
    :func:`prefill_step` and :func:`serve_step` on the card's blocks."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    blocks = _blocks(params, card, pspecs)
    plan = serve_step_collectives(model, card, shape.kind, batch=(B, S))
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)
        bspec = batch_spec(mesh)
        b_bytes = sum(_block_bytes(t, card, bspec) for t in batch.values())
        mem = dict(argument=p_bytes + b_bytes, output=None, alias=0)
        card_batch = {k: torch.empty(shard_lib.block_shape(v.shape, card, bspec), dtype=v.dtype,
                                     device=META) for k, v in batch.items()}
        return (lambda: prefill_step(model, card, blocks, card_batch)), mem, plan
    state = decode_state_specs(cfg, B, S)
    sspecs = shard_lib.decode_state_specs(cfg, mesh, B, S)
    tspec = shard_lib.token_sharding(mesh, B).spec
    s_bytes = sum(_block_bytes(t, card, sp) for t, sp in zip(_walk(state), _walk(sspecs)))
    t_bytes = math.prod(shard_lib.block_shape((B, 1), card, tspec)) * 4
    mem = dict(argument=p_bytes + s_bytes + t_bytes, output=s_bytes + t_bytes, alias=s_bytes)
    card_state = type(state)(
        tuple(torch.empty(shard_lib.block_shape(t.shape, card, sp), dtype=t.dtype, device=META)
              for t, sp in zip(state.cache, sspecs.cache)),
        torch.empty(shard_lib.block_shape((B,), card, sspecs.cache_len), dtype=torch.int32,
                    device=META))
    tokens = torch.empty(shard_lib.block_shape((B, 1), card, tspec), dtype=torch.int32,
                         device=META)
    return (lambda: serve_step(model, card, blocks, card_state, tokens)), mem, plan


# ---------------------------------------------------------------------------
# The decoders' split serve step
# ---------------------------------------------------------------------------
def _serve_setup(model, card: Mesh, params, B: int, S: int, timing):
    """What a split prefill or decode step of a ``(B, S)`` batch on
    ``card`` runs with: the parameters as the model takes them (gathered
    along the data axes, the tensor-parallel step's partial leaves one copy
    a local ``model`` shard), the tensor-parallel context (``None`` where
    ``model`` has one shard) with ``"sequence"`` where the cache's
    sequence splits along ``model``, and this process's data shards."""
    from repro_torch.models import shard_ctx
    from repro_torch.train.step import _MeshStep

    cfg = model.cfg
    if cfg.family != "decoder":
        raise ValueError(f"{cfg.name}: the split serve step runs the decoder family, not "
                         f"{cfg.family}")
    step = _MeshStep(model, None, card, 1, False)
    step.timing = timing
    full = step._gather(params)
    live = optim.tree_from_paths(full, {path: step._live(path, p, False)
                                        for path, p in tree_leaves(full)})
    seq = shard_lib.dim_axes(shard_lib.decode_state_specs(cfg, card, B, S).cache[0], 5)[2]
    if any(card.size(a) > 1 for a in seq if a != "model"):
        raise ValueError(f"{cfg.name}: a batch of {B} does not split over the data axes "
                         f"{step.dp_axes}: the split serve step does not split the cache's "
                         "sequence over them")
    tp = step.tp
    if tp is not None and "model" in seq:
        tp = dataclasses.replace(tp, split=tp.split | {shard_ctx.SEQUENCE})
    return live, tp, len(step.shards)


def _global_rows(card: Mesh, rows: int) -> int:
    """The request batch whose block along the data axes has ``rows`` rows."""
    dp = _dp_axes(card)
    local = math.prod(card.local(a) for a in dp)
    if rows % local:
        raise ValueError(f"a block of {rows} rows does not split over the data axes {dp} "
                         f"({local} shards in this process)")
    return rows // local * math.prod(card.size(a) for a in dp)


def _join(parts, dim: int) -> torch.Tensor:
    """The data shards' parts in order (the one part itself, no copy)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def _context(tp):
    from repro_torch.models import shard_ctx

    return contextlib.nullcontext() if tp is None else shard_ctx.tensor_parallel(tp)


@torch.no_grad()
def prefill_step(model, card: Mesh, params, batch: dict, *, timing=None):
    """The reference's ``prefill_step`` as a process of ``card`` runs it
    (the decoder family): from its parameter blocks and its rows of the
    prompts (``batch["tokens"]``, ``(rows, S)``), each of its data shards'
    rows in turn (an MoE layer routes them as one group), its ``model``
    shards' heads, MLP columns, experts and vocab rows.  Returns ``(the
    last position's logits, (rows, 1, its vocab columns); the caches, its
    block under ``decode_state_specs(cfg, card, B, S)``)``.  ``timing``: a
    dict that collects the model-axis collectives' seconds under
    ``tp_s``."""
    from repro_torch.models import transformer as tr

    tokens = batch["tokens"]
    live, tp, n = _serve_setup(model, card, params, _global_rows(card, tokens.shape[0]),
                               tokens.shape[1], timing)
    rows = tokens.shape[0] // n
    logits, caches = [], []
    with _context(tp):
        for q in range(n):
            hidden, cache = model.prefill(live, {"tokens": tokens[q * rows:(q + 1) * rows]})
            logits.append(tr.unembed(model.cfg, live, hidden[:, -1:, :]))
            caches.append(cache)
    return _join(logits, 0), tuple(_join(c, 1) for c in zip(*caches))


@torch.no_grad()
def serve_step(model, card: Mesh, params, state, tokens, *, timing=None,
               return_logits: bool = False):
    """The reference's ``serve_step`` (one decode step and its next token)
    as a process of ``card`` runs it (the decoder family): from its
    parameter blocks, its block of the decode ``state`` under
    ``launch/shardings.py::decode_state_specs`` and its rows of ``tokens``
    ``(rows, 1)``, each of its data shards' rows in turn, its ``model``
    shards' part of every product and its block of the cache.  Returns
    ``(the new state block, the next tokens (rows, 1) int32)``, the argmax
    over the vocab split along ``model``, lowest index first (and with
    ``return_logits`` the logits' block, (rows, its vocab columns)).
    ``timing`` as :func:`prefill_step`'s."""
    from repro_torch.models import shard_ctx
    from repro_torch.models.transformer import DecodeState, cache_shapes

    cfg = model.cfg
    B = _global_rows(card, tokens.shape[0])
    S = state.cache[0].shape[2]
    if "model" in card.axes and (cfg.mla or cfg.n_kv_heads % card.size("model")):
        S = S // card.local("model") * card.size("model")       # the sequence is split
    specs = shard_lib.decode_state_specs(cfg, card, B, S)
    want = [shard_lib.block_shape(shape, card, sp)
            for shape, sp in zip(cache_shapes(cfg, B, S), specs.cache)]
    got = [tuple(c.shape) for c in state.cache]
    if got != want:
        raise ValueError(f"{cfg.name}: the state's cache blocks {got} are not the blocks "
                         f"{want} of a ({B}, {S}) cache")
    live, tp, n = _serve_setup(model, card, params, B, S, timing)
    rows = tokens.shape[0] // n
    caches, lens, nxt, logits = [], [], [], []
    with _context(tp):
        for q in range(n):
            r = slice(q * rows, (q + 1) * rows)
            st = DecodeState(tuple(c[:, r] for c in state.cache), state.cache_len[r])
            st, lg = model.decode_step(live, st, tokens[r])
            vocab = shard_ctx.split("vocab")
            nxt.append(vocab.argmax(vocab.shards(lg, -1)))
            caches.append(st.cache)
            lens.append(st.cache_len)
            logits.append(lg)
    new = DecodeState(tuple(_join(c, 1) for c in zip(*caches)), _join(lens, 0))
    out = (new, _join(nxt, 0).to(torch.int32)[:, None])
    return out + (_join(logits, 0),) if return_logits else out


def _train_step(model, ocfg, card: Mesh, batch: dict):
    """The mesh step (``train/step.py::_MeshStep``) as one card runs it, on
    ``meta``: from the card's parameter and moment blocks and the global
    batch, its data shard's rows."""
    from repro_torch.train.step import _MeshStep

    step = _MeshStep(model, ocfg, card, 1, True)
    full = model.shapes()
    opt = optim.AdamWState(torch.zeros((), dtype=torch.int32, device=META),
                           _blocks(full, card, step.specs, ocfg.state_dtype),
                           _blocks(full, card, step.specs, ocfg.state_dtype))
    return step(_blocks(full, card, step.specs), opt, batch)


@torch.no_grad()
def _prefill_step(model, params, batch: dict):
    from repro_torch.models import transformer as tr

    hidden, caches = model.prefill(params, batch)
    # serving returns last-position logits (next-token readiness)
    return tr.unembed(model.cfg, params, hidden[:, -1:, :]), caches


@torch.no_grad()
def _decode_step(model, params, state):
    tokens = torch.empty((state.cache_len.shape[0], 1), dtype=torch.int32, device=META)
    new_state, logits = model.decode_step(params, state, tokens)
    return new_state, torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def _depth_knobs(cfg) -> list[tuple[str, int]]:
    """The config fields that set the stack's depth, each with its period;
    empty where a cut depth would not count a whole number of periods."""
    if cfg.family == "encdec":
        knobs = [("enc_layers", 1), ("n_layers", 1)] if cfg.enc_layers else [("n_layers", 1)]
    elif cfg.family == "zamba2":
        knobs = [("n_layers", cfg.attn_every)]
    elif cfg.family == "decoder" and cfg.moe and cfg.moe_every > 1:
        knobs = [("n_layers", cfg.moe_every)]
    else:
        knobs = [("n_layers", 1)]
    if any(getattr(cfg, f) % p or getattr(cfg, f) < 2 * p for f, p in knobs):
        return []
    return knobs


def _counted(step) -> tuple[Counts, object]:
    with StepTally() as tally:
        out = step()
    return tally.counts, out


def count_tower_cell(arch: str, shape, mesh: Mesh, cfg=None):
    """``(counts, raw, output_bytes, trips)`` of a tower cell: the card's
    counts weighted to the config's depth, the counted runs' own (one
    period), the step's output bytes at that depth and the depths."""
    cfg = cfg or get_arch(arch).config
    knobs = _depth_knobs(cfg)
    base_cfg = dataclasses.replace(cfg, **{f: p for f, p in knobs})
    base, base_out = _counted(build_cell(arch, shape, mesh, cfg=base_cfg)[0])
    base_out = _bytes(base_out)
    terms, out_bytes = [], base_out
    for f, p in knobs:
        more, more_out = _counted(build_cell(
            arch, shape, mesh, cfg=dataclasses.replace(base_cfg, **{f: 2 * p}))[0])
        more_out = _bytes(more_out)
        w = getattr(cfg, f) // p - 1
        terms.append((w, more.minus(base)))
        out_bytes += w * (more_out - base_out)
    trips = {f: getattr(cfg, f) for f, _ in knobs} or {"n_layers": cfg.n_layers}
    return base.combine(terms), base, out_bytes, trips


# ---------------------------------------------------------------------------
# The index cell
# ---------------------------------------------------------------------------
def build_index_cell(mesh: Mesh, *, n_global=1 << 20, dim=768, m_deg=64,
                     ef=64, k=10, nq=1024, device=None):
    """The paper's own technique as a dry-run cell: one card's step of the
    sharded UG IF search (rows over ``("pod", "data")``, the hierarchical
    merge, the sharded search's frontier width 4).  Returns ``(step,
    mem, plan, W, iters_cap)``: ``step(max_steps)`` runs the card's shard
    search with at most ``max_steps`` expansions and the merge's sorts, on
    ``device`` (``None`` = the card); an iteration expands ``W`` nodes a
    query, and the loop runs at most ``iters_cap`` iterations."""
    from repro_torch.core.sharded import ShardedIndex, make_sharded_search_fn
    from repro_torch.core.store import IndexStore, VectorPlane
    from repro_torch.kernels.util import resolve_device

    dev = resolve_device(device)
    index_axes = tuple(a for a in ("pod", "data") if a in mesh.axes)
    card = card_view(mesh)
    rows = n_global // math.prod(mesh.size(a) for a in index_axes)
    width = 4
    g = torch.Generator().manual_seed(0)
    x = torch.randn(rows, dim, generator=g)
    lo = torch.rand(rows, generator=g)
    ints = torch.stack([lo, lo + 0.25 * torch.rand(rows, generator=g)], dim=1)
    nbrs = torch.randint(0, rows, (rows, m_deg), generator=g, dtype=torch.int32)
    status = torch.randint(1, 4, (rows, m_deg), generator=g, dtype=torch.uint8)
    q = torch.randn(nq, dim, generator=g)
    q_lo = 0.5 * torch.rand(nq, generator=g)
    q_int = torch.stack([q_lo, q_lo + 0.5], dim=1)
    x, ints, nbrs, status, q, q_int = (t.to(dev) for t in (x, ints, nbrs, status, q, q_int))
    gids = torch.arange(rows, dtype=torch.int32, device=dev)   # the first card's rows
    store = IndexStore(VectorPlane("f32", x), None, ints, nbrs, status, None)
    mem = dict(argument=_bytes((x, ints, nbrs, status, gids, q, q_int)),
               output=nq * k * 8, alias=0)
    plan = index_merge_collectives(card, index_axes, nq, k)
    W = max(min(width, ef), 1)
    iters_cap = (8 * ef + 32 + W - 1) // W            # beam_search_flags's default cap
    plan.trips["search_loop"] = iters_cap

    def step(max_steps: int):
        fn = make_sharded_search_fn(card, index_axes=index_axes, ef=ef, k=k, width=width,
                                    max_steps=max_steps)
        return fn(ShardedIndex(store, gids, card), q, q_int)

    return step, mem, plan, W, iters_cap


def count_index_cell(mesh: Mesh, *, device=None, **cell_kw):
    """``(counts, raw, mem, plan, out)`` of the index cell: the search cut to
    one iteration, plus the second iteration's counts ``iters_cap − 1``
    times; ``out`` is the two-iteration step's ``(ids, dist)``."""
    step, mem, plan, W, iters_cap = build_index_cell(mesh, device=device, **cell_kw)
    one, _ = _counted(lambda: step(W))
    two, out = _counted(lambda: step(2 * W))
    # beam_merge runs once for the entries and once an iteration
    if two.kernels["beam_merge"][0] != one.kernels["beam_merge"][0] + 1:
        raise RuntimeError("the index cell's search ended before its second iteration")
    return one.combine([(iters_cap - 1, two.minus(one))]), one, mem, plan, out


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------
def run_cell(arch: str, shape, mesh_kind: str, *, index_cell=False, verbose=True,
             cfg=None, mesh=None, device=None) -> dict:
    """One cell's record.  ``shape`` is a name of ``SHAPES`` or a
    ``ShapeSpec``; ``cfg`` replaces the arch's config and ``mesh`` the
    production mesh of ``mesh_kind`` (tests, and ``chip_smoke.py``'s
    one-card cell); ``device`` is the index cell's (``None`` = the card)."""
    t0 = time.time()
    if mesh is None:
        dev = device if index_cell else META
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device=dev)
    name = shape.name if isinstance(shape, ShapeSpec) else shape
    rec = {
        "arch": arch, "shape": name, "mesh": mesh_kind,
        "mesh_shape": dict(zip(mesh.axes, mesh.shape)), "ok": False,
    }
    try:
        if index_cell:
            rec["arch"] = "ug-index-search"
            counts, raw, mem, plan, _ = count_index_cell(mesh, device=device)
            t_lower = 0.0
            trips = dict(plan.trips)
        else:
            skip = get_arch(arch).skip_reason(name)
            if skip:
                rec.update(ok=True, skipped=skip)
                return rec
            _, mem, plan = build_cell(arch, shape, mesh, cfg=cfg)
            t_lower = time.time() - t0
            counts, raw, out_bytes, trips = count_tower_cell(arch, shape, mesh, cfg=cfg)
            if mem["output"] is None:
                mem["output"] = out_bytes
            trips.update(plan.trips)
        t_count = time.time() - t0 - t_lower
        stats = HloStats(counts.flops, counts.hbm_bytes + plan.hbm_bytes, plan.stats())
        rec.update(
            ok=True,
            lower_s=round(t_lower, 1),
            compile_s=round(t_count, 1),
            flops=float(stats.flops),
            bytes_accessed=float(stats.hbm_bytes),
            xla_flops=float(raw.flops),
            other_ops=float(counts.ops),
            xla_bytes=float(raw.hbm_bytes),
            mem=_mem_dict(mem),
            collective_bytes=stats.collectives.total_bytes,
            collective_by_type=stats.collectives.by_type,
            collective_by_part=stats.collectives.by_computation,
            loop_trip_counts={k: v for k, v in sorted(trips.items())[:16]},
            kernels=counts.top("kernels"),
            top_ops=counts.top("by_op"),
        )
        if verbose:
            print(f"[dryrun] {rec['arch']} × {name} × {mesh_kind}: OK "
                  f"(count {rec['compile_s']}s)")
            print(f"  memory: {rec['mem']}")
            print(f"  flops/device: {rec['flops']:.3e}  "
                  f"bytes/device: {rec['bytes_accessed']:.3e}")
            print(stats.collectives.fmt())
    except Exception as e:  # noqa: BLE001 — failures are the signal here
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch} × {name} × {mesh_kind}: FAIL {rec['error']}")
    return rec


def _mem_dict(mem: dict) -> dict:
    """The reference's five memory keys; ``temp`` and ``generated_code``
    have no counterpart without a compiler."""
    return {"temp": None, "argument": int(mem["argument"]), "output": int(mem["output"]),
            "alias": int(mem["alias"]), "generated_code": None}


def run_cells(cells, *, index_cell=False, out=None, verbose=True, device=None,
              cfgs=None, shapes=None) -> int:
    """Run ``cells`` (``(arch, shape, mesh_kind)``), appending each record
    to ``out`` (JSONL) when given; the number of failed cells.  ``cfgs``
    (arch -> config) and ``shapes`` (name -> ``ShapeSpec``) replace the
    registry's, for tests."""
    failures = 0
    for arch, shape, mesh_kind in cells:
        rec = run_cell(arch or "", (shapes or {}).get(shape, shape), mesh_kind,
                       index_cell=index_cell, verbose=verbose, device=device,
                       cfg=(cfgs or {}).get(arch))
        if out:
            p = pathlib.Path(out)
            p.parent.mkdir(parents=True, exist_ok=True)
            with p.open("a") as f:
                f.write(json.dumps(rec) + "\n")
        failures += 0 if rec.get("ok") else 1
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS) + [None])
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true", help="every (arch × shape)")
    ap.add_argument("--index-cell", action="store_true",
                    help="dry-run the sharded UG search step instead")
    ap.add_argument("--device", default=None,
                    help="the index cell's device (default: the card; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    if args.index_cell:
        cells = [(None, "index", args.mesh)]
    elif args.all:
        cells = [(a, s, args.mesh) for a in sorted(ARCHS) for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all / --index-cell)")
        cells = [(args.arch, args.shape, args.mesh)]
    failures = run_cells(cells, index_cell=args.index_cell, out=args.out, device=args.device)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
