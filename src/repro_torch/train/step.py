"""Train-step factory: loss → grads → AdamW, with microbatch accumulation,
on one device or over a ``(data, model)`` mesh.

Gradients come from ``torch.autograd.grad`` over detached views of the
parameter leaves that require grad, so nothing accumulates into ``.grad``.

**The mesh step** (``mesh=``) computes the one-device step's function, as
the reference's partitioned step does (its XLA partitioner keeps the global
semantics), up to the order of float sums:

* each parameter leaf and its two moments are held as this process's block
  under the leaf's spec (``Model.specs(mesh)``; ``launch/shardings.py``):
  ``embed`` over the data axes (FSDP), heads/mlp/vocab/expert over
  ``model``;
* a step gathers the parameters (along the data axes only under tensor
  parallelism, below; else whole), splits the global batch into
  microbatches and each microbatch over the data shards (dim 0), and runs
  each of this process's data shards as its own forward and backward — so
  a shard computes the same bits whichever process holds it, and 1, 2 or 4
  processes give the same result;
* the loss stays global: a shard's cross-entropy is rescaled from its own
  mask count to the microbatch's (``Σ mask`` over the whole batch), and an
  MoE layer dispatches each shard's tokens as part of one global dispatch
  (``moe.data_shard``: capacity from the microbatch's token count, the
  ranks after the shards before it, the aux from the global means; the
  shards of one process run in threads, below);
* the gradients are summed over the data shards with the ring
  collectives (``launch.shardings.reduce_blocks``: a reduce-scatter over
  the leaf's data sub-dimension, an all-reduce for a leaf not split over
  the data axes), in float32 accumulators the size of the gathered
  parameters, and each process keeps its block;
* the global norm is summed over the leaves' shard cells in a fixed order,
  and AdamW updates the blocks.

**Along ``model``** every arch splits its products, as XLA's partitioner
splits the reference's (Megatron's tensor parallelism,
``models/shard_ctx.py``): on a mesh whose ``model`` axis has several
shards, each process computes its ``model`` shards' part of the groups its
leaves' specs split (``transformer.tp_plan``), with its blocks gathered
along the data axes only.  The dense decoders (qwen1.5-4b, qwen3-32b,
starcoder2-15b, chameleon-34b, minicpm3-4b) split their heads, MLP columns
and vocab rows; the MoE archs (qwen3-moe, llama4-maverick) their experts
too (or, where the experts do not divide ``model``, every expert's
columns), the router gathered whole; rwkv6 its time-mix heads (with
``w_g``'s columns), channel-mix columns and vocab rows; zamba2 its Mamba2
heads, the shared block's attention heads and MLP columns and its vocab
rows; encdec (seamless-m4t) its encoder's, decoder's and cross
attention's heads, MLP columns and vocab rows.  A group splits only where
every leaf of it splits along ``model`` as its computation reads it;
otherwise its split leaves are gathered whole along ``model``
(``transformer.tp_gathered``) and it runs whole on every process, its
gradient complete there (reduced rwkv6's 4 heads on 16×16, reduced
zamba2's 2 Mamba heads on 4 or 16 shards).  A decoder leaf whose spec the
path cannot serve, and a leaf no group reads, raise.  Leaves that always
run whole (the MoE router, RWKV6's ``w_ffn_r``, encdec's ``frame_proj``)
are gathered the same way.  The split regions' partials are summed over
``model`` in shard order (``collectives.ordered_sum``); a process holding
several ``model`` shards runs them one after another in each region, each
on its own tensors, so 1, 2 or 4 processes still give the same bits.  A
leaf that feeds split compute whole (attention's norm gammas, ``wk``/
``wv`` where the kv heads do not split, MLA's latent projections, RWKV6's
mixes and ``decay_lora_a``, Mamba2's ``w_bc``, and ``w_in`` and ``conv_w``,
gathered first: their contiguous blocks are not a shard's heads) is handed
to the model with one copy a local shard (after its layer dimension;
first for the shared block's unstacked leaves), and its shards' partial
gradients are summed over ``model`` before the data axes.  A checkpointed
block's recompute runs whole there (no early stop), so its sums run as
often on every process.

**Threads.**  An MoE config's data shards run in threads of their own
(:class:`_Exchange`), in step at each MoE layer's count exchange, which
the calling thread serves: every ``torch.distributed`` call of the step
comes from the calling thread.  A model-axis sum inside a shard's thread
(or inside its backward, which the card runs on autograd's device
thread) must then stay in the process: with the power-of-two meshes the
repo runs (``launch/mesh.py``: data takes the processes first), a
process that holds several data shards holds the whole ``model`` axis,
whose sums make no ``torch.distributed`` call; where ``model`` spans
processes each process holds one data shard and the step runs it
inline.  A layout that breaks this (``(6, 2)`` on 4 processes) raises
``ValueError``.

Determinism.  The backward passes hold float scatter-adds (the embedding
lookup's, the MoE dispatch's and combine's), which run as atomics on the
card unless PyTorch's deterministic mode is on.  :func:`deterministic`
turns it on for a block; the training entry points (``launch/train.py``,
``bench_lm_steps``, ``chip_smoke.py``) run their steps inside it, with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before their first cuBLAS call.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading

import torch

from repro_torch.models import moe
from repro_torch.models.api import Model
from repro_torch.models.common import P, tree_leaves, tree_map
from repro_torch.train import optim

CUBLAS_WORKSPACE = ":4096:8"   # the cuBLAS workspace deterministic mode needs


@contextlib.contextmanager
def deterministic(device=None):
    """PyTorch's deterministic algorithms for the block, then the previous
    setting.  On the card (``device`` of type cuda) cuBLAS also needs
    ``CUBLAS_WORKSPACE_CONFIG`` set before the process's first cuBLAS
    call; a missing one raises here rather than at the first product."""
    on_card = device is not None and torch.device(device).type == "cuda"
    if on_card and not os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
        raise RuntimeError("deterministic training on the card needs "
                           f"CUBLAS_WORKSPACE_CONFIG={CUBLAS_WORKSPACE} in the environment "
                           "before the first cuBLAS call")
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _scalar(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def value_and_grad(model: Model, params, batch):
    """``(loss, metrics, grads)`` of ``model.loss``: grads a tree like
    ``params`` (zeros for a leaf the loss does not read), by
    ``torch.autograd.grad`` over detached leaves that require grad."""
    paths = [path for path, _ in tree_leaves(params)]
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = [leaf for _, leaf in tree_leaves(live)]
    with torch.enable_grad():
        loss, metrics = model.loss(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    dev = leaves[0].device
    return (loss.detach(), {k: _scalar(v, dev) for k, v in metrics.items()},
            optim.tree_from_paths(params, dict(zip(paths, grads))))


def make_train_step(model: Model, opt_cfg: optim.AdamWConfig, mesh=None, *,
                    microbatches: int = 1, donate: bool = True):
    """Returns ``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``microbatches > 1`` splits the batch on dim 0 and sums the gradients
    from float32 zeros (each add promoted to float32), then divides by
    ``microbatches``; ``metrics`` then holds only ``loss`` and the
    optimizer's stats.  ``donate`` updates the parameters and moments in
    place and returns the same trees: the caller must not reuse the old
    ones (JAX's donation contract)."""
    if mesh is not None:
        return _MeshStep(model, opt_cfg, mesh, microbatches, donate)

    def step_fn(params, opt_state, batch):
        if microbatches > 1:
            def part(a, i):
                b = a.shape[0] // microbatches
                return a[i * b:(i + 1) * b]

            dev = tree_leaves(params)[0][1].device
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            g_acc = dict(tree_leaves(grads))
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatches):
                mb = {k: part(v, i) for k, v in batch.items()}
                loss, _, g = value_and_grad(model, params, mb)
                for path, gl in tree_leaves(g):
                    g_acc[path].add_(gl)
                loss_sum = loss_sum + loss
                del g
            for acc in g_acc.values():
                acc.div_(microbatches)
            loss = loss_sum / microbatches
            metrics = {}
        else:
            loss, metrics, grads = value_and_grad(model, params, batch)
        new_params, new_opt, stats = optim.update(opt_cfg, opt_state, params, grads,
                                                  inplace=donate)
        del grads
        return new_params, new_opt, {"loss": loss, **metrics, **stats}

    return step_fn


def make_eval_step(model: Model, mesh=None):
    """Returns ``(params, batch) -> {"loss", **metrics}`` (no gradients)."""
    if mesh is not None:
        mesh_step = _MeshStep(model, None, mesh, 1, False)
        return torch.no_grad()(mesh_step.evaluate)

    @torch.no_grad()
    def eval_fn(params, batch):
        loss, metrics = model.loss(params, batch)
        dev = tree_leaves(params)[0][1].device
        return {"loss": loss, **{k: _scalar(v, dev) for k, v in metrics.items()}}

    return eval_fn


# ---------------------------------------------------------------------------
# The mesh step
# ---------------------------------------------------------------------------
class _Exchange:
    """The MoE layers' count exchange for this process's data shards, each
    run in a thread of its own by :meth:`serve`: a shard's thread hands in
    its ``(2, E)`` counts and waits; the serving (calling) thread
    all-gathers them over the data axes once every local shard has handed
    its in, and each thread gets every shard's, ``(n, 2, E)`` in shard
    order.  So every ``torch.distributed`` call of the step is made by the
    calling thread, never by a shard's (on the card autograd runs every
    thread's backward nodes on one worker thread, where two threads'
    collectives could meet in another order on two processes)."""

    def __init__(self, mesh, dp_axes, local_grid, timeout: float):
        self.mesh, self.dp_axes, self.grid = mesh, dp_axes, list(local_grid)
        self.n_local = math.prod(local_grid)
        self.timeout = timeout
        self.cond = threading.Condition()
        self.slots = [None] * self.n_local
        self.out = None
        self.round = 0                   # exchanges served so far
        self.failed = False              # a shard's thread raised, or the serve gave up

    def _gathered(self, slots: list) -> torch.Tensor:
        from repro_torch.launch.shardings import gather_leaf

        mine = torch.stack(slots).reshape(self.grid + list(slots[0].shape))
        every = gather_leaf(mine, self.mesh, P(*self.dp_axes))
        return every.reshape((-1,) + tuple(slots[0].shape))

    def __call__(self, q: int, counts: torch.Tensor) -> torch.Tensor:
        if self.n_local == 1:                    # inline, on the calling thread
            return self._gathered([counts])
        with self.cond:
            self.slots[q] = counts
            r = self.round
            self.cond.notify_all()
            if not self.cond.wait_for(lambda: self.round != r or self.failed, self.timeout):
                raise TimeoutError(f"data shard {q} waited {self.timeout} s at the MoE "
                                   "count exchange")
            if self.round == r:
                raise RuntimeError("another data shard of this process failed")
            return self.out

    def serve(self, fns: list) -> list:
        """``[f() for f in fns]``, each in a thread of its own (inline for
        one), serving their exchanges until every thread has ended; the
        first error is raised after every thread has ended."""
        if len(fns) == 1:
            return [fns[0]()]
        out, errors, done = [None] * len(fns), [], [False] * len(fns)

        def run(i):
            try:
                out[i] = fns[i]()
            except BaseException as e:  # noqa: BLE001  (re-raised below)
                errors.append(e)
            finally:
                with self.cond:
                    done[i] = True
                    self.failed = self.failed or bool(errors)
                    self.cond.notify_all()

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
        for t in threads:
            t.start()
        try:
            while True:
                with self.cond:
                    if not self.cond.wait_for(
                            lambda: self.failed or all(done)
                            or all(c is not None for c in self.slots), self.timeout):
                        raise TimeoutError(f"the data shards' threads passed {self.timeout} s "
                                           "without meeting at the MoE count exchange")
                    if self.failed or all(done):
                        break
                    slots = list(self.slots)
                every = self._gathered(slots)            # the collective, on this thread
                with self.cond:
                    self.out, self.slots = every, [None] * self.n_local
                    self.round += 1
                    self.cond.notify_all()
        finally:
            with self.cond:
                self.failed = self.failed or not all(done)
                self.cond.notify_all()
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
        return out


@contextlib.contextmanager
def _tp_scope(tp):
    """The model runs under ``tp``, its checkpointed recomputes whole.  Both
    settings are process-wide (a recompute may run on autograd's device
    thread): the step enters this once around all its data shards."""
    from torch.utils.checkpoint import set_checkpoint_early_stop

    from repro_torch.models import shard_ctx

    with shard_ctx.tensor_parallel(tp), set_checkpoint_early_stop(False):
        yield


class _MeshStep:
    """The mesh train step (see the module docstring); also its eval."""

    def __init__(self, model: Model, opt_cfg, mesh, microbatches: int, donate: bool):
        from repro_torch.launch.mesh import GROUP_TIMEOUT, Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh, not {type(mesh)}")
        self.model, self.cfg, self.opt_cfg = model, model.cfg, opt_cfg
        self.mesh, self.microbatches, self.donate = mesh, microbatches, donate
        self.specs = model.specs(mesh)
        self.spec_of = dict(tree_leaves(self.specs))
        self.dp_axes = tuple(a for a in ("pod", "data") if a in mesh.axes)
        self.n_data = math.prod(mesh.size(a) for a in self.dp_axes)
        self.grid = [mesh.local(a) for a in self.dp_axes]
        self.shards = mesh.local_shards(self.dp_axes) if self.dp_axes else [0]
        self.timeout = GROUP_TIMEOUT.total_seconds()
        # a dict here collects each step's seconds in its collective phases
        # (the parameters' gather, the model-axis sums of the split products,
        # the gradients' reduce and the norm), each synchronised with the
        # device; None records nothing
        self.timing = None
        self._timing_lock = threading.Lock()
        # the tensor-parallel context (on a mesh whose model axis has several
        # shards), else None
        from repro_torch.distributed.collectives import spans
        from repro_torch.models import shard_ctx, transformer

        plan = transformer.tp_plan(self.cfg, self.specs, mesh)
        self.tp, self.partial, self.whole, self.copy_dim = None, frozenset(), frozenset(), {}
        if plan is not None:
            self.tp = shard_ctx.TensorParallel(mesh, plan[0], self._timed)
            self.partial, self.whole = plan[1], transformer.tp_gathered(self.cfg, self.specs)
            self.copy_dim = {path: transformer.tp_copy_dim(self.cfg, path)
                             for path in self.partial}
            # the MoE's data shards run in threads (_Exchange), which must not
            # issue a model-axis collective across processes
            if self.cfg.moe and len(self.shards) > 1 and spans(mesh, "model"):
                raise ValueError(
                    f"{self.cfg.name} on {dict(zip(mesh.axes, mesh.shape))} over processes "
                    f"{dict(zip(mesh.axes, mesh.procs))}: a process holds "
                    f"{len(self.shards)} data shards while model spans processes; the "
                    "tensor-parallel MoE step needs one data shard a process there, or "
                    "the whole model axis in each process")

    @contextlib.contextmanager
    def _timed(self, name: str):
        if self.timing is None:
            yield
            return
        import time

        sync = self.mesh.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.mesh.device)
        t0 = time.perf_counter()
        yield
        if sync:
            torch.cuda.synchronize(self.mesh.device)
        with self._timing_lock:          # the MoE's data shards time from their threads
            self.timing[name] = self.timing.get(name, 0.0) + time.perf_counter() - t0

    # ----------------------------------------------------------- shards
    def _rows(self, batch: dict, m: int) -> tuple[dict, int, int]:
        """Microbatch ``m`` of the global batch, its rows a data shard."""
        B = batch["tokens"].shape[0]
        if B % (self.microbatches * self.n_data):
            raise ValueError(f"batch {B} does not split into {self.microbatches} microbatches "
                             f"of {self.n_data} data shards")
        mb = B // self.microbatches
        return ({k: v[m * mb:(m + 1) * mb] for k, v in batch.items()}, mb,
                mb // self.n_data)

    def _gather(self, params):
        """The parameters a shard computes with: whole, or under tensor
        parallelism gathered along the data axes only (the leaves of
        ``transformer.tp_gathered`` whole)."""
        from repro_torch.launch.shardings import gather_tree

        return gather_tree(params, self.mesh, self.specs,
                           self.dp_axes if self.tp is not None else None, whole=self.whole)

    def _live(self, path, p, grads: bool) -> torch.Tensor:
        """A leaf as the model takes it: detached, requiring grad when
        ``grads``; a partial leaf (``transformer.tp_plan``) with one copy a
        local ``model`` shard after its layer dimension (first where it has
        none, ``transformer.tp_copy_dim``), so that each shard's gradient
        stays its own."""
        p = p.detach()
        if path in self.partial:
            c = self.copy_dim[path]
            p = p.unsqueeze(c).expand(tuple(p.shape[:c]) + (self.tp.local,)
                                      + tuple(p.shape[c:]))
        return p.requires_grad_(grads)

    def _run_shards(self, full, mb: dict, rows: int, grads: bool) -> list:
        """Each of this process's data shards of one microbatch:
        ``(shard loss, ce part, aux part, dropped, grads | None)``."""
        denom = torch.clamp_min(torch.sum(mb["mask"]), 1.0)
        tokens = mb["tokens"].numel()
        exchange = _Exchange(self.mesh, self.dp_axes, self.grid, self.timeout) \
            if self.cfg.moe else None
        paths = [path for path, _ in tree_leaves(full)]

        def shard(q: int):
            g = self.shards[q]
            sb = {k: v[g * rows:(g + 1) * rows] for k, v in mb.items()}
            ctx = (moe.data_shard(moe.DataShard(g, self.n_data, tokens,
                                                lambda t: exchange(q, t)))
                   if exchange is not None else contextlib.nullcontext())
            with ctx as ds, torch.set_grad_enabled(grads):
                live = optim.tree_from_paths(full, {path: self._live(path, p, grads)
                                                    for path, p in tree_leaves(full)})
                _, metrics = self.model.loss(live, sb)
                ce = metrics["ce"] * (torch.clamp_min(torch.sum(sb["mask"]), 1.0) / denom)
                aux = torch.as_tensor(metrics["aux"], dtype=torch.float32, device=ce.device)
                loss = ce + aux
                g_out = None
                if grads:
                    leaves = [leaf for _, leaf in tree_leaves(live)]
                    g_out = dict(zip(paths, torch.autograd.grad(
                        loss, leaves, allow_unused=True, materialize_grads=True)))
            dropped = sum(ds.dropped) if ds is not None else 0
            return loss.detach(), ce.detach(), aux.detach(), dropped, g_out

        fns = [lambda q=q: shard(q) for q in range(len(self.shards))]
        # under tensor parallelism a checkpointed block's recompute runs whole
        # (no early stop), so its model-axis sums run as often on every
        # process and every torch version
        with contextlib.nullcontext() if self.tp is None else _tp_scope(self.tp):
            if exchange is None:
                return [f() for f in fns]
            try:
                return exchange.serve(fns)
            finally:
                moe.forget_calls()

    def _sum_over_shards(self, per_shard: list) -> list[torch.Tensor]:
        """Scalars a local shard (``[(a, b, ...)]``) summed over every data
        shard, in shard order."""
        from repro_torch.launch.shardings import gather_leaf

        mine = torch.stack([torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                                         device=self.mesh.device)
                                         for v in row]) for row in per_shard])
        every = gather_leaf(mine.reshape(self.grid + [mine.shape[-1]]), self.mesh,
                            P(*self.dp_axes)).reshape(-1, mine.shape[-1])
        return list(every.sum(dim=0))

    # ------------------------------------------------------------- norm
    def _global_norm(self, blocks: dict) -> torch.Tensor:
        """``optim.global_norm`` of the whole gradients from this process's
        blocks: the power-of-two scale from the global largest ``|g|``,
        each leaf's sum of squares taken a shard cell at a time (the cells
        of its spec's axes), every cell's sum all-reduced, and the cells
        added in (leaf, cell) order — the same bits however the processes
        hold the cells."""
        from repro_torch.distributed.collectives import all_reduce_max
        from repro_torch.launch.shardings import expanded

        mesh = self.mesh
        amax = optim.abs_max(blocks.values())
        for a in mesh.axes:
            amax = all_reduce_max(amax, mesh, a)
        inv, back = optim.pow2_scale(amax)
        cells = []
        for path in sorted(blocks):
            g, spec = blocks[path], self.spec_of[path]
            exp, pos = expanded(g.shape, mesh, spec, mesh.local)
            axes = sorted(pos, key=pos.get)
            t = g.reshape(exp)
            sums = torch.full((math.prod(mesh.size(a) for a in axes),), -1.0,
                              dtype=torch.float32, device=g.device)
            for local in itertools.product(*(range(mesh.local(a)) for a in axes)):
                cell = t
                for a, i in sorted(zip(axes, local), key=lambda ai: -pos[ai[0]]):
                    cell = cell.select(pos[a], i)
                gid = 0
                for a, i in zip(axes, local):
                    gid = gid * mesh.size(a) + mesh.start(a) + i
                sums[gid] = optim.sum_squares(cell.contiguous(), inv)
            cells.append(sums)
        every = torch.cat(cells)
        for a in mesh.axes:              # a cell this process does not hold is -1
            every = all_reduce_max(every, mesh, a)
        return torch.sqrt(torch.sum(every)) * back

    # ------------------------------------------------------------- step
    def __call__(self, params, opt_state, batch):
        from repro_torch.launch.shardings import reduce_blocks

        with self._timed("gather_s"):
            full = self._gather(params)
        acc: list[dict] = [dict() for _ in self.shards]
        sums, dropped = [], [0] * len(self.shards)
        for m in range(self.microbatches):
            mb, _, rows = self._rows(batch, m)
            out = self._run_shards(full, mb, rows, grads=True)
            for q, (loss, ce, aux, drop, g) in enumerate(out):
                for path, gl in g.items():
                    if path in acc[q]:
                        acc[q][path].add_(gl)
                    else:
                        acc[q][path] = gl.float()
                dropped[q] += drop
            sums.append(self._sum_over_shards([o[:3] for o in out]))
            del out
        del full
        blocks = {}
        with self._timed("reduce_s"):
            for path, spec in self.spec_of.items():
                contribs = torch.stack([a.pop(path) for a in acc])
                if path in self.partial:     # (shards, [L,] local model, ...) -> model first
                    contribs = contribs.movedim(1 + self.copy_dim[path], 1)
                # a leaf gathered whole has a complete gradient: its block is taken
                held = ("model",) if self.tp is not None and path not in self.whole else ()
                g = reduce_blocks(contribs.reshape(self.grid + list(contribs.shape[1:])),
                                  self.mesh, spec, self.dp_axes, held=held,
                                  partial="model" if path in self.partial else None)
                blocks[path] = g.div_(self.microbatches) if self.microbatches > 1 else g
                del contribs
            gnorm = self._global_norm(blocks)
        grads = optim.tree_from_paths(params, blocks)
        new_params, new_opt, stats = optim.update(self.opt_cfg, opt_state, params, grads,
                                                  inplace=self.donate, gnorm=gnorm)
        del grads, blocks
        if self.microbatches > 1:
            loss = sums[0][0]
            for s in sums[1:]:
                loss = loss + s[0]
            metrics = {"loss": loss / self.microbatches}
        else:
            metrics = {"loss": sums[0][0], "ce": sums[0][1], "aux": sums[0][2]}
        if self.cfg.moe:             # the assignments the global dispatch dropped
            metrics["dropped"] = self._sum_over_shards([(d,) for d in dropped])[0]
        return new_params, new_opt, {**metrics, **stats}

    def evaluate(self, params, batch) -> dict:
        full = self._gather(params)
        mb, _, rows = self._rows(batch, 0)
        out = self._run_shards(full, mb, rows, grads=False)
        loss, ce, aux = self._sum_over_shards([o[:3] for o in out])
        return {"loss": loss, "ce": ce, "aux": aux}
