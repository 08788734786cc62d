"""The port's tally of one step for the roofline: FLOPs, HBM bytes and
collective bytes a card.

The reference reads these from XLA's compiled HLO text (``analyze_hlo``:
dot FLOPs, the operand and result bytes of the ops that touch HBM, each
collective's operand bytes, ``while`` bodies weighted by their trip count).
The port has no HLO: eager PyTorch launches one kernel an op, so the port
tallies a step by running it under :class:`StepTally`, on ``meta`` tensors
where the step allows it.  The reference's HLO text parser therefore has no
counterpart here.  The record types and their meanings are the reference's:

* **FLOPs**: the products' (matmul, convolution, attention) operations,
  by ``torch.utils.flop_counter``'s formulas: the reference's dot-only rule.
  A product counts ``2·m·n·d`` whatever route runs it (a float32 one on
  three TF32 passes too).
* **HBM bytes**: the operand and result bytes of every op that moves data.
  Ops that only make a view (:data:`NO_BYTES` and every op whose schema
  returns an alias of its input) and ops that only allocate count nothing,
  as the reference's ``_NOBYTES_OPS`` do; fills count their result only,
  and a copy between the host and the card counts nothing (it crosses the
  bus: the step's inputs, its constants, a value read back).
* **Kernels**: the hand-written kernels launch through ``ctypes``, outside
  PyTorch's dispatcher.  A call of a ``kernels/ops.py`` entry charges its
  kernel's own cost (``kernels.util.metered``): its products' FLOPs to
  ``flops``, its other operations (fp32 arithmetic, compare-exchanges; no
  product) to ``ops``, which no roofline term reads, and its bytes.  The
  ops it runs inside count nothing, so a step counts the same on the CPU
  (the plain versions) as on the card.
* **Collectives**: planned (a card of a 256-card mesh is one process
  here, whose collectives move nothing): :func:`mesh_step_collectives`,
  :func:`serve_step_collectives` and :func:`index_merge_collectives` add up, in the reference's operand-bytes
  convention and under its five type names, what the port's collectives
  (``distributed/collectives.py``, whose ``COUNTS`` counts the same at run
  time) hand over for one step a process.  A collective's operand and
  result bytes are added to the HBM bytes, as the reference counts a
  collective op's.  Where a step runs its collectives on a planned group
  (``collectives.Planned``: the train step, the index cell's merge), the
  ops the port runs around the transport (the ring's adds, the gathered
  copies) are counted as they run.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.collectives import spans
from repro_torch.kernels.util import METERS
from repro_torch.launch.shardings import block_shape, dim_axes, expanded
from repro_torch.models import moe
from repro_torch.models.common import P, ParamBuilder, tree_leaves

aten = torch.ops.aten

# Ops that move no data: views (besides those whose schema says so), and
# allocations that write nothing.
NO_BYTES = {
    aten._unsafe_view, aten.alias, aten.detach, aten.lift_fresh, aten.empty,
    aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
    aten._local_scalar_dense,
}
# Copies between devices move data over the bus, not within a card's memory.
TRANSFERS = {aten._to_copy, aten.copy_, aten.lift_fresh_copy}
# Ops that write their result and read no data of their tensor operands.
WRITE_ONLY = {aten.zeros_like, aten.ones_like, aten.full_like, aten.new_zeros,
              aten.new_ones, aten.new_full, aten.fill_, aten.zero_}


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: int
    by_type: dict[str, int]
    by_computation: dict[str, int]     # the step's part that makes the collective
    trip_counts: dict[str, int]

    def fmt(self) -> str:
        rows = [f"  total collective operand bytes/device: {self.total_bytes:,}"]
        for k, v in sorted(self.by_type.items(), key=lambda kv: -kv[1]):
            rows.append(f"    {k:20s} {v:,}")
        return "\n".join(rows)


@dataclasses.dataclass
class HloStats:
    flops: float            # loop-weighted product FLOPs per device
    hbm_bytes: float        # loop-weighted operand+result bytes
    collectives: CollectiveStats


# ---------------------------------------------------------------------------
# The counted run
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Counts:
    """What a :class:`StepTally` counted: product FLOPs, the kernels' other
    operations, HBM bytes, and each by aten op and by kernel (``name ->
    [calls, flops, ops, bytes]``)."""

    flops: int = 0
    ops: int = 0
    hbm_bytes: int = 0
    by_op: dict = dataclasses.field(default_factory=lambda: defaultdict(lambda: [0] * 4))
    kernels: dict = dataclasses.field(default_factory=lambda: defaultdict(lambda: [0] * 4))

    def combine(self, terms: list[tuple[int, "Counts"]]) -> "Counts":
        """``self + Σ w · c`` over ``(w, c)`` in ``terms``: the weighting of
        a loop body by its trip count (integer weights, exact)."""
        out = Counts()
        for w, c in [(1, self), *terms]:
            out.flops += w * c.flops
            out.ops += w * c.ops
            out.hbm_bytes += w * c.hbm_bytes
            for table in ("by_op", "kernels"):
                dst = getattr(out, table)
                for k, v in getattr(c, table).items():
                    dst[k] = [a + w * b for a, b in zip(dst[k], v)]
        return out

    def minus(self, other: "Counts") -> "Counts":
        """``self − other`` (one loop body's counts from two runs)."""
        return self.combine([(-1, other)])

    def top(self, table: str = "by_op", n: int = 8) -> dict:
        """The ``n`` largest entries of a table by bytes."""
        rows = sorted(getattr(self, table).items(), key=lambda kv: -kv[1][3])[:n]
        return {k: dict(zip(("calls", "flops", "ops", "bytes"), v)) for k, v in rows}


def _tensors(obj):
    """The tensors in an op's arguments or results (tuples, lists, dicts)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)


def _tensor_bytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


class StepTally(TorchDispatchMode):
    """Counts every aten op run inside it (see the module docstring), and
    takes the kernel entries' charges while it is the innermost meter.

    ``bincount`` has no ``meta`` kernel; on ``meta`` inputs the tally gives
    it a ``minlength`` result, which is its length whenever the values stay
    below ``minlength`` (the MoE's expert ids)."""

    def __init__(self):
        super().__init__()
        self.counts = Counts()
        self._quiet = 0

    def __enter__(self):
        METERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        METERS.remove(self)
        return super().__exit__(*exc)

    def kernel_call(self, name: str, cost, fn, args, kw):
        """A kernel entry's call: its ops uncounted, its kernel's cost charged."""
        if self._quiet:
            return fn(*args, **kw)
        self._quiet += 1
        try:
            out = fn(*args, **kw)
            c = cost(out, *args, **kw)
        finally:
            self._quiet -= 1
        charge = [1, *(int(v) for v in c[:3])]          # calls, flops, ops, bytes
        row = self.counts.kernels[c[3] if len(c) > 3 else name]
        for i, v in enumerate(charge):
            row[i] += v
        self.counts.flops += charge[1]
        self.counts.ops += charge[2]
        self.counts.hbm_bytes += charge[3]
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is aten.bincount.default and args[0].is_meta:
            minlength = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
            out = torch.empty((minlength,), dtype=torch.int64, device="meta")
        else:
            out = func(*args, **kwargs)
        packet = func._overloadpacket
        if self._quiet or (packet in TRANSFERS
                           and len({t.device for t in _tensors((args, kwargs, out))}) > 1):
            return out
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        nbytes = 0
        if packet in WRITE_ONLY:
            nbytes = _tensor_bytes(out)
        elif packet not in NO_BYTES and not func.is_view:
            nbytes = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        row = self.counts.by_op[str(packet).removeprefix("aten.")]
        row[0] += 1
        row[1] += flops
        row[3] += nbytes
        self.counts.flops += flops
        self.counts.hbm_bytes += nbytes
        return out


# ---------------------------------------------------------------------------
# Collectives, planned
# ---------------------------------------------------------------------------
class CollectivePlan:
    """Collective operand bytes of a step, by type and by the step's part,
    added as the port's collectives would count them (only a collective
    whose axis spans more than one process counts); ``hbm_bytes`` gathers
    their operand and result bytes."""

    def __init__(self):
        self.by_type: dict[str, int] = defaultdict(int)
        self.by_part: dict[str, int] = defaultdict(int)
        self.trips: dict[str, int] = {}
        self.hbm_bytes = 0

    def add(self, kind: str, part: str, nbytes: int, across: bool, result_bytes: int):
        if across:
            self.by_type[kind] += int(nbytes)
            self.by_part[part] += int(nbytes)
            self.hbm_bytes += int(nbytes) + int(result_bytes)

    def gather(self, part: str, block, itemsize: int, mesh, spec, keep=()):
        """:func:`launch.shardings.gather_leaf` of a block of shape ``block``:
        one all-gather an axis of ``spec`` that this process does not hold
        whole (``keep``: axes left split), its operand the block gathered
        so far, its result that block from every process of the axis."""
        axes = [a for d in dim_axes(spec, len(block)) for a in d]
        if all(mesh.local(a) == mesh.size(a) for a in axes):
            return
        _, pos = expanded(block, mesh, spec, mesh.local)
        nbytes = math.prod(block) * itemsize
        for a in pos:
            if mesh.local(a) == mesh.size(a) or a in keep:
                continue
            procs = mesh.procs[mesh.axes.index(a)]
            self.add("all-gather", part, nbytes, spans(mesh, a), nbytes * procs)
            nbytes *= procs

    def reduce(self, part: str, shape, mesh, spec, axes, itemsize: int = 4):
        """:func:`launch.shardings.reduce_blocks` of contributions to a leaf
        of ``shape`` (float32 by default): a ring reduce-scatter over each
        of ``axes`` that splits the leaf (its result the operand's share of
        the axis), a ring all-reduce over each other (its result the
        operand's shape)."""
        exp, pos = expanded(shape, mesh, spec, mesh.size)
        nbytes = math.prod(mesh.local(a) for a in axes) * math.prod(exp) * itemsize
        for a in pos:
            if a not in axes:
                nbytes = nbytes // mesh.size(a) * mesh.local(a)
        for a in reversed(axes):
            if a in pos:
                self.add("reduce-scatter", part, nbytes, spans(mesh, a), nbytes // mesh.size(a))
                nbytes //= mesh.size(a)
            else:
                self.add("all-reduce", part, nbytes, spans(mesh, a), nbytes)
                nbytes //= mesh.local(a)

    def stats(self) -> CollectiveStats:
        return CollectiveStats(sum(self.by_type.values()), dict(self.by_type),
                               dict(self.by_part), dict(self.trips))


def _moe_layers(cfg) -> int:
    if not cfg.moe:
        return 0
    return cfg.n_layers // cfg.moe_every if cfg.moe_every > 1 else cfg.n_layers


def _tp_sums(plan: CollectivePlan, cfg, split, mesh, rows: int, S: int, S_enc: int = 0, *,
             train: bool = True) -> None:
    """One data shard's model-axis sums (``shard_ctx``'s ``enter`` and
    ``leave``, ``collectives.ordered_sum``; the vocab max) in a forward and
    backward of the tensor-parallel step, or with ``train=False`` in the
    serve step's forward (each region's sums once, none of the backward's,
    the recompute's or the loss's): the embedding's rows; each split
    region of a layer summed in the forward, again in its checkpointed
    recompute, and its input gradient in the backward — the decoder's
    attention and MLP (an MoE layer's experts and shared expert, and its
    gate values' gradient, ``(rows · S, top_k)`` float32, in the
    backward), RWKV6's time-mix and channel-mix, Mamba2's heads with their
    gated norm's ``(rows, S, 1)`` float32 sums of squares, zamba2's shared
    block at each site, encdec's encoder (over ``S_enc`` frames) and
    decoder self and cross attention and MLPs, and the encoder's output
    entering the cross attention once (its gradient, in the backward);
    each loss chunk's max and its ``(2, rows, C)`` exp sums and gold
    logits, in the forward and the recompute, and the chunk's input
    gradient."""
    local, item = mesh.local("model"), torch.empty((), dtype=cfg.dtype).element_size()
    across = spans(mesh, "model")

    def ordered(nbytes, times=1):
        for _ in range(times):
            plan.add("all-reduce", "tp_sums", local * nbytes, across,
                     local * nbytes * mesh.procs[mesh.axes.index("model")])

    act = rows * S * cfg.d_model * item
    passes = (3 if cfg.remat else 2) if train else 1
    if "vocab" in split:
        ordered(act)
    if cfg.family == "decoder":
        n_moe = _moe_layers(cfg)       # a tensor-parallel MoE layer always splits its experts
        regions = {"heads": cfg.n_layers,  # the layers each region runs in
                   "mlp": cfg.n_layers - n_moe + (n_moe if cfg.n_shared_experts else 0)}
        for group, layers in regions.items():
            if group in split:
                ordered(act, layers * passes)
        for _ in range(n_moe):         # the experts' region, and the gate values' gradient
            ordered(act, passes)
            if train:
                ordered(rows * S * cfg.top_k * 4)
    elif cfg.family == "rwkv6":
        for group in ("heads", "mlp"):
            if group in split:
                ordered(act, cfg.n_layers * passes)
    elif cfg.family == "zamba2":
        if "ssm_heads" in split:
            ordered(act, cfg.n_layers * passes)
            ordered(rows * S * 4, cfg.n_layers * passes)
        sites = max(cfg.n_layers // cfg.attn_every, 1)
        for group in ("heads", "mlp"):
            if group in split:
                ordered(act, sites * passes)
    else:                              # encdec
        enc = rows * S_enc * cfg.d_model * item
        layers = cfg.enc_layers or cfg.n_layers
        for group in ("heads", "mlp"):
            if group in split:
                ordered(enc, layers * passes)
                ordered(act, cfg.n_layers * passes * (2 if group == "heads" else 1))
        if "heads" in split:
            ordered(enc)
    if "vocab" in split and train:
        C = min(cfg.logits_chunk, S)
        for _ in range(-(-S // C)):
            for _ in range(2):                   # the forward and the recompute
                plan.add("all-reduce", "tp_sums", rows * C * 4, across, rows * C * 4)
                ordered(2 * rows * C * 4)
            ordered(rows * C * cfg.d_model * item)


def mesh_step_collectives(model, mesh, *, microbatches: int = 1,
                          batch: tuple[int, ...] | None = None) -> CollectivePlan:
    """One step of ``train/step.py::_MeshStep`` on ``mesh``, a process:
    the parameters' gather, each microbatch's MoE count exchanges (one
    ``(2, E)`` int64 vector a layer and a data shard) and loss sums, the
    float32 gradients' reduce, the global norm's two maxima (its scale and
    its cells) over every axis, and the MoE's dropped count.  Where the
    step is tensor-parallel (several ``model`` shards) the
    gather is along the data axes only (the leaves that run whole, an MoE
    router's, Mamba2's ``w_in``, along ``model`` too,
    ``transformer.tp_gathered``), each data shard's model-axis sums
    are added (:func:`_tp_sums`; ``batch`` is the global ``(B, S)``, and
    for encdec ``(B, S, S_enc)`` with the frames' length), and each
    partial leaf's float32 gradients are summed over ``model`` before the
    data axes."""
    from repro_torch.models import transformer

    cfg = model.cfg
    plan = CollectivePlan()
    shapes = dict(tree_leaves(model.shapes()))
    specs = dict(tree_leaves(model.specs(mesh)))
    dp = tuple(a for a in ("pod", "data") if a in mesh.axes)
    grid = [mesh.local(a) for a in dp]
    tp = transformer.tp_plan(cfg, model.specs(mesh), mesh)
    split, partial = tp or ((), ())
    if tp and batch is None:
        raise ValueError(f"{cfg.name}: the tensor-parallel step's plan needs the batch's (B, S)")
    _param_gather(plan, model, mesh, tp)
    layers = _moe_layers(cfg)
    for _ in range(microbatches):
        for _ in range(layers):
            plan.gather("moe_exchange", grid + [2, cfg.n_experts], 8, mesh, P(*dp))
        if tp:
            rows = batch[0] // microbatches // math.prod(mesh.size(a) for a in dp)
            for _ in range(math.prod(grid)):
                _tp_sums(plan, cfg, split, mesh, rows, *batch[1:])
        plan.gather("loss_sums", grid + [3], 4, mesh, P(*dp))
    for path, t in shapes.items():
        if path in partial:
            nbytes = math.prod(grid) * mesh.local("model") * t.numel() * 4
            plan.add("all-reduce", "grad_reduce", nbytes, spans(mesh, "model"),
                     nbytes * mesh.procs[mesh.axes.index("model")])
        plan.reduce("grad_reduce", t.shape, mesh, specs[path], dp)
    cells = sum(math.prod(mesh.size(a) for a in expanded(
        block_shape(t.shape, mesh, specs[path]), mesh, specs[path], mesh.local)[1])
        for path, t in shapes.items())
    for nbytes in (4, 4 * cells):
        for a in mesh.axes:
            plan.add("all-reduce", "global_norm", nbytes, spans(mesh, a), nbytes)
    if cfg.moe:
        plan.gather("loss_sums", grid + [1], 4, mesh, P(*dp))
    plan.trips.update(microbatches=microbatches, moe_layers=layers)
    return plan


def _param_gather(plan: CollectivePlan, model, mesh, tp) -> None:
    """The parameters' gather of a mesh step: along the data axes only under
    the tensor-parallel plan ``tp`` (the leaves of
    ``transformer.tp_gathered`` along ``model`` too), else whole."""
    from repro_torch.models import transformer

    specs = dict(tree_leaves(model.specs(mesh)))
    whole = transformer.tp_gathered(model.cfg, model.specs(mesh)) if tp else frozenset()
    for path, t in tree_leaves(model.shapes()):
        plan.gather("param_gather", block_shape(t.shape, mesh, specs[path]),
                    t.element_size(), mesh, specs[path],
                    keep=("model",) if tp and path not in whole else ())


def serve_step_collectives(model, mesh, kind: str, *, batch: tuple[int, int]
                           ) -> CollectivePlan:
    """One call of the decoders' split serve step (``launch/dryrun.py``'s
    ``prefill_step`` for ``kind`` ``"prefill"``, ``serve_step`` for
    ``"decode"``) on ``mesh``, a process, for a ``batch`` of ``(B, S)``
    (the prompts' length, or the decode cache's): the parameters' gather
    (as :func:`mesh_step_collectives`'s), and for each of this process's
    data shards the forward's model-axis sums (:func:`_tp_sums` at ``rows ×
    S`` tokens, or ``rows × 1`` a decode step).  A decode step whose cache
    splits along ``model`` by its sequence adds, each layer, the gather of
    the local shards' queries along ``model`` (where the heads split; MLA's
    absorbed queries and their rotary part), the merge's maximum of the
    scores and its ordered sum of the rescaled ``Σ exp`` and values
    (float32, float64 for a float64 model), and the argmax's two maxima
    (its value, its negated index, int64) where the vocab splits."""
    from repro_torch.launch.shardings import decode_state_specs
    from repro_torch.models import transformer

    cfg = model.cfg
    plan = CollectivePlan()
    tp = transformer.tp_plan(cfg, model.specs(mesh), mesh)
    _param_gather(plan, model, mesh, tp)
    if not tp:
        return plan
    split = tp[0]
    B, S = batch
    dp = tuple(a for a in ("pod", "data") if a in mesh.axes)
    n = math.prod(mesh.local(a) for a in dp)
    rows = B // math.prod(mesh.size(a) for a in dp)
    seq = dim_axes(decode_state_specs(cfg, mesh, B, S).cache[0], 5)[2]
    local, across = mesh.local("model"), spans(mesh, "model")
    procs = mesh.procs[mesh.axes.index("model")]
    item = torch.empty((), dtype=cfg.dtype).element_size()
    acc = torch.empty((), dtype=torch.promote_types(cfg.dtype, torch.float32)).element_size()
    H = cfg.n_heads
    for _ in range(n):
        _tp_sums(plan, cfg, split, mesh, rows, S if kind == "prefill" else 1, train=False)
        if kind == "prefill":
            continue
        if "model" in seq:
            q_width, v_width = ((cfg.kv_lora_rank + cfg.rope_head_dim, cfg.kv_lora_rank)
                                if cfg.mla else (cfg.hd, cfg.hd))
            for _ in range(cfg.n_layers):
                if "heads" in split:
                    nbytes = local * rows * H // mesh.size("model") * q_width * item
                    plan.add("all-gather", "serve_merge", nbytes, across, nbytes * procs)
                plan.add("all-reduce", "serve_merge", rows * H * acc, across, rows * H * acc)
                nbytes = local * rows * H * (1 + v_width) * acc
                plan.add("all-reduce", "serve_merge", nbytes, across, nbytes * procs)
        if "vocab" in split:
            for nbytes in (rows * acc, rows * 8):
                plan.add("all-reduce", "serve_argmax", nbytes, across, nbytes)
    return plan


def ep_layer_collectives(cfg, mesh, B: int, S: int) -> CollectivePlan:
    """The expert-parallel MoE layer (``models/moe.py::_moe_ffn_ep``)
    forward and backward over a ``(B, S, d)`` residual, a process: the
    router, experts and shared expert gathered once a layer (their
    gradients reduced back over the same axes, in the leaves' dtype), the
    ``frac`` and aux scalars gathered, and for each of this process's data
    shards two all-to-alls over ``model`` forward and two backward, each
    of its ``(local model, model, E / model, C, d)`` slots."""
    plan = CollectivePlan()
    dp = tuple(a for a in ("pod", "data") if a in mesh.axes)
    tp = mesh.size("model") if "model" in mesh.axes else 1
    every = dp + (("model",) if tp > 1 else ())
    dp_size = math.prod(mesh.size(a) for a in dp)
    E, K = cfg.n_experts, cfg.top_k
    T_dev = B * S // (dp_size * tp)
    C = min(max(int(T_dev * K / max(E, 1) * cfg.capacity_factor) + 1, 4), T_dev * K)
    shapes = dict(tree_leaves(moe.build_moe_params(cfg, ParamBuilder(cfg, "shape"),
                                                   prefix_layers=False)))
    specs = dict(tree_leaves(moe.build_moe_params(cfg, ParamBuilder(cfg, "spec", mesh=mesh),
                                                  prefix_layers=False)))
    for path, t in shapes.items():
        axes = dp if path[0] == "experts" else every
        spec = moe._only(specs[path], axes)
        plan.gather("ep_gather", block_shape(t.shape, mesh, specs[path]), t.element_size(),
                    mesh, spec)
        plan.reduce("ep_grad_reduce", t.shape, mesh, spec, axes, t.element_size())
    tp_loc = mesh.local("model") if tp > 1 else 1
    grid = [mesh.local(a) for a in dp] + [tp_loc]          # this process's token shards
    plan.gather("ep_aux", grid + [E], 4, mesh, P(*every))  # the shards' frac
    plan.gather("ep_aux", grid, 4, mesh, P(*every))        # the shards' aux parts
    if tp > 1:
        slots = tp_loc * E * C * cfg.d_model * torch.empty((), dtype=cfg.dtype).element_size()
        for _ in range(4 * math.prod(mesh.local(a) for a in dp)):
            plan.add("all-to-all", "ep_all_to_all", slots, spans(mesh, "model"), slots)
    return plan


def index_merge_collectives(mesh, index_axes, nq: int, k: int) -> CollectivePlan:
    """The sharded search's hierarchical merge
    (``core/sharded.py::make_sharded_search_fn``): the ``(nq, k)`` int32 ids
    and float32 distances of this process's shards gathered along each
    index axis, the inner axis first, and merged to ``k`` before the next."""
    plan = CollectivePlan()
    dims = [mesh.local(a) for a in index_axes]
    for j in reversed(range(len(index_axes))):
        a = index_axes[j]
        nbytes = math.prod(dims) * nq * k * 4
        for _ in ("ids", "dist"):
            plan.add("all-gather", "merge", nbytes, spans(mesh, a),
                     nbytes * mesh.procs[mesh.axes.index(a)])
        dims[j] = 1
    return plan
