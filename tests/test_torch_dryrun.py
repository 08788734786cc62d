"""The port's dry-run (``launch/dryrun.py``) and its tally of a step
(``launch/hlo_analysis.py``) against the reference's compiled cells.

The reference's side runs once, in one subprocess with 4 fake CPU devices
(``tests/test_torch_ep.py``'s way), started before the port's side runs
here: it lowers and compiles a reduced dense (qwen1.5-4b) and a reduced MoE
(qwen3-moe) train cell on a (2, 2) and on a (2, 1) host mesh, their
prefill and decode cells on (2, 2), a reduced encoder-decoder
(seamless-m4t) train cell on (2, 2), and a reduced index cell (n = 4,096,
d = 32) on (2, 2), and reports each cell's
``memory_analysis().argument_size_in_bytes`` and ``analyze_hlo`` FLOPs.

* The card's argument bytes equal the reference's exactly, for the four
  train and index cells and the four prefill and decode cells on (2, 2).
* The prefill and decode cells on (2, 2) (the port's split serve step,
  ``dryrun.prefill_step``/``serve_step``): the dense cells' FLOPs within
  5 % of the reference's; the MoE prefill cell's after a stated term (the
  port's card routes its rows as one group with that group's capacity,
  where the reference's expert-parallel path gives each device's token
  shard its own); the MoE decode cell's with none (both take the local
  path, one group a data shard).  Every decoder's reduced serve cell on
  (1, 4) gathers no parameter along ``model`` but the router and no decode
  state, and its counted collectives are its plan.
* The train cells' FLOPs on (2, 1) (no model split: both packages compute
  the same products a device) lie within 5 % of the reference's, and the
  dense cell's on (2, 2), where both split the products over ``model``
  (the port's tensor-parallel step).  For the
  MoE cell the port's count is first reduced by a stated term: the port's
  mesh step dispatches a data shard's tokens into the step's global
  capacity (``capacity(cfg, B·S)`` slots an expert, ``models/moe.py``'s
  global dispatch), where the reference's partitioned step runs its
  expert-parallel path with a device's capacity (``capacity`` over
  ``B·S / 2`` tokens); the experts' three products over the extra slots,
  run forward, again in the remat recompute and twice in the backward, are
  that term.  The encoder-decoder cell on (2, 2), split too, after two
  stated terms: ``frame_proj`` whole on every card, and the split step's
  whole recompute (no early stop) of each block's last MLP product.
* The tally charges each kernel entry its kernel's own work (no product
  FLOPs for these two kernels: their operations go to ``ops``) and counts
  none of its plain version's ops; the index cell's kernel charges are the
  rule's, call by call.
* A tower cell's depth-weighted count equals the count of the whole stack,
  op for op (these port-only tests run while the reference compiles).
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.registry import ShapeSpec, get_arch
from repro_torch.kernels import beam_merge as bm_mod
from repro_torch.kernels import expand_score as es_mod
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import StepTally
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe

REPO = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 240
ARCHS = ("qwen1.5-4b", "qwen3-moe-235b-a22b")
SPLIT = ("seamless-m4t-medium",)      # a family outside the decoder, its (2, 2) cell only
TRAIN = dict(seq=16, batch=4)
SERVE = dict(prefill_32k=("prefill", 16, 4), decode_32k=("decode", 16, 4))   # kind, S, B
INDEX = dict(n_global=4096, dim=32, m_deg=16, ef=16, nq=16)

REFERENCE = r"""
import concurrent.futures, dataclasses, json, sys, types
from repro.launch import dryrun              # sets XLA_FLAGS before jax starts
import jax
from repro.configs import registry
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_mesh
from repro.models import shard_ctx

dryrun.SHAPES = {"train_4k": registry.ShapeSpec("train_4k", TRAIN["seq"], TRAIN["batch"],
                                                "train"),
                 **{n: registry.ShapeSpec(n, s, b, k) for n, (k, s, b) in SERVE.items()}}
cfgs = {a: dataclasses.replace(registry.get_arch(a).reduced, n_layers=1) for a in ARCHS + SPLIT}
dryrun.get_arch = lambda name: types.SimpleNamespace(config=cfgs[name])
# the index cell (the longest compile) first
jobs = ([("index", (2, 2), None)] + [(a, s, "train_4k") for a in ARCHS for s in ((2, 2), (2, 1))]
        + [(a, (2, 2), "train_4k") for a in SPLIT]
        + [(a, (2, 2), n) for a in ARCHS for n in SERVE])


def compiled(lo, flops: bool):
    c = lo.compile()
    out = dict(argument=int(c.memory_analysis().argument_size_in_bytes))
    if flops:
        out["flops"] = float(analyze_hlo(c.as_text()).flops)
    return out


# each cell compiles in a thread while the next one lowers
with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
    futures = []
    for name, shape, cell in jobs:
        mesh = make_mesh(shape, ("data", "model"))
        if name == "index":
            fn, args, in_sh, out_sh = dryrun.build_index_cell(mesh, **INDEX)
            donate = ()
        else:
            fn, args, in_sh, out_sh, donate = dryrun.build_cell(name, cell, mesh)
        with shard_ctx.use_mesh(mesh):
            lowered = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                              donate_argnums=donate).lower(*args)
        futures.append(pool.submit(compiled, lowered, name != "index"))
    out = {f"{n}@{s[0]}x{s[1]}" + ("" if c in (None, "train_4k") else f"/{c}"): f.result()
           for (n, s, c), f in zip(jobs, futures)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: torch's intra-op pool would only contend with the
    reference's compiles and the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference's cells (see the module docstring): a subprocess started
    when the module's first test starts; ``reference()`` waits for it."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               DRYRUN_XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                                "--xla_backend_optimization_level=0")
    code = (f"ARCHS = {ARCHS!r}\nSPLIT = {SPLIT!r}\nTRAIN = {TRAIN!r}\nINDEX = {INDEX!r}\n"
            f"SERVE = {SERVE!r}\n" + REFERENCE)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    result = {}

    def wait() -> dict:
        if not result:
            out, err = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
            result.update(json.loads(out.strip().splitlines()[-1]))
        return result

    try:
        yield wait
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def cfg_of(arch: str):
    return dataclasses.replace(get_arch(arch).reduced, n_layers=1)


def train_shape() -> ShapeSpec:
    return ShapeSpec("train_4k", TRAIN["seq"], TRAIN["batch"], "train")


def serve_shape(name: str) -> ShapeSpec:
    kind, seq, batch = SERVE[name]
    return ShapeSpec(name, seq, batch, kind)


def port_cell(arch: str, shape, cell: str = "train_4k") -> dict:
    mesh = make_mesh(shape, ("data", "model"), device="meta")
    spec = train_shape() if cell == "train_4k" else serve_shape(cell)
    rec = dryrun.run_cell(arch, spec, "host", cfg=cfg_of(arch), mesh=mesh, verbose=False)
    assert rec["ok"], rec.get("traceback")
    return rec


# ------------------------------------------------------------------ tally
def small_scores(seed: int):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(300, 16, generator=g)
    q = torch.randn(8, 16, generator=g)
    idx = torch.randint(0, 300, (8, 32), generator=g, dtype=torch.int32)
    idx[:, ::3] = -1
    return x, idx, q


def test_kernel_entry_charges_its_kernel_and_not_its_ops():
    """``ops.expand_score`` and ``ops.beam_merge`` on the CPU charge their
    kernels' rule and count none of the plain versions' aten ops; the
    plain version called outside the entry counts its ops; ``legacy``
    launches no kernel and counts its ops."""
    x, idx, q = small_scores(0)
    n_valid = int((idx >= 0).sum())
    with StepTally() as t:
        d = ops.expand_score(x, idx, q)
    assert dict(t.counts.by_op) == {}
    assert t.counts.kernels["expand_score"] == [1, 0, n_valid * 3 * 16,
                                                n_valid * 4 * 16 + 8 * 32 * 8 + 8 * 16 * 4]
    assert (t.counts.flops, t.counts.ops) == (0, n_valid * 3 * 16)
    with StepTally() as t:
        es_mod.expand_score_torch(x, idx, q)
    assert t.counts.by_op and not t.counts.kernels
    with StepTally() as t:
        ops.expand_score(x, idx, q, backend="legacy")
    assert t.counts.by_op and not t.counts.kernels

    B, E, L = 8, 16, 32
    bd, _ = torch.sort(torch.rand(B, E), dim=-1)
    bp = (torch.arange(B * E, dtype=torch.int32).reshape(B, E) << 1)
    cp = torch.where(torch.isfinite(d), idx << 1, bm_mod.PAD_PAYLOAD).to(torch.int32)
    with StepTally() as t:
        ops.beam_merge(bd, bp, d.contiguous(), cp.contiguous())
    assert dict(t.counts.by_op) == {}
    ce = L // 2 * 5 * 6 // 2 + E + E // 2 * 4            # log2 L = 5, log2 E = 4
    assert t.counts.kernels["beam_merge"] == [1, 0, B * ce * 2, B * (2 * E + 2 * L) * 4
                                              + B * 2 * E * 4]


def test_index_cell_kernel_charges_follow_the_rule(monkeypatch):
    """The index cell's one-iteration step on the plain versions: each
    ``expand_score`` and ``beam_merge`` call is charged its rule on the
    call's own inputs (recorded here), and the loop's weighting is the
    second iteration's counts ``iters_cap - 1`` times."""
    calls = {"expand_score": [], "beam_merge": []}
    score, merge = es_mod.expand_score_torch, bm_mod.beam_merge_torch

    def rec_score(x, idx, q):
        n_valid = int((idx >= 0).sum())
        B, C = idx.shape
        d = q.shape[1]
        calls["expand_score"].append((n_valid * 3 * d, n_valid * 4 * d + B * C * 8 + B * d * 4))
        return score(x, idx, q)

    def rec_merge(beam_d, beam_p, cand_d, cand_p):
        B, E = beam_d.shape
        L = bm_mod.next_pow2(max(cand_d.shape[1], 2))
        lg, le = int(math.log2(L)), int(math.log2(E))
        ce = L // 2 * lg * (lg + 1) // 2 + E + E // 2 * le
        calls["beam_merge"].append((B * ce * 2,
                                    B * (2 * E + 2 * cand_d.shape[1]) * 4 + B * 2 * E * 4))
        return merge(beam_d, beam_p, cand_d, cand_p)

    monkeypatch.setattr(es_mod, "expand_score_torch", rec_score)
    monkeypatch.setattr(bm_mod, "beam_merge_torch", rec_merge)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    step, mem, plan, W, iters_cap = dryrun.build_index_cell(mesh, device="cpu", **INDEX)
    with StepTally() as t:
        step(W)
    for name, rows in calls.items():
        assert len(rows) == 2                       # the entries, one iteration
        assert t.counts.kernels[name] == [2, 0, sum(r[0] for r in rows),
                                          sum(r[1] for r in rows)]
    counts, one, _, _, _ = dryrun.count_index_cell(mesh, device="cpu", **INDEX)
    assert counts.kernels["beam_merge"][0] == 1 + iters_cap
    assert one.kernels == t.counts.kernels
    assert plan.stats().by_type == {"all-gather": 2 * INDEX["nq"] * 10 * 4}
    assert iters_cap == (8 * INDEX["ef"] + 32 + 3) // 4


@pytest.mark.parametrize("arch,depth", [
    ("qwen1.5-4b", dict(n_layers=4)),
    ("llama4-maverick-400b-a17b", dict(n_layers=6)),
    ("zamba2-2.7b", dict(n_layers=6)),
    ("seamless-m4t-medium", dict(enc_layers=3, n_layers=2)),
])
def test_depth_weighted_count_equals_the_whole_stack(arch, depth):
    """The count at one and two periods, weighted to the depth, equals the
    count of the whole stack, op for op (train cells on (2, 2))."""
    cfg = dataclasses.replace(get_arch(arch).reduced, **depth)
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    shape = ShapeSpec("train_4k", 16, 4, "train")
    weighted, _, _, trips = dryrun.count_tower_cell(arch, shape, mesh, cfg=cfg)
    step = dryrun.build_cell(arch, shape, mesh, cfg=cfg)[0]
    with StepTally() as t:
        step()
    moe.forget_calls()
    assert trips == depth
    assert (weighted.flops, weighted.hbm_bytes) == (t.counts.flops, t.counts.hbm_bytes)
    assert {k: v for k, v in weighted.by_op.items() if any(v)} == dict(t.counts.by_op)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_runs_the_mesh_step_collectives(arch):
    """A train cell runs the mesh step itself on the card's view: its
    collectives, on planned groups, count what the cell's plan says."""
    from repro_torch.distributed import collectives

    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    step, _, plan = dryrun.build_cell(arch, train_shape(), mesh, cfg=cfg_of(arch))
    collectives.reset_counts()
    with StepTally():                 # as the cell is counted (bincount on meta)
        step()
    moe.forget_calls()
    assert collectives.counts() == plan.stats().by_type


# -------------------------------------------------------- the reference
@pytest.mark.parametrize("cell", list(ARCHS) + list(SPLIT) + ["index"])
def test_argument_bytes_equal_the_reference(reference, cell):
    if cell == "index":
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        got = dryrun.build_index_cell(mesh, device="cpu", **INDEX)[1]["argument"]
    else:
        got = port_cell(cell, (2, 2))["mem"]["argument"]
    assert got == reference()[f"{cell}@2x2"]["argument"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_flops_within_five_percent_on_2x1(reference, arch):
    cfg = cfg_of(arch)
    got = port_cell(arch, (2, 1))["flops"]
    if cfg.moe:
        # the global dispatch's extra slots over a device's (module docstring)
        T = TRAIN["batch"] * TRAIN["seq"]
        extra = moe.capacity(cfg, T) - moe.capacity(cfg, T // 2)
        per_pass = 3 * 2 * cfg.n_experts * extra * cfg.d_model * cfg.moe_d_ff
        got -= per_pass * (4 if cfg.remat else 3) * cfg.n_layers
    want = reference()[f"{arch}@2x1"]["flops"]
    assert abs(got - want) <= 0.05 * want, (got, want)


def test_train_flops_within_five_percent_on_2x2(reference):
    """The dense cell on (2, 2) runs the tensor-parallel step: a card
    computes its model shard's heads, MLP columns and vocab rows, as the
    reference's partitioned step splits its products over ``model``."""
    got = port_cell("qwen1.5-4b", (2, 2))["flops"]
    want = reference()["qwen1.5-4b@2x2"]["flops"]
    assert abs(got - want) <= 0.05 * want, (got, want)


def test_moe_train_flops_within_five_percent_on_2x2(reference):
    """The MoE cell on (2, 2) runs the tensor-parallel step: a card computes
    its model shard's ``E / 2`` experts (and heads and vocab rows), as the
    reference's expert-parallel path gives a device ``E / 2`` experts.  A
    card's experts still take the step's global capacity, where the
    reference's take ``model`` devices' token shards of a device's
    capacity each (``capacity`` over ``B·S / 4`` tokens); the three expert
    products over the extra slots, in the four passes of the 2x1 test's
    term, are taken off first."""
    cfg = cfg_of("qwen3-moe-235b-a22b")
    got = port_cell("qwen3-moe-235b-a22b", (2, 2))["flops"]
    T, tp = TRAIN["batch"] * TRAIN["seq"], 2
    extra = cfg.n_experts // tp * (moe.capacity(cfg, T) - tp * moe.capacity(cfg, T // 4))
    got -= 3 * 2 * extra * cfg.d_model * cfg.moe_d_ff * (4 if cfg.remat else 3) * cfg.n_layers
    want = reference()["qwen3-moe-235b-a22b@2x2"]["flops"]
    assert abs(got - want) <= 0.05 * want, (got, want)


def test_encdec_train_flops_within_five_percent_on_2x2(reference):
    """Reduced seamless-m4t (2 encoder layers, 1 decoder layer) on (2, 2)
    runs the tensor-parallel step: a card computes its model shard's
    encoder, decoder and cross attention heads, MLP columns and vocab rows.
    Two terms the reference's partitioned step does not have are taken off
    first: ``frame_proj`` runs whole on every card (its columns are the
    encoder input's channels; gathering the leaf moves fewer bytes than
    gathering its output's), half of its forward and of its weight
    gradient over the reference's split; and the split step's recompute
    of a checkpointed block runs whole (no early stop, so that its
    model-axis sums run as often on every process), where the unsplit
    step's and the reference's skip each block's last MLP product."""
    cfg = cfg_of("seamless-m4t-medium")
    got = port_cell("seamless-m4t-medium", (2, 2))["flops"]
    rows, S_enc, S_dec = TRAIN["batch"] // 2, TRAIN["seq"] // 2, TRAIN["seq"] // 2
    frame_proj = 2 * rows * S_enc * cfg.d_model * cfg.d_model * 2 // 2
    w_down = (cfg.enc_layers * S_enc + cfg.n_layers * S_dec) * rows * 2 * cfg.d_ff // 2 \
        * cfg.d_model
    got -= frame_proj + w_down
    want = reference()["seamless-m4t-medium@2x2"]["flops"]
    assert abs(got - want) <= 0.05 * want, (got, want)


# ------------------------------------------------------------ serve cells
@pytest.mark.parametrize("cell", list(SERVE))
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_argument_bytes_equal_the_reference(reference, arch, cell):
    assert port_cell(arch, (2, 2), cell)["mem"]["argument"] == \
        reference()[f"{arch}@2x2/{cell}"]["argument"]


@pytest.mark.parametrize("cell", list(SERVE))
def test_dense_serve_flops_within_five_percent_on_2x2(reference, cell):
    """The dense prefill and decode cells on (2, 2): a card computes its
    rows' part of its model shard's heads, MLP columns and vocab columns
    against its block of the cache, as the reference's partitioned step
    does."""
    got = port_cell("qwen1.5-4b", (2, 2), cell)["flops"]
    want = reference()[f"qwen1.5-4b@2x2/{cell}"]["flops"]
    assert abs(got - want) <= 0.05 * want, (got, want)


@pytest.mark.parametrize("cell", list(SERVE))
def test_moe_serve_flops_within_five_percent_on_2x2(reference, cell):
    """The MoE prefill and decode cells on (2, 2): a card routes its rows
    as one group and computes its ``E / 2`` experts.  At prefill the
    reference takes its expert-parallel path (``S`` divides ``model``): a
    device's capacity over its ``rows · S / 2`` tokens, ``model`` token
    shards of it for a device's ``E / 2`` experts; the port's card takes
    its group's capacity over ``rows · S`` tokens.  The three expert
    products over the difference in slots (forward only) are taken off
    first.  At decode both take the local path, one group a data shard, so
    no term."""
    cfg = cfg_of("qwen3-moe-235b-a22b")
    kind, seq, batch = SERVE[cell]
    got = port_cell("qwen3-moe-235b-a22b", (2, 2), cell)["flops"]
    if kind == "prefill":
        T, tp = batch // 2 * seq, 2
        extra = cfg.n_experts // tp * (moe.capacity(cfg, T) - tp * moe.capacity(cfg, T // tp))
        got -= 3 * 2 * extra * cfg.d_model * cfg.moe_d_ff * cfg.n_layers
    want = reference()[f"qwen3-moe-235b-a22b@2x2/{cell}"]["flops"]
    assert abs(got - want) <= 0.05 * want, (got, want)


DECODERS = ("chameleon-34b", "llama4-maverick-400b-a17b", "minicpm3-4b", "qwen1.5-4b",
            "qwen3-32b", "qwen3-moe-235b-a22b", "starcoder2-15b")


@pytest.mark.parametrize("arch", DECODERS)
def test_serve_cells_gather_no_model_block(arch):
    """Every decoder's reduced prefill and decode cells on (1, 4): the plan
    gathers no parameter along ``model`` but those that run whole
    (``transformer.tp_gathered``: an MoE config's router) and no decode
    state, and the cell's collectives, run on planned groups, count what
    the plan says (the serve step also refuses a state that is not its
    ``decode_state_specs`` block)."""
    from repro_torch.distributed import collectives
    from repro_torch.launch import shardings as sl
    from repro_torch.launch.hlo_analysis import CollectivePlan
    from repro_torch.models import get_model, transformer
    from repro_torch.models.common import tree_leaves

    cfg = dataclasses.replace(get_arch(arch).reduced, n_layers=get_arch(arch).reduced.moe_every)
    model = get_model(cfg)
    mesh = make_mesh((1, 4), ("data", "model"), device="meta")
    card = dryrun.card_view(mesh)
    whole = CollectivePlan()
    specs = dict(tree_leaves(model.specs(mesh)))
    for path in transformer.tp_gathered(cfg, model.specs(mesh)):
        t = dict(tree_leaves(model.shapes()))[path]
        whole.gather("param_gather", sl.block_shape(t.shape, card, specs[path]),
                     t.element_size(), card, specs[path])
    for cell in SERVE:
        step, _, plan = dryrun.build_cell(arch, serve_shape(cell), mesh, cfg=cfg)
        parts = plan.stats().by_computation
        assert "state_gather" not in parts
        assert parts.get("param_gather", 0) == whole.stats().by_computation.get("param_gather", 0)
        assert parts["tp_sums"] > 0 and (cell == "prefill_32k") != ("serve_argmax" in parts)
        collectives.reset_counts()
        with StepTally():
            step()
        assert collectives.counts() == plan.stats().by_type, cell
