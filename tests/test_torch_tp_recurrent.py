"""Tensor parallelism for rwkv6, zamba2 and encdec in the port's mesh step
(``models/shard_ctx.py::plan_groups``, the families' ``tp_groups``,
``train/step.py::_MeshStep``), on the CPU in one process with one torch
thread, every input drawn with numpy.  This file holds the port's split
step to the port's one-device step; the same split steps are held to the
reference's jitted step (its xla backend, on the same arrays) in
``tests/test_torch_mesh_train.py`` (``TP_ARCHS``, on (1, 4) too).

* The plan of the three archs' specs on ``(1, 2)``, ``(2, 2)`` and
  ``(1, 4)`` and on the 16×16 production mesh, reduced and at full width:
  the split groups, the partial leaves and the leaves gathered whole,
  among them the groups that fall back to running whole (reduced rwkv6's
  4 heads and reduced zamba2's 2 Mamba heads do not split 16 ways, nor
  zamba2's 4) while some of their leaves split (``w_g``; ``w_in``,
  ``conv_w``, ``gn``, ``w_out``); a leaf no group reads raises.
* The split step of the three reduced archs on those three meshes against
  the one-device step: the parameters after one step
  (``AdamWConfig(eps=1e-3)``), the loss, and the eval step's loss.
  rwkv6 within 1e-6.  Reduced zamba2 and seamless amplify the split's
  rounding (near one-hot attention at the reference's init scale): here
  seamless's parameters lie 1.5e-6 from the one-device step's, in
  ``embed`` (Adam's first step passes a near-zero gradient's rounding
  through, ``lr / eps = 1``), and ``python -m repro_torch.bench.
  split_rounding --device cpu --seeds 1 2 3 4 5`` finds up to 9.9e-7
  (zamba2) and 2.3e-6 (seamless) against at most 1.2e-7 for the unsplit
  data-parallel step, while a one-device step from weights moved by
  2^-24 lies up to 1.5e-6 and 1.6e-5 away (the towers' own sensitivity
  to one rounding); so their float32 steps
  are held to 1e-5, and the three archs' float64 steps to 1e-6, their
  loss too (the norms, scans and loss still round in float32), as
  ``tests/test_torch_tp_moe.py`` holds llama4.
* zamba2's shared attention with its kv heads replicated along ``model``
  (a config with 2 kv heads on (1, 4)): partial leaves without a layer
  dimension, their copies first.
* The new operators against plain sums: the gated norm's sum
  (``enter(leave(·))``: every shard's gradient summed back), and the
  reduce of a leaf gathered whole and then read a shard's columns at a
  time (``reduce_blocks(..., partial="model", held=())``).

The split step is held to the reference's jitted step in
``tests/test_torch_mesh_train.py`` (the three archs on (1, 4) too), and
across gloo processes there, the plan's collective bytes included.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shardings import gather_tree, reduce_blocks, shard_tree
from repro_torch.models import get_model, shard_ctx, transformer
from repro_torch.models.common import P, tree_leaves
from repro_torch.train import AdamWConfig, make_eval_step, make_train_step, optim
from torch_mesh_ranks import STEP_CFG, reduced

ARCHS = ("rwkv6-1.6b", "zamba2-2.7b", "seamless-m4t-medium")
MESHES = ((1, 2), (2, 2), (1, 4))
B, S, S_ENC = 4, 16, 8
TOL = 1e-6                       # tests/test_torch_mesh_train.py's mesh-vs-one-device bound
TOL_F32 = {"zamba2-2.7b": 1e-5, "seamless-m4t-medium": 1e-5}     # see the module docstring
MIXES = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "decay_lora_a")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh_of(shape, device="cpu"):
    return make_mesh(shape, ("data", "model"), device=device)


def numpy_params(model, seed: int, dtype=torch.float32) -> dict:
    """Every leaf drawn with numpy: gammas 1 + N(0, 0.1²), RWKV6's mixes
    U(0, 1) logits and decay base N(−1, 0.5²), Mamba2's ``dt_bias``,
    ``a_log`` and ``d_skip`` N(0, 0.5²), the others N(0, 1) over the square
    root of their fan-in."""
    rng = np.random.default_rng(seed)

    def draw(path, t):
        name = path[-1]
        if name.startswith(("ln", "gn")) or name.endswith("norm"):
            return 1.0 + 0.1 * rng.standard_normal(t.shape)
        if name.startswith("mu_"):
            return rng.random(t.shape)
        if name == "decay_base":
            return -1.0 + 0.5 * rng.standard_normal(t.shape)
        if name in ("dt_bias", "a_log", "d_skip", "bonus"):
            return 0.5 * rng.standard_normal(t.shape)
        fan_in = t.shape[-2] if t.ndim >= 2 else t.shape[-1]
        return rng.standard_normal(t.shape) / np.sqrt(fan_in)

    flat = {p: torch.from_numpy(draw(p, t)).to(dtype) for p, t in tree_leaves(model.shapes())}
    return optim.tree_from_paths(model.shapes(), flat)


def numpy_batch(cfg, seed: int, dtype=torch.float32) -> dict:
    rng = np.random.default_rng(seed)
    out = dict(tokens=torch.from_numpy(rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)),
               labels=torch.from_numpy(rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)),
               mask=torch.from_numpy((rng.random((B, S)) < 0.8).astype(np.float32)))
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.standard_normal((B, S_ENC, cfg.d_model))).to(dtype)
    return out


def max_err(a, b) -> float:
    return max(float((x - y).abs().max()) for (_, x), (_, y) in
               zip(tree_leaves(a), tree_leaves(b)))


def step_on(model, params, batch, shape=None):
    """One step from whole ``params`` (on ``shape``, else one device): the
    whole parameters after it, its metrics and the step."""
    ocfg = AdamWConfig(**STEP_CFG)
    if shape is None:
        step = make_train_step(model, ocfg, donate=False)
        new, _, m = step(params, optim.init(ocfg, params), batch)
        return new, m, step
    mesh = mesh_of(shape)
    specs = model.specs(mesh)
    blocks = shard_tree(params, mesh, specs)
    step = make_train_step(model, ocfg, mesh, donate=False)
    step.timing = {}
    new, _, m = step(blocks, optim.init(ocfg, blocks), batch)
    return gather_tree(new, mesh, specs), m, step


def plan_of(cfg, shape, device="cpu"):
    mesh = mesh_of(shape, device)
    specs = get_model(cfg).specs(mesh)
    split, partial = transformer.tp_plan(cfg, specs, mesh)
    return split, partial, transformer.tp_gathered(cfg, specs)


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("shape", MESHES)
def test_plan_of_the_reduced_archs(shape):
    b, m = (lambda k: ("blocks", k)), (lambda k: ("mamba", k))
    everything = {"heads", "mlp", "vocab"}
    assert plan_of(reduced("rwkv6-1.6b"), shape) == (
        everything, {b(k) for k in MIXES}, {b("w_ffn_r")})
    attention = everything | {"kv_heads"}
    zamba = plan_of(reduced("zamba2-2.7b"), shape)
    if shape[1] == 2:                 # 2 Mamba heads split 2 ways
        assert zamba == (attention | {"ssm_heads"}, {m("w_in"), m("conv_w"), m("w_bc")},
                         {m("w_in"), m("conv_w")})
    else:                             # not 4 ways: the Mamba layers run whole
        assert zamba == (attention, set(), {m(k) for k in ("w_in", "conv_w", "gn", "w_out")})
    assert plan_of(reduced("seamless-m4t-medium"), shape) == (attention, set(),
                                                               {("frame_proj",)})


def test_plan_on_the_production_mesh():
    """16×16: reduced, the groups whose heads do not divide 16 run whole,
    their split leaves gathered (rwkv6's ``w_g``; zamba2's Mamba leaves),
    the MLPs and vocab split; at full width every group splits but
    seamless's 256,206 vocab rows."""
    b, m = (lambda k: ("blocks", k)), (lambda k: ("mamba", k))
    assert plan_of(reduced("rwkv6-1.6b"), (16, 16)) == (
        {"mlp", "vocab"}, set(), {b("w_g"), b("w_ffn_r")})
    assert plan_of(reduced("zamba2-2.7b"), (16, 16)) == (
        {"mlp", "vocab"}, set(), {m(k) for k in ("w_in", "conv_w", "gn", "w_out")})
    assert plan_of(reduced("seamless-m4t-medium"), (16, 16)) == (
        {"mlp", "vocab"}, set(), {("frame_proj",)})
    full = {a: get_arch(a).config for a in ARCHS}
    assert plan_of(full["rwkv6-1.6b"], (16, 16), "meta") == (
        {"heads", "mlp", "vocab"}, {b(k) for k in MIXES}, {b("w_ffn_r")})
    assert plan_of(full["zamba2-2.7b"], (16, 16), "meta") == (
        {"ssm_heads", "heads", "kv_heads", "mlp", "vocab"},
        {m("w_in"), m("conv_w"), m("w_bc")}, {m("w_in"), m("conv_w")})
    assert plan_of(full["seamless-m4t-medium"], (16, 16), "meta") == (
        {"heads", "kv_heads", "mlp"}, set(), {("frame_proj",)})


def test_a_leaf_no_group_reads_raises():
    cfg = reduced("rwkv6-1.6b")
    mesh = mesh_of((1, 2))
    specs = get_model(cfg).specs(mesh, {"rank": ("model",)})     # the LoRA rank over model
    with pytest.raises(ValueError, match="cannot serve blocks/decay_lora_a"):
        transformer.tp_plan(cfg, specs, mesh)


# ------------------------------------------------------------------ step
@pytest.mark.parametrize("arch", ARCHS)
def test_split_step_matches_one_device(arch):
    model = get_model(reduced(arch))
    params = numpy_params(model, 1)
    batch = numpy_batch(model.cfg, 2)
    p1, m1, _ = step_on(model, params, batch)
    ev1 = make_eval_step(model)(params, batch)
    for shape in MESHES:
        got, m, step = step_on(model, params, batch, shape)
        assert step.tp is not None and {"heads", "mlp", "vocab"} <= step.tp.split, shape
        assert {"gather_s", "tp_s", "reduce_s"} <= set(step.timing)
        assert max_err(got, p1) <= TOL_F32.get(arch, TOL), (arch, shape)
        assert abs(float(m["loss"]) - float(m1["loss"])) <= TOL * float(m1["loss"]), shape
        mesh = mesh_of(shape)
        ev = make_eval_step(model, mesh)(shard_tree(params, mesh, model.specs(mesh)), batch)
        assert abs(float(ev["loss"]) - float(ev1["loss"])) <= TOL * float(ev1["loss"]), shape


@pytest.mark.parametrize("arch", ARCHS)
def test_split_step_in_float64(arch):
    """The float32 gap is rounding: in float64 the split steps' parameters
    and loss lie within 1e-6 of the one-device step's (the moments stay
    float32)."""
    model = get_model(dataclasses.replace(reduced(arch), dtype=torch.float64))
    params = numpy_params(model, 1, torch.float64)
    batch = numpy_batch(model.cfg, 2, torch.float64)
    p1, m1, _ = step_on(model, params, batch)
    for shape in MESHES:
        got, m, _ = step_on(model, params, batch, shape)
        assert max_err(got, p1) <= TOL, shape
        assert abs(float(m["loss"]) - float(m1["loss"])) <= TOL * float(m1["loss"]), shape


def test_shared_attention_with_replicated_kv_heads():
    """zamba2 with 2 kv heads on (1, 4): the shared block's query heads
    split 4 ways, its ``wk``/``wv`` (no layer dimension) are partial, one
    copy a local shard first; the step within 1e-6."""
    cfg = dataclasses.replace(reduced("zamba2-2.7b"), n_kv_heads=2)
    model = get_model(cfg)
    split, partial, _ = plan_of(cfg, (1, 4))
    kv = {("shared_attn", "attn", k) for k in ("wk", "wv")}
    assert "heads" in split and "kv_heads" not in split and partial == kv
    params = numpy_params(model, 3)
    batch = numpy_batch(cfg, 4)
    p1, _, _ = step_on(model, params, batch)
    got, _, step = step_on(model, params, batch, (1, 4))
    assert {step.copy_dim[p] for p in kv} == {0}
    assert max_err(got, p1) <= TOL


# ------------------------------------------------------------- operators
def test_gated_norm_sum_against_plain_sums():
    """``enter(leave(parts))`` on (1, 4) in one process: each shard gets the
    shard-ordered sum, and each part's gradient is the ordered sum of every
    shard's gradient of it, bit for bit."""
    tp = shard_ctx.TensorParallel(mesh_of((1, 4)), frozenset(shard_ctx.GROUPS))
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(3, 5, 1, generator=g, requires_grad=True) for _ in range(4)]
    total = tp.enter(tp.leave(parts))
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert len(total) == 4 and all(torch.equal(t, want) for t in total)
    cots = [torch.randn(3, 5, 1, generator=g) for _ in range(4)]
    grads = torch.autograd.grad(total, parts, cots)
    summed = ((cots[0] + cots[1]) + cots[2]) + cots[3]
    assert all(torch.equal(gp, summed) for gp in grads)


@pytest.mark.parametrize("shape", ((1, 2), (2, 2)))
def test_reduce_of_a_gathered_partial_leaf(shape):
    """A leaf split along ``model`` but gathered whole, each model shard's
    contribution partial (its columns): ``reduce_blocks`` sums the copies
    over ``model`` in shard order, then the data shards, and keeps the
    process's block — the block of the plain sum."""
    mesh = mesh_of(shape)
    spec = P(None, "data", "model")                   # w_in's: (L, d, 2 d_inner)
    rng = np.random.default_rng(5)
    n_data, n_model = shape
    contribs = torch.from_numpy(rng.standard_normal((n_data, n_model, 2, 4, 8)).astype(
        np.float32))
    got = reduce_blocks(contribs, mesh, spec, ("data",), held=(), partial="model")
    plain = contribs[0, 0]
    for j in range(1, n_model):
        plain = plain + contribs[0, j]
    for i in range(1, n_data):
        row = contribs[i, 0]
        for j in range(1, n_model):
            row = row + contribs[i, j]
        plain = plain + row
    # one process holds every shard: its block is the whole leaf
    assert torch.allclose(got, plain, rtol=0, atol=1e-6)
    per_model = [contribs[:, j].sum(0) for j in range(n_model)]
    assert torch.allclose(got, torch.stack(per_model).sum(0), rtol=0, atol=1e-6)
