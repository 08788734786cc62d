"""Tensor parallelism for the MoE archs in the port's mesh step
(``models/moe.py``'s split global dispatch, ``transformer.tp_plan``,
``train/step.py::_MeshStep``), on the CPU.

* The plan of qwen3-moe and llama4-maverick on ``(1, 2)``, ``(2, 2)``,
  ``(1, 4)`` and the 16×16 production mesh: ``expert`` among the split
  groups, the router gathered whole; where ``E`` does not divide
  ``model`` each expert's columns split instead (the step held to the
  one-device step there), and where neither divides a ``ValueError``
  naming ``blocks/moe/experts/w_gate`` (the step then raises too: it
  never gathers the whole experts).
* The split step of both reduced archs on ``(1, 2)``, ``(2, 2)`` and
  ``(1, 4)`` against the one-device step, in one process: the parameters
  after one step (``AdamWConfig(eps=1e-3)``), the dropped assignments
  equal to the one-device dispatch's, the aux within 1e-6 relative, the
  eval step's loss.  The parameters within 1e-6 for qwen3-moe; llama4's
  interleaved dense blocks amplify rounding (its one-device step lies
  2.1e-6 to 5.8e-6 from the reference's, ``tests/test_torch_mesh_train.py``),
  so its float32 steps are held within 1e-5, and its float64 steps within
  1e-6, which leaves only the float32 moments' rounding.
* The remat recompute finds its forward's counts under the split: one
  count exchange a layer and a data shard.
* A (6, 2) mesh over 4 processes (a process would hold 3 data shards while
  ``model`` spans processes) raises, on a mesh built by hand with
  ``_process_grid``'s layout.
* Two gloo processes on (4, 2), each holding two data shards and the whole
  ``model`` axis: bitwise the one-process step, and no
  ``torch.distributed`` call made from the data shards' threads.

The split step is held to the reference's jitted step in
``tests/test_torch_mesh_train.py`` (both archs on (1, 4) too), and across
gloo processes there, the plan's collective bytes included.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import Mesh, _process_grid, make_mesh
from repro_torch.launch.sharded import host_bits, run_mesh_train, spawn_ranks
from repro_torch.launch.shardings import gather_tree, shard_tree
from repro_torch.models import get_model, moe, transformer
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train import AdamWConfig, make_eval_step, make_train_step, optim
from torch_mesh_ranks import STEP_CFG, reduced, threads_rank, tree_of

ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
MESHES = ((1, 2), (2, 2), (1, 4))
B, S = 4, 16
TOL = 1e-6                        # tests/test_torch_mesh_train.py's mesh-vs-one-device bound
TOL_F32 = {"llama4-maverick-400b-a17b": 1e-5}      # see the module docstring
ROUTER = ("blocks", "moe", "router")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh_of(shape, device="cpu"):
    return make_mesh(shape, ("data", "model"), device=device)


def numpy_params(model, seed: int) -> dict:
    """Every leaf drawn with numpy: the norms' gammas 1 + N(0, 0.1²), the
    others N(0, 1) over the square root of their fan-in, as the init."""
    rng = np.random.default_rng(seed)

    def draw(path, t):
        if t.ndim == 1 or path[-1].startswith("ln") or path[-1].endswith("norm"):
            return 1.0 + 0.1 * rng.standard_normal(t.shape)
        fan_in = t.shape[-2] if t.ndim >= 2 else t.shape[-1]
        return rng.standard_normal(t.shape) / np.sqrt(fan_in)

    flat = {p: torch.from_numpy(draw(p, t).astype(np.float32)).to(t.dtype)
            for p, t in tree_leaves(model.shapes())}
    return optim.tree_from_paths(model.shapes(), flat)


def numpy_batch(cfg, seed: int, rows: int = B) -> dict:
    rng = np.random.default_rng(seed)
    return dict(tokens=torch.from_numpy(rng.integers(0, cfg.vocab, (rows, S), dtype=np.int32)),
                labels=torch.from_numpy(rng.integers(0, cfg.vocab, (rows, S), dtype=np.int32)),
                mask=torch.from_numpy((rng.random((rows, S)) < 0.8).astype(np.float32)))


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
    new, _, m = step(blocks, optim.init(ocfg, blocks), batch)
    return gather_tree(new, mesh, specs), m, step


def one_device_drops(model, params, batch) -> int:
    """The one-device dispatch's dropped assignments over a forward."""
    calls, original = [], moe._router

    def router(cfg, xt, w):
        out = original(cfg, xt, w)
        calls.append(out[0])
        return out

    moe._router = router
    try:
        with torch.no_grad():
            model.loss(params, batch)
    finally:
        moe._router = original
    return sum(moe.dropped_assignments(model.cfg, c) for c in calls)


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_of_the_moe_archs(arch):
    """Reduced: 4 heads on 2 kv heads, 8 experts; full width on 16×16:
    qwen3-moe's 64 heads split (its 4 kv heads do not), llama4's 40 heads
    do not (attention runs whole on every shard), 128 experts both."""
    from repro_torch.configs import get_arch

    cfg = reduced(arch)
    for shape in MESHES:
        mesh = mesh_of(shape)
        split, partial = transformer.tp_plan(cfg, get_model(cfg).specs(mesh), mesh)
        kv = shape[1] == 2                  # 2 kv heads split over 2 shards, not over 4
        mlp = cfg.n_shared_experts or cfg.moe_every > 1    # llama4's shared expert, dense MLPs
        assert split == ({"heads", "vocab", "expert"} | ({"mlp"} if mlp else set())
                         | ({"kv_heads"} if kv else set())), shape
        norms = ("q_norm", "k_norm") if cfg.qk_norm else ()
        stacks = ("blocks", "dense_blocks") if cfg.moe_every > 1 else ("blocks",)
        assert partial == {(st, "attn", k) for st in stacks
                           for k in norms + (() if kv else ("wk", "wv"))}, shape
    assert transformer.tp_gathered(cfg) == {ROUTER}
    full = get_arch(arch).config
    mesh = mesh_of((16, 16), "meta")
    split, partial = transformer.tp_plan(full, get_model(full).specs(mesh), mesh)
    if arch.startswith("qwen3"):
        assert split == {"heads", "vocab", "expert"}
        assert partial == {("blocks", "attn", k) for k in ("q_norm", "k_norm", "wk", "wv")}
    else:
        assert split == {"mlp", "vocab", "expert"} and partial == frozenset()
    spec = dict(tree_leaves(get_model(full).specs(mesh)))
    assert spec[ROUTER] == (None, "data", "model")
    assert spec[("blocks", "moe", "experts", "w_gate")][1] == "model"


def test_experts_split_along_neither_raise():
    """6 experts of 66 columns over 4 model shards divide neither way: the
    experts' spec leaves them whole along model, and the plan and the step
    raise naming the leaf (they never gather the whole experts)."""
    cfg = dataclasses.replace(reduced("qwen3-moe-235b-a22b"), n_experts=6, moe_d_ff=66)
    model = get_model(cfg)
    mesh = mesh_of((1, 4))
    assert "model" not in model.specs(mesh)["blocks"]["moe"]["experts"]["w_gate"]
    with pytest.raises(ValueError, match="blocks/moe/experts/w_gate"):
        transformer.tp_plan(cfg, model.specs(mesh), mesh)
    with pytest.raises(ValueError, match="blocks/moe/experts/w_gate"):
        make_train_step(model, AdamWConfig(**STEP_CFG), mesh)


def test_experts_that_do_not_divide_model_split_their_columns():
    """6 experts over 4 model shards: the spec splits each expert's 64
    columns instead (how XLA's partitioner serves it, and the reduced MoE
    configs' 8 experts on the 16×16 mesh), and each shard computes every
    expert's slots on its columns: within 1e-6 of the one-device step, on
    (1, 4) and (2, 4), drops equal."""
    cfg = dataclasses.replace(reduced("qwen3-moe-235b-a22b"), n_experts=6)
    model = get_model(cfg)
    mesh = mesh_of((1, 4))
    spec = model.specs(mesh)["blocks"]["moe"]["experts"]["w_gate"]
    assert spec[1] is None and spec[3] == "model"
    split, _ = transformer.tp_plan(cfg, model.specs(mesh), mesh)
    assert "expert_mlp" in split and "expert" not in split
    params = numpy_params(model, 11)
    batch = numpy_batch(cfg, 12, rows=8)
    p1, m1, _ = step_on(model, params, batch)
    drops = one_device_drops(model, params, batch)
    for shape in ((1, 4), (2, 4)):
        got, m, _ = step_on(model, params, batch, shape)
        assert max_err(got, p1) <= TOL, shape
        assert int(m["dropped"]) == drops, shape
    # one card of (2, 4) as the dry-run counts it: its collectives are the plan's
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.distributed import collectives
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import StepTally

    step, _, plan = dryrun.build_cell(cfg.name, ShapeSpec("train_4k", S, 8, "train"),
                                      mesh_of((2, 4), "meta"), cfg=cfg)
    collectives.reset_counts()
    with StepTally():
        step()
    moe.forget_calls()
    assert collectives.counts() == plan.stats().by_type


# ------------------------------------------------------------------ step
@pytest.mark.parametrize("arch", ARCHS)
def test_split_step_matches_one_device(arch):
    model = get_model(reduced(arch))
    params = numpy_params(model, 1)
    batch = numpy_batch(model.cfg, 2)
    p1, m1, _ = step_on(model, params, batch)
    drops = one_device_drops(model, params, batch)
    assert drops > 0, "the test batch should make the router drop assignments"
    ev1 = make_eval_step(model)(params, batch)
    for shape in MESHES:
        got, m, step = step_on(model, params, batch, shape)
        assert step.tp is not None and "expert" in step.tp.split and step.whole == {ROUTER}
        assert max_err(got, p1) <= TOL_F32.get(arch, TOL), (arch, shape)
        assert int(m["dropped"]) == drops, shape
        assert abs(float(m["aux"]) - float(m1["aux"])) <= TOL * float(m1["aux"]), shape
        assert abs(float(m["loss"]) - float(m1["loss"])) <= TOL * float(m1["loss"]), shape
        mesh = mesh_of(shape)
        ev = make_eval_step(model, mesh)(shard_tree(params, mesh, model.specs(mesh)), batch)
        assert abs(float(ev["loss"]) - float(ev1["loss"])) <= TOL * float(ev1["loss"]), shape


def test_llama4_split_step_in_float64():
    """llama4's float32 gap is rounding: in float64 its split steps lie
    within 1e-6 of the one-device step (the moments stay float32)."""
    model = get_model(dataclasses.replace(reduced("llama4-maverick-400b-a17b"),
                                          dtype=torch.float64))
    params = tree_map(lambda t: t.double(), numpy_params(model, 3))
    batch = numpy_batch(model.cfg, 4)
    p1, _, _ = step_on(model, params, batch)
    for shape in MESHES:
        assert max_err(step_on(model, params, batch, shape)[0], p1) <= TOL, shape


def test_remat_recompute_reuses_the_forward_counts_under_the_split(monkeypatch):
    """On (2, 2) the checkpointed MoE block runs again in the backward with
    the experts split: it finds its forward's counts by its router leaf
    (the one gathered tensor of the step) and exchanges nothing more."""
    from repro_torch.train import step as step_mod

    calls = []
    original = step_mod._Exchange.__call__

    def counting(self, q, counts):
        calls.append(q)
        return original(self, q, counts)

    monkeypatch.setattr(step_mod._Exchange, "__call__", counting)
    model = get_model(reduced("qwen3-moe-235b-a22b"))
    assert model.cfg.remat
    params = numpy_params(model, 5)
    _, _, step = step_on(model, params, numpy_batch(model.cfg, 6), (2, 2))
    assert step.tp is not None
    assert sorted(calls) == [0] * model.cfg.n_layers + [1] * model.cfg.n_layers
    assert not moe._SEEN


def test_several_data_shards_while_model_spans_processes_raise():
    """(6, 2) on 4 processes: data takes 2 of them (3 shards each), model
    the other 2; a process's data shards run in threads, which must issue
    no model-axis collective across processes."""
    procs = _process_grid((6, 2), 4)
    assert procs == (2, 2)
    mesh = Mesh((6, 2), ("data", "model"), torch.device("cpu"), procs, (0, 1), {})
    model = get_model(reduced("qwen3-moe-235b-a22b"))
    with pytest.raises(ValueError, match="3 data shards while model spans processes"):
        make_train_step(model, AdamWConfig(**STEP_CFG), mesh)
    # the layouts the repo runs keep one data shard a process there
    for shape, world in (((2, 2), 4), ((1, 2), 2), ((4, 2), 2), ((2, 4), 8)):
        p = _process_grid(shape, world)
        assert p[1] == 1 or shape[0] // p[0] == 1, (shape, world)


def test_threads_make_no_distributed_call(tmp_path):
    """(4, 2) on two gloo processes: each holds two data shards, run in
    threads, and both model shards, whose sums stay in the process; the
    count exchange's all-gather is made by the calling thread."""
    cfg = reduced("qwen3-moe-235b-a22b")
    model = get_model(cfg)
    name, shape = "moe@4x2", (4, 2)
    full = numpy_params(model, 7)
    batches = [numpy_batch(cfg, 8)]
    arrays = {f"{name}/p/" + "/".join(p): t.numpy() for p, t in tree_leaves(full)}
    for i, b in enumerate(batches):
        arrays.update({f"{name}/b{i}/{k}": v.numpy() for k, v in b.items()})
    np.savez(tmp_path / "inputs.npz", **arrays)
    job = dict(name=name, kind="train", arch=cfg.name, reduced=True, dtype="float32",
               mesh=shape, opt=STEP_CFG, steps=1)
    spawn_ranks(threads_rank, 2, (str(tmp_path / "inputs.npz"), str(tmp_path),
                                  dict(device="cpu", threads=1, save="arrays", jobs=[job])),
                init_file=tmp_path / "init", timeout=120)
    mesh = mesh_of(shape)
    blocks, opt, _ = run_mesh_train(model, mesh, tree_of(model, {
        k[len(name) + 3:]: v for k, v in arrays.items() if k.startswith(f"{name}/p/")}),
        batches, STEP_CFG)
    got = np.load(tmp_path / "rank0.npz")
    for kind, tree in (("p", blocks), ("m", opt.m), ("v", opt.v)):
        for path, t in tree_leaves(gather_tree(tree, mesh, model.specs(mesh))):
            assert np.array_equal(got[f"{name}/{kind}/" + "/".join(path)], host_bits(t)), path
    for r in range(2):
        calls = json.loads((tmp_path / f"threads{r}.json").read_text())
        assert calls["data_shards"] == 2 and calls["threads"] == [], r
        assert calls["main"] > 0, r               # the step's collectives, on the main thread
