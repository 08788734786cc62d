"""Tensor parallelism in the port's mesh step (``models/shard_ctx.py``,
``distributed/collectives.py::ordered_sum``, the decoder's split products,
``train/step.py::_MeshStep``), on the CPU in one process.

* ``enter`` and ``leave`` against plain sums, forward and backward: each
  shard's term added in shard order, bit for bit; without a context both
  are identities.
* The vocab-parallel embedding lookup and chunked cross-entropy under a
  context that splits the vocab four ways against the one-device ones.
* The tensor-parallel mesh step of the five reduced dense decoders on
  ``(1, 2)``, ``(2, 2)`` and ``(1, 4)`` ``("data", "model")`` meshes
  against the one-device step: the loss and the parameters after one step
  within 1e-6 (``tests/test_torch_mesh_train.py``'s bound, under its
  ``AdamWConfig(eps=1e-3)``), and the eval step.  qwen3-32b on ``(1, 4)``
  and starcoder2-15b there keep their kv heads replicated along
  ``model``; minicpm3-4b is MLA.  A config whose shards read kv heads in
  another order than ``expand_kv``'s, and microbatches, run too.
* ``chip_smoke.py`` phase 16's rank program (``launch/sharded.py::
  tp_check_rank``) at a reduced width in two gloo processes.
* The plan: which groups a spec splits, which leaves are partial, and an
  error naming a leaf whose spec the tensor-parallel path cannot serve.

The port's one-device step is held to ``jax.grad`` of the reference in
``tests/test_torch_train.py`` and ``test_torch_grads_dense.py``; the
tensor-parallel step of the five archs on the same inputs as the
reference's jitted step, and the gloo processes' bits, in
``tests/test_torch_mesh_train.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shardings import gather_tree, shard_tree
from repro_torch.models import get_model, shard_ctx, transformer
from repro_torch.models.common import tree_leaves
from repro_torch.train import AdamWConfig, make_eval_step, make_train_step, optim
from torch_mesh_ranks import STEP_CFG, reduced

DENSE = ("qwen1.5-4b", "qwen3-32b", "minicpm3-4b", "starcoder2-15b", "chameleon-34b")
MESHES = ((1, 2), (2, 2), (1, 4))
B, S = 4, 16
TOL = 1e-6                       # tests/test_torch_mesh_train.py's mesh-vs-one-device bound
BF16_REL = 2.0 ** -8             # bf16's unit roundoff: one rounding of the loss or grad norm


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh_of(shape):
    return make_mesh(shape, ("data", "model"), device="cpu")


def context(shape, split=shard_ctx.GROUPS):
    return shard_ctx.TensorParallel(mesh_of(shape), frozenset(split))


def batch_of(cfg, seed: int, rows: int = B) -> dict:
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (rows, S), generator=g, dtype=torch.int32)
    labels = torch.randint(0, cfg.vocab, (rows, S), generator=g, dtype=torch.int32)
    mask = (torch.rand((rows, S), generator=g) < 0.8).float()
    return dict(tokens=tokens, labels=labels, mask=mask)


def max_err(a, b) -> float:
    return max(float((x - y).abs().max()) for (_, x), (_, y) in
               zip(tree_leaves(a), tree_leaves(b)))


# ------------------------------------------------------------ operators
def test_enter_and_leave_against_plain_sums():
    """On (1, 4) in one process: ``enter`` gives four views of ``x`` and its
    backward is ``((g₀ + g₁) + g₂) + g₃`` of the shards' gradients;
    ``leave`` sums the parts in that order and hands each its output's
    gradient."""
    tp = context((1, 4))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, generator=g, requires_grad=True)
    w = [torch.randn(5, 5, generator=g) for _ in range(4)]
    xs = tp.enter(x)
    assert len(xs) == 4 and all(torch.equal(xj, x) for xj in xs)
    ys = [xj @ wj for xj, wj in zip(xs, w)]
    (gx,) = torch.autograd.grad(sum(y.sum() for y in ys), [x])
    per = [torch.ones(3, 5) @ wj.T for wj in w]
    assert torch.equal(gx, ((per[0] + per[1]) + per[2]) + per[3])

    parts = [torch.randn(3, 5, generator=g, requires_grad=True) for _ in range(4)]
    out = tp.leave(parts)
    assert torch.equal(out, ((parts[0] + parts[1]) + parts[2]) + parts[3])
    cot = torch.randn(3, 5, generator=g)
    grads = torch.autograd.grad(out, parts, cot)
    assert all(torch.equal(gp, cot) for gp in grads)


def test_operators_without_a_context_are_identities():
    x = torch.randn(2, 3, requires_grad=True)
    whole = shard_ctx.split("mlp")
    assert whole is shard_ctx.WHOLE
    (xs,) = whole.enter(x)
    assert xs is x and whole.leave([x]) is x
    assert whole.shards(x, -1) == [x] and whole.copies(x) == [x]
    with shard_ctx.tensor_parallel(context((1, 2), {"vocab"})) as tp:
        assert shard_ctx.split("vocab") is tp and shard_ctx.split("mlp") is whole
        assert len(tp.enter(x)) == 2
    assert shard_ctx.split("vocab") is whole


# ---------------------------------------------------------------- vocab
def test_vocab_parallel_embedding_and_cross_entropy():
    """Reduced qwen3-32b, the vocab split four ways in one process: the
    embedding rows bitwise the one-device lookup's (one shard adds each
    row, the others 0), the chunked cross-entropy and its gradients
    (hidden states, ``unembed``, ``embed``) within float32 rounding."""
    cfg = reduced("qwen3-32b")
    params = get_model(cfg).init(torch.Generator().manual_seed(1))
    batch = batch_of(cfg, 2)
    hidden = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(3))

    def run():
        p = {k: params[k].detach().requires_grad_(True) for k in ("embed", "unembed")}
        h = hidden.detach().requires_grad_(True)
        x = transformer.embed_tokens(cfg, p, batch["tokens"])
        ce = transformer.lm_loss(cfg, p, h, batch["labels"], batch["mask"])
        grads = torch.autograd.grad(ce + (x * x).sum(), [h, p["unembed"], p["embed"]])
        return x.detach(), ce.detach(), grads

    x1, ce1, g1 = run()
    with shard_ctx.tensor_parallel(context((1, 4), {"vocab"})):
        x4, ce4, g4 = run()
    assert torch.equal(x4, x1)
    assert abs(float(ce4) - float(ce1)) <= 1e-6 * float(ce1)
    for a, b in zip(g4, g1):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


# ------------------------------------------------------------------ step
def one_step(model, params, batch, shape=None, microbatches=1):
    """One step from whole ``params``: the whole parameters after it, its
    metrics and the step (``shape``: on that mesh, else one device)."""
    ocfg = AdamWConfig(**STEP_CFG)
    if shape is None:
        step = make_train_step(model, ocfg, microbatches=microbatches, donate=False)
        new, _, m = step(params, optim.init(ocfg, params), batch)
        return new, m, step
    mesh = mesh_of(shape)
    specs = model.specs(mesh)
    blocks = shard_tree(params, mesh, specs)
    step = make_train_step(model, ocfg, mesh, microbatches=microbatches, donate=False)
    step.timing = {}
    new, _, m = step(blocks, optim.init(ocfg, blocks), batch)
    return gather_tree(new, mesh, specs), m, step


@pytest.mark.parametrize("arch", DENSE)
def test_tp_step_matches_one_device(arch):
    cfg = reduced(arch)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(4))
    batch = batch_of(cfg, 5)
    p1, m1, _ = one_step(model, params, batch)
    ev1 = make_eval_step(model)(params, batch)
    for shape in MESHES:
        got, m, step = one_step(model, params, batch, shape)
        assert step.tp is not None and {"heads", "mlp", "vocab"} <= step.tp.split, shape
        assert {"gather_s", "tp_s", "reduce_s"} <= set(step.timing)
        assert max_err(got, p1) <= TOL, (arch, shape)
        assert abs(float(m["loss"]) - float(m1["loss"])) <= TOL * float(m1["loss"]), shape
        mesh = mesh_of(shape)
        ev = make_eval_step(model, mesh)(shard_tree(params, mesh, model.specs(mesh)), batch)
        assert abs(float(ev["loss"]) - float(ev1["loss"])) <= TOL * float(ev1["loss"]), shape


def test_kv_heads_read_out_of_expand_order_and_microbatches():
    """6 query heads on 3 kv heads over 2 model shards: the kv heads stay
    replicated, shard 0's heads read kv heads (0, 0, 1) and shard 1's
    (1, 2, 2), which ``expand_kv`` cannot give; and 2 microbatches."""
    cfg = dataclasses.replace(reduced("qwen1.5-4b"), n_heads=6, n_kv_heads=3, head_dim=8)
    model = get_model(cfg)
    split, partial = transformer.tp_plan(cfg, model.specs(mesh_of((1, 2))), mesh_of((1, 2)))
    assert split == {"heads", "mlp", "vocab"}
    assert partial == {("blocks", "attn", k) for k in ("wk", "wv", "bk", "bv")}
    params = model.init(torch.Generator().manual_seed(6))
    batch = batch_of(cfg, 7)
    p1, _, _ = one_step(model, params, batch)
    got, _, _ = one_step(model, params, batch, (1, 2))
    assert max_err(got, p1) <= TOL
    p1, m1, _ = one_step(model, params, batch, microbatches=2)
    got, m, _ = one_step(model, params, batch, (2, 2), microbatches=2)
    assert max_err(got, p1) <= TOL
    assert abs(float(m["loss"]) - float(m1["loss"])) <= TOL * float(m1["loss"])


def test_tp_check_rank_in_two_gloo_processes(tmp_path):
    """``chip_smoke.py`` phase 16's rank program at a reduced width: two gloo
    processes on (1, 2), forked from a fork server as there, each holding
    one model shard, agree on the loss
    and grad norm, count the planned collective bytes, and match the
    one-device step: in float32 the parameters after the first step within
    1e-6 and its loss and grad norm within 1e-6 relative, in bf16 (one
    step) its loss and grad norm within ``BF16_REL`` relative."""
    import json

    import numpy as np

    from repro_torch.launch.hlo_analysis import mesh_step_collectives
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharded import (
        spawn_ranks, start_forkserver, stop_forkserver, tp_check_rank,
    )

    job = dict(arch="qwen3-32b", reduced=True, layers=2, mesh=(1, 2),
               runs=[dict(dtype="float32", steps=2, params=True),
                     dict(dtype="bfloat16", steps=1, params=False)],
               batch=2, seq=S, seed=8, device="cpu", threads=1,
               opt=dict(STEP_CFG, warmup_steps=2, total_steps=8))
    start_forkserver(["repro_torch.launch.sharded", "torch._dynamo"])   # as phase 16 does
    try:
        spawn_ranks(tp_check_rank, 2, (str(tmp_path), job), init_file=tmp_path / "init",
                    timeout=120, start="forkserver")
    finally:
        stop_forkserver()
    logs = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    for (dtype, steps, tol), *runs in zip(
            (("float32", 2, TOL), ("bfloat16", 1, BF16_REL)), *(lg["runs"] for lg in logs)):
        model = get_model(dataclasses.replace(reduced("qwen3-32b"), n_layers=2,
                                              dtype=getattr(torch, dtype)))
        for r, run in enumerate(runs):
            assert run["dtype"] == dtype
            mesh = Mesh((1, 2), ("data", "model"), torch.device("cpu"), (1, 2), (0, r), {})
            plan = mesh_step_collectives(model, mesh, batch=(2, S)).stats().by_type
            assert run["collective_bytes"] == [plan] * steps and plan["all-reduce"] > 0
            assert (run["loss"], run["grad_norm"]) == (runs[0]["loss"], runs[0]["grad_norm"])
            one = runs[0] if dtype == "bfloat16" else run     # bf16: rank 0 alone ran it
            for k in ("loss", "grad_norm"):
                assert abs(run[k][0] - one[f"one_device_{k}"]) <= tol * one[f"one_device_{k}"], (
                    dtype, k)
            assert np.isfinite(run["grad_norm"]).all() and set(run["timing"][0]) == {
                "gather_s", "tp_s", "reduce_s"}
        errs = [run["max_param_err"] for run in runs]
        assert all(e <= TOL for e in errs) if dtype == "float32" else errs == [None, None]


# ------------------------------------------------------------------ plan
def test_plan_of_the_specs():
    """The groups each reduced arch's specs split on (1, 4), its partial
    leaves, and a leaf the tensor-parallel path cannot serve."""
    mesh, two = mesh_of((1, 4)), mesh_of((1, 2))
    qwen3 = reduced("qwen3-32b")                      # 4 heads, 2 kv heads
    split, partial = transformer.tp_plan(qwen3, get_model(qwen3).specs(mesh), mesh)
    assert split == {"heads", "mlp", "vocab"}
    assert partial == {("blocks", "attn", k) for k in ("q_norm", "k_norm", "wk", "wv")}
    mla = reduced("minicpm3-4b")
    split, partial = transformer.tp_plan(mla, get_model(mla).specs(mesh), mesh)
    assert split == {"heads", "mlp", "vocab"}
    assert partial == {("blocks", "attn", k) for k in ("w_dq", "q_norm", "w_dkv", "kv_norm")}
    with pytest.raises(ValueError, match="cannot serve blocks/attn/k_norm"):
        transformer.tp_plan(qwen3, get_model(qwen3).specs(mesh, {"heads": (), "hd": ("model",)}),
                            mesh)
    with pytest.raises(ValueError, match="blocks/attn/wk"):
        transformer.tp_plan(qwen3, get_model(qwen3).specs(two, {"heads": ()}), two)
    moe = reduced("qwen3-moe-235b-a22b")                # split too (tests/test_torch_tp_moe.py)
    assert "expert" in transformer.tp_plan(moe, get_model(moe).specs(two), two)[0]
    assert transformer.tp_plan(qwen3, get_model(qwen3).specs(mesh_of((4, 1))),
                               mesh_of((4, 1))) is None
