"""The port's training substrate (``repro_torch.train``, the LM half of
``repro_torch.data``, ``launch/train.py``, ``bench_lm_steps``) against the
reference, on the CPU, in float32 (and bf16 leaves for the optimizer).

* ``optim.update`` against the reference's on identical numpy parameters
  and gradients: float32 and bf16 leaves, float32 and bf16 moments,
  three steps, within 1e-6; the
  grad clip, the three schedules' ``lr_at`` at steps 0, warm-up, middle
  and end, and ``global_norm``.
* A donated step equals a functional one bit for bit, and returns the
  same tensors.
* ``make_train_step`` with 1 and 2 microbatches against the reference's
  on a dense config (the capacity of an MoE layer depends on the call's
  tokens, so microbatching changes which assignments drop, in the
  reference too), within 1e-6 under the eps rule (Adam's first step is
  ``lr · sign(g)`` where ``|g| ≫ eps``: ``AdamWConfig(eps=1e-3)`` makes the
  update smooth in ``g``); 2 against 1 within the reference's 2e-5.
  ``make_eval_step``.
* ``lm_batch``: a pure function of ``(seed, step)``, different between
  steps; shapes, dtypes, the shift by one, the range, frames, and the
  Zipf-ish mean; ``host_slice`` bitwise the reference's on the same arrays.
* Restarts: 6 steps straight equal 3 steps, ``save``, ``restore`` and 3
  more, bit for bit; checkpoints across the packages both ways (the
  reference trains and saves, the port restores and trains on, against
  the reference's own continuation; the port saves, the reference
  restores with its templates); ``launch/train.main`` with ``--resume``.
* ``bench_lm_steps`` gives the reference's row names; the mesh step
  (item 9's slice 4, ``tests/test_torch_mesh_train.py``) refuses what is
  not a mesh, and ``--mesh`` trains.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import store as ref_ckpt
from repro.data import synthetic as ref_data
from repro.models import common as ref_common
from repro.models.api import get_model as ref_get_model
from repro.train import optim as ref_optim
from repro.train import step as ref_step
from repro_torch import ckpt
from repro_torch.bench import tables
from repro_torch.data import LMDataConfig, host_slice, lm_batch, lm_batches
from repro_torch.launch import train as train_cli
from repro_torch.models import common, get_model, params_from_numpy
from repro_torch.train import AdamWConfig, AdamWState, make_eval_step, make_train_step, optim
from torch_towers import assert_trees_close, lm_batch_np, torch_batch

STEP_CFG = dict(lr=1e-3, eps=1e-3, warmup_steps=0, schedule="constant")   # the eps rule
TINY = dict(family="decoder", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
            vocab=64, remat=False)          # the reference's microbatch test config


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: torch's intra-op pool would only contend with the other
    test processes and the reference's XLA threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in
               zip(common.tree_leaves(a), common.tree_leaves(b)))


# --------------------------------------------------------------- optimizer
def opt_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (5, 7), "blocks": {"a": (3, 4, 6), "b": (11,)}}

    def draw(shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32).astype(dtype)

    params = jax.tree.map(lambda s: draw(s, 1.0), shapes, is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda s: draw(s, 0.3), shapes, is_leaf=lambda s: isinstance(s, tuple))
             for _ in range(3)]
    return params, grads


def port_tree(tree):
    def leaf(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))

    return {k: port_tree(v) if isinstance(v, dict) else leaf(v) for k, v in tree.items()}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_update_matches_reference(param_dtype, state_dtype):
    np_dtype = ml_dtypes.bfloat16 if param_dtype == "bfloat16" else np.float32
    params, grads = opt_inputs(np_dtype)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0)
    rcfg = ref_optim.AdamWConfig(state_dtype=getattr(jnp, state_dtype), **kw)
    cfg = AdamWConfig(state_dtype=getattr(torch, state_dtype), **kw)
    rp, rs = params, ref_optim.init(rcfg, params)
    pp, ps = port_tree(params), optim.init(cfg, port_tree(params))
    for g in grads:
        rp, rs, rstats = ref_optim.update(rcfg, rs, rp, g)
        pp, ps, stats = optim.update(cfg, ps, pp, port_tree(g))
        assert abs(float(stats["grad_norm"]) - float(rstats["grad_norm"])) <= 1e-6
        assert abs(float(stats["lr"]) - float(rstats["lr"])) <= 1e-9
        for got, want, dt in ((pp, rp, param_dtype), (ps.m, rs.m, state_dtype),
                              (ps.v, rs.v, state_dtype)):
            for (path, a), (_, b) in zip(common.tree_leaves(got),
                                         common.tree_leaves(jax.tree.map(np.asarray, want))):
                a, b = a.float().numpy(), np.asarray(b, np.float32)
                assert (np.abs(a - b) <= 1e-6).all(), (path, dt)
    assert int(ps.step) == int(rs.step) == 3 and ps.step.dtype == torch.int32


def test_grad_clip_and_global_norm():
    params, grads = opt_inputs(np.float32, seed=1)
    g = jax.tree.map(lambda a: 100 * a, grads[0])
    want = float(ref_optim.global_norm(g))
    assert abs(float(optim.global_norm(port_tree(g))) - want) <= 1e-6 * want
    cfg = AdamWConfig(grad_clip=1.0, warmup_steps=0, schedule="constant")
    rcfg = ref_optim.AdamWConfig(grad_clip=1.0, warmup_steps=0, schedule="constant")
    pp, _, stats = optim.update(cfg, optim.init(cfg, port_tree(params)), port_tree(params),
                                port_tree(g))
    rp, _, rstats = ref_optim.update(rcfg, ref_optim.init(rcfg, params), params, g)
    assert abs(float(stats["grad_norm"]) - float(rstats["grad_norm"])) <= 1e-6 * want
    assert_trees_close(pp, jax.tree.map(np.asarray, rp), atol=1e-6, rtol=0)


@pytest.mark.parametrize("slice_elements", [optim.SLICE_ELEMENTS, 7])
@pytest.mark.parametrize("scale", [1.0, 1e25])
def test_global_norm_in_slices_and_past_float32_range(monkeypatch, slice_elements, scale):
    """The norm, summed in slices, equals the float64 norm within 1e-6
    relative; at 1e25 the squares pass float32's range, the reference's
    formula reads inf and the port's power-of-two scaling stays finite."""
    monkeypatch.setattr(optim, "SLICE_ELEMENTS", slice_elements)
    _, grads = opt_inputs(np.float32, seed=2)
    g = jax.tree.map(lambda a: (scale * a).astype(np.float32), grads[0])
    want = np.sqrt(sum(np.sum(np.square(a.astype(np.float64))) for a in jax.tree.leaves(g)))
    got = float(optim.global_norm(port_tree(g)))
    assert abs(got - want) <= 1e-6 * want
    assert np.isfinite(float(ref_optim.global_norm(g))) == (scale == 1.0)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedules_match_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    cfg, rcfg = AdamWConfig(**kw), ref_optim.AdamWConfig(**kw)
    for step in (0, 5, 10, 55, 100, 120):
        got = float(optim.lr_at(cfg, torch.tensor(step, dtype=torch.int32)))
        want = float(ref_optim.lr_at(rcfg, jnp.asarray(step, jnp.int32)))
        assert abs(got - want) <= 1e-6 * 3e-4, (schedule, step)
    assert float(optim.lr_at(cfg, torch.tensor(0))) == 0.0
    with pytest.raises(ValueError, match="schedule"):
        optim.lr_at(AdamWConfig(schedule="step"), torch.tensor(50))


# ------------------------------------------------------------- train step
def tiny_model():
    return get_model(common.ModelConfig(dtype=torch.float32, **TINY))


def tiny_batch(seed=1, B=4, S=8):
    return lm_batch_np(tiny_model().cfg, seed, B, S, masked=False)


def test_donated_step_equals_functional_bitwise():
    model = tiny_model()
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=8)
    p0 = model.init(torch.Generator().manual_seed(0))
    copy = lambda tr: common.tree_map(torch.clone, tr)   # noqa: E731
    fp, fo = copy(p0), optim.init(ocfg, p0)
    dp, do = copy(p0), optim.init(ocfg, p0)
    func = make_train_step(model, ocfg, donate=False)
    don = make_train_step(model, ocfg, donate=True)
    for i in range(3):
        b = torch_batch(tiny_batch(seed=10 + i))
        fp, fo, fm = func(fp, fo, b)
        held = [leaf for _, leaf in common.tree_leaves(dp)]
        dp, do, dm = don(dp, do, b)
        assert all(a is c for a, (_, c) in zip(held, common.tree_leaves(dp)))
        assert torch.equal(fm["loss"], dm["loss"])
    assert leaves_equal(fp, dp) and leaves_equal(fo.m, do.m) and leaves_equal(fo.v, do.v)
    assert not leaves_equal(fp, p0)


@pytest.fixture(scope="module")
def ref_steps():
    """The reference's jitted train steps (not donated) on the tiny dense
    config, microbatches 1 and 2, and its params."""
    rcfg = ref_common.ModelConfig(dtype=jnp.float32, **TINY)
    model = ref_get_model(rcfg)
    ocfg = ref_optim.AdamWConfig(**STEP_CFG)
    steps = {mb: ref_step.make_train_step(model, ocfg, microbatches=mb, donate=False)
             for mb in (1, 2)}
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0)))
    return dict(model=model, ocfg=ocfg, steps=steps, params=params)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(ref_steps, microbatches):
    b = tiny_batch()
    rp, ro, rm = ref_steps["steps"][microbatches](
        ref_steps["params"], ref_optim.init(ref_steps["ocfg"], ref_steps["params"]), b)
    model = tiny_model()
    ocfg = AdamWConfig(**STEP_CFG)
    params = params_from_numpy(model.cfg, ref_steps["params"], device="cpu")
    pp, po, pm = make_train_step(model, ocfg, microbatches=microbatches, donate=False)(
        params, optim.init(ocfg, params), torch_batch(b))
    assert abs(float(pm["loss"]) - float(rm["loss"])) <= 1e-5 * float(rm["loss"])
    assert set(pm) == set(rm)
    assert_trees_close(pp, jax.tree.map(np.asarray, rp), atol=1e-6, rtol=0)


def test_microbatches_agree():
    """The reference's test_microbatch_equivalence on the port: 2
    microbatches against 1 within 2e-5."""
    model = tiny_model()
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")
    params = model.init(torch.Generator().manual_seed(0))
    b = torch_batch(tiny_batch())
    p1, _, m1 = make_train_step(model, ocfg, microbatches=1, donate=False)(
        params, optim.init(ocfg, params), b)
    p2, _, m2 = make_train_step(model, ocfg, microbatches=2, donate=False)(
        params, optim.init(ocfg, params), b)
    assert set(m2) == {"loss", "grad_norm", "lr"} and {"ce", "aux"} <= set(m1)
    for (_, a), (_, c) in zip(common.tree_leaves(p1), common.tree_leaves(p2)):
        assert float((a - c).abs().max()) <= 2e-5


def test_eval_step_matches_loss(ref_steps):
    model = tiny_model()
    params = params_from_numpy(model.cfg, ref_steps["params"], device="cpu")
    b = tiny_batch()
    out = make_eval_step(model)(params, torch_batch(b))
    want, _ = ref_steps["model"].loss(ref_steps["params"], b)
    assert set(out) == {"loss", "ce", "aux"} and not out["loss"].requires_grad
    assert abs(float(out["loss"]) - float(want)) <= 1e-5 * float(want)


# ------------------------------------------------------------------- data
def test_lm_batch_deterministic_and_shaped():
    cfg = LMDataConfig(vocab=100, batch=4, seq=16, seed=7)
    a, b, c = lm_batch(cfg, 5, device="cpu"), lm_batch(cfg, 5, device="cpu"), \
        lm_batch(cfg, 6, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], lm_batch(LMDataConfig(100, 4, 16, seed=8), 5,
                                                 device="cpu")["tokens"])
    assert a["tokens"].shape == a["labels"].shape == a["mask"].shape == (4, 16)
    assert a["tokens"].dtype == a["labels"].dtype == torch.int32
    assert a["mask"].dtype == torch.float32 and bool((a["mask"] == 1).all())
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert int(a["tokens"].min()) >= 0 and int(a["labels"].max()) < 100
    f = lm_batch(cfg, 5, frames_dim=8, frames_len=6, device="cpu")
    assert f["frames"].shape == (4, 6, 8) and f["frames"].dtype == torch.float32
    assert torch.equal(f["tokens"], a["tokens"])
    big = lm_batch(LMDataConfig(vocab=1000, batch=64, seq=256), 0, device="cpu")
    assert float(big["tokens"].double().mean()) < (1000 - 1) / 3 * 1.05
    stream = lm_batches(cfg, 5, device="cpu")
    assert torch.equal(next(stream)["tokens"], a["tokens"])
    assert torch.equal(next(stream)["tokens"], c["tokens"])


def test_host_slice_matches_reference():
    b = tiny_batch(B=8)
    for i in range(4):
        want = ref_data.host_slice(b, i, 4)
        got = host_slice(torch_batch(b), i, 4)
        assert set(got) == set(want)
        assert all(np.array_equal(got[k].numpy(), np.asarray(want[k])) for k in got)


# ---------------------------------------------------------------- restarts
def test_restart_is_bitwise(tmp_path):
    """6 steps straight == 3 steps, save, restore, 3 more (reduced qwen3-moe,
    the optimizer state in the checkpoint)."""
    from repro_torch.configs import registry

    cfg = registry.get_arch("qwen3-moe-235b-a22b").reduced
    model = get_model(cfg)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    dcfg = LMDataConfig(vocab=cfg.vocab, batch=2, seq=16)
    step = make_train_step(model, ocfg)

    def run(params, opt, steps):
        for s in steps:
            params, opt, _ = step(params, opt, lm_batch(dcfg, s, device="cpu"))
        return params, opt

    p0 = model.init(torch.Generator().manual_seed(0))
    straight = run(p0, optim.init(ocfg, p0), range(6))
    p0 = model.init(torch.Generator().manual_seed(0))
    half = run(p0, optim.init(ocfg, p0), range(3))
    ckpt.save(tmp_path, 3, *half, data_cursor=3)
    rp, ro, meta = ckpt.restore(tmp_path, params_template=model.shapes(),
                                opt_template=optim.init(ocfg, model.shapes()), device="cpu")
    assert isinstance(ro, AdamWState) and meta["data_cursor"] == 3 and int(ro.step) == 3
    resumed = run(rp, ro, range(meta["data_cursor"], 6))
    assert leaves_equal(straight[0], resumed[0])
    assert leaves_equal(straight[1].m, resumed[1].m) and leaves_equal(straight[1].v, resumed[1].v)


def test_checkpoints_cross_the_packages(ref_steps, tmp_path):
    """The reference trains 3 steps and saves with its optimizer state; the
    port restores and trains 3 more, against the reference's own 3 more.
    Then the port saves, and the reference restores with its templates."""
    model, ocfg = tiny_model(), AdamWConfig(**STEP_CFG)
    rstep, rocfg = ref_steps["steps"][1], ref_steps["ocfg"]
    batches = [tiny_batch(seed=20 + i) for i in range(6)]
    rp, ro = ref_steps["params"], ref_optim.init(rocfg, ref_steps["params"])
    for b in batches[:3]:
        rp, ro, _ = rstep(rp, ro, b)
    ref_ckpt.save(tmp_path / "ref", 3, rp, ro, data_cursor=3)
    pp, po, meta = ckpt.restore(tmp_path / "ref", params_template=model.shapes(),
                                opt_template=optim.init(ocfg, model.shapes()), device="cpu")
    assert meta["data_cursor"] == 3 and int(po.step) == 3
    step = make_train_step(model, ocfg)
    for b in batches[3:]:
        rp, ro, _ = rstep(rp, ro, b)
        pp, po, _ = step(pp, po, torch_batch(b))
    assert_trees_close(pp, jax.tree.map(np.asarray, rp), atol=1e-6, rtol=0, what="6 steps")

    ckpt.save(tmp_path / "port", 6, pp, po, data_cursor=6)
    tmpl_o = jax.eval_shape(lambda p: ref_optim.init(rocfg, p), ref_steps["model"].shapes())
    back_p, back_o, rmeta = ref_ckpt.restore(tmp_path / "port",
                                             params_template=ref_steps["model"].shapes(),
                                             opt_template=tmpl_o)
    assert rmeta["data_cursor"] == 6 and int(back_o.step) == 6
    for got, want in ((back_p, pp), (back_o.m, po.m), (back_o.v, po.v)):
        for (_, a), (_, b) in zip(common.tree_leaves(jax.tree.map(np.asarray, got)),
                                  common.tree_leaves(want)):
            assert np.array_equal(a, b.numpy())


def test_train_cli_resumes_bitwise(tmp_path, capsys):
    """A ``--steps 4 --ckpt-every 2`` run whose final checkpoint is taken
    away (a run preempted after step 2 of 4), then ``--steps 4 --resume``,
    writes the final checkpoint the straight run wrote, array for array."""
    base = ["--arch", "zamba2-2.7b", "--reduced", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--steps", "4", "--ckpt-every", "2", "--log-every", "1",
            "--ckpt-dir", str(tmp_path / "a")]
    assert train_cli.main(base) == 0
    a, b = tmp_path / "a" / "step_000000004", tmp_path / "b" / "step_000000004"
    b.parent.mkdir()
    shutil.move(a, b)                      # the straight run's final checkpoint
    assert train_cli.main(base + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and "final checkpoint" in out
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    assert ma["keys"] == mb["keys"] and ma["data_cursor"] == mb["data_cursor"] == 4
    for info in ma["keys"].values():
        assert (a / "arrays" / info["file"]).read_bytes() == \
            (b / "arrays" / info["file"]).read_bytes(), info["file"]
    assert "opt/step" in ma["keys"] and any(k.startswith("opt/m/") for k in ma["keys"])


def test_bench_lm_steps_rows_match_reference(monkeypatch):
    import repro.models.api as ref_api
    from benchmarks import common as ref_bench_common
    from benchmarks import tables as ref_tables

    # the reference's row names, without building or timing its models
    class Unbuilt:
        def init(self, key):
            return {}

    monkeypatch.setattr(ref_api, "get_model", lambda cfg: Unbuilt())
    monkeypatch.setattr(ref_bench_common, "timed", lambda fn, **kw: (1.0, None))
    want = [r["name"] for r in ref_tables.bench_lm_steps()]
    rows = tables.bench_lm_steps(device="cpu")
    assert [r["name"] for r in rows] == want
    assert all(r["metrics"]["tokens_per_s"] > 0 for r in rows)


def test_mesh_raises_naming_slice_4():
    """The mesh step came with item 9's slice 4: it refuses an object that
    is not a ``launch.mesh.Mesh``, and the CLI's ``--mesh`` trains."""
    with pytest.raises(TypeError, match="Mesh"):
        make_train_step(tiny_model(), AdamWConfig(), mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        make_eval_step(tiny_model(), mesh=object())
    assert train_cli.main(["--arch", "qwen3-32b", "--reduced", "--mesh", "2x2", "--steps", "1",
                           "--batch", "4", "--seq", "8", "--device", "cpu"]) == 0
