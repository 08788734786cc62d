"""The mesh half of training on the CPU: ``make_train_step``/``make_eval_step``
with ``mesh=``, checkpoints with shardings, ``ft.elastic.resume`` and
``launch/train --mesh``, against the port's one-device step and the
reference's.

* The mesh step in one process on ``(2, 2)``, ``(4, 1)`` and ``(1, 2)``
  ``("data", "model")`` meshes against the port's one-device step within
  1e-6 on the parameters (``AdamWConfig(eps=1e-3)``, the eps rule of
  ``tests/test_torch_train.py``; a data shard sums its own rows, so the
  sums run in another order), and against the reference's jitted
  one-device step within the rule ``tests/test_torch_train.py`` holds a
  whole step to (1e-6 of each leaf's scale; 1e-5 for the recurrent
  towers, whose gradients ``tests/test_torch_grads_recurrent.py`` holds
  10× wider than the dense ones: the port's one-device step itself lies
  1.4e-6 from the reference's on zamba2), on masked batches, for
  reduced qwen1.5-4b, qwen3-32b, minicpm3-4b, starcoder2-15b and
  chameleon-34b, qwen3-moe (whose router drops assignments here),
  llama4-maverick, rwkv6, zamba2 and seamless-m4t-medium (all
  tensor-parallel along ``model``, the MoE archs' experts split too; also
  on ``(1, 4)``, where qwen3-32b's, starcoder2-15b's and the MoE archs'
  kv heads stay replicated and zamba2's 2 Mamba heads run whole) (llama4
  within 1e-5 both ways: ``ARCH_TOL``; zamba2's split meshes within 1e-5
  of the one-device step: ``SPLIT_TOL``; the encdec family within 1e-5 of
  the reference, whose one-device step the port's lies 1.1e-6 to 2.1e-6
  from on seamless-m4t);
  the MoE's dropped assignments equal the one-device
  dispatch's (global capacity, ranks across shards) and its aux within
  1e-6 relative of the reference's.
* Microbatches 2 on a mesh against the one-device step with 2; the eval
  step.
* 2 and 4 gloo processes (spawned, a file store, a time limit) train
  bitwise what one process holding every shard trains, the decoders,
  zamba2 and seamless-m4t tensor-parallel on (2, 2) and (1, 2) among them
  (qwen3-moe's and llama4-maverick's experts split along ``model``); a
  save from a
  2-process mesh writes a one-device save's array files byte for byte,
  and ``elastic.resume`` re-shards it onto another mesh in both processes.
  The collective bytes each rank's steps counted
  (``distributed.collectives.COUNTS``) equal the dry-run's plan of the
  step (``launch/hlo_analysis.py::mesh_step_collectives``) for that rank,
  the model-axis sums of the tensor-parallel step included.
* ``restore(param_shardings=...)`` and ``elastic.resume`` onto another
  mesh in one process; ``launch.train --mesh 2x1 --resume`` bitwise a
  straight run, and resumed onto ``1x2`` within 1e-5.
"""
import concurrent.futures
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models.api import get_model as ref_get_model
from repro.train import optim as ref_optim
from repro.train import step as ref_step
from repro_torch import ckpt
from repro_torch.configs import get_arch
from repro_torch.ft import elastic
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharded import (
    host_bits, run_mesh_train, spawn_ranks, train_rank_program,
)
from repro_torch.launch.shardings import block_shape, gather_tree, shard_tree
from repro_torch.models import get_model, moe, params_from_numpy
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train import AdamWConfig, make_eval_step, make_train_step, optim
from torch_mesh_ranks import SAVE_ARCH, STEP_CFG, mesh_rank, reduced, tree_of
from torch_towers import (
    TRAIN_DECAY, assert_trees_close, lm_batch_np, redraw_constant_leaves, torch_batch,
)

# by family, 1e-6 otherwise: the port's one-device step itself lies 1.4e-6 from the
# reference's on zamba2, and 1.1e-6 to 2.1e-6 on seamless-m4t (seeds 7, 9, 11)
REF_STEP_TOL = {"rwkv6": 1e-5, "zamba2": 1e-5, "encdec": 1e-5}
# reduced llama4-maverick's interleaved dense blocks' near one-hot attention amplifies
# rounding (tests/test_torch_grads_moe.py): the port's one-device step itself lies
# 2.1e-6 to 5.8e-6 from the reference's (parameters at seeds 11, 7, 9), and a model split
# adds up to 3.8e-6 against it; so its steps are held to 1e-5, both ways
ARCH_TOL = {"llama4-maverick-400b-a17b": 1e-5}      # 1e-6 otherwise
# reduced zamba2's split of its Mamba2 heads rounds its products and the gated norm's
# sum otherwise than the one-device step, and its shared attention amplifies that: the
# parameters after a step lie 1.06e-6 from the one-device step's here, in embed, where
# Adam's first step passes a gradient's rounding through (python -m
# repro_torch.bench.split_rounding --device cpu --seeds 1 2 3 4 5: up to 9.9e-7, the
# unsplit data-parallel step at most 6e-8, a one-device step from weights moved by 2^-24
# up to 1.5e-6); in float64 the split step lies within
# 1e-6 (tests/test_torch_tp_recurrent.py), so a split mesh holds it to 1e-5 against the
# one-device step, the reference's bound for the family
SPLIT_TOL = {"zamba2-2.7b": 1e-5}
ARCHS = ("qwen1.5-4b", "qwen3-32b", "minicpm3-4b", "starcoder2-15b", "chameleon-34b",
         "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "rwkv6-1.6b", "zamba2-2.7b",
         "seamless-m4t-medium")
MESHES = ((2, 2), (4, 1), (1, 2))
# the tensor-parallel archs also on (1, 4), where reduced qwen3-32b's 2 kv heads and
# starcoder2-15b's stay replicated along model (their wk/wv gradients partial), and
# reduced zamba2's 2 Mamba heads do not split (its Mamba layers run whole)
TP_ARCHS = ("qwen1.5-4b", "qwen3-32b", "minicpm3-4b", "starcoder2-15b", "chameleon-34b",
            "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "rwkv6-1.6b", "zamba2-2.7b",
            "seamless-m4t-medium")
TP_MESHES = MESHES + ((1, 4),)
B, S = 4, 16
ENC_LEN = 6                        # the frames lm_batch_np draws for encdec
TIMEOUT = 150.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def numpy_params(cfg, seed: int) -> dict:
    """The port's init of ``cfg`` as numpy, the constant leaves redrawn
    (RWKV6's decay as the gradient tests draw it)."""
    p = get_model(cfg).init(torch.Generator().manual_seed(seed))
    return redraw_constant_leaves(tree_map(lambda t: t.numpy(), p), seed + 1, draws=TRAIN_DECAY)


def mesh_of(shape):
    return make_mesh(shape, ("data", "model"), device="cpu")


def mesh_step(model, shape, params, batch, microbatches=1):
    """One mesh step in one process from whole ``params``: the whole
    parameters after it, and its metrics."""
    mesh = mesh_of(shape)
    specs = model.specs(mesh)
    blocks = shard_tree(params, mesh, specs)
    for (path, blk), (_, full) in zip(tree_leaves(blocks), tree_leaves(params)):
        assert tuple(blk.shape) == block_shape(full.shape, mesh, dict(tree_leaves(specs))[path])
    ocfg = AdamWConfig(**STEP_CFG)
    new, _, metrics = make_train_step(model, ocfg, mesh, microbatches=microbatches,
                                      donate=False)(blocks, optim.init(ocfg, blocks), batch)
    return gather_tree(new, mesh, specs), metrics


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


def max_err(a, b) -> float:
    return max(float((x - y).abs().max()) for (_, x), (_, y) in
               zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_one_device_and_reference(arch):
    cfg = reduced(arch)
    model = get_model(cfg)
    host = numpy_params(cfg, 7)
    batch_np = lm_batch_np(cfg, 8, B, S, masked=True)
    batch = torch_batch(batch_np)
    params = params_from_numpy(cfg, host, device="cpu")
    ocfg = AdamWConfig(**STEP_CFG)
    p1, _, m1 = make_train_step(model, ocfg, donate=False)(params, optim.init(ocfg, params),
                                                          batch)
    # the reference without remat (it changes no number; its compile is shorter)
    rcfg = dataclasses.replace(ref_registry.get_arch(arch).reduced, dtype=jnp.float32,
                               remat=False)
    rocfg = ref_optim.AdamWConfig(**STEP_CFG)
    rp, _, rm = ref_step.make_train_step(ref_get_model(rcfg), rocfg, donate=False)(
        host, ref_optim.init(rocfg, host), batch_np)
    ref_params = jax.tree.map(np.asarray, rp)
    drops = one_device_drops(model, params, batch) if cfg.moe else None
    if cfg.moe:
        assert drops > 0, "the test batch should make the router drop assignments"
    for shape in TP_MESHES if arch in TP_ARCHS else MESHES:
        got, m = mesh_step(model, shape, params, batch)
        tol = SPLIT_TOL.get(arch, 1e-6) if shape[1] > 1 else 1e-6
        assert max_err(got, p1) <= ARCH_TOL.get(arch, tol), (arch, shape)
        assert_trees_close(got, ref_params, rtol=0, what=f"{arch} {shape}",
                           atol=ARCH_TOL.get(arch, REF_STEP_TOL.get(cfg.family, 1e-6)))
        assert abs(float(m["loss"]) - float(rm["loss"])) <= 1e-5 * float(rm["loss"])
        assert abs(float(m["ce"]) - float(m1["ce"])) <= 1e-6 * float(m1["ce"])
        assert {"loss", "ce", "aux", "grad_norm", "lr"} <= set(m)
        if cfg.moe:
            assert int(m["dropped"]) == drops, (shape, float(m["dropped"]), drops)
            assert abs(float(m["aux"]) - float(rm["aux"])) <= 1e-6 * float(rm["aux"])


def test_mesh_microbatches_and_eval():
    """Microbatches 2 split first, then data shards: each microbatch is one
    global dispatch (its own capacity), as in the one-device step."""
    cfg = reduced("qwen3-moe-235b-a22b")
    model = get_model(cfg)
    params = params_from_numpy(cfg, numpy_params(cfg, 9), device="cpu")
    batch = torch_batch(lm_batch_np(cfg, 10, 8, S, masked=True))
    ocfg = AdamWConfig(**STEP_CFG)
    p1, _, m1 = make_train_step(model, ocfg, microbatches=2, donate=False)(
        params, optim.init(ocfg, params), batch)
    got, m = mesh_step(model, (2, 2), params, batch, microbatches=2)
    assert max_err(got, p1) <= 1e-6
    assert abs(float(m["loss"]) - float(m1["loss"])) <= 1e-6 * float(m1["loss"])
    with pytest.raises(ValueError, match="microbatches"):
        mesh_step(model, (4, 1), params, {k: v[:6] for k, v in batch.items()}, microbatches=2)
    mesh = mesh_of((2, 2))
    blocks = shard_tree(params, mesh, model.specs(mesh))
    ev = make_eval_step(model, mesh)(blocks, batch)
    ev1 = make_eval_step(model)(params, batch)
    assert set(ev) == set(ev1) == {"loss", "ce", "aux"}
    for k in ev:
        assert abs(float(ev[k]) - float(ev1[k])) <= 1e-6 * abs(float(ev1[k])), k


# ------------------------------------------------------------ processes
@pytest.fixture(scope="module")
def processes(tmp_path_factory):
    """Worlds 2 and 4 side by side: three reduced archs' 2 mesh steps on
    (2, 2), all three tensor-parallel (world 2 also qwen1.5-4b on (4, 1),
    and minicpm3-4b, llama4-maverick and seamless-m4t-medium
    tensor-parallel on (1, 2), their model shards one a process), and
    world 2's save and resume."""
    tmp = tmp_path_factory.mktemp("mesh_procs")
    jobs, arrays = [], {}
    for arch, shape in (("qwen3-moe-235b-a22b", (2, 2)), ("zamba2-2.7b", (2, 2)),
                        ("qwen1.5-4b", (4, 1)), ("qwen3-32b", (2, 2)), ("minicpm3-4b", (1, 2)),
                        ("llama4-maverick-400b-a17b", (1, 2)), ("seamless-m4t-medium", (1, 2))):
        cfg = reduced(arch)
        name = f"{arch}@{shape[0]}x{shape[1]}"
        jobs.append(dict(name=name, kind="train", arch=arch, reduced=True, dtype="float32",
                         mesh=shape, opt=STEP_CFG, steps=2))
        for path, a in tree_leaves(numpy_params(cfg, 11)):
            arrays[f"{name}/p/" + "/".join(path)] = a
        for i in range(2):
            for k, v in lm_batch_np(cfg, 12 + i, B, S, masked=True).items():
                arrays[f"{name}/b{i}/{k}"] = v
    save_cfg = reduced(SAVE_ARCH)
    for path, a in tree_leaves(numpy_params(save_cfg, 13)):
        arrays["save/p/" + "/".join(path)] = a
    for k, v in lm_batch_np(save_cfg, 14, B, S, masked=True).items():
        arrays[f"save/b/{k}"] = v
    np.savez(tmp / "inputs.npz", **arrays)
    worlds = {2: jobs, 4: [j for j in jobs if j["mesh"] == (2, 2)]}   # (1, 2) needs 2

    def launch(world):
        out = tmp / f"w{world}"
        out.mkdir()
        params = dict(device="cpu", threads=1, save="arrays", jobs=worlds[world],
                      save_dir=str(tmp / "saved") if world == 2 else None)
        spawn_ranks(mesh_rank, world, (str(tmp / "inputs.npz"), str(out), params),
                    init_file=tmp / f"init{world}", timeout=TIMEOUT)
        return out

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        outs = dict(zip(worlds, pool.map(launch, worlds)))
    return dict(tmp=tmp, jobs=jobs, arrays=np.load(tmp / "inputs.npz"), outs=outs,
                worlds=worlds)


def one_process_result(job, arrays) -> dict:
    """``run_mesh_train`` of a job in this process, whole arrays as bits."""
    cfg = reduced(job["arch"])
    model = get_model(cfg)
    name = job["name"]
    full = tree_of(model, {k[len(name) + 3:]: v for k, v in arrays.items()
                         if k.startswith(f"{name}/p/")})
    batches = [{k: torch.as_tensor(arrays[f"{name}/b{i}/{k}"])
                for k in ("tokens", "labels", "mask", "frames") if f"{name}/b{i}/{k}" in arrays}
               for i in range(job["steps"])]
    mesh = mesh_of(job["mesh"])
    blocks, opt, _ = run_mesh_train(model, mesh, full, batches, job["opt"])
    out = {}
    for kind, tree in (("p", blocks), ("m", opt.m), ("v", opt.v)):
        for path, t in tree_leaves(gather_tree(tree, mesh, model.specs(mesh))):
            out[f"{name}/{kind}/" + "/".join(path)] = host_bits(t)
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_collective_plan_equals_the_gloo_counts(processes, world):
    """Each rank's counted collective bytes, step by step and by type, equal
    the plan for its place in the process grid."""
    from repro_torch.launch.hlo_analysis import mesh_step_collectives
    from repro_torch.launch.mesh import Mesh, _process_grid

    for job in processes["worlds"][world]:
        model = get_model(reduced(job["arch"]))
        procs = _process_grid(job["mesh"], world)
        for r in range(world):
            log = json.loads((processes["outs"][world] / f"rank{r}.json").read_text())
            coords = tuple(int(c) for c in np.unravel_index(r, procs))
            mesh = Mesh(tuple(job["mesh"]), ("data", "model"), torch.device("cpu"), procs,
                        coords, {})
            frames = (ENC_LEN,) if model.cfg.family == "encdec" else ()
            plan = mesh_step_collectives(model, mesh, batch=(B, S) + frames).stats().by_type
            assert plan and all(v > 0 for v in plan.values())
            assert log[job["name"]]["collective_bytes"] == [plan] * job["steps"], (job, r)


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_processes_train_bitwise_one_process(processes, world):
    got = np.load(processes["outs"][world] / "rank0.npz")
    for job in processes["worlds"][world]:
        want = one_process_result(job, processes["arrays"])
        assert set(want) <= set(got.files), job["name"]
        for k, v in want.items():
            assert np.array_equal(got[k], v), (world, k)
    logs = [json.loads((processes["outs"][world] / f"rank{r}.json").read_text())
            for r in range(world)]
    for job in processes["worlds"][world]:
        losses = [lg[job["name"]]["loss"] for lg in logs]
        assert all(lo == losses[0] for lo in losses)          # every rank reports the same


def test_mesh_save_is_a_one_device_save_and_resumes(processes, tmp_path):
    """World 2's save from the (2, 2) mesh writes the array files a
    one-device save of the same step writes, byte for byte; its
    ``elastic.resume`` onto (1, 2) in both processes gives the saved
    arrays back, each rank holding half of ``embed``'s model dimension."""
    cfg = reduced(SAVE_ARCH)
    model = get_model(cfg)
    a = processes["arrays"]
    full = tree_of(model, {k[len("save/p/"):]: v for k, v in a.items() if k.startswith("save/p/")})
    batch = {k: torch.as_tensor(a[f"save/b/{k}"]) for k in ("tokens", "labels", "mask")}
    mesh = mesh_of((2, 2))
    blocks = shard_tree(full, mesh, model.specs(mesh))
    ocfg = AdamWConfig(**STEP_CFG)
    blocks, opt, _ = make_train_step(model, ocfg, mesh)(blocks, optim.init(ocfg, blocks), batch)
    # one process holds every shard: the blocks are the whole leaves
    ckpt.save(tmp_path / "one", 1, blocks, opt, data_cursor=1)
    saved = processes["tmp"] / "saved" / "step_000000001"
    mine = tmp_path / "one" / "step_000000001"
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (saved, mine))
    assert ma["keys"] == mb["keys"] and ma["data_cursor"] == 1
    for info in ma["keys"].values():
        assert (saved / "arrays" / info["file"]).read_bytes() == \
            (mine / "arrays" / info["file"]).read_bytes(), info["file"]
    for r in range(2):
        res = np.load(processes["outs"][2] / f"resumed{r}.npz")
        assert int(res["cursor"]) == 1 and int(res["step"]) == 1
        for path, t in tree_leaves(blocks):
            assert np.array_equal(res["p/" + "/".join(path)], t.numpy())
        for path, t in tree_leaves(opt.m):
            assert np.array_equal(res["m/" + "/".join(path)], t.numpy())
        # embed (vocab, d): vocab over model (2 shards), d over data (1)
        assert res["block_shapes"].tolist() == [[cfg.vocab // 2, cfg.d_model]]


def test_restore_with_shardings_and_resume_onto_another_mesh(tmp_path):
    """A checkpoint written whole restores as blocks on any mesh; a step on
    the new mesh continues as the one-device step does."""
    cfg = reduced("rwkv6-1.6b")
    model = get_model(cfg)
    params = params_from_numpy(cfg, numpy_params(cfg, 15), device="cpu")
    ocfg = AdamWConfig(**STEP_CFG)
    step = make_train_step(model, ocfg, donate=False)
    b0, b1 = (torch_batch(lm_batch_np(cfg, 16 + i, B, S, masked=True)) for i in range(2))
    p, o, _ = step(params, optim.init(ocfg, params), b0)
    ckpt.save(tmp_path, 1, p, o, data_cursor=1)
    for shape in ((4, 1), (1, 2)):
        mesh = mesh_of(shape)
        pshard = model.shardings(mesh)
        rp, ro, meta = ckpt.restore(tmp_path, params_template=model.shapes(),
                                    opt_template=optim.init(ocfg, model.shapes()),
                                    param_shardings=pshard,
                                    opt_shardings=optim.AdamWState(None, pshard, pshard),
                                    device="cpu")
        ep, eo, emeta = elastic.resume(tmp_path, model, optim.init(ocfg, model.shapes()), mesh)
        assert meta["data_cursor"] == emeta["data_cursor"] == 1 and int(eo.step) == 1
        specs = model.specs(mesh)
        for a, c in ((rp, ep), (ro.m, eo.m), (ro.v, eo.v)):
            assert all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_leaves(a), tree_leaves(c)))
        assert max_err(gather_tree(rp, mesh, specs), p) == 0.0
        p2, _, _ = step(p, o, b1)
        q2, _, _ = make_train_step(model, ocfg, mesh, donate=False)(ep, eo, b1)
        assert max_err(gather_tree(q2, mesh, specs), p2) <= 1e-6, shape


def test_train_cli_mesh_resume(tmp_path, capsys):
    """``--mesh 2x1`` straight 4 steps, its final checkpoint moved away,
    ``--resume`` on ``2x1`` writes it again byte for byte; on ``1x2``
    within 1e-5 (one data shard sums each gradient in another order)."""
    base = ["--arch", "qwen3-moe-235b-a22b", "--reduced", "--batch", "4", "--seq", "16",
            "--device", "cpu", "--steps", "4", "--ckpt-every", "2", "--log-every", "1",
            "--ckpt-dir", str(tmp_path / "a")]
    assert train_cli.main(base + ["--mesh", "2x1"]) == 0
    final = "step_000000004"
    (tmp_path / "b").mkdir()
    shutil.move(tmp_path / "a" / final, tmp_path / "b" / final)
    assert train_cli.main(base + ["--mesh", "2x1", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and "final checkpoint" in out
    a, b = tmp_path / "a" / final, tmp_path / "b" / final
    meta = json.loads((a / "manifest.json").read_text())
    for info in meta["keys"].values():
        assert (a / "arrays" / info["file"]).read_bytes() == \
            (b / "arrays" / info["file"]).read_bytes(), info["file"]
    shutil.rmtree(a)
    assert train_cli.main(base + ["--mesh", "1x2", "--resume"]) == 0
    assert "resumed at step 2" in capsys.readouterr().out
    for key, info in meta["keys"].items():
        x = np.load(a / "arrays" / info["file"]).astype(np.float64)
        y = np.load(b / "arrays" / info["file"]).astype(np.float64)
        assert np.abs(x - y).max() <= 1e-5, key


def test_remat_recompute_reuses_the_forward_counts(monkeypatch):
    """The checkpointed MoE block runs again in the backward: it finds its
    forward's counts by its router leaf and exchanges nothing more (one
    exchange a layer and a shard), and the record is dropped after."""
    from repro_torch.train import step as step_mod

    calls = []
    original = step_mod._Exchange.__call__

    def counting(self, q, counts):
        calls.append(q)
        return original(self, q, counts)

    monkeypatch.setattr(step_mod._Exchange, "__call__", counting)
    cfg = reduced("qwen3-moe-235b-a22b")
    assert cfg.remat and cfg.moe
    model = get_model(cfg)
    params = params_from_numpy(cfg, numpy_params(cfg, 17), device="cpu")
    batch = torch_batch(lm_batch_np(cfg, 18, B, S, masked=True))
    mesh_step(model, (2, 1), params, batch)
    assert sorted(calls) == [0] * cfg.n_layers + [1] * cfg.n_layers
    assert not moe._SEEN
