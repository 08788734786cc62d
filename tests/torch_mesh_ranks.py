"""Rank programs of ``tests/test_torch_mesh_train.py``'s spawned processes:
only torch and the port, so a spawned rank starts without the reference."""
import dataclasses
import json
import pathlib

import numpy as np
import torch

from repro_torch import ckpt
from repro_torch.configs import get_arch
from repro_torch.ft import elastic
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shardings import gather_tree, shard_tree
from repro_torch.models import get_model
from repro_torch.models.common import tree_leaves
from repro_torch.train import AdamWConfig, make_train_step, optim

STEP_CFG = dict(lr=1e-3, eps=1e-3, warmup_steps=0, schedule="constant")   # the eps rule
SAVE_ARCH = "qwen3-moe-235b-a22b"


def reduced(arch):
    return dataclasses.replace(get_arch(arch).reduced, dtype=torch.float32)


def mesh_rank(rank, world, inputs, out_dir, params):
    """``train_rank_program``'s jobs, then (world 2) a mesh step of
    SAVE_ARCH saved with its shardings and resumed onto ``(1, 2)``."""
    from repro_torch.launch.sharded import train_rank_program

    train_rank_program(rank, world, inputs, out_dir, params)
    if not params.get("save_dir"):
        return
    cfg = reduced(SAVE_ARCH)
    model = get_model(cfg)
    data = np.load(inputs)
    full = tree_of(model, {k[len("save/p/"):]: v for k, v in data.items()
                           if k.startswith("save/p/")})
    batch = {k: torch.as_tensor(data[f"save/b/{k}"]) for k in ("tokens", "labels", "mask")}
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    blocks = shard_tree(full, mesh, model.specs(mesh))
    ocfg = AdamWConfig(**STEP_CFG)
    blocks, opt, _ = make_train_step(model, ocfg, mesh)(blocks, optim.init(ocfg, blocks), batch)
    pshard = model.shardings(mesh)
    ckpt.save(params["save_dir"], 1, blocks, opt, data_cursor=1, param_shardings=pshard,
              opt_shardings=optim.AdamWState(None, pshard, pshard))
    mesh2 = make_mesh((1, 2), ("data", "model"), device="cpu")
    rp, ro, meta = elastic.resume(params["save_dir"], model,
                                  optim.init(ocfg, model.shapes()), mesh2)
    specs2 = model.specs(mesh2)
    out = {f"p/{'/'.join(k)}": v for k, v in tree_leaves(gather_tree(rp, mesh2, specs2))}
    out.update({f"m/{'/'.join(k)}": v for k, v in tree_leaves(gather_tree(ro.m, mesh2, specs2))})
    out["block_shapes"] = np.asarray([list(rp["embed"].shape)])
    np.savez(f"{out_dir}/resumed{rank}.npz", cursor=meta["data_cursor"], step=int(ro.step),
             **{k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()})


def threads_rank(rank, world, inputs, out_dir, params):
    """``train_rank_program``'s jobs, each ``torch.distributed`` call the
    collectives make counted by the thread that made it: the calls made on
    the main thread, the names of those made on any other, and the most
    data shards a process held, to ``out_dir/threads{rank}.json``."""
    import threading

    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.launch.sharded import train_rank_program
    from repro_torch.train import step as step_mod

    calls = dict(main=0, threads=[], data_shards=0)

    def watched(fn, name):
        def call(*args, **kw):
            if threading.current_thread() is threading.main_thread():
                calls["main"] += 1
            else:
                calls["threads"].append(name)
            return fn(*args, **kw)
        return call

    collectives._all_gather_single = watched(collectives._all_gather_single, "all_gather")
    for name in ("all_reduce", "batch_isend_irecv", "all_to_all_single", "broadcast"):
        setattr(dist, name, watched(getattr(dist, name), name))
    init = step_mod._MeshStep.__init__

    def mesh_step_init(self, *args, **kw):
        init(self, *args, **kw)
        calls["data_shards"] = max(calls["data_shards"], len(self.shards))

    step_mod._MeshStep.__init__ = mesh_step_init
    train_rank_program(rank, world, inputs, out_dir, params)
    pathlib.Path(out_dir, f"threads{rank}.json").write_text(json.dumps(calls))


def tree_of(model, flat: dict):
    from repro_torch.train.optim import tree_from_paths

    return tree_from_paths(model.shapes(), {tuple(k.split("/")): torch.as_tensor(v)
                                            for k, v in flat.items()})




# ------------------------------------------------ tests/test_torch_ep.py
# the reference test's MoE layer (tests/test_distributed.py), at the config's capacity
EP_CFG = dict(family="decoder", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32,
              vocab=32, moe=True, n_experts=8, top_k=2, moe_d_ff=32, n_shared_experts=1,
              capacity_factor=1.25)
COMPRESS = {"w": (512,), "b": (7, 100)}          # per-shard gradient leaves (700: padded)


def _stage_fn(p, h):
    for i in range(p.shape[0]):
        h = torch.tanh(h @ p[i])
    return h


PIPE = dict(stages=4, per=2, d=16, micro=8, mb=4, stage_fn=_stage_fn)


def numpy_moe_layer(rng) -> dict:
    """An MoE layer of EP_CFG drawn with numpy, each leaf at 1/sqrt(fan_in)."""
    d, f, E = EP_CFG["d_model"], EP_CFG["moe_d_ff"], EP_CFG["n_experts"]
    shapes = {"router": (d, E),
              "experts": {"w_gate": (E, d, f), "w_up": (E, d, f), "w_down": (E, f, d)},
              "shared": {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)

    return draw(shapes)


def ep_shards(x: np.ndarray) -> np.ndarray:
    """The (2, 2) ("data", "model") token shards of x (B, S, d), shard
    ``2 · data + model`` a row: (4, B/2 · S/2, d)."""
    B, S, d = x.shape
    return np.stack([x[i * B // 2:(i + 1) * B // 2, j * S // 2:(j + 1) * S // 2].reshape(-1, d)
                     for i in range(2) for j in range(2)])


def pipeline_inputs(rng):
    n, per, d = PIPE["stages"], PIPE["per"], PIPE["d"]
    W = (rng.standard_normal((n, per, d, d)) / np.sqrt(d)).astype(np.float32)
    x = rng.standard_normal((PIPE["micro"], PIPE["mb"], d)).astype(np.float32)
    return W, x


def ep_rank(rank, world, inputs, out_dir):
    """One rank of the EP layer on (2, 2), two steps of compressed_psum over
    (8,) and the pipeline over (4,) stages; rank 0 writes the whole
    results' bits."""
    from repro_torch.distributed import compressed_psum, init_ef, pipeline_forward
    from repro_torch.launch.sharded import host_bits, run_ep_layer
    from repro_torch.launch.shardings import gather_leaf
    from repro_torch.models.common import ModelConfig, P

    torch.set_num_threads(1)
    data = np.load(inputs)
    layer = tree_of_prefix({k: v for k, v in data.items()}, "layer/")
    x, g = (torch.from_numpy(data[k]) for k in ("x", "g"))
    out = {}
    got, log = run_ep_layer(ModelConfig(**EP_CFG, dtype=torch.float32),
                            make_mesh((2, 2), ("data", "model"), device="cpu"), layer, x, g)
    pathlib.Path(out_dir, f"ep{rank}.json").write_text(json.dumps(log["collective_bytes"]))
    out.update({"ep/" + k: host_bits(v) for k, v in got.items()})
    mesh8 = make_mesh((8,), ("data",), device="cpu")
    lo, n = mesh8.start("data"), mesh8.local("data")
    ef = init_ef({k: torch.zeros((n,) + s) for k, s in COMPRESS.items()})
    for t in range(2):
        grads = {k: torch.from_numpy(data[f"g{t}/{k}"][lo:lo + n]) for k in COMPRESS}
        mean, ef = compressed_psum(grads, ef, mesh8, "data")
        for k in COMPRESS:
            out[f"c{t}/mean/{k}"] = host_bits(gather_leaf(mean[k], mesh8, P("data")))
            out[f"c{t}/res/{k}"] = host_bits(gather_leaf(ef.residual[k], mesh8, P("data")))
    mesh4 = make_mesh((PIPE["stages"],), ("stage",), device="cpu")
    W = torch.from_numpy(data["pipe/W"])[mesh4.start("stage"):
                                         mesh4.start("stage") + mesh4.local("stage")]
    out["pipe/out"] = host_bits(pipeline_forward(mesh4, "stage", _stage_fn, W,
                                                 torch.from_numpy(data["pipe/x"])))
    if rank == 0:
        np.savez(f"{out_dir}/rank0.npz", **out)


def tree_of_prefix(flat: dict, prefix: str) -> dict:
    tree = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            node = tree
            parts = k[len(prefix):].split("/")
            for q in parts[:-1]:
                node = node.setdefault(q, {})
            node[parts[-1]] = torch.from_numpy(np.array(v))
    return tree
