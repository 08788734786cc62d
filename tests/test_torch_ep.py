"""The expert-parallel MoE, gradient compression and the GPipe pipeline
(``models/moe.py``, ``distributed/compression.py``,
``distributed/pipeline.py``) against the reference, and the mesh step's
global dispatch against the reference's partitioned step.

The reference's side runs once, in a subprocess with 8 fake CPU devices
(``tests/test_distributed.py::run_sub``'s way), on numpy inputs written
here, beside the port's side in this process and in 2 gloo processes:

* ``_moe_ffn_ep`` on a ``(2, 2)`` ``("data", "model")`` mesh at capacity
  factor 1.25 (it drops assignments): each token shard's kept assignments
  (``_local_dispatch``'s slot maps) **equal**, the output and aux within
  1e-5; at capacity factor 16 (nothing dropped) the port's EP output,
  aux, input gradient and parameter gradients within 1e-6 of each
  tensor's scale (``max(1, max |t|)``) of its local path's (the gradient
  through ``AllToAll`` and ``Gathered``), and ``AllToAll``'s gradient
  checked numerically;
* ``_moe_ffn_local`` under a ``data = 2`` mesh (two dispatch groups, each
  with its own capacity) within 1e-6;
* ``compressed_psum`` over 8 shards, two steps of error feedback: the int8
  payload, the scales and the residual **bitwise** (the reference's
  compiled arithmetic: XLA multiplies by the reciprocal of 127 and fuses
  the residual's multiply-add, and so does the port), the mean within
  float32 rounding of the reference's and within the reference's 0.05
  relative of the exact mean; ``compression_ratio`` equal;
* ``pipeline_forward`` over 4 stages and 8 microbatches within 1e-5 of
  the sequential stack and of the reference's; ``bubble_fraction``;
* one ``make_train_step(model, cfg, mesh)`` step of reduced qwen3-moe on
  ``(2, 2)``: the reference's partitioned step keeps the one-device
  step's global dispatch (its aux equals its one-device aux), and the
  port's mesh step lies within 1e-6 of it on every parameter;
* 2 gloo processes give the EP layer, the compressed mean and residual
  and the pipeline bitwise as one process holding every shard; the
  collective bytes each rank's EP layer counted equal the dry-run's plan.
"""
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.distributed import (
    bubble_fraction, compressed_psum, compression_ratio, init_ef, pipeline_forward,
)
from repro_torch.distributed import compression
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharded import host_bits, run_ep_layer, spawn_ranks
from repro_torch.launch.shardings import gather_tree, shard_tree
from repro_torch.models import get_model, moe, params_from_numpy, shard_ctx
from repro_torch.models.common import ModelConfig, tree_leaves
from repro_torch.train import AdamWConfig, make_train_step, optim
from torch_mesh_ranks import (
    COMPRESS, EP_CFG, PIPE, ep_rank, ep_shards, numpy_moe_layer, pipeline_inputs, reduced,
    STEP_CFG,
)
from torch_towers import TRAIN_DECAY, assert_trees_close, lm_batch_np, redraw_constant_leaves

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 150.0

REFERENCE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.compat import shard_map
from repro.models import ModelConfig, shard_ctx
from repro.models import moe as moe_lib
from repro.models.api import get_model
from repro.configs.registry import get_arch
from repro.distributed import compressed_psum, init_ef, compression
from repro.distributed.pipeline import pipeline_forward, bubble_fraction
from repro.train import optim, step

inp = dict(np.load(sys.argv[1]))
out = {}
devs = np.array(jax.devices())

def tree(prefix):
    t = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            node = t
            parts = k[len(prefix):].split("/")
            for q in parts[:-1]:
                node = node.setdefault(q, {})
            node[parts[-1]] = v
    return t

# ---- the EP layer at two capacity factors, the local path with G = 2
mesh22 = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
layer = tree("layer/")
x = inp["x"]
for cf in (1.25, 16.0):
    cfg = ModelConfig(**{**EP_CFG, "capacity_factor": cf}, dtype=jnp.float32)
    with shard_ctx.use_mesh(mesh22):
        y, aux = jax.jit(lambda p, xx: moe_lib.moe_ffn(cfg, p, xx))(layer, x)
    out[f"ep{cf}/y"], out[f"ep{cf}/aux"] = np.asarray(y), np.asarray(aux)
    # each token shard's dispatch, as the EP path runs it
    T_dev = x.shape[0] * x.shape[1] // 4
    C = min(max(int(T_dev * cfg.top_k / cfg.n_experts * cf) + 1, 4), T_dev * cfg.top_k)
    def dispatch(xs, router, cfg=cfg, C=C):
        gi, gv, _, _ = moe_lib._router(cfg, xs, router)
        return moe_lib._local_dispatch(xs, gi, gv, cfg.n_experts, C)[1:]
    dispatch = jax.jit(dispatch)
    for s, xs in enumerate(inp["shards"]):
        t_of, w_of = dispatch(xs, layer["router"])
        out[f"ep{cf}/t_of{s}"], out[f"ep{cf}/w_of{s}"] = np.asarray(t_of), np.asarray(w_of)
cfg = ModelConfig(**EP_CFG, dtype=jnp.float32)
mesh2 = Mesh(devs[:2].reshape(2), ("data",))
with shard_ctx.use_mesh(mesh2):
    y, aux = jax.jit(lambda p, xx: moe_lib._moe_ffn_local(cfg, p, xx))(layer, x)
out["local2/y"], out["local2/aux"] = np.asarray(y), np.asarray(aux)

# ---- compressed_psum: two steps of error feedback over 8 shards
mesh8 = Mesh(devs.reshape(8), ("data",))
names = sorted(k[3:] for k in inp if k.startswith("g0/"))
res = {n: np.zeros_like(inp["g0/" + n]) for n in names}
quantize = jax.jit(lambda a: compression._quantize(a.reshape(-1))[:2])
def local(gg, rr):
    grads = {n: gg[n][0] for n in names}
    ef = compression.EFState({n: rr[n][0] for n in names})
    mean, new = compressed_psum(grads, ef, "data")
    return ({n: mean[n][None] for n in names}, {n: new.residual[n][None] for n in names})
spec = {n: P("data") for n in names}
fn = jax.jit(shard_map(local, mesh=mesh8, in_specs=(spec, spec), out_specs=(spec, spec),
                       check_vma=False))
for t in range(2):
    g = {n: inp[f"g{t}/{n}"] for n in names}
    for n in names:
        for s in range(8):
            q, scale = quantize(jnp.asarray(g[n][s] + res[n][s]))
            out[f"c{t}/q/{n}/{s}"], out[f"c{t}/scale/{n}/{s}"] = np.asarray(q), np.asarray(scale)
    mean, new = fn(g, res)
    res = {n: np.asarray(new[n]) for n in names}
    for n in names:
        out[f"c{t}/mean/{n}"], out[f"c{t}/res/{n}"] = np.asarray(mean[n]), res[n]

# ---- the pipeline over 4 stages
mesh4 = Mesh(devs[:4].reshape(4), ("stage",))
Ws, xm = inp["pipe/W"], inp["pipe/x"]
def stage_fn(p, h):
    for i in range(p.shape[0]):
        h = jnp.tanh(h @ p[i])
    return h
out["pipe/out"] = np.asarray(pipeline_forward(mesh4, "stage", stage_fn, Ws, xm))
out["pipe/bubble"] = np.asarray(bubble_fraction(8, 4))

# ---- one partitioned train step of reduced qwen3-moe on (2, 2), and its one-device step
rcfg = __import__("dataclasses").replace(get_arch("qwen3-moe-235b-a22b").reduced,
                                         dtype=jnp.float32)
model = get_model(rcfg)
params = tree("train/p/")
batch = {k: inp["train/b/" + k] for k in ("tokens", "labels", "mask")}
ocfg = optim.AdamWConfig(**STEP_CFG)
p, o, met = step.make_train_step(model, ocfg, mesh22, donate=False)(
    params, optim.init(ocfg, params), batch)
for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
    out["train/mesh/p/" + "/".join(q.key for q in path)] = np.asarray(leaf)
for k in ("loss", "ce", "aux"):
    out[f"train/mesh/{k}"] = np.asarray(met[k])
# the one-device loss of the same parameters and batch (its aux: the global dispatch)
loss, met = jax.jit(model.loss)(params, batch)
out["train/one/loss"], out["train/one/aux"] = np.asarray(loss), np.asarray(met["aux"])
np.savez(sys.argv[2], **out)
print("reference OK")
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    rng = np.random.default_rng(31)
    arrays = {}
    layer = numpy_moe_layer(rng)
    for path, a in tree_leaves(layer):
        arrays["layer/" + "/".join(path)] = a
    # 32 tokens a (data, model) shard: capacity 11 an expert, which 1.25 lets drop
    arrays["x"] = rng.standard_normal((4, 32, EP_CFG["d_model"])).astype(np.float32)
    arrays["g"] = rng.standard_normal(arrays["x"].shape).astype(np.float32)
    arrays["shards"] = ep_shards(arrays["x"])
    for t in range(2):
        for n, shape in COMPRESS.items():
            arrays[f"g{t}/{n}"] = rng.standard_normal((8,) + shape).astype(np.float32)
    arrays["pipe/W"], arrays["pipe/x"] = pipeline_inputs(rng)
    cfg = reduced("qwen3-moe-235b-a22b")
    p = get_model(cfg).init(torch.Generator().manual_seed(33))
    host = redraw_constant_leaves({k: v for k, v in _numpy(p).items()}, 34, draws=TRAIN_DECAY)
    for path, a in tree_leaves(host):
        arrays["train/p/" + "/".join(path)] = a
    for k, v in lm_batch_np(cfg, 35, 4, 16, masked=True).items():
        arrays["train/b/" + k] = v
    np.savez(tmp / "inputs.npz", **arrays)
    return dict(tmp=tmp, arrays=arrays, layer=layer, host=host)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.fixture(scope="module")
def reference(inputs):
    """The reference's outputs (the subprocess runs while the port's
    processes start)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    code = (f"EP_CFG = {EP_CFG!r}\nSTEP_CFG = {STEP_CFG!r}\n") + REFERENCE
    proc = subprocess.Popen([sys.executable, "-c", code, str(inputs["tmp"] / "inputs.npz"),
                             str(inputs["tmp"] / "reference.npz")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out_dir = inputs["tmp"] / "ranks"
    out_dir.mkdir()
    try:
        spawn_ranks(ep_rank, 2, (str(inputs["tmp"] / "inputs.npz"), str(out_dir)),
                    init_file=inputs["tmp"] / "init", timeout=TIMEOUT)
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
    return dict(np.load(inputs["tmp"] / "reference.npz")), np.load(out_dir / "rank0.npz")


def ep_cfg(cf: float) -> ModelConfig:
    return ModelConfig(**{**EP_CFG, "capacity_factor": cf}, dtype=torch.float32)


def torch_layer(layer) -> dict:
    return {k: torch_layer(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in layer.items()}


def local_run(cfg, layer, x, g):
    """The local path (G = 1): y, aux, input and parameter gradients of
    ``Σ y · g + aux``."""
    p = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
             if isinstance(v, dict) else v.clone().requires_grad_(True)) for k, v in layer.items()}
    xl = x.clone().requires_grad_(True)
    y, aux = moe._moe_ffn_local(cfg, p, xl)
    leaves = [xl] + [t for _, t in tree_leaves(p)]
    grads = torch.autograd.grad(torch.sum(y * g) + aux, leaves)
    out = dict(y=y.detach(), aux=aux.detach(), dx=grads[0])
    for (path, _), gr in zip(tree_leaves(p), grads[1:]):
        out["grad/" + "/".join(path)] = gr
    return out


def test_ep_matches_local_and_reference(inputs, reference):
    ref, _ = reference
    layer = torch_layer(inputs["layer"])
    x, g = (torch.from_numpy(inputs["arrays"][k]) for k in ("x", "g"))
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    for cf in (1.25, 16.0):
        cfg = ep_cfg(cf)
        got, log = run_ep_layer(cfg, mesh, layer, x, g)
        np.testing.assert_allclose(got["y"].numpy(), ref[f"ep{cf}/y"], atol=1e-5, rtol=0)
        assert abs(float(got["aux"]) - float(ref[f"ep{cf}/aux"])) <= 1e-6
        # each token shard's kept assignments equal the reference's
        T_dev = x.shape[0] * x.shape[1] // 4
        C = min(max(int(T_dev * cfg.top_k / cfg.n_experts * cf) + 1, 4), T_dev * cfg.top_k)
        kept = 0
        for s, xs in enumerate(inputs["arrays"]["shards"]):
            xs = torch.from_numpy(xs)
            gi, gv, _, _ = moe._router(cfg, xs, layer["router"])
            _, t_of, w_of, _ = moe._local_dispatch(xs, gi, gv, cfg.n_experts, C)
            assert np.array_equal(t_of.numpy(), ref[f"ep{cf}/t_of{s}"]), (cf, s)
            assert np.array_equal(w_of.numpy() > 0, ref[f"ep{cf}/w_of{s}"] > 0), (cf, s)
            np.testing.assert_allclose(w_of.numpy(), ref[f"ep{cf}/w_of{s}"], atol=1e-6)
            kept += int((ref[f"ep{cf}/w_of{s}"] > 0).sum())
        assert log["dropped"] == 4 * T_dev * cfg.top_k - kept
        if cf == 1.25:
            assert log["dropped"] > 0, "capacity 1.25 should drop assignments here"
        else:
            assert log["dropped"] == 0
            want = local_run(cfg, layer, x, g)
            for k, v in want.items():           # 1e-6 of each tensor's scale
                scale = max(1.0, float(v.abs().max()))
                assert float((got[k] - v).abs().max()) <= 1e-6 * scale, k


def test_all_to_all_gradient():
    """``AllToAll``'s backward is the reverse all-to-all: gradcheck in one
    process, where it is the transposition of the shards."""
    mesh = make_mesh((1, 3), ("data", "model"), device="cpu")
    t = torch.randn(3, 3, 2, 4, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: moe.AllToAll.apply(a, mesh, "model"), (t,))
    assert torch.equal(moe.AllToAll.apply(t, mesh, "model").detach(), t.detach().transpose(0, 1))


def test_local_path_two_groups_matches_reference(inputs, reference):
    ref, _ = reference
    cfg = ep_cfg(EP_CFG["capacity_factor"])
    layer = torch_layer(inputs["layer"])
    x = torch.from_numpy(inputs["arrays"]["x"])
    with shard_ctx.use_mesh(make_mesh((2,), ("data",), device="cpu")):
        assert shard_ctx.dp_size() == 2 and shard_ctx.tp_size() == 1
        y, aux = moe._moe_ffn_local(cfg, layer, x)
    assert not shard_ctx.active()
    np.testing.assert_allclose(y.numpy(), ref["local2/y"], atol=1e-6, rtol=0)
    assert abs(float(aux) - float(ref["local2/aux"])) <= 1e-7
    y1, _ = moe._moe_ffn_local(cfg, layer, x)          # one group: another capacity
    assert float((y1 - y).abs().max()) > 1e-3


def compressed_steps(arrays, mesh):
    """Two steps of ``compressed_psum`` with error feedback (every shard
    in this process): the payloads, scales, means and residuals."""
    names = sorted(COMPRESS)
    res = init_ef({n: torch.zeros((8,) + COMPRESS[n]) for n in names})
    out = {}
    for t in range(2):
        g = {n: torch.from_numpy(arrays[f"g{t}/{n}"]) for n in names}
        for n in names:
            for s in range(8):
                q, scale, _ = compression._quantize((g[n][s] + res.residual[n][s]).reshape(-1))
                out[f"c{t}/q/{n}/{s}"], out[f"c{t}/scale/{n}/{s}"] = q, scale
        mean, res = compressed_psum(g, res, mesh, "data")
        for n in names:
            out[f"c{t}/mean/{n}"], out[f"c{t}/res/{n}"] = mean[n], res.residual[n]
    return out


def test_compressed_psum_matches_reference(inputs, reference):
    ref, _ = reference
    mesh = make_mesh((8,), ("data",), device="cpu")
    got = compressed_steps(inputs["arrays"], mesh)
    for k, v in got.items():
        if "/mean/" in k:
            # the sum over shards runs in the ring's order
            np.testing.assert_allclose(v.numpy(), ref[k], atol=2e-7 * np.abs(ref[k]).max())
        else:
            assert np.array_equal(v.numpy(), ref[k]), k          # payload, scales, residual
    for n in COMPRESS:
        exact = inputs["arrays"][f"g0/{n}"].mean(axis=0)
        rel = np.abs(got[f"c0/mean/{n}"][0].numpy() - exact).max() / np.abs(exact).max()
        assert rel < 0.05, rel            # the reference test's int8 noise bound
    for n in (1, 255, 256, 4097, 10 ** 6):
        assert compression_ratio(n) == pytest.approx(
            2 * n / (n + 4 * math.ceil(n / 256)), rel=0, abs=0)


def test_pipeline_matches_sequential_and_reference(inputs, reference):
    ref, _ = reference
    W, xm = (torch.from_numpy(inputs["arrays"][k]) for k in ("pipe/W", "pipe/x"))
    mesh = make_mesh((PIPE["stages"],), ("stage",), device="cpu")
    out = pipeline_forward(mesh, "stage", PIPE["stage_fn"], W, xm)
    seq = xm
    for s in range(PIPE["stages"]):
        seq = torch.stack([PIPE["stage_fn"](W[s], mb) for mb in seq])
    assert float((out - seq).abs().max()) <= 1e-5
    np.testing.assert_allclose(out.numpy(), ref["pipe/out"], atol=1e-5, rtol=0)
    assert abs(bubble_fraction(8, 4) - 3 / 11) < 1e-12
    assert bubble_fraction(8, 4) == float(ref["pipe/bubble"])


def test_mesh_step_keeps_the_global_dispatch(inputs, reference):
    """The reference's partitioned step is its one-device step (aux from
    the global dispatch); the port's mesh step matches it."""
    ref, _ = reference
    cfg = reduced("qwen3-moe-235b-a22b")
    model = get_model(cfg)
    assert abs(float(ref["train/mesh/aux"]) - float(ref["train/one/aux"])) <= \
        1e-6 * float(ref["train/one/aux"])
    params = params_from_numpy(cfg, inputs["host"], device="cpu")
    batch = {k: torch.from_numpy(inputs["arrays"]["train/b/" + k])
             for k in ("tokens", "labels", "mask")}
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    specs = model.specs(mesh)
    blocks = shard_tree(params, mesh, specs)
    ocfg = AdamWConfig(**STEP_CFG)
    new, _, m = make_train_step(model, ocfg, mesh, donate=False)(
        blocks, optim.init(ocfg, blocks), batch)
    want = {}
    for k, v in ref.items():
        if k.startswith("train/mesh/p/"):
            node = want
            parts = k[len("train/mesh/p/"):].split("/")
            for q in parts[:-1]:
                node = node.setdefault(q, {})
            node[parts[-1]] = v
    assert_trees_close(gather_tree(new, mesh, specs), want, atol=1e-6, rtol=0)
    for k in ("loss", "ce", "aux"):
        assert abs(float(m[k]) - float(ref[f"train/mesh/{k}"])) <= 1e-6 * abs(
            float(ref[f"train/mesh/{k}"])), k
    assert float(m["dropped"]) > 0


def test_two_processes_bitwise_one_process(inputs, reference):
    _, ranks = reference
    arrays = inputs["arrays"]
    layer = torch_layer(inputs["layer"])
    x, g = (torch.from_numpy(arrays[k]) for k in ("x", "g"))
    got, _ = run_ep_layer(ep_cfg(1.25), make_mesh((2, 2), ("data", "model"), device="cpu"),
                          layer, x, g)
    for k, v in got.items():
        assert np.array_equal(ranks["ep/" + k], host_bits(v)), k
    comp = compressed_steps(arrays, make_mesh((8,), ("data",), device="cpu"))
    for k, v in comp.items():
        if "/mean/" in k or "/res/" in k:
            assert np.array_equal(ranks[k], host_bits(v)), k
    W, xm = (torch.from_numpy(arrays[k]) for k in ("pipe/W", "pipe/x"))
    out = pipeline_forward(make_mesh((4,), ("stage",), device="cpu"), "stage",
                           PIPE["stage_fn"], W, xm)
    assert np.array_equal(ranks["pipe/out"], host_bits(out))


@pytest.mark.parametrize("rank", [0, 1])
def test_ep_collective_plan_equals_the_gloo_counts(inputs, reference, rank):
    """The collective bytes each gloo rank's EP layer counted (forward and
    backward, ``distributed.collectives.COUNTS``) equal the dry-run's plan
    of the layer (``launch/hlo_analysis.py::ep_layer_collectives``) for its
    place in the process grid."""
    import json

    from repro_torch.launch.hlo_analysis import ep_layer_collectives
    from repro_torch.launch.mesh import Mesh, _process_grid

    procs = _process_grid((2, 2), 2)
    mesh = Mesh((2, 2), ("data", "model"), torch.device("cpu"), procs,
                tuple(int(c) for c in np.unravel_index(rank, procs)), {})
    B, S, _ = inputs["arrays"]["x"].shape
    plan = ep_layer_collectives(ep_cfg(1.25), mesh, B, S).stats().by_type
    counted = json.loads((inputs["tmp"] / "ranks" / f"ep{rank}.json").read_text())
    assert plan and counted == plan
