"""The decoders' split prefill and decode (``launch/dryrun.py``'s
``prefill_step`` and ``serve_step``; ``models/shard_ctx.py``'s gather,
merge and argmax; the attention's sequence-split cache) on the CPU.

Reduced configs (2 layers; llama4's 4, two super-layers), ``B = 4``
prompts of 24 tokens, an ``S = 32`` cache, the rows' lengths 24, 20, 13
and 7 (a row's decode steps overwrite its positions past its length, so
the step's write position falls in different blocks of a sequence-split
cache), 8 teacher-forced decode steps; weights drawn once with numpy.

* **One device.**  Each of the 7 decoder archs on ``(1, 2)``, ``(2, 2)``
  and ``(1, 4)`` ``("data", "model")`` meshes, one process holding every
  shard: the split prefill's last logits and cache blocks (gathered), and
  each decode step's logits, next tokens and the last caches, against the
  one-device ``prefill`` / ``decode_step``: ``max |split − one device| /
  max |one device|`` within 1e-5 in float32 and 1e-9 in float64, the next
  tokens equal.  Reduced qwen3-32b, starcoder2-15b and chameleon-34b on
  ``(1, 4)`` (2 kv heads on 4), minicpm3-4b (MLA's latent cache) and the
  MoE archs there take the sequence-split cache; reduced qwen1.5-4b on
  ``(1, 4)`` splits its kv heads.  An MoE arch routes a data shard's rows
  as one group, so on ``(2, 2)`` it is held to the one-device run of each
  data shard's rows.
* **Reference.**  qwen3-32b, minicpm3-4b and qwen3-moe on ``(1, 4)``
  against the reference's ``prefill`` / ``decode_step`` on the same numpy
  weights (``params_from_numpy``), within ``tests/test_torch_models.py``'s
  atol = rtol = 1e-4.
* **Processes.**  Reduced qwen3-32b on ``(1, 4)`` in 2 spawned gloo
  processes (``launch/sharded.py::serve_check_all``) gives one process's
  bits, and each process's counted collective bytes, call by call, equal
  ``hlo_analysis.serve_step_collectives``'s plan.
* The operators: the merge against one softmax, the split argmax's ties,
  ``shardings.sequence_block``, a decode state's shard and gather, and the
  errors for a layout the split step does not serve.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import transformer as ref_tr
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as sl
from repro_torch.launch.hlo_analysis import serve_step_collectives
from repro_torch.launch.mesh import Mesh, _process_grid, make_mesh
from repro_torch.launch.sharded import serve_check_all, serve_one_device, serve_split
from repro_torch.models import get_model, params_from_numpy, shard_ctx
from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import DecodeState
from repro_torch.train import optim

ARCHS = ("chameleon-34b", "llama4-maverick-400b-a17b", "minicpm3-4b", "qwen1.5-4b",
         "qwen3-32b", "qwen3-moe-235b-a22b", "starcoder2-15b")
MESHES = ((1, 2), (2, 2), (1, 4))
B, PROMPT, CACHE, STEPS = 4, 24, 32, 8
LENS = (24, 20, 13, 7)
TOL = {torch.float32: 1e-5, torch.float64: 1e-9}
REF_TOL = dict(atol=1e-4, rtol=1e-4)       # tests/test_torch_models.py's


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config(arch, dtype=torch.float32):
    return dataclasses.replace(get_arch(arch).reduced, dtype=dtype)


def numpy_weights(cfg, seed: int = 5) -> dict:
    """Every leaf drawn with numpy: the norms' gammas 1 + N(0, 0.1²), the
    biases N(0, 0.1²), the embedding N(0, 0.02²), each product's weights
    N(0, 1) over the square root of the dimensions it contracts (``wq``'s
    ``d``, ``wo``'s heads × head width; the init's ``1 / sqrt(shape[-2])``
    draws the attention's 4-D leaves at ``1 / sqrt(heads)``, whose near
    one-hot attention amplifies float32 rounding step by step, see
    ``tests/test_torch_models.py``)."""
    rng = np.random.default_rng(seed)

    def draw(path, t):
        name = path[-1]
        if t.ndim == 1 or name.startswith("ln") or name.endswith("norm"):
            return 1.0 + 0.1 * rng.standard_normal(t.shape)
        if name in ("bq", "bk", "bv"):
            return 0.1 * rng.standard_normal(t.shape)
        if path == ("embed",):
            return 0.02 * rng.standard_normal(t.shape)
        if name == "wo":
            fan_in = t.shape[-3] * t.shape[-2]
        elif name in ("wq", "wk", "wv", "w_uq", "w_uk", "w_uv"):
            fan_in = t.shape[-3]
        else:
            fan_in = t.shape[-2]
        return rng.standard_normal(t.shape) / np.sqrt(fan_in)

    return {p: draw(p, t).astype(np.float32) for p, t in tree_leaves(get_model(cfg).shapes())}


def weights_of(cfg, arrays: dict) -> dict:
    return optim.tree_from_paths(get_model(cfg).shapes(), {
        p: torch.from_numpy(a).to(cfg.dtype) for p, a in arrays.items()})


def inputs(cfg):
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, PROMPT + STEPS)).astype(np.int32))
    lens = torch.tensor(LENS, dtype=torch.int32)
    forced = torch.stack([tokens[torch.arange(B), (lens + i).long()][:, None]
                          for i in range(STEPS)])
    return tokens[:, :PROMPT], forced, lens


def mesh_of(shape):
    return make_mesh(shape, ("data", "model"), device="cpu")


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def split_run(model, shape, weights, prompts, forced, lens) -> dict:
    """The split run on ``shape`` in this process, its outputs gathered."""
    mesh = mesh_of(shape)
    blocks = sl.shard_tree(weights, mesh, model.specs(mesh))
    out = serve_split(model, mesh, blocks, prompts, forced, lens, CACHE)
    cfg = model.cfg
    return dict(out, prefill_cache=sl.gather_tree(
        out["prefill_cache"], mesh, sl.decode_state_specs(cfg, mesh, B, PROMPT).cache),
        cache=sl.gather_tree(out["cache"], mesh, sl.decode_state_specs(cfg, mesh, B, CACHE).cache))


def one_device_run(model, weights, prompts, forced, lens, groups: int = 1) -> dict:
    """The one-device run, an MoE config's rows in ``groups`` blocks (one a
    data shard) run one after another."""
    n = B // groups
    runs = [serve_one_device(model, weights, prompts[g * n:(g + 1) * n],
                             forced[:, g * n:(g + 1) * n], lens[g * n:(g + 1) * n], CACHE)
            for g in range(groups)]
    cat = lambda key, dim: [torch.cat(ts, dim) for ts in zip(*[r[key] for r in runs])]  # noqa: E731
    return dict(prefill_logits=torch.cat([r["prefill_logits"] for r in runs]),
                prefill_cache=cat("prefill_cache", 1), cache=cat("cache", 1),
                logits=cat("logits", 0), next=cat("next", 0))


# ------------------------------------------------------------ one device
SEQUENCE_SPLIT = {("qwen3-32b", (1, 4)), ("starcoder2-15b", (1, 4)), ("chameleon-34b", (1, 4)),
                  ("qwen3-moe-235b-a22b", (1, 4)), ("llama4-maverick-400b-a17b", (1, 4))} | {
    ("minicpm3-4b", m) for m in MESHES}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_split_serve_matches_one_device(arch, shape, dtype):
    cfg = config(arch, dtype)
    model = get_model(cfg)
    weights = weights_of(cfg, numpy_weights(cfg))
    prompts, forced, lens = inputs(cfg)
    spec = sl.decode_state_specs(cfg, mesh_of(shape), B, CACHE).cache[0]
    assert ("model" in sl.dim_axes(spec, len(spec))[2]) == ((arch, shape) in SEQUENCE_SPLIT)
    if not cfg.mla:                            # the kv heads split where the sequence does not
        assert (spec[3] == "model") == ((arch, shape) not in SEQUENCE_SPLIT)
    got = split_run(model, shape, weights, prompts, forced, lens)
    want = one_device_run(model, weights, prompts, forced, lens, shape[0] if cfg.moe else 1)
    tol = TOL[dtype]
    errs = {"prefill_logits": rel(got["prefill_logits"], want["prefill_logits"])}
    for key in ("prefill_cache", "cache", "logits"):
        assert all(g.shape == w.shape for g, w in zip(got[key], want[key]))
        errs[key] = max(rel(g, w) for g, w in zip(got[key], want[key]))
    assert all(v <= tol for v in errs.values()), errs
    assert all(torch.equal(g, w) for g, w in zip(got["next"], want["next"]))


# ------------------------------------------------------------ reference
@pytest.mark.parametrize("arch", ["qwen3-32b", "minicpm3-4b", "qwen3-moe-235b-a22b"])
def test_split_serve_matches_reference(arch):
    cfg = config(arch)
    ref_cfg = ref_registry.get_arch(arch).reduced
    arrays = numpy_weights(cfg)
    tree = optim.tree_from_paths(get_model(cfg).shapes(), arrays)
    ref_params = jax.tree.map(np.asarray, tree)
    prompts, forced, lens = inputs(cfg)
    got = split_run(get_model(cfg), (1, 4), params_from_numpy(cfg, tree, device="cpu"),
                    prompts, forced, lens)
    hidden, caches = jax.jit(lambda p, x: ref_tr.prefill(ref_cfg, p, x))(ref_params,
                                                                       prompts.numpy())
    logits = ref_tr.unembed(ref_cfg, ref_params, hidden[:, -1:])
    np.testing.assert_allclose(got["prefill_logits"].numpy(), np.asarray(logits), **REF_TOL)
    pad = lambda c: np.pad(np.asarray(c), [(0, 0), (0, 0), (0, CACHE - PROMPT)]  # noqa: E731
                           + [(0, 0)] * (c.ndim - 3))
    for g, w in zip(got["prefill_cache"], caches):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **REF_TOL)
    state = ref_tr.DecodeState(tuple(pad(c) for c in caches), lens.numpy())
    step = jax.jit(lambda p, s, x: ref_tr.decode_step(ref_cfg, p, s, x))
    for i in range(STEPS):
        state, lg = step(ref_params, state, forced[i].numpy())
        np.testing.assert_allclose(got["logits"][i].numpy(), np.asarray(lg), **REF_TOL)
    for g, w in zip(got["cache"], state.cache):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **REF_TOL)


# ------------------------------------------------------------ processes
PROC_CELL = dict(arch="qwen3-32b", reduced=True, layers=2, dtype="float32", mesh=(1, 4),
                 batch=B, prompt=PROMPT, cache=CACHE, steps=STEPS, lens=list(LENS), seed=0,
                 device="cpu", threads=1)


@pytest.fixture(scope="module")
def processes(tmp_path_factory):
    (rec,) = serve_check_all([PROC_CELL], tmp_path_factory.mktemp("serve") / "work", world=2,
                             timeout=120, start="spawn")
    return rec


def test_gloo_processes_serve_bitwise_one_process(processes):
    assert processes["bitwise_one_process"] and processes["next_equal"]
    assert all(v <= TOL[torch.float32] for v in processes["rel"].values()), processes["rel"]


def test_collective_plan_equals_the_gloo_counts(processes):
    model = get_model(config("qwen3-32b"))
    procs = _process_grid(PROC_CELL["mesh"], 2)
    for r, log in enumerate(processes["logs"]):
        mesh = Mesh(PROC_CELL["mesh"], ("data", "model"), torch.device("cpu"), procs, (0, r), {})
        prefill = serve_step_collectives(model, mesh, "prefill", batch=(B, PROMPT)).stats()
        decode = serve_step_collectives(model, mesh, "decode", batch=(B, CACHE)).stats()
        assert set(decode.by_computation) == {"tp_sums", "serve_merge", "serve_argmax"}
        assert log["collective_bytes"] == [prefill.by_type] + [decode.by_type] * STEPS


# ------------------------------------------------------------ operators
def test_merge_equals_one_softmax():
    """Four shards' partial softmaxes over their blocks of 8 positions,
    merged, against one softmax over the 32 (a block with no valid
    position contributes nothing)."""
    from repro_torch.models.attention import _partial_softmax

    g = torch.Generator().manual_seed(0)
    s = torch.randn(3, 2, 32, generator=g, dtype=torch.float64)
    v = torch.randn(3, 32, 5, generator=g, dtype=torch.float64)
    valid = torch.tensor([32, 17, 3])
    tp = shard_ctx.TensorParallel(mesh_of((1, 4)), frozenset({shard_ctx.SEQUENCE}))
    parts = [_partial_softmax(s[..., 8 * j:8 * j + 8],
                              lambda p, j=j: torch.einsum("bhs,bsd->bhd", p, v[:, 8 * j:8 * j + 8]),
                              valid - 8 * j) for j in range(4)]
    mask = torch.arange(32)[None, None, :] < valid[:, None, None]
    want = torch.einsum("bhs,bsd->bhd", torch.softmax(torch.where(mask, s, -torch.inf), -1), v)
    assert float((tp.merge(parts) - want).abs().max()) <= 1e-14


def test_split_argmax_takes_the_lowest_index():
    tp = shard_ctx.TensorParallel(mesh_of((1, 4)), frozenset({"vocab"}))
    logits = torch.zeros(3, 16)
    logits[0, [5, 9]] = 2.0                     # a tie across shards 1 and 2
    logits[1, [12, 13]] = 1.0                   # a tie within shard 3
    logits[2] = -1.0                            # every entry equal
    got = tp.argmax(list(logits.chunk(4, -1)))
    assert got.tolist() == torch.argmax(logits, -1).tolist() == [5, 12, 0]


def test_sequence_block_and_decode_state_blocks():
    cfg = config("qwen3-32b")                   # 2 kv heads: on (1, 4) the sequence splits
    mesh = Mesh((1, 4), ("data", "model"), torch.device("cpu"), (1, 2), (0, 1), {})
    assert sl.sequence_block(cfg, mesh, B, CACHE) == (16, 16)
    assert sl.sequence_block(cfg, mesh_of((1, 2)), B, CACHE) == (0, CACHE)   # kv heads split
    one = mesh_of((2, 2))
    state = DecodeState(tuple(torch.randn(2, B, CACHE, 2, 16) for _ in range(2)),
                        torch.arange(B, dtype=torch.int32))
    specs = sl.decode_state_specs(cfg, one, B, CACHE)
    blocks = sl.shard_tree(state, one, specs)
    assert isinstance(blocks, DecodeState)
    back = sl.gather_tree(blocks, one, specs)
    assert all(torch.equal(a, b) for a, b in zip(back.cache + (back.cache_len,),
                                                 state.cache + (state.cache_len,)))


def test_split_serve_refuses_what_it_cannot_serve():
    tokens = torch.zeros(B, 1, dtype=torch.int32)
    cfg = config("qwen1.5-4b")                  # 4 kv heads: split on (1, 4)
    model = get_model(cfg)
    half = Mesh((1, 4), ("data", "model"), torch.device("cpu"), (1, 2), (0, 0), {})
    whole = model.init_decode_state({"embed": torch.zeros(1)}, B, CACHE)
    with pytest.raises(ValueError, match="not the blocks"):      # every kv head, 2 of 4 shards
        dryrun.serve_step(model, half, {}, whole, tokens)
    cfg = config("qwen3-32b")                   # 2 kv heads on 4, a cache of 30 on 4 shards
    model = get_model(cfg)
    mesh = mesh_of((1, 4))
    blocks = sl.shard_tree(model.init(torch.Generator().manual_seed(0)), mesh, model.specs(mesh))
    state = model.init_decode_state({"embed": torch.zeros(1)}, B, 30)
    with pytest.raises(ValueError, match="not the blocks"):        # 30 positions on 4 shards
        dryrun.serve_step(model, mesh, blocks, state, tokens)
    rwkv = get_model(get_arch("rwkv6-1.6b").reduced)
    with pytest.raises(ValueError, match="decoder family"):
        dryrun.prefill_step(rwkv, mesh, sl.shard_tree(rwkv.init(torch.Generator().manual_seed(0)),
                                                      mesh, rwkv.specs(mesh)),
                            {"tokens": torch.zeros(B, 8, dtype=torch.int32)})
    with pytest.raises(ValueError, match="does not split over the data axes"):
        dryrun.prefill_step(model, mesh_of((4, 1)), sl.shard_tree(
            model.init(torch.Generator().manual_seed(0)), mesh_of((4, 1)),
            model.specs(mesh_of((4, 1)))), {"tokens": torch.zeros(2, 8, dtype=torch.int32)})
