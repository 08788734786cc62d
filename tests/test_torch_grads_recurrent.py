"""Gradients of the port's SSM core and recurrent towers against
``jax.grad`` of the reference's, on the CPU, in float32, on inputs made
with numpy from a seed.

* ``chunked_linear_attention`` with the strict (RWKV6, with a bonus) and
  the inclusive (Mamba2) mask, chunk 16 over S = 45 (the last chunk
  padded) with an initial state, at a decay that stays clear of the −60
  clamp and at one whose cumulative log passes it (asserted): the
  gradients of ``Σ out · c₁ + Σ state · c₂`` with respect to q, k, v, the
  log decay, the bonus and the initial state.  A clamped entry passes no
  gradient in either package.
* ``rwkv6_block`` and ``mamba2_block`` (layer 0 of the towers' weights
  below) with a carried state, S = 21 over chunks of 16: the gradients
  with respect to the input, the state and every parameter.
* ``Model.loss`` and every gradient leaf of rwkv6, zamba2 at 5 layers
  (``n_layers % attn_every ≠ 0`` leaves a trailing mamba layer) and
  seamless-m4t-medium (with encoder frames), and a 6-step loss trajectory
  of each within 1e-4 relative.

RWKV6's ``decay_base`` and ``decay_lora_b`` are drawn for these tests as
N(−1, 0.5²) and N(0, 0.1²) (``torch_towers.TRAIN_DECAY``), every other
constant leaf as the forward tests draw it.  The forward tests' N(0, 4²)
base makes the log decay −exp(4) = −54.6 a step, so the chunk's
cumulative log passes −60 at its second step and the strict mask's
``max(cum − lw, −60)`` then multiplies exp(−5.4) by exp(+54.6) in both
packages: the gradient through the decay becomes float32 noise.  Here the
log decay is about −0.4 a step, so every decay leaf's gradient, that of
``decay_lora_a`` through ``tanh(x·A)·B`` too, is nonzero and held; the
−60 clamp is held at the layer, at decays whose cumulative log passes it.

Gradients within 1e-3 of each leaf's scale, ``max(1, max |g|)``, plus
1e-4 relative (``torch_towers.assert_trees_close``): the two packages'
float32 gradients of these towers differ by up to 7.9e-5 of the scale
(zamba2's ``w_dt``), as far as the reference's lie from a float64 run; a
wrong or missing term shows at 1e-1 or more.  The layer tests' inputs are
of order 1, held at 1e-5 of their scale.  Losses within 1e-5 relative;
steps under the eps rule of ``test_torch_grads_dense.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import ssm as ref_ssm
from repro.train import optim as ref_optim
from repro_torch.configs import registry
from repro_torch.models import common, get_model, params_from_numpy, ssm
from repro_torch.train import AdamWConfig, make_train_step, optim
from repro_torch.train.step import value_and_grad
from torch_towers import (TRAIN_DECAY, assert_trees_close, lm_batch_np, reference_params,
                          reference_value_and_grad, t, torch_batch)

# zamba2 at 5 layers: 2 attention sites of 2 mamba layers and a trailing one
CASES = ["rwkv6-1.6b", "zamba2-2.7b+rem", "seamless-m4t-medium"]
B, S = 2, 16
LAYER_TOL = dict(atol=1e-5, rtol=1e-4)     # atol of the leaf's scale
TOWER_TOL = dict(atol=1e-3, rtol=1e-4)
LOSS_RTOL = 1e-5
STEP_CFG = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=8)   # the eps rule


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: torch's intra-op pool would only contend with the other
    test processes and the reference's XLA threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def grads_of(fn, tree, cot):
    """Gradients of ``Σ fn(tree) · cot`` (over fn's outputs) for a numpy
    tree: ``(port grads as a flat dict of tensors, the leaves' paths)``."""
    tp = common.tree_map(lambda a: t(a).requires_grad_(True), tree)
    leaves = common.tree_leaves(tp)
    outs = fn(tp)
    total = sum(torch.sum(o.float() * t(c)) for o, c in zip(outs, cot))
    got = torch.autograd.grad(total, [a for _, a in leaves])
    return {"/".join(path): g for (path, _), g in zip(leaves, got)}


def ref_grads_of(fn, tree, cot):
    def f(tr):
        return sum(jnp.sum(o.astype(jnp.float32) * c) for o, c in zip(fn(tr), cot))

    g = jax.jit(jax.grad(f))(tree)
    return {"/".join(path): np.asarray(a) for path, a in common.tree_leaves(g)}


def assert_decay_grads_held(grads, atol):
    """Each RWKV6 decay leaf's reference gradient lies far above the
    comparison's tolerance, so a port that lost its path would fail."""
    for name in ("decay_base", "decay_lora_a", "decay_lora_b"):
        assert np.abs(np.asarray(grads[name])).max() > 10 * atol, name


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("clamped", [False, True])
@pytest.mark.parametrize("inclusive", [True, False])
def test_chunked_linear_attention_grads(inclusive, clamped):
    rng = np.random.default_rng(11 + clamped)
    Bq, Sq, H, Dk, Dv = 2, 45, 2, 6, 8
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    lo, hi = (0.001, 0.05) if clamped else (0.6, 0.98)
    w = (lo + (hi - lo) / (1 + np.exp(-f(Bq, Sq, H, Dk)))).astype(np.float32)
    tree = {"q": f(Bq, Sq, H, Dk), "k": f(Bq, Sq, H, Dk), "v": f(Bq, Sq, H, Dv),
            "lw": np.log(w), "s0": f(Bq, H, Dk, Dv)}
    if not inclusive:
        tree["bonus"] = (0.5 * f(H, Dk)).astype(np.float32)
    cot = [f(Bq, Sq, H, Dv), f(Bq, H, Dk, Dv)]
    reaches = np.cumsum(tree["lw"][:, :16], axis=1).min() < ssm._LOG_MIN   # the first chunk
    assert reaches == clamped

    def call(mod):
        return lambda tr: mod.chunked_linear_attention(
            tr["q"], tr["k"], tr["v"], tr["lw"], bonus=tr.get("bonus"), inclusive=inclusive,
            chunk=16, initial_state=tr["s0"])

    got = grads_of(call(ssm), tree, cot)
    want = ref_grads_of(call(ref_ssm), tree, cot)
    assert_trees_close(got, want, **LAYER_TOL)


def configs(case):
    arch, _, rem = case.partition("+")
    rcfg, cfg = ref_registry.get_arch(arch).reduced, registry.get_arch(arch).reduced
    if rem:
        rcfg, cfg = (dataclasses.replace(c, n_layers=5) for c in (rcfg, cfg))
    return rcfg, cfg


@pytest.fixture(scope="module")
def params_of():
    """``params_of(case)``: the reference's own init of the case's reduced
    config, the constant leaves redrawn (numpy; the decay's as TRAIN_DECAY),
    made once."""
    made = {}

    def get(case):
        if case not in made:
            made[case] = reference_params(configs(case)[0], seed=91, draws=TRAIN_DECAY)
        return made[case]

    return get


@pytest.mark.parametrize("case", ["rwkv6-1.6b", "zamba2-2.7b+rem"])
def test_block_grads_with_carried_state(params_of, case):
    """Layer 0 of the towers' weights (``params_of``), a seeded input and a
    carried state (S = 21 over chunks of 16)."""
    part = "blocks" if case.startswith("rwkv6") else "mamba"
    rcfg, cfg = configs(case)
    p = {k: v[0] for k, v in params_of(case)[part].items()}
    rng = np.random.default_rng(42)
    d = cfg.d_model
    x = rng.standard_normal((2, 21, d)).astype(np.float32)
    if part == "blocks":
        H, hd = ssm.rwkv6_heads(cfg)
        state = [rng.standard_normal((2, H, hd, hd)).astype(np.float32),
                 rng.standard_normal((2, 1, d)).astype(np.float32),
                 rng.standard_normal((2, 1, d)).astype(np.float32)]

        def call(mod):
            def run(tr):
                y, (s, a, b) = mod.rwkv6_block(tr["cfg"], tr["p"], tr["x"],
                                               state=tuple(tr["state"]))
                return y, s, a, b
            return run
    else:
        di = 2 * d
        H = di // ssm.MAMBA_HEAD
        state = [rng.standard_normal((2, H, cfg.ssm_state, ssm.MAMBA_HEAD)).astype(np.float32),
                 rng.standard_normal((2, 3, di + 2 * cfg.ssm_state)).astype(np.float32)]

        def call(mod):
            def run(tr):
                y, (s, c) = mod.mamba2_block(tr["cfg"], tr["p"], tr["x"], di,
                                             state=tr["state"][0], conv_state=tr["state"][1])
                return y, s, c
            return run

    tree = {"p": p, "x": x, "state": {str(i): s for i, s in enumerate(state)}}

    def with_cfg(mod, c):
        run = call(mod)
        return lambda tr: run({"cfg": c, "p": tr["p"], "x": tr["x"],
                               "state": [tr["state"][str(i)] for i in range(len(state))]})

    outs = with_cfg(ssm, cfg)(common.tree_map(t, tree))
    cot = [rng.standard_normal(tuple(o.shape)).astype(np.float32) for o in outs]
    got = grads_of(with_cfg(ssm, cfg), tree, cot)
    want = ref_grads_of(with_cfg(ref_ssm, rcfg), tree, cot)
    assert_trees_close(got, want, **LAYER_TOL, what=case)
    if part == "blocks":
        assert_decay_grads_held({k[2:]: v for k, v in want.items() if k.startswith("p/")},
                                LAYER_TOL["atol"])


# ------------------------------------------------------------- the towers
@pytest.fixture(scope="module")
def reference(params_of):
    made = {}

    def get(case):
        if case not in made:
            rcfg, _ = configs(case)
            params = params_of(case)
            batch = lm_batch_np(rcfg, 92, B, S)
            fn = reference_value_and_grad(rcfg)
            (loss, metrics), grads = fn(params, batch)
            made[case] = dict(params=params, batch=batch, fn=fn, loss=float(loss),
                              metrics={k: float(v) for k, v in metrics.items()},
                              grads=jax.tree.map(np.asarray, grads))
        return made[case]

    return get


def port(ref, case):
    cfg = configs(case)[1]
    return cfg, get_model(cfg), params_from_numpy(cfg, ref["params"], device="cpu")


def test_zamba_rem_case_has_trailing_layers():
    cfg = configs("zamba2-2.7b+rem")[1]
    assert cfg.n_layers % cfg.attn_every != 0


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_match_reference(reference, case):
    ref = reference(case)
    cfg, model, params = port(ref, case)
    loss, metrics, grads = value_and_grad(model, params, torch_batch(ref["batch"]))
    assert rel(float(loss), ref["loss"]) <= LOSS_RTOL
    assert rel(float(metrics["ce"]), ref["metrics"]["ce"]) <= LOSS_RTOL
    assert float(metrics["aux"]) == ref["metrics"]["aux"] == 0.0
    assert_trees_close(grads, ref["grads"], **TOWER_TOL, what=case)
    if case.startswith("rwkv6"):
        assert_decay_grads_held(ref["grads"]["blocks"], TOWER_TOL["atol"])


@pytest.mark.parametrize("case", CASES)
def test_six_step_loss_trajectory(reference, case):
    """Six seeded batches: the reference's jitted grads and its AdamW
    (jitted) against ``make_train_step``, losses within 1e-4 relative."""
    ref = reference(case)
    cfg, model, params = port(ref, case)
    rocfg, ocfg = ref_optim.AdamWConfig(**STEP_CFG), AdamWConfig(**STEP_CFG)
    update = jax.jit(lambda st, p, g: ref_optim.update(rocfg, st, p, g))
    rp, ro = ref["params"], ref_optim.init(rocfg, ref["params"])
    step = make_train_step(model, ocfg, donate=True)
    opt = optim.init(ocfg, params)
    for i in range(6):
        batch = lm_batch_np(cfg, 300 + i, B, S)
        (want, _), grads = ref["fn"](rp, batch)
        rp, ro, _ = update(ro, rp, grads)
        params, opt, metrics = step(params, opt, torch_batch(batch))
        assert rel(float(metrics["loss"]), float(want)) <= 1e-4, (case, i)
