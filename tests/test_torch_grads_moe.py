"""Gradients of the port's MoE FFN and MoE towers against ``jax.grad`` of
the reference's, on the CPU, in float32, on inputs made with numpy from a
seed.

* ``moe_ffn`` on the three configs of ``test_torch_moe.py`` (top-2 of 8;
  top-1 with a shared expert; ``capacity_factor = 0.25``, where
  assignments are dropped, asserted) and on a router with two equal
  columns (exact ties, the lower expert first): the gradients of
  ``Σ out · c + aux`` for a seeded cotangent ``c``, with respect to the
  input and every parameter.  The router's top-k and the capacity drops
  carry no gradient; the gate values and the Switch aux's ``mean_p`` do.
  The gradient of the aux alone with respect to the router and the input
  is held too: its largest element is 2.8e-4 (1.8e-3 with the ties), under
  the towers' tolerance, so only a check of its own shows a port that
  lost it.
* qwen3-moe and llama4-maverick reduced (llama4's interleaved dense/MoE
  stacks): ``Model.loss`` with its aux and every gradient leaf, and a
  6-step loss trajectory of qwen3-moe against the reference's.

The FFN's gradients within 1e-5 of each leaf's scale, ``max(1, max |g|)``,
plus 1e-4 relative (``torch_towers.assert_trees_close``): the two
packages differ there by at most 2.1e-6 of the scale (``top1_shared``).
The aux's gradients within 1e-5 of their own largest element plus 1e-4
relative: they differ by at most 2.1e-6 of it (the ties' input).  The
towers' gradients within 1e-3 of each leaf's scale plus 1e-4 relative:
the two packages' float32 gradients of the reduced towers differ by up
to 5.2e-4 of a leaf's scale (llama4-maverick's ``embed`` at another
seed; its dense blocks' near one-hot attention amplifies rounding), so
1e-4 of the scale would fail correct code.  Losses within 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import common as ref_common
from repro.models import moe as ref_moe
from repro.train import optim as ref_optim
from repro_torch.configs import registry
from repro_torch.models import common, get_model, moe, params_from_numpy
from repro_torch.train import AdamWConfig, make_train_step, optim
from repro_torch.train.step import value_and_grad
from torch_towers import (assert_trees_close, lm_batch_np, reference_params,
                          reference_value_and_grad, t, torch_batch)

MOE_ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"]
# test_torch_moe.py's three configs, and its router with tied columns
FFN_CONFIGS = {
    "top2_of_8": dict(n_experts=8, top_k=2),
    "top1_shared": dict(n_experts=8, top_k=1, n_shared_experts=1),
    "capacity_0.25": dict(n_experts=8, top_k=2, capacity_factor=0.25),
}
FFN_CASES = sorted(FFN_CONFIGS) + ["ties"]
B, S = 2, 16
FFN_TOL = dict(atol=1e-5, rtol=1e-4)      # atol of each leaf's scale
GRAD_TOL = dict(atol=1e-3, rtol=1e-4)
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


# ---------------------------------------------------------------- the FFN
def ffn_setup(case, seed):
    """Both configs, the reference's MoE parameters of one layer (numpy)
    and a seeded (3, 16, 32) input."""
    kw = dict(family="decoder", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=48,
              moe=True, moe_d_ff=48, **FFN_CONFIGS[case])
    rcfg = ref_common.ModelConfig(dtype=np.float32, **kw)
    cfg = common.ModelConfig(dtype=torch.float32, **kw)
    b = ref_common.ParamBuilder(rcfg, "init", key=jax.random.key(seed))
    p = jax.tree.map(np.asarray, ref_moe.build_moe_params(rcfg, b, prefix_layers=False))
    x = np.random.default_rng(seed + 1).standard_normal((3, 16, 32)).astype(np.float32)
    return rcfg, cfg, p, x


@pytest.mark.parametrize("case", FFN_CASES)
def test_moe_ffn_grads_match_reference(case):
    # test_torch_moe.py's seeds: 0 (drops only at capacity 0.25), 3 for the ties
    rcfg, cfg, p, x = ffn_setup("top2_of_8" if case == "ties" else case,
                                seed=3 if case == "ties" else 0)
    if case == "ties":      # columns 2 and 5 equal: their probabilities tie exactly
        w = p["router"].copy()
        w[:, 5] = w[:, 2] = 4.0 * w[:, 2]
        p = dict(p, router=w)
    cot = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def ref_f(p, x):
        out, aux = ref_moe._moe_ffn_local(rcfg, p, x)
        return jnp.sum(out * cot) + aux

    want_p, want_x = jax.jit(jax.grad(ref_f, argnums=(0, 1)))(p, x)
    tp = common.tree_map(lambda a: t(a).requires_grad_(True), p)
    xt = t(x).requires_grad_(True)
    out, aux = moe.moe_ffn(cfg, tp, xt)
    leaves = common.tree_leaves(tp)
    got = torch.autograd.grad(torch.sum(out * t(cot)) + aux, [a for _, a in leaves] + [xt])
    got_tree = {"x": got[-1], **{"/".join(path): g for (path, _), g in zip(leaves, got)}}
    want_tree = {"x": np.asarray(want_x),
                 **{"/".join(path): np.asarray(g) for path, g in common.tree_leaves(want_p)}}
    assert_trees_close(got_tree, want_tree, **FFN_TOL, what=case)
    gate_idx = moe._router(cfg, t(x).reshape(-1, 32), t(p["router"]))[0]
    if case == "capacity_0.25":
        assert moe.dropped_assignments(cfg, gate_idx) > 0
    if case == "ties":
        assert int(((gate_idx[:, 0] == 2) & (gate_idx[:, 1] == 5)).sum()) >= 5


@pytest.mark.parametrize("case", FFN_CASES)
def test_moe_aux_grad_matches_reference(case):
    """The gradient of the Switch aux alone with respect to the router and
    the input: it flows only through ``mean_p`` (the routed fractions carry
    none), held within 1e-5 of its own largest element."""
    rcfg, cfg, p, x = ffn_setup("top2_of_8" if case == "ties" else case,
                                seed=3 if case == "ties" else 0)
    if case == "ties":
        w = p["router"].copy()
        w[:, 5] = w[:, 2] = 4.0 * w[:, 2]
        p = dict(p, router=w)

    def ref_aux(router, x):
        return ref_moe._moe_ffn_local(rcfg, dict(p, router=router), x)[1]

    want = [np.asarray(g) for g in jax.jit(jax.grad(ref_aux, argnums=(0, 1)))(p["router"], x)]
    router, xt = t(p["router"]).requires_grad_(True), t(x).requires_grad_(True)
    tp = dict(common.tree_map(t, p), router=router)
    got = torch.autograd.grad(moe.moe_ffn(cfg, tp, xt)[1], [router, xt])
    for name, g, w in zip(("router", "x"), got, want):
        scale = float(np.abs(w).max())
        assert scale > 0, (case, name)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * scale, rtol=1e-4,
                                   err_msg=f"{case} d aux / d {name}")


# ------------------------------------------------------------- the towers
@pytest.fixture(scope="module")
def reference():
    made = {}

    def get(arch):
        if arch not in made:
            rcfg = ref_registry.get_arch(arch).reduced
            params = reference_params(rcfg, seed=81)
            batch = lm_batch_np(rcfg, 82, B, S)
            fn = reference_value_and_grad(rcfg)
            (loss, metrics), grads = fn(params, batch)
            made[arch] = dict(params=params, batch=batch, fn=fn, loss=float(loss),
                              metrics={k: float(v) for k, v in metrics.items()},
                              grads=jax.tree.map(np.asarray, grads))
        return made[arch]

    return get


def port(ref, arch):
    cfg = registry.get_arch(arch).reduced
    return cfg, get_model(cfg), params_from_numpy(cfg, ref["params"], device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grads_match_reference(reference, arch):
    ref = reference(arch)
    cfg, model, params = port(ref, arch)
    loss, metrics, grads = value_and_grad(model, params, torch_batch(ref["batch"]))
    assert rel(float(loss), ref["loss"]) <= LOSS_RTOL
    assert rel(float(metrics["ce"]), ref["metrics"]["ce"]) <= LOSS_RTOL
    assert ref["metrics"]["aux"] > 0 and rel(float(metrics["aux"]), ref["metrics"]["aux"]) <= 1e-5
    assert_trees_close(grads, ref["grads"], **GRAD_TOL, what=arch)


def test_six_step_loss_trajectory(reference):
    """qwen3-moe, six seeded batches: the reference's jitted grads and its
    AdamW (jitted) against ``make_train_step``, losses within 1e-4."""
    arch = "qwen3-moe-235b-a22b"
    ref = reference(arch)
    cfg, model, params = port(ref, arch)
    rocfg, ocfg = ref_optim.AdamWConfig(**STEP_CFG), AdamWConfig(**STEP_CFG)
    update = jax.jit(lambda st, p, g: ref_optim.update(rocfg, st, p, g))
    rp, ro = ref["params"], ref_optim.init(rocfg, ref["params"])
    step = make_train_step(model, ocfg, donate=True)
    opt = optim.init(ocfg, params)
    for i in range(6):
        batch = lm_batch_np(cfg, 200 + i, B, S)
        (want, _), grads = ref["fn"](rp, batch)
        rp, ro, _ = update(ro, rp, grads)
        params, opt, metrics = step(params, opt, torch_batch(batch))
        assert rel(float(metrics["loss"]), float(want)) <= 1e-4, i
