"""Gradients of the port's dense towers against ``jax.grad`` of the
reference's, on the CPU, in float32.

Inputs are made with numpy from a seed; the reference's weights come from
its own ``Model.init`` and are carried across with ``params_from_numpy``.

* ``lm_loss`` at chunk 5 over S = 17 (a padded last chunk) with a random
  mask: the loss within 1e-5 relative, its gradients (hidden states and
  ``unembed``) within atol = 1e-5, rtol = 1e-4; chunked against one chunk.
* ``cfg.remat`` on and off give the same loss and gradients, bit for bit
  (the checkpointed blocks recompute the same operations).
* ``flash_attention``'s gradients at S = 17 with 8-wide tiles, where the
  last q tile holds padded rows that every key masks: within the
  gradient tolerance, and no NaN.
* ``Model.loss`` (loss, ``ce``, ``aux``) and every gradient leaf (within
  1e-4 of the leaf's scale, ``max(1, max |g|)``, plus 1e-4 relative:
  ``torch_towers.assert_trees_close`` says why the scale; over two seeds
  the two packages' float32 gradients differ by at most 2.4e-5 of the
  scale, in qwen1.5-4b's ``embed``) of the
  five dense reduced archs (qkv bias, MLA, qk-norm, the GELU MLP) and of
  qwen1.5-4b with ``tie_embeddings=True`` (no registry arch ties, and
  ``lm_loss`` then reads ``embed.T``).
* One whole ``make_train_step`` of qwen1.5-4b against the reference's
  AdamW on the reference's gradients, and a 6-step loss trajectory
  against the reference's within 1e-4 relative.  Adam's first step is
  ``lr · sign(g)`` where ``|g| ≫ eps``, so a gradient element near zero
  whose sign differs by rounding moves its parameter by 2·lr: steps are
  held with ``AdamWConfig(eps=1e-3)``, where the update is smooth in
  ``g``, parameters within 1e-6.

One jitted reference ``value_and_grad`` an arch, shared by the module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import transformer as ref_tr
from repro.train import optim as ref_optim
from repro_torch.configs import registry
from repro_torch.models import attention, common, get_model, params_from_numpy
from repro_torch.models import transformer as tr
from repro_torch.train import AdamWConfig, make_train_step, optim
from repro_torch.train.step import value_and_grad
from torch_towers import (assert_trees_close, lm_batch_np, reference_params,
                          reference_value_and_grad, t, torch_batch)

DENSE = ["chameleon-34b", "minicpm3-4b", "qwen1.5-4b", "qwen3-32b", "starcoder2-15b"]
CASES = DENSE + ["qwen1.5-4b+tied"]
B, S = 2, 16
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)      # the layers' gradients
TOWER_TOL = dict(atol=1e-4, rtol=1e-4)     # atol of each gradient leaf's scale
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


def configs(case):
    """(reference config, port config): an arch's reduced config, or with
    ``+tied`` qwen1.5-4b's with tied embeddings."""
    arch, _, tied = case.partition("+")
    rcfg, cfg = ref_registry.get_arch(arch).reduced, registry.get_arch(arch).reduced
    if tied:
        rcfg, cfg = (dataclasses.replace(c, tie_embeddings=True) for c in (rcfg, cfg))
    return rcfg, cfg


@pytest.fixture(scope="module")
def ref_update():
    """The reference's AdamW step under the eps rule, jitted once."""
    rocfg = ref_optim.AdamWConfig(**STEP_CFG)
    return rocfg, jax.jit(lambda st, p, g: ref_optim.update(rocfg, st, p, g))


@pytest.fixture(scope="module")
def reference():
    """``reference(case)``: weights, a batch, and the reference's jitted
    ``value_and_grad`` of ``Model.loss`` with its result on them."""
    made = {}

    def get(case):
        if case not in made:
            rcfg, _ = configs(case)
            params = reference_params(rcfg, seed=71)
            batch = lm_batch_np(rcfg, 72, B, S)
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


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


# ------------------------------------------------------------------ layers
def test_lm_loss_matches_reference():
    """Chunk 5 over S = 17: four chunks, the last padded by 3; a random mask."""
    rng = np.random.default_rng(5)
    kw = dict(family="decoder", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32,
              vocab=40, logits_chunk=5)
    rcfg = ref_common.ModelConfig(dtype=np.float32, **kw)
    cfg = common.ModelConfig(dtype=torch.float32, **kw)
    hidden = rng.standard_normal((2, 17, 16)).astype(np.float32)
    unembed = (rng.standard_normal((16, 40)) / 4).astype(np.float32)
    labels = rng.integers(0, 40, (2, 17)).astype(np.int32)
    mask = (rng.random((2, 17)) < 0.7).astype(np.float32)

    def ref_loss(h, w):
        return ref_tr.lm_loss(rcfg, {"unembed": w}, h, labels, mask)

    want, (want_h, want_w) = jax.jit(jax.value_and_grad(ref_loss, argnums=(0, 1)))(hidden,
                                                                            unembed)
    h, w = t(hidden).requires_grad_(True), t(unembed).requires_grad_(True)
    got = tr.lm_loss(cfg, {"unembed": w}, h, t(labels), t(mask))
    got_h, got_w = torch.autograd.grad(got, (h, w))
    got = got.detach()
    assert rel(float(got), float(want)) <= LOSS_RTOL
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **GRAD_TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **GRAD_TOL)
    whole = tr.lm_loss(dataclasses.replace(cfg, logits_chunk=64), {"unembed": w}, h,
                       t(labels), t(mask))
    assert rel(float(whole), float(got)) <= 1e-6


def test_remat_does_not_change_loss():
    """The reference's test, bit for bit: remat recomputes the same ops."""
    kw = dict(family="decoder", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
              vocab=64, dtype=torch.float32)
    m1 = get_model(common.ModelConfig(**kw, remat=False))
    m2 = get_model(common.ModelConfig(**kw, remat=True))
    p = m1.init(torch.Generator().manual_seed(0))
    b = torch_batch(lm_batch_np(m1.cfg, 1, 2, 8, masked=False))
    l1, _, g1 = value_and_grad(m1, p, b)
    l2, _, g2 = value_and_grad(m2, p, b)
    assert torch.equal(l1, l2)
    for (path, a), (_, c) in zip(common.tree_leaves(g1), common.tree_leaves(g2)):
        assert torch.equal(a, c), path


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grads_with_padded_tiles(causal):
    """S = 17 in tiles of 8: the third q tile has 7 padded rows, fully
    masked; their backward must give zeros, not NaN (``l`` clamped at
    1e-30, −inf masked by ``where``)."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((2, 17, h, 8)).astype(np.float32) for h in (4, 2, 2))
    cot = rng.standard_normal((2, 17, 4, 8)).astype(np.float32)
    kw = dict(causal=causal, q_chunk=8, kv_chunk=8)

    def ref_f(q, k, v):
        return jnp.sum(ref_attn.flash_attention(q, k, v, **kw) * cot)

    want = jax.jit(jax.grad(ref_f, argnums=(0, 1, 2)))(q, k, v)
    ins = [t(a).requires_grad_(True) for a in (q, k, v)]
    out = torch.sum(attention.flash_attention(*ins, **kw) * t(cot))
    got = torch.autograd.grad(out, ins)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


# ------------------------------------------------------------- the towers
@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_match_reference(reference, case):
    ref = reference(case)
    cfg, model, params = port(ref, case)
    assert ("unembed" in params) != cfg.tie_embeddings
    loss, metrics, grads = value_and_grad(model, params, torch_batch(ref["batch"]))
    assert rel(float(loss), ref["loss"]) <= LOSS_RTOL
    assert rel(float(metrics["ce"]), ref["metrics"]["ce"]) <= LOSS_RTOL
    assert float(metrics["aux"]) == ref["metrics"]["aux"] == 0.0
    assert_trees_close(grads, ref["grads"], **TOWER_TOL, what=case)


def test_train_step_matches_reference(reference, ref_update):
    """One step: the port's make_train_step against the reference's AdamW
    on the reference's own gradients (the eps rule)."""
    ref = reference("qwen1.5-4b")
    cfg, model, params = port(ref, "qwen1.5-4b")
    rocfg, update = ref_update
    want_p, want_o, want_stats = update(ref_optim.init(rocfg, ref["params"]), ref["params"],
                                        ref["grads"])
    ocfg = AdamWConfig(**STEP_CFG)
    step = make_train_step(model, ocfg, donate=False)
    got_p, got_o, stats = step(params, optim.init(ocfg, params), torch_batch(ref["batch"]))
    assert rel(float(stats["grad_norm"]), float(want_stats["grad_norm"])) <= 1e-5
    assert rel(float(stats["lr"]), float(want_stats["lr"])) <= 1e-6
    assert int(got_o.step) == int(want_o.step) == 1
    assert_trees_close(got_p, jax.tree.map(np.asarray, want_p), atol=1e-6, rtol=0,
                       what="params after a step")
    assert_trees_close(got_o.m, jax.tree.map(np.asarray, want_o.m), atol=1e-6, rtol=1e-4)


def test_six_step_loss_trajectory(reference, ref_update):
    """Six steps on six seeded batches: the reference's (its jitted grads,
    its AdamW) against ``make_train_step``, losses within 1e-4 relative."""
    ref = reference("qwen1.5-4b")
    cfg, model, params = port(ref, "qwen1.5-4b")
    (rocfg, update), ocfg = ref_update, AdamWConfig(**STEP_CFG)
    rp, ro = ref["params"], ref_optim.init(rocfg, ref["params"])
    step = make_train_step(model, ocfg, donate=True)
    opt = optim.init(ocfg, params)
    for i in range(6):
        batch = lm_batch_np(cfg, 100 + i, B, S)
        (want, _), grads = ref["fn"](rp, batch)
        rp, ro, _ = update(ro, rp, grads)
        params, opt, metrics = step(params, opt, torch_batch(batch))
        assert rel(float(metrics["loss"]), float(want)) <= 1e-4, i
