"""The port's MoE FFN (``repro_torch.models.moe``) and the MoE towers
(qwen3-moe; llama4's interleaved dense/MoE super-layers) against the
reference, on the CPU, in float32, on inputs made with numpy from a seed.

* ``moe_ffn`` against the reference's ``_moe_ffn_local`` (the path it
  takes without a mesh) on three configs: top-2 of 8 experts; top-1 with a
  shared expert; ``capacity_factor = 0.25``, where assignments are dropped
  (asserted).  Outputs within 1e-5 (float32 products summed in other
  orders), the Switch aux within 1e-6.
* A router with two equal columns forces exact ties: the expert choices
  are bitwise the reference's (``lax.top_k`` keeps the lower expert).
* qwen3-moe and llama4-maverick reduced: ``forward``'s hidden states and
  aux, ``prefill``'s caches, 12 decode steps' logits within atol = rtol =
  1e-4, and ``init_decode_state``'s shapes and dtypes.
* Full-width ``param_count``/``active_param_count`` over ``meta`` tensors
  against the reference's shape-mode counts (nothing allocated), and the
  known numbers, also for the depth cuts ``chip_smoke.py`` runs at full
  width (qwen3-moe at 6 layers, llama4-maverick at 2).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import common as ref_common
from repro.models import moe as ref_moe
from repro_torch.configs import registry
from repro_torch.models import common, get_model, moe, params_from_numpy
from torch_towers import reference_run, shape_leaves, t

B, S = 2, 12
TOL = dict(atol=1e-4, rtol=1e-4)
MOE_ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"]
# (n_layers, param_count, active_param_count): full, and the depth chip_smoke.py runs
COUNTS = {"qwen3-moe-235b-a22b": [(94, 235_093_634_560, 22_190_763_520),
                                  (6, 16_171_193_856, 2_581_648_896)],
          "llama4-maverick-400b-a17b": [(48, 400_711_848_960, 17_184_691_200),
                                        (2, 18_679_096_320, 2_698_798_080)]}
FFN_CASES = {
    "top2_of_8": dict(n_experts=8, top_k=2),
    "top1_shared": dict(n_experts=8, top_k=1, n_shared_experts=1),
    "capacity_0.25": dict(n_experts=8, top_k=2, capacity_factor=0.25),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: torch's intra-op pool would only contend with the other
    test processes and the reference's XLA threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- the FFN
def ffn_setup(case, seed=0):
    """Both configs, the reference's MoE parameters of one layer (numpy)
    and a seeded (B, S, d) input."""
    kw = dict(family="decoder", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=48,
              moe=True, moe_d_ff=48, **FFN_CASES[case])
    rcfg = ref_common.ModelConfig(dtype=np.float32, **kw)
    cfg = common.ModelConfig(dtype=torch.float32, **kw)
    b = ref_common.ParamBuilder(rcfg, "init", key=jax.random.key(seed))
    p = jax.tree.map(np.asarray, ref_moe.build_moe_params(rcfg, b, prefix_layers=False))
    x = np.random.default_rng(seed + 1).standard_normal((3, 16, 32)).astype(np.float32)
    return rcfg, cfg, p, x


def port_tree(p):
    return {k: port_tree(v) if isinstance(v, dict) else t(v) for k, v in p.items()}


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_reference_local_path(case):
    rcfg, cfg, p, x = ffn_setup(case)
    want, want_aux = jax.jit(lambda p, x: ref_moe._moe_ffn_local(rcfg, p, x))(p, x)
    got, aux = moe.moe_ffn(cfg, port_tree(p), t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    gate_idx = moe._router(cfg, t(x).reshape(-1, 32), t(p["router"]))[0]
    dropped = moe.dropped_assignments(cfg, gate_idx)
    assert (dropped > 0) == (case == "capacity_0.25"), dropped
    assert moe.capacity(cfg, 48) == min(max(int(48 * cfg.top_k / 8 * cfg.capacity_factor) + 1,
                                            4), 48 * cfg.top_k)


def test_router_ties_keep_the_lower_expert():
    """Columns 2 and 5 of the router are equal (and large), so their
    probabilities tie exactly and are the top choice for many tokens: the
    reference's ``lax.top_k`` takes expert 2 first, and so must the port."""
    rcfg, cfg, p, x = ffn_setup("top2_of_8", seed=3)
    w = p["router"].copy()
    w[:, 5] = w[:, 2] = 4.0 * w[:, 2]
    p = dict(p, router=w)
    xt = x.reshape(-1, 32)
    want_idx, want_vals, _, _ = ref_moe._router(rcfg, xt, w)
    got_idx, got_vals, _, _ = moe._router(cfg, t(xt), t(w))
    probs = torch.softmax(t(xt) @ t(w), dim=-1)
    assert torch.equal(probs[:, 2], probs[:, 5])
    tied_first = (got_idx[:, 0] == 2) & (got_idx[:, 1] == 5)
    assert int(tied_first.sum()) >= 5
    assert np.array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_vals.numpy(), np.asarray(want_vals), atol=1e-6)
    want, _ = ref_moe._moe_ffn_local(rcfg, p, x)
    got, _ = moe.moe_ffn(cfg, port_tree(p), t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_top_k_stable_orders_ties_by_index():
    x = torch.tensor([[0.1, 0.4, 0.4, 0.1, 0.4], [0.0, 0.0, 0.0, 0.0, 0.0]])
    vals, idx = moe.top_k_stable(x, 3)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]
    rv, ri = jax.lax.top_k(x.numpy(), 3)
    assert np.array_equal(idx.numpy(), np.asarray(ri)) and np.array_equal(vals, np.asarray(rv))


# ------------------------------------------------------------- the towers
@pytest.fixture(scope="module")
def reference():
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = reference_run(ref_registry.get_arch(arch).reduced, seed=61, B=B, S=S,
                                       steps=S)
        return made[arch]

    return get


def port(ref, arch):
    cfg = registry.get_arch(arch).reduced
    return cfg, get_model(cfg), params_from_numpy(cfg, ref["params"], device="cpu")


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_hidden_and_aux_match_reference(reference, arch):
    ref = reference(arch)
    cfg, model, params = port(ref, arch)
    hidden, aux, caches = model.forward(params, t(ref["toks"]))
    assert caches is None and ref["aux"] > 0
    close(hidden, ref["hidden"])
    assert abs(float(aux) - ref["aux"]) <= 1e-6
    if cfg.moe_every > 1:   # llama4, 4 layers: 2 super-layers of a dense and an MoE block
        assert params["dense_blocks"]["mlp"]["w_up"].shape == (2, 64, 128)
        assert params["blocks"]["moe"]["shared"]["w_up"].shape == (2, 64, 64)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_caches_match_reference(reference, arch):
    ref = reference(arch)
    cfg, model, params = port(ref, arch)
    hidden, caches = model.prefill(params, {"tokens": t(ref["toks"])})
    close(hidden, ref["hidden"])
    for got, want in zip(caches, ref["caches"], strict=True):
        assert tuple(got.shape) == want.shape == (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
        close(got, want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_steps_match_reference(reference, arch):
    ref = reference(arch)
    cfg, model, params = port(ref, arch)
    state = model.init_decode_state(params, B, S)
    assert shape_leaves(state) == shape_leaves(ref["init_state"])
    for i in range(S):
        state, logits = model.decode_step(params, state, t(ref["toks"][:, i:i + 1]))
        close(logits, ref["logits"][i])
    assert state.cache_len.tolist() == [S] * B


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_and_cut_param_counts(arch):
    for n_layers, total, active in COUNTS[arch]:
        cfg = dataclasses.replace(registry.get_arch(arch).config, n_layers=n_layers)
        rcfg = dataclasses.replace(ref_registry.get_arch(arch).config, n_layers=n_layers)
        assert cfg.param_count() == rcfg.param_count() == total
        assert cfg.active_param_count() == rcfg.active_param_count() == active
    shapes = get_model(registry.get_arch(arch).config).shapes()
    assert shapes["blocks"]["moe"]["experts"]["w_gate"].device.type == "meta"
