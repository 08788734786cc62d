"""The port's LM towers (``repro_torch.models``) and arch registry
(``repro_torch.configs``) against the reference, on the CPU, in float32.

Inputs are made with numpy from a seed; the reference's weights come from
its own ``Model.init`` and are carried across with ``params_from_numpy``.

* Layers: ``rms_norm``, ``rope``, ``swiglu``, the tanh GELU and
  ``expand_kv`` within 1e-6; ``flash_attention`` at the reference's own
  test shapes (ragged chunks, non-causal, a q offset) and at GQA 8:2, and
  ``decode_attention``, within 1e-5.  The two packages order their float32
  sums differently (XLA's einsums against PyTorch's matmuls), so the
  results agree to rounding, not bit for bit.
* The five dense archs' reduced configs: ``forward``'s hidden states,
  ``prefill``'s caches and 12 ``decode_step`` logits within atol = rtol =
  1e-4 (two layers of float32 rounding on values of order 1-4), and
  ``init_cache``'s shapes and dtypes.
* Full-width parameter counts over ``meta`` tensors against the
  reference's shape-mode count (nothing allocated) and the known numbers.
* The registry: the same archs, shapes and skips; ``input_specs`` of the
  same shapes and dtypes.  The other families (MoE, rwkv6, zamba2,
  encdec; their parity is in ``test_torch_moe.py`` and
  ``test_torch_recurrent.py``) init and run, and ``loss`` gives a finite
  scalar with ``ce`` and ``aux`` for all ten archs, and one train step
  changes the parameters (the reference's ``test_arch_smoke.py``; the
  gradients are held against the reference in
  ``test_torch_grads_*.py``).
"""
import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import registry as ref_registry
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import transformer as ref_tr
from repro.models.api import get_model as ref_get_model
from repro_torch.configs import registry
from repro_torch.models import attention, common, get_model, params_from_numpy
from repro_torch.models import transformer as tr

DENSE = ["chameleon-34b", "minicpm3-4b", "qwen1.5-4b", "qwen3-32b", "starcoder2-15b"]
OTHER = ["llama4-maverick-400b-a17b", "qwen3-moe-235b-a22b", "rwkv6-1.6b",
         "seamless-m4t-medium", "zamba2-2.7b"]
FULL_PARAMS = {"qwen1.5-4b": 3_950_369_280, "minicpm3-4b": 4_261_902_848,
               "qwen3-32b": 32_762_123_264, "starcoder2-15b": 15_955_630_080,
               "chameleon-34b": 34_293_436_416}
B, S = 2, 12
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: torch's intra-op pool would only contend with the other
    test processes and the reference's XLA threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ------------------------------------------------------------------ layers
def gaussian(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_rms_norm_rope_swiglu_gelu_expand_kv():
    x = gaussian(0, 2, 5, 4, 16)
    gamma = gaussian(1, 16)
    close(common.rms_norm(t(x), t(gamma)), ref_common.rms_norm(x, gamma), atol=1e-6)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32) + 3, (2, 5))
    close(common.rope(t(x), t(pos), 10_000.0), ref_common.rope(x, pos, 10_000.0), atol=1e-6)
    h, wg, wu, wd = gaussian(2, 3, 16), gaussian(3, 16, 24), gaussian(4, 16, 24), gaussian(5, 24, 16)
    h, wg, wu, wd = h / 4, wg / 4, wu / 4, wd / 4
    close(common.swiglu(t(h), t(wg), t(wu), t(wd)), ref_common.swiglu(h, wg, wu, wd), atol=1e-6)
    close(F.gelu(t(x), approximate="tanh"), jax.nn.gelu(x), atol=1e-6)
    k = gaussian(6, 2, 5, 2, 8)
    got = attention.expand_kv(t(k), 8)
    assert np.array_equal(got.numpy(), np.asarray(ref_attn.expand_kv(k, 8)))
    assert torch.equal(got, torch.repeat_interleave(t(k), 4, dim=2))


@pytest.mark.parametrize("Sq,Sk,causal,qc,kc,H,KV,q_offset", [
    (16, 16, True, 4, 4, 4, 2, 0), (32, 32, True, 16, 8, 4, 2, 0),
    (8, 24, False, 4, 8, 4, 2, 0), (33, 33, True, 7, 5, 4, 2, 0),
    (8, 24, True, 4, 8, 4, 2, 16), (8, 8, True, 512, 1024, 8, 2, 0),
    (40, 40, True, 16, 16, 8, 2, 0),
])
def test_flash_attention_matches_reference(Sq, Sk, causal, qc, kc, H, KV, q_offset):
    q, k, v = gaussian(7, 2, Sq, H, 8), gaussian(8, 2, Sk, KV, 8), gaussian(9, 2, Sk, KV, 8)
    kw = dict(causal=causal, q_offset=q_offset, q_chunk=qc, kv_chunk=kc)
    got = attention.flash_attention(t(q), t(k), t(v), **kw)
    close(got, ref_attn.flash_attention(q, k, v, **kw), atol=1e-5)


def test_decode_attention_matches_reference():
    q, kc, vc = gaussian(10, 3, 1, 8, 8), gaussian(11, 3, 10, 2, 8), gaussian(12, 3, 10, 2, 8)
    lens = np.array([1, 6, 10], np.int32)
    got = attention.decode_attention(t(q), t(kc), t(vc), t(lens))
    close(got, ref_attn.decode_attention(q, kc, vc, lens), atol=1e-5)


# ------------------------------------------------------------- dense archs
@pytest.fixture(scope="module")
def reference():
    """``reference(arch)``: the reference's reduced model of ``arch``, made
    once a module: weights, tokens, prefill hidden states and caches, and
    the logits of 12 decode steps (one jit compile of each an arch)."""
    made = {}

    def get(arch):
        if arch not in made:
            cfg = ref_registry.get_arch(arch).reduced
            params = ref_get_model(cfg).init(jax.random.key(3))
            toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, S)).astype(np.int32)
            hidden, caches = jax.jit(lambda p, x: ref_tr.prefill(cfg, p, x))(params, toks)
            step = jax.jit(lambda p, s, x: ref_tr.decode_step(cfg, p, s, x))
            state, logits = ref_tr.init_cache(cfg, B, S), []
            for i in range(S):
                state, lg = step(params, state, toks[:, i:i + 1])
                logits.append(np.asarray(lg))
            made[arch] = dict(params=jax.tree.map(np.asarray, params), toks=toks,
                              hidden=np.asarray(hidden), caches=[np.asarray(c) for c in caches],
                              logits=logits, init_cache=ref_tr.init_cache(cfg, B, S))
        return made[arch]

    return get


def port(ref, arch):
    cfg = registry.get_arch(arch).reduced
    return cfg, params_from_numpy(cfg, ref["params"], device="cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_forward_hidden_matches_reference(reference, arch):
    ref = reference(arch)
    cfg, params = port(ref, arch)
    hidden, aux, caches = get_model(cfg).forward(params, t(ref["toks"]))
    assert caches is None and aux == 0.0
    close(hidden, ref["hidden"], **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_caches_match_reference(reference, arch):
    ref = reference(arch)
    cfg, params = port(ref, arch)
    hidden, caches = get_model(cfg).prefill(params, {"tokens": t(ref["toks"])})
    close(hidden, ref["hidden"], **TOL)
    assert len(caches) == len(ref["caches"]) == 2
    for got, want in zip(caches, ref["caches"]):
        assert tuple(got.shape) == want.shape
        close(got, want, **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_reference(reference, arch):
    ref = reference(arch)
    cfg, params = port(ref, arch)
    model = get_model(cfg)
    state = model.init_decode_state(params, B, S)
    for i in range(S):
        state, logits = model.decode_step(params, state, t(ref["toks"][:, i:i + 1]))
        close(logits, ref["logits"][i], **TOL)
    assert state.cache_len.tolist() == [S] * B and state.cache_len.dtype == torch.int32


@pytest.mark.parametrize("arch", DENSE)
def test_init_cache_shapes(reference, arch):
    cfg = registry.get_arch(arch).reduced
    want = reference(arch)["init_cache"]
    got = tr.init_cache(cfg, B, S, device="cpu")
    for g, w in zip(list(got.cache) + [got.cache_len], list(want.cache) + [want.cache_len]):
        assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype}"
        assert not g.any()
    if cfg.mla:   # the latent cache: kv_lora + rope_head_dim a token
        assert got.cache[0].shape[-1] == cfg.kv_lora_rank
        assert got.cache[1].shape[-1] == cfg.rope_head_dim


@pytest.mark.parametrize("arch", DENSE)
def test_full_param_count(arch):
    cfg = registry.get_arch(arch).config
    assert cfg.param_count() == ref_registry.get_arch(arch).config.param_count()
    assert cfg.param_count() == FULL_PARAMS[arch] == cfg.active_param_count()
    shapes = get_model(cfg).shapes()
    assert shapes["embed"].device.type == "meta" and shapes["embed"].dtype == torch.bfloat16


def test_params_from_numpy_rejects_another_tree(reference):
    cfg = registry.get_arch("qwen1.5-4b").reduced
    tree = dict(reference("qwen1.5-4b")["params"])
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(cfg, {k: v for k, v in tree.items() if k != "ln_f"}, device="cpu")
    with pytest.raises(ValueError, match="ln_f"):
        params_from_numpy(cfg, dict(tree, ln_f=np.ones(3, np.float32)), device="cpu")


def test_init_draws_the_reference_scales():
    """The port's own init: one generator, normal leaves at 1/sqrt(fan-in)
    (0.02 for ``embed``), zeros for biases, ones for norms."""
    cfg = registry.get_arch("qwen1.5-4b").reduced
    a = get_model(cfg).init(torch.Generator().manual_seed(0))
    b = get_model(cfg).init(torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(common.tree_leaves(a),
                                                            common.tree_leaves(b)))
    assert abs(float(a["embed"].std()) - 0.02) < 0.002
    assert abs(float(a["blocks"]["mlp"]["w_down"].std()) - cfg.d_ff ** -0.5) < 0.01
    assert not a["blocks"]["attn"]["bq"].any() and bool((a["ln_f"] == 1).all())


# ----------------------------------------------------------------- registry
def test_registry_matches_reference():
    assert registry.list_archs() == ref_registry.list_archs()
    assert {k: vars(v) for k, v in registry.SHAPES.items()} == \
        {k: vars(v) for k, v in ref_registry.SHAPES.items()}
    for arch in registry.list_archs():
        spec, ref = registry.get_arch(arch), ref_registry.get_arch(arch)
        assert (spec.module, spec.tag) == (ref.module, ref.tag)
        for shape in registry.SHAPES:
            assert spec.skip_reason(shape) == ref.skip_reason(shape)
        for cfg, rcfg in ((spec.config, ref.config), (spec.reduced, ref.reduced)):
            mine, theirs = dict(vars(cfg)), dict(vars(rcfg))
            assert str(mine.pop("dtype")) == f"torch.{np.dtype(theirs.pop('dtype'))}"
            assert mine == theirs
    with pytest.raises(KeyError):
        registry.get_arch("gpt-5")


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", DENSE)
def test_input_specs_match_reference(arch):
    cfg, rcfg = registry.get_arch(arch).config, ref_registry.get_arch(arch).config
    for name, shape in registry.SHAPES.items():
        got = leaves(registry.input_specs(cfg, shape))
        want = leaves(ref_registry.input_specs(rcfg, ref_registry.SHAPES[name]))
        assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want], name
        assert [str(g.dtype) for g in got] == [f"torch.{w.dtype}" for w in want], name
        assert all(g.device.type == "meta" for g in got)
    small = registry.input_specs(registry.get_arch(arch).reduced, registry.SHAPES["decode_32k"],
                                 concrete=True, batch_override=2, seq_override=16, device="cpu")
    assert small["tokens"].shape == (2, 1) and small["state"].cache[0].shape[2] == 16
    assert not small["state"].cache[0].any()


def lm_batch_for(cfg, B=1, S=4):
    """A small batch: zero tokens, labels 1, a full mask (frames for encdec)."""
    b = {"tokens": torch.zeros((B, S), dtype=torch.int32),
         "labels": torch.ones((B, S), dtype=torch.int32), "mask": torch.ones((B, S))}
    if cfg.family == "encdec":
        b["frames"] = torch.zeros((B, 3, cfg.d_model))
    return b


def assert_finite_loss(model, params, batch):
    loss, metrics = model.loss(params, batch)
    assert loss.shape == () and bool(torch.isfinite(loss)) and set(metrics) == {"ce", "aux"}
    assert abs(float(loss) - float(metrics["ce"]) - float(metrics["aux"])) <= 1e-5


@pytest.mark.parametrize("arch", OTHER)
def test_other_families_raise_naming_their_slice(arch):
    """The families ported after the dense towers init and run (encdec
    through ``prefill``, with frames), and their ``loss`` is a finite
    scalar with ``ce`` and ``aux`` (it raised until item 9's slice 3)."""
    cfg = registry.get_arch(arch).reduced
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 4), dtype=torch.int32)
    if cfg.family == "encdec":
        hidden, _ = model.prefill(params, {"tokens": toks,
                                           "frames": torch.zeros((1, 3, cfg.d_model))})
    else:
        hidden = model.forward(params, toks)[0]
    assert hidden.shape == (1, 4, cfg.d_model) and bool(torch.isfinite(hidden).all())
    assert_finite_loss(model, params, lm_batch_for(cfg))


@pytest.mark.parametrize("arch", registry.list_archs())
def test_loss_raises_naming_slice_3(arch):
    """Item 9's slice 3 is ported: every arch's ``loss`` is a finite scalar
    with ``ce`` and ``aux``, and one train step changes the parameters (the
    reference's ``test_forward_and_train_step``)."""
    from repro_torch.train import AdamWConfig, make_train_step, optim

    model = get_model(registry.get_arch(arch).reduced)
    params = model.init(torch.Generator().manual_seed(1))
    batch = lm_batch_for(model.cfg, B=2, S=8)
    assert_finite_loss(model, params, batch)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    new, _, metrics = make_train_step(model, ocfg, donate=False)(
        params, optim.init(ocfg, params), batch)
    assert bool(torch.isfinite(metrics["loss"]))
    delta = sum(float((a.float() - b.float()).abs().sum())
                for (_, a), (_, b) in zip(common.tree_leaves(params), common.tree_leaves(new)))
    assert delta > 0, f"{arch}: no parameter update"
