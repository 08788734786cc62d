"""The port's recurrent and encoder-decoder towers (``models/ssm``,
``rwkv_model``, ``zamba``, ``encdec``) and the registry's specs against
the reference, on the CPU, in float32.

The reference's weights come from its own ``Model.init`` with the leaves it
makes constant redrawn (``tests/torch_towers.py``), carried across with
``params_from_numpy``; tokens and frames are made with numpy from a seed.

* rwkv6, zamba2 (reduced: 4 layers, two shared-attention sites; and 5
  layers, so that a trailing mamba layer runs after the last site) and
  seamless-m4t-medium: ``forward`` (encdec: ``encode`` and
  ``decode_train``), ``prefill`` (zamba2's per-site caches), 12 decode
  steps' logits within atol = rtol = 1e-4 (two to five layers of float32
  rounding, the dense towers' tolerance), and ``init_decode_state``'s
  shapes and dtypes.
* Full-width parameter counts over ``meta`` tensors against the
  reference's and the known numbers.
* ``registry.input_specs`` and ``decode_state_specs`` of all ten archs at
  the four shapes: the reference's shapes and dtypes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro_torch.configs import registry
from repro_torch.models import get_model, params_from_numpy
from torch_towers import reference_run, shape_leaves, t, tensor_leaves

TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 12
FULL_PARAMS = {"rwkv6-1.6b": 1_583_892_480, "zamba2-2.7b": 2_422_386_848,
               "seamless-m4t-medium": 978_806_784}
CASES = ["rwkv6-1.6b", "zamba2-2.7b", "zamba2-2.7b+rem", "seamless-m4t-medium"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: torch's intra-op pool would only contend with the other
    test processes and the reference's XLA threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(case):
    """(reference config, port config) of a case: an arch's reduced config,
    or with ``+rem`` zamba2's at 5 layers (2 sites of 2, one trailing)."""
    arch, _, rem = case.partition("+")
    rcfg, cfg = ref_registry.get_arch(arch).reduced, registry.get_arch(arch).reduced
    if rem:
        rcfg, cfg = (dataclasses.replace(c, n_layers=5) for c in (rcfg, cfg))
    return rcfg, cfg


@pytest.fixture(scope="module")
def reference():
    made = {}

    def get(case):
        if case not in made:
            made[case] = reference_run(configs(case)[0], seed=31, B=B, S=S, steps=S)
        return made[case]

    return get


def port(ref, case):
    cfg = configs(case)[1]
    return cfg, get_model(cfg), params_from_numpy(cfg, ref["params"], device="cpu")


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_zamba_rem_case_has_trailing_layers():
    from repro_torch.models import zamba

    cfg = configs("zamba2-2.7b+rem")[1]
    assert zamba._groups(cfg) == (2, 2, 1)
    assert zamba._groups(configs("zamba2-2.7b")[1]) == (2, 2, 0)


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_reference(reference, case):
    ref = reference(case)
    cfg, model, params = port(ref, case)
    if cfg.family == "encdec":
        from repro_torch.models import encdec

        enc = encdec.encode(cfg, params, t(ref["frames"]))
        close(enc, ref["enc_out"])
        close(encdec.decode_train(cfg, params, t(ref["toks"]), enc), ref["hidden"])
        with pytest.raises(ValueError, match="encdec"):
            model.forward(params, t(ref["toks"]))
        return
    hidden, aux, caches = model.forward(params, t(ref["toks"]))
    assert aux == 0.0 == ref["aux"] and caches is None
    close(hidden, ref["hidden"])


@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_reference(reference, case):
    ref = reference(case)
    cfg, model, params = port(ref, case)
    batch = {"tokens": t(ref["toks"])}
    if cfg.family == "encdec":
        batch["frames"] = t(ref["frames"])
    hidden, caches = model.prefill(params, batch)
    close(hidden, ref["hidden"])
    if cfg.family != "zamba2":
        assert caches is None
        return
    sites = configs(case)[1].n_layers // cfg.attn_every
    assert len(caches) == len(ref["caches"]) == 2
    for got, want in zip(caches, ref["caches"]):
        assert tuple(got.shape) == want.shape == (sites, B, S, cfg.n_kv_heads, cfg.hd)
        close(got, want)


@pytest.mark.parametrize("case", CASES)
def test_decode_steps_match_reference(reference, case):
    ref = reference(case)
    cfg, model, params = port(ref, case)
    src = (params, t(ref["frames"])) if cfg.family == "encdec" else params
    state = model.init_decode_state(src, B, S)
    for i in range(S):
        state, logits = model.decode_step(params, state, t(ref["toks"][:, i:i + 1]))
        close(logits, ref["logits"][i])
    assert state.cache_len.tolist() == [S] * B and state.cache_len.dtype == torch.int32


@pytest.mark.parametrize("case", CASES)
def test_init_decode_state_shapes(reference, case):
    ref = reference(case)
    cfg, model, params = port(ref, case)
    src = (params, t(ref["frames"])) if cfg.family == "encdec" else params
    got = model.init_decode_state(src, B, S)
    assert type(got).__name__ == type(ref["init_state"]).__name__
    assert got._fields == ref["init_state"]._fields
    assert shape_leaves(got) == shape_leaves(ref["init_state"])
    if cfg.family != "encdec":         # encdec's holds the encoded frames' K/V
        assert all(not a.any() for a in tensor_leaves(got))
    else:
        with pytest.raises(ValueError, match="encdec"):
            model.init_decode_state(params, B, S)


@pytest.mark.parametrize("arch", sorted(FULL_PARAMS))
def test_full_param_count(arch):
    cfg = registry.get_arch(arch).config
    assert cfg.param_count() == ref_registry.get_arch(arch).config.param_count()
    assert cfg.param_count() == FULL_PARAMS[arch] == cfg.active_param_count()
    assert get_model(cfg).shapes()["embed"].device.type == "meta"


@pytest.mark.parametrize("arch", registry.list_archs())
def test_input_and_decode_state_specs_match_reference(arch):
    cfg, rcfg = registry.get_arch(arch).config, ref_registry.get_arch(arch).config
    for name, shape in registry.SHAPES.items():
        got = shape_leaves(registry.input_specs(cfg, shape))
        want = shape_leaves(ref_registry.input_specs(rcfg, ref_registry.SHAPES[name]))
        assert got == want, name
        assert all(a.device.type == "meta" for a in tensor_leaves(
            registry.decode_state_specs(cfg, 2, 64)))
    assert shape_leaves(registry.decode_state_specs(cfg, 3, 40)) == \
        shape_leaves(ref_registry.decode_state_specs(rcfg, 3, 40))
    small = registry.decode_state_specs(registry.get_arch(arch).reduced, 2, 16, concrete=True,
                                        device="cpu")
    assert all(a.device.type == "cpu" and not a.any() for a in tensor_leaves(small))
