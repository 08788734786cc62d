"""Gradients of randomly initialised towers at full depth, against
``jax.grad`` of the reference's, on the CPU, in float32 and bfloat16.

The reference's own init makes a deep tower's gradients grow layer by
layer from the loss back to the embedding, by many decades: at full width
on the card, qwen1.5-4b's reach 1.8e18 (``embed``) and rwkv6-1.6b's
gradient norm 4.8e7, which is why ``train/optim.py::global_norm`` scales
by a power of two before it squares.  These tests show that the growth is
the reference's and not a fault of the port's backward, at the full
depth and narrow widths:

* qwen1.5-4b at 40 layers with d = 256 and 2 heads, so the head width
  (128) and ``d / n_heads`` (128, the scale of the init's ``wq``/``wk``
  columns) are the full width's, and attention is as near one-hot;
* rwkv6-1.6b at 24 layers at its reduced widths, the init's constant
  leaves as the init makes them (as on the card).

Each layer's gradient norm (over every ``blocks`` leaf) is compared.  Both
packages grow by the same decades from the last layer to the first
(asserted above ``GROWTH_MIN``).  rwkv6 in float32 agrees layer for layer
within 1e-2 relative (read: 2.0e-3).  Elsewhere rounding is amplified as
the gradients grow: qwen1.5-4b's per-layer norms in float32 lie up to
1.01 decades from the reference's, and the reference's own lie up to
0.54 decades from themselves when its weights are moved by one float32
ulp (``2^-23`` relative noise, asserted above ``SELF_DECADES_MIN``); in bfloat16 the port lies up to 1.08
(qwen1.5-4b) and 0.89 (rwkv6) decades from the reference, and the
reference's own float32 and bfloat16 runs lie 0.9 decades apart at
qwen1.5-4b's first layer.  So the
per-layer bound is 1.5 decades; a backward fault that compounded per layer
would miss it by tens of decades.  ``global_norm`` of the port's
gradients equals their float64 norm within 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models.api import get_model as ref_get_model
from repro_torch.configs import registry
from repro_torch.models import common, get_model, params_from_numpy
from repro_torch.train import optim
from repro_torch.train.step import value_and_grad
from torch_towers import lm_batch_np, reference_value_and_grad, torch_batch

B, S = 2, 32
DEEP = {
    "qwen1.5-4b": dict(n_layers=40, d_model=256, n_heads=2, n_kv_heads=2, d_ff=512),
    "rwkv6-1.6b": dict(n_layers=24),
}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GROWTH_MIN = 1e3          # first layer's gradient norm over the last layer's
DECADES_MAX = 1.5         # per-layer |log10(port / reference)|
RWKV_F32_RTOL = 1e-2      # rwkv6 in float32: per layer, relative
SELF_DECADES_MIN = 0.3    # qwen1.5-4b float32: the reference against itself
LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: torch's intra-op pool would only contend with the other
    test processes and the reference's XLA threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def per_layer_norm(tree) -> np.ndarray:
    """The gradient norm of each layer over every ``blocks`` leaf (float64)."""
    sq = 0.0
    for path, leaf in common.tree_leaves(tree):
        if path[0] == "blocks":
            a = leaf.float().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            sq = sq + np.square(a.astype(np.float64).reshape(a.shape[0], -1)).sum(1)
    return np.sqrt(sq)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", sorted(DEEP))
def test_deep_gradient_growth_is_the_reference(arch, dtype):
    jdt, tdt = DTYPES[dtype]
    rcfg = dataclasses.replace(ref_registry.get_arch(arch).reduced, dtype=jdt, **DEEP[arch])
    cfg = dataclasses.replace(registry.get_arch(arch).reduced, dtype=tdt, **DEEP[arch])
    params = jax.tree.map(np.asarray, jax.jit(ref_get_model(rcfg).init)(jax.random.key(5)))
    batch = lm_batch_np(rcfg, 7, B, S, masked=False)
    ref_fn = reference_value_and_grad(rcfg)
    (want_loss, _), want = ref_fn(params, batch)
    loss, _, got = value_and_grad(get_model(cfg), params_from_numpy(cfg, params, device="cpu"),
                                  torch_batch(batch))
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL[dtype] * abs(float(want_loss))

    ref_layers, port_layers = per_layer_norm(want), per_layer_norm(got)
    assert np.isfinite(port_layers).all() and len(port_layers) == DEEP[arch]["n_layers"]
    for layers in (ref_layers, port_layers):
        assert layers[0] / layers[-1] > GROWTH_MIN, (arch, dtype, layers[0], layers[-1])
    if arch == "rwkv6-1.6b" and dtype == "float32":
        np.testing.assert_allclose(port_layers, ref_layers, rtol=RWKV_F32_RTOL)
    decades = np.abs(np.log10(port_layers / ref_layers)).max()
    assert decades <= DECADES_MAX, (arch, dtype, decades)
    if arch == "qwen1.5-4b" and dtype == "float32":
        # the reference against itself, its weights moved by one ulp
        rng = np.random.default_rng(8)
        nudged = jax.tree.map(
            lambda a: (a * (1 + 2.0 ** -23 * rng.choice([-1, 0, 1], a.shape))).astype(a.dtype),
            params)
        self_decades = np.abs(np.log10(per_layer_norm(ref_fn(nudged, batch)[1])
                                       / ref_layers)).max()
        assert self_decades >= SELF_DECADES_MIN

    flat = [leaf.float().numpy().astype(np.float64) for _, leaf in common.tree_leaves(got)]
    norm64 = np.sqrt(sum(np.square(a).sum() for a in flat))
    assert abs(float(optim.global_norm(got)) - norm64) <= 1e-6 * norm64
