"""The port's SSM core (``repro_torch.models.ssm``) against the reference's,
on the CPU, in float32, on inputs made with numpy from a seed.

* ``chunked_linear_attention`` at the reference's own test cases
  (``tests/test_ssm_core.py``): chunks 1, 4, 7, 16 and 64, inclusive
  (Mamba2) and strict with a bonus (RWKV6), an odd length (29, so the last
  chunk is padded), a carried initial state, and strong decay whose
  cumulative log over a 128-step chunk passes the -60 clamp; output and final state within
  atol = rtol = 1e-5 (the packages sum their einsums in other orders).
* ``linear_attention_step``, both masks, within 1e-5.
* ``rwkv6_block`` and ``mamba2_block`` on reduced configs, with and
  without carried state, the leaves the reference's init makes constant
  redrawn (``tests/torch_towers.py``; the decay base drawn so that the
  ``clip(-8, 4)`` binds): output and every state within 1e-5 of its scale.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import common as ref_common
from repro.models import ssm as ref_ssm
from repro_torch.configs import registry
from repro_torch.models import attention, common, ssm
from torch_towers import redraw_constant_leaves, t

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: torch's intra-op pool would only contend with the other
    test processes and the reference's XLA threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want):
    """``|got - want| <= TOL * scale``, scale = max(1, max |want|)."""
    got, want = got.detach().numpy().astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"largest error {err} at scale {scale}"


def data(seed, B=2, S=29, H=2, Dk=6, Dv=10, w_lo=0.6):
    """q, k, v, w in (w_lo, 0.98) and a bonus, as the reference's test draws
    them (here with numpy)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    q, k, v = f(B, S, H, Dk), f(B, S, H, Dk), f(B, S, H, Dv)
    w = (1 / (1 + np.exp(-f(B, S, H, Dk))) * (0.98 - w_lo) + w_lo).astype(np.float32)
    return q, k, v, w, (0.5 * f(H, Dk)).astype(np.float32)


def both(fn_ref, fn_port, *arrays, **kw):
    """``fn`` of the same arrays in both packages (the port's on tensors; the
    reference's jitted, one compile a case)."""
    static = [k for k in ("inclusive", "chunk") if k in kw]
    want = jax.jit(fn_ref, static_argnames=static)(*arrays, **kw)
    got = fn_port(*(t(a) for a in arrays),
                  **{k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    return got, want


@pytest.mark.parametrize("chunk", [1, 4, 7, 16, 64])
@pytest.mark.parametrize("inclusive", [True, False])
def test_chunked_matches_reference(chunk, inclusive):
    q, k, v, w, bonus = data(chunk * 10 + inclusive)
    kw = dict(bonus=None if inclusive else bonus, inclusive=inclusive, chunk=chunk)
    (o, st), (ro, rst) = both(ref_ssm.chunked_linear_attention, ssm.chunked_linear_attention,
                              q, k, v, np.log(w), **kw)
    assert o.shape == (2, 29, 2, 10) and st.dtype == torch.float32
    close(o, ro)
    close(st, rst)


def test_initial_state_carry_matches_reference():
    q, k, v, w, bonus = data(7, S=24)
    lw = np.log(w)
    s0 = np.random.default_rng(8).standard_normal((2, 2, 6, 10)).astype(np.float32)
    for inclusive in (True, False):
        kw = dict(bonus=None if inclusive else bonus, inclusive=inclusive, chunk=8,
                  initial_state=s0)
        (o, st), (ro, rst) = both(ref_ssm.chunked_linear_attention,
                                  ssm.chunked_linear_attention,
                                  q[:, 10:], k[:, 10:], v[:, 10:], lw[:, 10:], **kw)
        close(o, ro)
        close(st, rst)


def test_strong_decay_reaches_the_clamp():
    """w in (0.05, 0.98) over a 128-step chunk (the full configs' chunk):
    the cumulative log decay passes -60, so the clamp (and the strict
    mask's ``max(cum - lw, -60)``) binds."""
    q, k, v, w, bonus = data(11, S=128, w_lo=0.05)
    lw = np.log(w)
    assert np.cumsum(lw, axis=1).min() < ssm._LOG_MIN
    for inclusive in (True, False):
        kw = dict(bonus=None if inclusive else bonus, inclusive=inclusive, chunk=128)
        (o, st), (ro, rst) = both(ref_ssm.chunked_linear_attention,
                                  ssm.chunked_linear_attention, q, k, v, lw, **kw)
        assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(st).all())
        close(o, ro)
        close(st, rst)


@pytest.mark.parametrize("inclusive", [True, False])
def test_step_matches_reference(inclusive):
    q, k, v, w, bonus = data(3, S=1)
    s0 = np.random.default_rng(4).standard_normal((2, 2, 6, 10)).astype(np.float32)
    kw = dict(bonus=None if inclusive else bonus, inclusive=inclusive)
    (o, st), (ro, rst) = both(ref_ssm.linear_attention_step, ssm.linear_attention_step,
                              q[:, 0], k[:, 0], v[:, 0], w[:, 0], s0, **kw)
    close(o, ro)
    close(st, rst)


# ------------------------------------------------------------------ blocks
def layer0(arch, part, seed):
    """Layer 0 of the reference's reduced ``arch`` (constant leaves
    redrawn), numpy, and the two configs."""
    rcfg, cfg = ref_registry.get_arch(arch).reduced, registry.get_arch(arch).reduced
    tree = ref_common.init_params(rcfg, key=jax.random.key(seed))
    tree = redraw_constant_leaves(jax.tree.map(np.asarray, tree), seed + 1)
    return rcfg, cfg, {k: v[0] for k, v in tree[part].items()}


def gaussian(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("carried", [False, True])
def test_rwkv6_block_matches_reference(carried):
    rcfg, cfg, p = layer0("rwkv6-1.6b", "blocks", 41)
    B, S, d = 2, 21, cfg.d_model
    H, hd = ssm.rwkv6_heads(cfg)
    x = gaussian(42, B, S, d)
    state = ((gaussian(43, B, H, hd, hd), gaussian(44, B, 1, d), gaussian(45, B, 1, d))
             if carried else None)
    want_y, want_st = jax.jit(lambda p, x, s: ref_ssm.rwkv6_block(rcfg, p, x, state=s))(
        p, x, state)
    pt = {k: t(v) for k, v in p.items()}
    y, st = ssm.rwkv6_block(cfg, pt, t(x),
                            state=None if state is None else tuple(t(a) for a in state))
    close(y, want_y)
    for got, want in zip(st, want_st):
        assert tuple(got.shape) == want.shape
        close(got, want)
    # the redrawn decay base and LoRA push some pre-clip decays past both ends
    xa = common.rms_norm(t(x), pt["ln1"], cfg.norm_eps)
    xs = ssm._token_shift(xa, None if state is None else t(state[1]))
    m = xa + (xs - xa) * torch.sigmoid(pt["mu_w"])
    pre = pt["decay_base"] + attention._heads(torch.tanh(m @ pt["decay_lora_a"]),
                                              pt["decay_lora_b"])
    assert bool((pre > 4).any()) and bool((pre < -8).any())


@pytest.mark.parametrize("carried", [False, True])
def test_mamba2_block_matches_reference(carried):
    rcfg, cfg, p = layer0("zamba2-2.7b", "mamba", 51)
    B, S, d, di, N = 2, 19, cfg.d_model, 2 * cfg.d_model, cfg.ssm_state
    x = gaussian(52, B, S, d)
    st0, conv0 = ((gaussian(53, B, di // 64, N, 64), gaussian(54, B, 3, di + 2 * N))
                  if carried else (None, None))
    want_y, (want_s, want_c) = jax.jit(
        lambda p, x, s, c: ref_ssm.mamba2_block(rcfg, p, x, di, state=s, conv_state=c))(
        p, x, st0, conv0)
    y, (s, c) = ssm.mamba2_block(cfg, {k: t(v) for k, v in p.items()}, t(x), di,
                                 state=None if st0 is None else t(st0),
                                 conv_state=None if conv0 is None else t(conv0))
    close(y, want_y)
    assert tuple(s.shape) == want_s.shape == (B, di // 64, N, 64) and s.dtype == torch.float32
    close(s, want_s)
    assert tuple(c.shape) == want_c.shape == (B, 3, di + 2 * N)
    close(c, want_c)


def test_decode_chunk_is_one_step():
    """S = 1 gives chunk 1: RWKV's decode path (the chunked function with an
    initial state) equals the single-step recurrence."""
    q, k, v, w, bonus = data(9, S=1)
    s0 = gaussian(10, 2, 2, 6, 10)
    o, st = ssm.chunked_linear_attention(t(q), t(k), t(v), t(np.log(w)), bonus=t(bonus),
                                         inclusive=False, chunk=64, initial_state=t(s0))
    o1, st1 = ssm.linear_attention_step(t(q[:, 0]), t(k[:, 0]), t(v[:, 0]), t(w[:, 0]), t(s0),
                                        bonus=t(bonus), inclusive=False)
    close(o[:, 0], o1)
    close(st, st1)
