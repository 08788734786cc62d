"""What the LM-tower parity tests share: the reference's reduced towers with
the leaves its init makes constant redrawn, and one jitted run of each.

The reference's init zeroes RWKV6's bonus, decay base, decay LoRA and every
token-shift mix, and Mamba2's ``dt_bias`` and ``a_log``, and sets Mamba2's
``d_skip`` and both families' ``gn`` to ones.  At those values a port that
dropped the bonus, the LoRA decay or the shift mix would still match the
reference bit for bit, so every parity test first redraws them with numpy
from a seed (the same arrays go to both packages).  ``decay_base`` is drawn
wide, so that the reference's ``clip(-8, 4)`` binds on some entries.
"""
import jax
import numpy as np
import torch

from repro.models import encdec as ref_encdec
from repro.models.api import get_model as ref_get_model

ZERO_LEAVES = {"mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ffn_k", "bonus", "decay_lora_b",
               "dt_bias", "a_log"}
ONE_LEAVES = {"d_skip", "gn"}
DECAY_BASE_STD = 4.0          # P(|N(0, 4)| > 4) ~ 0.32: the clip at 4 binds


def redraw_constant_leaves(tree, seed: int):
    """A copy of the numpy tree ``tree`` with the constant leaves redrawn:
    zeros as N(0, 0.5²), ones as 1 + N(0, 0.3²), ``decay_base`` as N(0, 4²)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            if k in ZERO_LEAVES:
                v = 0.5 * rng.standard_normal(v.shape)
            elif k in ONE_LEAVES:
                v = 1.0 + 0.3 * rng.standard_normal(v.shape)
            elif k == "decay_base":
                v = DECAY_BASE_STD * rng.standard_normal(v.shape)
            out[k] = np.asarray(v, dtype=t[k].dtype)
        return out

    return walk(tree)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def reference_run(cfg, *, seed: int, B: int, S: int, steps: int, enc_len: int = 6):
    """The reference's tower ``cfg`` (its own init at ``seed``, constant
    leaves redrawn) over seeded tokens: the forward's hidden states, aux and
    caches (encdec: ``encode`` and ``decode_train``), and the logits of
    ``steps`` decode steps, one jit compile of each."""
    model = ref_get_model(cfg)
    params = redraw_constant_leaves(jax.tree.map(np.asarray, model.init(jax.random.key(seed))),
                                    seed + 1)
    rng = np.random.default_rng(seed + 2)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    out = dict(params=params, toks=toks)
    if cfg.family == "encdec":
        frames = rng.standard_normal((B, enc_len, cfg.d_model)).astype(np.float32)

        def run(p, x, f):
            enc = ref_encdec.encode(cfg, p, f)
            return enc, ref_encdec.decode_train(cfg, p, x, enc)

        enc, hidden = jax.jit(run)(params, toks, frames)
        state = model.init_decode_state((params, frames), B, S)
        out.update(frames=frames, enc_out=np.asarray(enc), hidden=np.asarray(hidden))
    else:
        kw = dict(collect_cache=True) if cfg.family in ("decoder", "zamba2") else {}
        hidden, aux, caches = jax.jit(lambda p, x: model.forward(p, x, **kw))(params, toks)
        state = model.init_decode_state(params, B, S)
        out.update(hidden=np.asarray(hidden), aux=float(aux),
                   caches=None if caches is None else [np.asarray(c) for c in caches])
    out["init_state"] = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state)
    step = jax.jit(model.decode_step)
    logits = []
    for i in range(steps):
        state, lg = step(params, state, toks[:, i:i + 1])
        logits.append(np.asarray(lg))
    out["logits"] = logits
    return out


def shape_leaves(tree) -> list:
    """``(shape, dtype name)`` of every leaf of a state (tuples and named
    tuples in field order, dicts by sorted key)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in shape_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in shape_leaves(v)]
    return [(tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]


def tensor_leaves(state) -> list:
    """The tensors of a decode state (nested tuples and named tuples)."""
    if isinstance(state, tuple):
        return [x for v in state for x in tensor_leaves(v)]
    return [state]

