"""What the LM-tower parity tests share: the reference's reduced towers with
the leaves its init makes constant redrawn, and one jitted run of each;
for the gradient tests, seeded numpy batches, one jitted
``value_and_grad`` of the reference's ``Model.loss`` an arch, and the
comparison of two gradient trees leaf by leaf.

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
# RWKV6's decay for the gradient tests: the log decay -exp(base + LoRA) is
# about -0.4 a step, so a chunk's cumulative log stays well above the -60
# clamp and every decay leaf's gradient, decay_lora_a's too, is nonzero
TRAIN_DECAY = {"decay_base": (-1.0, 0.5), "decay_lora_b": (0.0, 0.1)}


def redraw_constant_leaves(tree, seed: int, draws=None):
    """A copy of the numpy tree ``tree`` with the constant leaves redrawn:
    zeros as N(0, 0.5²), ones as 1 + N(0, 0.3²), ``decay_base`` as N(0, 4²);
    ``draws`` maps a leaf name to the ``(mean, std)`` drawn in its place
    (the same standard normals are drawn, so the other leaves' values do
    not change)."""
    rng = np.random.default_rng(seed)
    draws = dict(draws or {})

    def walk(t):
        out = {}
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            if k in ZERO_LEAVES:
                mean, std = 0.0, 0.5
            elif k in ONE_LEAVES:
                mean, std = 1.0, 0.3
            elif k == "decay_base":
                mean, std = 0.0, DECAY_BASE_STD
            else:
                out[k] = np.asarray(v, dtype=v.dtype)
                continue
            mean, std = draws.get(k, (mean, std))
            out[k] = np.asarray(mean + std * rng.standard_normal(v.shape), dtype=v.dtype)
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


def lm_batch_np(cfg, seed: int, B: int, S: int, *, enc_len: int = 6, masked: bool = True):
    """A seeded numpy LM batch: random tokens and labels, a random 0/1 mask
    (about 80 % ones, every row keeping its first position) or ones, and
    encoder frames for the encdec family."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, S)) < 0.8) if masked else np.ones((B, S), bool)
    mask[:, 0] = True
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "mask": mask.astype(np.float32)}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((B, enc_len, cfg.d_model)).astype(np.float32)
    return b


def reference_params(cfg, seed: int, draws=None) -> dict:
    """The reference's own init of ``cfg`` at ``seed`` (numpy), the constant
    leaves redrawn (``draws`` as in :func:`redraw_constant_leaves`)."""
    params = jax.jit(ref_get_model(cfg).init)(jax.random.key(seed))   # one compile
    return redraw_constant_leaves(jax.tree.map(np.asarray, params), seed + 1, draws)


def reference_value_and_grad(cfg):
    """One jitted ``value_and_grad`` of the reference's ``Model.loss``:
    ``(params, batch) -> ((loss, metrics), grads)``."""
    return jax.jit(jax.value_and_grad(ref_get_model(cfg).loss, has_aux=True))


def torch_batch(batch: dict) -> dict:
    return {k: t(v) for k, v in batch.items()}


def flat(tree) -> list:
    """``(path, leaf)`` of a tree of nested dicts in sorted key order."""
    if isinstance(tree, dict):
        return [(k,) + path_leaf for k in sorted(tree) for path_leaf in flat(tree[k])]
    return [(np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree),)]


def assert_trees_close(got, want, *, atol: float, rtol: float, what: str = "") -> float:
    """Every leaf of ``got`` (tensors) within ``atol · scale + rtol·|want|``
    of ``want``'s (numpy), the same paths, ``scale = max(1, max |want|)``
    of the leaf; returns the largest error over the scale.

    The scale: a gradient leaf's float32 rounding error is a fraction of
    the leaf's largest terms, not of each element.  Reduced qwen1.5-4b's
    ``embed`` gradient reaches 8.4 (the embeddings are drawn at 0.02 and
    the first ``rms_norm`` divides by their RMS); the port's and the
    reference's float32 gradients there lie 1.7e-4 and 1.9e-4 from a
    float64 run of the port, so an element far below the leaf's largest
    differs by more than 1e-5 in both packages alike."""
    g, w = flat(got), flat(want)
    assert [x[:-1] for x in g] == [x[:-1] for x in w], what
    worst = 0.0
    for gl, wl in zip(g, w):
        a, b = gl[-1].astype(np.float64), np.asarray(wl[-1], np.float64)
        assert a.shape == b.shape, (what, gl[:-1])
        assert np.isfinite(a).all(), (what, gl[:-1])
        scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
        np.testing.assert_allclose(a, b, atol=atol * scale, rtol=rtol,
                                   err_msg=f"{what} {gl[:-1]} (scale {scale:.3g})")
        worst = max(worst, float(np.abs(a - b).max()) / scale if a.size else 0.0)
    return worst
