"""Shared model substrate: the config, the parameter builder, the core layers.

Parameters are plain trees (nested dicts of tensors) with the reference's
keys and shapes: block parameters carry a leading ``n_layers`` axis, so a
checkpoint's leaf names (``params/blocks/attn/wq``) match the reference's.
Every leaf is made through a :class:`ParamBuilder` callback, which runs in
one of two modes:

* ``init``  — draw the tensors from an explicit ``torch.Generator`` on its
  device, one leaf at a time (the float32 temporary is one leaf);
* ``shape`` — ``meta`` tensors: shapes and dtypes, no memory;
* ``spec``  — each leaf's spec over a mesh: its *logical axes*
  (``"embed"``, ``"heads"``, ``"mlp"``, ``"vocab"``, ``"expert"``,
  ``"layers"`` …) resolved to mesh axes by :func:`resolve_spec`, with the
  reference's divisibility rule — a dimension that does not divide over its
  mesh axes keeps a dividing prefix of them, else is replicated.

A spec (:class:`PartitionSpec`) is a tuple with one entry a dimension, as
JAX's ``PartitionSpec`` holds them: ``None``, an axis name, or a tuple of
axis names (the dimension split over their product, the first outermost).
A :class:`NamedSharding` is the pair (mesh, spec);
``launch/shardings.py`` places a leaf's blocks under one.

:func:`checkpointed` and :func:`remat` are the reference's
``jax.checkpoint(..., policy=nothing_saveable)``: a checkpointed call
keeps its inputs and recomputes its insides in the backward.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config covers all 10 assigned architectures via ``family``."""

    name: str = "model"
    family: str = "decoder"          # decoder | encdec | rwkv6 | zamba2
    n_layers: int = 12
    d_model: int = 1024
    n_heads: int = 16
    n_kv_heads: int = 16
    d_ff: int = 4096
    vocab: int = 32000
    head_dim: int = 0                # 0 -> d_model // n_heads

    # mlp options
    gated_mlp: bool = True           # False: plain GELU MLP (starcoder2)

    # attention options
    qkv_bias: bool = False           # qwen1.5
    qk_norm: bool = False            # qwen3 / chameleon
    rope_theta: float = 10_000.0

    # MLA (minicpm3)
    mla: bool = False
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    rope_head_dim: int = 32

    # MoE (qwen3-moe, llama4)
    moe: bool = False
    n_experts: int = 0
    top_k: int = 1
    moe_d_ff: int = 0
    n_shared_experts: int = 0        # llama4 shared expert
    moe_every: int = 1               # llama4: MoE every k-th layer, dense otherwise
    dense_d_ff: int = 0              # d_ff of the interleaved dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2

    # SSM (rwkv6 / zamba2-mamba2)
    ssm_state: int = 64
    ssm_chunk: int = 64
    attn_every: int = 6              # zamba2: shared attn block period

    # enc-dec (seamless-m4t)
    enc_layers: int = 0

    # numerics / structure; ``remat`` checkpoints each block when autograd
    # records (its backward recomputes the block; no number changes);
    # ``scan_layers`` changes nothing (the layers run one after another)
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: bool = True
    logits_chunk: int = 512
    scan_layers: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Total parameter count N, counted over ``meta`` tensors."""
        return sum(t.numel() for _, t in tree_leaves(init_params(self, mode="shape")))

    def active_param_count(self) -> int:
        """Active-per-token N for MoE: the leaves under an ``experts`` key
        count at ``top_k / n_experts``; == N for dense."""
        if not self.moe:
            return self.param_count()
        leaves = tree_leaves(init_params(self, mode="shape"))
        total = sum(t.numel() for _, t in leaves)
        expert_leaves = sum(t.numel() for path, t in leaves if "experts" in path)
        active_frac = self.top_k / max(self.n_experts, 1)
        return int(total - expert_leaves + expert_leaves * active_frac)


def tree_leaves(tree, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` of a tree of nested dicts, in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k], path + (k,))]
    return [(path, tree)]


def checkpointed(fn, *args):
    """``fn(*args)``, checkpointed when autograd records: the backward
    recomputes ``fn`` from ``args`` instead of keeping its activations."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def remat(cfg: "ModelConfig", fn):
    """``fn``, checkpointed on every call when ``cfg.remat``."""
    if not cfg.remat:
        return fn
    return lambda *args: checkpointed(fn, *args)


def tree_map(fn, tree):
    """``tree`` with every leaf of its nested dicts replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# Logical-axis resolution
# ---------------------------------------------------------------------------
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "embed": ("pod", "data"),        # FSDP shard of the contraction dim
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "layers": (),
    "seq": (),
    "state": (),
    "rank": (),
    "hd": (),
}


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: shards}`` of a mesh (the port's :class:`~repro_torch.launch.
    mesh.Mesh`, or anything with ``axes`` and ``shape``)."""
    return dict(zip(mesh.axes, mesh.shape))


def resolve_axis(logical: str | None, dim: int, mesh_shape: Mapping[str, int],
                 rules: Mapping[str, tuple[str, ...]]) -> tuple[str, ...] | None:
    """Map one logical axis to mesh axes, dropping non-divisible shards."""
    if logical is None:
        return None
    axes = tuple(a for a in rules.get(logical, ()) if a in mesh_shape)
    if not axes:
        return None
    if dim % math.prod(mesh_shape[a] for a in axes) == 0:
        return axes
    # try a prefix that divides (keeps at least partial sharding)
    for cut in range(len(axes) - 1, 0, -1):
        if dim % math.prod(mesh_shape[a] for a in axes[:cut]) == 0:
            return axes[:cut]
    return None


class PartitionSpec(tuple):
    """A leaf's spec, one entry a dimension: ``None``, an axis name, or a
    tuple of axis names; a one-name tuple is that name, as in JAX.  A tuple
    subclass, so that a tree of specs tells a spec from a tuple of specs."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def resolve_spec(shape: Sequence[int], axes: Sequence[str | None],
                 mesh_shape: Mapping[str, int], rules: Mapping[str, tuple[str, ...]]) -> P:
    """One leaf's spec: each dimension's mesh axes, a mesh axis used once."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and logical axes {tuple(axes)} differ in length")
    used: set[str] = set()
    out = []
    for dim, ax in zip(shape, axes):
        r = resolve_axis(ax, dim, mesh_shape, rules)
        if r is None or any(a in used for a in r):
            out.append(None)
        else:
            used.update(r)
            out.append(r)
    return P(*out)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A leaf's placement: the spec's blocks over ``mesh``'s shards."""

    mesh: Any
    spec: PartitionSpec


# ---------------------------------------------------------------------------
# Parameter builder
# ---------------------------------------------------------------------------
class ParamBuilder:
    """Makes one leaf per call; see the module docstring.  ``axes`` are the
    leaf's logical axes, which the ``spec`` mode resolves over ``mesh``
    (``rules`` update :data:`DEFAULT_RULES`)."""

    def __init__(self, cfg: ModelConfig, mode: str, generator: torch.Generator | None = None,
                 mesh=None, rules: Mapping[str, tuple[str, ...]] | None = None):
        if mode not in ("init", "shape", "spec"):
            raise ValueError(f"ParamBuilder mode {mode!r}: 'init', 'shape' or 'spec'")
        if mode == "init" and generator is None:
            raise ValueError("ParamBuilder mode 'init' needs a torch.Generator")
        if mode == "spec" and mesh is None:
            raise ValueError("ParamBuilder mode 'spec' needs a mesh")
        self.cfg = cfg
        self.mode = mode
        self.generator = generator
        self.mesh = mesh
        self.rules = {**DEFAULT_RULES, **(rules or {})}

    def __call__(self, shape: Sequence[int], axes: Sequence[str | None],
                 init: str = "normal", scale: float | None = None):
        shape = tuple(int(s) for s in shape)
        if self.mode == "spec":
            return resolve_spec(shape, axes, mesh_shape(self.mesh), self.rules)
        dtype = self.cfg.dtype
        if self.mode == "shape":
            return torch.empty(shape, dtype=dtype, device="meta")
        dev = self.generator.device
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=dev)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=dev)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        w = torch.randn(shape, generator=self.generator, dtype=torch.float32, device=dev)
        return w.mul_(s).to(dtype)


def init_params(cfg: ModelConfig, mode: str = "init", generator: torch.Generator | None = None,
                mesh=None, rules=None):
    """Dispatch to the family-specific parameter builder."""
    from repro_torch.models import encdec, ssm, transformer, zamba

    b = ParamBuilder(cfg, mode, generator, mesh=mesh, rules=rules)
    if cfg.family == "decoder":
        return transformer.build_params(cfg, b)
    if cfg.family == "encdec":
        return encdec.build_params(cfg, b)
    if cfg.family == "rwkv6":
        return ssm.build_rwkv6_params(cfg, b)
    if cfg.family == "zamba2":
        return zamba.build_params(cfg, b)
    raise ValueError(f"unknown family {cfg.family}")


def param_specs(cfg: ModelConfig, mesh, rules=None):
    """The parameter tree's specs over ``mesh`` (a tuple a leaf)."""
    return init_params(cfg, mode="spec", mesh=mesh, rules=rules)


def param_shardings(cfg: ModelConfig, mesh, rules=None):
    """The parameter tree's :class:`NamedSharding` a leaf."""
    return tree_map(lambda s: NamedSharding(mesh, s), param_specs(cfg, mesh, rules))


def batch_spec(mesh) -> P:
    """A batch's spec: dim 0 over the data axes (``pod`` and ``data``)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axes)
    return P(axes if axes else None)


def params_from_numpy(cfg: ModelConfig, tree, device=None):
    """The reference's parameter tree (nested dicts of numpy arrays, as
    ``np.asarray`` gives its leaves) as the port's tree of tensors on
    ``device`` (``None`` = the card).  Keys, shapes and dtypes must be those
    :func:`init_params` builds for ``cfg``.  A bfloat16 leaf (an
    ``ml_dtypes`` array, which ``torch.from_numpy`` refuses) is carried
    across as its 16-bit words."""
    from repro_torch.kernels.util import resolve_device

    dev = resolve_device(device)
    want = dict(tree_leaves(init_params(cfg, mode="shape")))
    got = dict(tree_leaves(tree))
    if want.keys() != got.keys():
        raise ValueError(f"parameter keys differ from {cfg.name}'s: "
                         f"{sorted(set(want) ^ set(got))}")

    def leaf(a) -> torch.Tensor:
        a = np.array(a)                  # a writable copy
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    out = tree_map(leaf, tree)
    for path, t in tree_leaves(out):
        w = want[path]
        if t.shape != w.shape or t.dtype != w.dtype:
            raise ValueError(f"{'/'.join(path)}: {tuple(t.shape)} {t.dtype}, "
                             f"{cfg.name} has {tuple(w.shape)} {w.dtype}")
    return out


# ---------------------------------------------------------------------------
# Core layers (functional)
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalised in float32, cast back to ``x``'s dtype, then scaled by
    ``gamma`` in that dtype (the reference's rounding order)."""
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last axis, the two halves concatenated (not
    interleaved); x (..., S, H, hd), positions (..., S); angles in float32."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., :, None].float() * freqs           # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """The gated MLP.  Under a tensor-parallel context that splits ``mlp``
    (``shard_ctx``), ``w_gate``/``w_up`` are column-parallel and ``w_down``
    row-parallel: each local shard's columns give its partial, and the
    partials are summed over ``model`` in shard order."""
    from repro_torch.models import shard_ctx

    tp = shard_ctx.split("mlp")
    parts = []
    for xj, wg, wu, wd in zip(tp.enter(x), tp.shards(w_gate, -1), tp.shards(w_up, -1),
                              tp.shards(w_down, -2)):
        h = torch.nn.functional.silu((xj @ wg).float()).to(x.dtype) * (xj @ wu)
        parts.append(h @ wd)
    return tp.leave(parts)
