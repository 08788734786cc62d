"""Attention variants: GQA (+bias/qk-norm), MLA, flash-chunked softmax.

``flash_attention`` is the full-sequence path: the FlashAttention online
softmax over (q chunk × kv chunk) tiles in plain PyTorch, with the
reference's tile order and guards, so the (S × S) logits never
materialise.  ``decode_attention`` scores one query step against a KV
cache.  MLA follows DeepSeek-V2/MiniCPM3: queries, keys and values are
low-rank projections of cached latents; the decode path uses the absorbed
form (W_uk folded into the query), so a token's cache is
``kv_lora + rope_dim`` wide.

The reference pins some tensors' sharding (``shard_ctx.constrain``); on one
card that is the identity, and the port has no such calls.  Under a
tensor-parallel context (``shard_ctx.tensor_parallel``, the mesh train
step) the full-sequence paths compute this process's ``model`` shards'
heads, ``wo`` row-parallel; cross attention (:func:`cross_kv_shards`,
:func:`gqa_cross`) too, each shard making and reading only its kv heads'
K/V.

The serve step (``launch/dryrun.py``'s ``prefill_step``/``serve_step``)
runs prefill and decode under such a context.  Its decode cache is the
process's block under ``launch/shardings.py::decode_state_specs``: where
the kv heads split along ``model``, each local shard's kv heads at every
position, and a decode step is the train step's split (its queries, its
kv heads, ``wo`` row-parallel); where they do not (and always for MLA's
latent cache), each local shard's block of positions of every kv head
(the context splits ``"sequence"``).  A decode step then gathers every
head's query along ``model``, each local shard scores them against its
positions (:func:`_partial_softmax`), the partials merge in shard order
(``TensorParallel.merge``), and each shard multiplies its heads' outputs
by its ``wo`` rows.  The new step's k/v (every kv head, from the shard's
copy of the replicated ``wk``/``wv``) is written by the shard whose block
holds position ``cache_len``.  A prefill returns the cache in the same
layout.  The cache is never gathered along ``model``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import shard_ctx
from repro_torch.models.common import ModelConfig, rms_norm, rope


def _inv_sqrt(n: int) -> float:
    """``1 / sqrt(n)`` rounded as the reference rounds it, in float32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(n)))


# ---------------------------------------------------------------------------
# Flash-style chunked attention (no S×S materialisation)
# ---------------------------------------------------------------------------
def expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: (B, S, KV, hd) -> (B, S, H, hd); query head h reads kv head
    ``h // (H / KV)`` (a gather, as ``repeat_interleave`` orders heads)."""
    g = n_heads // k.shape[2]
    idx = torch.arange(n_heads, device=k.device) // g
    return k.index_select(2, idx)


def flash_attention(
    q: torch.Tensor,          # (B, Sq, H, hd)
    k: torch.Tensor,          # (B, Sk, KV, hd)
    v: torch.Tensor,          # (B, Sk, KV, dv)
    *,
    causal: bool = True,
    q_offset: int = 0,        # absolute position of q[0] (prefill continuation)
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention, chunked on both axes: the largest logits
    tensor is (B, H, q_chunk, kv_chunk).

    Aligned causal attention (``q_offset == 0``, ``Sq == Sk``) with more
    than one q chunk visits only the lower-triangle (q tile, kv tile) pairs,
    in the reference's order (q tile by q tile, kv tiles ascending); any
    other input takes the q × kv double loop.  Computed in float32, cast
    back to ``q``'s dtype.
    """
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    dv = v.shape[-1]                 # may differ from hd (MLA rope-extended k)
    dev = q.device

    kh = expand_kv(k, H).float()
    vh = expand_kv(v, H).float()

    aligned = causal and q_offset == 0 and Sq == Sk
    q_chunk = min(q_chunk, Sq)
    if aligned:
        kv_chunk = q_chunk          # square tiles -> clean triangle skipping
    kv_chunk = min(kv_chunk, Sk)
    nq = (Sq + q_chunk - 1) // q_chunk
    nk = (Sk + kv_chunk - 1) // kv_chunk
    qf = F.pad(q.float() * _inv_sqrt(hd), (0, 0, 0, 0, 0, nq * q_chunk - Sq))
    kf = F.pad(kh, (0, 0, 0, 0, 0, nk * kv_chunk - Sk))
    vf = F.pad(vh, (0, 0, 0, 0, 0, nk * kv_chunk - Sk))
    qf = qf.reshape(B, nq, q_chunk, H, hd)
    kf = kf.reshape(B, nk, kv_chunk, H, hd)
    vf = vf.reshape(B, nk, kv_chunk, H, dv)
    q_ar = torch.arange(q_chunk, device=dev)
    kv_ar = torch.arange(kv_chunk, device=dev)

    def tile(i, j, m, l, acc):
        """One (q_chunk × kv_chunk) online-softmax update of q tile i by kv tile j."""
        q_pos = q_offset + i * q_chunk + q_ar
        kv_pos = j * kv_chunk + kv_ar
        s = torch.einsum("bqhd,bshd->bhqs", qf[:, i], kf[:, j])     # (B,H,qc,kc)
        mask = (kv_pos[None, :] <= q_pos[:, None]) if causal else (kv_pos[None, :] >= 0)
        mask = mask & (kv_pos[None, :] < Sk)
        s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum("bhqs,bshd->bhqd", p, vf[:, j])
        return m_new, l_new, acc_new

    def start():
        return (torch.full((B, H, q_chunk), -torch.inf, device=dev),
                torch.zeros((B, H, q_chunk), device=dev),
                torch.zeros((B, H, q_chunk, dv), device=dev))

    if aligned and nq > 1:
        pairs = [(i, j) for i in range(nq) for j in range(nk)
                 if j * kv_chunk <= i * q_chunk + q_chunk - 1]
    else:
        pairs = [(i, j) for i in range(nq) for j in range(nk)]
    state = [start() for _ in range(nq)]
    for i, j in pairs:
        state[i] = tile(i, j, *state[i])
    out = torch.stack([acc / l.clamp_min(1e-30)[..., None] for _, l, acc in state], dim=1)
    out = out.permute(0, 1, 3, 2, 4).reshape(B, nq * q_chunk, H, dv)[:, :Sq]  # (B,Sq,H,dv)
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,          # (B, 1, H, hd)
    k_cache: torch.Tensor,    # (B, S, KV, hd)
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) valid prefix length
) -> torch.Tensor:
    """Softmax attention of one query step over the cache's first
    ``cache_len`` positions, in float32 (float64 for a float64 model)."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    acc = _acc_dtype(q)
    qf = (q.to(acc) * _inv_sqrt(hd)).reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.to(acc))
    mask = torch.arange(S, device=q.device)[None, :] < cache_len[:, None]     # (B, S)
    s = torch.where(mask[:, None, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(acc))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype decode scores and sums in: float32, float64 for a float64
    model."""
    return torch.promote_types(t.dtype, torch.float32)


def _partial_softmax(s: torch.Tensor, v: torch.Tensor, valid: torch.Tensor):
    """One shard's part of a softmax over its block of positions: scores
    ``s`` (B, ..., n), ``v(p)`` the values weighted by ``p`` (B, ..., n)
    and summed over the block, and ``valid`` (B,) the block's valid
    positions (its first ``valid``; none where ``valid <= 0``).  Returns
    ``(m, l, acc)`` for ``TensorParallel.merge``."""
    n = s.shape[-1]
    mask = torch.arange(n, device=s.device)[None, :] < valid[:, None]             # (B, n)
    mask = mask.reshape(mask.shape[:1] + (1,) * (s.ndim - 2) + mask.shape[1:])
    s = torch.where(mask, s, -torch.inf)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
    return m, p.sum(dim=-1), v(p)


# ---------------------------------------------------------------------------
# GQA block (covers dense archs; bias and qk-norm options)
# ---------------------------------------------------------------------------
def build_gqa_params(cfg: ModelConfig, b, prefix_layers: bool = True):
    L = (cfg.n_layers,) if prefix_layers else ()
    lax_ = ("layers",) if prefix_layers else ()
    hd = cfg.hd
    p = {
        "wq": b(L + (cfg.d_model, cfg.n_heads, hd), lax_ + ("embed", "heads", "hd")),
        "wk": b(L + (cfg.d_model, cfg.n_kv_heads, hd), lax_ + ("embed", "kv_heads", "hd")),
        "wv": b(L + (cfg.d_model, cfg.n_kv_heads, hd), lax_ + ("embed", "kv_heads", "hd")),
        "wo": b(L + (cfg.n_heads, hd, cfg.d_model), lax_ + ("heads", "hd", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = b(L + (cfg.n_heads, hd), lax_ + ("heads", "hd"), init="zeros")
        p["bk"] = b(L + (cfg.n_kv_heads, hd), lax_ + ("kv_heads", "hd"), init="zeros")
        p["bv"] = b(L + (cfg.n_kv_heads, hd), lax_ + ("kv_heads", "hd"), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = b(L + (hd,), lax_ + ("hd",), init="ones")
        p["k_norm"] = b(L + (hd,), lax_ + ("hd",), init="ones")
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, H, k) -> (B, S, H, k)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(x.shape[:-1] + w.shape[1:])


def _merge_heads(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, k) @ (H, k, d) -> (B, S, d)."""
    return o.reshape(o.shape[:-2] + (-1,)) @ wo.reshape(-1, wo.shape[-1])


def _queries(cfg: ModelConfig, p, x, positions):
    q = _heads(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta)


def gqa_kv(cfg: ModelConfig, p, x, positions):
    """Rotary k and v of ``x`` (B, S, d) -> (B, S, KV, hd) each."""
    k = _heads(x, p["wk"])
    v = _heads(x, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return rope(k, positions, cfg.rope_theta), v


def gqa_qkv(cfg: ModelConfig, p, x, positions):
    """Project to rotary q/k and v. x (B, S, d) -> q (B,S,H,hd), k/v (B,S,KV,hd)."""
    return (_queries(cfg, p, x, positions),) + gqa_kv(cfg, p, x, positions)


def gqa_attend(cfg: ModelConfig, p, x, positions, *, causal=True, cache=None, cache_len=None):
    """Full GQA self-attention block: returns (out, new_kv_for_cache).

    ``cache``/``cache_len``: decode path — append one step, score vs cache.
    Cross attention is :func:`cross_kv_shards` and :func:`gqa_cross`.
    """
    if cache is None:
        return _gqa_self(cfg, p, x, positions, causal)
    if shard_ctx.split(shard_ctx.SEQUENCE).mesh is not None:
        return _gqa_decode_sequence(cfg, p, x, positions, cache, cache_len)
    tp = shard_ctx.split("heads")
    if tp.mesh is not None and "kv_heads" not in tp.split:
        raise ValueError("the split decode needs the cache split along model by its kv heads "
                         "or by its sequence; its kv heads are replicated along model")
    # one device, or each local shard's query heads and its block of the kv heads
    parts, ks, vs = [], [], []
    for xj, (pj, _), kc, vc in zip(tp.enter(x), _shard_heads(cfg, p, tp),
                                   tp.shards(cache[0], 2), tp.shards(cache[1], 2)):
        q, k, v = gqa_qkv(cfg, pj, xj, positions)
        ks.append(_scatter_step(kc, k, cache_len))
        vs.append(_scatter_step(vc, v, cache_len))
        out = decode_attention(q, ks[-1], vs[-1], cache_len + 1)
        parts.append(_merge_heads(out, pj["wo"]))
    return tp.leave(parts), (_cat(ks, 2), _cat(vs, 2))


def _cat(parts: list, dim: int) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def _kv_leaves(cfg: ModelConfig, p, tp, n: int) -> list[dict]:
    """``n`` trees of the leaves that make every kv head's k and v: each
    local shard's copy of the replicated leaves where ``tp`` splits
    "heads" (``n`` is then its local shards), else the leaves themselves."""
    names = ("wk", "wv") + (("bk", "bv") if cfg.qkv_bias else ()) + (
        ("k_norm",) if cfg.qk_norm else ())
    if tp.mesh is None:
        return [{k: p[k] for k in names}] * n
    per = {k: tp.copies(p[k]) for k in names}
    return [{k: v[j] for k, v in per.items()} for j in range(n)]


def _gqa_decode_sequence(cfg: ModelConfig, p, x, positions, cache, cache_len):
    """A decode step on a cache split along ``model`` by its sequence: each
    local shard's block of positions of every kv head (see the module
    docstring)."""
    tp, sq = shard_ctx.split("heads"), shard_ctx.split(shard_ctx.SEQUENCE)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shards = _shard_heads(cfg, p, tp)
    xs = tp.enter(x)
    q = tp.gather([_queries(cfg, pj, xj, positions) for xj, (pj, _) in zip(xs, shards)], 2)
    B, acc = x.shape[0], _acc_dtype(q)
    qf = (q.to(acc) * _inv_sqrt(hd)).reshape(B, KV, H // KV, hd)
    n = cache[0].shape[1] // sq.local
    ks, vs, partials = [], [], []
    for j, (kc, vc, pk) in enumerate(zip(sq.shards(cache[0], 1), sq.shards(cache[1], 1),
                                         _kv_leaves(cfg, p, tp, sq.local))):
        lens = cache_len - sq.shard(j) * n           # the step's position in this block
        k, v = gqa_kv(cfg, pk, x, positions)
        ks.append(_scatter_step(kc, k, lens))
        vs.append(_scatter_step(vc, v, lens))
        s = torch.einsum("bkgd,bskd->bkgs", qf, ks[-1].to(acc))
        vf = vs[-1].to(acc)
        partials.append(_partial_softmax(
            s, lambda pr, vf=vf: torch.einsum("bkgs,bskd->bkgd", pr, vf), lens + 1))
    out = sq.merge(partials).reshape(B, 1, H, hd).to(x.dtype)
    hs = H // tp.size
    parts = [_merge_heads(out[:, :, tp.shard(j) * hs:(tp.shard(j) + 1) * hs], pj["wo"])
             for j, (pj, _) in enumerate(shards)]
    return tp.leave(parts), (_cat(ks, 1), _cat(vs, 1))


def tp_groups(cfg: ModelConfig, prefix: tuple, stacked: bool) -> list[shard_ctx.Group]:
    """The split groups of the GQA block under ``prefix`` (``stacked``: its
    leaves have a leading layer dimension): its query heads, their norms
    partial, and its kv heads within them."""
    o = 1 if stacked else 0
    heads = {prefix + ("wq",): o + 1, prefix + ("wo",): o}
    kv = {prefix + ("wk",): o + 1, prefix + ("wv",): o + 1}
    if cfg.qkv_bias:
        heads[prefix + ("bq",)] = o
        kv.update({prefix + ("bk",): o, prefix + ("bv",): o})
    norms = tuple(prefix + (k,) for k in ("q_norm", "k_norm")) if cfg.qk_norm else ()
    return [shard_ctx.Group("heads", heads, partial=norms),
            shard_ctx.Group("kv_heads", kv, within="heads")]


def _shard_heads(cfg: ModelConfig, p, tp) -> list[tuple[dict, list[int] | None]]:
    """Each local shard's attention leaves under ``tp`` (which splits
    "heads"): its query heads (``wq``, ``bq``, ``wo``), the norms' copies,
    and the kv heads they read: its block of ``wk``/``wv`` where the kv
    heads are split too, else those heads of its copy of the replicated
    leaves (query head ``h`` reads kv head ``h // (H / KV)``); with the
    order its query heads read its kv heads in, where that is not
    ``expand_kv``'s (else ``None``)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    hs, group = H // tp.size, H // KV
    kv_split = "kv_heads" in tp.split
    norms = ("q_norm", "k_norm") if cfg.qk_norm else ()
    kv_names = ("wk", "wv") + (("bk", "bv") if cfg.qkv_bias else ())
    per = {"wq": tp.shards(p["wq"], -2), "wo": tp.shards(p["wo"], -3),
           **({"bq": tp.shards(p["bq"], -2)} if cfg.qkv_bias else {}),
           **{k: tp.copies(p[k]) for k in norms},
           **{k: (tp.shards(p[k], -2) if kv_split else tp.copies(p[k])) for k in kv_names}}
    out = []
    for j in range(tp.local):
        pj = {k: v[j] for k, v in per.items()}
        h0 = tp.shard(j) * hs
        reads = [h // group for h in range(h0, h0 + hs)]     # the kv head of each query head
        lo = reads[0]                                         # the shard's first kv head
        reads = [r - lo for r in reads]
        if not kv_split:
            for k in kv_names:
                pj[k] = pj[k][..., lo:lo + reads[-1] + 1, :]
        kv_heads = reads[-1] + 1
        out.append((pj, None if reads == [h // (hs // kv_heads) for h in range(hs)]
                    else reads))                              # else not expand_kv's order
    return out


def _read_order(k, v, reads):
    if reads is None:
        return k, v
    idx = torch.tensor(reads, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _gqa_self(cfg: ModelConfig, p, x, positions, causal: bool):
    """Self-attention over ``x``: ``(out, (k, v))``.  Under a context that
    splits "heads" each local shard takes its query heads and the kv heads
    they read (:func:`_shard_heads`); ``wo`` is row-parallel, the shards'
    partials summed over ``model``.  The (k, v) returned are the process's
    block of the cache (the serve step's layout, module docstring): every
    kv head at every position without a split; its local shards' kv heads
    where they split; its local shards' blocks of positions of every kv
    head under a context that splits ``"sequence"``; else (the train step's
    replicated kv heads, which the serve step refuses) the last local
    shard's."""
    tp = shard_ctx.split("heads")
    parts, ks, vs = [], [], []
    for xj, (pj, reads) in zip(tp.enter(x), _shard_heads(cfg, p, tp)):
        q, k, v = gqa_qkv(cfg, pj, xj, positions)
        ks.append(k)
        vs.append(v)
        out = flash_attention(q, *_read_order(k, v, reads), causal=causal)
        parts.append(_merge_heads(out, pj["wo"]))
    sq = shard_ctx.split(shard_ctx.SEQUENCE)
    if sq.mesh is not None:
        blocks = [_sequence_block(sq, j, x.shape[1]) for j in range(sq.local)]
        if tp.mesh is None:                  # every kv head computed whole: its blocks
            return tp.leave(parts), tuple(_cat([t[:, a:b] for a, b in blocks], 1)
                                          for t in (ks[0], vs[0]))
        kvs = [gqa_kv(cfg, pk, x[:, a:b], positions[:, a:b])
               for (a, b), pk in zip(blocks, _kv_leaves(cfg, p, tp, sq.local))]
        return tp.leave(parts), tuple(_cat(list(t), 1) for t in zip(*kvs))
    if tp.mesh is not None and "kv_heads" not in tp.split:
        return tp.leave(parts), (ks[-1], vs[-1])
    return tp.leave(parts), (_cat(ks, 2), _cat(vs, 2))


def _sequence_block(sq, j: int, S: int) -> tuple[int, int]:
    """The positions ``[a, b)`` of local shard ``j``'s block of a sequence
    of ``S`` split along ``model``."""
    if S % sq.size:
        raise ValueError(f"a sequence of {S} does not split into {sq.size} model shards")
    n = S // sq.size
    return sq.shard(j) * n, (sq.shard(j) + 1) * n


def cross_kv_shards(cfg: ModelConfig, p, source, positions) -> list:
    """Cross attention's (K, V) of ``source`` (the encoder's output, one
    copy a local shard as :meth:`~shard_ctx.TensorParallel.enter` gives
    them) for each local shard of the context that splits "heads" (one,
    every head, without one): its kv heads' K (roped at ``positions``) and
    V, in the order its query heads read them."""
    tp = shard_ctx.split("heads")
    out = []
    for sj, (pj, reads) in zip(source, _shard_heads(cfg, p, tp)):
        k, v = _heads(sj, pj["wk"]), _heads(sj, pj["wv"])
        if cfg.qkv_bias:
            k, v = k + pj["bk"], v + pj["bv"]
        if cfg.qk_norm:
            k = rms_norm(k, pj["k_norm"], cfg.norm_eps)
        out.append(_read_order(rope(k, positions, cfg.rope_theta), v, reads))
    return out


def gqa_cross(cfg: ModelConfig, p, x, positions, kvs: list):
    """Cross attention of ``x`` over each local shard's ``(K, V)`` of
    :func:`cross_kv_shards`, under the context that splits "heads" (one
    shard without one): each shard's query heads, ``wo`` row-parallel."""
    tp = shard_ctx.split("heads")
    parts = []
    for xj, (pj, _), (k, v) in zip(tp.enter(x), _shard_heads(cfg, p, tp), kvs):
        out = flash_attention(_queries(cfg, pj, xj, positions), k, v, causal=False)
        parts.append(_merge_heads(out, pj["wo"]))
    return tp.leave(parts)


def _scatter_step(cache: torch.Tensor, step: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """``cache`` (B, S, ...) with one new step (B, 1, ...) written at per-row
    position ``lens``; a row whose ``lens`` lies outside ``[0, S)`` is
    unchanged, as under the reference's one-hot blend (a block of a
    sequence split along ``model`` takes ``lens`` less its offset, so only
    the block that holds the position writes it)."""
    hit = torch.arange(cache.shape[1], device=cache.device)[None, :] == lens[:, None]
    hit = hit.reshape(hit.shape + (1,) * (cache.ndim - 2))
    return torch.where(hit, step.to(cache.dtype), cache)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention) — MiniCPM3 / DeepSeek-V2 style
# ---------------------------------------------------------------------------
def build_mla_params(cfg: ModelConfig, b):
    L = (cfg.n_layers,)
    lax_ = ("layers",)
    hd = cfg.hd                      # nope head dim (== v head dim)
    rd = cfg.rope_head_dim
    return {
        "w_dq": b(L + (cfg.d_model, cfg.q_lora_rank), lax_ + ("embed", "rank")),
        "q_norm": b(L + (cfg.q_lora_rank,), lax_ + ("rank",), init="ones"),
        "w_uq": b(L + (cfg.q_lora_rank, cfg.n_heads, hd + rd), lax_ + ("rank", "heads", "hd")),
        "w_dkv": b(L + (cfg.d_model, cfg.kv_lora_rank + rd), lax_ + ("embed", "rank")),
        "kv_norm": b(L + (cfg.kv_lora_rank,), lax_ + ("rank",), init="ones"),
        "w_uk": b(L + (cfg.kv_lora_rank, cfg.n_heads, hd), lax_ + ("rank", "heads", "hd")),
        "w_uv": b(L + (cfg.kv_lora_rank, cfg.n_heads, hd), lax_ + ("rank", "heads", "hd")),
        "wo": b(L + (cfg.n_heads, hd, cfg.d_model), lax_ + ("heads", "hd", "embed")),
    }


def mla_latents(cfg: ModelConfig, p, x, positions):
    """The cached latent: c_kv (B,S,r) and rotary k_rope (B,S,rd), roped
    over a singleton head axis."""
    dkv = x @ p["w_dkv"]
    c_kv = rms_norm(dkv[..., : cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = rope(dkv[..., None, cfg.kv_lora_rank:], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_queries(cfg: ModelConfig, p, x, positions):
    hd = cfg.hd
    cq = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = _heads(cq, p["w_uq"])
    return q[..., :hd], rope(q[..., hd:], positions, cfg.rope_theta)


def mla_attend_train(cfg: ModelConfig, p, x, positions):
    """Full-sequence MLA: per-head k/v materialised from the latents.
    Under a context that splits "heads" each local shard computes the
    latents with its copies of the replicated down-projections and norms,
    and its heads with its blocks of the up-projections; ``wo`` is
    row-parallel.  The latents returned are the process's block of the
    latent cache: every position, or under a context that splits
    ``"sequence"`` its local shards' blocks of positions."""
    tp = shard_ctx.split("heads")
    hs = cfg.n_heads // tp.size
    per = {**{k: tp.copies(p[k]) for k in ("w_dq", "q_norm", "w_dkv", "kv_norm")},
           **{k: tp.shards(p[k], -2) for k in ("w_uq", "w_uk", "w_uv")},
           "wo": tp.shards(p["wo"], -3)}
    parts, latents = [], []
    for j, xj in enumerate(tp.enter(x)):
        pj = {k: v[j] for k, v in per.items()}
        c_kv, k_rope = mla_latents(cfg, pj, xj, positions)
        q_nope, q_rope = mla_queries(cfg, pj, xj, positions)
        k_nope = _heads(c_kv, pj["w_uk"])
        v = _heads(c_kv, pj["w_uv"])
        k_rope_h = k_rope[:, :, None, :].expand(k_rope.shape[:2] + (hs, cfg.rope_head_dim))
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope_h], dim=-1)
        out = flash_attention(q_full, k_full, v, causal=True)
        parts.append(_merge_heads(out, pj["wo"]))
        latents.append((c_kv, k_rope))
    sq = shard_ctx.split(shard_ctx.SEQUENCE)
    if sq.mesh is None:
        return tp.leave(parts), latents[-1]
    # local shard j's block of positions, from its own latents (one set
    # where the heads run whole)
    blocks = [_sequence_block(sq, j, x.shape[1]) for j in range(sq.local)]
    return tp.leave(parts), tuple(
        _cat([latents[min(j, len(latents) - 1)][i][:, a:b] for j, (a, b) in enumerate(blocks)],
             1) for i in range(2))


def mla_attend_decode(cfg: ModelConfig, p, x, positions, cache, cache_len):
    """Absorbed-form decode: score directly against the latent cache.

    q̃ = q_nope · W_uk  →  (B, 1, H, r); a token's cache is (r + rd).
    Under a context that splits ``"sequence"`` (the latent cache has no
    head axis: the serve step always splits its sequence along ``model``)
    the absorbed queries of the local shards' heads (every head where the
    heads run whole) are gathered along ``model``, each local shard scores
    them against its block of positions, the partials merge in shard
    order, and each shard's heads take their ``w_uv`` and ``wo`` rows."""
    if shard_ctx.split(shard_ctx.SEQUENCE).mesh is not None:
        return _mla_decode_sequence(cfg, p, x, positions, cache, cache_len)
    if shard_ctx.split("heads").mesh is not None:
        raise ValueError("the split decode needs MLA's latent cache split along model by "
                         "its sequence")
    c_cache, r_cache = cache                     # (B, S, r), (B, S, rd)
    c_new, k_rope_new = mla_latents(cfg, p, x, positions)
    c_cache = _scatter_step(c_cache, c_new, cache_len)
    r_cache = _scatter_step(r_cache, k_rope_new, cache_len)
    S = c_cache.shape[1]

    q_nope, q_rope = mla_queries(cfg, p, x, positions)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])     # absorbed
    acc = _acc_dtype(x)
    s = (torch.einsum("bshr,btr->bhst", q_abs.to(acc), c_cache.to(acc))
         + torch.einsum("bshk,btk->bhst", q_rope.to(acc), r_cache.to(acc))
         ) * _inv_sqrt(cfg.hd + cfg.rope_head_dim)
    mask = torch.arange(S, device=x.device)[None, :] < (cache_len + 1)[:, None]
    s = torch.where(mask[:, None, None, :], s, -torch.inf)
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", pr, c_cache.to(acc))
    out = torch.einsum("bshr,rhk->bshk", ctx, p["w_uv"].to(acc))
    return _merge_heads(out.to(x.dtype), p["wo"]), (c_cache, r_cache)


def _mla_decode_sequence(cfg: ModelConfig, p, x, positions, cache, cache_len):
    """:func:`mla_attend_decode` on a latent cache split along ``model`` by
    its sequence."""
    tp, sq = shard_ctx.split("heads"), shard_ctx.split(shard_ctx.SEQUENCE)
    H, r = cfg.n_heads, cfg.kv_lora_rank
    hs = H // tp.size
    latent = ("w_dq", "q_norm", "w_dkv", "kv_norm")
    per = {**{k: tp.copies(p[k]) for k in latent},
           **{k: tp.shards(p[k], -2) for k in ("w_uq", "w_uk", "w_uv")},
           "wo": tp.shards(p["wo"], -3)}
    shards = [{k: v[j] for k, v in per.items()} for j in range(tp.local)]
    qs = []
    for xj, pj in zip(tp.enter(x), shards):
        q_nope, q_rope = mla_queries(cfg, pj, xj, positions)
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope, pj["w_uk"])     # absorbed
        qs.append(torch.cat([q_abs, q_rope], dim=-1))
    acc = _acc_dtype(x)
    q = tp.gather(qs, 2).to(acc)                                         # (B, 1, H, r + rd)
    n = cache[0].shape[1] // sq.local
    cs, rs, partials = [], [], []
    for j, (cc, rc) in enumerate(zip(sq.shards(cache[0], 1), sq.shards(cache[1], 1))):
        pj = shards[j] if tp.mesh is not None else p    # its copies of the latent leaves
        lens = cache_len - sq.shard(j) * n
        c_new, k_rope_new = mla_latents(cfg, pj, x, positions)
        cs.append(_scatter_step(cc, c_new, lens))
        rs.append(_scatter_step(rc, k_rope_new, lens))
        cf = cs[-1].to(acc)
        s = (torch.einsum("bshr,btr->bhst", q[..., :r], cf)
             + torch.einsum("bshk,btk->bhst", q[..., r:], rs[-1].to(acc))
             ) * _inv_sqrt(cfg.hd + cfg.rope_head_dim)
        partials.append(_partial_softmax(
            s, lambda pr, cf=cf: torch.einsum("bhst,btr->bhsr", pr, cf), lens + 1))
    ctx = sq.merge(partials).transpose(1, 2)                            # (B, 1, H, r)
    parts = []
    for j, pj in enumerate(shards):
        cj = ctx[:, :, tp.shard(j) * hs:(tp.shard(j) + 1) * hs]
        out = torch.einsum("bshr,rhk->bshk", cj, pj["w_uv"].to(acc))
        parts.append(_merge_heads(out.to(x.dtype), pj["wo"]))
    return tp.leave(parts), (_cat(cs, 1), _cat(rs, 1))
