"""SSM / linear-recurrence core: chunked decayed linear attention.

One chunk-parallel primitive serves both recurrent families:

* **RWKV6 (Finch)** — per-channel data-dependent decay ``w_t ∈ (0,1)^{dk}``,
  bonus ``u`` on the current token, strict (i < t) intra-chunk mask;
* **Mamba2 (SSD)**  — per-head scalar decay broadcast over the state dim,
  inclusive (i ≤ t) mask, no bonus.

Math (per head; ``P_t = ∏_{j≤t} w_j`` within a chunk):
``S_t = diag(P_t)(S_0 + Σ_{i≤t} (k_i/P_i) ⊗ v_i)`` so with
``q̃_t = q_t⊙P_t`` and ``k̃_i = k_i/P_i`` the intra-chunk part is a masked
product ``(q̃ k̃ᵀ ⊙ M) v``, and the inter-chunk part is a recurrence over
the chunk states, run here as a Python loop over the ``n`` chunks in order
(the reference's ``lax.scan``).  Cumulative products run in log space,
clamped at ``_LOG_MIN``.  All of it is PyTorch products and plain ops, as
the reference's is XLA outside any Pallas kernel; ``torch.autograd``
differentiates it.  An entry clamped at ``_LOG_MIN`` passes no gradient, as
under the reference's ``maximum``.

The within-chunk cumulative sum is a product with a lower-triangular
ones matrix (chunk × chunk): PyTorch's deterministic mode, which training
turns on for the backward's scatter-adds, refuses a float ``cumsum`` on the
card, and a product is deterministic there and differentiates to the
transposed product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import shard_ctx
from repro_torch.models.attention import _heads, _merge_heads
from repro_torch.models.common import ModelConfig, rms_norm

_LOG_MIN = -60.0  # clamp for cumulative log-decay (exp(-60) ~ 1e-26)


def chunked_linear_attention(
    q: torch.Tensor,        # (B, S, H, Dk)
    k: torch.Tensor,        # (B, S, H, Dk)
    v: torch.Tensor,        # (B, S, H, Dv)
    log_w: torch.Tensor,    # (B, S, H, Dk) negative log-decay (log w_t)
    *,
    bonus: torch.Tensor | None = None,   # (H, Dk) current-token bonus (RWKV6)
    inclusive: bool = True,              # True: mamba (i ≤ t); False: rwkv (i < t)
    chunk: int = 64,
    initial_state: torch.Tensor | None = None,  # (B, H, Dk, Dv)
):
    """Returns (out (B, S, H, Dv) in ``q``'s dtype, final_state (B, H, Dk, Dv)
    float32)."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    chunk = min(chunk, S)
    n = (S + chunk - 1) // chunk
    pad = n * chunk - S

    def pad_t(x):
        return F.pad(x, (0, 0, 0, 0, 0, pad))

    qf = pad_t(q).float().reshape(B, n, chunk, H, Dk)
    kf = pad_t(k).float().reshape(B, n, chunk, H, Dk)
    vf = pad_t(v).float().reshape(B, n, chunk, H, Dv)
    # padded steps get decay 1 (log 0) and k=0 so they don't disturb state
    lw = pad_t(log_w.float())
    if pad:
        kill = (torch.arange(n * chunk, device=q.device) >= S).reshape(n, chunk)
        kf = torch.where(kill[None, :, :, None, None], 0.0, kf)
    lw = lw.reshape(B, n, chunk, H, Dk)

    tril = torch.ones((chunk, chunk), device=q.device).tril()
    cum = torch.einsum("ts,bnshd->bnthd", tril, lw).clamp_min(_LOG_MIN)  # log P_t
    p_t = torch.exp(cum)
    inv_p = torch.exp(-cum)
    if inclusive:
        q_eff = qf * p_t
    else:
        q_eff = qf * torch.exp((cum - lw).clamp_min(_LOG_MIN))  # P_{t-1} = P_t / w_t
    k_eff = kf * inv_p

    # Intra-chunk masked attention.
    s = torch.einsum("bnthd,bnshd->bnhts", q_eff, k_eff)      # (B,n,H,t,s)
    ti = torch.arange(chunk, device=q.device)
    mask = ti[:, None] >= ti[None, :] if inclusive else ti[:, None] > ti[None, :]
    s = torch.where(mask, s, 0.0)
    intra = torch.einsum("bnhts,bnshd->bnthd", s, vf)         # (B,n,t,H,Dv)

    if bonus is not None:
        diag = (qf * (kf * bonus)).sum(dim=-1)                # (B,n,t,H)
        intra = intra + diag[..., None] * vf

    # Inter-chunk: the chunk states S_c, one chunk after another.
    p_last = p_t[:, :, -1]                                    # (B,n,H,Dk)
    kv_chunk = torch.einsum("bnshd,bnshe->bnhde", k_eff, vf)  # (B,n,H,Dk,Dv)
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((B, H, Dk, Dv), dtype=torch.float32, device=q.device))
    prevs = []
    for c in range(n):
        prevs.append(state)
        state = p_last[:, c, :, :, None] * (state + kv_chunk[:, c])
    s_prevs = torch.stack(prevs, dim=1)                       # (B,n,H,Dk,Dv)
    inter = torch.einsum("bnthd,bnhde->bnthe", q_eff, s_prevs)
    out = (intra + inter).reshape(B, n * chunk, H, Dv)[:, :S]
    return out.to(q.dtype), state


def linear_attention_step(
    q: torch.Tensor,        # (B, H, Dk) one step
    k: torch.Tensor,
    v: torch.Tensor,        # (B, H, Dv)
    w: torch.Tensor,        # (B, H, Dk) decay in (0,1)
    state: torch.Tensor,    # (B, H, Dk, Dv)
    *,
    bonus: torch.Tensor | None = None,
    inclusive: bool = True,
):
    """Single-token recurrence; mirrors the chunked math."""
    qf, kf, vf, wf = (t.float() for t in (q, k, v, w))
    st = state.float()
    kv = kf[..., :, None] * vf[..., None, :]
    if inclusive:
        new_state = wf[..., None] * st + kv
        out = torch.einsum("bhd,bhde->bhe", qf, new_state)
    else:
        read = st + bonus[None, ..., None] * kv if bonus is not None else st
        out = torch.einsum("bhd,bhde->bhe", qf, read)
        new_state = wf[..., None] * st + kv
    return out.to(q.dtype), new_state.to(state.dtype)


# ---------------------------------------------------------------------------
# RWKV6 (Finch) blocks
# ---------------------------------------------------------------------------
def rwkv6_heads(cfg: ModelConfig) -> tuple[int, int]:
    """(heads, head width) of an RWKV6 layer: ``d // 64`` heads unless set."""
    H = cfg.n_heads if cfg.n_heads else cfg.d_model // 64
    return H, cfg.d_model // H


def build_rwkv6_params(cfg: ModelConfig, b):
    L = (cfg.n_layers,)
    lax_ = ("layers",)
    d = cfg.d_model
    H, hd = rwkv6_heads(cfg)
    lora = 64
    blocks = {
        "ln1": b(L + (d,), lax_ + ("embed",), init="ones"),
        "ln2": b(L + (d,), lax_ + ("embed",), init="ones"),
        # time-mix lerp coefficients (token shift)
        "mu_r": b(L + (d,), lax_ + ("embed",), init="zeros"),
        "mu_k": b(L + (d,), lax_ + ("embed",), init="zeros"),
        "mu_v": b(L + (d,), lax_ + ("embed",), init="zeros"),
        "mu_w": b(L + (d,), lax_ + ("embed",), init="zeros"),
        "mu_g": b(L + (d,), lax_ + ("embed",), init="zeros"),
        "w_r": b(L + (d, H, hd), lax_ + ("embed", "heads", "hd")),
        "w_k": b(L + (d, H, hd), lax_ + ("embed", "heads", "hd")),
        "w_v": b(L + (d, H, hd), lax_ + ("embed", "heads", "hd")),
        "w_g": b(L + (d, d), lax_ + ("embed", "mlp")),
        "w_o": b(L + (H, hd, d), lax_ + ("heads", "hd", "embed")),
        # data-dependent decay LoRA (Finch): w_t = exp(-exp(base + lora(x)))
        "decay_base": b(L + (H, hd), lax_ + ("heads", "hd"), init="zeros"),
        "decay_lora_a": b(L + (d, lora), lax_ + ("embed", "rank")),
        "decay_lora_b": b(L + (lora, H, hd), lax_ + ("rank", "heads", "hd"), init="zeros"),
        "bonus": b(L + (H, hd), lax_ + ("heads", "hd"), init="zeros"),
        "gn": b(L + (H, hd), lax_ + ("heads", "hd"), init="ones"),
        # channel-mix FFN
        "mu_ffn_k": b(L + (d,), lax_ + ("embed",), init="zeros"),
        "w_ffn_k": b(L + (d, cfg.d_ff), lax_ + ("embed", "mlp")),
        "w_ffn_v": b(L + (cfg.d_ff, d), lax_ + ("mlp", "embed")),
        "w_ffn_r": b(L + (d, d), lax_ + ("embed", "mlp")),
    }
    return {
        "embed": b((cfg.vocab, d), ("vocab", "embed"), scale=0.02),
        "blocks": blocks,
        "ln_out": b((d,), ("embed",), init="ones"),
        "unembed": b((d, cfg.vocab), ("embed", "vocab")),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """x (B,S,d) -> previous-token features (zero/carry at position 0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


_TIME_MIX_SPLIT = (("w_r", -2), ("w_k", -2), ("w_v", -2), ("w_g", -1), ("w_o", -3),
                   ("decay_base", -2), ("decay_lora_b", -2), ("bonus", -2), ("gn", -2))
TIME_MIX_COPIES = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "decay_lora_a")


def rwkv6_block(cfg: ModelConfig, p, x, *, state=None):
    """One RWKV6 layer (time-mix + channel-mix).

    ``state`` is ``(S, shift_a, shift_b)``: the wkv matrix state plus the two
    token-shift carries (time-mix and channel-mix).  Returns (y, new_state).

    Under a tensor-parallel context that splits "heads" each local shard
    runs the time-mix of its heads (``w_r``/``w_k``/``w_v`` and the decay
    and bonus blocks, the chunked scan and the per-head group norm; its
    block of ``w_g``'s columns, which are its heads' channels) from the
    normed input, with its copies of the mixes and the decay LoRA's
    ``decay_lora_a``; ``w_o`` is row-parallel.  Under one that splits
    "mlp" the channel-mix's ``w_ffn_k`` is column- and ``w_ffn_v``
    row-parallel; the receptance gate ``w_ffn_r`` (its columns are the
    residual's channels) runs whole.  The wkv state returned is the last
    local shard's.
    """
    B, S, d = x.shape
    H, hd = rwkv6_heads(cfg)
    wkv_state, shift_a, shift_b = state if state is not None else (None, None, None)

    xa = rms_norm(x, p["ln1"], cfg.norm_eps)
    tp = shard_ctx.split("heads")
    hs = H // tp.size
    per = {k: tp.shards(p[k], dim) for k, dim in _TIME_MIX_SPLIT}
    per.update({k: tp.copies(p[k]) for k in TIME_MIX_COPIES})
    parts = []
    for j, xaj in enumerate(tp.enter(xa)):
        pj = {k: v[j] for k, v in per.items()}
        xs = _token_shift(xaj, shift_a)

        def mix(mu):
            return xaj + (xs - xaj) * torch.sigmoid(mu)

        r = _heads(mix(pj["mu_r"]), pj["w_r"])
        k = _heads(mix(pj["mu_k"]), pj["w_k"])
        v = _heads(mix(pj["mu_v"]), pj["w_v"])
        g = F.silu((mix(pj["mu_g"]) @ pj["w_g"]).float()).to(x.dtype)

        lora = mix(pj["mu_w"]) @ pj["decay_lora_a"]
        lora = _heads(torch.tanh(lora.float()).to(x.dtype), pj["decay_lora_b"])
        # log w_t = -exp(·) < 0 ⇒ w ∈ (0,1)
        log_w = -torch.exp(torch.clamp(pj["decay_base"].float() + lora.float(), -8.0, 4.0))

        o, new_wkv = chunked_linear_attention(
            r, k, v, log_w, bonus=pj["bonus"].float(), inclusive=False, chunk=cfg.ssm_chunk,
            initial_state=wkv_state)
        o32 = o.float()
        o32 = o32 * torch.rsqrt((o32 * o32).mean(dim=-1, keepdim=True) + cfg.norm_eps)
        o = (o32 * pj["gn"].float()).to(x.dtype)
        o = o.reshape(B, S, hs * hd) * g
        parts.append(_merge_heads(o.reshape(B, S, hs, hd), pj["w_o"]))
    x = x + tp.leave(parts)
    new_shift_a = xa[:, -1:]

    xb = rms_norm(x, p["ln2"], cfg.norm_eps)
    xbs = _token_shift(xb, shift_b)
    kin = xb + (xbs - xb) * torch.sigmoid(p["mu_ffn_k"])
    tp = shard_ctx.split("mlp")
    parts = []
    for kj, wk, wv in zip(tp.enter(kin), tp.shards(p["w_ffn_k"], -1),
                          tp.shards(p["w_ffn_v"], -2)):
        kf = torch.square(torch.relu((kj @ wk).float())).to(x.dtype)
        parts.append(kf @ wv)
    ffn = tp.leave(parts)
    rg = torch.sigmoid((xbs @ p["w_ffn_r"]).float()).to(x.dtype)
    x = x + ffn * rg
    return x, (new_wkv, new_shift_a, xb[:, -1:])


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block — used by the zamba2 hybrid
# ---------------------------------------------------------------------------
MAMBA_HEAD = 64          # Mamba2's head width: d_inner // 64 heads


def build_mamba2_params(cfg: ModelConfig, b, d_inner: int, prefix_layers=True):
    L = (cfg.n_layers,) if prefix_layers else ()
    lax_ = ("layers",) if prefix_layers else ()
    d = cfg.d_model
    N = cfg.ssm_state
    H = d_inner // MAMBA_HEAD
    return {
        "ln": b(L + (d,), lax_ + ("embed",), init="ones"),
        "w_in": b(L + (d, 2 * d_inner), lax_ + ("embed", "mlp")),
        "w_bc": b(L + (d, 2 * N), lax_ + ("embed", "state")),
        "w_dt": b(L + (d, H), lax_ + ("embed", "heads")),
        "dt_bias": b(L + (H,), lax_ + ("heads",), init="zeros"),
        "a_log": b(L + (H,), lax_ + ("heads",), init="zeros"),
        "conv_w": b(L + (4, d_inner + 2 * N), lax_ + (None, "mlp"), scale=0.5),
        "d_skip": b(L + (H,), lax_ + ("heads",), init="ones"),
        "gn": b(L + (d_inner,), lax_ + ("mlp",), init="ones"),
        "w_out": b(L + (d_inner, d), lax_ + ("mlp", "embed")),
    }


def mamba2_block(cfg: ModelConfig, p, x, d_inner: int, *, state=None, conv_state=None):
    """Mamba2/SSD block (simplified single-group).  Returns (y, (ssm, conv)):
    the state (B, H, N, 64) float32 and the last 3 conv inputs (B, 3, C).

    Under a tensor-parallel context that splits "ssm_heads" each local
    shard runs its heads from the normed input: their ``z`` and ``u``
    columns of ``w_in`` and ``u`` channels of ``conv_w`` (both whole
    leaves: their contiguous blocks are not a shard's heads), the shared
    ``b``/``c`` channels with its copy of ``w_bc``, and its blocks of
    ``w_dt``, ``dt_bias``, ``a_log``, ``d_skip`` and ``gn``.  The gated
    norm's mean of squares over all of ``d_inner`` is the shards' sums of
    squares summed over ``model`` (entered again: each shard's share of
    its gradient is summed back); ``w_out`` is row-parallel.  The states
    returned are the last local shard's."""
    B, S, d = x.shape
    N = cfg.ssm_state
    P = MAMBA_HEAD
    H = d_inner // P
    tp = shard_ctx.split("ssm_heads")
    hs = H // tp.size
    n = hs * P                                         # a shard's channels

    xi = rms_norm(x, p["ln"], cfg.norm_eps)
    per = {k: tp.shards(p[k], -1) for k in ("w_dt", "dt_bias", "a_log", "d_skip", "gn")}
    per.update({"w_out": tp.shards(p["w_out"], -2),
                **{k: tp.copies(p[k]) for k in ("w_in", "w_bc", "conv_w")}})
    heads = []
    for j, xij in enumerate(tp.enter(xi)):
        pj = {k: v[j] for k, v in per.items()}
        w_in, w = pj["w_in"], pj["conv_w"]
        if tp.mesh is not None:        # the shard's z, u columns; its u and the b, c channels
            lo = tp.shard(j) * n
            w_in = torch.cat([w_in.narrow(-1, lo, n), w_in.narrow(-1, d_inner + lo, n)], -1)
            w = torch.cat([w.narrow(-1, lo, n), w[..., d_inner:]], -1)
        z, u = (xij @ w_in).split(n, dim=-1)           # gate, value (B,S,n)
        bc = xij @ pj["w_bc"]                          # (B,S,2N)

        # depthwise causal conv (width 4) over concat([u, bc])
        cu = torch.cat([u, bc], dim=-1)
        if conv_state is None:
            conv_in = F.pad(cu, (0, 0, 3, 0))
        else:
            conv_in = torch.cat([conv_state.to(cu.dtype), cu], dim=1)
        conv = sum(conv_in[:, i : i + S] * w[i] for i in range(4))
        conv = F.silu(conv.float()).to(x.dtype)
        u_c, bc_c = conv[..., :n], conv[..., n:]
        b_in, c_in = bc_c.split(N, dim=-1)             # (B,S,N) each
        new_conv_state = conv_in[:, S : S + 3] if conv_state is not None else cu[:, -3:]

        dt = F.softplus((xij @ pj["w_dt"]).float() + pj["dt_bias"].float())   # (B,S,hs)
        a = -torch.exp(pj["a_log"].float())            # (hs,) negative
        log_decay = dt * a                             # (B,S,hs) = log w_t

        uh = u_c.reshape(B, S, hs, P).float() * dt[..., None]
        q = c_in[:, :, None, :].expand(B, S, hs, N)
        k = b_in[:, :, None, :].expand(B, S, hs, N)
        lw = log_decay[..., None].expand(B, S, hs, N)

        o, new_state = chunked_linear_attention(
            q, k, uh.to(x.dtype), lw, inclusive=True, chunk=cfg.ssm_chunk, initial_state=state)
        o = o.float() + pj["d_skip"].float()[:, None] * u_c.reshape(B, S, hs, P).float()
        heads.append((o.reshape(B, S, n), z, pj))
    if tp.mesh is None:
        ((o, z, pj),) = heads
        means = [(o * o).mean(dim=-1, keepdim=True)]
    else:                          # the mean over every shard's channels
        sq = tp.leave([(o * o).sum(dim=-1, keepdim=True) for o, _, _ in heads])
        means = [m / d_inner for m in tp.enter(sq)]
    parts = []
    for (o, z, pj), m in zip(heads, means):
        o = o * torch.rsqrt(m + cfg.norm_eps)
        o = (o * pj["gn"].float()).to(x.dtype)
        o = o * F.silu(z.float()).to(x.dtype)
        parts.append(o @ pj["w_out"])
    return x + tp.leave(parts), (new_state, new_conv_state)
