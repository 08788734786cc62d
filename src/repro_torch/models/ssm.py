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


def rwkv6_block(cfg: ModelConfig, p, x, *, state=None):
    """One RWKV6 layer (time-mix + channel-mix).

    ``state`` is ``(S, shift_a, shift_b)``: the wkv matrix state plus the two
    token-shift carries (time-mix and channel-mix).  Returns (y, new_state).
    """
    B, S, d = x.shape
    H, hd = rwkv6_heads(cfg)
    wkv_state, shift_a, shift_b = state if state is not None else (None, None, None)

    xa = rms_norm(x, p["ln1"], cfg.norm_eps)
    xs = _token_shift(xa, shift_a)

    def mix(mu):
        return xa + (xs - xa) * torch.sigmoid(mu)

    r = _heads(mix(p["mu_r"]), p["w_r"])
    k = _heads(mix(p["mu_k"]), p["w_k"])
    v = _heads(mix(p["mu_v"]), p["w_v"])
    g = F.silu((mix(p["mu_g"]) @ p["w_g"]).float()).to(x.dtype)

    lora = mix(p["mu_w"]) @ p["decay_lora_a"]
    lora = _heads(torch.tanh(lora.float()).to(x.dtype), p["decay_lora_b"])
    # log w_t = -exp(·) < 0 ⇒ w ∈ (0,1)
    log_w = -torch.exp(torch.clamp(p["decay_base"].float() + lora.float(), -8.0, 4.0))

    o, new_wkv = chunked_linear_attention(
        r, k, v, log_w, bonus=p["bonus"].float(), inclusive=False, chunk=cfg.ssm_chunk,
        initial_state=wkv_state)
    o32 = o.float()
    o32 = o32 * torch.rsqrt((o32 * o32).mean(dim=-1, keepdim=True) + cfg.norm_eps)
    o = (o32 * p["gn"].float()).to(x.dtype)
    o = o.reshape(B, S, d) * g
    x = x + _merge_heads(o.reshape(B, S, H, hd), p["w_o"])
    new_shift_a = xa[:, -1:]

    xb = rms_norm(x, p["ln2"], cfg.norm_eps)
    xbs = _token_shift(xb, shift_b)
    kf = (xb + (xbs - xb) * torch.sigmoid(p["mu_ffn_k"])) @ p["w_ffn_k"]
    kf = torch.square(torch.relu(kf.float())).to(x.dtype)
    ffn = kf @ p["w_ffn_v"]
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
    the state (B, H, N, 64) float32 and the last 3 conv inputs (B, 3, C)."""
    B, S, d = x.shape
    N = cfg.ssm_state
    P = MAMBA_HEAD
    H = d_inner // P

    xi = rms_norm(x, p["ln"], cfg.norm_eps)
    z, u = (xi @ p["w_in"]).split(d_inner, dim=-1)   # gate, value (B,S,d_inner)
    bc = xi @ p["w_bc"]                                # (B,S,2N)

    # depthwise causal conv (width 4) over concat([u, bc])
    cu = torch.cat([u, bc], dim=-1)
    if conv_state is None:
        conv_in = F.pad(cu, (0, 0, 3, 0))
    else:
        conv_in = torch.cat([conv_state.to(cu.dtype), cu], dim=1)
    w = p["conv_w"]                                    # (4, channels)
    conv = sum(conv_in[:, i : i + S] * w[i] for i in range(4))
    conv = F.silu(conv.float()).to(x.dtype)
    u_c, bc_c = conv[..., :d_inner], conv[..., d_inner:]
    b_in, c_in = bc_c.split(N, dim=-1)                 # (B,S,N) each
    new_conv_state = conv_in[:, S : S + 3] if conv_state is not None else cu[:, -3:]

    dt = F.softplus((xi @ p["w_dt"]).float() + p["dt_bias"].float())   # (B,S,H)
    a = -torch.exp(p["a_log"].float())                 # (H,) negative
    log_decay = dt * a                                 # (B,S,H) = log w_t

    uh = u_c.reshape(B, S, H, P).float() * dt[..., None]
    q = c_in[:, :, None, :].expand(B, S, H, N)
    k = b_in[:, :, None, :].expand(B, S, H, N)
    lw = log_decay[..., None].expand(B, S, H, N)

    o, new_state = chunked_linear_attention(
        q, k, uh.to(x.dtype), lw, inclusive=True, chunk=cfg.ssm_chunk, initial_state=state)
    o = o.float() + p["d_skip"].float()[:, None] * u_c.reshape(B, S, H, P).float()
    o = o.reshape(B, S, d_inner)
    o = o * torch.rsqrt((o * o).mean(dim=-1, keepdim=True) + cfg.norm_eps)
    o = (o * p["gn"].float()).to(x.dtype)
    o = o * F.silu(z.float()).to(x.dtype)
    return x + o @ p["w_out"], (new_state, new_conv_state)
