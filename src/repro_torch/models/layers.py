"""Layer primitives of every model family (port of ``repro.models.layers``).

Conventions as in the reference: x (B, S, D); q (B, S, H, hd); k, v
(B, S, KV, hd) with GQA group G = H // KV.  Mixed precision follows the
reference: norms and rope in f32 cast back to the activation dtype,
attention scores and softmax in f32, the MoE router's probabilities in
f32.  Attention is a plain masked matmul + softmax (the reference's
online-softmax ``chunked_attention`` is jnp, not a kernel); the two agree
up to f32 summation order.  The MoE dispatch and combine are the
reference's one-hot einsums: no scatter, so the card's deterministic mode
needs no ``index_add_``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.types import ArchConfig


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    init: str = "normal"      # normal | zeros | ones | small | alog
    scale: float = 0.02


def scalar_like(value, x):
    """``value`` as a 0-dim tensor of x's dtype: JAX casts a Python scalar
    to the array's dtype before the op, PyTorch keeps it in f32."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def rmsnorm(x, w, eps=1e-5):
    x32 = x.to(torch.float32)
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(x.dtype) * w


def rope(x, positions, theta):
    """x: (..., S, H, hd); positions: (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=x.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs       # (S, half)
    ang = ang[..., None, :]                                     # (S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attn_defs(cfg: ArchConfig, cross: bool = False):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    d = {
        "wq": ParamDef((D, H * hd)),
        "wk": ParamDef((D, KV * hd)),
        "wv": ParamDef((D, KV * hd)),
        "wo": ParamDef((H * hd, D)),
        "ln": ParamDef((D,), "ones"),
    }
    if cfg.qkv_bias and not cross:
        d["bq"] = ParamDef((H * hd,), "zeros")
        d["bk"] = ParamDef((KV * hd,), "zeros")
        d["bv"] = ParamDef((KV * hd,), "zeros")
    return d


def qkv(p, x, cfg: ArchConfig, positions, use_rope=True):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q * scalar_like(hd ** -0.5, q), k, v


def attention(q, k, v, *, causal=True, window=0):
    """Plain masked GQA self-attention over one sequence's positions:
    key c is seen by query q if ``c <= q`` (causal) and ``c > q - window``
    (``window > 0``); f32 scores and softmax, output cast back to q's
    dtype, (B, S, H * hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).to(torch.float32)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.to(torch.float32))
    if causal or window:
        pos = torch.arange(S, device=q.device)
        kp, qp = pos[None, :], pos[:, None]
        mask = kp <= qp if causal else None
        if window:
            seen = kp > qp - window
            mask = seen if mask is None else mask & seen
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckd->bqkgd", p, v.to(torch.float32))
    return out.reshape(B, S, H * hd).to(q.dtype)


# --- cross attention (whisper decoder) ---------------------------------------

def cross_attn_defs(cfg: ArchConfig):
    return attn_defs(cfg, cross=True)


def cross_attention(p, x, enc_kv, cfg: ArchConfig):
    """enc_kv: precomputed (ek, ev) each (B, T, KV, hd); no mask, no rope."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, S, H, hd)
    q = q * scalar_like(hd ** -0.5, q)
    ek, ev = enc_kv
    qg = q.reshape(B, S, KV, H // KV, hd).to(torch.float32)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, ek.to(torch.float32))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckd->bqkgd", w, ev.to(torch.float32))
    out = out.reshape(B, S, H * hd).to(x.dtype)
    return x + out @ p["wo"]


def encode_cross_kv(p, enc_out, cfg: ArchConfig):
    B, T, _ = enc_out.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    ek = (enc_out @ p["wk"]).reshape(B, T, KV, hd)
    ev = (enc_out @ p["wv"]).reshape(B, T, KV, hd)
    return ek, ev


# ---------------------------------------------------------------------------
# FFN: gated (llama/qwen) and plain gelu (whisper)
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ArchConfig, gated=True):
    D, F_ = cfg.d_model, cfg.d_ff
    d = {"ln": ParamDef((D,), "ones"),
         "w_up": ParamDef((D, F_)),
         "w_down": ParamDef((F_, D))}
    if gated:
        d["w_gate"] = ParamDef((D, F_))
    return d


def mlp_block(p, x, cfg: ArchConfig):
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    up = h @ p["w_up"]
    if "w_gate" in p:
        up = F.silu(h @ p["w_gate"]) * up
    else:
        up = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    return x + up @ p["w_down"]


# ---------------------------------------------------------------------------
# MoE (top-k routing with per-expert capacity)
# ---------------------------------------------------------------------------

def moe_defs(cfg: ArchConfig):
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "ln": ParamDef((D,), "ones"),
        "router": ParamDef((D, E)),
        "w_gate": ParamDef((E, D, F_)),
        "w_up": ParamDef((E, D, F_)),
        "w_down": ParamDef((E, F_, D)),
    }


def moe_capacity(cfg: ArchConfig, S: int) -> int:
    """Per-expert slots for a sequence of S tokens."""
    return max(1, int(cfg.expert_capacity_factor * S * cfg.experts_per_token
                      / cfg.num_experts))


def moe_route(h, router, cfg: ArchConfig):
    """The router on normed tokens h (B, S, D): ``(probs (B, S, E) f32,
    gate_idx (B, S, K), sel (B, S, K, E) f32 one-hot, pos_in_e (B, S, E)
    f32 — each token's place in its experts' queues — and keep = pos_in_e
    < capacity)``.  ``gate_idx`` is ``lax.top_k``'s: probabilities
    descending, ties to the lower expert (a stable sort)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax((h @ router).to(torch.float32), dim=-1)
    gate_idx = torch.sort(probs, dim=-1, descending=True,
                          stable=True).indices[..., :K]
    experts = torch.arange(E, device=h.device)
    sel = (gate_idx[..., None] == experts).to(torch.float32)
    # the queue position counts earlier tokens, 0/1 terms: an integer
    # cumsum is exact, and unlike a float one is deterministic on the card
    chosen = sel.sum(2).to(torch.int32)
    pos_in_e = (torch.cumsum(chosen, dim=1) - chosen).to(torch.float32)
    keep = pos_in_e < moe_capacity(cfg, h.shape[1])
    return probs, gate_idx, sel, pos_in_e, keep


def moe_block(p, x, cfg: ArchConfig):
    """Top-k routing with per-expert capacity; returns (y, aux_loss).
    Tokens past an expert's capacity get no slot there (the reference's
    all-zero one-hot of an out-of-range index)."""
    E = cfg.num_experts
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    probs, _, sel, pos_in_e, keep = moe_route(h, p["router"], cfg)
    # the gate values probs[gate_idx] as one-hot sums: one nonzero term
    gate_vals = (sel * probs[..., None, :]).sum(-1)             # (B,S,K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    combine = (sel * gate_vals[..., None]).sum(2) * keep        # (B,S,E)
    slots = torch.arange(moe_capacity(cfg, x.shape[1]), device=x.device,
                         dtype=torch.float32)
    disp = (pos_in_e[..., None] == slots).to(x.dtype) \
        * (combine > 0)[..., None].to(x.dtype)                  # (B,S,E,C)

    xe = torch.einsum("bsec,bsd->becd", disp, h)                # (B,E,C,D)
    a = torch.einsum("becd,edf->becf", xe, p["w_gate"])
    u = torch.einsum("becd,edf->becf", xe, p["w_up"])
    y = torch.einsum("becf,efd->becd", F.silu(a) * u, p["w_down"])
    out = torch.einsum("bsec,becd->bsd",
                       disp * combine[..., None].to(x.dtype), y)

    # load-balance aux loss (Switch-style)
    frac_tokens = (sel.sum(2) > 0).to(torch.float32).mean((0, 1))  # (E,)
    frac_prob = probs.mean((0, 1))
    aux = E * torch.sum(frac_tokens * frac_prob)
    return x + out, aux
