"""Layer primitives of the dense ``attn+mlp`` family (port of
``repro.models.layers``).

Conventions as in the reference: x (B, S, D); q (B, S, H, hd); k, v
(B, S, KV, hd) with GQA group G = H // KV.  Mixed precision follows the
reference: norms and rope in f32 cast back to the activation dtype,
attention scores and softmax in f32.  Attention is a plain causal
matmul + softmax (the reference's online-softmax ``chunked_attention`` is
jnp, not a kernel); the two agree up to f32 summation order.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.types import ArchConfig


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    init: str = "normal"      # normal | ones
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


def attn_defs(cfg: ArchConfig):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamDef((D, H * hd)),
        "wk": ParamDef((D, KV * hd)),
        "wv": ParamDef((D, KV * hd)),
        "wo": ParamDef((H * hd, D)),
        "ln": ParamDef((D,), "ones"),
    }


def qkv(p, x, cfg: ArchConfig, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q * scalar_like(hd ** -0.5, q), k, v


def causal_attention(q, k, v):
    """Plain causal GQA attention: f32 scores and softmax, output cast
    back to q's dtype, (B, S, H * hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).to(torch.float32)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.to(torch.float32))
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]                          # (q, c)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckd->bqkgd", p, v.to(torch.float32))
    return out.reshape(B, S, H * hd).to(q.dtype)


def mlp_defs(cfg: ArchConfig):
    D, F_ = cfg.d_model, cfg.d_ff
    return {"ln": ParamDef((D,), "ones"),
            "w_up": ParamDef((D, F_)),
            "w_down": ParamDef((F_, D)),
            "w_gate": ParamDef((D, F_))}


def mlp_block(p, x, cfg: ArchConfig):
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    up = F.silu(h @ p["w_gate"]) * (h @ p["w_up"])
    return x + up @ p["w_down"]
