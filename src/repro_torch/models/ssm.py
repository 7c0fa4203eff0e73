"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) block (port of
``repro.models.ssm``).

The chunked SSD form: intra-chunk terms are dense (L x L) products, and the
inter-chunk recurrence is a loop over the S / L chunks (the reference's
``lax.scan``).  Shapes: x (B, S, D); internal x~ (B, S, H, P) with
H = d_inner / P heads, B~ / C~ (B, S, G, N) with G = 1 group, state
N = ``cfg.ssm_state``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.types import ArchConfig
from repro_torch.models.layers import ParamDef, rmsnorm


def ssm_dims(cfg: ArchConfig):
    d_inner = cfg.d_inner
    H = cfg.ssm_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    G = 1
    conv_dim = d_inner + 2 * G * N
    d_in_proj = 2 * d_inner + 2 * G * N + H
    return d_inner, H, P, N, G, conv_dim, d_in_proj


def mamba_defs(cfg: ArchConfig):
    D = cfg.d_model
    d_inner, H, P, N, G, conv_dim, d_in_proj = ssm_dims(cfg)
    return {
        "ln": ParamDef((D,), "ones"),
        "in_proj": ParamDef((D, d_in_proj)),
        "conv_w": ParamDef((cfg.ssm_conv_width, conv_dim)),
        "conv_b": ParamDef((conv_dim,), "zeros"),
        "A_log": ParamDef((H,), "alog"),
        "D": ParamDef((H,), "ones"),
        "dt_bias": ParamDef((H,), "zeros"),
        "norm": ParamDef((d_inner,), "ones"),
        "out_proj": ParamDef((d_inner, D)),
    }


def _split_proj(zxbcdt, cfg):
    d_inner, H, P, N, G, conv_dim, _ = ssm_dims(cfg)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt = zxbcdt[..., d_inner + conv_dim:]
    return z, xBC, dt


def _split_xbc(xBC, cfg):
    d_inner, H, P, N, G, _, _ = ssm_dims(cfg)
    x = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + G * N]
    Cm = xBC[..., d_inner + G * N:]
    B_, S = x.shape[0], x.shape[1]
    return (x.reshape(B_, S, H, P),
            Bm.reshape(B_, S, G, N),
            Cm.reshape(B_, S, G, N))


def causal_conv(xBC, w, b, cfg):
    """Depthwise causal conv, width W, via shifted adds (no conv primitive)."""
    W = cfg.ssm_conv_width
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + xBC.shape[1]] * w[i] for i in range(W))
    return F.silu(out + b)


def _prefix_sum(x, dim):
    """Inclusive prefix sum along ``dim`` by doubling (Hillis–Steele):
    log2(n) shifted adds.  Deterministic on the card, where ``torch.cumsum``
    of a float tensor is refused under ``use_deterministic_algorithms``;
    it agrees with a sequential sum up to f32 summation order."""
    n = x.shape[dim]
    step = 1
    while step < n:
        head = torch.zeros_like(x.narrow(dim, 0, step))
        x = x + torch.cat([head, x.narrow(dim, 0, n - step)], dim=dim)
        step *= 2
    return x


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk):
    """Chunked SSD forward. x (B,S,H,P), dt (B,S,H), A (H,) <= 0,
    Bm / Cm (B,S,G,N)."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD "
                         f"chunk {L}")
    nc = S // L
    f32 = torch.float32

    xc = x.reshape(B_, nc, L, H, P).to(f32)
    dtc = dt.reshape(B_, nc, L, H).to(f32)
    Bc = Bm.reshape(B_, nc, L, G, N).to(f32)[..., 0, :]        # (B,nc,L,N)
    Cc = Cm.reshape(B_, nc, L, G, N).to(f32)[..., 0, :]

    dA = dtc * A.to(f32)                                    # (B,nc,L,H) <= 0
    A_cs = _prefix_sum(dA, 2)                                   # inclusive
    A_end = A_cs[:, :, -1:, :]                                  # (B,nc,1,H)

    # intra-chunk (dual / quadratic) term.  The exponent is masked BEFORE
    # the exp: for j > i it is positive and can overflow, and the gradient
    # through a mask applied after it would carry the NaN
    diff = A_cs[:, :, :, None, :] - A_cs[:, :, None, :, :]      # (B,nc,i,j,H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(mask[None, None, ..., None], diff, -1e9))
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)                # (B,nc,L,L)
    M = CB[..., None] * decay
    M = M * dtc[:, :, None, :, :]                           # weight by dt_j
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", M, xc)

    # chunk states: contribution of chunk c to the running state
    decay_end = torch.exp(A_end - A_cs)                         # (B,nc,L,H)
    S_c = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, decay_end * dtc, xc)

    # inter-chunk recurrence: the state entering each chunk
    A_tot = torch.exp(A_end[:, :, 0, :])                        # (B,nc,H)
    h = torch.zeros((B_, H, N, P), dtype=f32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * A_tot[:, c, :, None, None] + S_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                       # (B,nc,H,N,P)

    y_off = torch.einsum("bcin,bchnp,bcih->bcihp", Cc, h_prevs,
                         torch.exp(A_cs))
    y = (y_diag + y_off).reshape(B_, S, H, P) \
        + D.to(f32)[None, None, :, None] * x.to(f32)
    return y.to(x.dtype)


def mamba_block(p, x, cfg: ArchConfig):
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    zxbcdt = h @ p["in_proj"]
    z, xBC, dt_raw = _split_proj(zxbcdt, cfg)
    xBC = causal_conv(xBC, p["conv_w"], p["conv_b"], cfg)
    xs, Bm, Cm = _split_xbc(xBC, cfg)
    dt = F.softplus(dt_raw.to(torch.float32)
                    + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))
    y = ssd_chunked(xs, dt, A, Bm, Cm, p["D"], cfg.ssm_chunk)
    B_, S = x.shape[0], x.shape[1]
    y = y.reshape(B_, S, -1)
    y = rmsnorm(y, p["norm"], cfg.norm_eps) * F.silu(z)
    return x + y @ p["out_proj"]
