"""Layer primitives of every model family (port of ``repro.models.layers``).

Conventions as in the reference: x (B, S, D); q (B, S, H, hd); k, v
(B, S, KV, hd) with GQA group G = H // KV.  Mixed precision follows the
reference: norms and rope in f32 cast back to the activation dtype,
attention scores and softmax in f32, the MoE router's probabilities in
f32.  Self-attention is the reference's doubly tiled online softmax
(``chunked_attention``, plain tensor ops: the reference has no kernel for
it), whose temporaries are bounded by the chunk sizes at any sequence
length; ``attention`` is its plain one-softmax version.  Decoding reads a
ring-buffer KV cache (``attn_cache_defs``, ``attention_decode``), bf16 or
int8 with per-(token, head) scales.  The MoE dispatch and combine are the
reference's one-hot einsums: no scatter, so the card's deterministic mode
needs no ``index_add_``.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import ArchConfig


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    logical: tuple = ()       # the reference's logical axis name per dim
    init: str = "normal"      # normal | zeros | ones | small | alog
    scale: float = 0.02


def scalar_like(value, x):
    """``value`` as a 0-dim tensor of x's dtype: JAX casts a Python scalar
    to the array's dtype before the op, PyTorch keeps it in f32.  A fill
    on the device, not a copy from the host, which would synchronise."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def rmsnorm(x, w, eps=1e-5):
    x32 = x.to(torch.float32)
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(x.dtype) * w


def rope(x, positions, theta):
    """x: (..., S, H, hd); positions: (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
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
        "wq": ParamDef((D, H * hd), ("embed", "heads")),
        "wk": ParamDef((D, KV * hd), ("embed", "kv_heads")),
        "wv": ParamDef((D, KV * hd), ("embed", "kv_heads")),
        "wo": ParamDef((H * hd, D), ("heads", "embed")),
        "ln": ParamDef((D,), ("norm",), "ones"),
    }
    if cfg.qkv_bias and not cross:
        d["bq"] = ParamDef((H * hd,), ("heads",), "zeros")
        d["bk"] = ParamDef((KV * hd,), ("kv_heads",), "zeros")
        d["bv"] = ParamDef((KV * hd,), ("kv_heads",), "zeros")
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


def remat_call(fn, *args, remat=True):
    """``fn(*args)``, under ``remat`` rematerialised in the backward
    (``jax.checkpoint``'s counterpart): the forward keeps only ``args``
    and the output, and the backward runs ``fn`` again.  The model draws
    no random numbers, so no RNG state is kept; without autograd (no
    grad mode) there is nothing to save and ``fn`` runs as it is."""
    if not remat or not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


# the f32 elements of one score tile (256 MiB): query chunks are batched
# into one tile up to this size, so that long sequences launch fewer,
# larger operations while the temporaries stay bounded
TILE_ELEMS = 1 << 26


def _tile_seen(q_lo, q_hi, k_lo, k_hi, causal, window):
    """Whether any query position in [q_lo, q_hi] sees any key position
    in [k_lo, k_hi]."""
    return (not causal or k_lo <= q_hi) and \
        (not window or k_hi > q_lo - window)


def chunked_attention(q, k, v, *, q_positions=None, k_positions=None,
                      causal=True, window=0, chunk=512, chunk_q=512,
                      remat=False):
    """Online-softmax attention, doubly tiled: queries in chunks of
    ``chunk_q``, each running over KV chunks of ``chunk``, so the score
    temporaries are bounded by the chunk sizes at any length.  GQA
    grouping, causal and sliding-window masks by position (key c is seen
    by query q where ``0 <= c``, ``c <= q`` if causal, ``c > q - window``
    if ``window``); keys are padded to a chunk multiple and queries to a
    ``chunk_q`` multiple with position -1.  The running max ``m``, sum
    ``l`` and accumulator are f32; a row that no key has reached yet keeps
    ``m = -inf`` (``m_safe`` 0, ``corr`` 0), and the output is cast back
    to q's dtype: (B, Sq, H * hd).

    Query chunks run side by side, as many at a time as fit a score tile
    of ``TILE_ELEMS`` f32 elements; each query chunk's rows see the KV
    chunks in order, as in the reference.  Positions default to
    ``arange``, and then a KV chunk that no query of the tile can see is
    skipped: for such a chunk every row's update is an exact no-op
    (``corr`` 1 or 0, nothing added), so the values are those of the full
    loop.  Under ``remat`` (training with ``ArchConfig.remat``) each tile
    of a layer with more than one is rematerialised, so the layer's
    backward keeps one tile's KV loop at a time (memory linear in S, not
    quadratic); the values are the same.  One tile is the layer's whole
    attention, which the superblock's remat already bounds."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    Sk = k.shape[1]
    f32 = torch.float32
    static = q_positions is None and k_positions is None
    # keys at position -1 (padding, or a caller's) are masked
    padded = not static or Sk % min(chunk, Sk) != 0
    if q_positions is None:
        q_positions = torch.arange(Sq, device=q.device)
    if k_positions is None:
        k_positions = torch.arange(Sk, device=q.device)
    chunk = min(chunk, Sk)
    chunk_q = min(chunk_q, Sq)
    Sk0 = Sk
    if Sk % chunk:                      # padded keys get position -1:
        pad = chunk - Sk % chunk        # masked out
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = F.pad(k_positions, (0, pad), value=-1)
        Sk += pad
    qpad = (-Sq) % chunk_q
    if qpad:
        q = F.pad(q, (0, 0, 0, 0, 0, qpad))
        q_positions = F.pad(q_positions, (0, qpad), value=-1)
    nq, nk = (Sq + qpad) // chunk_q, Sk // chunk
    per_tile = max(1, min(nq, TILE_ELEMS // (B * H * chunk_q * chunk)))
    # keys and values once as (B, KV, Sk, hd) f32: every chunk is then a
    # view whose batch dims fold into one for the batched products
    kf = k.to(f32).permute(0, 2, 1, 3).contiguous()
    vf = v.to(f32).permute(0, 2, 1, 3).contiguous()

    def tile(qc, qpos, kv_chunks):
        # qc (B, KV, G * rows, hd) f32, qpos (rows,)
        rows = qpos.shape[0]
        m = None
        for i in kv_chunks:
            sl = slice(i * chunk, (i + 1) * chunk)
            kp = k_positions[sl][None, :]
            s = (qc @ kf[:, :, sl].transpose(-1, -2)).reshape(
                B, KV, G, rows, chunk)
            masks = [kp >= 0] if padded else []
            if causal:
                masks.append(kp <= qpos[:, None])
            if window:
                masks.append(kp > qpos[:, None] - window)
            if masks:
                mask = functools.reduce(torch.logical_and, masks)
                s = torch.where(mask, s, float("-inf"))
            # from the start (m = -inf, l = acc = 0) corr is 0: the first
            # chunk's m is its row max and l, acc its sums, exactly
            m_new = s.amax(dim=-1) if m is None else \
                torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
            # masked scores are -inf and m_safe finite: their p is exactly
            # 0, the reference's where(mask, p, 0)
            p = torch.exp(s - m_safe[..., None])
            pv = (p.reshape(B, KV, G * rows, chunk) @ vf[:, :, sl]).reshape(
                B, KV, G, rows, hd)
            if m is None:
                l, acc = p.sum(dim=-1), pv
            else:
                corr = torch.where(torch.isinf(m), 0.0,
                                   torch.exp(m - m_safe))
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + pv
            m = m_new
        if m is None:                                   # no key seen
            return torch.zeros((B, KV, G, rows, hd), dtype=q.dtype,
                               device=q.device)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.to(q.dtype)                          # (B,KV,G,rows,hd)

    qg = q.reshape(B, nq, chunk_q, KV, G, hd).permute(0, 3, 4, 1, 2, 5)
    remat = remat and nq > per_tile
    outs = []
    for j in range(0, nq, per_tile):
        n = min(per_tile, nq - j)
        r0, r1 = j * chunk_q, (j + n) * chunk_q
        chunks = range(nk)
        if static:
            q_hi = min(r1, Sq) - 1
            chunks = [i for i in chunks if _tile_seen(
                r0, q_hi, i * chunk, min((i + 1) * chunk, Sk0) - 1,
                causal, window)]
        qc = qg[:, :, :, j:j + n].to(f32).reshape(B, KV, G * n * chunk_q, hd)
        outs.append(remat_call(functools.partial(tile, kv_chunks=chunks),
                               qc, q_positions[r0:r1], remat=remat))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=3)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq + qpad, H * hd)
    return out[:, :Sq]


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


# --- decode (one token, a KV cache; optionally a ring buffer) ----------------

@dataclasses.dataclass(frozen=True)
class CacheDef:
    """One decode-cache leaf: its shape, dtype and fill value."""
    shape: tuple
    dtype: torch.dtype
    fill: float = 0


def attn_cache_defs(cfg: ArchConfig, batch, cache_len, quantized=False):
    """The KV cache of one attention layer: ``slot_pos`` (the position in
    each of the ``cache_len`` slots, -1 while empty) and ``k`` / ``v``
    (B, cache_len, KV, hd) in the model's dtype, or with ``quantized`` as
    int8 codes with per-(token, head) f32 scales ``kscale`` / ``vscale``
    (B, cache_len, KV, 1): decode reads the whole cache every step, and
    int8 halves those bytes against bf16."""
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    d = {"slot_pos": CacheDef((cache_len,), torch.int32, -1)}
    if quantized:
        d["k"] = CacheDef((batch, cache_len, KV, hd), torch.int8)
        d["v"] = CacheDef((batch, cache_len, KV, hd), torch.int8)
        d["kscale"] = CacheDef((batch, cache_len, KV, 1), torch.float32)
        d["vscale"] = CacheDef((batch, cache_len, KV, 1), torch.float32)
    else:
        d["k"] = CacheDef((batch, cache_len, KV, hd), cfg.dtype)
        d["v"] = CacheDef((batch, cache_len, KV, hd), cfg.dtype)
    return d


def _quantize_kv(x):
    """x (B, 1, KV, hd) -> (int8 codes, f32 scales (B, 1, KV, 1)):
    ``round(x / max(scale, 1e-30) * 127)``, the division before the
    multiply and ties to even, as ``jnp.round``."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(dim=-1, keepdim=True)
    q = torch.round(x32 / torch.clamp(scale, min=1e-30) * 127.0)
    return q.to(torch.int8), scale


def _ring_write(buf, val, slot, dim):
    """``val`` into ``buf`` at ``slot`` along ``dim``, in place: a Python
    int slot is a view's copy, a tensor slot (1,) an ``index_copy_`` (no
    host sync either way)."""
    if isinstance(slot, int):
        buf.select(dim, slot).copy_(val.select(dim, 0))
    else:
        buf.index_copy_(dim, slot, val)


def _by_head(cache, scale=None):
    """A (B, W, KV, hd) cache as (B, KV, W, hd) f32 in one pass (the
    int8 codes times ``scale / 127``, per (token, head)), the layout in
    which the scores and the weighted sum are batched products."""
    B, W, KV, hd = cache.shape
    out = torch.empty((B, KV, W, hd), dtype=torch.float32,
                      device=cache.device)
    if scale is None:
        out.copy_(cache.transpose(1, 2))
    else:
        torch.mul(cache.transpose(1, 2), (scale / 127.0).transpose(1, 2),
                  out=out)
    return out


def attention_decode(p, x, cfg: ArchConfig, cache, pos, *, window=0,
                     use_rope=True):
    """One decode step of an attention layer.  x (B, 1, D); ``pos`` the
    position, a Python int or a 0-dim integer tensor.  The new key and value go to slot ``pos mod W`` of the ring buffer
    ``cache`` (``attn_cache_defs``' leaves, written in place), and the
    query attends over every valid slot: ``0 <= slot_pos <= pos`` and,
    with ``window``, ``slot_pos > pos - window``.  Scores, softmax and the
    weighted sum in f32; the output in x's dtype.  Returns (x + out @ wo,
    cache)."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pos_t = decode_positions(pos, x.device)
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    q, k, v = qkv(p, h, cfg, pos_t, use_rope=use_rope)
    W = cache["k"].shape[1]
    slot = pos % W if isinstance(pos, int) else \
        torch.remainder(pos_t, W)
    if "kscale" in cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        for name, val in (("k", kq), ("v", vq), ("kscale", ks),
                          ("vscale", vs)):
            _ring_write(cache[name], val, slot, 1)
        kd = _by_head(cache["k"], cache["kscale"])
        vd = _by_head(cache["v"], cache["vscale"])
    else:
        _ring_write(cache["k"], k.to(cache["k"].dtype), slot, 1)
        _ring_write(cache["v"], v.to(cache["v"].dtype), slot, 1)
        kd, vd = _by_head(cache["k"]), _by_head(cache["v"])
    spos = cache["slot_pos"]
    _ring_write(spos, pos_t.to(torch.int32), slot, 0)
    qg = q.reshape(B, KV, H // KV, hd).to(torch.float32)
    s = qg @ kd.transpose(-1, -2)                           # (B,KV,G,W)
    valid = (spos >= 0) & (spos <= pos)
    if window:
        valid = valid & (spos > pos - window)
    s = s.masked_fill(~valid, float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = (w @ vd).reshape(B, 1, H * hd).to(x.dtype)
    return x + out @ p["wo"], cache


def decode_positions(pos, device):
    """A decode position (Python int or 0-dim tensor) as the (1,) int64
    tensor that rope reads, made on the device without a host copy."""
    if isinstance(pos, int):
        return torch.full((1,), pos, dtype=torch.int64, device=device)
    return pos.reshape(1).to(device=device, dtype=torch.int64)


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
    d = {"ln": ParamDef((D,), ("norm",), "ones"),
         "w_up": ParamDef((D, F_), ("embed", "ffn")),
         "w_down": ParamDef((F_, D), ("ffn", "embed"))}
    if gated:
        d["w_gate"] = ParamDef((D, F_), ("embed", "ffn"))
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
        "ln": ParamDef((D,), ("norm",), "ones"),
        "router": ParamDef((D, E), ("embed", None)),
        "w_gate": ParamDef((E, D, F_),
                            ("experts", "embed", "ffn")),
        "w_up": ParamDef((E, D, F_), ("experts", "embed", "ffn")),
        "w_down": ParamDef((E, F_, D),
                            ("experts", "ffn", "embed")),
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
