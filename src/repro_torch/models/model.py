"""Model facade (port of ``repro.models.model``): one stack of superblocks
(optionally + an encoder) that expresses every architecture of
``repro_torch.configs`` through ``ArchConfig.block_pattern``.

Pattern entries are ``"<mixer>[+cross][+<ffn>]"`` with mixer in
{``attn``, ``mamba``} and ffn in {``mlp``, ``moe``}, e.g.:

  dense llama/qwen  : ("attn+mlp",)
  MoE               : ("attn+moe",)
  Mamba-2           : ("mamba",)
  Jamba             : ("mamba+mlp","mamba+moe","mamba+mlp","attn+moe",
                       "mamba+mlp","mamba+moe","mamba+mlp","mamba+moe")
  Whisper decoder   : ("attn+cross+mlp",)

Parameters are a flat ordered ``dict[str, Tensor]`` whose keys are the
reference's pytree paths joined with dots, in ``jax.tree.leaves`` order
(dict keys sorted at every level), e.g. for paper_lm::

    embed, final_ln, layers.b0.ffn.{ln,w_down,w_gate,w_up},
    layers.b0.mixer.{ln,wk,wo,wq,wv}, lm_head

Entry i of the pattern is ``layers.b<i>``; an encoder's leaves are
``encoder.layers.*`` and ``encoder.final_ln``, the VLM projector
``patch_proj``.  Each ``layers.*`` leaf is stacked over superblocks
(leading dim ``num_superblocks``, ``encoder.layers.*`` over
``encoder_layers``), as the reference's ``lax.scan`` stack is, so the FL
wire compresses whole stacked leaves and indexes them like the reference.

Self-attention and the encoder run the reference's online-softmax
``chunked_attention`` with the ``chunk`` that ``forward`` and ``loss_fn``
take, and under ``ArchConfig.remat`` each superblock, each encoder layer,
each cross-entropy chunk and each attention tile is rematerialised
in the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``): the same values, a fraction of the activation memory.

Serving: ``init_cache`` builds the decode cache in the same idiom, a flat
ordered dict whose keys are the reference cache's paths joined with dots
(``b0.kv.k``, ``b0.kv.slot_pos``, ``b0.enc.ek``, ...), each leaf stacked
over superblocks; ``decode_step`` advances it one token, in place, and
``prefill`` is the full-context forward's last-position logits.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.core.types import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as M
from repro_torch.models.layers import ParamDef


def _flatten(tree, prefix=""):
    """Nested dict -> [(dotted key, leaf)] in jax.tree.leaves order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(_flatten(v, key + "."))
        else:
            out.append((key, v))
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *heads, last = key.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _block_defs(cfg: ArchConfig, entry: str) -> dict:
    parts = entry.split("+")
    d: dict = {}
    if parts[0] == "attn":
        d["mixer"] = L.attn_defs(cfg)
    elif parts[0] == "mamba":
        d["mixer"] = M.mamba_defs(cfg)
    else:
        raise ValueError(entry)
    if "cross" in parts:
        d["cross"] = L.cross_attn_defs(cfg)
    if "moe" in parts:
        d["ffn"] = L.moe_defs(cfg)
    elif "mlp" in parts:
        d["ffn"] = L.mlp_defs(cfg, gated=cfg.family != "encdec")
    return d


def _stack_defs(tree: dict, n: int) -> dict:
    return {k: _stack_defs(v, n) if isinstance(v, dict)
            else ParamDef((n,) + v.shape, ("stack",) + v.logical, v.init,
                         v.scale)
            for k, v in tree.items()}


def param_defs(cfg: ArchConfig) -> dict:
    """Ordered ``{dotted name: ParamDef}``; layer leaves are stacked."""
    D, V = cfg.d_model, cfg.vocab_size
    sb = {f"b{i}": _block_defs(cfg, e)
          for i, e in enumerate(cfg.block_pattern)}
    tree = {"embed": ParamDef((V, D), ("vocab", "embed")),
            "final_ln": ParamDef((D,), ("norm",), "ones"),
            "layers": _stack_defs(sb, cfg.num_superblocks)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamDef((D, V), ("embed", "vocab"))
    if cfg.encoder_layers:
        enc_block = {"mixer": L.attn_defs(cfg),
                     "ffn": L.mlp_defs(cfg, gated=False)}
        tree["encoder"] = {
            "layers": _stack_defs(enc_block, cfg.encoder_layers),
            "final_ln": ParamDef((D,), ("norm",), "ones")}
    if cfg.num_patches:
        # the projector of the (stubbed) vision embeddings
        tree["patch_proj"] = ParamDef((D, D), ("embed", "embed"))
    return dict(_flatten(tree))


def init_params(defs: dict, seed: int, dtype, device) -> dict:
    """Seeded init on ``device`` by ``ParamDef.init``: N(0, scale) for
    ``normal``, N(0, scale / 10) for ``small``, ones and zeros, and
    log(Uniform[1, 16]) for ``alog`` (Mamba's A_log).  The draws are
    PyTorch's, not ``jax.random``'s; tests convert the reference's params
    with ``repro_torch.convert.params_from_jax``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f32 = dict(generator=g, dtype=torch.float32, device=device)
    out = {}
    for name, d in defs.items():
        if d.init == "ones":
            out[name] = torch.ones(d.shape, dtype=dtype, device=device)
        elif d.init == "zeros":
            out[name] = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "alog":
            u = torch.rand(d.shape, **f32) * 15.0 + 1.0
            out[name] = torch.log(u).to(dtype)
        else:
            scale = d.scale if d.init == "normal" else d.scale * 0.1
            out[name] = (torch.randn(d.shape, **f32) * scale).to(dtype)
    return out


def _subtree(params: dict, prefix: str) -> dict:
    """The nested dict of the leaves under ``prefix``, prefix stripped."""
    n = len(prefix)
    return _unflatten({k[n:]: v for k, v in params.items()
                       if k.startswith(prefix)})


def _index(tree: dict, i: int) -> dict:
    """Superblock i of a stacked subtree."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _sinusoid(S, D, device):
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=device), 2 * dim / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _self_attention(p, x, cfg: ArchConfig, positions, *, causal, window,
                    use_rope, chunk=512, remat=False):
    """Self-attention over one sequence: ``positions`` is its
    ``arange``, chunked attention's default (which lets it skip the KV
    chunks that no query of a tile sees)."""
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    q, k, v = L.qkv(p, h, cfg, positions, use_rope=use_rope)
    o = L.chunked_attention(q, k, v, causal=causal, window=window,
                            chunk=chunk, remat=remat)
    return x + o @ p["wo"]


def _superblock(psb, x, cfg: ArchConfig, positions, enc_out, *, window,
                chunk):
    """One repetition of the block pattern; returns (x, the superblock's
    summed router aux loss: a Python 0.0 where no entry has a router, so
    that the dense families launch nothing for it)."""
    use_rope = cfg.family != "encdec"
    aux = 0.0
    for i, entry in enumerate(cfg.block_pattern):
        parts = entry.split("+")
        p = psb[f"b{i}"]
        if parts[0] == "attn":
            x = _self_attention(p["mixer"], x, cfg, positions, causal=True,
                                window=window, use_rope=use_rope,
                                chunk=chunk, remat=cfg.remat)
        else:
            x = M.mamba_block(p["mixer"], x, cfg)
        if "cross" in parts:
            ekv = L.encode_cross_kv(p["cross"], enc_out, cfg)
            x = L.cross_attention(p["cross"], x, ekv, cfg)
        if "ffn" in p:
            if "router" in p["ffn"]:
                x, a = L.moe_block(p["ffn"], x, cfg)
                aux = aux + a
            else:
                x = L.mlp_block(p["ffn"], x, cfg)
    return x, aux


def _encode(params, frontend, cfg: ArchConfig):
    """Whisper-style bidirectional encoder over stubbed frame embeddings
    (B, T, D), attention chunked at 512 as in the reference."""
    T, D = frontend.shape[1], cfg.d_model
    x = frontend + _sinusoid(T, D, frontend.device).to(frontend.dtype)
    pos = torch.arange(T, device=x.device)
    layers = _subtree(params, "encoder.layers.")

    def layer(p, x):
        x = _self_attention(p["mixer"], x, cfg, pos, causal=False, window=0,
                            use_rope=False, chunk=512, remat=cfg.remat)
        return L.mlp_block(p["ffn"], x, cfg)

    for i in range(cfg.encoder_layers):
        x = L.remat_call(functools.partial(layer, _index(layers, i)), x,
                         remat=cfg.remat)
    return L.rmsnorm(x, params["encoder.final_ln"], cfg.norm_eps)


def _inputs_to_x(params, batch, cfg: ArchConfig):
    """Embed tokens, handling modality prefixes.  Returns (x, positions,
    enc_out, text_offset)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"].index_select(0, tokens.reshape(-1)).reshape(
        B, S, cfg.d_model)
    enc_out = None
    offset = 0
    if cfg.family == "vlm":
        patches = batch["patches"].to(x.dtype) @ params["patch_proj"]
        x = torch.cat([patches, x], dim=1)
        offset = patches.shape[1]
    if cfg.family == "encdec":
        enc_out = _encode(params, batch["frontend"].to(x.dtype), cfg)
        x = x + _sinusoid(S, cfg.d_model, x.device).to(x.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions, enc_out, offset


def forward(params, batch, cfg: ArchConfig, *, window=None, chunk=512):
    """Full-sequence forward -> (final hidden states (B, S_text, D), the
    router aux loss summed over superblocks; 0.0 without a router).
    ``window`` None is the config's ``sliding_window``; attention runs in
    chunks of ``chunk`` keys (and 512 queries)."""
    x, positions, enc_out, offset = _inputs_to_x(params, batch, cfg)
    w = cfg.sliding_window if window is None else window
    layers = _subtree(params, "layers.")
    aux = 0.0
    for i in range(cfg.num_superblocks):
        block = functools.partial(_superblock, _index(layers, i),
                                  cfg=cfg, positions=positions,
                                  enc_out=enc_out, window=w, chunk=chunk)
        x, a = L.remat_call(block, x, remat=cfg.remat)
        aux = aux + a
    x = L.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    if offset:
        x = x[:, offset:]
    return x, aux


def unembed(params, x, cfg: ArchConfig):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ w


def chunked_xent(x, w, labels, mask, chunk=512, remat=False):
    """Cross-entropy over sequence chunks without materialising (B, S, V)
    at once (under ``remat`` nor keeping a chunk's logits for the
    backward).  Returns (sum_loss, sum_mask)."""
    S = x.shape[1]
    c = min(chunk, S)

    def body(xc, lc, mc):
        logits = (xc @ w).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc[..., None].long())[..., 0]
        return ((lse - gold) * mc).sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, c):
        xc, lc, mc = x[:, s0:s0 + c], labels[:, s0:s0 + c], mask[:, s0:s0 + c]
        tot = tot + L.remat_call(body, xc, lc, mc, remat=remat)
        cnt = cnt + mc.sum()
    return tot, cnt


def loss_fn(params, batch, cfg: ArchConfig, *, chunk=512):
    """Next-token LM loss.  batch: tokens, labels (B, S) int, mask (B, S)
    [+ patches (vlm) / frontend (encdec)].  Returns ``(xent +
    router_aux_weight * aux, {"xent", "aux"})`` like the reference; without
    a router the total is ``xent`` and ``aux`` the Python 0.0."""
    x, aux = forward(params, batch, cfg, chunk=chunk)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    tot, cnt = chunked_xent(x, w, batch["labels"],
                            batch["mask"].to(torch.float32), chunk=chunk,
                            remat=cfg.remat)
    loss = tot / torch.clamp(cnt, min=1.0)
    total = loss + cfg.router_aux_weight * aux if torch.is_tensor(aux) \
        else loss
    return total, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def cache_defs(cfg: ArchConfig, batch: int, cache_len: int,
               enc_len: int = 0, quantized: bool = False) -> dict:
    """Ordered ``{dotted name: CacheDef}`` of the decode cache, each leaf
    with its leading superblock dim: per pattern entry ``kv`` (an
    attention layer's KV ring buffer, int8 with ``quantized``, or a Mamba
    layer's state and conv window) and, for cross-attention, ``enc``
    (the encoder's keys and values, (B, enc_len, KV, hd))."""
    def one_block(entry):
        parts = entry.split("+")
        d: dict = {}
        if parts[0] == "attn":
            d["kv"] = L.attn_cache_defs(cfg, batch, cache_len,
                                        quantized=quantized)
        else:
            d["kv"] = M.mamba_cache_defs(cfg, batch)
        if "cross" in parts:
            KV, hd = cfg.num_kv_heads, cfg.head_dim
            d["enc"] = {"ek": L.CacheDef((batch, enc_len, KV, hd),
                                         cfg.dtype),
                        "ev": L.CacheDef((batch, enc_len, KV, hd),
                                         cfg.dtype)}
        return d

    n = cfg.num_superblocks
    tree = {f"b{i}": one_block(e) for i, e in enumerate(cfg.block_pattern)}
    return {k: L.CacheDef((n,) + d.shape, d.dtype, d.fill)
            for k, d in _flatten(tree)}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               enc_len: int = 0, quantized: bool = False,
               device="cpu") -> dict:
    """The zero decode cache of :func:`cache_defs` on ``device`` (``meta``
    gives shapes and dtypes without memory): ``slot_pos`` -1, everything
    else 0.  The ``enc`` leaves stay zero until a caller fills them
    (:func:`encode_cache`)."""
    return {k: torch.full(d.shape, d.fill, dtype=d.dtype, device=device)
            for k, d in cache_defs(cfg, batch, cache_len, enc_len,
                                   quantized).items()}


def encode_cache(params, cache, frontend, cfg: ArchConfig) -> dict:
    """Fills the cross-attention entries of ``cache`` in place with each
    superblock's encoder keys and values of ``frontend`` (B, T, D)."""
    with torch.no_grad():
        enc_out = _encode(params, frontend.to(cfg.dtype), cfg)
        layers = _subtree(params, "layers.")
        for i in range(cfg.num_superblocks):
            psb = _index(layers, i)
            for j, entry in enumerate(cfg.block_pattern):
                if "cross" in entry.split("+"):
                    ek, ev = L.encode_cross_kv(psb[f"b{j}"]["cross"],
                                               enc_out, cfg)
                    cache[f"b{j}.enc.ek"][i].copy_(ek)
                    cache[f"b{j}.enc.ev"][i].copy_(ev)
    return cache


@torch.no_grad()
def decode_step(params, cache, token, pos, cfg: ArchConfig, *, window=0):
    """One decode step: token (B, 1) int, ``pos`` a Python int or a 0-dim
    int tensor (nothing is read back to the host).  Returns (logits
    (B, 1, V), cache), the cache advanced in place.  A MoE layer routes
    its one token with the capacity of S = 1; a VLM decodes without its
    prefix, and an encoder-decoder reads the ``enc`` entries."""
    B = token.shape[0]
    x = params["embed"].index_select(0, token.reshape(-1)).reshape(
        B, 1, cfg.d_model)
    if cfg.family == "encdec":
        x = x + _sinusoid_at(L.decode_positions(pos, x.device),
                             cfg.d_model).to(x.dtype)
    layers = _subtree(params, "layers.")
    caches = _unflatten(cache)
    for i in range(cfg.num_superblocks):
        psb, csb = _index(layers, i), _index(caches, i)
        for j, entry in enumerate(cfg.block_pattern):
            parts = entry.split("+")
            p, c = psb[f"b{j}"], csb[f"b{j}"]
            if parts[0] == "attn":
                x, _ = L.attention_decode(
                    p["mixer"], x, cfg, c["kv"], pos, window=window,
                    use_rope=cfg.family != "encdec")
            else:
                x, _ = M.mamba_decode(p["mixer"], x, cfg, c["kv"])
            if "cross" in parts:
                x = L.cross_attention(p["cross"], x, (c["enc"]["ek"],
                                                      c["enc"]["ev"]), cfg)
            if "ffn" in p:
                if "router" in p["ffn"]:
                    x, _ = L.moe_block(p["ffn"], x, cfg)
                else:
                    x = L.mlp_block(p["ffn"], x, cfg)
    x = L.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return unembed(params, x, cfg), cache


def _sinusoid_at(pos_t, D):
    """The sinusoid of ``_sinusoid`` at one position (a (1,) tensor):
    (1, 1, D)."""
    dim = torch.arange(D // 2, dtype=torch.float32, device=pos_t.device)
    ten_k = torch.full((), 10_000.0, device=pos_t.device)
    ang = pos_t.to(torch.float32) / torch.pow(ten_k, 2 * dim / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :]


@torch.no_grad()
def prefill(params, batch, cfg: ArchConfig, *, window=0, chunk=512):
    """The full-context forward's last-position logits (B, 1, V); window
    0 (the default) attends to every earlier position, as in the
    reference."""
    x, _ = forward(params, batch, cfg, window=window, chunk=chunk)
    return unembed(params, x[:, -1:], cfg)


class Model:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.defs = param_defs(cfg)

    def init(self, seed: int = 0, device=None) -> dict:
        return init_params(self.defs, seed, self.cfg.dtype,
                           resolve_device(device))

    def loss(self, params, batch, chunk=512):
        return loss_fn(params, batch, self.cfg, chunk=chunk)

    def prefill(self, params, batch, window=0, chunk=512):
        return prefill(params, batch, self.cfg, window=window, chunk=chunk)

    def decode(self, params, cache, token, pos, window=0):
        return decode_step(params, cache, token, pos, self.cfg,
                           window=window)

    def init_cache(self, batch, cache_len, enc_len=0, quantized=False,
                   device=None) -> dict:
        return init_cache(self.cfg, batch, cache_len, enc_len,
                          quantized=quantized,
                          device=resolve_device(device))

    def logical_axes(self) -> dict:
        """``{leaf name: its logical axis names}`` in leaf order (the
        reference's ``logical_axes`` tree, flattened)."""
        return {n: d.logical for n, d in self.defs.items()}

    def param_sizes(self) -> list:
        """Flat per-leaf parameter counts, in leaf order."""
        return [math.prod(d.shape) for d in self.defs.values()]

    def param_count(self) -> int:
        return sum(self.param_sizes())
