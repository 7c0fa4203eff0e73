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
The decode path (``init_cache``, ``decode_step``, ``prefill``) is not
ported yet.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.types import ArchConfig
from repro_torch.device import not_ported, resolve_device
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
            else ParamDef((n,) + v.shape, v.init, v.scale)
            for k, v in tree.items()}


def param_defs(cfg: ArchConfig) -> dict:
    """Ordered ``{dotted name: ParamDef}``; layer leaves are stacked."""
    D, V = cfg.d_model, cfg.vocab_size
    sb = {f"b{i}": _block_defs(cfg, e)
          for i, e in enumerate(cfg.block_pattern)}
    tree = {"embed": ParamDef((V, D)), "final_ln": ParamDef((D,), "ones"),
            "layers": _stack_defs(sb, cfg.num_superblocks)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamDef((D, V))
    if cfg.encoder_layers:
        enc_block = {"mixer": L.attn_defs(cfg),
                     "ffn": L.mlp_defs(cfg, gated=False)}
        tree["encoder"] = {
            "layers": _stack_defs(enc_block, cfg.encoder_layers),
            "final_ln": ParamDef((D,), "ones")}
    if cfg.num_patches:
        # the projector of the (stubbed) vision embeddings
        tree["patch_proj"] = ParamDef((D, D))
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
                    use_rope):
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    q, k, v = L.qkv(p, h, cfg, positions, use_rope=use_rope)
    return x + L.attention(q, k, v, causal=causal, window=window) @ p["wo"]


def _superblock(psb, x, cfg: ArchConfig, positions, enc_out, *, window):
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
                                window=window, use_rope=use_rope)
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
    (B, T, D)."""
    T, D = frontend.shape[1], cfg.d_model
    x = frontend + _sinusoid(T, D, frontend.device).to(frontend.dtype)
    pos = torch.arange(T, device=x.device)
    layers = _subtree(params, "encoder.layers.")
    for i in range(cfg.encoder_layers):
        p = _index(layers, i)
        x = _self_attention(p["mixer"], x, cfg, pos, causal=False, window=0,
                            use_rope=False)
        x = L.mlp_block(p["ffn"], x, cfg)
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


def forward(params, batch, cfg: ArchConfig):
    """Full-sequence forward -> (final hidden states (B, S_text, D), the
    router aux loss summed over superblocks; 0.0 without a router)."""
    x, positions, enc_out, offset = _inputs_to_x(params, batch, cfg)
    layers = _subtree(params, "layers.")
    aux = 0.0
    for i in range(cfg.num_superblocks):
        x, a = _superblock(_index(layers, i), x, cfg, positions, enc_out,
                           window=cfg.sliding_window)
        aux = aux + a
    x = L.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    if offset:
        x = x[:, offset:]
    return x, aux


def chunked_xent(x, w, labels, mask, chunk=512):
    """Cross-entropy over sequence chunks without materialising (B, S, V)
    at once.  Returns (sum_loss, sum_mask)."""
    S = x.shape[1]
    c = min(chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, c):
        xc, lc, mc = x[:, s0:s0 + c], labels[:, s0:s0 + c], mask[:, s0:s0 + c]
        logits = (xc @ w).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc[..., None].long())[..., 0]
        tot = tot + ((lse - gold) * mc).sum()
        cnt = cnt + mc.sum()
    return tot, cnt


def loss_fn(params, batch, cfg: ArchConfig, *, chunk=512):
    """Next-token LM loss.  batch: tokens, labels (B, S) int, mask (B, S)
    [+ patches (vlm) / frontend (encdec)].  Returns ``(xent +
    router_aux_weight * aux, {"xent", "aux"})`` like the reference; without
    a router the total is ``xent`` and ``aux`` the Python 0.0."""
    x, aux = forward(params, batch, cfg)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    tot, cnt = chunked_xent(x, w, batch["labels"],
                            batch["mask"].to(torch.float32), chunk=chunk)
    loss = tot / torch.clamp(cnt, min=1.0)
    total = loss + cfg.router_aux_weight * aux if torch.is_tensor(aux) \
        else loss
    return total, {"xent": loss, "aux": aux}


class Model:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.defs = param_defs(cfg)

    def init(self, seed: int = 0, device=None) -> dict:
        return init_params(self.defs, seed, self.cfg.dtype,
                           resolve_device(device))

    def loss(self, params, batch, chunk=512):
        return loss_fn(params, batch, self.cfg, chunk=chunk)

    def prefill(self, *args, **kwargs):
        raise not_ported("prefill", "repro.models.model")

    def decode(self, *args, **kwargs):
        raise not_ported("decode_step", "repro.models.model")

    def init_cache(self, *args, **kwargs):
        raise not_ported("init_cache", "repro.models.model")

    def param_sizes(self) -> list:
        """Flat per-leaf parameter counts, in leaf order."""
        return [math.prod(d.shape) for d in self.defs.values()]

    def param_count(self) -> int:
        return sum(self.param_sizes())
