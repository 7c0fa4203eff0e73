"""Model facade for the dense ``attn+mlp`` family (port of
``repro.models.model``).

Parameters are a flat ordered ``dict[str, Tensor]`` whose keys are the
reference's pytree paths joined with dots, in ``jax.tree.leaves`` order
(dict keys sorted at every level), e.g. for paper_lm::

    embed, final_ln, layers.b0.ffn.{ln,w_down,w_gate,w_up},
    layers.b0.mixer.{ln,wk,wo,wq,wv}, lm_head

Each ``layers.*`` leaf is stacked over layers (leading dim
``num_superblocks``), as the reference's ``lax.scan`` stack is, so the FL
wire compresses whole stacked leaves and indexes them like the reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.types import ArchConfig
from repro_torch.device import not_ported, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamDef

DENSE_PATTERN = ("attn+mlp",)


def _check_supported(cfg: ArchConfig):
    if cfg.block_pattern != DENSE_PATTERN:
        raise not_ported(f"block pattern {cfg.block_pattern}",
                         "repro.models.model (and repro.models.ssm)")
    if cfg.num_experts or cfg.encoder_layers or cfg.num_patches \
            or cfg.family not in ("dense",):
        raise not_ported(f"the {cfg.family!r} family", "repro.models.model")
    if cfg.qkv_bias or cfg.sliding_window:
        raise not_ported("qkv_bias / sliding_window", "repro.models.layers")


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


def param_defs(cfg: ArchConfig) -> dict:
    """Ordered ``{dotted name: ParamDef}``; layer leaves are stacked."""
    _check_supported(cfg)
    D, V, n = cfg.d_model, cfg.vocab_size, cfg.num_superblocks
    block = {"b0": {"mixer": L.attn_defs(cfg), "ffn": L.mlp_defs(cfg)}}
    stacked = {}
    for key, d in _flatten(block):
        stacked[key] = ParamDef((n,) + d.shape, d.init, d.scale)
    tree = {"embed": ParamDef((V, D)), "final_ln": ParamDef((D,), "ones"),
            "layers": _unflatten(stacked)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamDef((D, V))
    return dict(_flatten(tree))


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *heads, last = key.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def init_params(defs: dict, seed: int, dtype, device) -> dict:
    """Seeded init on ``device``: N(0, scale) for matrices, ones for norms.
    The draws are PyTorch's, not ``jax.random``'s; tests convert the
    reference's params with ``repro_torch.convert.params_from_jax``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out = {}
    for name, d in defs.items():
        if d.init == "ones":
            out[name] = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            w = torch.randn(d.shape, generator=g, dtype=torch.float32,
                            device=device)
            out[name] = (w * d.scale).to(dtype)
    return out


def _layer(params: dict, i: int) -> dict:
    """Layer i's parameters as the reference's nested block dict."""
    p = {"mixer": {}, "ffn": {}}
    for name, t in params.items():
        if name.startswith("layers.b0."):
            _, _, part, leaf = name.split(".")
            p[part][leaf] = t[i]
    return p


def forward(params, batch, cfg: ArchConfig):
    """Full-sequence forward -> final hidden states (B, S, D)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"].index_select(0, tokens.reshape(-1)).reshape(
        B, S, cfg.d_model)
    positions = torch.arange(S, device=x.device)
    for i in range(cfg.num_superblocks):
        p = _layer(params, i)
        h = L.rmsnorm(x, p["mixer"]["ln"], cfg.norm_eps)
        q, k, v = L.qkv(p["mixer"], h, cfg, positions)
        x = x + L.causal_attention(q, k, v) @ p["mixer"]["wo"]
        x = L.mlp_block(p["ffn"], x, cfg)
    return L.rmsnorm(x, params["final_ln"], cfg.norm_eps)


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
    """Next-token LM loss.  batch: tokens, labels (B, S) int, mask (B, S).
    Returns (loss, aux dict) like the reference (the dense family has no
    router loss)."""
    x = forward(params, batch, cfg)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    tot, cnt = chunked_xent(x, w, batch["labels"],
                            batch["mask"].to(torch.float32), chunk=chunk)
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss, {"xent": loss}


class Model:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.defs = param_defs(cfg)

    def init(self, seed: int = 0, device=None) -> dict:
        return init_params(self.defs, seed, self.cfg.dtype,
                           resolve_device(device))

    def loss(self, params, batch, chunk=512):
        return loss_fn(params, batch, self.cfg, chunk=chunk)

    def param_sizes(self) -> list:
        """Flat per-leaf parameter counts, in leaf order."""
        return [math.prod(d.shape) for d in self.defs.values()]

    def param_count(self) -> int:
        return sum(self.param_sizes())
