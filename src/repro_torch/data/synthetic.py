"""Synthetic non-iid federated LM data (port of ``repro.data.synthetic``).

Each client samples token streams from its own bigram process

    T_c = softmax( G + beta_c · P_{z_c} + beta_c · gamma_c )

with a shared global bigram structure G, per-cluster perturbations P_z and
a per-client unigram skew gamma_c — the reference's construction, drawn
from ``torch.Generator``s instead of ``jax.random`` (the bits differ; the
differential tests feed the reference's batches).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FedDataConfig:
    vocab_size: int
    num_clients: int
    seq_len: int
    batch_per_client: int
    heterogeneity: float = 1.0
    client_skew: float = 1.0
    num_clusters: int = 4
    seed: int = 0


def _gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed * 1_000_003 + stream)
    return g


def client_tables(cfg: FedDataConfig, device):
    """(logits (C, V, V), sizes (C,)), V = min(vocab, 256); a function of
    ``cfg.seed`` only."""
    V, C = min(cfg.vocab_size, 256), cfg.num_clients
    f32 = dict(dtype=torch.float32, device=device)
    G = torch.randn((V, V), generator=_gen(cfg.seed, 0, device), **f32) * 1.5
    P = torch.randn((cfg.num_clusters, V, V),
                    generator=_gen(cfg.seed, 1, device), **f32) * 2.0
    z = torch.randint(0, cfg.num_clusters, (C,),
                      generator=_gen(cfg.seed, 2, device), device=device)
    gamma = torch.randn((C, V), generator=_gen(cfg.seed, 3, device),
                        **f32) * 1.5 * cfg.client_skew
    logits = G[None] + cfg.heterogeneity * (P[z] + gamma[:, None, :])
    sizes = 1.0 + torch.rand((C,), generator=_gen(cfg.seed, 4, device), **f32)
    return logits, sizes


def sample_round(cfg: FedDataConfig, seed: int, device=None):
    """One round's client-major batch: tokens/labels/mask (C, B, S) and
    sizes (C,) (the reference's FedMCCS ``resources`` are not drawn: no
    ported selection policy reads them).  ``seed`` picks the round's
    draws."""
    dev = resolve_device(device)
    logits, sizes = client_tables(cfg, dev)
    C, B, S = cfg.num_clients, cfg.batch_per_client, cfg.seq_len
    V = logits.shape[-1]
    g = _gen(cfg.seed, 1_000 + int(seed), dev)
    probs = torch.softmax(logits, dim=-1)                 # (C, V, V)
    cidx = torch.arange(C, device=dev)[:, None].expand(C, B)
    tok = torch.randint(0, V, (C, B), generator=g, device=dev)
    toks = []
    for _ in range(S):
        rows = probs[cidx, tok].reshape(C * B, V)
        tok = torch.multinomial(rows, 1, generator=g).reshape(C, B)
        toks.append(tok)
    tokens = torch.stack(toks, dim=-1)                    # (C, B, S)
    labels = torch.roll(tokens, -1, dims=-1)
    mask = torch.ones((C, B, S), dtype=torch.float32, device=dev)
    mask[:, :, -1] = 0.0
    return {"tokens": tokens, "labels": labels, "mask": mask, "sizes": sizes}
