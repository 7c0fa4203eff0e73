"""Synthetic non-iid federated LM data (port of ``repro.data.synthetic``).

Each client samples token streams from its own bigram process

    T_c = softmax( G + beta_c · P_{z_c} + beta_c · gamma_c )

with a shared global bigram structure G, per-cluster perturbations P_z and
a per-client unigram skew gamma_c — the reference's construction, drawn
from ``torch.Generator``s instead of ``jax.random`` (the bits differ; the
differential tests feed the reference's batches).

Each client also has a FedMCCS device profile, ``resources`` (C, 4) f32
in [0.05, 1) ([cpu, memory, energy, link]): the signal of the
``multi_criteria`` selection policy and of the async engine's latency
draws (``data.pipeline.device_latency``).  It comes from a generator
stream of its own, so the tokens and sizes do not depend on it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.rng import Key, uniform_between
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
    z = client_clusters(cfg, device)
    gamma = torch.randn((C, V), generator=_gen(cfg.seed, 3, device),
                        **f32) * 1.5 * cfg.client_skew
    logits = G[None] + cfg.heterogeneity * (P[z] + gamma[:, None, :])
    sizes = 1.0 + torch.rand((C,), generator=_gen(cfg.seed, 4, device), **f32)
    return logits, sizes


def client_resources(cfg: FedDataConfig, device):
    """The clients' FedMCCS device profiles (C, 4) f32 in [0.05, 1), a
    function of ``cfg.seed`` only (the reference's ``minval=0.05``
    uniforms, from a stream of their own)."""
    u = torch.rand((cfg.num_clients, 4), generator=_gen(cfg.seed, 5, device),
                   dtype=torch.float32, device=device)
    return uniform_between(u, 0.05, 1.0)


def client_clusters(cfg: FedDataConfig, device=None):
    """Each client's ground-truth generator cluster (C,) int64, the ``z``
    of :func:`client_tables` (for FL+HC recovery experiments)."""
    dev = resolve_device(device)
    return torch.randint(0, cfg.num_clusters, (cfg.num_clients,),
                         generator=_gen(cfg.seed, 2, dev), device=dev)


def sample_round(cfg: FedDataConfig, seed: int, device=None):
    """One round's client-major batch: tokens/labels/mask (C, B, S), sizes
    (C,) and resources (C, 4).  ``seed`` picks the round's draws; sizes
    and resources are the same every round."""
    dev = resolve_device(device)
    return _sample(cfg, _gen(cfg.seed, 1_000 + int(seed), dev), dev)


def eval_batch(cfg: FedDataConfig, seed: int, batch_size: int = 32,
               device=None):
    """A held-out batch from the same generator tables (same
    ``cfg.seed``), flattened across clients: tokens/labels/mask of shape
    (C * batch_size, S), evaluating the global model on the full client
    mixture.  Its draws come from a stream of their own (``seed`` picks
    them), which no round's batch shares."""
    dev = resolve_device(device)
    g = Key(cfg.seed).fold_in(-1).fold_in(int(seed)).generator(dev)
    b = _sample(dataclasses.replace(cfg, batch_per_client=batch_size), g,
                dev)
    return {k: b[k].reshape((-1,) + tuple(b[k].shape[2:]))
            for k in ("tokens", "labels", "mask")}


def _sample(cfg: FedDataConfig, g: torch.Generator, dev):
    logits, sizes = client_tables(cfg, dev)
    C, B, S = cfg.num_clients, cfg.batch_per_client, cfg.seq_len
    V = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)                 # (C, V, V)
    cidx = torch.arange(C, device=dev)[:, None].expand(C, B)
    tok = torch.randint(0, V, (C, B), generator=g, device=dev)
    toks = []
    for _ in range(S):
        rows = probs[cidx, tok].reshape(C * B, V)
        tok = torch.multinomial(rows, 1, generator=g).reshape(C, B)
        toks.append(tok)
    tokens = torch.stack(toks, dim=-1)                    # (C, B, S)
    return dict(_labels_and_mask(tokens), sizes=sizes,
                resources=client_resources(cfg, dev))


def _labels_and_mask(tokens):
    labels = torch.roll(tokens, -1, dims=-1)
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, :, -1] = 0.0
    return {"tokens": tokens, "labels": labels, "mask": mask}


def sample_cohort(cfg: FedDataConfig, seed: int, ids, device=None):
    """A cohort's batch in O(M), never materialising the population: the
    shared G and P of :func:`client_tables`, then each client's cluster,
    unigram skew and size from a generator keyed on its id alone, and the
    uniforms of its token streams from one keyed on (round ``seed``, id).
    The per-client draws are made on the CPU (the same values on every
    device, and no device sync per client).  The values differ from
    :func:`client_tables`' (the scale path, not a replica of the dense
    one).  Each client's resources come from a generator keyed on its id
    in a stream of their own.  Returns the :func:`sample_round` dict with
    an (M,) lead plus ``"ids"`` (int32)."""
    dev = resolve_device(device)
    V = min(cfg.vocab_size, 256)
    f32 = dict(dtype=torch.float32, device=dev)
    G = torch.randn((V, V), generator=_gen(cfg.seed, 0, dev), **f32) * 1.5
    P = torch.randn((cfg.num_clusters, V, V),
                    generator=_gen(cfg.seed, 1, dev), **f32) * 2.0
    ids = ids.to(device=dev, dtype=torch.int32)
    M, B, S = ids.shape[0], cfg.batch_per_client, cfg.seq_len
    z, gamma, sizes, res, u = [], [], [], [], []
    for i in ids.tolist():
        g = Key(cfg.seed + 2).fold_in(i).generator("cpu")
        z.append(int(torch.randint(0, cfg.num_clusters, (), generator=g)))
        gamma.append(torch.randn((V,), generator=g))
        sizes.append(1.0 + torch.rand((), generator=g))
        res.append(Key(cfg.seed + 3).fold_in(i).uniform((4,), "cpu"))
        u.append(Key(cfg.seed + 1).fold_in(int(seed)).fold_in(i)
                 .uniform((B, S + 1), "cpu"))
    gamma = torch.stack(gamma).to(dev) * 1.5 * cfg.client_skew      # (M, V)
    logits = G[None] + cfg.heterogeneity * (P[torch.tensor(z, device=dev)]
                                            + gamma[:, None, :])
    # each stream by inverse-CDF sampling from the client's own uniforms
    # (the first token uniform over V), so all M clients step together
    cdf = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
    u = torch.stack(u).to(dev)                            # (M, B, S + 1)
    midx = torch.arange(M, device=dev)[:, None].expand(M, B)
    tok = (u[..., 0] * V).to(torch.int64).clamp(max=V - 1)
    tokens = torch.empty((M, B, S), dtype=torch.int64, device=dev)
    for t in range(S):
        tok = torch.searchsorted(cdf[midx, tok].contiguous(),
                                 u[..., t + 1:t + 2].contiguous()) \
            .squeeze(-1).clamp(max=V - 1)
        tokens[:, :, t] = tok
    return dict(_labels_and_mask(tokens), sizes=torch.stack(sizes).to(dev),
                resources=uniform_between(torch.stack(res), 0.05, 1.0).to(dev),
                ids=ids)
