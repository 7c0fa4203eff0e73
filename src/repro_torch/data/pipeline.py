"""Round data over a population and the simulated device latencies (port
of ``repro.data.pipeline``'s ``cohort_data_fn``, ``LATENCY_PROFILES``,
``capability_latency`` and ``device_latency``)."""
from __future__ import annotations

import torch

from repro_torch.core.rng import uniform_between
from repro_torch.data.synthetic import FedDataConfig, sample_cohort

LATENCY_PROFILES = ("constant", "resource", "uniform", "heavy_tail")


def cohort_data_fn(population, cfg: FedDataConfig, device=None):
    """``data_fn(round_idx)`` over a :class:`ClientPopulation`: the round's
    cohort ids (pure in (population.seed, round), so the engine computes
    the same ones) and only those M clients' batches, O(cohort) whatever
    ``cfg.num_clients``.  The batch carries ``"ids"``."""
    def fn(round_idx):
        return sample_cohort(cfg, round_idx,
                             population.cohort_ids(round_idx, device),
                             device)
    return fn


def _f32(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def capability_latency(resources):
    """The deterministic FedMCCS capability base ``0.5 / cpu + 0.5 / link``
    per client (C,) f32, each resource floored at 0.05: the noise-free core
    of every non-constant :func:`device_latency` profile."""
    lo = _f32(0.05, resources)
    cpu = torch.maximum(resources[:, 0], lo)
    link = torch.maximum(resources[:, 3], lo)
    half = _f32(0.5, resources)
    return half / cpu + half / link


def device_latency(profile: str, resources, rng):
    """Per-client virtual latency (C,) f32 of one dispatch from the
    (C, 4) FedMCCS profile ``resources`` and the key ``rng``:

      * ``constant``   — 1.0 for everyone (the degenerate limit in which
                         the async engine reproduces synchronous FedAvg);
      * ``resource``   — :func:`capability_latency`, deterministic;
      * ``uniform``    — that base times U[0.5, 1.5) jitter;
      * ``heavy_tail`` — that base times Pareto(a = 1.5) jitter
                         ``u^(-1/1.5)``, u ~ U[1e-4, 1).

    The jitter's uniforms are ``rng.uniform`` moved to their range with
    ``jax.random.uniform``'s arithmetic, so a ``jax.random``-backed key
    gives the reference's latencies bit for bit, except ``heavy_tail``'s
    ``pow``, whose vectorised CPU form differs from XLA's by one ULP on
    about 2% of draws."""
    C = resources.shape[0]
    if profile == "constant":
        return torch.ones((C,), dtype=torch.float32, device=resources.device)
    base = capability_latency(resources)
    if profile == "resource":
        return base
    if profile == "uniform":
        return base * uniform_between(rng.uniform((C,), resources.device),
                                      0.5, 1.5)
    if profile == "heavy_tail":
        u = uniform_between(rng.uniform((C,), resources.device), 1e-4, 1.0)
        return base * torch.pow(u, _f32(-1.0 / 1.5, u))
    raise ValueError(
        f"unknown latency profile {profile!r}; have {LATENCY_PROFILES}")
