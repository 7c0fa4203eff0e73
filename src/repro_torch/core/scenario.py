"""Client availability (the part of ``repro.core.scenario`` that the
population needs).

``bernoulli_mask`` is the i.i.d. availability draw: one uniform per client
id from ``PRNGKey(seed + 13).fold_in(round).fold_in(id)``, available iff
``u < rate``, so (seed, round, id) fully determine the mask.
``availability_mask`` is the shared entry point; the port has its static
trace only (the diurnal and square traces, mid-round dropout, epoch
scaling and adaptive deadlines are not ported).

Root keys come from the module-level ``PRNGKey``: a test replaces it with
a ``jax.random``-backed key to draw the reference's masks.
"""
from __future__ import annotations

import torch

from repro_torch.core.rng import PRNGKey
from repro_torch.device import not_ported

_AVAIL_SALT = 13


def bernoulli_mask(seed: int, rate: float, round_idx, ids):
    """(M,) f32 in {0, 1}: one uniform per id of ``ids`` (M,), ``u <
    rate`` (the rate rounded to f32, as the reference's weak-typed
    compare)."""
    key = PRNGKey(seed + _AVAIL_SALT).fold_in(int(round_idx))
    dev = ids.device
    u = torch.stack([key.fold_in(i).uniform((), dev) for i in ids.tolist()])
    return (u < torch.tensor(rate, dtype=torch.float32, device=dev)) \
        .to(torch.float32)


def availability_mask(scenario, seed: int, rate: float, round_idx, ids):
    """Availability under the scenario's trace: :func:`bernoulli_mask` for
    no scenario or the ``static`` trace."""
    if scenario is None or scenario.trace == "static":
        return bernoulli_mask(seed, rate, round_idx, ids)
    raise not_ported(f"availability trace {scenario.trace!r}",
                     "repro.core.scenario")
