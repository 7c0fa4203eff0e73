"""Client selection (port of ``repro.core.selection``).

Selection is a per-round weight vector w (C,) (0 for skipped clients):
every client slot computes its local update, and selection decides whose
update, and whose wire bytes, count.

  * ``all``              — full participation (FedAvg);
  * ``random``           — uniform m-of-C sampling;
  * ``power_of_choice``  — Cho et al.: the m highest first-minibatch
                           losses among a random candidate set of
                           d = min(C, 2m);
  * ``multi_criteria``   — FedMCCS: the m best mean resource scores
                           (the simulated device profiles of the data
                           pipeline).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import FLConfig


def _top_m_mask(scores, m: int):
    """Exactly-m selection mask (C,) f32: ones at the m largest scores,
    equal scores ordered by ascending index (``lax.top_k``'s order, which
    a stable descending sort keeps; ``torch.topk`` leaves it unspecified)."""
    idx = torch.sort(scores, descending=True, stable=True).indices[:m]
    mask = torch.zeros(scores.shape, dtype=torch.float32,
                       device=scores.device)
    mask[idx] = 1.0
    return mask


def select(cfg: FLConfig, rng, *, losses, resources, sizes,
           availability=None):
    """Per-client weights (C,) f32.

    rng          : the round's selection key (``uniform`` draws)
    losses       : (C,) local first-minibatch loss (power-of-choice signal)
    resources    : (C, R) in [0, 1] simulated device profile (FedMCCS)
    sizes        : (C,) client dataset sizes (FedAvg weighting)
    availability : optional (C,) {0, 1} mask of clients sampled into the
                   cohort but offline this round: zero-weighted whatever
                   the policy
    """
    if availability is not None:
        sizes = sizes * availability
    C = sizes.shape[0]
    m = min(cfg.clients_per_round or C, C)
    if cfg.selection == "all" or m == C:
        return sizes

    if cfg.selection == "random":
        mask = _top_m_mask(rng.uniform((C,), sizes.device), m)
    elif cfg.selection == "power_of_choice":
        d = min(C, 2 * m)
        cand = _top_m_mask(rng.uniform((C,), sizes.device), d)
        mask = _top_m_mask(torch.where(cand > 0, losses,
                                       float("-inf")), m)
    elif cfg.selection == "multi_criteria":
        mask = _top_m_mask(resources.mean(dim=-1), m)
    else:
        raise ValueError(cfg.selection)
    return mask * sizes
