"""Client selection (port of ``repro.core.selection``): full participation
(``all``) only; random, power_of_choice and multi_criteria are not ported
yet."""
from __future__ import annotations

from repro_torch.core.types import FLConfig
from repro_torch.device import not_ported


def select(cfg: FLConfig, sizes, availability=None):
    """Per-client weights (C,) f32: the dataset sizes (FedAvg weighting).
    ``availability``, an optional (C,) {0, 1} mask of clients sampled into
    the cohort but offline this round, zero-weights them first."""
    if availability is not None:
        sizes = sizes * availability
    C = sizes.shape[0]
    m = min(cfg.clients_per_round or C, C)
    if cfg.selection == "all" or m == C:
        return sizes
    raise not_ported(f"selection={cfg.selection!r}", "repro.core.selection")
