"""Client selection (port of ``repro.core.selection``): full participation
(``all``) only; random, power_of_choice and multi_criteria are not ported
yet."""
from __future__ import annotations

from repro_torch.core.types import FLConfig
from repro_torch.device import not_ported


def select(cfg: FLConfig, sizes):
    """Per-client weights (C,) f32: the dataset sizes (FedAvg weighting)."""
    C = sizes.shape[0]
    m = min(cfg.clients_per_round or C, C)
    if cfg.selection == "all" or m == C:
        return sizes
    raise not_ported(f"selection={cfg.selection!r}", "repro.core.selection")
