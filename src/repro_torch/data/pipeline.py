"""Round data over a population (port of ``repro.data.pipeline``'s
``cohort_data_fn``)."""
from __future__ import annotations

from repro_torch.data.synthetic import FedDataConfig, sample_cohort


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
