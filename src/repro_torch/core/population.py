"""ClientPopulation: the client axis at survey scale (port of
``repro.core.population``).

A dense engine keeps every client's state and batch, which caps C in the
low thousands; the survey's production regime is 10^5-10^6 devices with a
sub-percent cohort each round.  A population is ``n_clients`` ids of which
each round samples ``cohort``; per-client pipeline state lives in a
bounded :class:`~repro_torch.compress.residual_store.ResidualStore`, so
memory is flat in ``n_clients``.

``cohort == n_clients`` makes ``cohort_ids`` the identity and (with
``capacity >= n_clients``) the store a value identity: the population path
is then bit-exact with the dense engine.

Cohorts are pure in ``(seed, round)``: the engine and the data pipeline
each call :meth:`ClientPopulation.cohort_ids` and agree.  Two samplers:

  * ``"shuffle"``: the first M entries of a permutation of the C ids,
    exact uniform sampling without replacement in O(C) per round (the
    default up to 65,536 clients);
  * ``"stride"``: the lattice ``(offset + s * arange(M)) mod C`` with
    ``gcd(s, C) == 1``, collision-free by construction and O(M), the
    stride drawn each round from coprimes near ``C / golden ratio``.

Root keys come from the module-level ``PRNGKey``: a test replaces it with
a ``jax.random``-backed key to draw the reference's cohorts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.compress.residual_store import (EVICTION_POLICIES,
                                                 ResidualStore)
from repro_torch.core import scenario as _scn
from repro_torch.core.rng import PRNGKey

SAMPLERS = ("auto", "shuffle", "stride")
_SHUFFLE_LIMIT = 65536


def _coprime_strides(C: int, M: int, count: int = 64) -> np.ndarray:
    """Strides coprime to C near C / phi (phi the golden ratio), capped so
    that ``stride * (M - 1)`` fits in int32 (the reference's uint32 lattice
    then cannot wrap before the final ``mod C``)."""
    cap = max(1, (2 ** 31 - 1) // max(M, 1))
    target = min(max(1, int(C * 0.6180339887)), cap, C - 1) if C > 1 else 1
    out = []
    for d in range(C):
        for s in (target - d, target + d):
            if 1 <= s <= min(cap, C - 1) and math.gcd(s, C) == 1:
                out.append(s)
        if len(out) >= count:
            break
    return np.unique(np.asarray(out or [1], np.int64)).astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class ClientPopulation:
    """Streaming client axis: ``n_clients`` ids, ``cohort`` per round.

    ``capacity`` bounds the residual store (0 means ``min(n_clients, 2 *
    cohort)``).  ``availability < 1.0`` drops each sampled client i.i.d.
    per round through a per-id draw (the selection hop zero-weights it);
    at 1.0 no draw is made.  ``scenario`` would give the draw a
    time-varying trace; the port has the static one only."""
    n_clients: int
    cohort: int = 0
    capacity: int = 0
    eviction: str = "drop"
    sampler: str = "auto"
    availability: float = 1.0
    seed: int = 0
    tail_rows: int = 5
    tail_cols: int = 16384
    scenario: Optional[object] = None

    def __post_init__(self):
        if self.n_clients < 1:
            raise ValueError(f"n_clients must be >= 1; got {self.n_clients}")
        if self.cohort == 0:
            object.__setattr__(self, "cohort", self.n_clients)
        if not (1 <= self.cohort <= self.n_clients):
            raise ValueError(
                f"cohort must be in [1, n_clients={self.n_clients}]; "
                f"got {self.cohort}")
        if self.capacity == 0:
            object.__setattr__(
                self, "capacity", min(self.n_clients, 2 * self.cohort))
        if self.capacity < self.cohort:
            raise ValueError(
                f"store capacity ({self.capacity}) must be >= cohort "
                f"({self.cohort}): a round's scatter would collide")
        if self.eviction not in EVICTION_POLICIES:
            raise ValueError(f"eviction must be one of {EVICTION_POLICIES}; "
                             f"got {self.eviction!r}")
        if self.sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}; "
                             f"got {self.sampler!r}")
        if not (0.0 < self.availability <= 1.0):
            raise ValueError(
                f"availability must be in (0, 1]; got {self.availability}")
        if self.sampler == "auto":
            object.__setattr__(
                self, "sampler",
                "shuffle" if self.n_clients <= _SHUFFLE_LIMIT else "stride")
        if self.sampler == "shuffle" and self.n_clients > _SHUFFLE_LIMIT:
            raise ValueError(
                f"sampler='shuffle' permutes all {self.n_clients} ids per "
                f"round; use 'stride' above {_SHUFFLE_LIMIT}")
        if self.sampler == "stride" and self.cohort < self.n_clients:
            object.__setattr__(self, "_strides",
                               _coprime_strides(self.n_clients, self.cohort))

    # ------------------------------------------------------------- sampling
    def _key(self, round_idx):
        return PRNGKey(self.seed + 7).fold_in(int(round_idx))

    def cohort_ids(self, round_idx, device=None):
        """(cohort,) int32 unique client ids for this round on ``device``,
        pure in (seed, round); ``cohort == n_clients`` gives ``arange``.
        The draws are made on the CPU, so the ids do not depend on the
        device."""
        C, M = self.n_clients, self.cohort
        if M == C:
            return torch.arange(C, dtype=torch.int32, device=device)
        if self.sampler == "shuffle":
            return self._key(round_idx).permutation(C, "cpu")[:M] \
                .to(device=device, dtype=torch.int32)
        strides = self._strides
        k_s, k_o = self._key(round_idx).split(2)
        s = int(strides[int(k_s.randint(0, strides.shape[0], (), "cpu"))])
        off = int(k_o.randint(0, C, (), "cpu"))
        # int64 holds off + s * (M - 1) < 2^32 exactly
        lattice = off + s * torch.arange(M, dtype=torch.int64, device=device)
        return (lattice % C).to(torch.int32)

    @property
    def availability_active(self) -> bool:
        """Whether the selection hop draws a mask: below full availability
        or under a time-varying trace."""
        return (self.availability < 1.0
                or (self.scenario is not None
                    and self.scenario.trace != "static"))

    def availability_mask(self, round_idx, ids):
        """(M,) f32 in {0, 1}: this round's per-id availability draws
        (``core.scenario``'s shared implementation)."""
        return _scn.availability_mask(self.scenario, self.seed,
                                      self.availability, round_idx, ids)

    def availability_count(self, round_idx, ids):
        """() f32: how many of this round's cohort are available."""
        if not self.availability_active:
            return torch.tensor(float(ids.shape[0]), dtype=torch.float32,
                                device=ids.device)
        return self.availability_mask(round_idx, ids).sum()

    # ---------------------------------------------------------------- store
    def make_store(self, pipe, params, device=None):
        """The ResidualStore for this population, or None for a stateless
        pipeline (no per-client rows to keep)."""
        if not getattr(pipe, "stateful", False):
            return None
        return ResidualStore(pipe, params, self.capacity,
                             eviction=self.eviction,
                             tail_rows=self.tail_rows,
                             tail_cols=self.tail_cols, device=device)
