"""Scenario: client dynamics behind the static config surface (port of
``repro.core.scenario``, DESIGN.md §13).

The engines consume it as masks over their rounds, so every scenario has a
bit-exact OFF path:

  * availability traces: :func:`availability_mask` is the i.i.d.
    Bernoulli draw (``trace="static"``), per-client phase-shifted
    ``"square"`` duty windows, or ``"diurnal"`` sinusoid-modulated
    Bernoulli schedules;
  * mid-round dropout: :func:`survival_mask` / :func:`survival_draw`, a
    survival draw ``P = exp(-hazard * latency)`` per (round, client); a
    dropped client becomes a zero-weight row;
  * heterogeneity-aware dispatch: :func:`epoch_steps`, the per-client
    local-step budget ``clip(median(lat) / lat_i, floor, 1)``;
  * adaptive deadlines: :func:`quantile_update`, a Robbins-Monro
    completion-time quantile tracker kept in the async state.

Every draw is keyed by ``fold_in`` on (seed, round, id), never by carried
state, so any two consumers recompute the same masks.  One uniform per id
comes from ``PRNGKey(seed + salt).fold_in(round).fold_in(id)``.  Root keys
come from the module-level ``PRNGKey``: a test replaces it with a
``jax.random``-backed key to draw the reference's masks.  Scalars are
rounded to f32 where the reference's weakly-typed Python floats meet f32
arrays.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.rng import PRNGKey
from repro_torch.data.pipeline import capability_latency

TRACES = ("static", "diurnal", "square")

# fold_in salts (the reference's)
_AVAIL_SALT = 13
_PHASE_SALT = 29
_DROP_SALT = 31


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Client-dynamics configuration.  Every default means "off": a
    default Scenario has ``enabled == False`` and the engines build no
    scenario hop.  Reachable from ``FLConfig.scenario_*`` via
    :meth:`from_fl` and from ``launch/train.py``'s ``--scenario-*``
    flags."""

    trace: str = "static"             # static | diurnal | square
    period: float = 24.0              # trace period, in rounds
    availability: float = 1.0         # duty-cycle rate (dense sim path;
    #                                   a ClientPopulation keeps its own rate)
    dropout: float = 0.0              # mid-round dropout hazard per unit
    #                                   virtual time (0 = off)
    epoch_scale: float = 0.0          # 0 = off; else the floor in (0, 1] of
    #                                   the per-client local-epoch scale
    deadline_quantile: float = 0.0    # 0 = off; else the completion-time
    #                                   quantile the async deadline tracks
    seed: int = 0

    def __post_init__(self):
        if self.trace not in TRACES:
            raise ValueError(
                f"scenario trace {self.trace!r} not in {TRACES}")
        if not self.period > 0:
            raise ValueError("scenario period must be > 0 rounds")
        if not 0.0 < self.availability <= 1.0:
            raise ValueError("scenario availability must be in (0, 1]")
        if self.dropout < 0.0:
            raise ValueError("scenario dropout hazard must be >= 0")
        if not 0.0 <= self.epoch_scale <= 1.0:
            raise ValueError("scenario epoch_scale must be in [0, 1]")
        if not 0.0 <= self.deadline_quantile < 1.0:
            raise ValueError("scenario deadline_quantile must be in [0, 1)")

    @staticmethod
    def from_fl(fl) -> "Scenario":
        return Scenario(trace=fl.scenario_trace,
                        period=fl.scenario_period,
                        availability=fl.scenario_availability,
                        dropout=fl.scenario_dropout,
                        epoch_scale=fl.scenario_epoch_scale,
                        deadline_quantile=fl.scenario_deadline_quantile,
                        seed=fl.scenario_seed)

    @property
    def diurnal(self) -> bool:
        """True when the availability trace is time-varying."""
        return self.trace != "static"

    @property
    def availability_on(self) -> bool:
        """True when the dense (no-population) path must draw a mask."""
        return self.diurnal or self.availability < 1.0

    @property
    def enabled(self) -> bool:
        """Any dynamics at all?  False: the engines build today's rounds
        (no scenario hop, no extra async state keys)."""
        return (self.diurnal or self.availability < 1.0
                or self.dropout > 0.0 or self.epoch_scale > 0.0
                or self.deadline_quantile > 0.0)


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _uniform_per_id(key, ids) -> torch.Tensor:
    """(M,) f32: one uniform per id of ``ids`` from ``key.fold_in(id)``."""
    dev = ids.device
    return torch.stack([key.fold_in(i).uniform((), dev)
                        for i in ids.tolist()])


# ---------------------------------------------------------------------------
# availability traces
# ---------------------------------------------------------------------------

def bernoulli_mask(seed: int, rate: float, round_idx, ids):
    """(M,) f32 in {0, 1}: one uniform per id of ``ids`` (M,), ``u <
    rate`` (the rate rounded to f32, as the reference's weak-typed
    compare)."""
    key = PRNGKey(seed + _AVAIL_SALT).fold_in(int(round_idx))
    u = _uniform_per_id(key, ids)
    return (u < _f32(rate, ids.device)).to(torch.float32)


def client_phases(seed: int, ids):
    """Per-client diurnal phase offsets, U[0, 1), keyed on the id only:
    a client keeps its timezone across rounds."""
    return _uniform_per_id(PRNGKey(seed + _PHASE_SALT), ids)


def availability_mask(scenario, seed: int, rate: float, round_idx, ids):
    """Availability under the scenario's trace; the shared entry point.

    * ``scenario is None`` / ``"static"``: :func:`bernoulli_mask`;
    * ``"square"``: client i is available iff ``frac(round / period +
      phase_i) < rate``;
    * ``"diurnal"``: Bernoulli with rate ``rate + min(rate, 1 - rate) *
      sin(2 pi frac(round / period + phase_i))``.

    At ``rate == 1.0`` every trace gives all ones."""
    if scenario is None or scenario.trace == "static":
        return bernoulli_mask(seed, rate, round_idx, ids)
    if scenario.trace == "square":
        frac = _trace_frac(scenario, round_idx, ids)
        return (frac < _f32(rate, ids.device)).to(torch.float32)
    key = PRNGKey(seed + _AVAIL_SALT).fold_in(int(round_idx))
    u = _uniform_per_id(key, ids)
    return (u < diurnal_prob(scenario, rate, round_idx, ids)) \
        .to(torch.float32)


def _trace_frac(scenario, round_idx, ids):
    """(M,) f32: ``frac(round / period + phase_i)``."""
    dev = ids.device
    t = _f32(float(int(round_idx)), dev) / _f32(scenario.period, dev)
    # t + phi >= 0, so C's fmod is jnp.mod (both exact)
    return torch.fmod(t + client_phases(scenario.seed, ids), 1.0)


def diurnal_prob(scenario, rate: float, round_idx, ids):
    """(M,) f32: the diurnal trace's per-client availability probability
    ``rate + min(rate, 1 - rate) * sin(2 pi frac)``."""
    dev = ids.device
    frac = _trace_frac(scenario, round_idx, ids)
    return _f32(rate, dev) + _f32(min(rate, 1.0 - rate), dev) * torch.sin(
        _f32(2.0 * math.pi, dev) * frac)


# ---------------------------------------------------------------------------
# mid-round dropout
# ---------------------------------------------------------------------------

def survival_prob(scenario, latency):
    """P(client finishes the round) = exp(-hazard * elapsed virtual
    time)."""
    lat = torch.as_tensor(latency, dtype=torch.float32)
    return torch.exp(-_f32(scenario.dropout, lat.device) * lat)


def survival_mask(scenario, round_idx, ids, latency):
    """(M,) f32 in {0, 1}: the per-(round, client) survival draw of the
    synchronous engines; ``latency`` is the capability base."""
    key = PRNGKey(scenario.seed + _DROP_SALT).fold_in(int(round_idx))
    u = _uniform_per_id(key, ids)
    return (u < survival_prob(scenario, latency)).to(torch.float32)


def survival_draw(scenario, event_idx, client_id, latency):
    """() f32 in {0, 1}: the async engine's draw, one per arrival event,
    keyed (event, client)."""
    key = PRNGKey(scenario.seed + _DROP_SALT).fold_in(int(event_idx)) \
        .fold_in(int(client_id))
    lat = torch.as_tensor(latency, dtype=torch.float32)
    u = key.uniform((), lat.device)
    return (u < survival_prob(scenario, lat)).to(torch.float32)


# ---------------------------------------------------------------------------
# heterogeneity-aware dispatch (FedMCCS local-epoch scaling)
# ---------------------------------------------------------------------------

def epoch_steps(scenario, local_steps: int, resources):
    """Per-client local-step budgets: ``scale_i = clip(median(lat) /
    lat_i, floor, 1)`` over the capability latency (``jnp.median``'s
    midpoint median), ``n_i = max(1, round(local_steps * scale_i))``
    (half to even).  Returns ``(n_steps (C,) int32, scale (C,) f32)``."""
    lat = capability_latency(resources)
    srt = torch.sort(lat).values
    C = lat.shape[0]
    med = (srt[(C - 1) // 2] + srt[C // 2]) * 0.5
    dev = lat.device
    scale = torch.clamp(med / lat, min=_f32(scenario.epoch_scale, dev),
                        max=_f32(1.0, dev))
    n = torch.clamp(torch.round(_f32(float(local_steps), dev) * scale),
                    min=1.0).to(torch.int32)
    return n, scale


# ---------------------------------------------------------------------------
# adaptive deadline arming (completion-time quantile tracking)
# ---------------------------------------------------------------------------

QUANTILE_ETA = 0.05


def quantile_init(latency):
    """The first completion-time estimate: the mean of the first dispatch
    generation's latencies."""
    return torch.as_tensor(latency, dtype=torch.float32).mean()


def quantile_update(q, x, quantile: float, eta: float = QUANTILE_ETA):
    """One Robbins-Monro step ``q + max(eta q, 1e-4) (quantile - 1[x <
    q])``."""
    dev = q.device
    step = torch.maximum(_f32(eta, dev) * q, _f32(1e-4, dev))
    ind = (torch.as_tensor(x, dtype=torch.float32) < q).to(torch.float32)
    return q + step * (_f32(quantile, dev) - ind)
