"""In-graph telemetry: ``RoundStats`` (port of ``repro.obs.telemetry``).

One ``RoundStats`` rides next to the ``CommLedger`` in every round's
metrics when ``FLConfig.telemetry`` is on.  Every field is a fixed-shape
f32 tensor, so the stats stack over ``run_rounds``' rounds like the ledger
and stay a base metric on the rounds the eval cadence skips.

Per-stage byte attribution: ``telemetry_spec`` decomposes a pipeline's
static ``wire_bits`` into one slot per carrier stage
(``pipeline.stage_sequence``; the EF, DGC, SecAgg and DPNoise wrappers
bill through ``.inner`` and add no bytes of their own).  Stage i bills its
``meta_bits`` over the input length it sees (``pipeline
.stage_input_lens``); the final stage also bills the ``32 * carrier_len``
payload floats.

``round_stats`` multiplies the static table by the round's unit (the
billed client count, or 1 where the ledger bills absolute totals), except
the last slot, which is the residual ``ledger_total - sum(previous
slots)``.  Every table entry is cast to f32 first and the slots are summed
one after another in f32, so the slots sum to the ledger's total bit for
bit in f32 (``n * sum(t_i) != sum(n * t_i)`` in f32 once totals pass
2^24).

Every constructor here only reads values the round has already computed
(weights, ledger, staleness, store masks) and static Python floats:
nothing feeds back into params, pipeline state or the ledger, and nothing
waits on the device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.compress.pipeline import stage_input_lens, stage_sequence

# staleness histogram bucket edges (virtual versions): bucket i counts tau
# in [edge_{i-1}, edge_i); the last bucket is tau >= 64
STALENESS_EDGES = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
N_STALENESS_BUCKETS = len(STALENESS_EDGES) + 1

# epoch-scale histogram: uniform buckets over (0, 1]; bucket i counts
# scales in [i/8, (i+1)/8), scale 1.0 lands in the last bucket
N_ESCALE_BUCKETS = 8


@dataclasses.dataclass
class RoundStats:
    """Fixed-shape f32 per-round telemetry (one per metrics row).

    ``up_stage_bytes`` / ``down_stage_bytes`` hold one slot per pipeline
    stage (the names live in the static :class:`TelemetrySpec`); the slots
    sum exactly to ``CommLedger.uplink_wire`` / ``downlink_wire``.  A
    scalar is 0 where its source does not exist on the topology (no async
    state: a zero staleness histogram; no store: zero counters)."""
    up_stage_bytes: torch.Tensor          # (S_up,) per-stage uplink bytes
    down_stage_bytes: torch.Tensor        # (S_down,) per-stage downlink
    staleness_hist: torch.Tensor          # (N_STALENESS_BUCKETS,)
    buffer_fill: torch.Tensor             # () async buffer fill at arrival
    store_hits: torch.Tensor              # () ResidualStore gather hits
    store_misses: torch.Tensor            # () gather misses
    store_evictions: torch.Tensor         # () occupied slots evicted
    store_sketch_recovered: torch.Tensor  # () misses answered by the tail
    selected: torch.Tensor                # () clients aggregated
    available: torch.Tensor               # () cohort members available
    avail_duty: torch.Tensor              # () available / cohort
    dropped: torch.Tensor                 # () mid-round scenario dropouts
    epoch_scale_hist: torch.Tensor        # (N_ESCALE_BUCKETS,)

    def fields(self) -> dict:
        """The tensors by field name, in field order."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Static (per-engine) stage metadata: slot names and per-unit byte
    tables (Python floats).  Lives in ``RoundEngine.aux["telemetry"]``."""
    up_names: tuple
    up_table: tuple
    down_names: tuple
    down_table: tuple

    def up_total(self) -> float:
        return float(sum(self.up_table))

    def down_total(self) -> float:
        return float(sum(self.down_table))


def stage_byte_table(pipe, sizes, scale: float = 1.0):
    """Per-stage wire bytes for one unit (one client upload), summed over
    the model's leaf sizes: each stage's ``meta_bits`` over its input
    length plus the final stage's ``32 * carrier_len`` payload, so the
    table sums to ``scale * sum(pipe.wire_bits(n) for n in sizes) / 8`` up
    to float summation order."""
    stages = stage_sequence(pipe)
    per = [0.0] * len(stages)
    for n in sizes:
        ms = stage_input_lens(stages, n)
        for i, (s, m) in enumerate(zip(stages, ms)):
            per[i] += s.meta_bits(m)
        per[-1] += 32.0 * stages[-1].carrier_len(ms[-1])
    return tuple(scale * b / 8.0 for b in per)


def telemetry_spec(up, down, sizes, up_scale: float = 1.0,
                   down_scale: float = 1.0, extra_up=()) -> TelemetrySpec:
    """The static spec for an uplink / downlink pipeline pair.
    ``extra_up`` appends named absolute-byte slots after the uplink stages;
    the last up slot is the in-round residual anchor, so appended slots
    absorb ledger terms the stage table does not cover."""
    up_names = tuple(s.name for s in stage_sequence(up))
    up_table = stage_byte_table(up, sizes, up_scale)
    for name, nbytes in extra_up:
        up_names += (name,)
        up_table += (float(nbytes),)
    if down is not None:
        down_names = tuple(s.name for s in stage_sequence(down))
        down_table = stage_byte_table(down, sizes, down_scale)
    else:
        down_names, down_table = ("none",), (0.0,)
    return TelemetrySpec(up_names, up_table, down_names, down_table)


def _f32(v, device=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _hist(idx, w, n_buckets) -> torch.Tensor:
    """``zeros(n).at[idx].add(w)`` as a one-hot sum (no scatter, so the
    same deterministic arithmetic on every device)."""
    buckets = torch.arange(n_buckets, dtype=idx.dtype, device=idx.device)
    onehot = (idx[:, None] == buckets[None, :]).to(torch.float32)
    return (onehot * w[:, None]).sum(0)


def staleness_hist(tau, weights=None) -> torch.Tensor:
    """(N_STALENESS_BUCKETS,) f32 histogram of staleness values.  A scalar
    ``tau`` (one async arrival) gives a one-hot; a vector with an
    occupancy-mask ``weights`` sums per bucket."""
    tau = torch.atleast_1d(_f32(tau))
    w = (torch.ones_like(tau) if weights is None
         else _f32(weights, tau.device).reshape(tau.shape))
    edges = torch.tensor(STALENESS_EDGES, dtype=torch.float32,
                         device=tau.device)
    idx = (tau[:, None] >= edges[None, :]).sum(dim=1)
    return _hist(idx, w, N_STALENESS_BUCKETS)


def epoch_scale_hist(scale, weights=None) -> torch.Tensor:
    """(N_ESCALE_BUCKETS,) f32 histogram of per-client local-epoch scales
    (``scenario.epoch_steps``); ``weights`` masks out clients."""
    scale = torch.atleast_1d(_f32(scale))
    w = (torch.ones_like(scale) if weights is None
         else _f32(weights, scale.device).reshape(scale.shape))
    nb = torch.tensor(float(N_ESCALE_BUCKETS), dtype=torch.float32,
                      device=scale.device)
    idx = torch.clamp(torch.floor(scale * nb).to(torch.int32), 0,
                      N_ESCALE_BUCKETS - 1)
    return _hist(idx, w, N_ESCALE_BUCKETS)


def _residual_slots(table, unit, total) -> torch.Tensor:
    """Stage slots: ``unit * f32(table[i])`` for every slot but the last,
    summed one after another in f32; the last is ``total - partial``, so
    ``partial + last == total`` holds bit for bit in f32."""
    total = _f32(total)
    unit = _f32(unit, total.device).to(total.device)
    parts = [unit * torch.tensor(t, dtype=torch.float32, device=total.device)
             for t in table[:-1]]
    partial = torch.zeros((), dtype=torch.float32, device=total.device)
    for p in parts:
        partial = partial + p
    parts.append(total - partial)
    return torch.stack(parts)


def round_stats(spec: TelemetrySpec, ledger, *, up_unit, down_unit=None,
                staleness=None, staleness_weights=None, fill=None,
                store=None, selected=None, available=None, avail_duty=None,
                dropped=None, epoch_scale=None,
                epoch_scale_weights=None) -> RoundStats:
    """One round's ``RoundStats`` from already-computed values.

    ``up_unit`` multiplies the per-unit stage table (the billed client
    count on the server topologies, 1 where the ledger is absolute);
    ``down_unit`` defaults to ``up_unit``.  ``store`` is the dict
    ``ResidualStore.stats`` returns.  ``avail_duty`` / ``dropped`` /
    ``epoch_scale`` are the scenario's counters.  Whatever is absent is 0,
    on the ledger's device."""
    dev = ledger.uplink_wire.device
    f = lambda v: (torch.zeros((), dtype=torch.float32, device=dev)
                   if v is None else _f32(v, dev))
    store = store or {}
    hist = (torch.zeros((N_STALENESS_BUCKETS,), dtype=torch.float32,
                        device=dev) if staleness is None
            else staleness_hist(staleness, staleness_weights))
    e_hist = (torch.zeros((N_ESCALE_BUCKETS,), dtype=torch.float32,
                          device=dev) if epoch_scale is None
              else epoch_scale_hist(epoch_scale, epoch_scale_weights))
    return RoundStats(
        up_stage_bytes=_residual_slots(spec.up_table, up_unit,
                                       ledger.uplink_wire),
        down_stage_bytes=_residual_slots(
            spec.down_table, up_unit if down_unit is None else down_unit,
            ledger.downlink_wire),
        staleness_hist=hist,
        buffer_fill=f(fill),
        store_hits=f(store.get("hits")),
        store_misses=f(store.get("misses")),
        store_evictions=f(store.get("evictions")),
        store_sketch_recovered=f(store.get("sketch_recovered")),
        selected=f(selected),
        available=f(available),
        avail_duty=f(avail_duty),
        dropped=f(dropped),
        epoch_scale_hist=e_hist)


def zero_stats(spec: TelemetrySpec, device=None) -> RoundStats:
    """An all-zero RoundStats with ``spec``'s slot shapes."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return RoundStats(
        up_stage_bytes=z(len(spec.up_table)),
        down_stage_bytes=z(len(spec.down_table)),
        staleness_hist=z(N_STALENESS_BUCKETS), buffer_fill=z(),
        store_hits=z(), store_misses=z(), store_evictions=z(),
        store_sketch_recovered=z(), selected=z(), available=z(),
        avail_duty=z(), dropped=z(),
        epoch_scale_hist=z(N_ESCALE_BUCKETS))
