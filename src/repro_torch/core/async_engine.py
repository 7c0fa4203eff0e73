"""The virtual-clock asynchronous engine (port of
``repro.core.async_engine``): FedBuff and FedAsync as the ``async``
topology of the round engine.

Every client slot draws a latency per dispatch from its simulated device
profile (``data.pipeline.device_latency`` over the FedMCCS resources), and
the server consumes completions in virtual-time order.  One round of
``run_rounds`` is one **server event**, a client upload arriving:

    pop      — the slot with the earliest completion time (ties to the
               lowest index, so constant latencies pop in slot order);
               its staleness tau (the server version now minus the one it
               was dispatched on) and FedAsync weight ``(1 + tau)^-alpha``;
    arrive   — the slot enters the buffer, and its pending pipeline row
               (the EF residual advanced when its payload was encoded) is
               committed: written into ``comm_state``, or scattered into
               the population's residual store under the client id the
               slot hosts;
    flush    — when the buffer holds ``buffer_size`` uploads, or the
               clock has passed the flush deadline, the server aggregates
               the buffer staleness-weighted, steps its optimizer with the
               buffer's mean staleness, bumps the server version and
               re-dispatches the flushed slots on the new model;
    ledger   — one upload per event, the downlink paid per re-dispatched
               slot at a flush, and the virtual time.

**The dispatch is the sync engine's** (``engine.make_dispatch``, the same
object and code as the sim round's wire), and the key schedule is the
sync one (``state.rng.split(5)`` per generation), so with constant
latencies and ``buffer_size == C`` an async run equals the sync run bit
for bit: C pops in slot order, one flush per generation, weights
``(1 + 0)^-alpha == 1`` and a mean staleness of 0.

Where the reference keeps the buffer in static shapes (a (C,)-slotted
tree masked by ``isinf(next_done)``, every slot re-dispatched at a flush
and merged under the mask, the flush under ``lax.cond``), the port
branches on the host and re-dispatches the flushed slots only; a slot's
rows depend only on its own batch, state and keys, so they are the rows
the reference merges.  The scheduler's vectors (clock, completion times,
versions, buffer weights and staleness) live on the CPU, where the
latencies are drawn, so an event without a flush waits on nothing; the
buffered rows, pending pipeline rows and losses live on the engine's
device and are updated in place (an event consumes its input state, as
the reference's donated scan carries are).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.compress.residual_store import _leaves
from repro_torch.core import server_opt
from repro_torch.core.rng import PRNGKey
from repro_torch.core.types import CommLedger, FLConfig, FLState
from repro_torch.data.pipeline import LATENCY_PROFILES, device_latency
from repro_torch.models.model import Model

_ALGORITHMS = ("fedavg", "fedsgd", "fedprox")


def _async_knobs(fl: FLConfig, topo, n_slots: int = 0) -> tuple:
    """Resolve (buffer_size K, staleness alpha, latency profile, flush
    deadline): Topology fields win, the FLConfig fields are the fallback,
    K == 0 means every slot, and a deadline of 0 means count-only
    flushing.  ``n_slots`` is the in-flight slot count (n_clients, or the
    cohort over a population)."""
    C = n_slots or topo.n_clients
    K = topo.buffer_size or fl.async_buffer_size or C
    if not (1 <= K <= C):
        raise ValueError(f"async buffer_size must be in [1, n_slots]; "
                         f"got {K} with {C} slots")
    alpha = (topo.staleness_alpha if topo.staleness_alpha is not None
             else fl.staleness_alpha)
    profile = topo.latency_profile or fl.latency_profile
    if profile not in LATENCY_PROFILES:
        raise ValueError(f"unknown latency profile {profile!r}; "
                         f"have {LATENCY_PROFILES}")
    deadline = (topo.flush_deadline if topo.flush_deadline is not None
                else fl.async_flush_deadline)
    if deadline < 0:
        raise ValueError(f"async_flush_deadline must be >= 0 (0 disables "
                         f"deadline flushing); got {deadline}")
    return int(K), float(alpha), profile, float(deadline)


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def build_async_engine(model: Model, fl: FLConfig, topo, data_fn,
                       chunk: int = 512, device=None, population=None):
    """Build the async event executor (a RoundEngine whose ``round_fn`` is
    one server event) on ``device``.  ``data_fn(version) -> batch`` gives
    each dispatch generation's client batch (with ``sizes`` and
    ``resources``), keyed on the server version at dispatch: the function
    a sync run's ``run_rounds`` gets, so a degenerate async run and a
    sync run see the same data.

    With a ``population`` the slot axis is the cohort: each slot hosts
    one sampled client (``slot_client``, its dataset size in
    ``slot_size``), an arrival scatters the client's pipeline row into the
    residual store, and a flush gathers the next cohort's ids for the
    flushed slots (every slot's id, as the reference gathers them) and
    dispatches them.  ``data_fn`` must then be ``data.pipeline
    .cohort_data_fn`` over the same population."""
    # late import: engine builds this topology through make_round_engine
    from repro_torch.core import engine as eng

    if data_fn is None:
        raise ValueError("the async topology samples dispatch batches inside "
                         "the event scan — pass data_fn to make_round_engine")
    if fl.algorithm not in _ALGORITHMS:
        raise ValueError(
            f"async topology supports fedavg/fedsgd/fedprox; "
            f"{fl.algorithm!r} needs synchronous control flow (SCAFFOLD "
            f"control variates / FedDANE's extra gradient round)")
    if fl.selection != "all" or fl.cmfl_threshold > 0:
        raise ValueError("async topology replaces client selection with "
                         "completion order — use selection='all' and "
                         "cmfl_threshold=0")
    if population is not None and population.n_clients != topo.n_clients:
        raise ValueError(
            f"population.n_clients ({population.n_clients}) must match "
            f"Topology.async_(n_clients={topo.n_clients})")
    # telemetry, DP and every scenario knob (the availability trace, which
    # the reference rejects here, among them) raise as not ported
    eng.check_fl(fl)

    C = topo.n_clients
    # M: the in-flight slot count; every per-slot vector below is (M,)
    M = population.cohort if population is not None else C
    K, alpha, profile, deadline = _async_knobs(fl, topo, n_slots=M)
    terms, up, down = eng.ledger_terms(model, fl)
    stateful = up.stateful
    store = (population.make_store(up, model.defs, device)
             if population is not None else None)
    # the sync engine's dispatch body, not a copy of it
    dispatch = eng.make_dispatch(model, fl, up, down, M, chunk)

    def latencies(batch, key):
        # drawn on the host, where the scheduler lives
        return device_latency(profile, batch["resources"].cpu(), key)

    def sizes_of(batch):
        s = batch.get("sizes")
        return (torch.ones((M,), dtype=torch.float32, device=device)
                if s is None else s)

    def state_from_params(params):
        # generation 0's key schedule is the sync engine's round 0 split
        _, k_down, k_sel, k_up, k_next = PRNGKey(fl.seed).split(5)
        batch0 = data_fn(0)
        if store is not None:
            ids0 = population.cohort_ids(0, device)
            rows0, comm0 = store.gather(store.init(), ids0)
        else:
            comm0 = (eng.comm_state_init(up, params, M, device) if stateful
                     else None)
            rows0 = comm0
        updates, losses, pending = dispatch(params, batch0, rows0, k_down,
                                            k_up)
        A = {
            "clock": _f32(0.0),
            "next_done": latencies(batch0, k_sel),       # all M in flight
            "version": torch.zeros((M,), dtype=torch.int32),
            "server_version": torch.zeros((), dtype=torch.int32),
            "updates": updates,
            "buf_w": torch.zeros((M,), dtype=torch.float32),
            "buf_tau": torch.zeros((M,), dtype=torch.float32),
            "losses": losses,
            "next_deadline": _f32(deadline if deadline > 0
                                  else float("inf")),
        }
        if stateful:
            A["pending_comm"] = pending
        if population is not None:
            A["slot_client"] = ids0
            A["slot_size"] = sizes_of(batch0)
        return FLState(
            params=params,
            server_opt_state=server_opt.init_state(fl.server_opt, params),
            control=None, client_controls=None, comm_state=comm0,
            rng=k_next, round=0, async_state=A)

    def init_fn(seed=0):
        return state_from_params(model.init(seed, device))

    # ------------------------------------------------------------------ hops
    def hop_pop(ctx):
        A = ctx["state"].async_state
        # torch.argmin returns the first minimum: ties -> lowest index
        c = int(torch.argmin(A["next_done"]))
        tau = (A["server_version"] - A["version"][c]).to(torch.float32)
        ctx.update(c=c, tau=tau,
                   clock=torch.maximum(A["clock"], A["next_done"][c]),
                   stale_w=server_opt.staleness_scale(fl, tau, alpha))
        return ctx

    def hop_arrive(ctx):
        """Delivery of one slot's upload: it enters the buffer with its
        staleness weight and raw tau, and its pending pipeline row is
        committed (only a slot's own uploads touch its row, so commit
        order is safe)."""
        st, A, c = ctx["state"], dict(ctx["state"].async_state), ctx["c"]
        for k, v in (("next_done", float("inf")), ("buf_w", ctx["stale_w"]),
                     ("buf_tau", ctx["tau"])):
            A[k] = A[k].clone()
            A[k][c] = v
        A["clock"] = ctx["clock"]
        if store is not None:
            rows = tuple(eng._index_state(p, slice(c, c + 1))
                         for p in A["pending_comm"])
            ctx["new_comm"] = store.scatter(
                st.comm_state, A["slot_client"][c:c + 1], rows)
        elif stateful:
            for dst, src in zip(_leaves(st.comm_state),
                                _leaves(A["pending_comm"])):
                dst[c].copy_(src[c])
            ctx["new_comm"] = st.comm_state
        else:
            ctx["new_comm"] = None
        ctx["A"] = A
        ctx["fill"] = int(torch.isinf(A["next_done"]).sum())
        return ctx

    def flush(ctx):
        """FedBuff aggregation of the buffer and the flushed slots'
        next-generation dispatch."""
        st, A = ctx["state"], ctx["A"]
        comm = ctx["new_comm"]            # committed rows, this arrival's too
        mask = torch.isinf(A["next_done"])
        slots = torch.nonzero(mask).flatten().tolist()
        maskf = mask.to(torch.float32)
        mask_d = maskf.to(device)
        new_ver = A["server_version"] + 1
        # the next generation's key schedule is the sync engine's next round
        _, k_down, k_sel, k_up, k_next = st.rng.split(5)
        nbatch = data_fn(int(new_ver))
        if population is not None:
            # the weights of the clients the slots HOST (their sizes at
            # dispatch): nbatch holds the next cohort's clients
            w = A["slot_size"] * mask_d
        else:
            # dataset sizes are the same every generation
            w = sizes_of(nbatch) * mask_d
        wsum = torch.clamp(w.sum(), min=1e-9)
        agg = dispatch.aggregate_rows(A["updates"], A["buf_w"].to(device) * w,
                                      wsum)
        # the flushed buffer's mean staleness scales the adaptive server
        # moments (0 in the degenerate limit, where the scale is exactly 1)
        tau_mean = ((maskf * A["buf_tau"]).sum()
                    / torch.clamp(maskf.sum(), min=1.0))
        new_params, new_sos = server_opt.apply(
            fl, st.params, agg, st.server_opt_state, staleness=tau_mean,
            staleness_alpha=alpha)
        del agg
        loss = (w * A["losses"]).sum() / wsum
        if population is not None:
            # flushed slots take on the new cohort's clients; in-flight
            # slots keep theirs
            ids_disp = torch.where(mask_d > 0,
                                   population.cohort_ids(int(new_ver),
                                                         device),
                                   A["slot_client"])
            rows_in, comm = store.gather(comm, ids_disp)
        else:
            rows_in = comm
        lat = latencies(nbatch, k_sel)
        rows, losses, pending = dispatch(new_params, nbatch, rows_in, k_down,
                                         k_up, clients=slots)
        del rows_in
        idx = torch.tensor(slots, dtype=torch.long, device=device)
        for n, leaf in A["updates"].items():
            leaf.index_copy_(0, idx, rows.pop(n))
        A["losses"] = A["losses"].index_copy(0, idx, losses)
        if stateful:
            for dst, src in zip(_leaves(A["pending_comm"]), _leaves(pending)):
                dst.index_copy_(0, idx, src)
        A["next_done"] = torch.where(mask, ctx["clock"] + lat,
                                     A["next_done"])
        A["version"] = torch.where(mask, new_ver, A["version"])
        A["buf_w"] = torch.where(mask, 0.0, A["buf_w"])
        A["buf_tau"] = torch.where(mask, 0.0, A["buf_tau"])
        A["server_version"] = new_ver
        if deadline > 0:
            A["next_deadline"] = ctx["clock"] + _f32(deadline)
        if population is not None:
            A["slot_client"] = ids_disp
            A["slot_size"] = torch.where(mask_d > 0, sizes_of(nbatch),
                                         A["slot_size"])
        ctx.update(new_params=new_params, new_sos=new_sos, A=A,
                   new_rng=k_next, loss=loss, n_down=maskf.sum(),
                   flushed=_f32(1.0), new_comm=comm)
        return ctx

    def hop_flush(ctx):
        """Fires on the buffer count (fill >= K), or when the popped
        completion time has reached the flush deadline; the buffer is
        never empty here (this event's upload is in it)."""
        st, A = ctx["state"], ctx["A"]
        fire = ctx["fill"] >= K
        if deadline > 0:
            fire = fire or bool(ctx["clock"] >= A["next_deadline"])
        if fire:
            return flush(ctx)
        ctx.update(new_params=st.params, new_sos=st.server_opt_state,
                   new_rng=st.rng, loss=A["losses"].mean(), n_down=_f32(0.0),
                   flushed=_f32(0.0))
        return ctx

    def hop_ledger(ctx):
        # one upload per event; the downlink is paid at a flush, once per
        # re-dispatched slot
        n_down = ctx["n_down"]
        ctx["ledger"] = CommLedger(
            uplink_wire=_f32(terms["up_wire"]),
            uplink_entropy=_f32(terms["up_entropy"]),
            downlink_wire=n_down * _f32(terms["down_wire"]),
            uplink_dense=_f32(terms["dense"]),
            downlink_dense=n_down * _f32(terms["dense"]),
            virtual_time=ctx["clock"])
        return ctx

    def hop_finalize(ctx):
        st = ctx["state"]
        ctx["metrics"] = {
            "loss": ctx["loss"],
            "clock": ctx["clock"],
            "staleness": ctx["tau"],
            "server_version": ctx["A"]["server_version"],
            "buffer_fill": _f32(ctx["fill"]) * (1.0 - ctx["flushed"]),
            "flushed": ctx["flushed"],
            "ledger": ctx["ledger"],
        }
        ctx["new_state"] = FLState(
            params=ctx["new_params"], server_opt_state=ctx["new_sos"],
            control=None, client_controls=None, comm_state=ctx["new_comm"],
            rng=ctx["new_rng"], round=st.round + 1, async_state=ctx["A"])
        return ctx

    program = eng.RoundProgram(hops=(
        ("pop", hop_pop), ("arrive", hop_arrive), ("flush", hop_flush),
        ("ledger", hop_ledger), ("finalize", hop_finalize)))
    aux = {"buffer_size": K, "staleness_alpha": alpha,
           "latency_profile": profile, "flush_deadline": deadline,
           "events_per_generation": K, "dispatch": dispatch}
    if population is not None:
        aux.update(population=population, cohort=M, store=store)
    return eng.RoundEngine(
        topology=topo, round_fn=program, init_fn=init_fn,
        state_from_params=state_from_params, n_clients=C, terms=terms,
        device=device, aux=aux)


# ---------------------------------------------------------------------------
# convenience binding (mirrors simulate.make_sim_step)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AsyncFL:
    init_fn: Any
    step_fn: Any           # (state, batch) -> (state, metrics): one event
    n_clients: int
    buffer_size: int
    terms: dict
    engine: Any = None


def make_async_step(model: Model, fl: FLConfig, n_clients: int, data_fn,
                    buffer_size: int = 0, staleness_alpha: float = None,
                    latency_profile: str = None, flush_deadline: float = None,
                    chunk: int = 64, device=None) -> AsyncFL:
    """Build the async event step on ``device`` (``cuda`` unless
    ``device="cpu"``).  ``run_rounds(a.engine, state, data_fn, n_events)``
    then drives ``n_events`` server events; the step ignores its batch
    argument (the engine samples its own dispatch batches, keyed on the
    server version)."""
    from repro_torch.core.engine import Topology, make_round_engine
    topo = Topology.async_(n_clients, buffer_size=buffer_size,
                           staleness_alpha=staleness_alpha,
                           latency_profile=latency_profile or "",
                           flush_deadline=flush_deadline)
    engine = make_round_engine(model, fl, topo, chunk=chunk, device=device,
                               data_fn=data_fn)
    return AsyncFL(init_fn=engine.init_fn, step_fn=engine.round_fn,
                   n_clients=engine.n_clients,
                   buffer_size=engine.aux["buffer_size"],
                   terms=engine.terms, engine=engine)
