"""The round engine (port of ``repro.core.engine``): the sim and async
topologies.

One FL round is a :class:`RoundProgram`, an ordered sequence of hops over a
plain dict context, as in the reference (the ``sim`` topology):

    rng -> [cohort] -> downlink -> [dane_gradient] -> local_update
        -> select -> [cmfl] -> wire -> [control] -> server_opt -> ledger
        -> finalize

built on the shared dispatch body (:func:`make_dispatch`: ``downlink``,
``local_update`` / ``client_updates``, ``global_gradient``,
``wire_rows``, ``aggregate_rows``).  The bracketed hops are there only
when their feature is on: a population's cohort, FedDANE's gradient
round, CMFL's relevance filter and SCAFFOLD's control variates.  The reference's
``vmap`` over clients is a Python loop over the client dim here, and its
``lax.scan`` over rounds is the Python loop of :func:`run_rounds`.

Random keys follow the reference's structure exactly: ``state.rng``
splits 5 ways per round (local, downlink, selection, uplink, next), the
uplink key splits per client, each client's key is folded with the leaf
index, and the chain folds in its stage index; the downlink roundtrips
every leaf with the same downlink key — so a test that injects
``jax.random``-backed keys gets the reference's QSGD uniforms.

The ``sim`` and ``async`` topologies are ported.  ``sim`` runs the
fedavg, fedsgd, fedprox, scaffold and feddane client algorithms, CMFL
(``cmfl_threshold``), EF or DGC uplinks, a downlink compressor
roundtripped per leaf (e.g. ``lfl8``), the ``all``, ``random``,
``power_of_choice`` and ``multi_criteria`` selection policies and the
fedavg / fedavgm / fedadam / fedyogi server step, densely or over a
streaming :class:`~repro_torch.core.population.ClientPopulation`
(``population=``: a ``cohort`` hop after ``rng``, the dispatch width set
to the cohort, and the per-client pipeline state in a ``ResidualStore``).
``async`` (:mod:`repro_torch.core.async_engine`) is the virtual-clock
FedBuff / FedAsync event engine on the same dispatch body.  Every other
knob raises ``NotImplementedError`` naming the reference module that has
it.
The client and server algorithms' state runs leaf by leaf: no hop builds
a concatenation of the model or of C clients' rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.compress.api import make_compressor
from repro_torch.compress.pipeline import error_feedback, momentum_correction
from repro_torch.core import selection as sel
from repro_torch.core import server_opt
from repro_torch.core.rng import PRNGKey
from repro_torch.core.types import CommLedger, FLConfig, FLState
from repro_torch.device import not_ported, resolve_device
from repro_torch.models.layers import scalar_like
from repro_torch.models.model import Model

_ALGORITHMS = ("fedavg", "fedsgd", "fedprox", "scaffold", "feddane")
_SCENARIO_FIELDS = ("scenario_trace", "scenario_period",
                    "scenario_availability", "scenario_dropout",
                    "scenario_epoch_scale", "scenario_deadline_quantile")


@dataclasses.dataclass(frozen=True)
class Topology:
    """Which shape the round's transport hops take; the port has ``sim``
    and ``async``."""
    kind: str
    n_clients: int = 0
    # async only; the sentinels (0 / None / "") fall back to the FLConfig
    # fields at engine build time
    buffer_size: int = 0
    staleness_alpha: float = None
    latency_profile: str = ""
    flush_deadline: float = None

    @staticmethod
    def sim(n_clients: int) -> "Topology":
        return Topology(kind="sim", n_clients=n_clients)

    @staticmethod
    def async_(n_clients: int, buffer_size: int = 0,
               staleness_alpha: float = None,
               latency_profile: str = "",
               flush_deadline: float = None) -> "Topology":
        """Virtual-clock asynchronous FL (:mod:`repro_torch.core
        .async_engine`): FedBuff buffering (``buffer_size`` K; 1 =
        FedAsync, 0 or C = the degenerate synchronous limit), FedAsync
        staleness decay ``(1 + tau)^(-staleness_alpha)``, per-dispatch
        latencies drawn from ``latency_profile`` over the FedMCCS device
        profiles, and ``flush_deadline`` (> 0: also flush when the virtual
        clock passes the last flush + deadline).  Knobs left at their
        sentinel (0 / None / "") fall back to ``FLConfig.async_buffer_size
        / staleness_alpha / latency_profile / async_flush_deadline``."""
        return Topology(kind="async", n_clients=n_clients,
                        buffer_size=buffer_size,
                        staleness_alpha=staleness_alpha,
                        latency_profile=latency_profile,
                        flush_deadline=flush_deadline)


@dataclasses.dataclass(eq=False)
class RoundProgram:
    """One FL round as an ordered sequence of named hops."""
    hops: tuple                        # ((name, fn), ...)

    def __call__(self, state: FLState, batch) -> tuple:
        ctx = {"state": state, "batch": batch}
        for _name, fn in self.hops:
            ctx = fn(ctx)
        return ctx["new_state"], ctx["metrics"]


@dataclasses.dataclass
class RoundEngine:
    """A built round executor for one (model, fl, topology) binding."""
    topology: Topology
    round_fn: RoundProgram             # (state, batch) -> (state, metrics)
    init_fn: Any                       # seed -> FLState
    state_from_params: Any             # params dict -> FLState
    n_clients: int
    terms: dict
    device: torch.device
    aux: dict = dataclasses.field(default_factory=dict)
    eval_every: int = 1                # run_rounds' metrics_fn cadence


# ---------------------------------------------------------------------------
# Uplink pipeline + static ledger terms
# ---------------------------------------------------------------------------

def check_fl(fl: FLConfig) -> None:
    """Reject the reference's knobs this slice does not run."""
    if fl.algorithm not in _ALGORITHMS:
        raise not_ported(f"algorithm={fl.algorithm!r}", "repro.core.engine")
    if fl.secure_agg or fl.dp_sigma > 0 or fl.dp_clip > 0:
        raise not_ported("secure aggregation / DP noise",
                         "repro.compress.secure_agg")
    if fl.telemetry:
        raise not_ported("telemetry", "repro.obs.telemetry")
    default = FLConfig()
    if any(getattr(fl, f) != getattr(default, f) for f in _SCENARIO_FIELDS):
        raise not_ported("scenario client dynamics", "repro.core.scenario")


def _make_uplink(fl: FLConfig, fraction: float):
    return make_compressor(fl.uplink_compressor, fraction=fraction,
                           block=fl.qsgd_block, rows=fl.sketch_rows,
                           cols=fl.sketch_cols, backend=fl.backend,
                           wire_format=fl.wire_format)


def uplink_pipeline(fl: FLConfig):
    """The uplink CommPipeline from config: the spec plus the stateful
    correction wrapper — DGC momentum correction if ``dgc_momentum`` is set
    (with the warm-up sparsity schedule when ``dgc_warmup_rounds`` > 0),
    else error feedback for biased pipelines."""
    check_fl(fl)
    if fl.dgc_warmup_rounds > 0 and fl.dgc_momentum <= 0.0:
        raise ValueError("dgc_warmup_rounds is a DGC knob — it needs "
                         "dgc_momentum > 0 to take effect")
    frac = fl.topk_fraction
    warmup = fl.dgc_warmup_rounds if fl.dgc_momentum > 0.0 else 0
    if warmup > 0:
        # the wire is sized for the first (widest) round's fraction
        # f_target^(1/(W+1)); later rounds mask down inside it
        frac = fl.topk_fraction ** (1.0 / (warmup + 1.0))
    up = _make_uplink(fl, frac)
    if warmup > 0 and not up.is_identity:
        # an explicit per-stage fraction ("topk:0.01>>...") overrides the
        # fraction kwarg and would make the warm-up a silent no-op
        at_target = _make_uplink(fl, fl.topk_fraction)
        if up.wire_bits(1 << 16) == at_target.wire_bits(1 << 16):
            raise ValueError(
                "dgc_warmup_rounds needs a fraction-kwarg-driven uplink "
                f"spec (e.g. 'topk' + topk_fraction); "
                f"{fl.uplink_compressor!r} ignores the warm-up widening")
    if fl.dgc_momentum > 0.0 and not up.is_identity:
        up = momentum_correction(up, fl.dgc_momentum, warmup_rounds=warmup,
                                 final_fraction=fl.topk_fraction)
    elif up.biased and fl.error_feedback:
        up = error_feedback(up)
    return up


def ledger_terms(model: Model, fl: FLConfig):
    """Static per-selected-client byte terms for the round ledger."""
    up = uplink_pipeline(fl)
    down = make_compressor(fl.downlink_compressor, block=fl.qsgd_block,
                           backend=fl.backend, wire_format=fl.wire_format)
    sizes = model.param_sizes()
    # SCAFFOLD ships control variates, FedDANE ships a gradient round: 2x
    scaff = 2.0 if fl.algorithm in ("scaffold", "feddane") else 1.0
    t = {
        "up_wire": scaff * sum(up.wire_bits(n) for n in sizes) / 8.0,
        "up_entropy": scaff * sum(up.entropy_bits(n) for n in sizes) / 8.0,
        "down_wire": sum(down.wire_bits(n) for n in sizes) / 8.0,
        "dense": sum(32.0 * n for n in sizes) / 8.0,
        "dp_rho": up.dp_rho_per_round(),
    }
    return t, up, down


def _make_ledger(terms: dict, n_sel) -> CommLedger:
    """``n_sel * term`` in float32, as the reference's f32 scalar times a
    weakly-typed Python float."""
    f32 = lambda v: n_sel * torch.tensor(v, dtype=torch.float32,
                                         device=n_sel.device)
    return CommLedger(uplink_wire=f32(terms["up_wire"]),
                      uplink_entropy=f32(terms["up_entropy"]),
                      downlink_wire=f32(terms["down_wire"]),
                      uplink_dense=f32(terms["dense"]),
                      downlink_dense=f32(terms["dense"]))


# ---------------------------------------------------------------------------
# Client local update
# ---------------------------------------------------------------------------

def _value_and_grad(model: Model, params: dict, batch_c, chunk):
    names = list(params)
    leaves = [p.detach().requires_grad_(True) for p in params.values()]
    loss = model.loss(dict(zip(names, leaves)), batch_c, chunk=chunk)[0]
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(names, grads))


def _client_update(model: Model, fl: FLConfig, params, batch_c, chunk,
                   control=None, c_i=None, global_grad=None):
    """One client's local training.  Returns (delta, mean_loss,
    first_loss, new_c_i).  E = 1 fedavg/fedsgd takes the reference's fast
    path: ``-lr * g`` in the parameter dtype, then cast to the delta dtype.

    ``scaffold`` adds ``(control - c_i)``, cast to the gradient's dtype, to
    every step's gradient and returns ``new_c_i = c_i - control -
    delta / (E * lr)``; ``feddane`` adds ``global_grad - g_i(params)``
    (the DANE correction, in f32, cast likewise) and, with
    ``fedprox_mu``, the proximal term.  Other algorithms return ``c_i``
    unchanged."""
    E, lr = fl.local_steps, fl.local_lr
    ddt = torch.bfloat16 if fl.delta_dtype == "bf16" else torch.float32
    fast = (E == 1 and fl.algorithm in ("fedavg", "fedsgd")
            and fl.fedprox_mu == 0.0)
    if fast:
        loss, g = _value_and_grad(model, params, batch_c, chunk)
        delta = {n: (g_ * scalar_like(-lr, g_)).to(ddt)
                 for n, g_ in g.items()}
        return delta, loss, loss, c_i

    dane_corr = None
    if fl.algorithm == "feddane" and global_grad is not None:
        _, g_i0 = _value_and_grad(model, params, batch_c, chunk)
        dane_corr = {n: global_grad[n].to(torch.float32)
                     - g_i0[n].to(torch.float32) for n in params}
        del g_i0
    prox = fl.algorithm in ("fedprox", "feddane") and fl.fedprox_mu
    scaffold = fl.algorithm == "scaffold"
    p_c = dict(params)
    losses = []
    for _ in range(E):
        loss, g = _value_and_grad(model, p_c, batch_c, chunk)
        losses.append(loss)
        step = {}
        for n, a in p_c.items():
            g_ = g[n]
            if prox:
                g_ = g_ + scalar_like(fl.fedprox_mu, g_) * \
                    (a - params[n]).to(g_.dtype)
            if dane_corr is not None:
                g_ = g_ + dane_corr[n].to(g_.dtype)
            if scaffold:
                g_ = g_ + (control[n] - c_i[n]).to(g_.dtype)
            step[n] = (a.to(torch.float32)
                       - g_.to(torch.float32) * lr).to(a.dtype)
        p_c = step
    delta = {n: (p_c[n].to(torch.float32) - p.to(torch.float32)).to(ddt)
             for n, p in params.items()}
    new_c_i = c_i
    if scaffold:
        new_c_i = {n: c_i[n] - control[n]
                   - delta[n] / scalar_like(E * lr, delta[n])
                   for n in params}
    return delta, torch.stack(losses).mean(), losses[0], new_c_i


# ---------------------------------------------------------------------------
# The shared dispatch body
# ---------------------------------------------------------------------------

def _index_state(st, c):
    if isinstance(st, torch.Tensor):
        return st[c]
    if isinstance(st, dict):
        return {k: _index_state(v, c) for k, v in st.items()}
    if isinstance(st, tuple):
        return tuple(_index_state(v, c) for v in st)
    return st


def _stack_states(states):
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(states)
    if isinstance(first, dict):
        return {k: _stack_states([s[k] for s in states]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack_states([s[i] for s in states])
                     for i in range(len(first)))
    return first


@dataclasses.dataclass(eq=False)
class Dispatch:
    """One dispatch generation: ``downlink(params, k_down) -> params`` (the
    LFL-quantized broadcast), ``local_update(params, model_batch,
    clients=None) -> (deltas, losses, first_losses)``, its general form
    ``client_updates(params, model_batch, control, client_controls,
    global_grad, clients=None) -> (deltas, losses, first_losses, new
    client controls or None)`` (SCAFFOLD's and FedDANE's solves),
    ``global_gradient(params, model_batch)`` (FedDANE's gradient round),
    ``wire_rows(deltas, comm_state, k_up, clients=None) -> (decoded rows,
    new comm_state rows)`` and ``aggregate_rows(rows, w_num, wsum)``.
    Deltas, rows and client controls are ``{leaf name: (C, *leaf
    shape)}`` in leaf order.

    ``clients``, a list of client indices, runs those clients only: the
    outputs are led by ``len(clients)`` rows in that order, while
    ``model_batch``, ``client_controls`` and ``comm_state`` stay C-led
    and are read at the listed indices.  Every client's rows depend only
    on its own batch, state and keys (the uplink key splits C ways
    either way), so a subset's rows are bit-identical to the same rows of
    a full dispatch.  Calling the object is one whole dispatch
    generation, the async engine's: downlink, local update, wire."""
    downlink: Callable
    local_update: Callable
    client_updates: Callable
    global_gradient: Callable
    wire_rows: Callable
    aggregate_rows: Callable

    @staticmethod
    def model_batch(batch) -> dict:
        """Model inputs only (FL metadata keys stay out of the loss)."""
        return {k: v for k, v in batch.items()
                if k not in ("sizes", "resources", "ids")}

    def __call__(self, params, batch, comm_state, k_down, k_up,
                 clients=None):
        """``(decoded rows, losses, new comm_state rows)`` of the listed
        clients (all when None) trained from ``params``' broadcast."""
        params = self.downlink(params, k_down)
        deltas, losses, _ = self.local_update(
            params, self.model_batch(batch), clients=clients)
        rows, new_comm = self.wire_rows(deltas, comm_state, k_up,
                                        clients=clients)
        return rows, losses, new_comm


def make_dispatch(model: Model, fl: FLConfig, up, down, C: int,
                  chunk: int) -> Dispatch:
    stateful = up.stateful

    def downlink(params, k_down):
        # every leaf roundtrips with the same key, as the reference's
        # jax.tree.map over the params does
        if down.is_identity:
            return params
        return {n: down.roundtrip(k_down, p.reshape(-1).to(torch.float32))
                .reshape(p.shape).to(p.dtype) for n, p in params.items()}

    def client_updates(params, model_batch, control=None,
                       client_controls=None, global_grad=None,
                       clients=None):
        cs = range(C) if clients is None else clients
        ddt = torch.bfloat16 if fl.delta_dtype == "bf16" else torch.float32
        deltas = {n: torch.empty((len(cs),) + tuple(p.shape), dtype=ddt,
                                 device=p.device) for n, p in params.items()}
        new_ci = None
        if client_controls is not None:
            new_ci = {n: torch.empty((len(cs),) + tuple(v.shape[1:]),
                                     dtype=v.dtype, device=v.device)
                      for n, v in client_controls.items()}
        losses, first = [], []
        for j, c in enumerate(cs):
            b = {k: v[c] for k, v in model_batch.items()}
            c_i = (None if client_controls is None else
                   {n: v[c] for n, v in client_controls.items()})
            d, loss, first_loss, nci = _client_update(
                model, fl, params, b, chunk, control, c_i, global_grad)
            for n, v in d.items():
                deltas[n][j] = v
            if new_ci is not None:
                for n, v in nci.items():
                    new_ci[n][j] = v
            del d, nci
            losses.append(loss)
            first.append(first_loss)
        return deltas, torch.stack(losses), torch.stack(first), new_ci

    def local_update(params, model_batch, clients=None):
        return client_updates(params, model_batch, clients=clients)[:3]

    def global_gradient(params, model_batch):
        # each client's gradient at the broadcast params, accumulated in
        # f32 in client order, then divided by C (the reference's f32
        # mean over the client dim, up to the order of its reduction)
        acc = None
        for c in range(C):
            b = {k: v[c] for k, v in model_batch.items()}
            _, g = _value_and_grad(model, params, b, chunk)
            if acc is None:
                acc = {n: v.to(torch.float32) for n, v in g.items()}
            else:
                for n, v in g.items():
                    acc[n] += v.to(torch.float32)
            del g
        return {n: v / C for n, v in acc.items()}

    def wire_rows(deltas, comm_state, k_up, clients=None):
        cs = range(C) if clients is None else clients
        rngs_up = k_up.split(C)
        dec_rows, st_rows = {}, []
        for li, (name, leaf) in enumerate(deltas.items()):
            flat = leaf.reshape(len(cs), -1).to(torch.float32)
            n = flat.shape[1]
            dec = torch.empty_like(flat)
            new_states = []
            for j, c in enumerate(cs):
                r = rngs_up[c].fold_in(li)
                st = (_index_state(comm_state[li], c) if stateful
                      else up.init((n,), device=flat.device))
                payload, nst = up.encode(st, r, flat[j])
                dec[j] = up.decode(payload, n)
                new_states.append(nst)
            if stateful:
                st_rows.append(_stack_states(new_states))
            dec_rows[name] = dec.reshape(leaf.shape)
        return dec_rows, (tuple(st_rows) if stateful else None)

    def aggregate_rows(rows, w_num, wsum):
        return {n: ((w_num[:, None] * leaf.reshape(C, -1)).sum(0) / wsum)
                .reshape(leaf.shape[1:]) for n, leaf in rows.items()}

    return Dispatch(downlink=downlink, local_update=local_update,
                    client_updates=client_updates,
                    global_gradient=global_gradient, wire_rows=wire_rows,
                    aggregate_rows=aggregate_rows)


def comm_state_init(pipe, params: dict, C: int, device):
    """Zero pipeline state per leaf with a leading client dim."""
    def lead(t):
        if isinstance(t, torch.Tensor):
            return torch.zeros((C,) + tuple(t.shape), dtype=t.dtype,
                               device=device)
        if isinstance(t, dict):
            return {k: lead(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(lead(v) for v in t)
        return t
    return tuple(lead(pipe.init(tuple(p.shape), device="meta"))
                 for p in params.values())


# ---------------------------------------------------------------------------
# The server-topology round program
# ---------------------------------------------------------------------------

def _build_server_program(fl: FLConfig, terms: dict, dispatch: Dispatch,
                          C: int, population=None, store=None,
                          device=None) -> RoundProgram:

    def hop_rng(ctx):
        # the reference's split: (local, downlink, selection, uplink,
        # next); the port's local update draws nothing
        _, r_down, r_sel, r_up, r_next = ctx["state"].rng.split(5)
        ctx.update(r_down=r_down, r_sel=r_sel, r_up=r_up, r_next=r_next)
        return ctx

    def hop_downlink(ctx):
        # clients train from the (LFL-quantized) broadcast model; the server
        # step applies the aggregate to the unquantized params
        ctx["params"] = dispatch.downlink(ctx["state"].params, ctx["r_down"])
        return ctx

    def hop_dane_gradient(ctx):
        # FedDANE: one extra communication round, the clients' mean
        # gradient at the broadcast params before the corrected local
        # solves (the ledger bills the uplink twice)
        ctx["global_grad"] = dispatch.global_gradient(
            ctx["params"], Dispatch.model_batch(ctx["batch"]))
        return ctx

    def hop_local_update(ctx):
        st = ctx["state"]
        deltas, losses, first_losses, new_ci = dispatch.client_updates(
            ctx.pop("params"), Dispatch.model_batch(ctx["batch"]),
            control=st.control, client_controls=st.client_controls,
            global_grad=ctx.pop("global_grad", None))
        ctx.update(deltas=deltas, losses=losses, first_losses=first_losses,
                   new_ci=new_ci)
        return ctx

    def hop_cohort(ctx):
        # this round's client ids, pure in (population.seed, round): the
        # data pipeline (cohort_data_fn) computes the same ids
        ctx["ids"] = population.cohort_ids(ctx["state"].round, device)
        return ctx

    def _select(ctx, availability=None):
        batch, dev = ctx["batch"], ctx["losses"].device
        sizes = batch.get("sizes")
        if sizes is None:
            sizes = torch.ones((C,), dtype=torch.float32, device=dev)
        resources = batch.get("resources")
        if resources is None:
            resources = torch.ones((C, 4), dtype=torch.float32, device=dev)
        ctx["weights"] = sel.select(fl, ctx["r_sel"],
                                    losses=ctx["first_losses"],
                                    resources=resources, sizes=sizes,
                                    availability=availability)
        return ctx

    def hop_select(ctx):
        return _select(ctx)

    def hop_select_available(ctx):
        # the population's per-(id, round) availability draw zero-weights
        # the sampled clients that are offline this round
        return _select(ctx, population.availability_mask(ctx["state"].round,
                                                         ctx["ids"]))

    def hop_cmfl(ctx):
        # CMFL: a client whose raw update agrees in sign with the previous
        # global update on fewer than cmfl_threshold of the coordinates is
        # irrelevant and never uploads (zero weight, so the ledger bills
        # the reduced n_sel); every client is relevant at round 0.  The
        # agreements are counted per leaf as integers and divided by the
        # model's size once, in f32: up to 2^24 coordinates that is the
        # reference's f32 mean bit for bit, and above it the integer count
        # is the exact one (no C x model concatenation is built)
        st, deltas, weights = ctx["state"], ctx["deltas"], ctx["weights"]
        if st.round == 0:
            rel = torch.ones_like(weights)
        else:
            agree = torch.zeros((C,), dtype=torch.int64,
                                device=weights.device)
            total = 0
            for n, d in deltas.items():
                p = st.prev_delta[n].reshape(1, -1)
                agree += (torch.sign(d.reshape(C, -1))
                          == torch.sign(p)).sum(1)
                total += p.shape[1]
            rel = agree.to(torch.float32) / torch.tensor(
                float(total), dtype=torch.float32, device=weights.device)
        ctx["weights"] = weights * (rel >= fl.cmfl_threshold).to(
            weights.dtype)
        return ctx

    def hop_wire(ctx):
        # the sim wire: encode/decode every client's rows, then the
        # weighted mean; the deltas leave the context so that they are freed
        # as soon as the wire returns
        weights = ctx["weights"]
        rows, new_comm = dispatch.wire_rows(ctx.pop("deltas"),
                                            ctx["state"].comm_state,
                                            ctx["r_up"])
        wsum = torch.clamp(weights.sum(), min=1e-9)
        ctx.update(agg=dispatch.aggregate_rows(rows, weights, wsum),
                   new_comm=new_comm,
                   n_sel=(weights > 0).sum().to(torch.float32))
        return ctx

    def hop_population_wire(ctx):
        # the sim wire over the cohort (reference _population_wire): its
        # rows are gathered from the store, advanced by the same wire_rows
        # as the dense wire, and scattered back at the commit; with
        # capacity >= n_clients and cohort == n_clients gather and scatter
        # are the identity
        weights = ctx["weights"]
        rows_in, st = store.gather(ctx["state"].comm_state, ctx["ids"])
        rows, new_rows = dispatch.wire_rows(ctx.pop("deltas"), rows_in,
                                            ctx["r_up"])
        del rows_in
        new_comm = store.scatter(st, ctx["ids"], new_rows)
        wsum = torch.clamp(weights.sum(), min=1e-9)
        ctx.update(agg=dispatch.aggregate_rows(rows, weights, wsum),
                   new_comm=new_comm,
                   n_sel=(weights > 0).sum().to(torch.float32))
        return ctx

    def hop_control(ctx):
        # SCAFFOLD's control variates, leaf by leaf: unselected clients
        # keep their c_i; the server control moves by n_sel / C times the
        # weighted mean of the selected clients' c_i changes
        st, weights = ctx["state"], ctx["weights"]
        new_ci = ctx["new_ci"]
        keep = [c for c, on in enumerate((weights > 0).tolist()) if not on]
        wsum = torch.clamp(weights.sum(), min=1e-9)
        control = {}
        for n, new in new_ci.items():
            old = st.client_controls[n]
            for c in keep:
                new[c] = old[c]
            dci = (new - old).reshape(C, -1)
            agg = ((weights[:, None] * dci).sum(0) / wsum).reshape(
                new.shape[1:])
            del dci
            control[n] = st.control[n] + (ctx["n_sel"] / C) * agg
        ctx["control"] = control
        return ctx

    def hop_server_opt(ctx):
        st = ctx["state"]
        new_params, new_sos = server_opt.apply(fl, st.params, ctx["agg"],
                                               st.server_opt_state)
        ctx.update(new_params=new_params, new_sos=new_sos)
        return ctx

    def hop_ledger(ctx):
        ctx["ledger"] = _make_ledger(terms, ctx["n_sel"])
        return ctx

    def hop_finalize(ctx):
        st, weights, losses = ctx["state"], ctx["weights"], ctx["losses"]
        wsum = torch.clamp(weights.sum(), min=1e-9)
        ctx["metrics"] = {
            "loss": (weights * losses).sum() / wsum,
            "loss_all": losses.mean(),
            "selected": ctx["n_sel"],
            "ledger": ctx["ledger"],
        }
        ctx["new_state"] = FLState(
            params=ctx["new_params"], server_opt_state=ctx["new_sos"],
            control=ctx.get("control"), client_controls=ctx.get("new_ci"),
            comm_state=ctx["new_comm"], rng=ctx["r_next"],
            round=st.round + 1,
            prev_delta=ctx["agg"] if fl.cmfl_threshold > 0 else None)
        return ctx

    available = population is not None and population.availability_active
    hops = [("rng", hop_rng)]
    if population is not None:
        hops.append(("cohort", hop_cohort))
    hops.append(("downlink", hop_downlink))
    if fl.algorithm == "feddane":
        hops.append(("dane_gradient", hop_dane_gradient))
    hops += [("local_update", hop_local_update),
             ("select", hop_select_available if available else hop_select)]
    if fl.cmfl_threshold > 0:
        hops.append(("cmfl", hop_cmfl))
    # a stateless pipeline keeps no per-client rows: no store
    hops.append(("wire", hop_population_wire if store is not None
                 else hop_wire))
    if fl.algorithm == "scaffold":
        hops.append(("control", hop_control))
    hops += [("server_opt", hop_server_opt), ("ledger", hop_ledger),
             ("finalize", hop_finalize)]
    return RoundProgram(hops=tuple(hops))


def _build_sim(model: Model, fl: FLConfig, topo: Topology, chunk: int,
               device, population=None) -> RoundEngine:
    C = topo.n_clients
    terms, up, down = ledger_terms(model, fl)
    scaffold = fl.algorithm == "scaffold"
    store, aux = None, {}
    if population is not None:
        if scaffold:
            raise ValueError(
                "scaffold keeps dense (C, model) client controls — "
                "incompatible with a streaming ClientPopulation")
        if population.n_clients != C:
            raise ValueError(
                f"population.n_clients ({population.n_clients}) must match "
                f"Topology.sim(n_clients={C})")
        C = population.cohort           # dispatch width = the cohort slice
        store = population.make_store(up, model.defs, device)
        aux = dict(population=population, cohort=C, store=store)
    dispatch = make_dispatch(model, fl, up, down, C, chunk)
    program = _build_server_program(fl, terms, dispatch, C,
                                    population=population, store=store,
                                    device=device)

    def state_from_params(params):
        def zeros(lead=()):
            return {n: torch.zeros(lead + tuple(p.shape),
                                   dtype=torch.float32, device=p.device)
                    for n, p in params.items()}
        return FLState(
            params=params,
            server_opt_state=server_opt.init_state(fl.server_opt, params),
            control=zeros() if scaffold else None,
            client_controls=zeros((C,)) if scaffold else None,
            comm_state=(store.init() if store is not None
                        else comm_state_init(up, params, C, device)
                        if up.stateful else None),
            rng=PRNGKey(fl.seed), round=0,
            prev_delta=zeros() if fl.cmfl_threshold > 0 else None)

    def init_fn(seed=0):
        return state_from_params(model.init(seed, device))

    return RoundEngine(topology=topo, round_fn=program, init_fn=init_fn,
                       state_from_params=state_from_params,
                       n_clients=topo.n_clients, terms=terms, device=device,
                       aux=aux)


# above this client count a dense sim build would allocate O(C x model)
# comm_state rows; the build refuses and points at the streaming path
POPULATION_DENSE_LIMIT = 4096


def _check_population(fl: FLConfig, topology: Topology) -> None:
    C = topology.n_clients
    if C <= POPULATION_DENSE_LIMIT:
        return
    if not uplink_pipeline(fl).stateful:
        return      # stateless sim keeps no per-client rows; C-wide is legal
    raise ValueError(
        f"{topology.kind} topology with n_clients={C} would allocate dense "
        f"per-client state — O(C x model) comm_state rows for the stateful "
        f"uplink pipeline — above the {POPULATION_DENSE_LIMIT}-client dense "
        f"limit. Pass a streaming population instead: "
        f"make_round_engine(..., population=ClientPopulation("
        f"n_clients={C}, cohort=1024)) (core.population; CLI: "
        f"--population {C} --cohort 1024), which bounds per-client state "
        f"by the residual-store capacity (DESIGN.md §9).")


def make_round_engine(model: Model, fl: FLConfig, topology: Topology,
                      chunk: int = 512, device=None, data_fn=None,
                      population=None) -> RoundEngine:
    """Build the round executor for one (model, fl, topology) binding on
    ``device`` (``cuda`` unless ``device="cpu"`` is asked for).

    The ``async`` topology also needs ``data_fn(version) -> batch`` at
    build time: its events sample each dispatch generation's batch,
    keyed on the server version at dispatch (:mod:`repro_torch.core
    .async_engine`).

    ``population`` (a :class:`repro_torch.core.population
    .ClientPopulation`) switches the sim and async rounds to streaming
    cohorts: each round or generation touches ``population.cohort``
    sampled clients, and per-client pipeline state lives in a bounded
    residual store.  Dense builds above ``POPULATION_DENSE_LIMIT`` clients
    with a stateful uplink are rejected."""
    dev = resolve_device(device)
    if topology.kind not in ("sim", "async"):
        raise not_ported(f"topology {topology.kind!r}", "repro.core.engine")
    if topology.n_clients <= 0:
        raise ValueError(f"{topology.kind} topology needs n_clients > 0")
    if population is None:
        _check_population(fl, topology)
    if topology.kind == "async":
        from repro_torch.core.async_engine import build_async_engine
        engine = build_async_engine(model, fl, topology, data_fn, chunk,
                                    dev, population=population)
    else:
        engine = _build_sim(model, fl, topology, chunk, dev,
                            population=population)
    engine.eval_every = max(1, int(fl.eval_every))
    return engine


def _gated_metrics(tmpl: dict, base: dict) -> dict:
    """A skipped round's metrics: each key of the metrics_fn output
    ``tmpl`` that the base metrics hold with the same shape and dtype
    keeps the base value; an eval-only key is NaN (0 for integer dtypes),
    as the reference's ``_gated_metrics`` fills it."""
    out = {}
    for k, t in tmpl.items():
        b = base.get(k)
        if not isinstance(t, torch.Tensor) or (
                isinstance(b, torch.Tensor) and b.shape == t.shape
                and b.dtype == t.dtype):
            out[k] = b
        else:
            fill = float("nan") if t.dtype.is_floating_point else 0
            out[k] = torch.full(t.shape, fill, dtype=t.dtype,
                                device=t.device)
    return out


def run_rounds(engine: RoundEngine, state, data_fn, n: int, metrics_fn=None,
               eval_every=None):
    """Run ``n`` rounds; ``data_fn(round_idx) -> batch``.  Returns
    ``(final_state, metrics)`` with every metric stacked over a leading
    (n,) round dim (the ledger as a CommLedger of (n,) tensors).  On the
    ``async`` topology a round is one server event, which samples its own
    dispatch batches: no batch is drawn for it here.

    ``metrics_fn(new_state, metrics) -> metrics`` (optional) appends
    per-round metrics such as a held-out eval loss.  It runs every
    ``eval_every``-th round (default the engine's ``FLConfig.eval_every``):
    the last of each cadence window, where the pre-round ``state.round %
    eval_every == eval_every - 1``, so a run whose length is a multiple of
    the cadence evaluates its final round.  On the other rounds its
    eval-only float metrics are NaN."""
    if n <= 0:
        return state, None
    ee = max(1, int(engine.eval_every if eval_every is None else eval_every))
    rows, tmpl = [], None
    for _ in range(n):
        due = state.round % ee == ee - 1
        batch = None if engine.topology.kind == "async" else \
            data_fn(state.round)
        state, m = engine.round_fn(state, batch)
        if metrics_fn is not None and due:
            m = metrics_fn(state, m)
            tmpl = m
        rows.append((m, metrics_fn is not None and not due))
    if tmpl is None and metrics_fn is not None:
        # no round of this run was due: the output's keys, shapes and
        # dtypes from one call on the final state, its values unused
        tmpl = metrics_fn(state, rows[-1][0])
    rows = [_gated_metrics(tmpl, m) if skipped else m for m, skipped in rows]
    metrics = {k: torch.stack([m[k] for m in rows])
               for k in rows[0] if k != "ledger"}
    led = {k: torch.stack([m["ledger"].fields()[k] for m in rows])
           for k in rows[0]["ledger"].fields()}
    metrics["ledger"] = CommLedger(**led)
    return state, metrics
