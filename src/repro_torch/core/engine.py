"""The round engine, sim slice (port of ``repro.core.engine``).

One FL round is a :class:`RoundProgram`, an ordered sequence of hops over a
plain dict context, as in the reference:

    rng -> local_update -> select -> wire -> server_opt -> ledger -> finalize

built on the shared dispatch body (:func:`make_dispatch`:
``local_update``, ``wire_rows``, ``aggregate_rows``; the reference's
downlink hop is the identity in this slice and has no hop here).  The reference's
``vmap`` over clients is a Python loop over the client dim here, and its
``lax.scan`` over rounds is the Python loop of :func:`run_rounds`.

Random keys follow the reference's structure exactly: ``state.rng``
splits 5 ways per round, the uplink key splits per client, each client's
key is folded with the leaf index, and the chain folds in its stage index
— so a test that injects ``jax.random``-backed keys gets the reference's
QSGD uniforms.

Only the ``sim`` topology with fedavg / fedsgd / fedprox, an identity
downlink, ``selection="all"`` and the ``fedavg`` server step is ported;
every other knob raises ``NotImplementedError`` naming the reference module
that has it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.compress.api import make_compressor
from repro_torch.compress.pipeline import error_feedback
from repro_torch.core import selection as sel
from repro_torch.core import server_opt
from repro_torch.core.rng import PRNGKey
from repro_torch.core.types import CommLedger, FLConfig, FLState
from repro_torch.device import not_ported, resolve_device
from repro_torch.models.layers import scalar_like
from repro_torch.models.model import Model

_ALGORITHMS = ("fedavg", "fedsgd", "fedprox")
_SCENARIO_FIELDS = ("scenario_trace", "scenario_period",
                    "scenario_availability", "scenario_dropout",
                    "scenario_epoch_scale", "scenario_deadline_quantile")


@dataclasses.dataclass(frozen=True)
class Topology:
    """Which shape the round's transport hops take; the port has ``sim``."""
    kind: str
    n_clients: int = 0

    @staticmethod
    def sim(n_clients: int) -> "Topology":
        return Topology(kind="sim", n_clients=n_clients)


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


# ---------------------------------------------------------------------------
# Uplink pipeline + static ledger terms
# ---------------------------------------------------------------------------

def check_fl(fl: FLConfig) -> None:
    """Reject the reference's knobs this slice does not run."""
    if fl.algorithm not in _ALGORITHMS:
        raise not_ported(f"algorithm={fl.algorithm!r}", "repro.core.engine")
    if fl.downlink_compressor not in ("none", "", None):
        raise not_ported(f"downlink_compressor={fl.downlink_compressor!r}",
                         "repro.core.engine (make_dispatch.downlink)")
    if fl.cmfl_threshold > 0:
        raise not_ported("CMFL (cmfl_threshold > 0)", "repro.core.engine")
    if fl.dgc_momentum > 0 or fl.dgc_warmup_rounds > 0:
        raise not_ported("DGC momentum correction", "repro.compress.pipeline")
    if fl.secure_agg or fl.dp_sigma > 0 or fl.dp_clip > 0:
        raise not_ported("secure aggregation / DP noise",
                         "repro.compress.secure_agg")
    if fl.telemetry:
        raise not_ported("telemetry", "repro.obs.telemetry")
    default = FLConfig()
    if any(getattr(fl, f) != getattr(default, f) for f in _SCENARIO_FIELDS):
        raise not_ported("scenario client dynamics", "repro.core.scenario")


def uplink_pipeline(fl: FLConfig):
    """The uplink CommPipeline from config: the spec plus error feedback
    for biased pipelines."""
    check_fl(fl)
    up = make_compressor(fl.uplink_compressor, fraction=fl.topk_fraction,
                         block=fl.qsgd_block, rows=fl.sketch_rows,
                         cols=fl.sketch_cols, backend=fl.backend,
                         wire_format=fl.wire_format)
    if up.biased and fl.error_feedback:
        up = error_feedback(up)
    return up


def ledger_terms(model: Model, fl: FLConfig):
    """Static per-selected-client byte terms for the round ledger."""
    up = uplink_pipeline(fl)
    down = make_compressor(fl.downlink_compressor, block=fl.qsgd_block,
                           backend=fl.backend, wire_format=fl.wire_format)
    sizes = model.param_sizes()
    t = {
        "up_wire": sum(up.wire_bits(n) for n in sizes) / 8.0,
        "up_entropy": sum(up.entropy_bits(n) for n in sizes) / 8.0,
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


def _client_update(model: Model, fl: FLConfig, params, batch_c, chunk):
    """One client's local training.  Returns (delta, mean_loss,
    first_loss).  E = 1 fedavg/fedsgd takes the reference's fast path:
    ``-lr * g`` in the parameter dtype, then cast to the delta dtype."""
    E, lr = fl.local_steps, fl.local_lr
    ddt = torch.bfloat16 if fl.delta_dtype == "bf16" else torch.float32
    fast = (E == 1 and fl.algorithm in ("fedavg", "fedsgd")
            and fl.fedprox_mu == 0.0)
    if fast:
        loss, g = _value_and_grad(model, params, batch_c, chunk)
        delta = {n: (g_ * scalar_like(-lr, g_)).to(ddt)
                 for n, g_ in g.items()}
        return delta, loss, loss

    prox = fl.algorithm == "fedprox" and fl.fedprox_mu
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
            step[n] = (a.to(torch.float32)
                       - g_.to(torch.float32) * lr).to(a.dtype)
        p_c = step
    delta = {n: (p_c[n].to(torch.float32) - p.to(torch.float32)).to(ddt)
             for n, p in params.items()}
    return delta, torch.stack(losses).mean(), losses[0]


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
    """One dispatch generation: ``local_update(params, model_batch) ->
    (deltas, losses, first_losses)``, ``wire_rows(deltas, comm_state,
    k_up) -> (decoded rows, new comm_state)`` and ``aggregate_rows(rows,
    w_num, wsum)``.  Deltas and rows are ``{leaf name: (C, *leaf shape)}``
    in leaf order."""
    local_update: Callable
    wire_rows: Callable
    aggregate_rows: Callable

    @staticmethod
    def model_batch(batch) -> dict:
        """Model inputs only (FL metadata keys stay out of the loss)."""
        return {k: v for k, v in batch.items()
                if k not in ("sizes", "resources", "ids")}


def make_dispatch(model: Model, fl: FLConfig, up, down, C: int,
                  chunk: int) -> Dispatch:
    stateful = up.stateful
    if not down.is_identity:
        raise not_ported("a compressed downlink",
                         "repro.core.engine (make_dispatch.downlink)")

    def local_update(params, model_batch):
        ddt = torch.bfloat16 if fl.delta_dtype == "bf16" else torch.float32
        deltas = {n: torch.empty((C,) + tuple(p.shape), dtype=ddt,
                                 device=p.device) for n, p in params.items()}
        losses, first = [], []
        for c in range(C):
            b = {k: v[c] for k, v in model_batch.items()}
            d, loss, first_loss = _client_update(model, fl, params, b, chunk)
            for n, v in d.items():
                deltas[n][c] = v
            del d
            losses.append(loss)
            first.append(first_loss)
        return deltas, torch.stack(losses), torch.stack(first)

    def wire_rows(deltas, comm_state, k_up):
        rngs_up = k_up.split(C)
        dec_rows, st_rows = {}, []
        for li, (name, leaf) in enumerate(deltas.items()):
            flat = leaf.reshape(C, -1).to(torch.float32)
            n = flat.shape[1]
            dec = torch.empty_like(flat)
            new_states = []
            for c in range(C):
                r = rngs_up[c].fold_in(li)
                st = (_index_state(comm_state[li], c) if stateful
                      else up.init((n,), device=flat.device))
                payload, nst = up.encode(st, r, flat[c])
                dec[c] = up.decode(payload, n)
                new_states.append(nst)
            if stateful:
                st_rows.append(_stack_states(new_states))
            dec_rows[name] = dec.reshape(leaf.shape)
        return dec_rows, (tuple(st_rows) if stateful else None)

    def aggregate_rows(rows, w_num, wsum):
        return {n: ((w_num[:, None] * leaf.reshape(C, -1)).sum(0) / wsum)
                .reshape(leaf.shape[1:]) for n, leaf in rows.items()}

    return Dispatch(local_update=local_update, wire_rows=wire_rows,
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
                          C: int) -> RoundProgram:

    def hop_rng(ctx):
        # the reference's split: (local, downlink, selection, uplink, next);
        # this slice draws only from the uplink key
        _, _, _, r_up, r_next = ctx["state"].rng.split(5)
        ctx.update(r_up=r_up, r_next=r_next)
        return ctx

    def hop_local_update(ctx):
        deltas, losses, first_losses = dispatch.local_update(
            ctx["state"].params, Dispatch.model_batch(ctx["batch"]))
        ctx.update(deltas=deltas, losses=losses, first_losses=first_losses)
        return ctx

    def hop_select(ctx):
        sizes = ctx["batch"].get("sizes")
        if sizes is None:
            sizes = torch.ones((C,), dtype=torch.float32,
                               device=ctx["losses"].device)
        ctx["weights"] = sel.select(fl, sizes)
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
            control=None, client_controls=None,
            comm_state=ctx["new_comm"], rng=ctx["r_next"],
            round=st.round + 1, prev_delta=None)
        return ctx

    hops = (("rng", hop_rng), ("local_update", hop_local_update),
            ("select", hop_select), ("wire", hop_wire),
            ("server_opt", hop_server_opt), ("ledger", hop_ledger),
            ("finalize", hop_finalize))
    return RoundProgram(hops=hops)


def _build_sim(model: Model, fl: FLConfig, topo: Topology, chunk: int,
               device) -> RoundEngine:
    C = topo.n_clients
    terms, up, down = ledger_terms(model, fl)
    server_opt.check(fl.server_opt)
    dispatch = make_dispatch(model, fl, up, down, C, chunk)
    program = _build_server_program(fl, terms, dispatch, C)

    def state_from_params(params):
        return FLState(
            params=params,
            server_opt_state=server_opt.init_state(fl.server_opt, params),
            control=None, client_controls=None,
            comm_state=(comm_state_init(up, params, C, device)
                        if up.stateful else None),
            rng=PRNGKey(fl.seed), round=0)

    def init_fn(seed=0):
        return state_from_params(model.init(seed, device))

    return RoundEngine(topology=topo, round_fn=program, init_fn=init_fn,
                       state_from_params=state_from_params, n_clients=C,
                       terms=terms, device=device)


def make_round_engine(model: Model, fl: FLConfig, topology: Topology,
                      chunk: int = 512, device=None) -> RoundEngine:
    """Build the round executor for one (model, fl, topology) binding on
    ``device`` (``cuda`` unless ``device="cpu"`` is asked for)."""
    dev = resolve_device(device)
    if topology.kind != "sim":
        raise not_ported(f"topology {topology.kind!r}", "repro.core.engine")
    if topology.n_clients <= 0:
        raise ValueError("sim topology needs n_clients > 0")
    return _build_sim(model, fl, topology, chunk, dev)


def run_rounds(engine: RoundEngine, state, data_fn, n: int):
    """Run ``n`` rounds; ``data_fn(round_idx) -> batch``.  Returns
    ``(final_state, metrics)`` with every metric stacked over a leading
    (n,) round dim (the ledger as a CommLedger of (n,) tensors)."""
    if n <= 0:
        return state, None
    rows = []
    for _ in range(n):
        state, m = engine.round_fn(state, data_fn(state.round))
        rows.append(m)
    metrics = {k: torch.stack([m[k] for m in rows])
               for k in rows[0] if k != "ledger"}
    led = {k: torch.stack([m["ledger"].fields()[k] for m in rows])
           for k in rows[0]["ledger"].fields()}
    metrics["ledger"] = CommLedger(**led)
    return state, metrics
