"""The round engine (port of ``repro.core.engine``): the sim, async, star,
hier and gossip topologies.

One FL round is a :class:`RoundProgram`, an ordered sequence of hops over a
plain dict context, as in the reference (the ``sim`` topology):

    rng -> [cohort] -> downlink -> [dane_gradient] -> local_update
        -> select -> [scenario_dropout] -> [cmfl] -> wire -> [control]
        -> server_opt -> ledger -> [telemetry] -> finalize

built on the shared dispatch body (:func:`make_dispatch`: ``downlink``,
``local_update`` / ``client_updates``, ``global_gradient``,
``wire_rows``, ``aggregate_rows``).  The bracketed hops are there only
when their feature is on: a population's cohort, FedDANE's gradient
round, the scenario's mid-round dropout, CMFL's relevance filter,
SCAFFOLD's control variates and the flight recorder's ``RoundStats``
(``FLConfig.telemetry``: :mod:`repro_torch.obs.telemetry`, a hop that
reads the round's values and writes none).  The reference's
``vmap`` over clients is a Python loop over the client dim here, and its
``lax.scan`` over rounds is the Python loop of :func:`run_rounds`.

Random keys follow the reference's structure exactly: ``state.rng``
splits 5 ways per round (local, downlink, selection, uplink, next), the
uplink key splits per client, each client's key is folded with the leaf
index, and the chain folds in its stage index; the downlink roundtrips
every leaf with the same downlink key — so a test that injects
``jax.random``-backed keys gets the reference's QSGD uniforms.

``sim`` runs the fedavg, fedsgd, fedprox, scaffold and feddane client
algorithms, CMFL (``cmfl_threshold``), EF or DGC uplinks, a downlink
compressor roundtripped per leaf (e.g. ``lfl8``), the ``all``, ``random``,
``power_of_choice`` and ``multi_criteria`` selection policies and the
fedavg / fedavgm / fedadam / fedyogi server step, densely or over a
streaming :class:`~repro_torch.core.population.ClientPopulation`
(``population=``: a ``cohort`` hop after ``rng``, the dispatch width set
to the cohort, and the per-client pipeline state in a ``ResidualStore``).
``async`` (:mod:`repro_torch.core.async_engine`) is the virtual-clock
FedBuff / FedAsync event engine on the same dispatch body.  Both take the
privacy wire (``secagg`` / ``dpnoise`` in the spec or ``FLConfig
.secure_agg`` / ``dp_sigma`` / ``dp_clip``: the mask context is injected
per client and leaf in ``wire_rows``) and the scenario's client dynamics
(:mod:`repro_torch.core.scenario`: availability traces, mid-round
dropout, per-client step budgets).

``star``, ``hier`` and ``gossip`` run on a :class:`~repro_torch.launch
.mesh.Mesh`: each client is one rank of a ``torch.distributed`` group and
every round's transport is a real collective whose operand is the
pipeline's encoded payload (:mod:`repro_torch.core.aggregation`).  The
star runs the sim's hop list with three hops of its own (the rank's local
update with the losses gathered, the collective wire, SCAFFOLD's control
over a dense all-reduce), and over a population the sim's cohort and
availability hops with a wire of its own (each rank a replica of the
residual store, the advanced rows all-gathered); hier has the edge hop
within each pod every round and the cloud hop across pods every
``sync_every`` rounds; gossip mixes each node's payload into its graph
neighbours point to point.
Every other knob raises ``NotImplementedError`` naming the reference
module that has it.  The client and server algorithms' state runs leaf by
leaf: no hop builds a concatenation of the model or of C clients' rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.compress.api import Identity, make_compressor
from repro_torch.compress.pipeline import error_feedback, momentum_correction
from repro_torch.compress.secure_agg import (DPNoise, MASK_TAG, SecAgg,
                                             bind_n_leaves, has_mask_ctx,
                                             inject_mask_ctx)
from repro_torch.core import aggregation
from repro_torch.core import scenario as scn_mod
from repro_torch.core import selection as sel
from repro_torch.core import server_opt
from repro_torch.core.aggregation import (comm_state_init,  # noqa: F401
                                          index_state as _index_state,
                                          stack_states as _stack_states)
from repro_torch.core.rng import PRNGKey
from repro_torch.core.types import CommLedger, FLConfig, FLState
from repro_torch.data.pipeline import capability_latency
from repro_torch.device import not_ported, resolve_device
from repro_torch.models import sharding
from repro_torch.models.layers import scalar_like
from repro_torch.models.model import Model
from repro_torch.obs import telemetry as obs_tel

_ALGORITHMS = ("fedavg", "fedsgd", "fedprox", "scaffold", "feddane")


@dataclasses.dataclass(frozen=True)
class Topology:
    """Which shape the round's transport hops take.

    ``graph`` (gossip) is a tuple of ``(edge, mix_weight)`` entries where
    ``edge`` is either a ring offset (int: every node sends to ``(i + off)
    % C``) or an explicit permutation tuple of length C (fixed points
    ``sigma[i] == i`` do not send).  The per-node self weight is whatever
    the incoming edge weights leave over; building the engine checks that the
    mixing matrix is doubly stochastic.  :func:`expander_graph` and
    :func:`erdos_renyi_graph` (or the ``Topology.gossip_*`` constructors)
    build non-ring graphs."""
    kind: str                          # star | hier | gossip | sim | async
    n_clients: int = 0                 # sim / async only
    sync_every: int = 4                # hier only (cloud hop period)
    graph: tuple = ((1, 0.25), (-1, 0.25))   # gossip only
    client_axis: str = ""              # star only ("" = from ArchConfig)
    # async only; the sentinels (0 / None / "") fall back to the FLConfig
    # fields at engine build time
    buffer_size: int = 0
    staleness_alpha: float = None
    latency_profile: str = ""
    flush_deadline: float = None

    @staticmethod
    def star(client_axis: str = "") -> "Topology":
        return Topology(kind="star", client_axis=client_axis)

    @staticmethod
    def hier(sync_every: int = 4) -> "Topology":
        return Topology(kind="hier", sync_every=sync_every)

    @staticmethod
    def gossip(graph=None) -> "Topology":
        return Topology(kind="gossip", graph=tuple(graph) if graph
                        else ((1, 0.25), (-1, 0.25)))

    @staticmethod
    def gossip_expander(n_clients: int, degree: int = 4) -> "Topology":
        return Topology.gossip(expander_graph(n_clients, degree))

    @staticmethod
    def gossip_er(n_clients: int, p: float = 0.5, seed: int = 0) -> "Topology":
        return Topology.gossip(erdos_renyi_graph(n_clients, p, seed))

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


# ---------------------------------------------------------------------------
# Gossip graph constructors + the doubly-stochastic contract
# ---------------------------------------------------------------------------

def _graph_edges(spec, C: int):
    """Directed (src, dst) pairs for one graph entry: a ring offset (int) or
    an explicit permutation tuple (fixed points do not send)."""
    if isinstance(spec, (int, np.integer)):
        return [(i, (i + int(spec)) % C) for i in range(C)]
    sigma = tuple(int(s) for s in spec)
    if len(sigma) != C or sorted(sigma) != list(range(C)):
        raise ValueError(f"graph entry {spec!r} is not a permutation of "
                         f"range({C})")
    return [(i, sigma[i]) for i in range(C) if sigma[i] != i]


def mixing_matrix(graph, C: int) -> np.ndarray:
    """The dense (C, C) gossip mixing matrix W (row i mixes *into* node i):
    W[dst, src] += w per edge, and each node keeps whatever its incoming
    edge weights leave over (per-node self weight)."""
    W = np.zeros((C, C))
    for spec, w in graph:
        for src, dst in _graph_edges(spec, C):
            W[dst, src] += float(w)
    np.fill_diagonal(W, np.diag(W) + 1.0 - W.sum(axis=1))
    return W


def check_doubly_stochastic(W: np.ndarray, atol: float = 1e-6) -> None:
    """Gossip averaging preserves the model mean and contracts to consensus
    iff W is doubly stochastic with non-negative entries — checked at engine
    build time for every graph."""
    if W.min() < -atol:
        raise ValueError(f"mixing matrix has negative entries "
                         f"(min {W.min():.4f}): edge weights too large — "
                         f"a node's incoming weights must sum to <= 1")
    for axis, name in ((1, "row"), (0, "column")):
        s = W.sum(axis=axis)
        if not np.allclose(s, 1.0, atol=atol):
            raise ValueError(f"mixing matrix {name} sums deviate from 1 "
                             f"(max |err| {np.abs(s - 1).max():.4f}) — "
                             f"graph is not doubly stochastic")


def expander_graph(n: int, degree: int = 4) -> tuple:
    """Circulant power-of-two expander: offsets ±1, ±2, ±4, ... with uniform
    weights 1/(E+1).  Each offset is a permutation, so the mix is a convex
    combination of permutation matrices — doubly stochastic by
    construction."""
    offs = []
    j = 0
    while len(offs) < degree and (1 << j) <= n // 2:
        o = 1 << j
        offs.append(o)
        if len(offs) < degree and (n - o) % n not in offs and n - o != o:
            offs.append(n - o)        # the symmetric (negative) offset
        j += 1
    w = 1.0 / (len(offs) + 1)
    return tuple((o, w) for o in offs)


def erdos_renyi_graph(n: int, p: float = 0.5, seed: int = 0) -> tuple:
    """Erdős–Rényi G(n, p) gossip graph: the undirected edge set sampled,
    greedily edge-coloured into matchings (each an involution permutation),
    uniform edge weight 1/(max_degree + 1) so every node's self weight stays
    non-negative and W is symmetric doubly stochastic."""
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((n, n)) < p, 1)
    edges = list(zip(*np.nonzero(upper)))
    deg = np.zeros(n, int)
    for i, j in edges:
        deg[i] += 1
        deg[j] += 1
    if not edges:
        raise ValueError(f"G({n}, {p}) sample (seed={seed}) has no edges — "
                         f"raise p or change the seed")
    w = 1.0 / (deg.max() + 1)
    used: list = [set() for _ in range(n)]
    matchings: list = []
    for i, j in edges:
        c = 0
        while c in used[i] or c in used[j]:
            c += 1
        used[i].add(c)
        used[j].add(c)
        while len(matchings) <= c:
            matchings.append(list(range(n)))
        matchings[c][i], matchings[c][j] = j, i
    return tuple((tuple(m), w) for m in matchings)


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
    """A built round executor for one (model, fl, topology) binding.  On a
    mesh (star, hier, gossip) it is this rank's: ``local_batch`` takes a
    round's global batch (the reference's layout) to the rank's part, and
    ``programs`` holds hier's separate edge and cloud programs."""
    topology: Topology
    round_fn: RoundProgram             # (state, batch) -> (state, metrics)
    init_fn: Any                       # seed -> FLState
    state_from_params: Any             # params dict -> FLState
    n_clients: int
    terms: dict
    device: torch.device
    aux: dict = dataclasses.field(default_factory=dict)
    eval_every: int = 1                # run_rounds' metrics_fn cadence
    mesh: Any = None
    local_batch: Optional[Callable] = None
    programs: dict = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Uplink pipeline + static ledger terms
# ---------------------------------------------------------------------------

def check_fl(fl: FLConfig) -> None:
    """Reject the reference's knobs this slice does not run."""
    if fl.algorithm not in _ALGORITHMS:
        raise not_ported(f"algorithm={fl.algorithm!r}", "repro.core.engine")


def _make_uplink(fl: FLConfig, fraction: float):
    return make_compressor(fl.uplink_compressor, fraction=fraction,
                           block=fl.qsgd_block, rows=fl.sketch_rows,
                           cols=fl.sketch_cols, backend=fl.backend,
                           wire_format=fl.wire_format)


def uplink_pipeline(fl: FLConfig):
    """The uplink CommPipeline from config: the spec, the privacy knobs
    (:func:`_apply_privacy`), then the stateful correction wrapper — DGC
    momentum correction if ``dgc_momentum`` is set (with the warm-up
    sparsity schedule when ``dgc_warmup_rounds`` > 0), else error feedback
    for biased pipelines."""
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
    up = _apply_privacy(fl, up)
    if fl.dgc_momentum > 0.0 and not up.is_identity:
        up = momentum_correction(up, fl.dgc_momentum, warmup_rounds=warmup,
                                 final_fraction=fl.topk_fraction)
    elif up.biased and fl.error_feedback:
        up = error_feedback(up)
    return up


def _apply_privacy(fl: FLConfig, up):
    """The FLConfig privacy knobs as spec-suffix equivalents: dpnoise at
    the wire boundary first, secagg masking outermost; EF / DGC wrap
    outside both, so residuals come from the unmasked decode."""
    if fl.dp_sigma > 0.0 or fl.dp_clip > 0.0:
        clip = fl.dp_clip if fl.dp_clip > 0.0 else float("inf")
        up = DPNoise(up, fl.dp_sigma, clip)
    if fl.secure_agg and not up.is_identity:
        up = SecAgg(up)   # raises with the carrier rule for float pipelines
    return up


def ledger_terms(model: Model, fl: FLConfig):
    """Static per-selected-client byte terms for the round ledger."""
    up = uplink_pipeline(fl)
    down = make_compressor(fl.downlink_compressor, block=fl.qsgd_block,
                           backend=fl.backend, wire_format=fl.wire_format)
    sizes = model.param_sizes()
    # dpnoise splits its joint L2 clip budget across this model's leaves
    bind_n_leaves(up, len(sizes))
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


def _telemetry_spec(fl: FLConfig, up, down, sizes):
    """The static per-stage byte spec when the flight recorder is on, else
    None; scaled like ``ledger_terms``: SCAFFOLD and FedDANE bill the
    uplink twice."""
    if not fl.telemetry:
        return None
    scaff = 2.0 if fl.algorithm in ("scaffold", "feddane") else 1.0
    return obs_tel.telemetry_spec(up, down, sizes, up_scale=scaff)


def _make_ledger(terms: dict, n_sel) -> CommLedger:
    """``n_sel * term`` in float32, as the reference's f32 scalar times a
    weakly-typed Python float; ``dp_rho`` (the zCDP spent) only when the
    uplink has noise."""
    f32 = lambda v: n_sel * torch.tensor(v, dtype=torch.float32,
                                         device=n_sel.device)
    return CommLedger(uplink_wire=f32(terms["up_wire"]),
                      uplink_entropy=f32(terms["up_entropy"]),
                      downlink_wire=f32(terms["down_wire"]),
                      uplink_dense=f32(terms["dense"]),
                      downlink_dense=f32(terms["dense"]),
                      dp_rho=(f32(terms["dp_rho"]) if terms.get("dp_rho")
                              else None))


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
                   control=None, c_i=None, global_grad=None, n_steps=None):
    """One client's local training.  Returns (delta, mean_loss,
    first_loss, new_c_i).  E = 1 fedavg/fedsgd takes the reference's fast
    path: ``-lr * g`` in the parameter dtype, then cast to the delta dtype.

    ``n_steps`` (the scenario's step budget, an int in [1, E]) runs the
    first ``n_steps`` of the E local steps: the reference's later steps
    keep the params, so stopping there is the same arithmetic, and the
    mean loss is the sum of the E losses (0 for the skipped steps) over
    ``n_steps``.

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
    for _ in range(E if n_steps is None else int(n_steps)):
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
    if n_steps is None:
        mean_loss = torch.stack(losses).mean()
    else:
        pad = [torch.zeros_like(losses[0])] * (E - len(losses))
        mean_loss = torch.stack(losses + pad).sum() / scalar_like(
            float(len(losses)), losses[0])
    return delta, mean_loss, losses[0], new_c_i


# ---------------------------------------------------------------------------
# The shared dispatch body
# ---------------------------------------------------------------------------

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
    generation, the async engine's: downlink, local update, wire.

    ``epoch_steps(batch) -> (n_steps, scale)`` (the scenario's per-client
    step budgets, C-led) is set only when the scenario's epoch scaling is
    on; the local-update stages then take ``n_steps=``.  With a SecAgg
    stage in the uplink, ``wire_rows`` injects each client's mask context:
    the key ``k_up.fold_in(MASK_TAG).fold_in(leaf)``, the client's lane
    (its index among the C, also for a subset) and the cohort C."""
    downlink: Callable
    local_update: Callable
    client_updates: Callable
    global_gradient: Callable
    wire_rows: Callable
    aggregate_rows: Callable
    epoch_steps: Optional[Callable] = None

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
        if self.epoch_steps is not None:
            n_steps, _ = self.epoch_steps(batch)
            deltas, losses, _ = self.local_update(
                params, self.model_batch(batch), clients=clients,
                n_steps=n_steps)
        else:
            deltas, losses, _ = self.local_update(
                params, self.model_batch(batch), clients=clients)
        rows, new_comm = self.wire_rows(deltas, comm_state, k_up,
                                        clients=clients)
        return rows, losses, new_comm


def make_dispatch(model: Model, fl: FLConfig, up, down, C: int,
                  chunk: int, scenario=None) -> Dispatch:
    """The shared dispatch body over ``C`` clients; ``scenario`` with
    ``epoch_scale > 0`` attaches the per-client step budgets."""
    stateful = up.stateful
    masked = has_mask_ctx(up)

    def downlink(params, k_down):
        # every leaf roundtrips with the same key, as the reference's
        # jax.tree.map over the params does
        if down.is_identity:
            return params
        return {n: down.roundtrip(k_down, p.reshape(-1).to(torch.float32))
                .reshape(p.shape).to(p.dtype) for n, p in params.items()}

    def client_updates(params, model_batch, control=None,
                       client_controls=None, global_grad=None,
                       clients=None, n_steps=None):
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
                model, fl, params, b, chunk, control, c_i, global_grad,
                n_steps=None if n_steps is None else int(n_steps[c]))
            for n, v in d.items():
                deltas[n][j] = v
            if new_ci is not None:
                for n, v in nci.items():
                    new_ci[n][j] = v
            del d, nci
            losses.append(loss)
            first.append(first_loss)
        return deltas, torch.stack(losses), torch.stack(first), new_ci

    def local_update(params, model_batch, clients=None, n_steps=None):
        return client_updates(params, model_batch, clients=clients,
                              n_steps=n_steps)[:3]

    epoch_steps = None
    if scenario is not None and scenario.epoch_scale > 0.0:
        if fl.local_steps <= 1:
            raise ValueError(
                "scenario epoch scaling needs local_steps > 1 — there is "
                "no per-client budget to truncate at a single local step")
        if fl.algorithm not in ("fedavg", "fedsgd", "fedprox"):
            raise ValueError(
                f"scenario epoch scaling truncates the local scan per "
                f"client — the {fl.algorithm!r} control-variate bookkeeping "
                f"assumes a fixed step count; use fedavg/fedsgd/fedprox")

        def epoch_steps(batch):
            res = batch.get("resources")
            if res is None:
                res = torch.ones((C, 4), dtype=torch.float32,
                                 device=batch["tokens"].device)
            return scn_mod.epoch_steps(scenario, fl.local_steps, res)

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
            # the secagg context of this hop: a round- and leaf-shared
            # mask key, the client's lane as ring index, cohort C
            mkey = k_up.fold_in(MASK_TAG).fold_in(li) if masked else None
            for j, c in enumerate(cs):
                r = rngs_up[c].fold_in(li)
                st = (_index_state(comm_state[li], c) if stateful
                      else up.init((n,), device=flat.device))
                if masked:
                    st = inject_mask_ctx(st, mkey, c, C)
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
                    aggregate_rows=aggregate_rows, epoch_steps=epoch_steps)


# ---------------------------------------------------------------------------
# The server-topology round program
# ---------------------------------------------------------------------------

def _fl_scenario(fl: FLConfig):
    """The FLConfig's scenario, or None when every knob is at its default:
    the builders then add no scenario hop at all."""
    scn = scn_mod.Scenario.from_fl(fl)
    return scn if scn.enabled else None


def _attach_scenario(population, scenario):
    """Give the population the scenario's availability trace (its mask and
    the selection hop then share one schedule); the population keeps its
    own rate.  A no-op without a scenario or when one is attached."""
    if (scenario is None or population is None
            or population.scenario is not None):
        return population
    return dataclasses.replace(population, scenario=scenario)


@dataclasses.dataclass
class _StarWire:
    """The star's own hops' transport (:func:`_build_star`): this rank's
    client index of C, the collective aggregator, the dense one for
    SCAFFOLD's controls, the gather of a (1,) per-client value into the
    (C,) one every rank sees, the gather of this rank's (1,)-led
    pipeline rows into the (C,)-led whole rows (a population's ``store``
    hop), and this rank's block of a (1,)-led whole row (the identity
    without a model axis)."""
    idx: int
    aggregate: Callable            # (deltas, weights, rng, comm) -> agg, comm
    aggregate_dense: Optional[Callable]   # (tree, weights, rng) -> agg
    gather: Callable               # (1,) -> (C,)
    gather_rows: Callable          # (1,)-led rows -> (C,)-led rows
    block_rows: Callable           # (1,)-led whole rows -> this rank's


def _build_server_program(fl: FLConfig, terms: dict, dispatch: Dispatch,
                          C: int, population=None, store=None,
                          device=None, scenario=None,
                          tele=None, star: _StarWire = None) -> RoundProgram:
    """The server-topology round: the sim's hops, or with ``star`` the same
    hop list with the star's local update (this rank's client, its losses
    gathered), wire (the collective aggregator) and SCAFFOLD control (a
    dense all-reduce); FedDANE's gradient round and CMFL stay on the sim,
    as in the reference."""
    simulator = star is None

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
        kw = {}
        if dispatch.epoch_steps is not None:
            # the scenario's per-client step budgets from the FedMCCS
            # capability profile; the scale feeds the telemetry histogram
            kw["n_steps"], ctx["scn_escale"] = dispatch.epoch_steps(
                ctx["batch"])
        deltas, losses, first_losses, new_ci = dispatch.client_updates(
            ctx.pop("params"), Dispatch.model_batch(ctx["batch"]),
            control=st.control, client_controls=st.client_controls,
            global_grad=ctx.pop("global_grad", None), **kw)
        ctx.update(deltas=deltas, losses=losses, first_losses=first_losses,
                   new_ci=new_ci)
        return ctx

    def hop_star_local_update(ctx):
        # the rank's own client (the dispatch is built for one), from its
        # slice of the batch; the (C,) losses every rank needs for the
        # selection and the metrics are gathered
        st = ctx["state"]
        kw = {}
        if dispatch.epoch_steps is not None:
            n_steps, ctx["scn_escale"] = scn_mod.epoch_steps(
                scenario, fl.local_steps, _resources(ctx))
            kw["n_steps"] = n_steps[star.idx:star.idx + 1]
        deltas, losses, first_losses, new_ci = dispatch.client_updates(
            ctx.pop("params"), Dispatch.model_batch(ctx["batch"]),
            control=st.control, client_controls=st.client_controls, **kw)
        ctx.update(deltas=deltas, losses=star.gather(losses),
                   first_losses=star.gather(first_losses), new_ci=new_ci)
        return ctx

    def hop_cohort(ctx):
        # this round's client ids, pure in (population.seed, round): the
        # data pipeline (cohort_data_fn) computes the same ids
        ctx["ids"] = population.cohort_ids(ctx["state"].round, device)
        return ctx

    def _resources(ctx):
        res = ctx["batch"].get("resources")
        if res is None:
            res = torch.ones((C, 4), dtype=torch.float32, device=device)
        return res

    def _select(ctx, availability=None):
        batch, dev = ctx["batch"], ctx["losses"].device
        sizes = batch.get("sizes")
        if sizes is None:
            sizes = torch.ones((C,), dtype=torch.float32, device=dev)
        ctx["weights"] = sel.select(fl, ctx["r_sel"],
                                    losses=ctx["first_losses"],
                                    resources=_resources(ctx), sizes=sizes,
                                    availability=availability)
        if availability is not None:
            ctx["avail"] = availability
        return ctx

    def hop_select(ctx):
        return _select(ctx)

    def hop_select_available(ctx):
        # the population's per-(id, round) availability draw (its rate,
        # the attached scenario's trace) zero-weights the sampled clients
        # that are offline this round
        return _select(ctx, population.availability_mask(ctx["state"].round,
                                                         ctx["ids"]))

    def hop_select_trace(ctx):
        # the dense path: the scenario's trace over the static client
        # slots (the ids are the lanes)
        return _select(ctx, scn_mod.availability_mask(
            scenario, scenario.seed, scenario.availability,
            ctx["state"].round,
            torch.arange(C, dtype=torch.int32, device=device)))

    def hop_scenario_dropout(ctx):
        # mid-round dropout: a survival draw per client against the
        # round's elapsed virtual time (the capability latency); a dropped
        # client is a zero-weight row (under secagg its masked codes still
        # arrive and unmask per client) and is billed by the ledger
        ids = ctx.get("ids")
        if ids is None:
            ids = torch.arange(C, dtype=torch.int32, device=device)
        survive = scn_mod.survival_mask(scenario, ctx["state"].round, ids,
                                        capability_latency(_resources(ctx)))
        weights = ctx["weights"]
        selected_before = (weights > 0).to(torch.float32)
        ctx["weights"] = weights * survive
        ctx["scn_dropped"] = (selected_before * (1.0 - survive)).sum()
        return ctx

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

    def hop_star_wire(ctx):
        # encode -> collective -> decode -> aggregate; this rank's pipeline
        # row rides along
        weights = ctx["weights"]
        agg, new_comm = star.aggregate(ctx.pop("deltas"), weights,
                                       ctx["r_up"], ctx["state"].comm_state)
        ctx.update(agg=agg, new_comm=new_comm,
                   n_sel=(weights > 0).sum().to(torch.float32))
        return ctx

    def hop_star_population_wire(ctx):
        # the star over a population (reference _star_population_wire):
        # every rank holds a replica of the store and gathers the whole
        # cohort's rows from it (so every replica's clock, slots and tail
        # advance alike), its own client's row (cohort slot = client
        # index) goes through the collective aggregator, and the advanced
        # rows cross the client group so that every replica scatters the
        # same C rows
        weights, ids = ctx["weights"], ctx["ids"]
        rows_in, st = store.gather(ctx["state"].comm_state, ids)
        agg, row = star.aggregate(
            ctx.pop("deltas"), weights, ctx["r_up"], star.block_rows(
                _index_state(rows_in, slice(star.idx, star.idx + 1))))
        ctx.update(agg=agg, new_comm=store.scatter(st, ids,
                                                   star.gather_rows(row)),
                   n_sel=(weights > 0).sum().to(torch.float32))
        return ctx

    def hop_star_control(ctx):
        # SCAFFOLD on the star: this rank's c_i row (kept when unselected),
        # the weighted mean of the rows' changes over a dense all-reduce
        st, weights = ctx["state"], ctx["weights"]
        keep = not bool(weights[star.idx] > 0)
        new_ci, dci = {}, {}
        for n, new in ctx["new_ci"].items():
            old = st.client_controls[n]
            new_ci[n] = old.clone() if keep else new
            dci[n] = new_ci[n] - old
        agg_dc = star.aggregate_dense(dci, weights, ctx["r_up"])
        ctx.update(new_ci=new_ci, control={
            n: st.control[n] + (ctx["n_sel"] / C) * agg_dc[n]
            for n in new_ci})
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
        billed = ctx["n_sel"]
        if dropout:
            # a client dropped mid-round already shipped its payload (under
            # secagg its masked codes must arrive for the masks to
            # cancel), so the bill is the pre-dropout selection
            billed = billed + ctx["scn_dropped"]
        ctx["billed"] = billed
        ctx["ledger"] = _make_ledger(terms, billed)
        return ctx

    def hop_telemetry(ctx):
        # the flight recorder: reads values the round already computed and
        # the static byte tables only, so params, pipeline state and ledger
        # are those of the program without this hop; no host sync
        st = ctx["state"]
        ctrs = (store.stats(st.comm_state, ctx["ids"])
                if store is not None else None)
        if population is not None:
            available = population.availability_count(st.round, ctx["ids"])
        elif "avail" in ctx:
            available = ctx["avail"].sum()
        else:
            available = torch.tensor(float(C), dtype=torch.float32,
                                     device=device)
        ctx["round_stats"] = obs_tel.round_stats(
            tele, ctx["ledger"], up_unit=ctx["billed"], store=ctrs,
            selected=ctx["n_sel"], available=available,
            avail_duty=available / torch.tensor(
                float(C), dtype=torch.float32, device=available.device),
            dropped=ctx.get("scn_dropped"),
            epoch_scale=ctx.get("scn_escale"))
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
        if tele is not None:
            ctx["metrics"]["round_stats"] = ctx["round_stats"]
        ctx["new_state"] = FLState(
            params=ctx["new_params"], server_opt_state=ctx["new_sos"],
            control=ctx.get("control"), client_controls=ctx.get("new_ci"),
            comm_state=ctx["new_comm"], rng=ctx["r_next"],
            round=st.round + 1,
            prev_delta=(ctx["agg"] if simulator and fl.cmfl_threshold > 0
                        else None))
        return ctx

    if population is not None and population.availability_active:
        select = hop_select_available
    elif (population is None and scenario is not None
          and scenario.availability_on):
        select = hop_select_trace
    else:
        select = hop_select
    dropout = scenario is not None and scenario.dropout > 0.0
    hops = [("rng", hop_rng)]
    if population is not None:
        hops.append(("cohort", hop_cohort))
    hops.append(("downlink", hop_downlink))
    if simulator and fl.algorithm == "feddane":
        hops.append(("dane_gradient", hop_dane_gradient))
    hops += [("local_update", hop_local_update if simulator
              else hop_star_local_update), ("select", select)]
    if dropout:
        hops.append(("scenario_dropout", hop_scenario_dropout))
    if simulator and fl.cmfl_threshold > 0:
        hops.append(("cmfl", hop_cmfl))
    # a stateless pipeline keeps no per-client rows: no store
    if simulator:
        wire = hop_population_wire if store is not None else hop_wire
    else:
        wire = hop_star_population_wire if store is not None \
            else hop_star_wire
    hops.append(("wire", wire))
    if fl.algorithm == "scaffold":
        hops.append(("control", hop_control if simulator
                     else hop_star_control))
    hops += [("server_opt", hop_server_opt), ("ledger", hop_ledger)]
    if tele is not None:
        hops.append(("telemetry", hop_telemetry))
    hops.append(("finalize", hop_finalize))
    return RoundProgram(hops=tuple(hops))


def _build_sim(model: Model, fl: FLConfig, topo: Topology, chunk: int,
               device, population=None) -> RoundEngine:
    C = topo.n_clients
    terms, up, down = ledger_terms(model, fl)
    scaffold = fl.algorithm == "scaffold"
    scenario = _fl_scenario(fl)
    population = _attach_scenario(population, scenario)
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
    dispatch = make_dispatch(model, fl, up, down, C, chunk,
                             scenario=scenario)
    tele = _telemetry_spec(fl, up, down, model.param_sizes())
    if tele is not None:
        aux["telemetry"] = tele
    program = _build_server_program(fl, terms, dispatch, C,
                                    population=population, store=store,
                                    device=device, scenario=scenario,
                                    tele=tele)

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


# ---------------------------------------------------------------------------
# star / hier / gossip: one client per rank of a mesh
# ---------------------------------------------------------------------------

def _f32(v, device) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _gather_cat(mesh, axes):
    """(1,) per rank -> the (C,) tensor of the ranks along ``axes``; on a
    model axis, model rank 0's value of each client."""
    M = mesh.shape.get("model", 1)
    if M > 1:
        return lambda v: torch.cat(aggregation.all_gather(
            v.reshape(1), mesh, tuple(axes) + ("model",), "metrics")[::M])
    return lambda v: torch.cat(aggregation.all_gather(
        v.reshape(1), mesh, axes, "metrics"))


def _model_blocks(model: Model, mesh):
    """The star's model axis: ``({leaf: spec}, {leaf: its model dim or
    None}, {leaf: this rank's block shape})`` by
    ``repro_torch.models.sharding`` (specs None without a model axis)."""
    M = mesh.shape.get("model", 1)
    shapes = {n: tuple(d.shape) for n, d in model.defs.items()}
    if M == 1:
        return None, {n: None for n in shapes}, shapes
    specs = sharding.tree_specs(shapes, model.logical_axes(), mesh,
                                model.cfg.fsdp)
    if any(a not in (None, "model") for sp in specs.values() for a in sp):
        raise not_ported("FSDP weight sharding over the data axis",
                         "repro.models.sharding")
    dims = {n: sharding.model_dim(sp) for n, sp in specs.items()}
    return specs, dims, {n: sharding.block_shape(s, dims[n], M)
                         for n, s in shapes.items()}


def _build_star(model: Model, fl: FLConfig, topo: Topology, mesh, chunk: int,
                device, population=None) -> RoundEngine:
    """The star: each rank trains its own client from the replicated
    params, and the uplink is the collective aggregator
    (:func:`repro_torch.core.aggregation.make_aggregator`).  A rank's state
    is the params, the server optimizer's state and SCAFFOLD's server
    control (all replicated), its own pipeline row and its own ``c_i``
    row; its batch is its client's slice with the (C,) metadata.

    With a ``population`` (cohort C, one cohort slot per rank: slot c is
    client index c) each round samples the cohort (the ``cohort`` hop) and
    the rank trains cohort slot ``idx`` from the batch of
    ``data.pipeline.cohort_data_fn``.  The pipeline state is the
    reference's replicated residual store: every rank holds all of it,
    gathers the whole cohort's rows, advances its own through the
    collective wire and scatters the C advanced rows, which cross under
    the ``store`` hop, so the replicas stay bit-identical.  SCAFFOLD and
    a cohort other than C raise the reference's ``ValueError``.

    On a model axis of M ranks (``repro_torch.models.sharding``'s specs)
    each of a client's M ranks runs the client's whole local update from
    the same batch slice and encodes its block of every leaf
    (:func:`aggregation.make_aggregator`); its pipeline rows hold that
    block (a replicated leaf whole), and every rank ends the round with
    the whole params.  A population's store stays whole on every rank:
    the rank's slot row is cut to its blocks, and the ``store`` hop
    gathers every rank's advanced blocks over the client axes and
    ``model``."""
    client_axis = topo.client_axis or model.cfg.client_axis
    if client_axis == "pod":
        raise not_ported("pod-level clients (client_axis='pod', the FSDP "
                         "configs)", "repro.models.sharding")
    axes = aggregation.client_axes(mesh, client_axis)
    C = 1
    for a in axes:
        C *= mesh.shape[a]
    idx = aggregation.client_index(axes, mesh)
    terms, up, down = ledger_terms(model, fl)
    specs, dims, bshapes = _model_blocks(model, mesh)
    M = mesh.shape.get("model", 1)
    m = mesh.axis_index("model") if M > 1 else 0
    if specs is not None and up.stateful:
        aggregation.check_model_axis_state(up, bshapes.values())
    scaffold = fl.algorithm == "scaffold"
    scenario = _fl_scenario(fl)
    population = _attach_scenario(population, scenario)
    store, aux = None, {}
    if population is not None:
        if scaffold:
            raise ValueError(
                "scaffold keeps dense (C, model) client controls — "
                "incompatible with a streaming ClientPopulation")
        if population.cohort != C:
            raise ValueError(
                f"star topology dispatches one cohort slot per mesh client "
                f"({C}); got population.cohort={population.cohort}")
        # a stateless pipeline keeps no per-client rows: no store
        store = population.make_store(up, model.defs, device)
        aux = dict(population=population, store=store)
    # the rank's own client: a dispatch body of one
    dispatch = make_dispatch(model, fl, up, down, 1, chunk,
                             scenario=scenario)
    dense = (aggregation.make_aggregator(mesh, Identity(), client_axis,
                                         hop="dense", specs=specs)
             if scaffold else None)
    names = list(bshapes)

    def block_rows(rows):
        # a leaf-shaped state tensor of leaf li -> this rank's block
        def cut(t, li):
            if isinstance(t, torch.Tensor):
                n = names[li]
                if tuple(t.shape[1:]) == tuple(model.defs[n].shape):
                    return sharding.block(t, dims[n], m, M, lead=1)
                return t
            if isinstance(t, dict):
                return {k: cut(v, li) for k, v in t.items()}
            if isinstance(t, tuple):
                return tuple(cut(v, li) for v in t)
            return t
        return rows if M == 1 else tuple(cut(r, li)
                                         for li, r in enumerate(rows))

    star = _StarWire(
        idx=idx,
        aggregate=aggregation.make_aggregator(mesh, up, client_axis,
                                              specs=specs),
        aggregate_dense=(lambda t, w, r: dense(t, w, r, None)[0])
        if scaffold else None,
        gather=_gather_cat(mesh, axes),
        gather_rows=lambda rows: tuple(
            aggregation.all_gather_rows(r, mesh, axes, "store", dims[n],
                                        bshapes[n])
            for r, n in zip(rows, names)),
        block_rows=block_rows)
    tele = _telemetry_spec(fl, up, down, model.param_sizes())
    if tele is not None:
        aux["telemetry"] = tele
    program = _build_server_program(fl, terms, dispatch, C,
                                    population=population, store=store,
                                    device=device, scenario=scenario,
                                    tele=tele, star=star)

    def state_from_params(params):
        def zeros(lead=()):
            return {n: torch.zeros(lead + tuple(p.shape),
                                   dtype=torch.float32, device=p.device)
                    for n, p in params.items()}
        return FLState(
            params=params,
            server_opt_state=server_opt.init_state(fl.server_opt, params),
            control=zeros() if scaffold else None,
            client_controls=zeros((1,)) if scaffold else None,
            comm_state=(store.init() if store is not None
                        else comm_state_init(up, bshapes, 1, device)
                        if up.stateful else None),
            rng=PRNGKey(fl.seed), round=0)

    def init_fn(seed=0):
        return state_from_params(model.init(seed, device))

    def local_batch(batch):
        """The client's slice of the model inputs; the (C,) metadata whole
        (the selection hop reads every client's)."""
        return {k: v if k in ("sizes", "resources", "ids")
                else v[idx:idx + 1] for k, v in batch.items()}

    return RoundEngine(topology=topo, round_fn=program, init_fn=init_fn,
                       state_from_params=state_from_params, n_clients=C,
                       terms=terms, device=device, aux=aux,
                       mesh=mesh, local_batch=local_batch)


def _build_hier(model: Model, fl: FLConfig, topo: Topology, mesh, chunk: int,
                device) -> RoundEngine:
    """Client -> edge (pod) -> cloud.  Every round each pod aggregates its
    clients' payloads over its ``data`` group (the edge hop) and steps its
    own model; every ``sync_every`` rounds the pods' models also average
    over each ``pod`` group, quantized with ``pod_compressor`` (the cloud
    hop).  A rank's state is its pod's params and server-optimizer state
    and its own (1, 1)-led pipeline row; its batch is its client's
    ``[pod, data]`` slice of a (G, Ce, ...) batch."""
    if "pod" not in mesh.axis_names:
        raise AssertionError("hierarchical FL needs a pod axis")
    if fl.algorithm == "scaffold":
        raise AssertionError(
            "hierarchical topology keeps no server control-variate state; "
            "use fedavg/fedsgd/fedprox (or the star topology for SCAFFOLD)")
    G, Ce = mesh.shape["pod"], mesh.shape["data"]
    gi, ci = mesh.axis_index("pod"), mesh.axis_index("data")
    # the edge hop runs the full uplink pipeline (EF / DGC included)
    up = uplink_pipeline(fl)
    pod_comp = make_compressor(fl.pod_compressor, block=fl.qsgd_block,
                               backend=fl.backend,
                               wire_format=fl.wire_format)
    stateful, masked = up.stateful, has_mask_ctx(up)
    nparams = model.param_sizes()
    bind_n_leaves(up, len(nparams))   # dpnoise: joint clip over all leaves
    terms = {
        "edge_wire": sum(up.wire_bits(n) for n in nparams) / 8.0 * Ce * G,
        "cloud_wire": sum(pod_comp.wire_bits(n) for n in nparams) / 8.0 * G,
        "dense": sum(32.0 * n for n in nparams) / 8.0 * Ce * G,
    }
    # one spec for both programs: the edge stages are static per-round
    # bytes, and the appended pod slot is the residual against the round's
    # own ledger (0 on edge rounds, cloud_wire on cloud rounds)
    tele = None
    if fl.telemetry:
        tele = obs_tel.telemetry_spec(
            up, None, nparams, up_scale=float(Ce * G),
            extra_up=((f"pod:{fl.pod_compressor}", terms["cloud_wire"]),))
    everyone = _gather_cat(mesh, ("pod", "data"))

    def agg_edge(deltas, weights, rng, comm_state):
        """The edge hop: this pod's weighted mean of its clients' decoded
        payloads, the payloads gathered over the pod's data group; the
        rank's pipeline row stays with it."""
        wrow = weights[gi]
        out, st_out = {}, []
        for li, (name, leaf) in enumerate(deltas.items()):
            flat = leaf.reshape(-1).to(torch.float32)
            n = flat.shape[0]
            r = rng.fold_in(li).fold_in(gi * Ce + ci)
            if up.is_identity:
                tot = aggregation.all_reduce_sum(wrow[ci] * flat, mesh,
                                                 ("data",), "edge")
                edge = tot / torch.clamp(wrow.sum(), min=1e-9)
            else:
                st = (_index_state(comm_state[li], (0, 0)) if stateful
                      else up.init((n,), device=flat.device))
                if masked:
                    # a mask ring per pod over its data group (cohort Ce)
                    mkey = rng.fold_in(MASK_TAG).fold_in(li).fold_in(gi)
                    st = inject_mask_ctx(st, mkey, ci, Ce)
                payload, new_st = up.encode(st, r, flat)
                rows = aggregation.gather_payload(up, payload, mesh,
                                                  ("data",), "edge")
                dec = torch.stack([up.decode(p, n) for p in rows])
                edge = (wrow[:, None] * dec).sum(0) / \
                    torch.clamp(wrow.sum(), min=1e-9)
                if stateful:
                    st_out.append(aggregation.lead_state(new_st, 2))
            out[name] = edge.reshape(leaf.shape).to(leaf.dtype)
        return out, (tuple(st_out) if stateful else None)

    def sync_models(params, rng):
        """The cloud hop: the pods' models averaged over each pod group,
        quantized with ``pod_compressor``; every pod leaves with the same
        model."""
        out = {}
        for li, (name, leaf) in enumerate(params.items()):
            flat = leaf.reshape(-1).to(torch.float32)
            r = rng.fold_in(li)
            if pod_comp.is_identity:
                synced = aggregation.all_reduce_sum(
                    flat, mesh, ("pod",), "cloud") / G
            else:
                pay, _ = pod_comp.encode(
                    pod_comp.init(flat.shape, device=flat.device),
                    r.fold_in(gi), flat)
                rows = aggregation.gather_payload(pod_comp, pay, mesh,
                                                  ("pod",), "cloud")
                synced = torch.stack([pod_comp.decode(p, flat.shape[0])
                                      for p in rows]).sum(0) / G
            out[name] = synced.reshape(leaf.shape).to(leaf.dtype)
        return out

    def pod_divergence(params):
        """Mean squared distance of the pods' models from their mean, probed
        on the first 4,096 entries of the largest leaf (the reference's
        probe: a full-model version costs a model-sized pod all-reduce);
        the probes cross the pod group."""
        name = sorted(params, key=lambda k: -params[k].numel())[0]
        probe = params[name].reshape(-1)[:4096].to(torch.float32)
        probe = torch.stack(aggregation.all_gather(probe, mesh, ("pod",),
                                                   "metrics"))
        return ((probe - probe.mean(0, keepdim=True)) ** 2).mean()

    def make_program(cloud: bool) -> RoundProgram:
        def hop_rng(ctx):
            r_loc, r_up, r_next = ctx["state"].rng.split(3)
            ctx.update(r_up=r_up, r_next=r_next)
            return ctx

        def hop_local_update(ctx):
            mb = {k: v for k, v in ctx["batch"].items() if k != "sizes"}
            delta, loss, _, _ = _client_update(model, fl, ctx["state"].params,
                                               mb, chunk)
            ctx.update(deltas=delta, losses=everyone(loss))
            return ctx

        def hop_wire(ctx):
            weights = ctx["batch"].get("sizes")
            if weights is None:
                weights = torch.ones((G, Ce), dtype=torch.float32,
                                     device=device)
            agg, new_comm = agg_edge(ctx.pop("deltas"), weights,
                                     ctx["r_up"], ctx["state"].comm_state)
            ctx.update(agg=agg, new_comm=new_comm)
            return ctx

        def hop_server_opt(ctx):
            st = ctx["state"]
            new_params, new_sos = server_opt.apply(fl, st.params, ctx["agg"],
                                                   st.server_opt_state)
            ctx.update(new_params=new_params, new_sos=new_sos)
            return ctx

        def hop_cloud_sync(ctx):
            ctx["new_params"] = sync_models(ctx["new_params"],
                                            ctx["r_up"].fold_in(99))
            return ctx

        def hop_ledger(ctx):
            wire = terms["edge_wire"] + (terms["cloud_wire"] if cloud
                                         else 0.0)
            rho = up.dp_rho_per_round()
            ctx["ledger"] = CommLedger(
                uplink_wire=_f32(wire, device),
                uplink_entropy=_f32(wire, device),
                downlink_wire=_f32(0.0, device),
                uplink_dense=_f32(terms["dense"], device),
                downlink_dense=_f32(0.0, device),
                dp_rho=_f32(rho * Ce * G, device) if rho else None)
            return ctx

        def hop_telemetry(ctx):
            ctx["round_stats"] = obs_tel.round_stats(
                tele, ctx["ledger"], up_unit=_f32(1.0, device),
                selected=_f32(Ce * G, device),
                available=_f32(Ce * G, device))
            return ctx

        def hop_finalize(ctx):
            st = ctx["state"]
            ctx["metrics"] = {
                "loss": ctx["losses"].mean(),
                "ledger": ctx["ledger"],
                "pod_divergence": pod_divergence(ctx["new_params"]),
            }
            if tele is not None:
                ctx["metrics"]["round_stats"] = ctx["round_stats"]
            ctx["new_state"] = FLState(
                params=ctx["new_params"], server_opt_state=ctx["new_sos"],
                control=None, client_controls=None,
                comm_state=ctx["new_comm"], rng=ctx["r_next"],
                round=st.round + 1)
            return ctx

        hops = [("rng", hop_rng), ("local_update", hop_local_update),
                ("edge_wire", hop_wire), ("server_opt", hop_server_opt)]
        if cloud:
            hops.append(("cloud_sync", hop_cloud_sync))
        hops.append(("ledger", hop_ledger))
        if tele is not None:
            hops.append(("telemetry", hop_telemetry))
        hops.append(("finalize", hop_finalize))
        return RoundProgram(hops=tuple(hops))

    edge_program, cloud_program = make_program(False), make_program(True)

    def round_fn(state, batch):
        """The cloud program every ``sync_every``-th round, else the edge
        program."""
        if (state.round + 1) % topo.sync_every == 0:
            return cloud_program(state, batch)
        return edge_program(state, batch)

    def state_from_params(params):
        return FLState(
            params=params,
            server_opt_state=server_opt.init_state(fl.server_opt, params),
            control=None, client_controls=None,
            comm_state=(comm_state_init(up, params, (1, 1), device)
                        if stateful else None),
            rng=PRNGKey(fl.seed), round=0)

    def init_fn(seed=0):
        return state_from_params(model.init(seed, device))

    def local_batch(batch):
        """The client's ``[pod, data]`` slice of (G, Ce, ...) model inputs;
        ``sizes`` (G, Ce) whole."""
        return {k: v if k == "sizes" else v[gi, ci] for k, v in batch.items()}

    return RoundEngine(
        topology=topo, round_fn=round_fn, init_fn=init_fn,
        state_from_params=state_from_params, n_clients=G * Ce, terms=terms,
        device=device, mesh=mesh, local_batch=local_batch,
        programs={"edge": edge_program, "cloud": cloud_program},
        aux={"n_pods": G, "clients_per_pod": Ce,
             **({"telemetry": tele} if tele is not None else {})})


def _build_gossip(model: Model, fl: FLConfig, topo: Topology, mesh,
                  chunk: int, device) -> RoundEngine:
    """Decentralized mixing over the ``data`` axis: every node keeps its own
    model, takes a local SGD step, then mixes in its in-neighbours' decoded
    payloads point to point, one ``ppermute`` per graph entry.  A rank's
    state is its node's params and its own (1,)-led pipeline row; its
    batch is its node's slice of a (C, ...) batch."""
    C = mesh.shape["data"]
    me = mesh.axis_index("data")
    # biased compressors gossip with error feedback, but not DGC momentum:
    # DGC accumulates update deltas and the mix ships raw parameters
    if fl.dgc_momentum > 0.0:
        raise ValueError(
            "dgc_momentum accumulates update deltas; the gossip mix ships "
            "raw model parameters — use error feedback (the default for "
            "biased pipelines) instead")
    comp = _make_uplink(fl, fl.topk_fraction)
    comp = _apply_privacy(fl, comp)
    if comp.biased and fl.error_feedback:
        comp = error_feedback(comp)
    stateful, masked = comp.stateful, has_mask_ctx(comp)
    check_doubly_stochastic(mixing_matrix(topo.graph, C))
    perms = [(_graph_edges(spec, C), w) for spec, w in topo.graph]
    # the self weight is 1 - the weights of the edges into the node (a node
    # no edge of a permutation targets receives zeros)
    self_w = 1.0
    for edges, w in perms:
        for _, dst in edges:
            if dst == me:
                self_w -= w
    self_w = _f32(np.float32(self_w), device)
    nparams = model.param_sizes()
    bind_n_leaves(comp, len(nparams))
    payload_bytes = sum(comp.wire_bits(n) for n in nparams) / 8.0
    n_edges = sum(len(edges) for edges, _ in perms)
    terms = {
        # every payload crossing a directed edge counts once
        "mix_wire": payload_bytes * n_edges,
        "dense": sum(32.0 * n for n in nparams) / 8.0 * n_edges,
    }
    tele = (obs_tel.telemetry_spec(comp, None, nparams,
                                   up_scale=float(n_edges))
            if fl.telemetry else None)

    def mix(params, rng, comm_state):
        out, st_out = {}, []
        for li, (name, leaf) in enumerate(params.items()):
            flat = leaf.reshape(-1).to(torch.float32)
            n = flat.shape[0]
            r = rng.fold_in(li)
            st = (_index_state(comm_state[li], 0) if stateful
                  else comp.init((n,), device=flat.device))
            if masked:
                # the ring spans all C nodes; a decode unmasks per sender
                st = inject_mask_ctx(st, rng.fold_in(MASK_TAG).fold_in(li),
                                     me, C)
            payload, new_st = comp.encode(st, r, flat)
            mixed = self_w * flat
            for edges, w in perms:
                src = [s for s, d in edges if d == me]
                nb = aggregation.permute_payload(
                    comp, payload, mesh, "data", edges,
                    src[0] if src else None, "mix")
                dec = comp.decode(nb, n)
                mixed = mixed + scalar_like(w, dec) * dec
            out[name] = mixed.reshape(leaf.shape).to(leaf.dtype)
            if stateful:
                st_out.append(aggregation.lead_state(new_st, 1))
        return out, (tuple(st_out) if stateful else None)

    everyone = _gather_cat(mesh, ("data",))

    def hop_rng(ctx):
        r_mix, r_next = ctx["state"].rng.split(2)
        ctx.update(r_mix=r_mix, r_next=r_next)
        return ctx

    def hop_local_update(ctx):
        p = ctx["state"].params
        loss, g = _value_and_grad(model, p, ctx["batch"], chunk)
        ctx.update(params={n: (a.to(torch.float32)
                               - g[n].to(torch.float32) * fl.local_lr)
                           .to(a.dtype) for n, a in p.items()},
                   losses=everyone(loss))
        return ctx

    def hop_mix(ctx):
        params, new_comm = mix(ctx["params"], ctx["r_mix"],
                               ctx["state"].comm_state)
        ctx.update(params=params, new_comm=new_comm)
        return ctx

    def hop_ledger(ctx):
        rho = comp.dp_rho_per_round()
        # every node releases one noised payload a round
        ctx["ledger"] = CommLedger(
            uplink_wire=_f32(terms["mix_wire"], device),
            uplink_entropy=_f32(terms["mix_wire"], device),
            downlink_wire=_f32(0.0, device),
            uplink_dense=_f32(terms["dense"], device),
            downlink_dense=_f32(0.0, device),
            dp_rho=_f32(rho * C, device) if rho else None)
        return ctx

    def hop_telemetry(ctx):
        ctx["round_stats"] = obs_tel.round_stats(
            tele, ctx["ledger"], up_unit=_f32(1.0, device),
            selected=_f32(C, device), available=_f32(C, device))
        return ctx

    def consensus(params):
        # mean squared distance to the mean model: the node mean is one f32
        # all-reduce of the model (a metric, outside the mix's bytes), the
        # squared distances one scalar all-reduce
        sq = torch.zeros((), dtype=torch.float32, device=device)
        size = 0
        for leaf in params.values():
            x = leaf.to(torch.float32)
            mean = aggregation.all_reduce_sum(x, mesh, ("data",),
                                              "metrics") / C
            sq = sq + ((x - mean) ** 2).sum()
            size += x.numel() * C
        return aggregation.all_reduce_sum(sq, mesh, ("data",),
                                          "metrics") / size

    def hop_finalize(ctx):
        ctx["metrics"] = {"loss": ctx["losses"].mean(),
                          "consensus": consensus(ctx["params"]),
                          "ledger": ctx["ledger"]}
        if tele is not None:
            ctx["metrics"]["round_stats"] = ctx["round_stats"]
        ctx["new_state"] = FLState(
            params=ctx["params"], server_opt_state={},
            control=None, client_controls=None,
            comm_state=ctx["new_comm"], rng=ctx["r_next"],
            round=ctx["state"].round + 1)
        return ctx

    hops = [("rng", hop_rng), ("local_update", hop_local_update),
            ("mix", hop_mix), ("ledger", hop_ledger)]
    if tele is not None:
        hops.append(("telemetry", hop_telemetry))
    hops.append(("finalize", hop_finalize))
    program = RoundProgram(hops=tuple(hops))

    def state_from_params(params):
        return FLState(params=params, server_opt_state={}, control=None,
                       client_controls=None,
                       comm_state=(comm_state_init(comp, params, 1, device)
                                   if stateful else None),
                       rng=PRNGKey(fl.seed), round=0)

    def init_fn(seed=0):
        return state_from_params(model.init(seed, device))

    def local_batch(batch):
        """The node's slice of (C, ...) model inputs."""
        return {k: v[me] for k, v in batch.items()
                if k not in ("sizes", "resources", "ids")}

    return RoundEngine(topology=topo, round_fn=program, init_fn=init_fn,
                       state_from_params=state_from_params, n_clients=C,
                       terms=terms, device=device, mesh=mesh,
                       local_batch=local_batch,
                       aux=({"telemetry": tele} if tele is not None else {}))


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
                      population=None, mesh=None) -> RoundEngine:
    """Build the round executor for one (model, fl, topology) binding on
    ``device`` (``cuda`` unless ``device="cpu"`` is asked for).

    The ``async`` topology also needs ``data_fn(version) -> batch`` at
    build time: its events sample each dispatch generation's batch,
    keyed on the server version at dispatch (:mod:`repro_torch.core
    .async_engine`).

    ``star``, ``hier`` and ``gossip`` need ``mesh`` (a
    :class:`repro_torch.launch.mesh.Mesh` over the initialised process
    group) and build this rank's engine, on the mesh's device unless
    ``device`` is given.

    ``population`` (a :class:`repro_torch.core.population
    .ClientPopulation`) switches the sim and async rounds to streaming
    cohorts: each round or generation touches ``population.cohort``
    sampled clients, and per-client pipeline state lives in a bounded
    residual store.  Dense builds above ``POPULATION_DENSE_LIMIT`` clients
    with a stateful uplink are rejected."""
    kind = topology.kind
    if population is not None and kind in ("hier", "gossip"):
        raise ValueError(
            f"{kind} topology pins every client to a mesh device — "
            f"a streaming ClientPopulation only applies to star/sim/async")
    if kind in ("hier", "gossip") and _fl_scenario(fl) is not None:
        raise ValueError(
            f"scenario client dynamics (FLConfig.scenario_*) thread through "
            f"the star/sim/async round programs; the {kind} "
            f"topology has no per-client selection/weighting hop to mask")
    if kind in ("star", "hier", "gossip"):
        if mesh is None:
            raise ValueError(f"{kind} topology needs a mesh")
        if kind != "star" and mesh.shape.get("model", 1) > 1:
            raise not_ported(f"the {kind} topology on a model axis",
                             "repro.models.sharding")
        dev = mesh.device if device is None else resolve_device(device)
        if kind == "star":
            engine = _build_star(model, fl, topology, mesh, chunk, dev,
                                 population=population)
        elif kind == "hier":
            engine = _build_hier(model, fl, topology, mesh, chunk, dev)
        else:
            engine = _build_gossip(model, fl, topology, mesh, chunk, dev)
        engine.eval_every = max(1, int(fl.eval_every))
        return engine
    if kind not in ("sim", "async"):
        raise ValueError(f"unknown topology kind {kind!r}")
    dev = resolve_device(device)
    if topology.n_clients <= 0:
        raise ValueError(f"{kind} topology needs n_clients > 0")
    if population is None:
        _check_population(fl, topology)
    if kind == "async":
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


def stack_rows(rows):
    """Per-round values stacked over a leading round dim: tensors with
    ``torch.stack``, dicts by key, dataclasses (the ``CommLedger``, the
    ``RoundStats``) field by field, a ``None`` field left ``None``."""
    first = rows[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: stack_rows([r[k] for r in rows]) for k in first}
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: stack_rows([getattr(r, f.name) for r in rows])
            for f in dataclasses.fields(first)})
    return torch.stack(rows)


def run_rounds(engine: RoundEngine, state, data_fn, n: int, metrics_fn=None,
               eval_every=None, tracer=None):
    """Run ``n`` rounds; ``data_fn(round_idx) -> batch`` (on a mesh the
    round's global batch, which ``engine.local_batch`` cuts to the rank's
    part).  Returns
    ``(final_state, metrics)`` with every metric stacked over a leading
    (n,) round dim (the ledger as a CommLedger of (n,) tensors, the
    telemetry as a RoundStats).  On the ``async`` topology a round is one
    server event, which samples its own dispatch batches: no batch is
    drawn for it here.

    ``metrics_fn(new_state, metrics) -> metrics`` (optional) appends
    per-round metrics such as a held-out eval loss.  It runs every
    ``eval_every``-th round (default the engine's ``FLConfig.eval_every``):
    the last of each cadence window, where the pre-round ``state.round %
    eval_every == eval_every - 1``, so a run whose length is a multiple of
    the cadence evaluates its final round.  On the other rounds its
    eval-only float metrics are NaN.

    ``tracer`` (a :class:`repro_torch.obs.trace.Tracer`) records one span
    per round, synchronised with the card inside it, of kind ``compile``
    when ``kernels/build.py`` built or loaded a CUDA library during the
    round and ``chunk`` otherwise, and runs the whole loop under the
    tracer's ``torch.profiler`` hook (a no-op without a profile
    directory)."""
    if n <= 0:
        return state, None
    if tracer is None:
        return _run(engine, state, data_fn, n, metrics_fn, eval_every, None)
    with tracer.profile():
        return _run(engine, state, data_fn, n, metrics_fn, eval_every,
                    tracer)


def _run(engine, state, data_fn, n, metrics_fn, eval_every, tracer):
    from repro_torch.kernels import build
    ee = max(1, int(engine.eval_every if eval_every is None else eval_every))
    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else lambda _dev: None)
    rows, tmpl = [], None
    for _ in range(n):
        due = state.round % ee == ee - 1
        batch = None if engine.topology.kind == "async" else \
            data_fn(state.round)
        if batch is not None and engine.local_batch is not None:
            batch = engine.local_batch(batch)
        if tracer is None:
            state, m = engine.round_fn(state, batch)
        else:
            loads = sum(build.LOADS.values())
            with tracer.span("chunk", rounds=1) as sp:
                state, m = engine.round_fn(state, batch)
                sync(engine.device)
                if sum(build.LOADS.values()) > loads:
                    sp["kind"] = "compile"
        if metrics_fn is not None and due:
            m = metrics_fn(state, m)
            tmpl = m
        rows.append((m, metrics_fn is not None and not due))
    if tmpl is None and metrics_fn is not None:
        # no round of this run was due: the output's keys, shapes and
        # dtypes from one call on the final state, its values unused
        tmpl = metrics_fn(state, rows[-1][0])
    rows = [_gated_metrics(tmpl, m) if skipped else m for m, skipped in rows]
    return state, stack_rows(rows)
