"""The port's virtual-clock async engine against the reference: the device
latencies, the degenerate contract, FedBuff, FedAsync, the deadline flush
and the population leg, plus the shared dispatch body, the guards and the
CLI.

The engines run with test_torch_selection.py's given local update on
paper_lm cut to two leaves, numpy-made batches and the reference's keys
through :class:`JaxKey`; the reference runs op by op (``jax.disable_jit``,
no FMA contraction across ops, as under :func:`ieee_jit`).  4 client
slots, 8 events a run.

Tolerances:
  * ``device_latency``: exact for ``constant``, ``resource`` and
    ``uniform``; ``heavy_tail`` within 2 ULP (PyTorch's vectorised f32
    ``pow`` and XLA's differ by 1 ULP on about 2% of inputs);
  * every run: the popped slot, staleness, server version, flush and
    buffer fill of every event exact; the virtual clock exact, and under
    ``heavy_tail`` within rtol 1e-6 (the latencies' ULPs);
  * params, EF residuals, server moments, buffered rows, pending rows,
    losses, ledger, store and slot table: exact (the staleness weight is
    a 0-dim ``pow``, the same function as XLA's on the CPU);
  * the deadline run's clock is at least 1e-5 relative away from every
    deadline it is compared with, so the clock's ULPs cannot flip a flush.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as EJ
from repro.core import population as pop_j
from repro.core.types import FLConfig as FLConfigJax
from repro.data import pipeline as pipe_j
from repro_torch.convert import (async_state_to_jax, params_from_jax,
                                 params_to_jax, store_to_jax)
from repro_torch.core import engine as ET
from repro_torch.core import population as pop_t
from repro_torch.core.types import FLConfig
from repro_torch.data import pipeline as pipe_t
from test_torch_jaxkeys import JaxKey, one_torch_thread  # noqa: F401
from test_torch_selection import (SPEC, batch_np, given_local_update,  # noqa: F401
                                  models, same_tree, to_jax, to_port)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

C, EVENTS = 4, 8
BASE = dict(uplink_compressor=SPEC, local_steps=1, local_lr=0.2)


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32))


@pytest.mark.parametrize("profile", pipe_t.LATENCY_PROFILES)
def test_device_latency_matches_reference(profile):
    res = np.random.default_rng(5).uniform(0.0, 1.0, (4096, 4)) \
        .astype(np.float32)                 # below 0.05 too: the floor
    key = jax.random.PRNGKey(11)
    with jax.disable_jit():
        want = np.asarray(pipe_j.device_latency(profile, jnp.asarray(res),
                                                key))
        cap = np.asarray(pipe_j.capability_latency(jnp.asarray(res)))
    got = pipe_t.device_latency(profile, torch.from_numpy(res), JaxKey(key))
    assert got.dtype == torch.float32 and got.shape == (4096,)
    np.testing.assert_array_equal(
        pipe_t.capability_latency(torch.from_numpy(res)).numpy(), cap)
    if profile == "heavy_tail":
        ulps = _ulps(got.numpy(), want)
        assert ulps.max() <= 2 and ulps.mean() < 0.1, (ulps.max(),
                                                       ulps.mean())
    else:
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# runs against the reference
# ---------------------------------------------------------------------------

def _dense_data():
    return (lambda v: to_jax(batch_np(C, v)),
            lambda v: to_port(batch_np(C, v)))


def _pop_batch(ids, version):
    """The cohort's batch: tokens drawn per (version, id), size and
    resources per id."""
    ids = [int(i) for i in ids]
    per_id = [np.random.default_rng([2, i]) for i in ids]
    sizes = np.float32([g.uniform(1.0, 2.0) for g in per_id])
    res = np.stack([g.uniform(0.05, 1.0, 4) for g in per_id]) \
        .astype(np.float32)
    toks = np.stack([np.random.default_rng([1, int(version), i]).integers(
        0, 256, (1, 4)) for i in ids]).astype(np.int32)
    return {"tokens": toks, "sizes": sizes, "resources": res,
            "ids": np.int32(ids)}


def _pop_data(pj, pt):
    def data_j(v):
        return to_jax(_pop_batch(np.asarray(pj.cohort_ids(v)), v))

    def data_t(v):
        b = _pop_batch(pt.cohort_ids(v, "cpu").numpy(), v)
        ids = b.pop("ids")
        return dict(to_port(b), ids=torch.from_numpy(ids))
    return data_j, data_t


def _run_both(fl_kw, topo_kw, n_events=EVENTS, pop_kw=None):
    """The reference's and the port's engines from the reference's init:
    (reference state, port state, per-event [(slot, metrics)] of the
    reference and [(slot, metrics, the clock's relative distance to the
    deadline)] of the port, the port engine, the init params (numpy))."""
    mj, mt = models()
    N, pops = C, (None, None)
    if pop_kw is not None:
        pops = (pop_j.ClientPopulation(**pop_kw),
                pop_t.ClientPopulation(**pop_kw))
        N = pop_kw["n_clients"]
    data_j, data_t = (_dense_data() if pop_kw is None
                      else _pop_data(*pops))
    et = ET.make_round_engine(mt, FLConfig(**fl_kw),
                              ET.Topology.async_(N, **topo_kw), chunk=8,
                              device="cpu", data_fn=data_t,
                              population=pops[1])
    ev_j, ev_t = [], []
    with jax.disable_jit():
        ej = EJ.make_round_engine(mj, FLConfigJax(**fl_kw),
                                  EJ.Topology.async_(N, **topo_kw), chunk=8,
                                  data_fn=data_j, population=pops[0])
        st_j = ej.init_fn(jax.random.PRNGKey(0))
        params0 = jax.tree.map(np.asarray, st_j.params)
        st_t = et.state_from_params(params_from_jax(params0))
        for _ in range(n_events):
            ev_j.append(int(jnp.argmin(st_j.async_state["next_done"])))
            st_j, m = ej.round_fn(st_j, None)
            ev_j[-1] = (ev_j[-1], m)
    for _ in range(n_events):
        A = st_t.async_state
        slot = int(torch.argmin(A["next_done"]))
        margin = abs(float(torch.maximum(A["clock"], A["next_done"][slot]))
                     / float(A["next_deadline"]) - 1.0)
        st_t, m = et.round_fn(st_t, None)
        ev_t.append((slot, m, margin))
    return st_j, st_t, ev_j, ev_t, et, params0


def _same_run(st_j, st_t, ev_j, ev_t, clock_rtol=0.0):
    for e, ((cj, mj), (ct, mt, _)) in enumerate(zip(ev_j, ev_t)):
        what = f"event {e}"
        assert ct == cj, what
        for k in ("staleness", "server_version", "flushed", "buffer_fill",
                  "loss"):
            assert float(mt[k]) == float(mj[k]), (what, k)
        np.testing.assert_allclose(float(mt["clock"]), float(mj["clock"]),
                                   rtol=clock_rtol, err_msg=what)
        for k, v in mt["ledger"].fields().items():
            if k != "virtual_time":
                assert float(v) == float(getattr(mj["ledger"], k)), (what,
                                                                     k)
    same_tree(params_to_jax(st_t.params), st_j.params, "params")
    same_tree({k: params_to_jax(v) for k, v in
               st_t.server_opt_state.items()}, st_j.server_opt_state,
              "server moments")
    same_tree(store_to_jax(st_t.comm_state), st_j.comm_state,
              "comm_state")
    A_t, A_j = async_state_to_jax(st_t.async_state), st_j.async_state
    assert sorted(A_t) == sorted(A_j)
    for k in A_t:
        if k in ("clock", "next_done", "next_deadline") and clock_rtol:
            np.testing.assert_allclose(A_t[k], np.asarray(A_j[k]),
                                       rtol=clock_rtol, err_msg=k)
        else:
            same_tree(A_t[k], A_j[k], f"async_state {k}")


@pytest.mark.parametrize("server_opt", ["fedavg", "fedadam"])
def test_degenerate_run_bitexact_with_reference_and_sync(server_opt,
                                                         given_local_update):
    """Constant latency, K = C: two generations of 4 pops in slot order
    (the all-equal completion times tie, argmin takes the lowest index)
    and one flush each, bit-exact against the reference's async run and
    the port's own sync run (params, EF residuals, moments, the flush
    events' losses, the ledger summed over a generation)."""
    kw = dict(BASE, server_opt=server_opt, server_lr=0.05)
    st_j, st_t, ev_j, ev_t, _, params0 = _run_both(
        kw, dict(buffer_size=C, latency_profile="constant"))
    _same_run(st_j, st_t, ev_j, ev_t)
    assert [s for s, _, _ in ev_t] == [0, 1, 2, 3] * 2
    assert [float(m["staleness"]) for _, m, _ in ev_t] == [0.0] * EVENTS
    assert [float(m["clock"]) for _, m, _ in ev_t] == [1.0] * 4 + [2.0] * 4

    _, mt = models()
    sync = ET.make_round_engine(mt, FLConfig(**kw), ET.Topology.sim(C),
                                chunk=8, device="cpu")
    ss = sync.state_from_params(params_from_jax(params0))
    ss, ms = ET.run_rounds(sync, ss, _port_data, 2)
    for (n, a), b in zip(st_t.params.items(), ss.params.values()):
        assert torch.equal(a, b), n
    for a, b in zip(jax.tree.leaves(store_to_jax(st_t.comm_state)),
                    jax.tree.leaves(store_to_jax(ss.comm_state))):
        np.testing.assert_array_equal(a, b)
    if server_opt == "fedadam":
        for k in ("m", "v"):
            for a, b in zip(st_t.server_opt_state[k].values(),
                            ss.server_opt_state[k].values()):
                assert torch.equal(a, b) and bool(b.abs().sum() > 0)
    flush_loss = [m["loss"] for _, m, _ in ev_t[C - 1::C]]
    assert torch.equal(torch.stack(flush_loss), ms["loss"])
    up = torch.stack([m["ledger"].uplink_wire for _, m, _ in ev_t])
    assert torch.equal(up.reshape(2, C).sum(1), ms["ledger"].uplink_wire)
    down = [m["ledger"].downlink_wire for _, m, _ in ev_t[C - 1::C]]
    assert torch.equal(torch.stack(down), ms["ledger"].downlink_wire)


@pytest.mark.parametrize("case", ["fedbuff_k2", "fedasync_k1", "deadline"])
def test_async_run_matches_reference(case, given_local_update):
    """FedBuff K = 2 under ``heavy_tail``, FedAsync K = 1 under
    ``uniform`` (alpha 0.6) and K = C with a 0.75 flush deadline under
    ``heavy_tail``: 8 events each from the reference's init."""
    topo = {"fedbuff_k2": dict(buffer_size=2, latency_profile="heavy_tail"),
            "fedasync_k1": dict(buffer_size=1, latency_profile="uniform",
                                staleness_alpha=0.6),
            "deadline": dict(buffer_size=C, latency_profile="heavy_tail",
                             flush_deadline=0.75)}[case]
    st_j, st_t, ev_j, ev_t, _, _ = _run_both(BASE, topo)
    heavy = topo["latency_profile"] == "heavy_tail"
    _same_run(st_j, st_t, ev_j, ev_t, clock_rtol=1e-6 if heavy else 0.0)
    flushed = [float(m["flushed"]) for _, m, _ in ev_t]
    stale = [float(m["staleness"]) for _, m, _ in ev_t]
    version = int(ev_t[-1][1]["server_version"])
    assert version == sum(flushed)
    if case == "fedasync_k1":
        assert flushed == [1.0] * EVENTS and max(stale) >= 1.0
    elif case == "fedbuff_k2":
        assert version == EVENTS // 2 and max(stale) >= 1.0
    else:
        # the deadline flushes below the count: more flushes than C-event
        # generations, and no clock within 1e-5 of a deadline it meets
        assert version > EVENTS // C
        assert min(margin for _, _, margin in ev_t) > 1e-5


def test_population_leg_matches_reference(given_local_update):
    """1,000 clients, stride cohorts of 4, a 6-slot ``drop`` store, K = 2
    under ``heavy_tail``: every arrival scatters its row into the store
    under the client id its slot hosts, every flush gathers the next
    cohort's ids for the flushed slots; slot table, store and params
    against the reference's."""
    pop_kw = dict(n_clients=1000, cohort=C, capacity=6, sampler="stride",
                  seed=2)
    st_j, st_t, ev_j, ev_t, et, _ = _run_both(
        BASE, dict(buffer_size=2, latency_profile="heavy_tail"),
        pop_kw=pop_kw)
    _same_run(st_j, st_t, ev_j, ev_t, clock_rtol=1e-6)
    assert et.aux["cohort"] == C and et.aux["store"] is not None
    client = st_t.comm_state["client"].tolist()
    assert len(set(client) - {-1}) == 6            # the store has evicted
    assert len(set(st_t.async_state["slot_client"].tolist())) == C


# ---------------------------------------------------------------------------
# structure, guards, CLI
# ---------------------------------------------------------------------------

def _port_data(v):
    return to_port(batch_np(C, v))


def test_sync_and_async_share_one_dispatch_body(monkeypatch,
                                                given_local_update):
    """Both topologies are built on ``engine.make_dispatch``: one Dispatch
    per engine from the one factory, the async engine's in its aux, and
    its wire body runs at the init and at every flush; ``run_rounds``
    draws no batch for an async event (the engine samples its own)."""
    built = []
    real = ET.make_dispatch

    def counting(*a, **kw):
        d = real(*a, **kw)
        d.wire_calls, wire = 0, d.wire_rows

        def counted(*ra, **rk):
            d.wire_calls += 1
            return wire(*ra, **rk)
        d.wire_rows = counted
        built.append(d)
        return d

    monkeypatch.setattr(ET, "make_dispatch", counting)
    _, mt = models()
    fl = FLConfig(**BASE)
    sim = ET.make_round_engine(mt, fl, ET.Topology.sim(C), chunk=8,
                               device="cpu")
    calls = []

    def data_fn(v):
        calls.append(int(v))
        return _port_data(v)
    asy = ET.make_round_engine(mt, fl, ET.Topology.async_(
        C, buffer_size=2, latency_profile="uniform"), chunk=8, device="cpu",
        data_fn=data_fn)
    assert len(built) == 2 and asy.aux["dispatch"] is built[1]
    sim.round_fn(sim.init_fn(0), _port_data(0))
    assert built[0].wire_calls == 1
    st = asy.init_fn(0)
    assert built[1].wire_calls == 1 and calls == [0]
    st, ms = ET.run_rounds(asy, st, data_fn, 6)
    assert float(ms["flushed"].sum()) == 3.0
    assert built[1].wire_calls == 4 and calls == [0, 1, 2, 3]


@pytest.mark.parametrize("kw,topo_kw,match", [
    (dict(algorithm="scaffold"), {}, "fedavg/fedsgd/fedprox"),
    (dict(selection="random", clients_per_round=2), {}, "completion order"),
    (dict(cmfl_threshold=0.5), {}, "completion order"),
    ({}, dict(buffer_size=C + 1), "buffer_size"),
    ({}, dict(latency_profile="nope"), "latency profile"),
    ({}, dict(flush_deadline=-1.0), "flush_deadline"),
    ({}, "no data_fn", "data_fn"),
    ({}, "population", "population.n_clients")])
def test_async_guards_match_reference(kw, topo_kw, match):
    mj, mt = models()
    pops, data_fn, N = (None, None), _port_data, C
    if topo_kw == "population":
        pops = (pop_j.ClientPopulation(n_clients=8, cohort=2),
                pop_t.ClientPopulation(n_clients=8, cohort=2))
    if topo_kw == "no data_fn":
        data_fn = None
    if isinstance(topo_kw, str):
        topo_kw = {}
    with pytest.raises(ValueError, match=match) as want:
        EJ.make_round_engine(mj, FLConfigJax(**kw),
                             EJ.Topology.async_(N, **topo_kw),
                             data_fn=data_fn, population=pops[0])
    with pytest.raises(ValueError) as got:
        ET.make_round_engine(mt, FLConfig(**kw),
                             ET.Topology.async_(N, **topo_kw), device="cpu",
                             data_fn=data_fn, population=pops[1])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,module", [
    (dict(telemetry=True), "repro.core.engine"),
    # the flight recorder beside the ported scenario and privacy knobs
    (dict(telemetry=True, scenario_deadline_quantile=0.5,
          scenario_dropout=0.5), "repro.core.engine"),
    (dict(telemetry=True, server_opt="fedadam", server_lr=0.05),
     "repro.core.engine")])
def test_async_unported_knobs_raise(kw, module, given_local_update,
                                    monkeypatch):
    """The telemetry knob, once rejected here, now runs: 4 events whose
    ``RoundStats`` (one upload, the flush's downlink slots, the one-hot
    staleness, the buffer fill, the dropout) equal the reference's bit for
    bit, as does the run; the star's population leg, once rejected too
    (naming ``module``), builds with the same knobs: the cohort hop first
    after rng and the telemetry hop before finalize.  (Telemetry under
    secagg: test_torch_obs.py; the star's population leg against the
    reference: test_torch_mesh_population.py.)"""
    from repro_torch.core import scenario as scn_t
    monkeypatch.setattr(scn_t, "PRNGKey",
                        lambda seed: JaxKey(jax.random.PRNGKey(seed)))
    fl_kw = dict(BASE, **kw)
    st_j, st_t, ev_j, ev_t, et, _ = _run_both(
        fl_kw, dict(buffer_size=2, latency_profile="uniform"), n_events=4)
    _same_run(st_j, st_t, ev_j, ev_t)
    assert et.aux["telemetry"].up_names
    for e, ((_, mj), (_, mt, _)) in enumerate(zip(ev_j, ev_t)):
        rs_j, rs_t = mj["round_stats"], mt["round_stats"]
        for f, v in rs_t.fields().items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(getattr(rs_j, f)),
                                          err_msg=f"event {e} {f}")
    from repro_torch.launch.mesh import Mesh
    _, mt = models()
    mesh = Mesh(shape={"data": C, "model": 1}, rank=0,
                device=torch.device("cpu"), backend="gloo", groups={})
    star = ET.make_round_engine(mt, FLConfig(**kw), ET.Topology.star(),
                                mesh=mesh, population=pop_t.ClientPopulation(
                                    n_clients=100, cohort=C))
    hops = [h for h, _ in star.round_fn.hops]
    assert hops[:2] == ["rng", "cohort"] and hops[-2:] == ["telemetry",
                                                           "finalize"]
    assert star.aux["telemetry"].up_names


@pytest.mark.parametrize("population", [False, True])
def test_cli_async_on_cpu(population, capsys):
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--async", "--clients", "4", "--buffer-size",
            "2", "--rounds", "6", "--local-steps", "1", "--compressor",
            "topk:0.05>>qsgd:8", "--seq", "8", "--batch-per-client", "1"]
    if population:
        argv += ["--population", "100000", "--cohort", "4",
                 "--store-capacity", "8"]
    state, ms = train.main(argv)
    out = capsys.readouterr().out
    assert out.count("event ") == 6
    assert ("population=100,000 cohort=4" in out) == population
    assert ms["server_version"].tolist() == [0, 1, 1, 2, 2, 3]
    assert torch.isfinite(ms["loss"]).all()
    assert ms["clock"].diff().ge(0).all()
    if population:
        assert len(set(state.comm_state["client"].tolist()) - {-1}) >= 4
