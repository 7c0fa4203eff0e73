"""The port's scenario client dynamics (``core/scenario.py`` and the
engines' scenario hops) against the reference: the traces, the dropout
draws, the step budgets, the quantile tracker, the degenerate contract
and one round of each dynamic through both engines.

The reference's draws reach the port through :class:`JaxKey`
(``scenario.PRNGKey`` monkeypatched).  The engines run with a given local
update on paper_lm cut to two leaves of one shape (test_torch_privacy.py's
``models2``), here in
a form that takes the per-client step budget: E elementwise steps of
test_torch_selection.py's update, a client's steps past its budget
keeping its params, the same arithmetic in both packages (the port's real
local update is held to the truncation below on its own).  The reference
runs op by op under ``jax.disable_jit()``.

Tolerances:
  * phases, square and diurnal masks, survival masks and draws,
    ``epoch_steps``, ``quantile_init`` / ``quantile_update``: exact (no
    mask flipped on the seeds used);
  * the diurnal probability (``sin``) within 2 ULP of 1.0, the scale of
    its terms (it cancels towards 0), and the survival probability
    (``exp``) within 2 ULP;
  * the degenerate SCENARIO_CASES against the port's scenario-free run,
    and every engine run against the reference (params, EF rows, ledger,
    selected, async state, event order): exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_cases import SCENARIO_CASES
from repro.compress import secure_agg as SJ
from repro.core import engine as EJ
from repro.core import scenario as scn_j
from repro.core.types import FLConfig as FLConfigJax
from repro.data import pipeline as pipe_j
from repro_torch.compress import secure_agg as ST
from repro_torch.convert import params_from_jax, params_to_jax, store_to_jax
from repro_torch.core import async_engine as AT
from repro_torch.core import engine as ET
from repro_torch.core import population as pop_t
from repro_torch.core import scenario as scn_t
from repro_torch.core.types import FLConfig
from test_torch_async import _run_both, _same_run, _ulps
from test_torch_engine import _same_ledger
from test_torch_jaxkeys import JaxKey
from test_torch_privacy import models2, two_leaves  # noqa: F401
from test_torch_selection import (SPEC, batch_np, given_local_update,  # noqa: F401
                                  same_tree, to_jax, to_port)

C = 4


def _jax_key(seed):
    return JaxKey(jax.random.PRNGKey(seed))


@pytest.fixture
def jax_keys(monkeypatch):
    monkeypatch.setattr(scn_t, "PRNGKey", _jax_key)


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------

def test_trace_masks_bit_equal(jax_keys):
    """Square, diurnal and static traces at several rates and seeds, 48
    ids each, at rounds 0, 3 and 11."""
    for trace, rate, seed in (("square", 0.5, 0), ("square", 0.3, 4),
                              ("diurnal", 0.5, 1), ("diurnal", 0.8, 7),
                              ("static", 0.6, 2)):
        _trace_case(trace, rate, seed)


def _trace_case(trace, rate, seed):
    ids = np.random.default_rng(seed).choice(10 ** 6, 48, replace=False) \
        .astype(np.int32)
    sj = scn_j.Scenario(trace=trace, period=7.0, seed=seed + 3)
    st = scn_t.Scenario(trace=trace, period=7.0, seed=seed + 3)
    idt = torch.from_numpy(ids)
    np.testing.assert_array_equal(
        scn_t.client_phases(st.seed, idt).numpy(),
        np.asarray(scn_j.client_phases(sj.seed, jnp.asarray(ids))))
    for r in (0, 3, 11):
        want = np.asarray(scn_j.availability_mask(
            sj, seed, rate, jnp.int32(r), jnp.asarray(ids)))
        got = scn_t.availability_mask(st, seed, rate, r, idt)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(r))
        if trace == "diurnal":
            # the reference's rate expression on its own phases
            phi = scn_j.client_phases(sj.seed, jnp.asarray(ids))
            frac = jnp.mod(jnp.float32(r) / jnp.float32(7.0) + phi, 1.0)
            amp = min(rate, 1.0 - rate)
            p = rate + jnp.float32(amp) * jnp.sin(2.0 * np.pi * frac)
            # 2 ULP at the scale of its terms (rate + amp <= 1): p near 0
            # cancels, so ULPs of p itself would overstate sin's error
            np.testing.assert_allclose(
                scn_t.diurnal_prob(st, rate, r, idt).numpy(), np.asarray(p),
                rtol=0, atol=2 * np.spacing(np.float32(1.0)))
    # duty 1.0 is all ones on every trace (the degenerate anchor)
    assert scn_t.availability_mask(st, seed, 1.0, 5, idt).eq(1).all()


def test_survival_draws_bit_equal(jax_keys):
    rng = np.random.default_rng(0)
    res = rng.uniform(0.05, 1.0, (64, 4)).astype(np.float32)
    lat_np = np.array(pipe_j.capability_latency(jnp.asarray(res)))
    ids = rng.choice(10 ** 5, 64, replace=False).astype(np.int32)
    for hazard, seed in ((0.3, 0), (1.5, 5)):
        sj = scn_j.Scenario(dropout=hazard, seed=seed)
        st = scn_t.Scenario(dropout=hazard, seed=seed)
        lat = torch.from_numpy(lat_np)
        assert _ulps(scn_t.survival_prob(st, lat).numpy(),
                     np.asarray(scn_j.survival_prob(sj, lat_np))).max() <= 2
        for r in (0, 9):
            np.testing.assert_array_equal(
                scn_t.survival_mask(st, r, torch.from_numpy(ids),
                                    lat).numpy(),
                np.asarray(scn_j.survival_mask(sj, jnp.int32(r),
                                               jnp.asarray(ids), lat_np)))
        got = [float(scn_t.survival_draw(st, e, int(i), lat[k]))
               for e, (k, i) in enumerate(zip(range(8), ids[:8]))]
        want = [float(scn_j.survival_draw(sj, e, int(i), lat_np[k]))
                for e, (k, i) in enumerate(zip(range(8), ids[:8]))]
        assert got == want


def test_epoch_steps_and_quantile_tracker_exact():
    rng = np.random.default_rng(1)
    for n_c, E, floor in ((4, 2, 0.5), (5, 3, 0.25), (4, 4, 1.0),
                          (5, 4, 0.1)):
        res = rng.uniform(0.05, 1.0, (n_c, 4)).astype(np.float32)
        nj, sj = scn_j.epoch_steps(scn_j.Scenario(epoch_scale=floor), E,
                                   jnp.asarray(res))
        nt, st = scn_t.epoch_steps(scn_t.Scenario(epoch_scale=floor), E,
                                   torch.from_numpy(res))
        assert nt.dtype == torch.int32
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    lat = rng.uniform(0.5, 3.0, 5).astype(np.float32)
    qj, qt = scn_j.quantile_init(lat), scn_t.quantile_init(
        torch.from_numpy(lat))
    assert float(qt) == float(qj)
    for x in rng.uniform(0.0, 4.0, 40).astype(np.float32):
        qj = scn_j.quantile_update(qj, x, 0.7)
        qt = scn_t.quantile_update(qt, torch.tensor(x), 0.7)
        assert float(qt) == float(qj)


def test_scenario_config_matches_reference():
    for kw in (dict(trace="lunar"), dict(availability=0.0),
               dict(dropout=-1.0), dict(epoch_scale=1.5),
               dict(deadline_quantile=1.0), dict(period=0.0)):
        with pytest.raises(ValueError) as want:
            scn_j.Scenario(**kw)
        with pytest.raises(ValueError) as got:
            scn_t.Scenario(**kw)
        assert str(got.value) == str(want.value)
    for kw in (dict(), dict(scenario_trace="square"),
               dict(scenario_availability=0.5), dict(scenario_dropout=0.1),
               dict(scenario_epoch_scale=0.5),
               dict(scenario_deadline_quantile=0.9)):
        sj = scn_j.Scenario.from_fl(FLConfigJax(**kw))
        st = scn_t.Scenario.from_fl(FLConfig(**kw))
        for p in ("diurnal", "availability_on", "enabled"):
            assert getattr(st, p) == getattr(sj, p), (kw, p)


# ---------------------------------------------------------------------------
# the guards and the OFF structure
# ---------------------------------------------------------------------------

def test_guards_match_the_reference():
    mj, mt = models2()
    cases = [(dict(scenario_trace="square"), "async"),
             (dict(scenario_availability=0.5), "async"),
             (dict(scenario_epoch_scale=0.5, local_steps=1), "sim"),
             (dict(scenario_epoch_scale=0.5, local_steps=2,
                   algorithm="scaffold"), "sim")]
    dfn_j = lambda v: to_jax(batch_np(C, v))
    dfn_t = lambda v: to_port(batch_np(C, v))
    for kw, kind in cases:
        topo = "async_" if kind == "async" else "sim"
        with pytest.raises(ValueError) as want:
            EJ.make_round_engine(mj, FLConfigJax(**kw),
                                 getattr(EJ.Topology, topo)(C), chunk=8,
                                 data_fn=dfn_j)
        with pytest.raises(ValueError) as got:
            ET.make_round_engine(mt, FLConfig(**kw),
                                 getattr(ET.Topology, topo)(C), chunk=8,
                                 device="cpu", data_fn=dfn_t)
        assert str(got.value) == str(want.value)


def test_off_path_builds_todays_hops():
    _, mt = models2()
    e = ET.make_round_engine(mt, FLConfig(uplink_compressor=SPEC),
                             ET.Topology.sim(C), chunk=8, device="cpu")
    assert [n for n, _ in e.round_fn.hops] == [
        "rng", "downlink", "local_update", "select", "wire", "server_opt",
        "ledger", "finalize"]
    on = ET.make_round_engine(
        mt, FLConfig(uplink_compressor=SPEC, scenario_dropout=0.1),
        ET.Topology.sim(C), chunk=8, device="cpu")
    assert "scenario_dropout" in [n for n, _ in on.round_fn.hops]


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

E = 3


def _g(q, a, b):
    return (q * a - q * q * b) * 0.05


def _local_steps_j(params, model_batch, k_loc, n_steps=None):
    t = model_batch["tokens"].astype(jnp.float32)
    n = (jnp.full((t.shape[0],), E, jnp.int32) if n_steps is None
         else n_steps)

    def one(p):
        lead = (t.shape[0],) + (1,) * p.ndim
        a = (t[:, 0, 0] / 256.0).reshape(lead)
        b = (t[:, 0, 1] / 512.0).reshape(lead)
        q = jnp.broadcast_to(p[None], (t.shape[0],) + p.shape)
        for k in range(E):
            q = jnp.where((k < n).reshape(lead), q - _g(q, a, b), q)
        return q - p[None]
    return (jax.tree.map(one, params), t[:, 0, 2] / 7.0, t[:, 0, 3] / 5.0)


def _client_updates_steps_t(params, model_batch, control=None,
                            client_controls=None, global_grad=None,
                            clients=None, n_steps=None):
    tokens = model_batch["tokens"]
    cs = list(range(tokens.shape[0]) if clients is None else clients)
    t = tokens[cs].to(torch.float32)
    n = (torch.full((len(cs),), E, dtype=torch.int32) if n_steps is None
         else n_steps[cs])
    deltas = {}
    for name, p in params.items():
        lead = (len(cs),) + (1,) * p.dim()
        a = (t[:, 0, 0] / 256.0).reshape(lead)
        b = (t[:, 0, 1] / 512.0).reshape(lead)
        q = p[None].expand((len(cs),) + tuple(p.shape))
        for k in range(E):
            q = torch.where((k < n).reshape(lead), q - _g(q, a, b), q)
        deltas[name] = q - p[None]
    return deltas, t[:, 0, 2] / 7.0, t[:, 0, 3] / 5.0, None


def _local_steps_t(params, model_batch, clients=None, n_steps=None):
    return _client_updates_steps_t(params, model_batch, clients=clients,
                                   n_steps=n_steps)[:3]


@pytest.fixture
def steps_local_update(monkeypatch):
    """Both packages' dispatch with the step-budgeted given update, and
    the port's root keys (engine, population, scenario) from
    ``jax.random``."""
    real_j, real_t = EJ.make_dispatch, ET.make_dispatch

    def make_j(*a, **kw):
        d = real_j(*a, **kw)
        d.local_update = _local_steps_j
        return d

    def make_t(*a, **kw):
        d = real_t(*a, **kw)
        d.client_updates = _client_updates_steps_t
        d.local_update = _local_steps_t
        return d

    monkeypatch.setattr(EJ, "make_dispatch", make_j)
    monkeypatch.setattr(ET, "make_dispatch", make_t)
    for mod in (ET, AT, pop_t, scn_t):
        monkeypatch.setattr(mod, "PRNGKey", _jax_key)


def test_degenerate_cases_bitexact_with_scenario_free_run(
        steps_local_update):
    """The reference's SCENARIO_CASES, enabled but drawing identity masks
    (duty-1.0 traces, epoch-scale floor 1.0), keep params, comm state and
    ledger of the scenario-free run bit for bit over 3 rounds, E = 3."""
    for c in SCENARIO_CASES:
        _degenerate_case(c)


def _degenerate_case(c):
    _, mt = models2()
    out = []
    for fl_kw in ({}, c["fl"]):
        e = ET.make_round_engine(
            mt, FLConfig(uplink_compressor=c["spec"], local_steps=E,
                         local_lr=0.2, **fl_kw),
            ET.Topology.sim(C), chunk=8, device="cpu")
        st = e.init_fn(0)
        st, ms = ET.run_rounds(e, st, lambda r: to_port(batch_np(C, r)), 3)
        out.append((e, st, ms))
    (_, a, ma), (_, b, mb) = out
    name = c["name"]
    assert ET._fl_scenario(FLConfig(**c["fl"])) is not None, name
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n]), (name, n)
    assert (a.comm_state is None) == (b.comm_state is None), name
    if a.comm_state is not None:
        same_tree(store_to_jax(ST.drop_mask_ctx(b.comm_state)),
                  store_to_jax(ST.drop_mask_ctx(a.comm_state)),
                  f"{name} comm_state")
    for k, v in ma["ledger"].fields().items():
        assert torch.equal(v, mb["ledger"].fields()[k]), (name, k)


def _sim_round(kw, batch):
    mj, mt = models2()
    et = ET.make_round_engine(mt, FLConfig(**kw), ET.Topology.sim(C),
                              chunk=8, device="cpu")
    with jax.disable_jit():
        ej = EJ.make_round_engine(mj, FLConfigJax(**kw), EJ.Topology.sim(C),
                                  chunk=8)
        st_j = ej.init_fn(jax.random.PRNGKey(0))
        st_t = et.state_from_params(params_from_jax(
            jax.tree.map(np.asarray, st_j.params)))
        st_t.rng = JaxKey(st_j.rng)
        st_j, m_j = ej.round_fn(st_j, to_jax(batch))
    st_t, m_t = et.round_fn(st_t, to_port(batch))
    for k in ("loss", "loss_all", "selected"):
        assert float(m_t[k]) == float(m_j[k]), k
    _same_ledger(m_t["ledger"], m_j["ledger"])
    same_tree(params_to_jax(st_t.params), st_j.params, "params")
    same_tree(store_to_jax(ST.drop_mask_ctx(st_t.comm_state)),
              SJ.drop_mask_ctx(st_j.comm_state), "comm_state")
    return m_t


def test_dropout_round_matches_reference(steps_local_update):
    """Hazard 0.5 over the capability latencies (one of the 4 clients
    drops), EF ``topk:0.25>>qsgd:8>>secagg``: the survivors' weights, the
    pre-dropout bill and the masked rows."""
    kw = dict(uplink_compressor=SPEC + ">>secagg", local_steps=E,
              local_lr=0.2, scenario_dropout=0.5, scenario_seed=0)
    m = _sim_round(kw, batch_np(C, 0))
    assert 0 < float(m["selected"]) < C
    per = float(ET.ledger_terms(models2()[1], FLConfig(**kw))[0]["up_wire"])
    assert float(m["ledger"].uplink_wire) == float(np.float32(C)
                                                   * np.float32(per))


def test_trace_and_epoch_scaled_round_matches_reference(steps_local_update):
    """A square trace at duty 0.75 on the dense path and step budgets with
    floor 0.3 at E = 3 (the clients' budgets differ): one round."""
    kw = dict(uplink_compressor=SPEC, local_steps=E, local_lr=0.2,
              scenario_trace="square", scenario_availability=0.75,
              scenario_period=5.0, scenario_epoch_scale=0.3,
              scenario_seed=1)
    b = batch_np(C, 0)
    n, _ = scn_t.epoch_steps(scn_t.Scenario(epoch_scale=0.3), E,
                             torch.from_numpy(b["resources"]))
    assert len(set(n.tolist())) > 1
    _sim_round(kw, b)


def test_async_adaptive_deadline_and_dropout_match_reference(
        given_local_update, jax_keys, two_leaves):
    """FedBuff over 4 slots with K = 4, ``heavy_tail`` latencies, the
    flush deadline tracking the 0.5 completion quantile and dropout hazard
    0.2: the first flush fires on the deadline before the buffer fills;
    event order, q_est, slot latencies, buffer weights and params against
    the reference (the clock within rtol 1e-6, test_torch_async.py's
    ``heavy_tail`` class)."""
    kw = dict(uplink_compressor=SPEC, local_steps=1, local_lr=0.2,
              scenario_deadline_quantile=0.5, scenario_dropout=0.2,
              scenario_seed=2)
    st_j, st_t, ev_j, ev_t, _, _ = _run_both(
        kw, dict(buffer_size=C, latency_profile="heavy_tail"), n_events=8)
    _same_run(st_j, st_t, ev_j, ev_t, clock_rtol=1e-6)
    flushed = [float(m["flushed"]) for _, m, _ in ev_t]
    assert sum(flushed) >= 2 and flushed.index(1.0) < C - 1
    # no clock within 1e-5 of a deadline: its ULPs cannot flip a flush
    assert min(margin for _, _, margin in ev_t) > 1e-5
    for (_, mt, _), (_, mj) in zip(ev_t, ev_j):
        assert float(mt["q_est"]) == float(mj["q_est"])


# ---------------------------------------------------------------------------
# the port's local update under a step budget, the CLI
# ---------------------------------------------------------------------------

def test_client_update_budget_is_a_shorter_run():
    """``_client_update(n_steps=k)`` at E = 3 is the E = k run: the same
    delta, first loss and mean loss (the real model, paper_lm)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model
    model = Model(get_arch("paper_lm"))
    params = model.init(0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (1, 7)).astype(np.int64))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": torch.ones((1, 6))}
    fl3 = FLConfig(local_steps=3, local_lr=0.2)
    fl2 = FLConfig(local_steps=2, local_lr=0.2)
    d3, l3, f3, _ = ET._client_update(model, fl3, params, batch, 8,
                                      n_steps=2)
    d2, l2, f2, _ = ET._client_update(model, fl2, params, batch, 8)
    for n in d2:
        assert torch.equal(d3[n], d2[n]), n
    assert torch.equal(f3, f2) and torch.equal(l3, l2)


def test_cli_scenario_flags_on_cpu(capsys):
    from repro_torch.launch import train
    _, ms = train.main([
        "--device", "cpu", "--clients", "4", "--rounds", "2",
        "--local-steps", "2", "--seq", "4", "--batch-per-client", "1",
        "--compressor", "qsgd:4>>secagg", "--scenario-trace", "square",
        "--scenario-availability", "0.5", "--scenario-period", "3",
        "--scenario-dropout", "0.5", "--scenario-epoch-scale", "0.5"])
    out = capsys.readouterr().out
    assert out.count("round ") == 2
    assert all(0 <= s <= 4 for s in ms["selected"].tolist())
