"""The port's flight recorder (``repro_torch.obs``) and checkpoints
against the reference: the per-stage byte specs, ``round_stats`` and its
histograms, the store counters, one telemetry-on sim run with a scenario,
the CLI's trace and its report, and the checkpoint files; then, port
only, telemetry on against off on the four engines.

The engine runs take test_torch_selection.py's given local update (the
step-budgeted form of test_torch_scenario.py for the scenario run) on
paper_lm cut to two leaves, numpy-made batches and the reference's keys
through :class:`JaxKey`; the reference runs op by op under
``jax.disable_jit()``.

Tolerances: every comparison is exact (stage tables as Python floats,
``RoundStats`` and the store counters bit for bit, the reports' text,
the checkpoint bytes).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ckpt_j
from repro.core import engine as EJ
from repro.core.types import CommLedger as CommLedgerJax
from repro.core.types import FLConfig as FLConfigJax
from repro.obs import report as report_j
from repro.obs import telemetry as tel_j
from repro.obs import trace as trace_j
from repro_torch import checkpoint as ckpt_t
from repro_torch.convert import params_from_jax, store_from_jax
from repro_torch.core import engine as ET
from repro_torch.core import population as pop_t
from repro_torch.core.types import CommLedger, FLConfig
from repro_torch.obs import report as report_t
from repro_torch.obs import telemetry as tel_t
from repro_torch.obs import trace as trace_t
from test_torch_jaxkeys import JaxKey, one_torch_thread  # noqa: F401
from test_torch_privacy import models2
from test_torch_scenario import E, steps_local_update  # noqa: F401
from test_torch_selection import (batch_np, given_local_update,  # noqa: F401
                                  models, to_jax, to_port)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

C = 4
SPEC = "topk:0.25>>qsgd:8"


def _stats_np(rs):
    return {f.name: np.asarray(getattr(rs, f.name))
            for f in dataclasses.fields(rs)}


def _same_stats(got, want, what):
    g, w = _stats_np(got), _stats_np(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        assert g[k].dtype == np.float32 and g[k].shape == w[k].shape, \
            (what, k)
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# the static spec and the in-round constructors
# ---------------------------------------------------------------------------

SPEC_CASES = (
    dict(uplink_compressor="topk:0.05>>qsgd:8"),                     # EF
    dict(uplink_compressor="topk:0.05>>qsgd:4@fused"),
    dict(uplink_compressor="topk:0.05>>qsgd:4>>secagg"),
    dict(uplink_compressor="topk:0.05>>qsgd:4>>dpnoise:0.8>>secagg"),
    dict(uplink_compressor="sketch>>qsgd:8"),
    dict(uplink_compressor="stc", topk_fraction=0.01,
         downlink_compressor="lfl8"),
    dict(uplink_compressor="qsgd:8", algorithm="scaffold"),          # 2x
)


def test_telemetry_spec_matches_reference():
    """Slot names and per-unit byte tables for EF, ``@fused``, secagg,
    dpnoise, the sketch, STC with an ``lfl8`` downlink and SCAFFOLD's
    doubled uplink, over paper_lm's 12 leaves; the tables sum to the
    ledger's static terms."""
    from repro.configs.registry import get_arch as get_arch_j
    from repro.models.model import Model as ModelJ
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model
    mj, mt = ModelJ(get_arch_j("paper_lm")), Model(get_arch("paper_lm"))
    for kw in SPEC_CASES:
        fl_j, fl_t = FLConfigJax(telemetry=True, **kw), \
            FLConfig(telemetry=True, **kw)
        terms_j, up_j, down_j = EJ.ledger_terms(mj, fl_j)
        terms_t, up_t, down_t = ET.ledger_terms(mt, fl_t)
        want = EJ._telemetry_spec(fl_j, up_j, down_j, EJ._param_sizes(mj))
        got = ET._telemetry_spec(fl_t, up_t, down_t, mt.param_sizes())
        assert got == tel_t.TelemetrySpec(*dataclasses.astuple(want)), kw
        assert len(got.up_names) >= 1 and len(got.down_names) >= 1
        assert got.up_total() == pytest.approx(terms_t["up_wire"],
                                               rel=1e-12), kw
        assert got.down_total() == pytest.approx(terms_t["down_wire"],
                                                 rel=1e-12), kw
    assert ET._telemetry_spec(FLConfig(), up_t, down_t, [8]) is None


def test_round_stats_and_histograms_bit_equal():
    """``round_stats`` on numpy-seeded values, totals past 2^24 (the
    residual slot is what keeps the sum exact there), staleness exactly on
    every bucket edge, epoch scales exactly on theirs and 1.0; then the
    slots' running f32 sum equals the ledger total."""
    rng = np.random.default_rng(19)
    edges = np.float32(list(tel_j.STALENESS_EDGES))
    tau = np.concatenate([edges, edges - np.float32(0.5), [0.0, 99.0]]) \
        .astype(np.float32)
    tau_w = (rng.uniform(size=tau.shape) > 0.3).astype(np.float32)
    scale = np.concatenate([np.arange(1, 9, dtype=np.float32) / 8,
                            rng.uniform(0.01, 1.0, 9).astype(np.float32)])
    scale_w = (rng.uniform(size=scale.shape) > 0.4).astype(np.float32)
    for t, w in ((tau, None), (tau, tau_w), (tau[3], None)):
        np.testing.assert_array_equal(
            tel_t.staleness_hist(torch.from_numpy(np.asarray(t)),
                                 None if w is None else
                                 torch.from_numpy(w)).numpy(),
            np.asarray(tel_j.staleness_hist(t, w)))
    for w in (None, scale_w):
        np.testing.assert_array_equal(
            tel_t.epoch_scale_hist(torch.from_numpy(scale), None if w is None
                                   else torch.from_numpy(w)).numpy(),
            np.asarray(tel_j.epoch_scale_hist(scale, w)))

    table = tuple(float(v) for v in rng.uniform(4.5e6, 9e6, 4)) + (1234.5,)
    spec_kw = dict(up_names=tuple("abcde"), up_table=table,
                   down_names=("lfl8",), down_table=(float(rng.uniform(
                       1e6, 5e6)),))
    spec_j, spec_t = tel_j.TelemetrySpec(**spec_kw), \
        tel_t.TelemetrySpec(**spec_kw)
    for unit in (np.float32(7.0), np.float32(1.0), np.float32(23.0)):
        up = np.float32(unit * np.float32(sum(table)))       # > 2^24
        down = np.float32(unit * np.float32(spec_kw["down_table"][0]))
        vals = rng.uniform(0.0, 9.0, 6).astype(np.float32)
        store = dict(zip(("hits", "misses", "evictions",
                          "sketch_recovered"), vals[:4]))
        kw = dict(staleness=tau, staleness_weights=tau_w, fill=vals[4],
                  selected=unit, available=vals[5],
                  avail_duty=vals[5] / np.float32(8), dropped=np.float32(1),
                  epoch_scale=scale, epoch_scale_weights=scale_w)
        want = tel_j.round_stats(
            spec_j, CommLedgerJax(*(jnp.float32(v) for v in
                                    (up, up, down, up, down))),
            up_unit=jnp.float32(unit), store={k: jnp.float32(v) for k, v in
                                              store.items()},
            **{k: jnp.asarray(v) for k, v in kw.items()})
        got = tel_t.round_stats(
            spec_t, CommLedger(*(torch.tensor(v) for v in
                                 (up, up, down, up, down))),
            up_unit=torch.tensor(unit), store={k: torch.tensor(v) for k, v
                                               in store.items()},
            **{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()})
        _same_stats(got, want, f"unit {unit}")
        total = torch.zeros((), dtype=torch.float32)
        for s in got.up_stage_bytes:
            total = total + s
        assert total == torch.tensor(up) and up > 2 ** 24
    _same_stats(tel_t.zero_stats(spec_t), tel_j.zero_stats(spec_j), "zero")


@pytest.mark.parametrize("eviction", ["drop", "sketch"])
def test_store_stats_on_converted_store_match_reference(eviction):
    """``ResidualStore.stats`` on one store state in both packages (a free
    slot, resident ids and stamps from numpy), for id sets with hits,
    misses into the free slot and LRU evictions; on
    test_torch_population.py's 4-slot stores, whose reference ops are
    compiled once for both files."""
    from test_torch_population import _stores
    sj, st = _stores(eviction)
    rng = np.random.default_rng(3)
    state_np = jax.tree.map(np.asarray, sj.init())
    client = rng.choice(1 << 20, 4, replace=False).astype(np.int32)
    client[1] = -1
    state_np.update(client=client, stamp=rng.permutation(4).astype(np.int32),
                    clock=np.int32(5))
    state_j = jax.tree.map(jnp.asarray, state_np)
    state_t = store_from_jax(state_np)
    for ids in ([client[0], 77, client[3]], [5, 6, 7],
                [client[2], 9, client[3]]):
        ids = np.int32(ids)
        want = sj.stats(state_j, jnp.asarray(ids))
        got = st.stats(state_t, torch.from_numpy(ids))
        assert {k: float(v) for k, v in got.items()} == \
            {k: float(v) for k, v in want.items()}, ids
        assert all(v.dtype == torch.float32 for v in got.values())
    assert float(got["evictions"]) == 0 and float(want["hits"]) == 2


def test_sim_round_stats_with_scenario_match_reference(steps_local_update):
    """A telemetry-on dense sim run of 2 rounds over 4 clients with a
    square trace, mid-round dropout and step budgets: ``RoundStats`` (the
    stage slots, available, duty, dropped, the epoch-scale histogram)
    and the ledger bit-equal to the reference's every round."""
    kw = dict(uplink_compressor=SPEC, local_steps=E, local_lr=0.2,
              scenario_trace="square", scenario_availability=0.75,
              scenario_period=5.0, scenario_epoch_scale=0.3,
              scenario_dropout=0.5, scenario_seed=1, telemetry=True)
    mj, mt = models2()
    et = ET.make_round_engine(mt, FLConfig(**kw), ET.Topology.sim(C),
                              chunk=8, device="cpu")
    assert [n for n, _ in et.round_fn.hops][-2:] == ["telemetry",
                                                     "finalize"]
    with jax.disable_jit():
        ej = EJ.make_round_engine(mj, FLConfigJax(**kw), EJ.Topology.sim(C),
                                  chunk=8)
        st_j = ej.init_fn(jax.random.PRNGKey(0))
        st_t = et.state_from_params(params_from_jax(
            jax.tree.map(np.asarray, st_j.params)))
        st_t.rng = JaxKey(st_j.rng)
        ms_j = []
        for r in range(2):
            st_j, m = ej.round_fn(st_j, to_jax(batch_np(C, r)))
            ms_j.append(m)
    assert et.aux["telemetry"] == tel_t.TelemetrySpec(
        *dataclasses.astuple(ej.aux["telemetry"]))
    for r in range(2):
        st_t, m = et.round_fn(st_t, to_port(batch_np(C, r)))
        _same_stats(m["round_stats"], ms_j[r]["round_stats"], f"round {r}")
        for k, v in m["ledger"].fields().items():
            assert float(v) == float(getattr(ms_j[r]["ledger"], k)), (r, k)
    rs = m["round_stats"]
    assert float(rs.epoch_scale_hist.sum()) == C


# ---------------------------------------------------------------------------
# the CLI's trace, both reports, the checkpoint files
# ---------------------------------------------------------------------------

def _reference_round_keys(fl_kw, clients):
    """The ``round`` record keys the reference's tracer writes for its sim
    engine's metrics plus the CLI's ``eval_loss`` (the metrics' structure
    from ``jax.eval_shape``: traced, not compiled)."""
    from repro.configs.registry import get_arch
    from repro.data.synthetic import FedDataConfig, sample_round
    from repro.models.model import Model
    model = Model(get_arch("paper_lm"))
    e = EJ.make_round_engine(model, FLConfigJax(**fl_kw),
                             EJ.Topology.sim(clients), chunk=8)
    data = FedDataConfig(vocab_size=256, num_clients=clients, seq_len=8,
                         batch_per_client=1)
    st = jax.eval_shape(e.init_fn, jax.random.PRNGKey(0))
    batch = jax.eval_shape(lambda k: sample_round(data, k),
                           jax.random.PRNGKey(1))
    _, m = jax.eval_shape(e.round_fn, st, batch)
    m = dict(jax.tree.map(lambda s: np.zeros((1,) + s.shape, s.dtype), m),
             eval_loss=np.zeros(1, np.float32))
    return m, e.aux["telemetry"]


def test_cli_trace_validates_and_renders_like_reference(tmp_path, capsys):
    """``train.main(["--device", "cpu", "--trace", ...])``: the trace
    validates under both packages' ``validate_file``, its ``round`` keys
    equal the reference tracer's for the same config, and both reports
    render it to the same text, plain and ``--md``; ``--profile-dir``
    leaves a profiler trace and ``--checkpoint`` the final params."""
    from repro_torch.launch import train
    trace = tmp_path / "run.jsonl"
    argv = ["--device", "cpu", "--rounds", "2", "--clients", "2",
            "--local-steps", "1", "--seq", "8", "--batch-per-client", "1",
            "--compressor", "topk:0.05>>qsgd:8", "--eval-every", "2"]
    # the profiler slows a CPU run several times over: one round of one
    # client under it
    train.main(argv[:2] + ["--rounds", "1", "--clients", "1"] + argv[6:]
               + ["--trace", str(tmp_path / "p.jsonl"), "--profile-dir",
                  str(tmp_path / "prof")])
    assert list((tmp_path / "prof").glob("*.json"))
    state, ms = train.main(argv + ["--trace", str(trace), "--checkpoint",
                                   str(tmp_path / "ckpt.npz")])
    out = capsys.readouterr().out
    assert f"trace: {trace}" in out
    recs_t = trace_t.validate_file(str(trace))
    recs_j = trace_j.validate_file(str(trace))
    assert recs_t == recs_j
    kinds = [r["kind"] for r in recs_t]
    assert kinds[0] == "meta" and kinds.count("stages") == 1
    assert kinds.count("round") == 2 and kinds.count("eval") == 1
    assert kinds.count("checkpoint") == 1
    meta = recs_t[0]
    assert (meta["arch"], meta["topology"], meta["rounds"],
            meta["algorithm"]) == ("paper_lm", "sim", 2, "fedavg")
    spans = [r for r in recs_t if r.get("type") == "span"]
    assert {r["kind"] for r in spans} == {"chunk", "checkpoint"}

    m, spec = _reference_round_keys(
        dict(uplink_compressor="topk:0.05>>qsgd:8", local_steps=1,
             telemetry=True), 2)
    ref = tmp_path / "ref.jsonl"
    tj = trace_j.Tracer(str(ref), meta={})
    tj.emit_rounds(m, spec=spec)
    tj.close()
    ref_recs = trace_j.validate_file(str(ref))
    rounds_t = [r for r in recs_t if r["kind"] == "round"]
    assert list(rounds_t[0]["m"]) == list(ref_recs[-1]["m"])
    assert [r for r in recs_t if r["kind"] == "stages"][0]["up"] == \
        ref_recs[1]["up"]
    # the slots sum to the ledger's wire totals in f32, every round
    for r in rounds_t:
        for slots, total in (("up_stage_bytes", "uplink_wire"),
                             ("down_stage_bytes", "downlink_wire")):
            acc = np.float32(0.0)
            for v in r["m"][f"round_stats.{slots}"]:
                acc = np.float32(acc + np.float32(v))
            assert acc == np.float32(r["m"][f"ledger.{total}"])

    for md in (False, True):
        text_t = report_t.render(report_t.summarize(recs_t), md=md)
        assert text_t == report_j.render(report_j.summarize(recs_j), md=md)
        assert "uplink byte waterfall" in text_t and "eval_loss" in text_t
    assert report_t.main([str(trace), "--md", str(tmp_path / "t.md")]) == 0
    plain_t = capsys.readouterr().out
    assert report_j.main([str(trace), "--md", str(tmp_path / "j.md")]) == 0
    assert capsys.readouterr().out == plain_t.replace("t.md", "j.md")
    assert (tmp_path / "t.md").read_text() == (tmp_path / "j.md").read_text()

    back = ckpt_t.restore(str(tmp_path / "ckpt.npz"), state.params)
    assert all(torch.equal(back[n], p) for n, p in state.params.items())
    assert json.loads(trace.read_text().splitlines()[-1])["kind"] == \
        "checkpoint"


def test_checkpoint_files_cross_both_ways(tmp_path):
    """A port checkpoint restores in the reference and a reference one in
    the port, f32 and bf16 leaves (bf16 as its raw 16-bit pattern, dtype
    ``V2``: the reference hands back ``|V2`` arrays); a shape mismatch
    raises."""
    rng = np.random.default_rng(7)
    tree = {"embed": rng.standard_normal((6, 4)).astype(np.float32),
            "layers": {"b0": {"mixer": {
                "wq": rng.standard_normal((2, 4, 4)).astype(
                    ml_dtypes.bfloat16)}}},
            "final_ln": np.ones(4, ml_dtypes.bfloat16)}
    flat = {"embed": tree["embed"], "final_ln": tree["final_ln"],
            "layers.b0.mixer.wq": tree["layers"]["b0"]["mixer"]["wq"]}
    params = {n: (torch.from_numpy(a.view(np.int16).copy())
                  .view(torch.bfloat16) if a.dtype == ml_dtypes.bfloat16
                  else torch.from_numpy(a.copy())) for n, a in flat.items()}

    ckpt_t.save(str(tmp_path / "port.npz"), params)
    back_j = ckpt_j.restore(str(tmp_path / "port.npz"), tree)
    for a, e in zip(jax.tree.leaves(back_j), jax.tree.leaves(tree)):
        assert a.shape == e.shape and a.tobytes() == e.tobytes()
        assert a.dtype == (np.dtype("V2") if e.dtype == ml_dtypes.bfloat16
                           else e.dtype)

    ckpt_j.save(str(tmp_path / "ref.npz"), tree)
    target = {n: torch.zeros_like(p) for n, p in params.items()}
    back_t = ckpt_t.restore(str(tmp_path / "ref.npz"), target)
    for n, p in params.items():
        assert back_t[n].dtype == p.dtype and torch.equal(back_t[n], p), n
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "ref.npz") as b:
        assert sorted(a) == sorted(b)
        assert all(a[k].dtype == b[k].dtype and a[k].tobytes()
                   == b[k].tobytes() for k in a)
    with pytest.raises(ValueError, match="embed"):
        ckpt_t.restore(str(tmp_path / "ref.npz"),
                       dict(target, embed=torch.zeros(4, 6)))


# ---------------------------------------------------------------------------
# telemetry on against off (port only)
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = tree.fields()
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _pop_data(pop):
    def data_fn(v):
        ids = pop.cohort_ids(v, "cpu")
        b = to_port(batch_np(pop.cohort, v, seed=int(ids[0])))
        return dict(b, ids=ids)
    return data_fn


@pytest.mark.parametrize("engine", ["sim", "population", "async",
                                    "population-async"])
def test_telemetry_on_equals_off(engine, given_local_update):
    """``FLConfig(telemetry=True)`` against the same run without it over 4
    rounds (events) of EF ``topk:0.25>>qsgd:8>>secagg`` with dropout:
    params, pipeline or store state (mask context included), async state,
    every metric and the ledger bit-identical; the stage slots sum to the
    ledger's wire totals in f32 every round; under ``sketch`` the counters
    show the store's misses and evictions."""
    _, mt = models()
    pop, N = None, C
    if engine.startswith("population"):
        pop = pop_t.ClientPopulation(n_clients=64, cohort=C, capacity=6,
                                     eviction="sketch", tail_cols=256)
        N = 64
    data_fn = (_pop_data(pop) if pop is not None
               else lambda v: to_port(batch_np(C, v)))
    topo = (ET.Topology.async_(N, buffer_size=2) if engine.endswith("async")
            else ET.Topology.sim(N))
    runs = []
    for tele in (False, True):
        fl = FLConfig(uplink_compressor=SPEC + ">>secagg", local_steps=1,
                      local_lr=0.2, scenario_dropout=0.3, telemetry=tele)
        e = ET.make_round_engine(mt, fl, topo, chunk=8, device="cpu",
                                 data_fn=data_fn, population=pop)
        st, ms = ET.run_rounds(e, e.init_fn(0), data_fn, 4)
        runs.append((e, st, ms))
    (_, a, ma), (e, b, mb) = runs
    rs = mb.pop("round_stats")
    assert "round_stats" not in ma
    for f in ("params", "server_opt_state", "comm_state", "async_state"):
        x, y = _leaves(getattr(a, f)), _leaves(getattr(b, f))
        assert len(x) == len(y) and all(torch.equal(p, q) for p, q in
                                        zip(x, y)), f
    x, y = _leaves(ma), _leaves(mb)
    assert len(x) == len(y) and all(torch.equal(p, q) for p, q in zip(x, y))
    assert rs.up_stage_bytes.shape == (4, len(e.aux["telemetry"].up_names))
    for i in range(4):
        for slots, total in ((rs.up_stage_bytes, mb["ledger"].uplink_wire),
                             (rs.down_stage_bytes,
                              mb["ledger"].downlink_wire)):
            acc = torch.zeros((), dtype=torch.float32)
            for v in slots[i]:
                acc = acc + v
            assert torch.equal(acc, total[i]), (engine, i)
    if pop is not None:
        assert float(rs.store_misses.sum()) > 0
        assert torch.equal(rs.store_sketch_recovered, rs.store_misses)
    if engine.endswith("async"):
        assert torch.equal(rs.staleness_hist.sum(1), torch.ones(4))
        assert torch.equal(rs.selected, torch.ones(4))
