"""The population slice of the port against the reference: the cohort
samplers, the availability draw, ``ClientPopulation``'s validation, the
``ResidualStore`` under ``drop`` and ``sketch``, the degenerate contract,
a partial cohort through the round program, the dense-build guard and the
CLI.  Inputs come from numpy; the reference's draws reach the port through
:class:`JaxKey` (cohorts, availability, QSGD uniforms) and
``jax_hash_params`` (the tail's hash).

Tolerances:
  * cohort ids, availability masks, ``_coprime_strides``, validation
    messages: exact;
  * the store under ``drop`` (slab, client, stamp, clock, stats, the
    gathered rows): exact;
  * under ``sketch``: client, stamp, clock and stats exact; the tail and
    the gathered rows within rtol 1e-5, with an atol of 1e-5 times the
    largest magnitude of the array (the floor's and gamma's f32 sums are
    reduced in another order, DESIGN.md §6's bounded-ULP class);
  * the degenerate population path against the port's dense path: exact;
  * the partial cohort (32 clients, cohort 8, capacity 12, 3 rounds), run
    through both round programs with numpy-seeded client deltas, losses
    and sizes in place of the local update and the batch (the local update
    itself is held to the reference in test_torch_engine.py), the
    reference compiled with :func:`ieee_jit` (:func:`quick_jit` under
    ``sketch``): under ``drop`` the decoded aggregate, params, slab,
    store bookkeeping and ledger exact; under ``sketch`` client, stamp,
    clock and ledger exact, params and slab at engine scope (rtol 1e-4 /
    atol 1e-6 on >= 99.9% of each array's elements).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import residual_store as rs_jax
from repro.compress import sketch as sk_jax
from repro.configs.registry import get_arch as get_arch_jax
from repro.core import engine as EJ
from repro.core import population as pop_jax
from repro.core import scenario as scn_jax
from repro.core.types import FLConfig as FLConfigJax
from repro.models.model import Model as ModelJax
from repro_torch.compress import residual_store as rs_t
from repro_torch.compress import sketch as sk_t
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_to_jax, store_from_jax, store_to_jax
from repro_torch.core import engine as ET
from repro_torch.core import population as pop_t
from repro_torch.core import scenario as scn_t
from repro_torch.core.types import FLConfig
from repro_torch.models.model import Model
from test_torch_engine import _same_ledger, _tree_np
from test_torch_jaxkeys import JaxKey, ieee_jit, jax_hash_params, quick_jit

SPEC = "topk:0.25>>qsgd:8"
SEQ, B = 16, 2


@functools.lru_cache(maxsize=None)
def _reference_hash_constants(rows, seed):
    with jax.ensure_compile_time_eval():
        a, b = sk_jax.hash_params(rows, seed)
    return np.asarray(a), np.asarray(b)


def _constant_hash_params(rows, seed=17):
    """The reference's own ``hash_params`` values, drawn once outside any
    trace: inside its jitted store they enter as constants, bit-equal to
    the draw, instead of a threefry chain per call (about half of the
    compile time of the sketch store)."""
    return tuple(jnp.asarray(v) for v in _reference_hash_constants(rows,
                                                                   seed))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread: this file's rounds are many small
    ops, which OpenMP threads only slow down when test processes share
    the cores (every comparison here is within one thread setting)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reference_draws(monkeypatch):
    jax_key = lambda seed: JaxKey(jax.random.PRNGKey(seed))
    monkeypatch.setattr(pop_t, "PRNGKey", jax_key)
    monkeypatch.setattr(scn_t, "PRNGKey", jax_key)
    monkeypatch.setattr(sk_t, "hash_params", jax_hash_params)
    monkeypatch.setattr(rs_jax, "hash_params", _constant_hash_params)


# ---------------------------------------------------------------------------
# cohorts, availability, validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,M", [(32, 8), (97, 5), (1_000_000, 16),
                                 (300_000, 10_000)])   # the last: C > 2^31/M
def test_coprime_strides_equal_reference(C, M):
    got, want = pop_t._coprime_strides(C, M), pop_jax._coprime_strides(C, M)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,m,sampler", [(1_000_000, 16, "stride"),
                                         (1000, 10, "shuffle"),
                                         (4, 4, "identity")])
def test_cohort_ids_bit_equal(n, m, sampler):
    pj = pop_jax.ClientPopulation(n_clients=n, cohort=m, seed=3)
    pt = pop_t.ClientPopulation(n_clients=n, cohort=m, seed=3)
    assert pt.sampler == pj.sampler
    assert sampler == "identity" or pt.sampler == sampler
    for r in range(3):
        want = np.asarray(pj.cohort_ids(jnp.int32(r)))
        got = pt.cohort_ids(r, "cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert len(set(want.tolist())) == m and want.max() < n


@pytest.mark.parametrize("rate", [0.3, 1.0])
def test_bernoulli_mask_bit_equal(rate):
    ids = np.array([0, 5, 17, 999_999, 65_536, 123_457, 42, 7], np.int32)
    for r in (0, 4):
        want = np.asarray(scn_jax.bernoulli_mask(3, rate, jnp.int32(r),
                                                 jnp.asarray(ids)))
        got = pop_t.ClientPopulation(n_clients=1_000_000, cohort=8,
                                     availability=rate, seed=3) \
            .availability_mask(r, torch.from_numpy(ids))
        np.testing.assert_array_equal(got.numpy(), want)
    if rate == 1.0:
        assert want.all()


@pytest.mark.parametrize("kw", [
    dict(n_clients=0), dict(n_clients=8, cohort=9),
    dict(n_clients=8, cohort=4, capacity=3),
    dict(n_clients=8, eviction="lru"), dict(n_clients=8, sampler="grid"),
    dict(n_clients=8, availability=0.0), dict(n_clients=8, availability=1.5),
    dict(n_clients=100_000, cohort=8, sampler="shuffle")])
def test_population_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        pop_jax.ClientPopulation(**kw)
    with pytest.raises(ValueError) as got:
        pop_t.ClientPopulation(**kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the store alone
# ---------------------------------------------------------------------------

# two leaves in jax.tree.leaves order; "w" has n = 65,536, so id * n passes
# 2^32 for every id >= 65,536
LEAVES = {"b": (8,), "w": (65_536,)}
# (ids per step): misses into free slots, hits, then LRU evictions, and
# evicted ids coming back (recovered from the tail under "sketch")
STEPS = [(3, 1_000_000, 12), (1_000_000, 7, 65_537),
         (3, 999_999, 1_048_575), (7, 1_000_000, 2_000_000),
         (65_537, 3, 999_999)]


def _stores(eviction):
    kw = dict(eviction=eviction, tail_cols=512)
    sj = rs_jax.ResidualStore(
        EJ.uplink_pipeline(FLConfigJax(uplink_compressor=SPEC)),
        {k: jnp.zeros(s, jnp.float32) for k, s in LEAVES.items()}, 4, **kw)
    st = rs_t.ResidualStore(
        ET.uplink_pipeline(FLConfig(uplink_compressor=SPEC)),
        {k: torch.empty(s) for k, s in LEAVES.items()}, 4, device="cpu",
        **kw)
    return sj, st


def _close(got, want, what, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    atol = rtol * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _same_store(got_t, want_j, exact_floats, what):
    got, want = store_to_jax(got_t), jax.tree.map(np.asarray, want_j)
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    for k in ("client", "stamp", "clock"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")
    for k in ("slab", "tail"):
        for a, e in zip(jax.tree.leaves(got.get(k)),
                        jax.tree.leaves(want.get(k))):
            if exact_floats:
                np.testing.assert_array_equal(a, e, err_msg=f"{what} {k}")
            else:
                _close(a, e, f"{what} {k}")


def _tail_norms(state):
    return [float(t.norm()) for t in rs_t._leaves(state["tail"]) if t.numel()]


@pytest.mark.parametrize("eviction", ["drop", "sketch"])
def test_store_sequence_matches_reference(eviction):
    """gather -> scatter of fresh rows over STEPS: hits, misses, free slots
    and LRU evictions, ids around 10^6 whose ``id * n`` wraps at 2^32."""
    exact = eviction == "drop"
    sj, st = _stores(eviction)
    # compiled once (every step has 3 ids): op-by-op dispatch is slower
    gather_j, scatter_j = quick_jit(sj.gather), quick_jit(sj.scatter)
    state_j, state_t = sj.init(), st.init()
    rng = np.random.default_rng(0)
    evictions = 0
    for step, ids in enumerate(STEPS):
        what = f"{eviction} step {step} ids {ids}"
        ids_j, ids_t = jnp.asarray(ids, jnp.int32), torch.tensor(
            ids, dtype=torch.int32)
        stats_j, stats_t = sj.stats(state_j, ids_j), st.stats(state_t, ids_t)
        for k, v in stats_j.items():
            assert float(stats_t[k]) == float(v), (what, k)
        evictions += int(stats_t["evictions"])
        rows_j, state_j = gather_j(state_j, ids_j)
        rows_t, state_t = st.gather(state_t, ids_t)
        for a, e in zip(jax.tree.leaves(store_to_jax(rows_t)),
                        jax.tree.leaves(rows_j)):
            if exact:
                np.testing.assert_array_equal(a, np.asarray(e), err_msg=what)
            else:
                _close(a, e, f"{what} gathered rows")
        _same_store(state_t, state_j, exact, f"{what} after gather")
        new = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.5)
                           .astype(np.float32), rows_j)
        state_j = scatter_j(state_j, ids_j, jax.tree.map(jnp.asarray, new))
        state_t = st.scatter(state_t, ids_t, store_from_jax(new))
        _same_store(state_t, state_j, exact, f"{what} after scatter")
    assert evictions >= 4
    if eviction == "sketch":
        assert all(n > 0 for n in _tail_norms(state_t))


def test_tail_norm_never_rises_across_gather():
    """The energy-conserving recovery only removes mass from the tail:
    every tail's norm after a gather is at most its norm before (to f32
    rounding), over 12 rounds of 3-id cohorts on a 4-slot store."""
    _, st = _stores("sketch")
    state = st.init()
    rng = np.random.default_rng(1)
    recovered = 0
    for r in range(12):
        ids = torch.from_numpy(rng.choice(10, 3, replace=False)
                               .astype(np.int32) * 400_009)
        before = _tail_norms(state)
        rows, state = st.gather(state, ids)
        after = _tail_norms(state)
        assert all(a <= b * (1 + 1e-6) for a, b in zip(after, before)), \
            (r, before, after)
        recovered += sum(a < b for a, b in zip(after, before))
        rows = rs_t._map(lambda a: a + torch.from_numpy(
            rng.standard_normal(tuple(a.shape)).astype(np.float32)), rows)
        state = st.scatter(state, ids, rows)
    assert recovered > 0


# ---------------------------------------------------------------------------
# through the round program
# ---------------------------------------------------------------------------

def _fl(spec, port, **kw):
    kw = dict(dict(uplink_compressor=spec, local_steps=2, local_lr=0.2), **kw)
    return FLConfig(**kw) if port else FLConfigJax(**kw)


@pytest.mark.parametrize("spec", [SPEC, "qsgd8"])
def test_degenerate_population_bitexact_with_dense(spec):
    """cohort == n_clients == capacity == 4: the population path's params
    and slab equal the dense path's params and EF rows bit for bit."""
    from repro_torch.data.synthetic import FedDataConfig, sample_round
    model = Model(get_arch("paper_lm"))
    fl = _fl(spec, True, backend="kernel")
    pop = pop_t.ClientPopulation(n_clients=4, cohort=4, capacity=4)
    dense = ET.make_round_engine(model, fl, ET.Topology.sim(4), chunk=SEQ,
                                 device="cpu")
    stream = ET.make_round_engine(model, fl, ET.Topology.sim(4), chunk=SEQ,
                                  device="cpu", population=pop)
    assert [h for h, _ in stream.round_fn.hops][:2] == ["rng", "cohort"]
    assert (stream.aux["store"] is None) == (spec == "qsgd8")
    data = FedDataConfig(vocab_size=256, num_clients=4, seq_len=SEQ,
                         batch_per_client=B, heterogeneity=2.0)
    sd, ss = dense.init_fn(0), stream.init_fn(0)
    for r in range(3):
        batch = sample_round(data, r, "cpu")
        sd, md = dense.round_fn(sd, batch)
        ss, ms = stream.round_fn(ss, batch)
        assert torch.equal(md["loss"], ms["loss"])
    for (name, a), b in zip(sd.params.items(), ss.params.values()):
        assert torch.equal(a, b), name
    if spec == "qsgd8":
        assert sd.comm_state is None and ss.comm_state is None
        return
    assert ss.comm_state["client"].tolist() == [0, 1, 2, 3]
    slab = rs_t._leaves(ss.comm_state["slab"])
    dense_rows = rs_t._leaves(sd.comm_state)
    assert len(slab) == len(dense_rows) == 12
    for a, b in zip(dense_rows, slab):
        assert torch.equal(a, b)


def _inject(hops):
    """The round program's hops with the local update replaced by the
    client deltas and losses found in the context under ``given``."""
    def inject(ctx):
        ctx.pop("params")
        deltas, losses, first = ctx.pop("given")
        ctx.update(deltas=deltas, losses=losses, first_losses=first,
                   new_ci=None)
        return ctx
    return [(n, inject if n == "local_update" else fn) for n, fn in hops]


def _run_hops(hops, ctx):
    for _, fn in hops:
        ctx = fn(ctx)
    return ctx


@pytest.mark.parametrize("eviction", ["drop", "sketch"])
def test_partial_cohort_rounds_match_reference(eviction):
    """32 clients, cohort 8 (stride sampler: the shuffle sampler's draw is
    held to the reference above), capacity 12, 3 rounds of EF
    ``topk:0.25>>qsgd:8`` through both round programs from one state, the
    local update replaced by numpy-seeded client deltas, losses and sizes
    (the local update is held to the reference in test_torch_engine.py),
    the reference's keys through JaxKey."""
    mj, mt = ModelJax(get_arch_jax("paper_lm")), Model(get_arch("paper_lm"))
    kw = dict(n_clients=32, cohort=8, capacity=12, eviction=eviction,
              tail_cols=512, sampler="stride")
    popj, popt = pop_jax.ClientPopulation(**kw), pop_t.ClientPopulation(**kw)
    ej = EJ.make_round_engine(mj, _fl(SPEC, False), EJ.Topology.sim(32),
                              chunk=SEQ, population=popj)
    et = ET.make_round_engine(mt, _fl(SPEC, True), ET.Topology.sim(32),
                              chunk=SEQ, device="cpu", population=popt)
    assert et.terms == ej.terms
    assert [h for h, _ in et.round_fn.hops] == [
        "rng", "cohort", "downlink", "local_update", "select", "wire",
        "server_opt", "ledger", "finalize"]
    exact = eviction == "drop"
    # bits are compared under drop only; the sketch tail's reductions run
    # an order of magnitude faster with XLA's fusions
    round_j = (ieee_jit if exact else quick_jit)(
        lambda st, b, given: _run_hops(
            _inject(ej.program.hops),
            {"state": st, "batch": b, "given": given}))
    st_t = et.init_fn(0)
    st_t.rng = JaxKey(jax.random.PRNGKey(0))
    st_j = EJ.FLState(
        params=jax.tree.map(jnp.asarray, params_to_jax(st_t.params)),
        server_opt_state={}, control=None, client_controls=None,
        comm_state=jax.tree.map(jnp.asarray, store_to_jax(st_t.comm_state)),
        rng=jax.random.PRNGKey(0), round=jnp.int32(0), prev_delta=None)
    rng = np.random.default_rng(2)
    for r in range(3):
        ids = popt.cohort_ids(r, "cpu")
        np.testing.assert_array_equal(
            ids.numpy(), np.asarray(popj.cohort_ids(jnp.int32(r))))
        deltas = {n: (rng.standard_normal((8,) + tuple(p.shape)) * 1e-3)
                  .astype(np.float32) for n, p in st_t.params.items()}
        losses = rng.uniform(4.0, 6.0, (2, 8)).astype(np.float32)
        sizes = rng.uniform(1.0, 2.0, 8).astype(np.float32)
        given_j = (params_to_jax({n: torch.from_numpy(v)
                                  for n, v in deltas.items()}),
                   losses[0], losses[1])
        ctx = round_j(st_j, {"sizes": sizes, "ids": ids.numpy()},
                      jax.tree.map(jnp.asarray, given_j))
        st_j, m_j = ctx["new_state"], ctx["metrics"]
        ctx = _run_hops(_inject(et.round_fn.hops), {
            "state": st_t, "batch": {"sizes": torch.from_numpy(sizes),
                                     "ids": ids},
            "given": ({n: torch.from_numpy(v) for n, v in deltas.items()},
                      torch.from_numpy(losses[0]),
                      torch.from_numpy(losses[1]))})
        st_t, m_t = ctx["new_state"], ctx["metrics"]
        what = f"{eviction} round {r}"
        assert st_t.round == int(st_j.round) == r + 1
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=0 if exact else 1e-6, err_msg=what)
        _same_ledger(m_t["ledger"], m_j["ledger"])
        if exact:
            _same_store(st_t.comm_state, st_j.comm_state, True, what)
            for a, e in zip(jax.tree.leaves(params_to_jax(st_t.params)),
                            _tree_np(st_j.params)):
                np.testing.assert_array_equal(a, e, err_msg=what)
            continue
        got, want = store_to_jax(st_t.comm_state), jax.tree.map(
            np.asarray, st_j.comm_state)
        for k in ("client", "stamp", "clock"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=what)
        for a, e in (list(zip(jax.tree.leaves(got["slab"]),
                              jax.tree.leaves(want["slab"])))
                     + list(zip(jax.tree.leaves(params_to_jax(st_t.params)),
                                _tree_np(st_j.params)))):
            close = np.isclose(a, e, rtol=1e-4, atol=1e-6)
            assert close.mean() >= 0.999, (what, close.mean())
    assert int((st_t.comm_state["client"] >= 0).sum()) == 12
    if not exact:
        assert all(n > 0 for n in _tail_norms(st_t.comm_state))


def test_dense_build_guard_matches_reference():
    model, mj = Model(get_arch("paper_lm")), ModelJax(get_arch_jax("paper_lm"))
    C = ET.POPULATION_DENSE_LIMIT + 1
    assert ET.POPULATION_DENSE_LIMIT == EJ.POPULATION_DENSE_LIMIT == 4096
    with pytest.raises(ValueError) as want:
        EJ.make_round_engine(mj, _fl(SPEC, False), EJ.Topology.sim(C))
    with pytest.raises(ValueError) as got:
        ET.make_round_engine(model, _fl(SPEC, True), ET.Topology.sim(C),
                             device="cpu")
    assert str(got.value) == str(want.value)
    # a stateless uplink keeps no per-client rows: a wide dense build is legal
    ET.make_round_engine(model, _fl("qsgd8", True), ET.Topology.sim(C),
                         device="cpu")


def test_cli_population_on_cpu(capsys):
    from repro_torch.compress.residual_store import store_nbytes
    from repro_torch.launch import train
    state, ms = train.main([
        "--device", "cpu", "--population", "1000000", "--cohort", "2",
        "--store-capacity", "4", "--rounds", "2", "--local-steps", "1",
        "--compressor", "topk:0.05>>qsgd:8", "--seq", "8",
        "--batch-per-client", "1", "--backend", "kernel"])
    out = capsys.readouterr().out
    mb = store_nbytes(state.comm_state) / 1e6
    assert (f"population=1,000,000 cohort=2 capacity=4 eviction=drop "
            f"store={mb:.1f}MB") in out
    assert out.count("round ") == 2 and torch.isfinite(ms["loss"]).all()
    assert state.comm_state["client"].tolist()[:2] != [-1, -1]


@pytest.mark.parametrize("flags", [["--scenario-dropout", "0.1"],
                                   ["--scenario-trace", "diurnal"],
                                   ["--scenario-availability", "0.5"]])
def test_cli_rejects_unported_flags(flags):
    """The other ``--scenario-*`` flags, and ``--scenario-availability``
    without ``--population``, raise."""
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match="not ported"):
        train.main(["--device", "cpu"] + flags)


def test_availability_zero_weights_offline_clients():
    """Below full availability the selection hop zero-weights the cohort's
    offline clients (the reference's draw, through JaxKey): the round
    selects exactly the available ones and bills only them."""
    from repro_torch.data.pipeline import cohort_data_fn
    from repro_torch.data.synthetic import FedDataConfig
    model = Model(get_arch("paper_lm"))
    pop = pop_t.ClientPopulation(n_clients=64, cohort=6, availability=0.5,
                                 seed=1)
    eng = ET.make_round_engine(model, _fl(SPEC, True, local_steps=1),
                               ET.Topology.sim(64), chunk=SEQ, device="cpu",
                               population=pop)
    assert dict(eng.round_fn.hops)["select"].__name__ == \
        "hop_select_available"
    data = cohort_data_fn(pop, FedDataConfig(
        vocab_size=256, num_clients=64, seq_len=SEQ, batch_per_client=1),
        "cpu")
    _, m = eng.round_fn(eng.init_fn(0), data(0))
    want = np.asarray(scn_jax.bernoulli_mask(
        1, 0.5, jnp.int32(0), jnp.asarray(pop.cohort_ids(0).numpy())))
    assert 0 < want.sum() < 6
    assert float(m["selected"]) == float(want.sum())
    assert float(m["ledger"].uplink_wire) == float(
        np.float32(want.sum()) * np.float32(eng.terms["up_wire"]))
    assert float(pop.availability_count(0, pop.cohort_ids(0))) == want.sum()
