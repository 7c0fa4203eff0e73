"""The client and server algorithms of the port against the reference:
the FedOpt server step, SCAFFOLD's control variates, FedDANE's gradient
round, CMFL's relevance filter, the held-out eval cadence of
``run_rounds``, FL+HC's clustering and the CLI (paper_lm, 3 clients, seq
16, batch 2).  Inputs come from numpy (batches, trees, controls), the
reference's init or the port's held-out batch; the reference's QSGD
uniforms reach the port through :class:`JaxKey`.  The reference's
programs are compiled once each (one round program per engine case, one
server step per optimizer).

Tolerances:
  * ``server_opt.apply`` (fedavgm, fedadam, fedyogi, 3 steps, with and
    without a staleness) and ``staleness_scale``: exact, against the
    reference compiled with :func:`ieee_jit` (one rounding per op);
  * engine rounds, each from the reference's state (params, EF
    residuals, the algorithm fields via ``convert``, rng, round), the
    reference's round jitted at XLA's optimization level 0: ledger and
    ``selected`` exact (SCAFFOLD's and FedDANE's 2x uplink bill, CMFL's
    reduced count), the loss within rtol 1e-5, and params, ``control``,
    ``client_controls``, ``m`` / ``v``, ``prev_delta`` and EF residuals
    within rtol 1e-4 / atol 1e-6 on >= 99.9% of each leaf's elements
    (test_torch_engine.py's engine-scope class: model ULPs between the
    frameworks can flip a QSGD floor or a top-k element);
  * the eval cadence exact (NaN off the cadence), the eval loss within
    rtol 1e-5 of the reference's ``evaluate`` on the same params and
    eval batch;
  * clustering: exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as get_arch_jax
from repro.core import clustering as CJ
from repro.core import engine as EJ
from repro.core import server_opt as SJ
from repro.core.population import ClientPopulation as PopJax
from repro.core.types import FLConfig as FLConfigJax
from repro.models.model import Model as ModelJax
from repro_torch.configs.registry import get_arch
from repro_torch.convert import (algorithm_state_from_jax,
                                 algorithm_state_to_jax, params_from_jax,
                                 params_to_jax, state_from_jax)
from repro_torch.core import clustering as CT
from repro_torch.core import engine as ET
from repro_torch.core import server_opt as ST
from repro_torch.core.population import ClientPopulation as PopT
from repro_torch.core.types import FLConfig
from repro_torch.data import synthetic as synth_t
from repro_torch.models.model import Model
from test_torch_engine import _flat_t, _port_batch, _same_ledger, _tree_np
from test_torch_jaxkeys import JaxKey, ieee_jit
from test_torch_population import quick_jit

C, SEQ, B = 3, 16, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread (many small ops: OpenMP threads
    only slow them down when test processes share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _models():
    return ModelJax(get_arch_jax("paper_lm")), Model(get_arch("paper_lm"))


@functools.lru_cache(maxsize=None)
def _batch(r):
    """Round ``r``'s batch from numpy: each client's tokens from its own
    unigram table, skewed to another degree per client (non-iid clients:
    in round 1 CMFL at 0.52 keeps clients 0 and 1, whose sign agreement
    clears the threshold by 337 or more of paper_lm's 361,088 coordinates,
    and filters client 2, 1,480 below it),
    labels the next token, the last position masked, dataset sizes in
    [1, 2)."""
    rng, g = np.random.default_rng(100 + r), np.random.default_rng(2)
    tables = [g.dirichlet(np.full(256, a)) for a in (0.02, 0.3, 0.3)]
    tokens = np.stack([rng.choice(256, (B, SEQ), p=t) for t in tables])
    mask = np.ones((C, B, SEQ), np.float32)
    mask[:, :, -1] = 0.0
    return {"tokens": tokens.astype(np.int32),
            "labels": np.roll(tokens, -1, axis=-1).astype(np.int32),
            "mask": mask,
            "sizes": (1.0 + rng.random(C)).astype(np.float32)}


# ---------------------------------------------------------------------------
# the server step
# ---------------------------------------------------------------------------

def _paper_lm_tree(rng, scale):
    return {n: (rng.standard_normal(p.shape) * scale).astype(np.float32)
            for n, p in _models()[1].init(0, "cpu").items()}


@functools.lru_cache(maxsize=None)
def _server_step_j(opt):
    """The reference's server step under :func:`ieee_jit`, compiled once
    per optimizer with the staleness traced: ``staleness=0`` scales the
    innovations by ``(1 + 0)^(-alpha) == 1.0`` exactly, which is the
    unscaled update's arithmetic."""
    flj = FLConfigJax(**_server_kw(opt))
    step = ieee_jit(lambda p, d, s, tau: SJ.apply(flj, p, d, s,
                                                  staleness=tau))
    scale = ieee_jit(lambda t: SJ.staleness_scale(flj, t))
    return step, scale


def _server_kw(opt):
    return dict(server_opt=opt, server_lr=0.05, staleness_alpha=0.7)


@pytest.mark.parametrize("staleness", [None, 2.0])
@pytest.mark.parametrize("opt", ["fedavgm", "fedadam", "fedyogi"])
def test_server_opt_apply_bitexact(opt, staleness):
    """3 server steps on paper_lm-shaped trees, the moments carried
    across; with a staleness the innovations are scaled by
    ``staleness_scale``, which is exact too."""
    flt = FLConfig(**_server_kw(opt))
    step_j, scale_j = _server_step_j(opt)
    tau = np.float32(0.0 if staleness is None else staleness)
    rng = np.random.default_rng(3)
    params_t = {n: torch.from_numpy(v)
                for n, v in _paper_lm_tree(rng, 0.02).items()}
    params_j = params_to_jax(params_t)
    state_t = ST.init_state(opt, params_t)
    state_j = SJ.init_state(opt, params_j)
    assert ST.state_keys(opt) == SJ.state_keys(opt) == sorted(state_t)
    np.testing.assert_array_equal(ST.staleness_scale(flt, tau).numpy(),
                                  np.asarray(scale_j(tau)))
    for k in range(3):
        delta = {n: torch.from_numpy(v) for n, v in
                 _paper_lm_tree(rng, 1e-3 * (k + 1)).items()}
        params_j, state_j = step_j(params_j, params_to_jax(delta), state_j,
                                   tau)
        params_t, state_t = ST.apply(flt, params_t, delta, state_t,
                                     staleness=staleness)
        for a, e in zip(jax.tree.leaves(params_to_jax(params_t)),
                        _tree_np(params_j)):
            np.testing.assert_array_equal(a, e, err_msg=f"{opt} step {k}")
        for key in state_t:
            for a, e in zip(jax.tree.leaves(params_to_jax(state_t[key])),
                            _tree_np(state_j[key])):
                np.testing.assert_array_equal(a, e,
                                              err_msg=f"{opt} {key} {k}")


# ---------------------------------------------------------------------------
# engine rounds
# ---------------------------------------------------------------------------

# (label, FLConfig knobs): SCAFFOLD with FedAdam on the EF top-k wire,
# client 1 given a zero dataset size in round 1 (unselected: it keeps its
# c_i); FedDANE with its prox term, CMFL 0.52 and FedYogi on the dense
# QSGD wire (after top-k, prev_delta is mostly zeros and every client
# falls below the threshold), where round 1 filters a client
ROUND_CASES = (
    ("scaffold+fedadam", dict(algorithm="scaffold", local_steps=2,
                              local_lr=0.2, server_opt="fedadam",
                              server_lr=0.05,
                              uplink_compressor="topk:0.05>>qsgd:8")),
    ("feddane+cmfl+fedyogi", dict(algorithm="feddane", local_steps=2,
                                  local_lr=0.1, fedprox_mu=0.01,
                                  cmfl_threshold=0.52, server_opt="fedyogi",
                                  server_lr=0.05, uplink_compressor="qsgd:8")),
)
# the reference's round context that the port's round is checked against,
# by the hop that makes it (hop_control later overwrites new_ci)
CTX_KEYS = {"dane_gradient": ("global_grad",),
            "local_update": ("deltas", "new_ci")}


def _port_state(engine_t, st_j):
    """The reference's FLState as the port's: params, EF residuals, the
    algorithm fields, the round and the rng (as a JaxKey)."""
    np_j = jax.tree.map(np.asarray, st_j)
    st = engine_t.state_from_params(params_from_jax(np_j.params))
    if st.comm_state is not None:
        st.comm_state = state_from_jax(st.comm_state,
                                       _tree_np(st_j.comm_state))
    for name, v in algorithm_state_from_jax(np_j).items():
        setattr(st, name, v)
    st.rng, st.round = JaxKey(st_j.rng), int(st_j.round)
    return st


def _close(got, want, what):
    for a, e in zip(got, want):
        close = np.isclose(a, e, rtol=1e-4, atol=1e-6)
        assert close.mean() >= 0.999, (what, close.mean())


def _round_ctx_j(engine_j):
    """The reference's round program returning, beside the new state and
    the metrics, the context entries of CTX_KEYS as their hops leave
    them."""
    def run(st, b):
        ctx, seen = {"state": st, "batch": b}, {}
        for name, fn in engine_j.program.hops:
            ctx = fn(ctx)
            seen.update({k: ctx[k] for k in CTX_KEYS.get(name, ())})
        return ctx["new_state"], ctx["metrics"], seen
    return quick_jit(run)


def _checked_hops(hops, ref, e_lr, what):
    """The port's hops with its gradient round and local update checked
    against the reference's context ``ref`` (at engine scope; the new c_i
    within the deltas' tolerance carried through ``- delta / (E * lr)``,
    ``e_lr`` = E * lr), then handed the reference's global gradient,
    deltas and new c_i: the hops after them (CMFL, the wire, the controls,
    the server step) then run on the reference's inputs, so a QSGD code
    that the frameworks' model ULPs flip cannot stand in for a fault
    there."""
    as_t = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree))

    def checked(name, fn):
        def hop(ctx):
            ctx = fn(ctx)
            for k in CTX_KEYS.get(name, ()):
                got = ctx[k]
                assert (got is None) == (ref[k] is None), (what, k)
                if got is not None and k == "new_ci":
                    for a, e, d in zip(jax.tree.leaves(params_to_jax(got)),
                                       _tree_np(ref[k]),
                                       _tree_np(ref["deltas"])):
                        bound = (1e-6 + 1e-4 * np.abs(d)) / e_lr \
                            + 1e-4 * np.abs(e)
                        ok = (np.abs(a - e) <= bound).mean()
                        assert ok >= 0.999, (f"{what} new_ci", ok)
                elif got is not None:
                    _close(jax.tree.leaves(params_to_jax(got)),
                           _tree_np(ref[k]), f"{what} {k}")
                if got is not None:
                    ctx[k] = as_t(ref[k])
            return ctx
        return hop
    return tuple((n, checked(n, fn)) for n, fn in hops)


@pytest.mark.parametrize("label,kw", ROUND_CASES, ids=[c[0] for c in
                                                       ROUND_CASES])
def test_algorithm_rounds_match_reference_engine(label, kw):
    mj, mt = _models()
    ej = EJ.make_round_engine(mj, FLConfigJax(backend="jax", **kw),
                              EJ.Topology.sim(C), chunk=SEQ)
    et = ET.make_round_engine(mt, FLConfig(backend="kernel", **kw),
                              ET.Topology.sim(C), chunk=SEQ, device="cpu")
    assert et.terms == ej.terms
    assert et.terms["up_wire"] == 2 * ET.ledger_terms(
        mt, FLConfig(uplink_compressor=kw["uplink_compressor"]))[0]["up_wire"]
    # the port has no model_batch hop, and a dane_gradient hop only under
    # feddane (the reference's is a no-op otherwise)
    hops = [h for h, _ in et.round_fn.hops]
    want = [h for h, _ in ej.program.hops if h != "model_batch" and (
        h != "dane_gradient" or kw["algorithm"] == "feddane")]
    assert hops == want, (hops, want)
    round_j = _round_ctx_j(ej)
    st_j = quick_jit(ej.init_fn)(jax.random.PRNGKey(0))
    st_t = _port_state(et, st_j)
    for name, v in algorithm_state_to_jax(st_t).items():
        want = getattr(st_j, name)
        assert (v is None) == (want is None), name
        if v is not None:
            assert jax.tree.structure(v) == jax.tree.structure(want), name
    selected = []
    for r in range(2):
        b = dict(_batch(r))
        if kw["algorithm"] == "scaffold" and r == 1:
            b["sizes"] = b["sizes"] * np.array([1, 0, 1], np.float32)
            ci_before = jax.tree.map(np.asarray, st_j.client_controls)
        forced_t = _port_state(et, st_j)
        st_j, m_j, ref = round_j(st_j, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        what = f"{label} round {r}"
        ctx = {"state": forced_t, "batch": _port_batch(b)}
        for _, fn in _checked_hops(et.round_fn.hops, ref,
                                   kw["local_steps"] * kw["local_lr"], what):
            ctx = fn(ctx)
        st_t, m_t = ctx["new_state"], ctx["metrics"]
        assert st_t.round == int(st_j.round) == r + 1
        assert float(m_t["selected"]) == float(m_j["selected"]), what
        selected.append(int(m_t["selected"]))
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5, err_msg=what)
        _same_ledger(m_t["ledger"], m_j["ledger"])
        _close(jax.tree.leaves(params_to_jax(st_t.params)),
               _tree_np(st_j.params), f"{what} params")
        if st_t.comm_state is not None:
            _close([a.numpy() for a in _flat_t(st_t.comm_state)],
                   _tree_np(st_j.comm_state), f"{what} EF residual")
        got = algorithm_state_to_jax(st_t)
        for name, v in got.items():
            if v is not None:
                _close(jax.tree.leaves(v), _tree_np(getattr(st_j, name)),
                       f"{what} {name}")
    # every client at round 0; in round 1 CMFL filters one, or the zero
    # dataset size leaves SCAFFOLD's client 1 out, which keeps its c_i
    assert selected == [C, C - 1], selected
    if kw["algorithm"] == "scaffold":
        for a, e in zip(jax.tree.leaves(algorithm_state_to_jax(st_t)[
                "client_controls"]), jax.tree.leaves(ci_before)):
            np.testing.assert_array_equal(a[1], e[1])


def test_dane_global_gradient_is_the_f32_client_mean(monkeypatch):
    """FedDANE's gradient round over numpy-seeded per-client gradients:
    the port's f32 accumulation in client order against the reference's
    f32 mean over the client dim, within rtol 1e-6 (XLA may order the
    reduction otherwise)."""
    _, mt = _models()
    grads = {n: (np.random.default_rng(8).standard_normal(
        (C,) + tuple(p.shape)) * 1e-2).astype(np.float32)
        for n, p in mt.init(0, "cpu").items()}
    calls = iter(range(C))

    def given(model, params, batch_c, chunk):
        c = next(calls)
        return None, {n: torch.from_numpy(g[c].copy())
                      for n, g in grads.items()}
    monkeypatch.setattr(ET, "_value_and_grad", given)
    fl = FLConfig(algorithm="feddane", uplink_compressor="qsgd:8")
    terms, up, down = ET.ledger_terms(mt, fl)
    disp = ET.make_dispatch(mt, fl, up, down, C, SEQ)
    gg = disp.global_gradient(mt.init(0, "cpu"), _port_batch(_batch(0)))
    want = jax.jit(lambda t: jax.tree.map(
        lambda g: g.astype(jnp.float32).mean(0), t))(grads)
    for n, e in want.items():
        np.testing.assert_allclose(gg[n].numpy(), np.asarray(e), rtol=1e-6,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# the eval cadence
# ---------------------------------------------------------------------------

def _data_t():
    return synth_t.FedDataConfig(vocab_size=256, num_clients=C, seq_len=SEQ,
                                 batch_per_client=B, num_clusters=3)

def test_run_rounds_eval_cadence_and_loss():
    """4 rounds at eval_every=3: the eval loss is on round 2 only (the
    last of the first cadence window, where the pre-round ``round % 3 ==
    2``), NaN elsewhere, and equals the reference's ``evaluate`` on the
    same params and eval batch; the base metrics are there every round."""
    mj, mt = _models()
    fl = FLConfig(uplink_compressor="qsgd:8", local_steps=1, eval_every=5)
    et = ET.make_round_engine(mt, fl, ET.Topology.sim(C), chunk=SEQ,
                              device="cpu")
    assert et.eval_every == 5
    ev_t = synth_t.eval_batch(_data_t(), 99, batch_size=2, device="cpu")
    ev_j = {k: jnp.asarray(v.numpy()) for k, v in ev_t.items()}
    seen = []

    def metrics_fn(st, m):
        seen.append((st.round, {n: p.clone() for n, p in st.params.items()}))
        return dict(m, eval_loss=mt.loss(st.params, ev_t, chunk=SEQ)[0])

    st, ms = ET.run_rounds(et, et.init_fn(0), lambda r: _port_batch(_batch(r)),
                           4, metrics_fn=metrics_fn, eval_every=3)
    assert st.round == 4 and [r for r, _ in seen] == [3]
    ev = ms["eval_loss"].numpy()
    assert ev.shape == (4,) and np.isnan(ev[[0, 1, 3]]).all()
    want = float(quick_jit(lambda p, b: mj.loss(p, b, chunk=SEQ)[0])(
        params_to_jax(seen[0][1]), ev_j))
    np.testing.assert_allclose(ev[2], want, rtol=1e-5)
    assert ms["loss"].shape == (4,) and np.isfinite(ms["loss"].numpy()).all()
    assert ms["ledger"].uplink_wire.shape == (4,)
    # no round of a 1-round run is due: the eval key is there, NaN
    _, ms1 = ET.run_rounds(et, et.init_fn(0),
                           lambda r: _port_batch(_batch(r)), 1,
                           metrics_fn=metrics_fn, eval_every=3)
    assert ms1["eval_loss"].shape == (1,)
    assert np.isnan(ms1["eval_loss"].numpy()).all()
    from repro_torch.core.simulate import evaluate
    assert evaluate(mt, seen[0][1], ev_t, chunk=SEQ) == pytest.approx(
        float(ev[2]), rel=1e-6)


def test_eval_batch_and_client_clusters():
    """The port's held-out batch: (C * batch_size, S) tokens, labels and
    mask as the reference's, from a stream no round's batch shares; the
    ground-truth clusters are client_tables' ``z``."""
    d = _data_t()
    ev = synth_t.eval_batch(d, 99, batch_size=4, device="cpu")
    assert sorted(ev) == ["labels", "mask", "tokens"]
    for k, v in ev.items():
        assert tuple(v.shape) == (C * 4, SEQ), k
    assert torch.equal(ev["labels"], torch.roll(ev["tokens"], -1, dims=-1))
    assert float(ev["mask"][:, -1].abs().sum()) == 0.0
    assert torch.equal(ev["tokens"], synth_t.eval_batch(
        d, 99, batch_size=4, device="cpu")["tokens"])
    rnd = synth_t.sample_round(dataclasses.replace(d, batch_per_client=4),
                               99, "cpu")["tokens"].reshape(C * 4, SEQ)
    assert not torch.equal(ev["tokens"], rnd)
    z = synth_t.client_clusters(d, "cpu")
    assert z.shape == (C,) and int(z.min()) >= 0 and int(z.max()) < 3
    # with no unigram skew, client c's logits are G + P[z_c]
    lg, _ = synth_t.client_tables(dataclasses.replace(d, client_skew=0.0),
                                  "cpu")
    for c in range(C):
        assert [torch.equal(lg[c], lg[k]) for k in range(C)] == \
            [bool(z[c] == z[k]) for k in range(C)]


# ---------------------------------------------------------------------------
# FL+HC clustering, validation, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric,threshold", [("cosine", 0.5), ("l1", 25.0)])
def test_clustering_equals_reference(metric, threshold):
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((3, 40))
    truth = np.array([0, 1, 2, 0, 1, 2, 0, 1])
    X = (centers[truth] + 0.3 * rng.standard_normal((8, 40))).astype(
        np.float32)
    D_t, D_j = CT.pairwise_delta_distance(X, metric), \
        CJ.pairwise_delta_distance(X, metric)
    np.testing.assert_array_equal(D_t, D_j)
    lab_t, lab_j = CT.agglomerate(D_t, threshold), CJ.agglomerate(D_j,
                                                                  threshold)
    np.testing.assert_array_equal(lab_t, lab_j)
    assert CT.adjusted_match(lab_t, truth) == CJ.adjusted_match(lab_j, truth)
    assert len(set(lab_t.tolist())) > 1
    with pytest.raises(ValueError):
        CT.pairwise_delta_distance(X, "l2")


def test_scaffold_with_population_raises_the_reference_message():
    mj, mt = _models()
    kw = dict(algorithm="scaffold", uplink_compressor="qsgd:8")
    with pytest.raises(ValueError) as want:
        EJ.make_round_engine(mj, FLConfigJax(**kw), EJ.Topology.sim(32),
                             population=PopJax(n_clients=32, cohort=4))
    with pytest.raises(ValueError) as got:
        ET.make_round_engine(mt, FLConfig(**kw), ET.Topology.sim(32),
                             device="cpu",
                             population=PopT(n_clients=32, cohort=4))
    assert str(got.value) == str(want.value)


def test_algorithms_compose_with_the_population():
    """FedDANE, CMFL and FedAdam over a streaming population: the port's
    hops are the reference's, and a cohort round runs with the
    population's cohort (the gradient round and the filter over the
    cohort, prev_delta and the moments model-shaped)."""
    mj, mt = _models()
    kw = dict(algorithm="feddane", local_steps=1, local_lr=0.1,
              cmfl_threshold=0.52, server_opt="fedadam", server_lr=0.05,
              uplink_compressor="topk:0.25>>qsgd:8")
    pop = dict(n_clients=64, cohort=C, capacity=6)
    ej = EJ.make_round_engine(mj, FLConfigJax(**kw), EJ.Topology.sim(64),
                              chunk=SEQ, population=PopJax(**pop))
    et = ET.make_round_engine(mt, FLConfig(**kw), ET.Topology.sim(64),
                              chunk=SEQ, device="cpu",
                              population=PopT(**pop))
    assert et.terms == ej.terms
    assert [h for h, _ in et.round_fn.hops] == [
        h for h, _ in ej.program.hops if h != "model_batch"]
    from repro_torch.data.pipeline import cohort_data_fn
    data_fn = cohort_data_fn(et.aux["population"], dataclasses.replace(
        _data_t(), num_clients=64), "cpu")
    st, ms = ET.run_rounds(et, et.init_fn(0), data_fn, 1)
    assert ms["selected"].tolist() == [C] and st.round == 1
    assert np.isfinite(ms["loss"].numpy()).all()
    assert sorted(st.server_opt_state) == ["m", "v"]
    for n, p in st.params.items():
        assert st.prev_delta[n].shape == p.shape
        assert st.server_opt_state["m"][n].shape == p.shape


def test_train_cli_runs_scaffold_fedadam_with_eval(capsys):
    from repro_torch.launch import train
    state, ms = train.main(["--algorithm", "scaffold", "--server-opt",
                            "fedadam", "--eval-every", "2", "--device", "cpu",
                            "--rounds", "2", "--clients", "2", "--seq", "16",
                            "--batch-per-client", "2", "--local-steps", "1",
                            "--compressor", "qsgd:8"])
    out = capsys.readouterr().out
    assert "algorithm=scaffold server_opt=fedadam eval_every=2" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("round")]
    assert len(lines) == 2 and "eval=" not in lines[0]
    ev = float(lines[1].split("eval=")[1])
    assert np.isfinite(ev) and ev == pytest.approx(
        float(ms["eval_loss"][1]), abs=5e-4)
    assert sorted(state.server_opt_state) == ["m", "v"]
    assert state.control is not None and state.client_controls is not None
