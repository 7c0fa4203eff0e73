"""(d) and (e): the port's sim round against the reference engine on
paper_lm with the main-path uplinks (EF over ``topk:0.05>>qsgd:8`` and
``topk:0.05>>qsgd:4@fused``), the reference's uniforms injected through
:class:`JaxKey`.

(d) Wire level, 3 rounds of the EF ``topk:0.05>>qsgd:8`` uplink (the
    fused chain's payloads are bit-checked stage by stage in
    test_torch_compress.py): the reference's per-round client deltas go
    through the port's ``wire_rows`` -> ``aggregate_rows`` -> fedavg ->
    ledger.  Decoded rows and EF residuals are bit-exact against the
    reference's ``wire_rows`` compiled with one rounding per op
    (:func:`ieee_jit`; a default CPU jit contracts multiply-adds into FMAs
    and rewrites ``q / L``, DESIGN.md §6's engine-scope class).  The
    aggregate and params are within rtol 1e-6 (the C-sum may be ordered
    differently); the ledger is exact.
(e) End to end, 3 rounds of ``make_sim_step`` with the fused chain (the
    ``qsgd:8`` chain's wire is (d)'s) from the reference's init and
    batches against the reference's jitted round.  Model ULPs between
    the frameworks (and the jitted reference's FMAs) can flip a QSGD floor
    or a top-k threshold element, which moves that coordinate by a whole
    quantization step; EF and the next local solve then carry the flip
    into every later round.  So each round is checked from the
    reference's state (params, EF residuals, rng): loss rtol 1e-5, ledger
    exact, params and EF residuals within rtol 1e-4 / atol 1e-6 on
    >= 99.9% of each leaf's elements, per-leaf update supports overlapping
    >= 99%.  A free-running port run alongside keeps its loss within
    rtol 2e-3 of the reference's and its ledger exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as get_arch_jax
from repro.core import engine as EJ
from repro.core import server_opt as SJ
from repro.core.simulate import make_sim_step as make_sim_step_jax
from repro.core.types import FLConfig as FLConfigJax
from repro.data.synthetic import FedDataConfig, sample_round
from repro.models.model import Model as ModelJax
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import engine as ET
from repro_torch.core import server_opt as ST
from repro_torch.core.simulate import make_sim_step
from repro_torch.core.types import FLConfig
from repro_torch.models.model import Model
from test_torch_jaxkeys import JaxKey, ieee_jit, quick_jit, to_torch

SPECS = ["topk:0.05>>qsgd:8", "topk:0.05>>qsgd:4@fused"]
C, SEQ, B = 2, 16, 2


@functools.lru_cache(maxsize=None)
def local_update_j():
    """The reference's local update (paper_lm, C clients, E = 2, lr 0.2),
    compiled once at optimization level 0: the wire round below and
    test_torch_downlink.py's STC rounds share it."""
    mj = ModelJax(get_arch_jax("paper_lm"))
    flj = _fl(SPECS[0], False)
    _, up, down = EJ.ledger_terms(mj, flj)
    return quick_jit(EJ.make_dispatch(mj, flj, up, down, C, SEQ)
                     .local_update)


def _fl(spec, port, **kw):
    kw = dict(dict(uplink_compressor=spec, local_steps=2, local_lr=0.2), **kw)
    return (FLConfig(backend="kernel", **kw) if port
            else FLConfigJax(backend="jax", **kw))


@functools.lru_cache(maxsize=None)
def _batches(rounds=3):
    d = FedDataConfig(vocab_size=256, num_clients=C, seq_len=SEQ,
                      batch_per_client=B, heterogeneity=2.0)
    return [jax.tree.map(np.asarray, sample_round(
        d, jax.random.fold_in(jax.random.PRNGKey(1), r)))
        for r in range(rounds)]


def _port_batch(b):
    return {k: to_torch(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in b.items()}


def _tree_np(t):
    return [np.asarray(x) for x in jax.tree.leaves(t)]


def _flat_t(d):
    out = []
    for v in (d.values() if isinstance(d, dict) else d):
        out.extend(_flat_t(v) if isinstance(v, (dict, tuple)) else [v])
    return out


def _same_ledger(led_t, led_j):
    for name, v in led_t.fields().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(led_j,
                                                                    name)),
                                      err_msg=f"ledger {name}")


@pytest.mark.parametrize("spec", SPECS[:1])
def test_wire_round_bitexact_against_reference(spec):
    mj, mt = ModelJax(get_arch_jax("paper_lm")), Model(get_arch("paper_lm"))
    flj, flt = _fl(spec, False), _fl(spec, True)
    terms_j, up_j, down_j = EJ.ledger_terms(mj, flj)
    terms_t, up_t, down_t = ET.ledger_terms(mt, flt)
    assert terms_t == terms_j
    disp_j = EJ.make_dispatch(mj, flj, up_j, down_j, C, SEQ)
    disp_t = ET.make_dispatch(mt, flt, up_t, down_t, C, SEQ)
    # the deltas feed both wires: their bits are not compared, so the
    # local update compiles at optimization level 0
    local = local_update_j()
    wire_j = ieee_jit(disp_j.wire_rows)
    agg_rows_j = ieee_jit(disp_j.aggregate_rows)
    apply_j = ieee_jit(functools.partial(SJ.apply, flj))
    params_j = mj.init(jax.random.PRNGKey(0))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j))
    comm_j = EJ.comm_state_init(up_j, params_j, C)
    comm_t = ET.comm_state_init(up_t, params_t, C, "cpu")
    rng = jax.random.PRNGKey(0)
    for r, b in enumerate(_batches()):
        k_loc, _, _, k_up, rng = jax.random.split(rng, 5)
        mb = {k: jnp.asarray(b[k]) for k in ("tokens", "labels", "mask")}
        deltas_j, _, _ = local(params_j, mb, k_loc)
        rows_j, comm_j = wire_j(deltas_j, comm_j, k_up)
        w_j = jnp.asarray(b["sizes"])
        wsum_j = jnp.maximum(w_j.sum(), 1e-9)
        agg_j = agg_rows_j(rows_j, w_j, wsum_j)
        params_j, _ = apply_j(params_j, agg_j, {})
        n_sel = (w_j > 0).sum().astype(jnp.float32)
        led_j = EJ._make_ledger(terms_j, n_sel)

        deltas_t = params_from_jax(jax.tree.map(np.asarray, deltas_j))
        rows_t, comm_t = disp_t.wire_rows(deltas_t, comm_t, JaxKey(k_up))
        w_t = to_torch(b["sizes"])
        wsum_t = torch.clamp(w_t.sum(), min=1e-9)
        agg_t = disp_t.aggregate_rows(rows_t, w_t, wsum_t)
        params_t, _ = ST.apply(flt, params_t, agg_t, {})
        led_t = ET._make_ledger(terms_t, (w_t > 0).sum().to(torch.float32))

        what = f"{spec} round {r}"
        for (name, a), e in zip(rows_t.items(), _tree_np(rows_j)):
            np.testing.assert_array_equal(a.numpy(), e,
                                          err_msg=f"{what} rows {name}")
        res_t, res_j = _flat_t(comm_t), _tree_np(comm_j)
        assert len(res_t) == len(res_j) == 12
        for a, e in zip(res_t, res_j):
            np.testing.assert_array_equal(a.numpy(), e,
                                          err_msg=f"{what} EF residual")
        for (name, a), e in zip(agg_t.items(), _tree_np(agg_j)):
            np.testing.assert_allclose(a.numpy(), e, rtol=1e-6,
                                       err_msg=f"{what} aggregate {name}")
        for (name, a), e in zip(params_t.items(), _tree_np(params_j)):
            np.testing.assert_allclose(a.numpy(), e, rtol=1e-6,
                                       err_msg=f"{what} params {name}")
        _same_ledger(led_t, led_j)


def _port_state(sim_t, st_j):
    """The reference's FLState as the port's: params, EF residuals, the
    round and the rng (as a JaxKey)."""
    st = sim_t.engine.state_from_params(
        params_from_jax(jax.tree.map(np.asarray, st_j.params)))
    st.comm_state = state_from_jax(st.comm_state, _tree_np(st_j.comm_state))
    st.rng, st.round = JaxKey(st_j.rng), int(st_j.round)
    return st


@pytest.mark.parametrize("spec", SPECS[1:])
def test_sim_rounds_match_reference_engine(spec):
    mj, mt = ModelJax(get_arch_jax("paper_lm")), Model(get_arch("paper_lm"))
    sim_j = make_sim_step_jax(mj, _fl(spec, False), C, chunk=SEQ)
    sim_t = make_sim_step(mt, _fl(spec, True), C, chunk=SEQ, device="cpu")
    assert sim_t.terms == sim_j.terms
    st_j = sim_j.init_fn(jax.random.PRNGKey(0))
    free_t = _port_state(sim_t, st_j)
    for r, b in enumerate(_batches()):
        batch_j = {k: jnp.asarray(v) for k, v in b.items()}
        forced_t = _port_state(sim_t, st_j)
        prev = _tree_np(st_j.params)
        st_j, m_j = sim_j.step_fn(st_j, batch_j)
        st_t, m_t = sim_t.step_fn(forced_t, _port_batch(b))
        free_t, m_free = sim_t.step_fn(free_t, _port_batch(b))
        assert st_t.round == free_t.round == int(st_j.round) == r + 1
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m_free["loss"]), float(m_j["loss"]),
                                   rtol=2e-3)
        _same_ledger(m_t["ledger"], m_j["ledger"])
        _same_ledger(m_free["ledger"], m_j["ledger"])
        for (name, a), e, p in zip(st_t.params.items(), _tree_np(st_j.params),
                                   prev):
            what = f"{spec} round {r} {name}"
            a = a.numpy()
            close = np.isclose(a, e, rtol=1e-4, atol=1e-6)
            assert close.mean() >= 0.999, (what, close.mean())
            s_t, s_j = a != p, e != p
            union = max(1, int((s_t | s_j).sum()))
            assert (s_t & s_j).sum() / union >= 0.99, what
        for a, e in zip(_flat_t(st_t.comm_state), _tree_np(st_j.comm_state)):
            close = np.isclose(a.numpy(), e, rtol=1e-4, atol=1e-6)
            assert close.mean() >= 0.999, (f"{spec} round {r} EF residual",
                                           close.mean())


@pytest.mark.parametrize("algorithm,steps,mu", [("fedavg", 1, 0.0),
                                                ("fedprox", 2, 0.1),
                                                ("scaffold", 2, 0.0),
                                                ("feddane", 3, 0.01)])
def test_client_update_matches_reference(algorithm, steps, mu):
    """One client's local solve (the E = 1 fast path, the E-step loop with
    fedprox's proximal term, SCAFFOLD's control-corrected steps and its
    new c_i, FedDANE's corrected steps from a given global gradient;
    fedavg's E = 2 loop runs in the round test above), the controls and
    the global gradient numpy-seeded: deltas within rtol 1e-4 / atol 1e-7,
    and c_i within that tolerance carried through ``c_i - c - delta /
    (E * lr)`` (an error e in delta is e / (E * lr) in c_i)."""
    mj, mt = ModelJax(get_arch_jax("paper_lm")), Model(get_arch("paper_lm"))
    kw = dict(algorithm=algorithm, local_steps=steps, local_lr=0.2,
              fedprox_mu=mu)
    flj, flt = FLConfigJax(**kw), FLConfig(**kw)
    params_j = mj.init(jax.random.PRNGKey(5))
    b = {k: v[0] for k, v in _batches()[0].items()
         if k in ("tokens", "labels", "mask")}
    rng = np.random.default_rng(6)
    tree = lambda: jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32),
        jax.tree.map(np.asarray, params_j))
    control = c_i = gg = None
    if algorithm == "scaffold":
        control, c_i = tree(), tree()
    if algorithm == "feddane":
        gg = tree()
    # XLA's optimization level 0 compiles the solve in about 60% of the
    # time; the comparison is at rtol 1e-4 either way
    d_j, loss_j, _, ci_j = jax.jit(lambda p, c, ci, g: EJ._client_update(
        mj, flj, p, {k: jnp.asarray(v) for k, v in b.items()},
        jax.random.PRNGKey(0), c, ci, SEQ, global_grad=g),
        compiler_options={"xla_backend_optimization_level": 0})(
            params_j, control, c_i, gg)
    port = lambda t: None if t is None else params_from_jax(t)
    d_t, loss_t, _, ci_t = ET._client_update(
        mt, flt, params_from_jax(jax.tree.map(np.asarray, params_j)),
        _port_batch(b), SEQ, port(control), port(c_i), port(gg))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    for (name, a), e in zip(d_t.items(), _tree_np(d_j)):
        np.testing.assert_allclose(a.numpy(), e, rtol=1e-4, atol=1e-7,
                                   err_msg=name)
    assert (ci_t is None) == (ci_j is None)
    if ci_t is not None:
        for (name, a), e, d in zip(ci_t.items(), _tree_np(ci_j),
                                   _tree_np(d_j)):
            bound = (1e-7 + 1e-4 * np.abs(d)) / (steps * 0.2) \
                + 1e-4 * np.abs(e)
            assert (np.abs(a.numpy() - e) <= bound).all(), f"c_i {name}"
