"""The STC round of the port against the reference engine: the sim FedAvg
round on paper_lm with an EF STC uplink and an LFL (``lfl8``) downlink,
the reference's draws injected through :class:`JaxKey`.

  * The downlink hop (every leaf QSGD-roundtripped with the same key) is
    bit-exact against the reference's, compiled one rounding per op
    (:func:`ieee_jit`).
  * One round of ``make_sim_step`` from the reference's init against the
    reference's round for EF ``stc`` (0.01) + ``lfl8`` and EF
    ``stc:0.1@fused``: the hops around the local update compiled with
    ``ieee_jit``, the local update (the same for both rounds) compiled
    once at optimization level 0.  Loss and params within rtol 1e-5 (mu
    is a sum in another order, and the local update's matmuls round
    differently), the ledger exact.  An EF residual is an unsent delta, ``p_local - p`` in
    f32: a one-ULP difference in a local step of a parameter near 1 (the
    norm gains) moves it by 1.2e-7 per step, so residuals are held at rtol
    1e-4 and atol 2.5e-7 (two local steps), or 1e-5 of the leaf's scale
    where that is larger — a sent coordinate is the delta minus mu, which
    adds mu's class (the reference's parity harness uses 1e-5 of scale).
  * The train CLI runs ``--compressor stc --downlink lfl8`` on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as get_arch_jax
from repro.core import engine as EJ
from repro.core.simulate import make_sim_step as make_sim_step_jax
from repro.models.model import Model as ModelJax
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import engine as ET
from repro_torch.core.simulate import make_sim_step
from repro_torch.launch import train
from repro_torch.models.model import Model
from test_torch_engine import C, SEQ, _batches, _fl, _port_batch, \
    _port_state, _same_ledger, _tree_np, local_update_j
from test_torch_jaxkeys import JaxKey, ieee_jit
from test_torch_jaxkeys import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROUNDS = {"stc_lfl8": dict(spec="stc", downlink_compressor="lfl8",
                           topk_fraction=0.01),
          "stc_fused": dict(spec="stc:0.1@fused")}


def _models():
    return ModelJax(get_arch_jax("paper_lm")), Model(get_arch("paper_lm"))


def test_downlink_hop_bitexact_and_ledger_terms():
    mj, mt = _models()
    flj = _fl("stc", False, downlink_compressor="lfl8")
    flt = _fl("stc", True, downlink_compressor="lfl8")
    terms_j, up_j, down_j = EJ.ledger_terms(mj, flj)
    terms_t, up_t, down_t = ET.ledger_terms(mt, flt)
    assert terms_t == terms_j and terms_t["down_wire"] < terms_t["dense"]
    params_j = mj.init(jax.random.PRNGKey(0))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j))
    key = jax.random.split(jax.random.PRNGKey(4), 5)[1]
    disp_j = EJ.make_dispatch(mj, flj, up_j, down_j, C, SEQ)
    disp_t = ET.make_dispatch(mt, flt, up_t, down_t, C, SEQ)
    got = disp_t.downlink(params_t, JaxKey(key))
    want = ieee_jit(disp_j.downlink)(params_j, key)
    changed = 0
    for (name, a), e, p in zip(got.items(), _tree_np(want), params_t.values()):
        np.testing.assert_array_equal(a.numpy(), e, err_msg=name)
        assert a.dtype == p.dtype, name
        changed += not torch.equal(a, p)
    assert changed >= 8          # the constant norm gains quantize exactly


def _round_j(engine, state, batch):
    """The reference's round program: the hops before and after the local
    update each as one :func:`ieee_jit` program, the local update
    test_torch_engine.py's :func:`local_update_j` (optimization level 0,
    compiled once: like the port's own, its deltas round their matmuls
    differently from an ``ieee_jit`` round, which the tolerances below
    already take)."""
    hops = engine.program.hops
    i = [n for n, _ in hops].index("local_update")

    def run(part, ctx):
        for _, fn in part:
            ctx = fn(ctx)
        return ctx
    ctx = ieee_jit(lambda st, b: run(hops[:i], {"state": st, "batch": b}))(
        state, batch)
    deltas, losses, first = local_update_j()(ctx["params"],
                                             ctx["model_batch"], ctx["rng"])
    ctx.update(deltas=deltas, losses=losses, first_losses=first, new_ci=None)
    ctx = ieee_jit(lambda c: run(hops[i + 1:], c))(ctx)
    return ctx["new_state"], ctx["metrics"]


@pytest.mark.parametrize("case", sorted(ROUNDS))
def test_stc_round_matches_reference_engine(case):
    kw = dict(ROUNDS[case])
    spec = kw.pop("spec")
    mj, mt = _models()
    sim_j = make_sim_step_jax(mj, _fl(spec, False, **kw), C, chunk=SEQ)
    sim_t = make_sim_step(mt, _fl(spec, True, **kw), C, chunk=SEQ,
                          device="cpu")
    assert sim_t.terms == sim_j.terms
    st_j = sim_j.init_fn(jax.random.PRNGKey(0))
    st_t = _port_state(sim_t, st_j)
    b = _batches()[0]
    st_j, m_j = _round_j(sim_j.engine, st_j,
                         {k: jnp.asarray(v) for k, v in b.items()})
    st_t, m_t = sim_t.step_fn(st_t, _port_batch(b))
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)
    _same_ledger(m_t["ledger"], m_j["ledger"])
    for (name, a), e in zip(st_t.params.items(), _tree_np(st_j.params)):
        np.testing.assert_allclose(a.numpy(), e, rtol=1e-5, atol=1e-7,
                                   err_msg=f"{case} params {name}")
    res_t, res_j = _leaves(st_t.comm_state), _tree_np(st_j.comm_state)
    assert len(res_t) == len(res_j) == 12
    for a, e in zip(res_t, res_j):
        atol = max(2.5e-7, 1e-5 * float(np.abs(e).max()))
        np.testing.assert_allclose(a.numpy(), e, rtol=1e-4, atol=atol,
                                   err_msg=f"{case} EF residual")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for v in tree for x in _leaves(v)]


def test_train_cli_runs_stc_with_lfl8_downlink(capsys):
    _, ms = train.main(["--device", "cpu", "--compressor", "stc",
                        "--downlink", "lfl8", "--rounds", "2", "--clients",
                        "2", "--seq", "16", "--batch-per-client", "2"])
    out = capsys.readouterr().out
    assert "uplink=stc downlink=lfl8" in out and "round   1" in out
    assert bool(torch.isfinite(ms["loss"]).all())
    mt = Model(get_arch("paper_lm"))
    down = 2 * sum(8 * n + 32 * -(-n // 2048) for n in mt.param_sizes()) / 8
    np.testing.assert_array_equal(ms["ledger"].downlink_wire.numpy(),
                                  np.float32(down))
