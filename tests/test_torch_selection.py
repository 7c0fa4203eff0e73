"""Client selection in the port against the reference: ``_top_m_mask``'s
tie order, every policy's weights, one sync round per policy through
both round engines, the FedMCCS ``resources`` draw and the CLI.

The round engines run with a given local update (``given_local_update``):
each client's delta is an elementwise function of the broadcast params
and two scalars of its own tokens, and its losses a third one, the same
arithmetic in both packages.  The local update itself is held to the
reference in test_torch_engine.py; here the selection, wire, aggregation,
server step and ledger are what is compared, so the model is paper_lm cut
to two of its leaves (``LEAVES``: the engines read only the parameter
structure).  Batches are numpy-made; the reference's keys reach the port
through :class:`JaxKey`.  The reference runs op by op
(``jax.disable_jit``): XLA compiles each primitive on its own, so no two
ops contract into an FMA, as under :func:`ieee_jit` (no primitive on
this path is one that XLA expands into a polynomial), and each primitive
compiles once for every configuration of the module.

Tolerance: none.  Masks, weights, params, EF residuals, losses,
``selected`` and the ledger are bit-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as get_arch_jax
from repro.core import engine as EJ
from repro.core import selection as sel_j
from repro.core.types import FLConfig as FLConfigJax
from repro.models.model import Model as ModelJax
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_jax, params_to_jax, store_to_jax
from repro_torch.core import async_engine as AT
from repro_torch.core import engine as ET
from repro_torch.core import population as pop_t
from repro_torch.core import selection as sel_t
from repro_torch.core.types import FLConfig
from repro_torch.data import synthetic as synth_t
from repro_torch.models.model import Model
from test_torch_engine import _same_ledger, _tree_np
from test_torch_jaxkeys import JaxKey, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SPEC = "topk:0.25>>qsgd:8"
LEAVES = ("final_ln", "layers.b0.mixer.wk")
POLICIES = ("random", "power_of_choice", "multi_criteria")


def models():
    """paper_lm's models in both packages, cut to :data:`LEAVES` (a norm
    of ones and a (2, 128, 64) matrix), in ``jax.tree.leaves`` order."""
    mj, mt = ModelJax(get_arch_jax("paper_lm")), Model(get_arch("paper_lm"))
    mj.defs = {"final_ln": mj.defs["final_ln"],
               "layers": {"b0": {"mixer": {
                   "wk": mj.defs["layers"]["b0"]["mixer"]["wk"]}}}}
    mt.defs = {k: mt.defs[k] for k in LEAVES}
    return mj, mt


def batch_np(C, version, seed=0):
    """Generation ``version``'s batch for C clients: tokens (C, 1, 4)
    drawn per version, sizes in [1, 2) and resources in [0.05, 1) the
    same every version (as ``sample_round``'s)."""
    fixed = np.random.default_rng(seed)
    sizes = fixed.uniform(1.0, 2.0, C).astype(np.float32)
    resources = fixed.uniform(0.05, 1.0, (C, 4)).astype(np.float32)
    toks = np.random.default_rng([seed, int(version)]).integers(
        0, 256, (C, 1, 4)).astype(np.int32)
    return {"tokens": toks, "sizes": sizes, "resources": resources}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_port(b):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v.copy()) for k, v in b.items()}


def _given(p, t, lead):
    """Client deltas of leaf ``p`` from each client's tokens ``t`` (n, B,
    S) as f32: ``(p * a - p * p * b) * 0.05`` with a = t0 / 256 and
    b = t1 / 512; written once for both packages' arrays."""
    a = (t[:, 0, 0] / 256.0).reshape(lead)
    b = (t[:, 0, 1] / 512.0).reshape(lead)
    return (p[None] * a - p[None] * p[None] * b) * 0.05


def _local_j(params, model_batch, k_loc):
    t = model_batch["tokens"].astype(jnp.float32)
    deltas = jax.tree.map(
        lambda p: _given(p, t, (t.shape[0],) + (1,) * p.ndim), params)
    return deltas, t[:, 0, 2] / 7.0, t[:, 0, 3] / 5.0


def _client_updates_t(params, model_batch, control=None,
                      client_controls=None, global_grad=None, clients=None):
    tokens = model_batch["tokens"]
    cs = list(range(tokens.shape[0]) if clients is None else clients)
    t = tokens[cs].to(torch.float32)
    deltas = {n: _given(p, t, (t.shape[0],) + (1,) * p.dim())
              for n, p in params.items()}
    return deltas, t[:, 0, 2] / 7.0, t[:, 0, 3] / 5.0, None


def _local_t(params, model_batch, clients=None):
    return _client_updates_t(params, model_batch, clients=clients)[:3]


@pytest.fixture
def given_local_update(monkeypatch):
    """Both packages' ``make_dispatch`` with the given local update, and
    the port's root keys drawn by ``jax.random``."""
    real_j, real_t = EJ.make_dispatch, ET.make_dispatch

    def make_j(*a, **kw):
        d = real_j(*a, **kw)
        d.local_update = _local_j
        return d

    def make_t(*a, **kw):
        d = real_t(*a, **kw)
        d.client_updates, d.local_update = _client_updates_t, _local_t
        return d

    monkeypatch.setattr(EJ, "make_dispatch", make_j)
    monkeypatch.setattr(ET, "make_dispatch", make_t)
    jax_key = lambda seed: JaxKey(jax.random.PRNGKey(seed))
    for mod in (ET, AT, pop_t):
        monkeypatch.setattr(mod, "PRNGKey", jax_key)


def same_tree(got, want, what):
    g, w = jax.tree.leaves(got), _tree_np(want)
    assert len(g) == len(w), what
    for a, e in zip(g, w):
        np.testing.assert_array_equal(np.asarray(a), e, err_msg=what)


# ---------------------------------------------------------------------------
# the selection functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scores,m", [
    (np.ones(10, np.float32), 3),
    (np.array([1.0, 2.0, 2.0, 2.0, 0.5], np.float32), 2),
    (np.array([-np.inf, 3.0, -np.inf, 3.0, 3.0, 1.0], np.float32), 2),
    (np.repeat(np.float32([0.25, 0.75]), 8), 11)])
def test_top_m_mask_breaks_ties_like_lax_top_k(scores, m):
    want = np.asarray(sel_j._top_m_mask(jnp.asarray(scores), m))
    got = sel_t._top_m_mask(torch.from_numpy(scores), m)
    assert got.dtype == torch.float32 and float(got.sum()) == m
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("policy", ("all",) + POLICIES)
def test_select_weights_bit_equal(policy):
    """Each policy's weights for several seeds and cohort shapes, with and
    without an availability mask, tied losses and tied resource scores
    among them."""
    for seed, (C, m) in enumerate([(8, 2), (8, 3), (4, 1), (4, 4),
                                   (8, 0)]):
        rng = np.random.default_rng(seed)
        losses = rng.integers(0, 4, C).astype(np.float32)     # ties
        res = rng.choice(np.float32([0.25, 0.5, 1.0]), (C, 4))
        sizes = rng.uniform(1.0, 2.0, C).astype(np.float32)
        avail = (rng.random(C) < 0.7).astype(np.float32)
        key = jax.random.fold_in(jax.random.PRNGKey(3), seed)
        kw = dict(selection=policy, clients_per_round=m)
        for av in (None, avail):
            with jax.disable_jit():
                want = np.asarray(sel_j.select(
                    FLConfigJax(**kw), key, losses=jnp.asarray(losses),
                    resources=jnp.asarray(res), sizes=jnp.asarray(sizes),
                    availability=None if av is None else jnp.asarray(av)))
            got = sel_t.select(
                FLConfig(**kw), JaxKey(key), losses=torch.from_numpy(losses),
                resources=torch.from_numpy(res),
                sizes=torch.from_numpy(sizes),
                availability=None if av is None else torch.from_numpy(av))
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{policy} {seed} {C} {m}")
            if policy != "all" and av is None and 0 < m < C:
                assert int((got > 0).sum()) == m


# ---------------------------------------------------------------------------
# one sync round per policy through both engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_sync_round_matches_reference_engine(policy, given_local_update):
    """4 clients, 1 per round (power_of_choice's candidate set is 2), EF
    ``topk:0.25>>qsgd:8``, E=1: one round from the reference's init, the
    port's round program against the reference's."""
    C, m = 4, 1
    mj, mt = models()
    kw = dict(uplink_compressor=SPEC, local_steps=1, local_lr=0.2,
              selection=policy, clients_per_round=m)
    et = ET.make_round_engine(mt, FLConfig(**kw), ET.Topology.sim(C),
                              chunk=8, device="cpu")
    b = batch_np(C, 0)
    with jax.disable_jit():
        ej = EJ.make_round_engine(mj, FLConfigJax(**kw), EJ.Topology.sim(C),
                                  chunk=8)
        st_j = ej.init_fn(jax.random.PRNGKey(0))
        st_t = et.state_from_params(params_from_jax(
            jax.tree.map(np.asarray, st_j.params)))
        st_t.rng = JaxKey(st_j.rng)
        st_j, m_j = ej.round_fn(st_j, to_jax(b))
    st_t, m_t = et.round_fn(st_t, to_port(b))
    assert et.terms == ej.terms
    assert float(m_t["selected"]) == float(m_j["selected"]) == m
    for k in ("loss", "loss_all", "selected"):
        assert float(m_t[k]) == float(m_j[k]), k
    _same_ledger(m_t["ledger"], m_j["ledger"])
    same_tree(params_to_jax(st_t.params), st_j.params, f"{policy} params")
    same_tree(store_to_jax(st_t.comm_state), st_j.comm_state,
              f"{policy} EF residuals")
    # the unselected clients' EF rows advanced too (every slot encodes)
    assert st_t.comm_state[1]["residual"].abs().sum(dim=(1, 2, 3)).gt(0) \
        .all()


# ---------------------------------------------------------------------------
# the FedMCCS resources draw, the CLI
# ---------------------------------------------------------------------------

def test_resources_draw_shape_range_and_stream():
    """``sample_round``'s and ``sample_cohort``'s ``resources``: (C, 4)
    f32 in [0.05, 1), the same every round, a client's the same in every
    cohort, and drawn from a stream of their own (the round's tokens and
    sizes are those of the draw without them)."""
    cfg = synth_t.FedDataConfig(vocab_size=64, num_clients=6, seq_len=5,
                                batch_per_client=2, seed=3)
    r0, r1 = (synth_t.sample_round(cfg, r, "cpu") for r in (0, 1))
    res = r0["resources"]
    assert res.shape == (6, 4) and res.dtype == torch.float32
    assert float(res.min()) >= 0.05 and float(res.max()) < 1.0
    assert torch.equal(res, r1["resources"])
    assert not torch.equal(r0["tokens"], r1["tokens"])
    g = synth_t._gen(cfg.seed, 1_000, torch.device("cpu"))
    plain = synth_t._sample(cfg, g, torch.device("cpu"))
    assert torch.equal(plain["tokens"], r0["tokens"])
    assert torch.equal(plain["sizes"], r0["sizes"])
    c0 = synth_t.sample_cohort(cfg, 0, torch.tensor([5, 2, 900]), "cpu")
    c1 = synth_t.sample_cohort(cfg, 4, torch.tensor([900, 7]), "cpu")
    assert c0["resources"].shape == (3, 4)
    assert torch.equal(c0["resources"][2], c1["resources"][0])
    assert float(c0["resources"].min()) >= 0.05


def test_cli_selection_on_cpu(capsys):
    from repro_torch.launch import train
    spec = "topk:0.05>>qsgd:8"
    _, ms = train.main([
        "--device", "cpu", "--clients", "6", "--selection",
        "power_of_choice", "--clients-per-round", "2", "--rounds", "2",
        "--local-steps", "1", "--compressor", spec, "--seq", "8",
        "--batch-per-client", "1"])
    out = capsys.readouterr().out
    assert "selection=power_of_choice" in out
    assert out.count("selected=2 ") == 2
    assert ms["selected"].tolist() == [2.0, 2.0]
    # the uplink bills the 2 selected clients, not the 6
    terms, _, _ = ET.ledger_terms(Model(get_arch("paper_lm")),
                                  FLConfig(uplink_compressor=spec))
    assert ms["ledger"].uplink_wire.tolist() == [
        float(np.float32(2) * np.float32(terms["up_wire"]))] * 2
