"""The port's privacy wire (``compress/secure_agg.py``) against the
reference: the ring-mask algebra, the two stages, the grammar's rules and
one masked round on each of the sim, population and async engines.

Inputs are numpy-made; the reference's draws reach the port through
:class:`JaxKey` (``bits`` for the masks, ``normal`` for the noise).  The
engine rounds use test_torch_selection.py's given local update on
paper_lm cut to two leaves of one shape (:func:`models2`), with the
reference run op by op under
``jax.disable_jit()``; the DP noise is then drawn op by op on both sides
(``JaxKey.normal`` is swapped for the eager draw, the reference's
arithmetic for ``erf_inv`` outside a compiled program).

Tolerances:
  * masks, masked planes, their sums over a cohort, the dropout
    correction and the unmasked decode: bit-exact;
  * ``dpnoise:0,inf``: a bit-exact no-op; the clip scale within rtol 1e-6
    (the leaf's L2 norm reduces in another order than XLA's); the noise
    of an unclipped leaf bit-exact (both sides draw it op by op);
  * the engine rounds: params, EF rows (context dropped), async state,
    ledger (``dp_rho`` with it) bit-exact, the clip share (4 / sqrt(2))
    above every leaf's norm, so that the clip scale is exactly 1.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import make_compressor as make_j
from repro.configs.registry import get_arch as get_arch_jax
from repro.compress import secure_agg as SJ
from repro.core import engine as EJ
from repro.core import population as pop_j
from repro.core.types import FLConfig as FLConfigJax
from repro.models.model import Model as ModelJax
from repro_torch.compress import secure_agg as ST
from repro_torch.compress.api import make_compressor as make_t
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_jax, params_to_jax, store_to_jax
from repro_torch.core import engine as ET
from repro_torch.core import population as pop_t
from repro_torch.core.types import FLConfig
from repro_torch.models.model import Model
from test_torch_async import _pop_data, _run_both, _same_run
from test_torch_engine import _same_ledger
from test_torch_jaxkeys import JaxKey
from test_torch_selection import (batch_np, given_local_update,  # noqa: F401
                                  models, same_tree, to_jax, to_port)

DTYPES = [(np.int8, torch.int8), (np.uint8, torch.uint8),
          (np.int32, torch.int32)]
# two leaves of one shape: the reference's op-by-op primitives compile
# once for both (and for every engine test of this file and
# test_torch_scenario.py)
LEAVES2 = ("layers.b0.mixer.wk", "layers.b0.mixer.wv")


def models2():
    """paper_lm's models in both packages, cut to :data:`LEAVES2` (two
    (2, 128, 64) matrices), in ``jax.tree.leaves`` order."""
    mj, mt = ModelJax(get_arch_jax("paper_lm")), Model(get_arch("paper_lm"))
    mixer = mj.defs["layers"]["b0"]["mixer"]
    mj.defs = {"layers": {"b0": {"mixer": {k: mixer[k]
                                           for k in ("wk", "wv")}}}}
    mt.defs = {k: mt.defs[k] for k in LEAVES2}
    return mj, mt


@pytest.fixture
def two_leaves(monkeypatch):
    """test_torch_async.py's runs on :func:`models2`."""
    import test_torch_async
    monkeypatch.setattr(test_torch_async, "models", models2)


def _plane(npdt, n, seed):
    info = np.iinfo(npdt)
    return np.random.default_rng(seed).integers(
        info.min, int(info.max) + 1, n, dtype=np.int64).astype(npdt)


# ---------------------------------------------------------------------------
# mask algebra
# ---------------------------------------------------------------------------

def test_ring_masks_cancel_and_equal_the_reference():
    """Over int8, uint8 and int32 planes: every client's mask and masked
    plane equals the reference's (the port's int64-then-wrap arithmetic
    against XLA's wrapping adds), the masks sum to 0 mod 2^w over the
    cohort, the masked planes' sum equals the clear planes' sum, and a
    cohort missing one client is restored by ``dropout_correction``."""
    for npdt, tdt in DTYPES:
        _ring_masks_case(npdt, tdt)


def _ring_masks_case(npdt, tdt):
    C, n, w = 5, 257, 8 * np.dtype(npdt).itemsize
    key = jax.random.PRNGKey(C * 1000 + n)
    planes = [_plane(npdt, n, s) for s in range(C)]
    masked_t, clear_sum = [], np.zeros(n, np.int64)
    total = np.zeros(n, np.int64)
    for i, x in enumerate(planes):
        want_m = np.asarray(SJ.ring_mask(key, i, C, jnp.asarray(x)))
        got_m = ST.ring_mask(JaxKey(key), i, C, torch.from_numpy(x))
        assert got_m.dtype == tdt
        np.testing.assert_array_equal(got_m.numpy(), want_m)
        total += want_m.astype(np.int64)
        body = {"q": jnp.asarray(x), "s": jnp.ones(3, jnp.float32)}
        want = SJ.mask_payload(body, key, i, C, +1)
        got = ST.mask_payload({"q": torch.from_numpy(x),
                               "s": torch.ones(3)}, JaxKey(key), i, C, +1)
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        assert torch.equal(got["s"], torch.ones(3))       # float side info
        back = ST.mask_payload(got, JaxKey(key), i, C, -1)
        np.testing.assert_array_equal(back["q"].numpy(), x)
        masked_t.append(got["q"].numpy().astype(np.int64))
        clear_sum += x.astype(np.int64)
    mod = 1 << w
    assert np.all(total % mod == 0)
    np.testing.assert_array_equal(sum(masked_t) % mod, clear_sum % mod)
    # one client (d) drops: the survivors' masked sum plus m_d is the
    # survivors' clear sum
    d = 2
    corr = ST.dropout_correction(JaxKey(key), d, C,
                                 {"q": torch.from_numpy(planes[d])})
    want_c = SJ.dropout_correction(key, d, C, {"q": jnp.asarray(planes[d])})
    np.testing.assert_array_equal(corr["q"].numpy(), np.asarray(want_c["q"]))
    part = sum(m for i, m in enumerate(masked_t) if i != d)
    clear = clear_sum - planes[d].astype(np.int64)
    np.testing.assert_array_equal(
        (part + corr["q"].numpy().astype(np.int64)) % mod, clear % mod)


def test_port_key_bits_is_deterministic_full_width_int64():
    from repro_torch.core.rng import Key
    for w in (8, 16, 32):
        a = Key(3).fold_in(w).bits((4096,), w, "cpu")
        assert a.dtype == torch.int64
        assert torch.equal(a, Key(3).fold_in(w).bits((4096,), w, "cpu"))
        assert 0 <= int(a.min()) and int(a.max()) < 1 << w
        assert int(a.max()) >= (1 << w) * 0.99     # the full range
    np.testing.assert_array_equal(
        JaxKey(jax.random.PRNGKey(2)).bits((9,), 16, "cpu").numpy(),
        np.asarray(jax.random.bits(jax.random.PRNGKey(2), (9,), jnp.uint16)))


def test_zero_context_and_one_client_cohort_leave_planes_clear():
    x = torch.from_numpy(_plane(np.int8, 64, 0))
    for coh in (0, 1):
        assert torch.equal(ST.ring_mask(JaxKey(jax.random.PRNGKey(0)), 0,
                                       coh, x), torch.zeros_like(x))
    base, masked = make_t("qsgd:4"), make_t("qsgd:4>>secagg")
    n, r = 3001, JaxKey(jax.random.PRNGKey(1))
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(n)
                         .astype(np.float32))
    pb, _ = base.encode(base.init((n,), "cpu"), r, v)
    pm, _ = masked.encode(masked.init((n,), "cpu"), r, v)
    assert torch.equal(pb["q"], pm["q"])


def test_masked_payload_equals_reference_and_decodes_clear():
    """The masked planes of one client's payload (int8 codes and int32
    indices of ``topk:0.05>>qsgd:4``, the packed uint8 bytes of #5's
    ``ternary@fused`` and #3's ``qsgd:2@fused`` layouts) bit-equal the
    reference's, and the decode equals the clear pipeline's."""
    for spec in ("topk:0.05>>qsgd:4>>secagg", "ternary@fused>>secagg",
                 "qsgd:2@fused>>secagg"):
        _masked_payload_case(spec)


def _masked_payload_case(spec):
    n, C, i = 3001, 4, 1
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    key, r = jax.random.PRNGKey(5), jax.random.PRNGKey(1)
    mj = make_j(spec)
    with jax.disable_jit():
        pj, _ = mj.encode(SJ.inject_mask_ctx(mj.init((n,)), key, i, C), r,
                          jnp.asarray(x))
    mt, bt = make_t(spec), make_t(spec.replace(">>secagg", ""))
    st = ST.inject_mask_ctx(mt.init((n,), "cpu"), JaxKey(key), i, C)
    pt, nst = mt.encode(st, JaxKey(r), torch.from_numpy(x))
    ctx = pt.pop("secagg_ctx")
    assert (ctx["idx"], ctx["cohort"]) == (i, C)
    assert int(nst["mask_idx"]) == i and int(nst["mask_cohort"]) == C
    pj = dict(pj)
    pj.pop("secagg_ctx")
    same_tree(pt, pj, spec)
    pt["secagg_ctx"] = ctx
    pb, _ = bt.encode(bt.init((n,), "cpu"), JaxKey(r), torch.from_numpy(x))
    assert torch.equal(mt.decode(pt, n), bt.decode(pb, n))
    assert mt.wire_bits(n) == mj.wire_bits(n)
    assert mt.entropy_bits(n) == mj.entropy_bits(n) == mt.wire_bits(n)


# ---------------------------------------------------------------------------
# DPNoise
# ---------------------------------------------------------------------------

def _eager_normal(self, shape, device):
    with jax.disable_jit():
        z = np.asarray(jax.random.normal(self.key, tuple(shape),
                                         jnp.float32))
    return torch.from_numpy(z.copy()).to(device)


def test_dpnoise_noop_clip_and_noise(eager_noise):
    """The leaf is (2, 128, 64)-sized, so the noise draws share their
    op-by-op compiles with the engine rounds below."""
    n = 16384
    x = (np.random.default_rng(7).standard_normal(n) * 2.0) \
        .astype(np.float32)
    r = jax.random.fold_in(jax.random.PRNGKey(1), 7)
    xt = torch.from_numpy(x)
    # sigma 0, clip inf: payload, state and decode of the bare pipeline
    base = make_t("topk:0.05>>qsgd:4")
    noop = ST.DPNoise(make_t("topk:0.05>>qsgd:4"), 0.0, float("inf"))
    pb, sb = base.encode(base.init((n,), "cpu"), JaxKey(r), xt)
    pn, sn = noop.encode(noop.init((n,), "cpu"), JaxKey(r), xt)
    lb, ln = jax.tree.leaves(pb), jax.tree.leaves(pn)
    assert len(lb) == len(ln) and all(torch.equal(a, b)
                                      for a, b in zip(lb, ln))
    assert sb == sn and noop.dp_rho_per_round() == 0.0
    assert torch.equal(base.decode(pb, n), noop.decode(pn, n))
    # the clip engaged: 4 leaves, each at clip / 2
    for sigma, clip, L in ((0.0, 2.0, 4), (0.5, 2.0, 4)):
        dj = SJ.DPNoise(make_j("none"), sigma, clip)
        dt = ST.DPNoise(make_t("none"), sigma, clip)
        assert SJ.bind_n_leaves(dj, L) == ST.bind_n_leaves(dt, L) == 1
        with jax.disable_jit():
            want = np.asarray(dj.encode((), r, jnp.asarray(x))[0]["x"])
        got = dt.encode((), JaxKey(r), xt)[0]["x"].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert dt.dp_rho_per_round() == dj.dp_rho_per_round()
        if sigma == 0.0:
            assert float(np.linalg.norm(got.astype(np.float64))) == \
                pytest.approx(clip / math.sqrt(L), rel=1e-5)
    # a leaf under its clip share: the scale is exactly 1, and the noise
    # (the reference's normal, op by op on both sides) is bit-exact
    small = (x * np.float32(1e-3)).astype(np.float32)
    dj = SJ.DPNoise(make_j("none"), 0.8, 1.0)
    dt = ST.DPNoise(make_t("none"), 0.8, 1.0)
    with jax.disable_jit():
        want = np.asarray(dj.encode((), r, jnp.asarray(small))[0]["x"])
    got = dt.encode((), JaxKey(r), torch.from_numpy(small))[0]["x"]
    np.testing.assert_array_equal(got.numpy(), want)


def test_bind_n_leaves_and_zcdp_epsilon():
    spec = "topk:0.05>>qsgd:4>>dpnoise:0.8>>secagg"
    from repro.compress.pipeline import error_feedback as ef_j
    from repro_torch.compress.pipeline import error_feedback as ef_t
    pj, pt = ef_j(make_j(spec)), ef_t(make_t(spec))
    assert ST.bind_n_leaves(pt, 7) == SJ.bind_n_leaves(pj, 7) == 1
    assert pt.inner.inner.n_leaves == 7
    assert ST.bind_n_leaves(make_t("topk:0.05>>qsgd:4"), 3) == 0
    with pytest.raises(ValueError, match=">= 1"):
        ST.bind_n_leaves(pt, 0)
    assert ST.has_mask_ctx(pt) and not ST.has_mask_ctx(make_t("qsgd:4"))
    for rho in (0.0, -1.0, 0.5, 2.0, float("inf")):
        for delta in (1e-5, 1e-3):
            assert ST.zcdp_epsilon(rho, delta) == SJ.zcdp_epsilon(rho, delta)
    assert make_t("qsgd:4>>dpnoise:0.5>>secagg").dp_rho_per_round() == \
        make_j("qsgd:4>>dpnoise:0.5>>secagg").dp_rho_per_round() == 2.0
    from repro.core.engine import ledger_terms as lt_j
    mj, mt = models()
    _, upj, _ = lt_j(mj, FLConfigJax(uplink_compressor=spec))
    _, upt, _ = ET.ledger_terms(mt, FLConfig(uplink_compressor=spec))
    assert upt.inner.inner.n_leaves == upj.inner.inner.n_leaves == 2


# ---------------------------------------------------------------------------
# the grammar
# ---------------------------------------------------------------------------

def _err(fn):
    try:
        fn()
    except (ValueError, KeyError) as e:
        return type(e), str(e)
    raise AssertionError("no error")


REJECTED = (
    lambda mk, S: mk("secagg", fraction=0.05),
    lambda mk, S: mk("topk:0.05>>secagg", fraction=0.05),
    lambda mk, S: mk("sketch:3,512>>secagg"),
    lambda mk, S: mk("randmask:0.1>>secagg"),
    lambda mk, S: mk("qsgd:4>>secagg>>topk:0.1"),
    lambda mk, S: S.SecAgg(mk("qsgd:4>>secagg")),
    lambda mk, S: mk("qsgd:4>>secagg@kernel"),
    lambda mk, S: S.DPNoise(mk("qsgd:4"), 0.5, float("inf")),
    lambda mk, S: mk("qsgd:4>>dpnoise"),
    lambda mk, S: mk("qsgd:4>>secagg:1"),
    lambda mk, S: mk("qsgd:4>>dpnoise:-1"),
    lambda mk, S: mk("qsgd:4>>dpnoise:0.5,0"))


def test_grammar_rejections_match_the_reference():
    """Float carriers (bare, top-k, sketch, RandMask), a stage after a
    privacy stage, a nested secagg, an ``@`` suffix, noise without a
    finite clip, dpnoise without a sigma, secagg with arguments, a
    negative sigma and a zero clip: the reference's error types and
    messages."""
    for i, build in enumerate(REJECTED):
        assert _err(lambda: build(make_t, ST)) == \
            _err(lambda: build(make_j, SJ)), i


def test_grammar_accepts_the_reference_forms():
    for spec in ("qsgd:4>>dpnoise:0.8:2.0", "qsgd:4>>dpnoise:0.8,2.0",
                 "topk:0.05>>qsgd:4>>dpnoise:0.8>>secagg",
                 "qsgd:4>>dpnoise:0>>dpnoise:0.5,3"):
        t, j = make_t(spec), make_j(spec)
        assert t.name == j.name and t.dp_rho_per_round() == \
            j.dp_rho_per_round()
    assert make_t("qsgd:4>>dpnoise:0.8:2.0").clip == 2.0
    a = ET.uplink_pipeline(FLConfig(uplink_compressor="qsgd:4",
                                    dp_sigma=0.8, dp_clip=1.0,
                                    secure_agg=True))
    b = EJ.uplink_pipeline(FLConfigJax(uplink_compressor="qsgd:4",
                                       dp_sigma=0.8, dp_clip=1.0,
                                       secure_agg=True))
    assert a.name == b.name == "qsgd4>>dpnoise:0.8>>secagg"


# ---------------------------------------------------------------------------
# one masked round per engine against the reference
# ---------------------------------------------------------------------------

MASKED = "topk:0.25>>qsgd:8>>dpnoise:0.001,4>>secagg"


@pytest.fixture
def eager_noise(monkeypatch):
    monkeypatch.setattr(JaxKey, "normal", _eager_normal)


def test_masked_sim_round_matches_reference(given_local_update,
                                            eager_noise):
    """4 clients, EF ``topk:0.25>>qsgd:8>>dpnoise:0.001,4>>secagg``, one
    round from the reference's init: params, EF rows and ledger, dp_rho =
    4 x 0.5 / 0.001^2 in f32."""
    C = 4
    mj, mt = models2()
    kw = dict(uplink_compressor=MASKED, local_steps=1, local_lr=0.2)
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
    assert et.terms == ej.terms and et.terms["dp_rho"] == 0.5 / 0.001 ** 2
    _same_ledger(m_t["ledger"], m_j["ledger"])
    assert float(m_t["ledger"].dp_rho) == float(
        np.float32(C) * np.float32(0.5 / 0.001 ** 2))
    same_tree(params_to_jax(st_t.params), st_j.params, "params")
    same_tree(store_to_jax(ST.drop_mask_ctx(st_t.comm_state)),
              SJ.drop_mask_ctx(st_j.comm_state), "EF rows")
    # the injected context: each lane's index, cohort C
    ctx = st_t.comm_state[1]["inner"]
    assert ctx["mask_idx"].tolist() == list(range(C))
    assert ctx["mask_cohort"].tolist() == [C] * C


def test_masked_population_round_matches_reference(given_local_update,
                                                   eager_noise):
    """16 clients, cohort 4, store capacity 8: the mask context rides the
    slab rows (lane = cohort position, cohort 4); two rounds."""
    pop_kw = dict(n_clients=16, cohort=4, capacity=8, seed=2)
    pj, pt = pop_j.ClientPopulation(**pop_kw), pop_t.ClientPopulation(**pop_kw)
    data_j, data_t = _pop_data(pj, pt)
    mj, mt = models2()
    kw = dict(uplink_compressor=MASKED, local_steps=1, local_lr=0.2)
    et = ET.make_round_engine(mt, FLConfig(**kw), ET.Topology.sim(16),
                              chunk=8, device="cpu", population=pt)
    with jax.disable_jit():
        ej = EJ.make_round_engine(mj, FLConfigJax(**kw), EJ.Topology.sim(16),
                                  chunk=8, population=pj)
        st_j = ej.init_fn(jax.random.PRNGKey(0))
        st_t = et.state_from_params(params_from_jax(
            jax.tree.map(np.asarray, st_j.params)))
        led_j = []
        for r in range(2):
            st_j, m = ej.round_fn(st_j, data_j(r))
            led_j.append(m["ledger"])
    for r in range(2):
        st_t, m = et.round_fn(st_t, data_t(r))
        _same_ledger(m["ledger"], led_j[r])
    same_tree(params_to_jax(st_t.params), st_j.params, "params")
    same_tree(store_to_jax(ST.drop_mask_ctx(st_t.comm_state)),
              SJ.drop_mask_ctx(st_j.comm_state), "store")


def test_masked_async_flush_matches_reference(given_local_update,
                                              eager_noise, two_leaves):
    """4 slots, K = 2, ``uniform`` latencies: each flush re-dispatches a
    subset of the slots, which must carry the reference's full-dispatch
    context (lane = slot, cohort 4); dp_rho is billed once per event."""
    kw = dict(uplink_compressor=MASKED, local_steps=1, local_lr=0.2)
    st_j, st_t, ev_j, ev_t, _, _ = _run_both(
        kw, dict(buffer_size=2, latency_profile="uniform"), n_events=6)
    assert sum(float(m["flushed"]) for _, m, _ in ev_t) >= 2
    for _, m, _ in ev_t:
        assert float(m["ledger"].dp_rho) == float(
            np.float32(0.5 / 0.001 ** 2))

    def clear(st, drop):
        A = dict(st.async_state, pending_comm=drop(
            st.async_state["pending_comm"]))
        return dataclasses.replace(st, comm_state=drop(st.comm_state),
                                   async_state=A)
    _same_run(clear(st_j, SJ.drop_mask_ctx), clear(st_t, ST.drop_mask_ctx),
              ev_j, ev_t)
