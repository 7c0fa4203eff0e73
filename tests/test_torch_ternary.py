"""The STC family of the port against the reference: the ternarize,
ternarize-pack, pack and unpack kernels' plain versions against the
reference's Pallas kernels in interpret mode, ``pack2`` / ``unpack2``, the
ternary / STC rows of ``tests/parity_cases.py``, and DGC's
``MomentumCorrection``.  Inputs come from numpy; QSGD-free, so no key
injection is needed except for the chain's fold-ins.

Tolerances (DESIGN.md §6's classes):
  * codes, packed bytes, supports, pcnt, ``wire_bits`` / ``entropy_bits``
    and every DGC output: exact;
  * ``psum``: rtol 1e-6 — a row sum in another order than XLA's;
  * mu, decodes and EF residuals of the ternary cases: the case's ``tol``
    (1e-5), relative to the input scale as in the reference's own harness.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_cases import CHAIN_CASES, FUSED_CASES, STAGE_CASES, \
    WRAPPER_CASES, build
from repro.compress import wire_format as wf_jax
from repro.core import engine as EJ
from repro.core.types import FLConfig as FLConfigJax
from repro.kernels import bitpack as bp_jax
from repro.kernels import ops as ops_jax
from repro.kernels import ternary as tern_jax
from repro_torch.compress import make_compressor
from repro_torch.compress import wire_format as wf_t
from repro_torch.compress.pipeline import error_feedback
from repro_torch.convert import state_from_jax
from repro_torch.core import engine as ET
from repro_torch.core.types import FLConfig
from repro_torch.kernels import bitpack, ops, ternary
from test_torch_jaxkeys import JaxKey, ieee_jit, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZES = (1, 100, 2049, 5000, 16384)


def _x(n, seed):
    x = (np.random.default_rng(seed).standard_normal(n) * 2.0) \
        .astype(np.float32)
    x[::7] = 0.0                 # exact zeros and negative zeros code 0
    x[3::11] = -0.0
    return x


def _grid(a, block, dtype):
    """The reference's blocked layout: rows padded to its 8-row grid."""
    rows = -(-max(1, -(-a.shape[0] // block)) // 8) * 8
    out = np.zeros(rows * block, dtype)
    out[:a.shape[0]] = a
    return jnp.asarray(out.reshape(rows, block))


def _eq(a_t, a_j, what):
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j), err_msg=what)


def _thresholds(x):
    return (0.0, float(np.sort(np.abs(x))[-max(1, x.shape[0] // 20)]))


@pytest.mark.parametrize("n", SIZES)
def test_ternarize_kernels_match_pallas(n):
    """#4 and #5: codes, packed bytes and pcnt exact, psum rtol 1e-6, on
    the logical rows, at threshold 0 and a top-k threshold."""
    x = _x(n, n)
    nb = -(-n // 2048)
    xb = _grid(x, 2048, np.float32)
    for t in _thresholds(x):
        what = f"n={n} t={t}"
        tt = torch.tensor([t], dtype=torch.float32)
        code_j, psum_j, pcnt_j = tern_jax.ternarize_blocked(
            xb, jnp.float32(t), interpret=True)
        code_t, psum_t, pcnt_t = ternary.ternarize_plain(torch.from_numpy(x),
                                                         tt)
        _eq(code_t, np.asarray(code_j)[:nb], what + " code")
        _eq(pcnt_t, np.asarray(pcnt_j)[:nb], what + " pcnt")
        np.testing.assert_allclose(psum_t.numpy(), np.asarray(psum_j)[:nb],
                                   rtol=1e-6, err_msg=what + " psum")
        pk_j, psum_j, pcnt_j = bp_jax.ternarize_pack_blocked(
            xb, jnp.float32(t), interpret=True)
        pk_t, psum_t, pcnt_t = bitpack.ternarize_pack_plain(
            torch.from_numpy(x), tt)
        _eq(pk_t, np.asarray(pk_j)[:nb], what + " packed")
        _eq(pcnt_t, np.asarray(pcnt_j)[:nb], what + " pcnt (packed)")
        np.testing.assert_allclose(psum_t.numpy(), np.asarray(psum_j)[:nb],
                                   rtol=1e-6, err_msg=what + " psum (packed)")


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("n", SIZES)
def test_pack_unpack_kernels_match_pallas(n, bits):
    """#7 and #8 exact, and the flat wrappers equal ``pack2`` / ``pack4``
    of the reference."""
    half = 1 << (bits - 1)
    codes = np.random.default_rng(n + bits).integers(-half, half, n) \
        .astype(np.int8)
    cb = _grid(codes, 2048, np.int8)
    pk_j = bp_jax.pack_codes_blocked(cb, bits, interpret=True)
    pk_t = bitpack.pack_codes_plain(torch.from_numpy(np.array(cb)), bits)
    _eq(pk_t, pk_j, f"pack n={n} bits={bits}")
    un_j = bp_jax.unpack_codes_blocked(pk_j, bits, interpret=True)
    _eq(bitpack.unpack_codes_plain(pk_t, bits), un_j,
        f"unpack n={n} bits={bits}")
    flat = ops.pack_codes(torch.from_numpy(codes), bits)
    pack_j = wf_jax.pack2 if bits == 2 else wf_jax.pack4
    _eq(flat, pack_j(jnp.asarray(codes)), f"flat pack n={n} bits={bits}")
    _eq(ops.unpack_codes(flat, n, bits), codes, f"flat unpack n={n}")


@pytest.mark.parametrize("n", [1, 3, 4, 5, 1001])
def test_pack2_unpack2_match_reference(n):
    codes = np.random.default_rng(n).integers(-1, 2, n).astype(np.int8)
    p = wf_t.pack2(torch.from_numpy(codes))
    _eq(p, wf_jax.pack2(jnp.asarray(codes)), "pack2")
    _eq(wf_t.unpack2(p, n), wf_jax.unpack2(wf_jax.pack2(jnp.asarray(codes)),
                                           n), "unpack2")
    _eq(wf_t.unpack2(p, n), codes, "unpack2 roundtrip")
    assert p.dtype == torch.uint8 and p.shape == (-(-n // 4),)


@pytest.mark.parametrize("n", [100, 5000])
def test_flat_ternary_wrappers_match_reference(n):
    """``ops.stc_ternarize`` (static and tensor fraction with
    ``max_fraction``), its packed form, and ``ternarize_signs`` (+packed):
    codes and bytes exact, mu and sum|x| at rtol 1e-6."""
    x = _x(n, 3 * n)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    pairs = [
        (ops.stc_ternarize(xt, 0.05), ops_jax.stc_ternarize(xj, 0.05)),
        (ops.stc_ternarize(xt, torch.tensor(0.05), max_fraction=0.1),
         ops_jax.stc_ternarize(xj, jnp.float32(0.05), max_fraction=0.1)),
        (ops.stc_ternarize_packed(xt, 0.1),
         ops_jax.stc_ternarize_packed(xj, 0.1)),
        (ops.ternarize_signs(xt), ops_jax.ternarize_signs(xj)),
        (ops.ternarize_signs_packed(xt), ops_jax.ternarize_signs_packed(xj)),
    ]
    for i, ((c_t, m_t), (c_j, m_j)) in enumerate(pairs):
        _eq(c_t, c_j, f"wrapper {i} codes n={n}")
        np.testing.assert_allclose(float(m_t), float(m_j), rtol=1e-6,
                                   err_msg=f"wrapper {i} scalar n={n}")
    assert int(ops._k_from_fraction(n, torch.tensor(0.05))) == \
        int(ops_jax._k_from_fraction(n, jnp.float32(0.05)))


# ---------------------------------------------------------------------------
# stages, chains and the EF wrapper (parity_cases.py)
# ---------------------------------------------------------------------------

CASES = ([c for c in STAGE_CASES if c["name"] in ("ternary", "stc")]
         + [c for c in CHAIN_CASES if c["name"] == "topk_ternary"]
         + [c for c in WRAPPER_CASES if c["name"] == "ef_stc"]
         + [c for c in FUSED_CASES if c["name"] in
            ("ternary_fused", "stc_fused", "topk_ternary_fused",
             "ef_stc_fused")])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _close(a, b, tol, what):
    """Integer leaves exact; float leaves at ``tol`` relative to scale."""
    a, b = a.numpy(), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.dtype, b.dtype)
    if a.dtype.kind in "iub":
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        scale = max(float(np.abs(b).max()) if b.size else 0.0, 1e-6)
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale,
                                   err_msg=what)


@functools.lru_cache(maxsize=None)
def _reference_run(name):
    """The reference's rounds for one case, once for both port backends,
    run op by op (``jax.disable_jit``, as test_torch_compress.py runs its
    stages)."""
    c = next(c for c in CASES if c["name"] == name)
    ref = build(c, "jax")
    out = []
    for n in c["sizes"]:
        st = ref.init((n,))
        for r in range(c["rounds"]):
            x = (np.random.default_rng(1000 * r + n).standard_normal(n)
                 * 2.0).astype(np.float32)
            key = jax.random.fold_in(jax.random.PRNGKey(7), r)
            with jax.disable_jit():
                pay, st = ref.encode(st, key, jnp.asarray(x))
                dec = ref.decode(pay, n)
            out.append((n, r, x, key, jax.tree.leaves(pay),
                        np.asarray(dec), jax.tree.leaves(st)))
    return ref, c, out


@pytest.mark.parametrize("backend", ["jax", "kernel"])
@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_stc_stages_match_reference(name, backend):
    ref, c, rounds = _reference_run(name)
    port = make_compressor(c["spec"], backend=backend, **c["kw"])
    if c["wrapper"] == "ef":
        port = error_feedback(port)
    assert port.name.replace("@kernel", "") == ref.name.replace("@kernel",
                                                                "")
    st = None
    for n, r, x, key, pay_j, dec_j, st_j in rounds:
        what = f"{name}/{backend} n={n} round={r}"
        if r == 0:
            assert port.wire_bits(n) == ref.wire_bits(n), what
            assert port.entropy_bits(n) == ref.entropy_bits(n), what
            st = port.init((n,), device="cpu")
        pay_t, st = port.encode(st, JaxKey(key), torch.from_numpy(x))
        pay_leaves = _leaves(pay_t)
        assert len(pay_leaves) == len(pay_j), what
        for a, b in zip(pay_leaves, pay_j):
            _close(a, b, c["tol"], what + ": payload")
        dec_t = port.decode(pay_t, n)
        _close(dec_t, dec_j, c["tol"], what + ": decode")
        np.testing.assert_array_equal(np.sign(dec_t.numpy()), np.sign(dec_j),
                                      err_msg=what + ": codes and support")
        st_leaves = _leaves(st)
        assert len(st_leaves) == len(st_j), what
        for a, b in zip(st_leaves, st_j):
            _close(a, b, c["tol"], what + ": state")


def test_stc_spec_grammar():
    assert make_compressor("stc", fraction=0.02).name == "topk0.02>>ternary"
    assert make_compressor("stc:0.1@fused", backend="kernel").name == \
        "stc0.1@kernel@fused"
    assert make_compressor("topk:0.1>>ternary@fused").wire_bits(4000) == \
        build(next(c for c in FUSED_CASES
                   if c["name"] == "topk_ternary_fused"),
              "jax").wire_bits(4000)
    with pytest.raises(ValueError, match="no packed wire format"):
        make_compressor("topk:0.1@fused")


# ---------------------------------------------------------------------------
# DGC: MomentumCorrection through uplink_pipeline, and the state converter
# ---------------------------------------------------------------------------

DGC = {"mc": dict(topk_fraction=0.05),
       "mc_warmup": dict(topk_fraction=0.02, dgc_warmup_rounds=2)}


@pytest.mark.parametrize("backend", ["jax", "kernel"])
@pytest.mark.parametrize("case", sorted(DGC))
def test_dgc_matches_reference_momentum_correction(case, backend):
    """Three rounds of EF-free DGC on ``topk`` (with and without the
    warm-up anneal), each package's pipeline built by its own
    ``uplink_pipeline``: payloads, decodes (so supports), momentum,
    accumulator and round counter exact.  The reference's state, carried
    across by ``convert.state_from_jax``, equals the port's."""
    kw = dict(uplink_compressor="topk", dgc_momentum=0.9, **DGC[case])
    ref = EJ.uplink_pipeline(FLConfigJax(backend="jax", **kw))
    port = ET.uplink_pipeline(FLConfig(backend=backend, **kw))
    assert port.name.replace("@kernel", "") == ref.name
    enc = ieee_jit(ref.encode)
    for n in (3001, 5000):
        assert port.wire_bits(n) == ref.wire_bits(n)
        st_j, st_t = ref.init((n,)), port.init((n,), device="cpu")
        for r in range(3):
            what = f"{case}/{backend} n={n} round={r}"
            x = (np.random.default_rng(100 * r + n).standard_normal(n)
                 * 2.0).astype(np.float32)
            key = jax.random.fold_in(jax.random.PRNGKey(3), r)
            pay_j, st_j = enc(st_j, key, jnp.asarray(x))
            pay_t, st_t = port.encode(st_t, JaxKey(key), torch.from_numpy(x))
            for a, b in zip(_leaves(pay_t), jax.tree.leaves(pay_j)):
                _close(a, b, 0.0, what + ": payload")
            _close(port.decode(pay_t, n), ref.decode(pay_j, n), 0.0,
                   what + ": decode")
            leaves_j = [np.asarray(v) for v in jax.tree.leaves(st_j)]
            carried = state_from_jax(port.init((n,), device="meta"),
                                     leaves_j)
            for a, b, c in zip(_leaves(st_t), leaves_j, _leaves(carried)):
                _close(a, b, 0.0, what + ": state")
                assert torch.equal(a, c), what + ": carried state"


def test_dgc_knob_errors_match_reference():
    for kw, match in ((dict(dgc_warmup_rounds=2), "needs dgc_momentum"),
                      (dict(dgc_momentum=0.9, dgc_warmup_rounds=2,
                            uplink_compressor="topk:0.01"),
                       "fraction-kwarg-driven")):
        kw = dict(dict(uplink_compressor="topk"), **kw)
        for uplink, cfg in ((EJ.uplink_pipeline, FLConfigJax),
                            (ET.uplink_pipeline, FLConfig)):
            with pytest.raises(ValueError, match=match):
                uplink(cfg(**kw))


def test_stc_mu_at_zero_threshold_counts_only_logical_lanes():
    """With fewer nonzeros than k the top-k threshold is 0 and pad lanes
    pass it: the port's kernel path takes them back out of the count, so
    its mu equals the plain ``FusedSTC``'s (the reference's plain path),
    Σ|x| / n.  (The reference's kernel path divides by n + its pad.)"""
    x = np.zeros(3000, np.float32)
    x[:10] = np.arange(1, 11)
    pay_j, _ = build(dict(spec="stc:0.1@fused", kw={}, wrapper=None),
                     "jax").encode((), jax.random.PRNGKey(0),
                                   jnp.asarray(x))
    _, mu_kernel = ops.stc_ternarize_packed(torch.from_numpy(x), 0.1)
    pay_t, _ = make_compressor("stc:0.1@fused").encode(
        (), None, torch.from_numpy(x))
    for mu in (mu_kernel, pay_t["mu"]):
        np.testing.assert_allclose(float(mu), float(pay_j["mu"]), rtol=1e-6)
    np.testing.assert_allclose(float(mu_kernel), 55.0 / 3000, rtol=1e-6)
