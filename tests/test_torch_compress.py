"""(b) Stage and chain payloads, decodes and pipeline state of the port
against the reference, for the ``topk``, ``qsgd``, ``topk>>qsgd``,
``sketch`` and ``sketch>>qsgd`` rows of ``tests/parity_cases.py``, with the
reference's uniforms injected through :class:`JaxKey` and its count-sketch
hash parameters monkeypatched into the port.

Tolerance: none for the exact rows.  Their payloads, decodes and EF
residuals are bit-exact on both of the port's backends (``jax`` = plain
PyTorch, ``kernel`` = the kernel wrappers, which take their plain versions
on a CPU tensor).  The sketch rows (``exact=False``) hold their float
leaves at the table's ``tol`` (1e-3) relative to the leaf's scale, and
their integer leaves (QSGD codes) exactly.  ``wire_bits`` and
``entropy_bits`` are float-equal.  Inputs come from numpy, or from the
table's heavy-hitter generator for the sketch rows.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_cases import CHAIN_CASES, FUSED_CASES, INPUTS, STAGE_CASES, \
    WRAPPER_CASES, build
from repro.compress import make_compressor as make_jax
from repro_torch.compress import make_compressor
from repro_torch.compress import sketch as sk_t
from repro_torch.compress.pipeline import error_feedback
from test_torch_jaxkeys import JaxKey, jax_hash_params, reference_rounds
from test_torch_jaxkeys import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = ([c for c in STAGE_CASES if c["name"] in
          ("topk", "qsgd8", "qsgd4", "qsgd_block256", "sketch")]
         + [c for c in CHAIN_CASES if c["name"] in
            ("topk_qsgd8", "topk_qsgd4", "sketch_qsgd8")]
         + [c for c in WRAPPER_CASES if c["name"] == "ef_topk_qsgd"]
         + [c for c in FUSED_CASES if c["name"] == "topk_qsgd4_fused"])


def _port(c, backend):
    pipe = make_compressor(c["spec"], backend=backend, **c["kw"])
    return error_feedback(pipe) if c["wrapper"] == "ef" else pipe


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _same(t, j, what, tol=0.0):
    """Leaves equal; at ``tol`` > 0, float leaves within ``tol`` of the
    leaf's scale."""
    t_leaves = _leaves(t)
    j_leaves = jax.tree.leaves(j)
    assert len(t_leaves) == len(j_leaves), what
    for a, b in zip(t_leaves, j_leaves):
        b = np.asarray(b)
        assert a.shape == b.shape and str(a.dtype).split(".")[-1] == \
            b.dtype.name, (what, a.shape, a.dtype, b.shape, b.dtype)
        if tol and b.dtype.kind == "f":
            scale = max(float(np.abs(b).max()) if b.size else 0.0, 1e-6)
            np.testing.assert_allclose(a.numpy(), b, rtol=tol,
                                       atol=tol * scale, err_msg=what)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=what)


@functools.lru_cache(maxsize=None)
def _input(kind, n, r):
    if kind == "gaussian":
        return (np.random.default_rng(1000 * r + n).standard_normal(n)
                * 2.0).astype(np.float32)
    gen = jax.jit(INPUTS[kind], static_argnums=(0, 1))
    return np.array(gen(1000 * r + n, n), np.float32)


@functools.lru_cache(maxsize=None)
def _reference_run(name):
    """The reference's rounds for one case, computed once for both port
    backends: [(n, round, x, payload, decode, state)] as numpy, every size
    in one :func:`ieee_jit` program (one rounding per op, as op by op;
    none of these stages uses a primitive that XLA expands into a
    polynomial, such as ``erf_inv``)."""
    c = next(c for c in CASES if c["name"] == name)
    ref = build(c, "jax")
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return ref, [(n, r, x, to_np(pay), np.asarray(dec), to_np(st))
                 for n, r, x, _, pay, dec, st in reference_rounds(
                     ref, c["sizes"], c["rounds"],
                     lambda n, r: _input(c["input"], n, r), _key)]


def _key(r):
    return jax.random.fold_in(jax.random.PRNGKey(7), r)


@pytest.mark.parametrize("backend", ["jax", "kernel"])
@pytest.mark.parametrize("c", CASES, ids=[c["name"] for c in CASES])
def test_payload_decode_state_bitexact(c, backend, monkeypatch):
    monkeypatch.setattr(sk_t, "hash_params", jax_hash_params)
    ref, rounds = _reference_run(c["name"])
    port = _port(c, backend)
    st_t = None
    for n, r, x, pay_j, dec_j, st_j in rounds:
        if r == 0:
            assert port.wire_bits(n) == ref.wire_bits(n), (c["name"], n)
            assert port.entropy_bits(n) == ref.entropy_bits(n), (c["name"], n)
            st_t = port.init((n,), device="cpu")
        pay_t, st_t = port.encode(st_t, JaxKey(_key(r)), torch.from_numpy(x))
        what = f"{c['name']} n={n} round={r}"
        _same(pay_t, pay_j, what + ": payload", c["tol"])
        _same(port.decode(pay_t, n), dec_j, what + ": decode", c["tol"])
        _same(st_t, st_j, what + ": state", c["tol"])


def test_spec_grammar_names_and_errors():
    assert make_compressor("topk:0.05>>qsgd:8", backend="kernel").name == \
        make_jax("topk:0.05>>qsgd:8", backend="kernel").name
    assert make_compressor("topk:0.05>>qsgd:4@fused").name == \
        "topk0.05>>qsgd4@fused"
    with pytest.raises(ValueError, match="unknown backend"):
        make_compressor("qsgd:8@gpu")
    with pytest.raises(ValueError, match="no packed wire format"):
        make_compressor("qsgd:8@fused")
    # the privacy stages wrap the pipeline to their left, as in the
    # reference (their rules: tests/test_torch_privacy.py)
    for spec in ("dpnoise:0.5", "qsgd:4>>secagg"):
        assert make_compressor(spec).name == make_jax(spec).name
    with pytest.raises(KeyError):
        make_compressor("nosuchstage:3")
    # the global packed wire degrades gracefully on qsgd:8, like the reference
    assert make_compressor("qsgd:8", wire_format="packed").wire == "staged"
