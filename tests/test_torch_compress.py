"""(b) Stage and chain payloads, decodes and pipeline state of the port
against the reference, for the ``topk``, ``qsgd`` and ``topk>>qsgd`` rows
of ``tests/parity_cases.py``, with the reference's uniforms injected
through :class:`JaxKey`.

Tolerance: none.  Payloads, decodes and EF residuals are bit-exact on both
of the port's backends (``jax`` = plain PyTorch, ``kernel`` = the kernel
wrappers, which take their plain versions on a CPU tensor); ``wire_bits``
and ``entropy_bits`` are float-equal.  Inputs come from numpy.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_cases import CHAIN_CASES, FUSED_CASES, STAGE_CASES, \
    WRAPPER_CASES, build
from repro.compress import make_compressor as make_jax
from repro_torch.compress import make_compressor
from repro_torch.compress.pipeline import error_feedback
from test_torch_jaxkeys import JaxKey, ieee_jit

CASES = ([c for c in STAGE_CASES if c["name"] in
          ("topk", "qsgd8", "qsgd4", "qsgd_block256")]
         + [c for c in CHAIN_CASES if c["name"] in
            ("topk_qsgd8", "topk_qsgd4")]
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


def _same(t, j, what):
    t_leaves = _leaves(t)
    j_leaves = jax.tree.leaves(j)
    assert len(t_leaves) == len(j_leaves), what
    for a, b in zip(t_leaves, j_leaves):
        b = np.asarray(b)
        assert a.shape == b.shape and str(a.dtype).split(".")[-1] == \
            b.dtype.name, (what, a.shape, a.dtype, b.shape, b.dtype)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=what)


@functools.lru_cache(maxsize=None)
def _reference_run(name):
    """The reference's rounds for one case, computed once for both port
    backends: [(n, round, x, payload, decode, state)] as numpy, compiled
    with :func:`ieee_jit` so every op rounds on its own."""
    c = next(c for c in CASES if c["name"] == name)
    ref = build(c, "jax")
    enc = ieee_jit(ref.encode)
    dec = ieee_jit(ref.decode, static_argnums=1)
    out = []
    for n in c["sizes"]:
        st = ref.init((n,))
        for r in range(c["rounds"]):
            x = (np.random.default_rng(1000 * r + n).standard_normal(n)
                 * 2.0).astype(np.float32)
            pay, st = enc(st, _key(r), jnp.asarray(x))
            to_np = lambda t: jax.tree.map(np.asarray, t)
            out.append((n, r, x, to_np(pay), np.asarray(dec(pay, n)),
                        to_np(st)))
    return ref, out


def _key(r):
    return jax.random.fold_in(jax.random.PRNGKey(7), r)


@pytest.mark.parametrize("backend", ["jax", "kernel"])
@pytest.mark.parametrize("c", CASES, ids=[c["name"] for c in CASES])
def test_payload_decode_state_bitexact(c, backend):
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
        _same(pay_t, pay_j, what + ": payload")
        _same(port.decode(pay_t, n), dec_j, what + ": decode")
        _same(st_t, st_j, what + ": state")


def test_spec_grammar_names_and_errors():
    assert make_compressor("topk:0.05>>qsgd:8", backend="kernel").name == \
        make_jax("topk:0.05>>qsgd:8", backend="kernel").name
    assert make_compressor("topk:0.05>>qsgd:4@fused").name == \
        "topk0.05>>qsgd4@fused"
    with pytest.raises(ValueError, match="unknown backend"):
        make_compressor("qsgd:8@gpu")
    with pytest.raises(ValueError, match="no packed wire format"):
        make_compressor("qsgd:8@fused")
    with pytest.raises(NotImplementedError,
                       match="repro.compress.sparsification"):
        make_compressor("sbc:0.1")
    with pytest.raises(NotImplementedError, match="repro.compress.secure_agg"):
        make_compressor("qsgd:4>>secagg")
    with pytest.raises(KeyError):
        make_compressor("nosuchstage:3")
    # the global packed wire degrades gracefully on qsgd:8, like the reference
    assert make_compressor("qsgd:8", wire_format="packed").wire == "staged"
