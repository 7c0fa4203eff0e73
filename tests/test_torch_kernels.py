"""(a) The port's plain kernel versions against the reference's oracles
(``repro.kernels.ref``) and its Pallas kernels in interpret mode.

Tolerance: none — every comparison is bit-exact (``assert_array_equal``),
over n in {100, 3001, 5000, 8*2048}, bits 2 / 4 / 8, and the short
carriers (one row of n < 2048, odd and even).  Inputs come from numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import wire_format as wf_jax
from repro.kernels import ops as ops_jax
from repro.kernels import ref as ref_jax
from repro_torch.compress import wire_format as wf_t
from repro_torch.kernels import bitpack, ops, qsgd, topk_mask
from repro_torch.kernels import ref as ref_t
from test_torch_jaxkeys import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZES = (100, 3001, 5000, 8 * 2048)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 2.0).astype(np.float32)
    u = rng.random(n, dtype=np.float32)
    return x, u


def _eq(a_t, a_j, what):
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j), err_msg=what)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("n", SIZES)
def test_qsgd_plain_matches_reference_and_pallas(n, bits):
    x, u = _inputs(n, n + bits)
    xt, ut = torch.from_numpy(x), torch.from_numpy(u)
    for block in sorted({2048, min(2048, n)}):
        q_t, s_t = ops.qsgd_quantize(xt, ut, bits, block)
        q_p, s_p = ops_jax.qsgd_quantize(jnp.asarray(x), jnp.asarray(u),
                                         bits, block)       # Pallas, interpret
        _eq(q_t, q_p, f"q n={n} bits={bits} block={block}")
        _eq(s_t, s_p, f"scale n={n} bits={bits} block={block}")
        # blocked oracle against the reference's oracle on the same tiles
        xb = ref_t.blocked(xt, block)
        ub = ref_t.blocked(ut, block)
        q_r, s_r = ref_jax.ref_qsgd_quantize_blocked(
            jnp.asarray(xb.numpy()), jnp.asarray(ub.numpy()), bits)
        q_o, s_o = ref_t.ref_qsgd_quantize_blocked(xb, ub, bits)
        _eq(q_o, q_r, "oracle q")
        _eq(s_o, s_r, "oracle scale")


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("n", SIZES + (101, 1))
def test_qsgd_packed_matches_pallas(n, bits):
    """The fused pack (even blocks) and the odd short-carrier fallback
    (n = 101 with the block adapted to n) both equal the reference."""
    x, u = _inputs(n, 7 * n + bits)
    block = min(2048, n)
    p_t, s_t = ops.qsgd_quantize_packed(torch.from_numpy(x),
                                        torch.from_numpy(u), bits, block)
    p_j, s_j = ops_jax.qsgd_quantize_packed(jnp.asarray(x), jnp.asarray(u),
                                            bits, block)
    _eq(p_t, p_j, f"packed n={n} bits={bits}")
    _eq(s_t, s_j, f"scale n={n} bits={bits}")
    assert p_t.shape == (-(-n // 2),)


@pytest.mark.parametrize("n", SIZES + (1,))
def test_threshold_sparsify_matches_pallas(n):
    x, _ = _inputs(n, 3 * n)
    t = np.float32(np.sort(np.abs(x))[-max(1, n // 20)])
    kept_t, resid_t = ops.threshold_sparsify(torch.from_numpy(x),
                                             torch.tensor([t]))
    kept_j, resid_j = ops_jax.threshold_sparsify(jnp.asarray(x),
                                                 jnp.float32(t))
    _eq(kept_t, kept_j, "kept")
    _eq(resid_t, resid_j, "resid")
    assert torch.equal(kept_t + resid_t, torch.from_numpy(x))


def test_plain_versions_share_the_kernel_interface():
    """The wrappers' plain halves give the kernels' output shapes: logical
    rows only, pad lanes code 0 (the CUDA kernels are checked against
    these on the card by chip_smoke.py)."""
    x, u = _inputs(3001, 1)
    xt, ut = torch.from_numpy(x), torch.from_numpy(u)
    q, s = qsgd.qsgd_quantize_plain(xt, ut, 8, 2048)
    assert q.shape == (2, 2048) and s.shape == (2,)
    assert not q[1, 3001 - 2048:].any()
    p, s = bitpack.qsgd_pack_plain(xt, ut, 4, 2048)
    assert p.shape == (2, 1024) and p.dtype == torch.uint8
    k, r = topk_mask.threshold_sparsify_plain(xt, torch.tensor([1.0]))
    assert k.shape == r.shape == (3001,)


def test_int8_conversion_saturates_like_xla():
    y = np.array([128.0, 200.0, -129.0, -300.0, 127.9], np.float32)
    _eq(ref_t.to_int8(torch.from_numpy(y)), jnp.asarray(y).astype(jnp.int8),
        "saturating cast")


@pytest.mark.parametrize("n", [1, 5, 1001])
def test_wire_format_pack_unpack_match_reference(n):
    c4 = np.random.default_rng(n).integers(-8, 8, n).astype(np.int8)
    p4 = wf_t.pack4(torch.from_numpy(c4))
    _eq(p4, wf_jax.pack4(jnp.asarray(c4)), "pack4")
    _eq(wf_t.unpack4(p4, n), c4, "unpack4")
    for bits in (2, 4):
        assert wf_t.packed_len(n, bits) == wf_jax.packed_len(n, bits)
