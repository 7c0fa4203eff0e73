"""The kernel-less uplink stages of the port against the reference: SBC,
RandMask (with and without its Gaussian noise), HSQ and UVeQ, with the
reference's draws (RandMask's scores and noise, UVeQ's dither) injected
through :class:`JaxKey`, and the engine's error-feedback wrapping of
every stage this slice adds.  Inputs come from numpy; the reference is
compiled with one rounding per op (:func:`ieee_jit`).

Tolerances:
  * indices, signs, codes, scales, RandMask's values and UVeQ's decode,
    the keys carried in the payloads, ``wire_bits`` / ``entropy_bits`` and
    the ledger terms: exact;
  * SBC's and HSQ's mu, and their decodes: rtol 1e-6 (a sum in another
    order than XLA's, DESIGN.md §6's bounded-ULP class); the decode's
    support is exact.
"""
import jax
import numpy as np
import pytest
import torch

from repro.compress import make_compressor as make_jax
from repro.configs.registry import get_arch as get_arch_jax
from repro.core import engine as EJ
from repro.core.types import FLConfig as FLConfigJax
from repro.models.model import Model as ModelJax
from repro_torch.compress import make_compressor
from repro_torch.configs.registry import get_arch
from repro_torch.core import engine as ET
from repro_torch.core.types import FLConfig
from repro_torch.models.model import Model
from test_torch_jaxkeys import JaxKey, ieee_jit, jax_hash_params
from test_torch_jaxkeys import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZES = (100, 3001, 5000)
# spec -> the payload fields held at rtol 1e-6 (every other field exact)
STAGES = {"sbc:0.05": ("mu",), "randmask:0.05": (),
          "hsq": ("mu",), "uveq": (), "uveq:2,512": ()}


def _x(n, seed):
    x = (np.random.default_rng(seed).standard_normal(n) * 2.0) \
        .astype(np.float32)
    x[::13] = 0.0
    return x


def _port(spec):
    if spec == "randmask:0.05+dp":
        return make_compressor("randmask", fraction=0.05, dp_sigma=0.3)
    return make_compressor(spec)


def _ref(spec):
    if spec == "randmask:0.05+dp":
        return make_jax("randmask", fraction=0.05, dp_sigma=0.3)
    return make_jax(spec)


def _payload_field(v):
    """A payload leaf as numpy: a key object as its raw key data."""
    if isinstance(v, JaxKey):
        return np.asarray(v.key)
    return v.numpy()


@pytest.mark.parametrize("spec", list(STAGES) + ["randmask:0.05+dp"])
def test_stage_matches_reference(spec):
    port, ref = _port(spec), _ref(spec)
    assert port.name == ref.name and port.biased == ref.biased
    assert port.carrier_key == ref.carrier_key
    enc = ieee_jit(ref.encode)
    dec = ieee_jit(ref.decode, static_argnums=1)
    loose = STAGES.get(spec, ())
    for n in SIZES:
        what = f"{spec} n={n}"
        assert port.wire_bits(n) == ref.wire_bits(n), what
        assert port.entropy_bits(n) == ref.entropy_bits(n), what
        assert port.carrier_len(n) == ref.carrier_len(n), what
        x = _x(n, n)
        key = jax.random.fold_in(jax.random.PRNGKey(11), n)
        pay_j, _ = enc(ref.init((n,)), key, x)
        pay_t, _ = port.encode(port.init((n,), device="cpu"), JaxKey(key),
                               torch.from_numpy(x))
        assert sorted(pay_t) == sorted(pay_j), what
        for field in pay_j:
            a, b = _payload_field(pay_t[field]), np.asarray(pay_j[field])
            assert a.shape == b.shape and a.dtype == b.dtype, (what, field)
            if field in loose:
                np.testing.assert_allclose(a, b, rtol=1e-6,
                                           err_msg=f"{what} {field}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{what} {field}")
        d_t, d_j = port.decode(pay_t, n).numpy(), np.asarray(dec(pay_j, n))
        np.testing.assert_array_equal(d_t != 0, d_j != 0,
                                      err_msg=f"{what} decode support")
        if loose:
            np.testing.assert_allclose(d_t, d_j, rtol=1e-6,
                                       err_msg=f"{what} decode")
        else:
            np.testing.assert_array_equal(d_t, d_j, err_msg=f"{what} decode")


def test_engine_wraps_the_biased_stages_in_error_feedback(monkeypatch):
    """EF wraps sketch, sbc and hsq and not randmask or uveq, as in the
    reference's ``uplink_pipeline``; the ledger terms agree exactly."""
    from repro_torch.compress import sketch as sk_t
    monkeypatch.setattr(sk_t, "hash_params", jax_hash_params)
    mj, mt = ModelJax(get_arch_jax("paper_lm")), Model(get_arch("paper_lm"))
    for spec, ef in (("sketch", True), ("sketch>>qsgd:8", True),
                     ("sketch:3,512", True), ("sbc", True), ("hsq", True),
                     ("randmask", False), ("randmask:0.05", False),
                     ("uveq", False)):
        flj = FLConfigJax(uplink_compressor=spec, topk_fraction=0.1)
        flt = FLConfig(uplink_compressor=spec, topk_fraction=0.1)
        up_j, up_t = EJ.uplink_pipeline(flj), ET.uplink_pipeline(flt)
        assert up_t.name == up_j.name, spec
        assert up_t.name.startswith("ef(") == ef, spec
        assert ET.ledger_terms(mt, flt)[0] == EJ.ledger_terms(mj, flj)[0], \
            spec


def test_every_reference_stage_but_privacy_builds_on_the_port():
    """Every name the reference registers builds on the port under the
    reference's name, and so do the privacy stages (which the grammar
    routes around the registry)."""
    from repro.compress import api as api_jax
    from repro_torch.compress import api
    assert not hasattr(api, "_NOT_PORTED")
    names = sorted(set(api_jax._REGISTRY) | set(api_jax._STAGES))
    for spec in names + ["sketch:3,512", "sketch>>qsgd:8", "sketch@kernel",
                         "qsgd:4>>secagg", "dpnoise:0.8",
                         "topk:0.05>>qsgd:4>>dpnoise:0.8>>secagg"]:
        assert make_compressor(spec).name == make_jax(spec).name, spec
