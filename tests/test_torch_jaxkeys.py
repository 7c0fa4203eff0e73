"""``jax.random``-backed keys for the port's differential tests.

``repro_torch`` threads keys with the reference's structure (split per
round and per client, ``fold_in`` per leaf and per chain stage) but draws
its own uniforms.  :class:`JaxKey` has the port key's seven methods and
answers them with ``jax.random``, so a port run handed a ``JaxKey`` draws
exactly the reference's QSGD uniforms (and UVeQ's dither, RandMask's
scores and noise, and a population's cohorts and availability) — the key
path of the main path is

    state.rng -> split(5)[3] -> split(C)[c] -> fold_in(leaf)
              -> (EF passes it through) -> fold_in(1) -> uniform((nb, blk))

and both packages walk it.  The tests below pin that equivalence.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.convert import hash_params_from_jax
from repro_torch.core.rng import Key


class JaxKey:
    """A ``jax.random`` key behind the port's key interface."""

    def __init__(self, key):
        self.key = key

    def split(self, n):
        # rows of a host copy: iterating the device array dispatches one
        # indexing op per row
        return [JaxKey(k) for k in np.asarray(jax.random.split(self.key, n))]

    def fold_in(self, data):
        return JaxKey(jax.random.fold_in(self.key, data))

    def uniform(self, shape, device):
        u = np.asarray(_uniform(self.key, tuple(shape)))
        return torch.from_numpy(u.copy()).to(device)

    def normal(self, shape, device):
        # compiled like the reference under test (one rounding per op):
        # the default jit contracts the inverse-erf polynomial into FMAs
        z = np.asarray(_ieee_normal(self.key, tuple(shape)))
        return torch.from_numpy(z.copy()).to(device)

    def randint(self, low, high, shape, device):
        # int32, the reference's draw for bounds below 2^31
        v = np.asarray(_randint(self.key, tuple(shape), low, high))
        return torch.from_numpy(v.astype(np.int64)).to(device)

    def permutation(self, n, device):
        v = np.asarray(_permutation(self.key, n))
        return torch.from_numpy(v.astype(np.int64)).to(device)

    def bits(self, shape, width, device):
        v = np.asarray(_bits(self.key, tuple(shape), int(width)))
        return torch.from_numpy(v.astype(np.int64)).to(device)


# compiled once per shape (eager jax.random re-dispatches every
# primitive).  ``uniform`` is integer hashing, then exact float ops (an OR into the
# mantissa, a subtraction of 1.0, a multiply by 1.0), so it draws the same
# bits at any optimization level; level 0 compiles each shape faster
_uniform = jax.jit(lambda k, shape: jax.random.uniform(k, shape, jnp.float32),
                   static_argnums=1,
                   compiler_options={"xla_backend_optimization_level": 0})
_randint = jax.jit(lambda k, shape, lo, hi: jax.random.randint(k, shape, lo,
                                                               hi),
                   static_argnums=1)
_permutation = jax.jit(jax.random.permutation, static_argnums=1)
# integer hashing only: the same bits at any optimization level
_bits = jax.jit(lambda k, shape, w: jax.random.bits(k, shape,
                                                    jnp.dtype(f"uint{w}")),
                static_argnums=(1, 2),
                compiler_options={"xla_backend_optimization_level": 0})


IEEE_OPTIONS = {"xla_backend_optimization_level": 0,
                "xla_disable_hlo_passes": "algsimp,fusion",
                "xla_cpu_use_fusion_emitters": False}


def ieee_jit(fn, **jit_kw):
    """``jax.jit`` that keeps the reference's arithmetic as written, one
    IEEE rounding per op — what op-by-op JAX computes, and what the port
    and its CUDA kernels compute.  A default CPU jit differs by ULPs: LLVM
    contracts a multiply feeding an add into one FMA (QSGD's
    ``x / s * L + u``, the EF residual's ``y - q / L * s``), and XLA's
    algebraic simplifier turns ``q / L`` into ``q * (1 / L)`` (DESIGN.md
    §6's engine-scope class).  The loop fusions that XLA's ``fusion`` pass
    builds can still contract at optimization level 0 (an 8-client EF
    ``topk>>qsgd:8`` wire flipped one QSGD code of 786,432 against op by
    op), so that pass is off too.  The CPU fusion emitters are off as
    well: with no fusion pass they change no arithmetic, and the compile
    is shorter."""
    return jax.jit(fn, compiler_options=IEEE_OPTIONS, **jit_kw)


def quick_jit(fn):
    """``jax.jit`` at XLA's optimization level 0 with the CPU fusion
    emitters off, for reference programs whose bits are not compared (or
    that only move data): they compile in about a third to a half of the
    default's time, the whole models' gradients several times faster
    without the emitters (test_torch_families.py)."""
    return jax.jit(fn, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_cpu_use_fusion_emitters": False})


def _ieee_normal(key, shape):
    return ieee_jit(lambda k: jax.random.normal(k, shape, jnp.float32))(key)


@functools.lru_cache(maxsize=None)
def jax_hash_params(rows, seed=17):
    """The reference's count-sketch hash parameters in the port's form, to
    monkeypatch over ``repro_torch.compress.sketch.hash_params``."""
    from repro.compress.sketch import hash_params
    a, b = hash_params(rows, seed)
    return hash_params_from_jax(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread for a test module (``pytestmark =
    pytest.mark.usefixtures("one_torch_thread")``): its rounds are many
    small ops, which OpenMP threads only slow down when the test
    processes share the cores; every comparison in a module runs within
    one thread setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_torch(a, device="cpu"):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def test_jaxkey_walks_the_reference_key_path():
    """The port's call sequence on a JaxKey draws the reference's
    uniforms for one (round, client, leaf) of the main path."""
    root = jax.random.PRNGKey(0)
    ref = jax.random.split(root, 5)[3]
    ref = jax.random.fold_in(jax.random.split(ref, 4)[2], 5)
    ref = jax.random.fold_in(ref, 1)
    want = np.asarray(jax.random.uniform(ref, (3, 7), jnp.float32))
    k = JaxKey(root).split(5)[3].split(4)[2].fold_in(5).fold_in(1)
    np.testing.assert_array_equal(k.uniform((3, 7), "cpu").numpy(), want)


def test_ieee_jit_rounds_every_op():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4096).astype(np.float32)
    c = rng.random(4096, dtype=np.float32)
    np.testing.assert_array_equal(
        np.asarray(ieee_jit(lambda a, c: a * 127 + c)(a, c)),
        (a * np.float32(127.0)) + c)
    np.testing.assert_array_equal(
        np.asarray(ieee_jit(lambda a, c: a / 127 * c)(a, c)),
        (a / np.float32(127.0)) * c)


def test_jaxkey_randint_and_permutation_are_the_reference_draws():
    k = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    np.testing.assert_array_equal(
        JaxKey(k).randint(0, 1000, (5,), "cpu").numpy(),
        np.asarray(jax.random.randint(k, (5,), 0, 1000)))
    np.testing.assert_array_equal(JaxKey(k).permutation(50, "cpu").numpy(),
                                  np.asarray(jax.random.permutation(k, 50)))


def test_port_key_is_deterministic_and_path_sensitive():
    k = Key(3)
    a = k.split(5)[3].fold_in(2).uniform((4, 5), "cpu")
    b = Key(3).split(5)[3].fold_in(2).uniform((4, 5), "cpu")
    c = k.split(5)[3].fold_in(1).uniform((4, 5), "cpu")
    d = k.split(5)[2].fold_in(2).uniform((4, 5), "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0
    r = k.fold_in(1).randint(5, 9, (1000,), "cpu")
    assert torch.equal(r, Key(3).fold_in(1).randint(5, 9, (1000,), "cpu"))
    assert r.dtype == torch.int64 and set(r.tolist()) == {5, 6, 7, 8}
    p = k.fold_in(2).permutation(100, "cpu")
    assert torch.equal(p, Key(3).fold_in(2).permutation(100, "cpu"))
    assert sorted(p.tolist()) == list(range(100))
