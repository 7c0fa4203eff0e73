"""The count-sketch slice of the port against the reference: the hash, the
identity the kernel's fold path rests on (at a power-of-two width a
bucket and its sign depend only on ``i mod 2*cols``), the scatter path's
division-free hash and its cluster plan (emulated in numpy), the plain sketch
against the reference's oracle and its Pallas kernel in interpret mode,
the midpoint-median unsketch, and one EF
``sketch>>qsgd:8`` sim round through the port's engine against the
reference engine.  Inputs come from numpy; the reference's hash parameters
are monkeypatched into the port (``jax_hash_params``), and its QSGD
uniforms come through :class:`JaxKey`.

Tolerances:
  * buckets and signs, ``unsketch`` for the same S, the round's ledger:
    exact;
  * S: ``|S - S_ref| <= 1e-5 * M`` elementwise, M the bucket's absolute
    mass (the sketch of |x| with every sign +1) — a sum in another order
    (DESIGN.md §6's bounded-ULP class);
  * the round's decoded rows, aggregate and params: rtol 1e-3 with an
    atol of 1e-3 times the leaf's scale (the table tolerance of the
    ``sketch`` rows of ``tests/parity_cases.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import sketch as sk_jax
from repro.configs.registry import get_arch as get_arch_jax
from repro.core import engine as EJ
from repro.core import server_opt as SJ
from repro.core.types import FLConfig as FLConfigJax
from repro.kernels import ops as ops_jax
from repro.kernels import ref as ref_jax
from repro.kernels.count_sketch import count_sketch as count_sketch_pallas
from repro.models.model import Model as ModelJax
from repro_torch.compress import sketch as sk_t
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_to_jax
from repro_torch.core import engine as ET
from repro_torch.core import server_opt as ST
from repro_torch.core.types import FLConfig
from repro_torch.data.synthetic import FedDataConfig, sample_round
from repro_torch.kernels import count_sketch, ops
from repro_torch.kernels.ref import ref_count_sketch
from repro_torch.models.model import Model
from test_torch_engine import C, SEQ, _same_ledger, _tree_np
from test_torch_jaxkeys import JaxKey, ieee_jit, jax_hash_params, quick_jit
from test_torch_jaxkeys import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _reference_hash(monkeypatch):
    monkeypatch.setattr(sk_t, "hash_params", jax_hash_params)


def _x(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 2.0) \
        .astype(np.float32)


def _mass(x, rows, cols):
    """Each bucket's absolute mass: the sketch of |x| with every sign +1."""
    a, b = jax_hash_params(rows)
    h, _ = sk_t.bucket_and_sign(torch.arange(x.shape[0]), a, b, cols)
    M = torch.zeros(rows * cols, dtype=torch.float64)
    offs = torch.arange(rows)[:, None] * cols
    M.index_add_(0, (h + offs).reshape(-1),
                 torch.from_numpy(np.abs(x)).double().expand(rows, -1)
                 .reshape(-1))
    return M.reshape(rows, cols).numpy()


def _within_mass(S, S_ref, M, what):
    err = np.abs(np.asarray(S, np.float64) - np.asarray(S_ref, np.float64))
    bad = err > 1e-5 * M + 1e-30
    assert not bad.any(), (what, float((err / np.maximum(M, 1e-30)).max()))


@pytest.mark.parametrize("cols", [4096, 12])
def test_bucket_and_sign_bit_equal(cols):
    """Buckets and signs equal the reference's for i < 2^20 and for the
    indices just below 2^31 (where the uint32 product wraps)."""
    a_j, b_j = sk_jax.hash_params(5)
    a_t, b_t = jax_hash_params(5)
    for lo, hi in ((0, 1 << 20), ((1 << 31) - 4096, 1 << 31)):
        i = np.arange(lo, hi, dtype=np.int64)
        h_j, s_j = sk_jax.bucket_and_sign(jnp.asarray(i.astype(np.int32)),
                                          a_j, b_j, cols)
        h_t, s_t = sk_t.bucket_and_sign(torch.from_numpy(i), a_t, b_t, cols)
        np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


_FOLD_INDICES = 1 << 20                  # 4 periods of the widest width
_jax_sketch = jax.jit(sk_jax.sketch, static_argnums=(1, 2))


@pytest.mark.parametrize("rows", [3, 5])
@pytest.mark.parametrize("cols", [8, 512, 4096, 131072])
def test_fold_identity_against_reference_hash(cols, rows):
    """At a power-of-two width, the reference's bucket and sign repeat with
    period 2*cols, every bucket has exactly two preimages in [0, 2*cols)
    with opposite signs, :func:`count_sketch.preimages` returns them, and
    folding x into rows of 2*cols then gathering ``y[p+] - y[p-]`` gives
    the reference's sketch within 1e-5 of each bucket's mass."""
    P = 2 * cols
    a_j, b_j = sk_jax.hash_params(rows)
    a_t, b_t = jax_hash_params(rows)
    # one index vector of one length for every width, so the reference's
    # eager ops compile once: residues t mod P shifted by 0, 1, 7 and the
    # last whole number of periods below 2^31
    t = np.arange(_FOLD_INDICES, dtype=np.int64)
    periods = np.array([0, 1, 7, (1 << 31) // P - 1], dtype=np.int64)
    i = t % P + periods[t // (_FOLD_INDICES // 4)] * P
    h, s = (np.asarray(v) for v in sk_jax.bucket_and_sign(
        jnp.asarray(i.astype(np.int32)), a_j, b_j, cols))
    h0, s0 = h[:, :P], s[:, :P]
    np.testing.assert_array_equal(h, h0[:, t % P])
    np.testing.assert_array_equal(s, s0[:, t % P])
    p_plus, p_minus = (t.numpy() for t in count_sketch.preimages(a_t, b_t,
                                                                 cols))
    for j in range(rows):
        assert (np.bincount(h0[j], minlength=cols) == 2).all()
        np.testing.assert_array_equal(
            np.bincount(h0[j], weights=s0[j], minlength=cols), 0.0)
        np.testing.assert_array_equal(h0[j][p_plus[j]], np.arange(cols))
        np.testing.assert_array_equal(h0[j][p_minus[j]], np.arange(cols))
        assert (s0[j][p_plus[j]] == 1.0).all()
        assert (s0[j][p_minus[j]] == -1.0).all()
    n = 2 * P + P // 2 + 3               # two full rows and a ragged one
    x = _x(n, cols + rows)
    y = np.zeros(3 * P, np.float32)
    y[:n] = x
    y = y.reshape(3, P).sum(axis=0, dtype=np.float32)
    S = y[p_plus] - y[p_minus]
    _within_mass(S, _jax_sketch(jnp.asarray(x), rows, cols),
                 _mass(x, rows, cols), f"fold cols={cols}")


def test_fold_path_takes_power_of_two_widths_and_odd_multipliers():
    """The adapted width 3276 takes the scatter path; the fold path's
    helpers refuse it and an even multiplier."""
    assert count_sketch.fold_path(4096) and count_sketch.fold_path(8)
    assert not count_sketch.fold_path(3276)
    assert not count_sketch.fold_path(3 * 1024)
    a, b = jax_hash_params(5)
    with pytest.raises(ValueError, match="power-of-two"):
        count_sketch.preimages(a, b, 3276)
    with pytest.raises(ValueError, match="odd"):
        count_sketch.inverses([int(a[0]), 6])
    assert all(int(t) * v % (1 << 32) == 1
               for t, v in zip(a, count_sketch.inverses(a)))


def _kernel_hash(i, a, b, cols):
    """Buckets (rows, m) and signs as the scatter kernel computes them:
    ``ab = a*i + b mod 2^32``, then :func:`count_sketch.fast_divmod`."""
    a = np.asarray([int(t) for t in a], np.uint64)[:, None]
    b = np.asarray([int(t) for t in b], np.uint64)[:, None]
    ab = (a * np.asarray(i, np.uint64)[None, :] + b) & np.uint64(0xFFFFFFFF)
    q, h = count_sketch.fast_divmod(ab, cols)
    return h.astype(np.int64), \
        np.where(q & np.uint64(1), -1.0, 1.0).astype(np.float32)


def _divmod_values(cols, count, rng):
    """uint64 (len(cols), count): 0, 1, 2^32 - 1, k*cols - 1, k*cols and
    k*cols + 1 for the two largest k with k*cols below 2^32, then seeded
    uniform draws."""
    c = np.asarray(cols, np.int64)[:, None]
    top = (1 << 32) // c
    near = np.concatenate([k * c + d for k in (top, top - 1)
                           for d in (-1, 0, 1)], axis=1)
    near = np.minimum(near, (1 << 32) - 1).astype(np.uint64)
    fixed = np.broadcast_to(np.array([0, 1, (1 << 32) - 1], np.uint64),
                            (c.shape[0], 3))
    draws = rng.integers(0, 1 << 32, size=(c.shape[0], count - 9),
                         dtype=np.uint64)
    return np.concatenate([fixed, near, draws], axis=1), c.astype(np.uint64)


def test_division_free_hash_exact_and_bit_equal():
    """The scatter kernel's multiply-high division (Granlund and
    Montgomery) equals ``//`` and ``%`` exactly: 64 values at every
    non-power-of-two width from 3 to 4,095 and 4,096 at 500, 70,000 and
    131,071; the buckets and signs built from it equal the reference's
    ``bucket_and_sign`` bit for bit at 32,768 x 5 x 3,276."""
    rng = np.random.default_rng(23)
    widths = [c for c in range(3, 4096) if c & (c - 1)]
    for cols, count in ((widths, 64), ([500, 70_000, 131_071], 4096)):
        ab, c = _divmod_values(cols, count, rng)
        magic = tuple(np.array(v, np.uint64)[:, None] for v in
                      zip(*(count_sketch.divisor_magic(w) for w in cols)))
        assert (magic[0] < np.uint64(1 << 32)).all()
        q, h = count_sketch.fast_divmod(ab, c, magic)
        np.testing.assert_array_equal(q, ab // c)
        np.testing.assert_array_equal(h, ab % c)
    n, rows, cols = 32_768, 5, 3276
    h_k, s_k = _kernel_hash(np.arange(n), *jax_hash_params(rows), cols)
    h_j, s_j = sk_jax.bucket_and_sign(jnp.arange(n, dtype=jnp.int32),
                                      *sk_jax.hash_params(rows), cols)
    np.testing.assert_array_equal(h_k, np.asarray(h_j))
    np.testing.assert_array_equal(s_k, np.asarray(s_j))


def _paper_lm_scatter_leaves():
    """(n, rows, cols) of every paper_lm leaf below 40,960 elements at 3
    and 5 rows, with the adapted width."""
    sizes = sorted(set(Model(get_arch("paper_lm")).param_sizes()))
    return [(n, r, sk_t.CountSketch(r, 4096)._cols(n))
            for n in sizes if n < 40_960 for r in (3, 5)]


def _covered_once(plan):
    """Every element in exactly one CTA's range (spans of a multiple of 4),
    every (row, column) in exactly one row group, column tile and merge
    slice; a CTA's shared memory within the H100's opt-in."""
    elems = np.zeros(plan.n, np.int64)
    for g in range(plan.ctas):
        lo, hi = plan.cta_range(g)
        elems[lo:hi] += 1
    assert plan.span % 4 == 0 and (elems == 1).all()
    cells = np.zeros((plan.rows, plan.cols), np.int64)
    for r0, g in plan.groups():
        for c0, w in plan.tiles():
            for m0, m1 in count_sketch.merge_slices(w, plan.cluster):
                cells[r0:r0 + g, c0 + m0:c0 + m1] += 1
    assert (cells == 1).all()
    assert plan.smem <= 232_448


@pytest.mark.parametrize("cluster", [8, 16])
def test_scatter_plan_covers_once(cluster):
    """Every paper_lm leaf below 40,960 elements runs as one cluster of one
    launch; 5,000 x 10 x 500 (two row groups) and 500,000 x 2 x 70,000
    (column tiles, several clusters) cover the sketch exactly once."""
    for n, rows, cols in _paper_lm_scatter_leaves():
        plan = count_sketch.scatter_plan(n, rows, cols, cluster)
        assert (plan.clusters, plan.ctas, plan.launches) == \
            (1, cluster, 1), (n, rows, cols)
        assert plan.scratch_floats == 0
        _covered_once(plan)
    for n, rows, cols, groups, tiles in ((5000, 10, 500, 2, 1),
                                         (500_000, 2, 70_000, 1, 3)):
        plan = count_sketch.scatter_plan(n, rows, cols, cluster)
        assert (len(plan.groups()), len(plan.tiles())) == (groups, tiles)
        _covered_once(plan)
    assert count_sketch.scatter_plan(32_768, 5, 3276, 16).span == 2048
    assert count_sketch.scatter_plan(500_000, 2, 70_000, 16, 7).clusters == 7


@pytest.mark.parametrize("n,rows,cols,cluster,smem", [
    (32_768, 5, 3276, 16, count_sketch.SMEM_OPTIN),
    (140_000, 10, 1000, 8, 16_000)])
def test_scatter_plan_emulation_matches_reference(n, rows, cols, cluster,
                                                  smem):
    """The scatter path emulated in numpy from its plan: a partial per CTA
    (the sketch of its range with the division-free hash), each tile's
    merge slices summed in rank order, clusters summed in order, within
    1e-5 of each bucket's mass of the reference's ``sketch``; the second
    shape has 3 clusters, 2 row groups and 2 column tiles."""
    x = _x(n, n + rows)
    plan = count_sketch.scatter_plan(n, rows, cols, cluster, 0, smem)
    h, s = _kernel_hash(np.arange(n), *jax_hash_params(rows), cols)
    sx = s * x[None, :]
    S = np.zeros((rows, cols), np.float32)
    for r0, g in plan.groups():
        for c0, w in plan.tiles():
            acc = np.zeros((g, w), np.float32)
            for k in range(plan.clusters):
                parts = []
                for r in range(cluster):
                    lo, hi = plan.cta_range(k * cluster + r)
                    part = np.zeros((g, w), np.float32)
                    for j in range(g):
                        hc = h[r0 + j, lo:hi] - c0
                        keep = (hc >= 0) & (hc < w)
                        part[j] = np.bincount(hc[keep],
                                              weights=sx[r0 + j, lo:hi][keep],
                                              minlength=w)
                    parts.append(part)
                merged = np.zeros((g, w), np.float32)
                for m0, m1 in count_sketch.merge_slices(w, cluster):
                    for part in parts:
                        merged[:, m0:m1] += part[:, m0:m1]
                acc += merged
            S[r0:r0 + g, c0:c0 + w] = acc
    assert plan.clusters == (1 if n < 65_536 else 3)
    _within_mass(S, _jax_sketch(jnp.asarray(x), rows, cols),
                 _mass(x, rows, cols), f"emulated plan n={n}")


@pytest.mark.parametrize("n,rows,cols", [(1024, 3, 256), (4096, 5, 512)])
def test_ref_count_sketch_matches_reference_and_pallas(n, rows, cols):
    """The plain sketch against the reference's oracle and its Pallas
    kernel (interpret mode), within 1e-5 of each bucket's mass."""
    x = _x(n, n + rows)
    a_j, b_j = sk_jax.hash_params(rows)
    a_t, b_t = jax_hash_params(rows)
    S_t = ref_count_sketch(torch.from_numpy(x), a_t, b_t, rows, cols).numpy()
    M = _mass(x, rows, cols)
    _within_mass(S_t, ref_jax.ref_count_sketch(jnp.asarray(x), a_j, b_j,
                                               rows, cols), M, "oracle")
    _within_mass(S_t, count_sketch_pallas(jnp.asarray(x), a_j, b_j, rows,
                                          cols, interpret=True), M, "pallas")
    S_w = count_sketch.count_sketch_plain(torch.from_numpy(x), a_t, b_t,
                                          rows, cols)
    np.testing.assert_array_equal(S_w.numpy(), S_t)


@pytest.mark.parametrize("n", [3001, 5000])
def test_flat_sketch_wrapper_matches_reference(n, monkeypatch):
    """``ops.sketch`` on a ragged n (the reference pads to its 1024 chunk),
    chunked finer than n so the chunk seams are crossed."""
    monkeypatch.setattr(sk_t, "CHUNK", 1000)
    x = _x(n, 3 * n)
    S_t = ops.sketch(torch.from_numpy(x), 3, 256)
    S_j = ops_jax.sketch(jnp.asarray(x), 3, 256)
    _within_mass(S_t.numpy(), S_j, _mass(x, 3, 256), f"ops.sketch n={n}")


@pytest.mark.parametrize("rows", [3, 4, 5])
def test_unsketch_bitexact(rows, monkeypatch):
    """The median-of-rows estimate for the same S, bit for bit: the
    midpoint rule at an even row count too, across chunk seams."""
    monkeypatch.setattr(sk_t, "CHUNK", 1500)
    n, cols = 5000, 64
    S = _x(rows * cols, rows).reshape(rows, cols)
    S[0, :7] = 0.0                       # empty buckets give signed zeros
    est_j = np.asarray(sk_jax.unsketch(jnp.asarray(S), n))
    est_t = sk_t.unsketch(torch.from_numpy(S), n).numpy()
    np.testing.assert_array_equal(est_t, est_j)


def test_count_sketch_wire_round_matches_reference():
    """One EF ``sketch>>qsgd:8`` sim round on paper_lm, 2 clients: the
    port's local update gives the client deltas, which go through the
    port's ``wire_rows`` -> ``aggregate_rows`` -> fedavg -> ledger and the
    reference's: its wire compiled at optimization level 0 (the rows are
    compared at the sketch's table tolerance, and this compiles in about
    a third of :func:`ieee_jit`'s time), the aggregate and the server
    step with one rounding per op (:func:`ieee_jit`)."""
    kw = dict(uplink_compressor="sketch>>qsgd:8", local_steps=2,
              local_lr=0.1)
    mj, mt = ModelJax(get_arch_jax("paper_lm")), Model(get_arch("paper_lm"))
    flj, flt = FLConfigJax(backend="jax", **kw), FLConfig(backend="kernel",
                                                          **kw)
    terms_j, up_j, down_j = EJ.ledger_terms(mj, flj)
    terms_t, up_t, down_t = ET.ledger_terms(mt, flt)
    assert up_t.name.replace("@kernel", "") == up_j.name == \
        "ef(sketch5x4096>>qsgd8)"
    assert terms_t == terms_j
    disp_j = EJ.make_dispatch(mj, flj, up_j, down_j, C, SEQ)
    disp_t = ET.make_dispatch(mt, flt, up_t, down_t, C, SEQ)
    params_t = mt.init(0, "cpu")
    params_j = jax.tree.map(jnp.asarray, params_to_jax(params_t))
    batch = sample_round(FedDataConfig(vocab_size=256, num_clients=C,
                                       seq_len=SEQ, batch_per_client=2,
                                       heterogeneity=2.0), 0, "cpu")
    deltas_t, _, _ = disp_t.local_update(params_t,
                                         ET.Dispatch.model_batch(batch))
    deltas_j = jax.tree.map(jnp.asarray, params_to_jax(deltas_t))
    k_up = jax.random.split(jax.random.PRNGKey(0), 5)[3]

    rows_j, _ = quick_jit(disp_j.wire_rows)(
        deltas_j, EJ.comm_state_init(up_j, params_j, C), k_up)
    w_j = jnp.asarray(batch["sizes"].numpy())
    agg_j = ieee_jit(disp_j.aggregate_rows)(rows_j, w_j,
                                            jnp.maximum(w_j.sum(), 1e-9))
    params_j, _ = ieee_jit(functools.partial(SJ.apply, flj))(params_j, agg_j,
                                                             {})
    led_j = EJ._make_ledger(terms_j, (w_j > 0).sum().astype(jnp.float32))

    rows_t, _ = disp_t.wire_rows(
        deltas_t, ET.comm_state_init(up_t, params_t, C, "cpu"), JaxKey(k_up))
    w_t = batch["sizes"]
    agg_t = disp_t.aggregate_rows(rows_t, w_t, torch.clamp(w_t.sum(),
                                                           min=1e-9))
    params_t, _ = ST.apply(flt, params_t, agg_t, {})
    _same_ledger(ET._make_ledger(terms_t, (w_t > 0).sum().to(torch.float32)),
                 led_j)
    for what, got, want in (("rows", rows_t, rows_j),
                            ("aggregate", agg_t, agg_j),
                            ("params", params_t, params_j)):
        for (name, a), e in zip(got.items(), _tree_np(want)):
            scale = max(float(np.abs(e).max()), 1e-6)
            np.testing.assert_allclose(a.numpy(), e, rtol=1e-3,
                                       atol=1e-3 * scale,
                                       err_msg=f"{what} {name}")
