"""The star over a ``ClientPopulation`` across ``torch.distributed`` ranks,
and the mesh CLI's ``--trace`` and ``--checkpoint``, against the
reference.

One subprocess runs the reference's star over a population on 4 host
devices (mesh ``(4, 1)``) while one gloo group of 4 CPU ranks runs the
port's (tests/population_cases.py) on the same numpy-made params and
batches and the same local objective as tests/test_torch_topology.py; the
ranks draw the reference's keys, cohorts and tail hash through
``topology_cases.NumpyKey``.  Every rank holds a replica of the residual
store; each round the advanced rows cross under the ``store`` hop.

Tolerances:
  * the degenerate population (n_clients = cohort = capacity = 4) against
    the port's dense star: params and slab rows bit-equal;
  * cohort 4 of 12 into 8 slots under ``drop`` (4 rounds: misses, hits,
    LRU evictions): params, the store (slab, client, stamp, clock),
    ``selected`` and the ledger bit-exact against the reference, losses
    within rtol 1e-5 (test_torch_topology.py's classes);
  * cohort 4 of 1,000,000 under ``sketch``: client, stamp, clock,
    ``selected`` and the ledger exact; the tail within rtol 1e-5 of each
    array's largest magnitude, the params and slab rows at engine scope
    (rtol 1e-4 / atol 1e-6 on >= 99.9% of each array), which is
    test_torch_population.py's class (the floor's and gamma's f32 sums
    run in another order);
  * every rank's replica bit-identical after every round, collective
    bytes exact: ``wire`` the payload (the ranks' sum the ledger),
    ``store`` one advanced row a rank a round.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as get_arch_j
from repro.core import engine as EJ
from repro.core.compat import make_mesh as make_mesh_j
from repro.core.population import ClientPopulation as PopJ
from repro.core.types import FLConfig as FLConfigJ
from repro.models.model import Model as ModelJ
from repro_torch.compress.wire_format import payload_nbytes
from repro_torch.configs.registry import get_arch
from repro_torch.core import engine as ET
from repro_torch.core.population import ClientPopulation
from repro_torch.core.types import FLConfig
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models.model import Model
import population_cases as PC
import topology_cases as TC

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SIZES = [int(np.prod(s)) for s in TC.LEAVES.values()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's npz, the 4 ranks' npz files and their directory
    (the CLI's traces and checkpoints)."""
    out = tmp_path_factory.mktemp("mesh_population")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "population_cases.py"), "ref",
         str(out / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        run_ranks(PC.rank_main, 4, args=(str(out),), timeout=300,
                  start_method="forkserver",
                  preload=["torch", "repro_torch.core.engine",
                           "repro_torch.launch.train", "population_cases"])
    finally:
        log, _ = ref.communicate(timeout=600)
    assert ref.returncode == 0, log[-3000:]
    return (dict(np.load(out / "ref.npz")),
            [dict(np.load(out / f"rank{r}.npz")) for r in range(4)], out)


def _leaves(d, key):
    out, i = [], 0
    while f"{key}/{i}" in d:
        out.append(d[f"{key}/{i}"])
        i += 1
    return out


def _engine_scope(got, want, what):
    assert len(got) == len(want) > 0, what
    for a, e in zip(got, want):
        close = np.isclose(a, e, rtol=1e-4, atol=1e-6)
        assert close.mean() >= 0.999, (what, close.mean())


def test_numpy_keys_draw_jax_randint_and_permutation():
    """NumpyKey's ``randint`` (int32 bounds, scalar and vector shapes, the
    uint32 wrap of jax's multiplier) and ``permutation`` (one and two sort
    rounds) equal ``jax.random``'s, and so do the tail's hash parameters
    drawn through them; the reference's process compiles with
    ``ieee_jit``'s options."""
    from repro.compress.sketch import hash_params
    from test_torch_jaxkeys import IEEE_OPTIONS
    assert PC.IEEE == IEEE_OPTIONS
    for seed in (0, 3):
        k = TC.NumpyKey.seed(seed).fold_in(5)
        j = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
        for lo, hi, shape in ((0, 12, ()), (0, 1_000_000, ()), (4, 4, ()),
                              (1, 1 << 30, (5,)), (0, 64, (5,))):
            np.testing.assert_array_equal(
                k.randint(lo, hi, shape, "cpu").numpy(),
                np.asarray(jax.random.randint(j, shape, lo, hi)))
        for n in (12, 2000):
            np.testing.assert_array_equal(
                k.permutation(n, "cpu").numpy(),
                np.asarray(jax.random.permutation(j, n)))
    for rows, seed in ((5, 23), (5, 17)):
        got, want = PC.numpy_hash_params(rows, seed), hash_params(rows, seed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_degenerate_population_star_equals_dense_star(runs):
    """n_clients = cohort = capacity = 4: every rank's params and its slab
    bit-equal to the dense star's params and EF rows (slot i holds client
    i), the cohort hop first after rng."""
    _, ranks, _ = runs
    for r, d in enumerate(ranks):
        assert list(d["pop_degenerate/hops"][:3]) == ["rng", "cohort",
                                                      "downlink"]
        for a, e in zip(_leaves(d, "pop_degenerate/params"),
                        _leaves(d, "dense/params")):
            np.testing.assert_array_equal(a, e, err_msg=f"rank {r}")
        np.testing.assert_array_equal(d["pop_degenerate/store/client/0"],
                                      [0, 1, 2, 3])
        slab = _leaves(d, "pop_degenerate/store/slab")
        dense = [_leaves(x, "dense/rows") for x in ranks]
        assert len(slab) == len(dense[0]) == 1
        np.testing.assert_array_equal(
            slab[0], np.concatenate([rows[0] for rows in dense]))


@pytest.mark.parametrize("case", ["pop_drop", "pop_sketch"])
def test_population_star_matches_reference(runs, case):
    """4 rounds of EF ``topk:0.25>>qsgd:8`` over the population against the
    reference's star: the cohorts (each round's slot clients), every
    rank's params and store, the losses, ``selected`` and the ledger."""
    ref, ranks, _ = runs
    exact = case == "pop_drop"
    for r, d in enumerate(ranks):
        what = f"{case} rank {r}"
        for i in range(PC.ROUNDS):
            np.testing.assert_array_equal(d[f"{case}/client/{i}"],
                                          ref[f"{case}/client/{i}"],
                                          err_msg=f"{what} round {i}")
        for k in ("client", "stamp", "clock"):
            np.testing.assert_array_equal(d[f"{case}/store/{k}/0"],
                                          ref[f"{case}/store/{k}/0"],
                                          err_msg=f"{what} {k}")
        got = (_leaves(d, f"{case}/params")
               + _leaves(d, f"{case}/store/slab"))
        want = (_leaves(ref, f"{case}/params")
                + _leaves(ref, f"{case}/store/slab"))
        if exact:
            assert len(got) == len(want) == 2
            for a, e in zip(got, want):
                np.testing.assert_array_equal(a, e, err_msg=what)
        else:
            _engine_scope(got, want, what)
            tails = _leaves(d, f"{case}/store/tail")
            for a, e in zip(tails, _leaves(ref, f"{case}/store/tail")):
                np.testing.assert_allclose(
                    a, e, rtol=1e-5, atol=1e-5 * float(np.abs(e).max()),
                    err_msg=f"{what} tail")
            assert tails and all(np.abs(t).sum() > 0 for t in tails)
        np.testing.assert_array_equal(d[f"{case}/selected"],
                                      ref[f"{case}/selected"])
        np.testing.assert_allclose(d[f"{case}/loss"], ref[f"{case}/loss"],
                                   rtol=1e-5)
        for f in ("uplink_wire", "uplink_entropy", "downlink_wire",
                  "uplink_dense", "downlink_dense"):
            np.testing.assert_array_equal(d[f"{case}/ledger/{f}"],
                                          ref[f"{case}/ledger/{f}"],
                                          err_msg=f"{what} ledger {f}")


def test_replicas_identical_and_collective_bytes(runs):
    """Every rank's store digest equal after every round, and the store
    counters (hits, misses, evictions: all of them occur) equal on every
    rank; on every rank the ``wire`` hop moves the payload a round (the
    ranks' sum the ledger's uplink) and the ``store`` hop one advanced EF
    row (its f32 residual), so C rows cross the group."""
    _, ranks, _ = runs
    from repro_torch.compress.api import make_compressor
    per = sum(payload_nbytes(make_compressor(PC.FL["uplink_compressor"]), n)
              for n in SIZES)
    row = 4 * sum(SIZES)
    for case in ("pop_degenerate", *PC.POPS):
        digests = [list(d[f"{case}/digests"]) for d in ranks]
        assert len(digests[0]) == PC.ROUNDS
        assert all(x == digests[0] for x in digests), case
        for d in ranks:
            hop, rnd = d[f"{case}/coll/hop"], d[f"{case}/coll/round"]
            nbytes = d[f"{case}/coll/nbytes"]
            for name, want in (("wire", per), ("store", row)):
                got = [int(nbytes[(hop == name) & (rnd == r)].sum())
                       for r in range(PC.ROUNDS)]
                assert got == [want] * PC.ROUNDS, (case, name, got)
            np.testing.assert_array_equal(d[f"{case}/ledger/uplink_wire"],
                                          np.float32(4 * per))
    for case in PC.POPS:
        for f in ("store_hits", "store_misses", "store_evictions"):
            vals = [d[f"{case}/rs/{f}"] for d in ranks]
            assert all(np.array_equal(v, vals[0]) for v in vals), (case, f)
        hits, misses, evictions = (ranks[0][f"{case}/rs/{f}"] for f in (
            "store_hits", "store_misses", "store_evictions"))
        assert misses.sum() > 0 and evictions.sum() > 0, case
        np.testing.assert_array_equal(hits + misses, 4.0)
        np.testing.assert_array_equal(
            ranks[0][f"{case}/rs/up_stage_bytes"].sum(1, dtype=np.float32),
            ranks[0][f"{case}/ledger/uplink_wire"])
    assert ranks[0]["pop_drop/rs/store_hits"].sum() > 0


def test_guards_match_reference():
    """SCAFFOLD over a population and a cohort other than the mesh's client
    count raise the reference's ValueErrors, word for word (one client on
    the reference's one host device, a (1, 1) mesh)."""
    mj, mt = ModelJ(get_arch_j("paper_lm")), Model(get_arch("paper_lm"))
    mesh_j = make_mesh_j((1, 1), ("data", "model"))
    mesh_t = Mesh(shape={"data": 1, "model": 1}, rank=0,
                  device=torch.device("cpu"), backend="gloo", groups={})
    for fl, pop in ((dict(algorithm="scaffold"), dict(n_clients=8,
                                                      cohort=1)),
                    (dict(), dict(n_clients=8, cohort=4))):
        with pytest.raises(ValueError) as want:
            EJ.make_round_engine(mj, FLConfigJ(**fl), EJ.Topology.star(),
                                 mesh=mesh_j, population=PopJ(**pop))
        with pytest.raises(ValueError) as got:
            ET.make_round_engine(mt, FLConfig(**fl), ET.Topology.star(),
                                 mesh=mesh_t,
                                 population=ClientPopulation(**pop))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["star", "hier"])
def test_cli_trace_and_checkpoint_under_nproc(runs, kind):
    """``launch.train.main`` with ``--nproc 4 --device cpu --dist-backend
    gloo --trace --checkpoint`` in each rank: rank 0's trace validates and
    renders (topology ``star`` or ``hier``, a span and a round record per
    round), its stage slots sum to the ledger, the checkpoint restores
    bit-equal to rank 0's final params, and every rank's params equal the
    untraced run's."""
    from repro_torch import checkpoint
    from repro_torch.obs import report
    from repro_torch.obs.trace import validate_file
    _, ranks, out = runs
    recs = validate_file(str(out / f"{kind}.jsonl"))
    assert recs[0]["topology"] == kind and recs[0]["rounds"] == 2
    kinds = [r["kind"] for r in recs]
    assert kinds.count("stages") == 1 and kinds.count("round") == 2
    assert kinds.count("checkpoint") == 1
    assert kinds.count("chunk") + kinds.count("compile") == 2
    text = report.render(report.summarize(recs))
    assert "round" in text and text.strip()
    for r in (x for x in recs if x["kind"] == "round"):
        m = r["m"]
        assert np.float32(sum(np.float32(v) for v in
                              m["round_stats.up_stage_bytes"])) == \
            np.float32(m["ledger.uplink_wire"])
    tag = f"cli/{kind}"
    mine = {k[len(f"{tag}/on/params/"):]: v for k, v in ranks[0].items()
            if k.startswith(f"{tag}/on/params/")}
    back = checkpoint.restore(str(out / f"{kind}.npz"),
                              {k: torch.from_numpy(v) for k, v in
                               mine.items()})
    for name, v in mine.items():
        np.testing.assert_array_equal(back[name].numpy(), v, err_msg=name)
    for d in ranks:
        on = sorted(k for k in d if k.startswith(f"{tag}/on/params/"))
        assert len(on) == len(mine) > 0
        for k in on:
            np.testing.assert_array_equal(
                d[k], d[k.replace("/on/", "/off/")], err_msg=k)
    lines = str(ranks[0][f"{tag}/on/stdout"]).splitlines()
    assert any(ln.startswith("saved ") for ln in lines), lines
    assert all(str(d[f"{tag}/on/stdout"]) == "" for d in ranks[1:])
