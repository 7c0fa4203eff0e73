"""The star, hierarchical and gossip topologies over ``torch.distributed``
against the reference's ``shard_map`` engines.

One subprocess runs the reference on 4 host devices (meshes ``(4, 1)`` and
``(2, 2, 1)``) while one gloo group of 4 CPU ranks runs the port
(``repro_torch.launch.mesh.run_ranks``), each rank one client, on the same
numpy-made params and batches and the same local objective
(tests/topology_cases.py): a gradient in one rounding in both packages,
so the wire, the aggregation, the server step and the ledger compare bit
for bit; the reference's keys reach the ranks through ``NumpyKey``
(jax.random's threefry in numpy: the ranks import no JAX) and the
reference compiles with ``ieee_jit``'s options.  The ranks then run the
train CLI's rank body.

Tolerances (DESIGN.md §6):
  * params, EF rows, ``selected`` and the ledger bit-exact, but: the
    identity wire's all-reduce and SCAFFOLD's dense control (sums over the
    clients in gloo's order, not XLA's; SCAFFOLD's second round, its
    params and ``c_i`` carry it) within rtol 1e-6 of each array's scale;
    the ternary wire's mu (a sum in another order) likewise, the supports
    exact;
  * losses, ``pod_divergence`` and ``consensus`` (reductions in another
    order) within rtol 1e-5;
  * collective bytes exact: on every rank the wire's operands are the
    payload (``wire_format.payload_nbytes``), summing over the ranks to the
    ledger; the masked runs and telemetry-on runs bit-identical to their
    twins.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.compress import make_compressor as make_j
from repro.compress.wire_format import payload_nbytes as payload_nbytes_j
from repro.core import engine as EJ
from repro_torch.compress.api import make_compressor as make_t
from repro_torch.compress.secure_agg import CTX_BITS
from repro_torch.compress.wire_format import payload_nbytes
from repro_torch.convert import shard_rows, store_from_jax, store_to_jax, \
    unshard_rows
from repro_torch.core import engine as ET
from repro_torch.core.types import FLConfig
from repro_torch.launch.mesh import run_ranks
import topology_cases as TC

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SIZES = [int(np.prod(s)) for s in TC.LEAVES.values()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's npz and the 4 ranks' npz files."""
    out = tmp_path_factory.mktemp("topology")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "topology_cases.py"), "ref",
         str(out / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        # the ranks stay on the CPU: they fork from a server that imported
        # torch and the port once (spawn would import them per rank)
        run_ranks(TC.rank_main, 4, args=(str(out),), timeout=300,
                  start_method="forkserver",
                  preload=["torch", "repro_torch.core.engine",
                           "repro_torch.launch.train", "topology_cases"])
    finally:
        log, _ = ref.communicate(timeout=600)
    assert ref.returncode == 0, log[-3000:]
    return (dict(np.load(out / "ref.npz")),
            [dict(np.load(out / f"rank{r}.npz")) for r in range(4)])


def _leaves(d, key):
    out, i = [], 0
    while f"{key}/{i}" in d:
        out.append(d[f"{key}/{i}"])
        i += 1
    return out


def _unshard(ranks, key, lead):
    """The ranks' rows of ``key`` back in one (lead, ...)-led list."""
    rows = [_leaves(r, key) for r in ranks]
    return unshard_rows([tuple(r) for r in rows], lead)


def _same(got, want, what, rtol=None):
    """Bit-exact, or within ``rtol`` of each array's largest magnitude with
    the supports exact."""
    assert len(got) == len(want) > 0, what
    for a, e in zip(got, want):
        if rtol is None:
            np.testing.assert_array_equal(a, e, err_msg=what)
        else:
            np.testing.assert_array_equal(a == 0, e == 0, err_msg=what)
            np.testing.assert_allclose(
                a, e, rtol=rtol, atol=rtol * float(np.abs(e).max()),
                err_msg=what)


def _same_metrics(got, want, case, keys=("loss", "pod_divergence",
                                          "consensus")):
    for f in ("uplink_wire", "uplink_entropy", "downlink_wire",
              "uplink_dense", "downlink_dense"):
        np.testing.assert_array_equal(got[f"{case}/ledger/{f}"],
                                      want[f"{case}/ledger/{f}"],
                                      err_msg=f"{case} ledger {f}")
    for k in keys:
        if f"{case}/{k}" in want:
            np.testing.assert_allclose(got[f"{case}/{k}"], want[f"{case}/{k}"],
                                       rtol=1e-5, atol=1e-12,
                                       err_msg=f"{case} {k}")
    if f"{case}/selected" in want:
        np.testing.assert_array_equal(got[f"{case}/selected"],
                                      want[f"{case}/selected"])


def test_graph_helpers_match_reference():
    """``mixing_matrix``, ``check_doubly_stochastic``, the expander and the
    Erdős–Rényi matchings, the Topology constructors and their errors."""
    for n, deg in ((4, 4), (8, 4), (8, 2), (5, 3)):
        assert ET.expander_graph(n, deg) == EJ.expander_graph(n, deg)
    for n, p, seed in ((6, 0.5, 0), (8, 0.3, 2), (5, 0.9, 1)):
        assert ET.erdos_renyi_graph(n, p, seed) == \
            EJ.erdos_renyi_graph(n, p, seed)
    swap = (((1, 0, 3, 2), 0.5),)             # an explicit permutation
    for graph, C in ((((1, 0.25), (-1, 0.25)), 4), (EJ.expander_graph(8), 8),
                     (EJ.erdos_renyi_graph(6, 0.5, 0), 6), (swap, 4)):
        np.testing.assert_array_equal(ET.mixing_matrix(graph, C),
                                      EJ.mixing_matrix(graph, C))
        ET.check_doubly_stochastic(ET.mixing_matrix(graph, C))
    for bad in ((((1, 0.6), (-1, 0.6)), 4), ((((0, 1, 2, 2), 0.5),), 4)):
        with pytest.raises(ValueError) as want:
            EJ.check_doubly_stochastic(EJ.mixing_matrix(*bad))
        with pytest.raises(ValueError) as got:
            ET.check_doubly_stochastic(ET.mixing_matrix(*bad))
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no edges"):
        ET.erdos_renyi_graph(4, 0.0)
    assert ET.Topology.gossip_expander(8) == ET.Topology.gossip(
        EJ.expander_graph(8))
    assert (ET.Topology.hier(3).sync_every, ET.Topology.star("pod")
            .client_axis, ET.Topology.gossip().graph) == (
        EJ.Topology.hier(3).sync_every, EJ.Topology.star("pod").client_axis,
        EJ.Topology.gossip().graph)


def test_payload_bytes_equal_the_reference_and_the_ledger():
    """``payload_nbytes`` equals the reference's for every wire of this
    slice, and ``wire_bits / 8`` on the packed specs at every length and on
    the staged ones at this file's leaf sizes (a staged QSGD plane is
    padded to whole blocks, which the ledger does not bill).  The
    reference's count of a SecAgg payload includes its context (key u32[2],
    ring index, cohort: ``CTX_BITS``), which every rank here rebuilds from
    the shared mask key and the sender's index instead of moving it."""
    for spec, wire in (("qsgd:8", "staged"), ("topk:0.25>>qsgd:8", "staged"),
                       ("ternary", "packed"), ("topk:0.05>>qsgd:4@fused",
                                               "staged"),
                       ("qsgd:8>>secagg", "staged"), ("none", "staged")):
        pj = make_j(spec, wire_format=wire)
        pt = make_t(spec, wire_format=wire)
        for n in (8, 128, 3001, 16384):
            got = payload_nbytes(pt, n)
            ctx = CTX_BITS // 8 if "secagg" in spec else 0
            assert got + ctx == payload_nbytes_j(pj, n), (spec, n)
            if wire == "packed" or "@fused" in spec or n in SIZES:
                assert 8 * got == pt.wire_bits(n) == pj.wire_bits(n), \
                    (spec, n)


def test_state_rows_shard_and_unshard():
    """``convert.shard_rows`` / ``unshard_rows`` on (C,) and (G, Ce) trees
    (EF state with a SecAgg context) and through the port's row types."""
    rng = np.random.default_rng(0)
    for lead, index in (((4,), lambda r: (r,)),
                        ((2, 2), lambda r: divmod(r, 2))):
        tree = ({"residual": rng.standard_normal(lead + (5,)),
                 "inner": ()},
                {"mask_key": np.zeros(lead + (2,), np.uint32),
                 "mask_idx": np.zeros(lead, np.int32),
                 "mask_cohort": np.zeros(lead, np.int32),
                 "inner": {"residual": rng.standard_normal(lead + (3,))}})
        rows = [store_to_jax(store_from_jax(shard_rows(tree, index(r))))
                for r in range(4)]
        assert rows[1][0]["residual"].shape == (1,) * len(lead) + (5,)
        back = unshard_rows(rows, lead)
        for a, e in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, e)


def test_star_matches_reference(runs):
    """Each star chain (FedSGD on the identity wire, EF
    ``topk:0.25>>qsgd:8``, packed ``ternary``, SCAFFOLD on ``qsgd:8``), 2
    rounds, against the reference's star: params on every rank, the EF
    rows and SCAFFOLD's c_i rows put back together, its control, the
    metrics and the ledger."""
    ref, ranks = runs
    for case, _ in TC.STAR:
        rtol = None if case == "star_ef" else 1e-6
        for r, d in enumerate(ranks):
            _same(_leaves(d, f"{case}/params"), _leaves(ref, f"{case}/params"),
                  f"{case} rank {r} params", rtol)
            _same_metrics(d, ref, case)
        if case in ("star_ef", "star_ternary"):
            _same(jax.tree.leaves(_unshard(ranks, f"{case}/comm_state",
                                           (4,))),
                  _leaves(ref, f"{case}/comm_state"), f"{case} EF rows", rtol)
    _same(jax.tree.leaves(_unshard(ranks, "star_scaffold/client_controls",
                                   (4,))),
          _leaves(ref, "star_scaffold/client_controls"), "scaffold c_i",
          1e-6)
    _same(_leaves(ranks[2], "star_scaffold/control"),
          _leaves(ref, "star_scaffold/control"), "scaffold control", 1e-6)


def test_hier_matches_reference(runs):
    """Hier at pod 2 x data 2 (EF ``topk:0.25>>qsgd:8`` on the edge,
    ``qsgd8`` on the cloud hop of round 2) against the reference's
    ``make_hier_fl_train_step`` engine: each rank's pod params against the
    reference's row, the (G, Ce) EF grid, the metrics (``pod_divergence``
    0 after the cloud round) and the ledger."""
    ref, ranks = runs
    pods = _leaves(ref, "hier/params")
    for r, d in enumerate(ranks):
        g = int(d["coords"][0])
        _same(_leaves(d, "hier/params"), [p[g] for p in pods],
              f"hier rank {r} pod {g} params")
        _same_metrics(d, ref, "hier")
        assert d["hier/pod_divergence"][0] > 0
        assert d["hier/pod_divergence"][1] == 0.0
    _same(jax.tree.leaves(_unshard(ranks, "hier/comm_state", (2, 2))),
          _leaves(ref, "hier/comm_state"), "hier EF grid")


def test_gossip_matches_reference(runs):
    """The ring on ``qsgd:8`` and the 4-node expander on EF
    ``topk:0.25>>qsgd:8`` against the reference's gossip: every node's
    params and EF row, the consensus and the ledger."""
    ref, ranks = runs
    for case, _, _ in TC.GOSSIP:
        nodes = _leaves(ref, f"{case}/params")
        for r, d in enumerate(ranks):
            _same(_leaves(d, f"{case}/params"), [p[r] for p in nodes],
                  f"{case} node {r}")
            _same_metrics(d, ref, case)
        if case == "gossip_expander":
            _same(jax.tree.leaves(_unshard(ranks, f"{case}/comm_state",
                                           (4,))),
                  _leaves(ref, f"{case}/comm_state"), f"{case} EF rows")


def _by_round(d, case, hop):
    hops, rounds = d[f"{case}/coll/hop"], d[f"{case}/coll/round"]
    return [d[f"{case}/coll/nbytes"][(hops == hop) & (rounds == r)].sum()
            for r in range(TC.ROUNDS)]


def test_collective_bytes_and_dtypes_equal_the_ledger(runs):
    """Every rank's wire operands are its payload (per leaf
    ``payload_nbytes``), the ranks' sum is the ledger's uplink; the staged
    ``qsgd`` wire gathers int8, the packed one uint8 and no int8 or f32
    code plane (f32 only as scales and mu), only the identity wire
    all-reduces f32; SCAFFOLD's dense control is f32 and billed beside the
    payload; hier sends edge_wire every round and cloud_wire over each
    data index's pod group on cloud rounds; gossip sends the payload once
    per directed edge (mix_wire)."""
    ref, ranks = runs
    for case, _ in TC.STAR + (("star_ef_secagg", None),):
        up = make_t(**_spec(case))
        per = sum(payload_nbytes(up, n) for n in SIZES)
        led = ranks[0][f"{case}/ledger/uplink_wire"]
        for d in ranks:
            assert _by_round(d, case, "wire") == [per] * TC.ROUNDS, case
            dt = set(d[f"{case}/coll/dtype"][d[f"{case}/coll/hop"]
                                             == "wire"])
            ops = set(d[f"{case}/coll/op"][d[f"{case}/coll/hop"] == "wire"])
            if case == "star_fedsgd":
                assert (dt, ops) == ({"torch.float32"}, {"all_reduce"})
                continue
            assert ops == {"all_gather"}, case
            numel = d[f"{case}/coll/numel"][
                (d[f"{case}/coll/hop"] == "wire")
                & (d[f"{case}/coll/dtype"] == "torch.float32")]
            assert (numel <= 8).all(), (case, numel)     # scales and mu
            if case == "star_ternary":
                assert "torch.uint8" in dt and "torch.int8" not in dt
            else:
                assert "torch.int8" in dt and "torch.uint8" not in dt
        scale = 2 if case == "star_scaffold" else 1
        np.testing.assert_array_equal(led, np.float32(scale * 4 * per))
    dense = [_by_round(d, "star_scaffold", "dense") for d in ranks]
    assert dense == [[4 * sum(SIZES)] * TC.ROUNDS] * 4
    assert set(ranks[0]["star_scaffold/coll/dtype"][
        ranks[0]["star_scaffold/coll/hop"] == "dense"]) == {"torch.float32"}
    terms = ref["hier/terms"]
    edge = sum(np.asarray([_by_round(d, "hier", "edge") for d in ranks]))
    np.testing.assert_array_equal(edge, [terms[1]] * TC.ROUNDS)
    for c in (0, 1):
        cloud = sum(np.asarray(_by_round(d, "hier", "cloud"))
                    for d in ranks if d["coords"][1] == c)
        np.testing.assert_array_equal(cloud, [0, terms[2]])
    np.testing.assert_array_equal(ranks[0]["hier/ledger/uplink_wire"],
                                  np.float32([terms[1], terms[1] + terms[2]]))
    for case, _, _ in TC.GOSSIP:
        mix = sum(np.asarray(_by_round(d, case, "mix")) for d in ranks)
        np.testing.assert_array_equal(mix, [ref[f"{case}/terms"][3]] * 2)
        np.testing.assert_array_equal(ranks[0][f"{case}/ledger/uplink_wire"],
                                      np.float32([ref[f"{case}/terms"][3]]
                                                 * 2))


def _spec(case):
    kw = TC.fl_kw(case)
    return dict(spec=kw["uplink_compressor"],
                wire_format=kw.get("wire_format", "staged"))


def test_secagg_masked_equals_clear_on_every_topology(runs):
    """The masked star, hier edge and gossip mix equal their clear twins bit
    for bit: params, EF rows (the mask context dropped), the ledger but the
    entropy bill, the losses; the masked collectives move the same
    bytes."""
    _, ranks = runs
    for masked, clear in TC.MASKED.items():
        for d in ranks:
            _same(_leaves(d, f"{masked}/params"),
                  _leaves(d, f"{clear}/params"), masked)
            got = [a for a in _leaves(d, f"{masked}/comm_state")
                   if a.dtype != np.uint32 and a.dtype != np.int32]
            if got or _leaves(d, f"{clear}/comm_state"):
                _same(got, _leaves(d, f"{clear}/comm_state"),
                      f"{masked} rows")
            np.testing.assert_array_equal(d[f"{masked}/loss"],
                                          d[f"{clear}/loss"])
            np.testing.assert_array_equal(d[f"{masked}/ledger/uplink_wire"],
                                          d[f"{clear}/ledger/uplink_wire"])
            np.testing.assert_array_equal(d[f"{masked}/coll/nbytes"],
                                          d[f"{clear}/coll/nbytes"])


def test_telemetry_on_equals_off(runs):
    """Hier and gossip with the flight recorder on equal the runs without
    it; the stage slots sum to the ledger, and hier's pod slot is 0 on the
    edge round and cloud_wire on the cloud round."""
    ref, ranks = runs
    for on, off in TC.TELEMETRY.items():
        for d in ranks:
            _same(_leaves(d, f"{on}/params"), _leaves(d, f"{off}/params"), on)
            if _leaves(d, f"{off}/comm_state"):
                _same(_leaves(d, f"{on}/comm_state"),
                      _leaves(d, f"{off}/comm_state"), f"{on} rows")
            for k in ("loss", "ledger/uplink_wire", "pod_divergence",
                      "consensus"):
                if f"{off}/{k}" not in d:
                    continue
                np.testing.assert_array_equal(d[f"{on}/{k}"], d[f"{off}/{k}"])
            slots = d[f"{on}/rs/up_stage_bytes"]
            np.testing.assert_array_equal(slots.sum(1, dtype=np.float32),
                                          d[f"{off}/ledger/uplink_wire"])
    pod = ranks[0]["hier_tele/rs/up_stage_bytes"][:, -1]
    np.testing.assert_array_equal(pod, np.float32([0.0, ref["hier/terms"][2]]))


def test_guards_and_not_ported_messages():
    """The reference's hier and gossip guards (population, scenario,
    SCAFFOLD, DGC), a mesh-less mesh topology, and the knobs the port does
    not run: pod-level clients and FSDP's data-axis dims.  A population on
    the star builds (its guards and rounds are in
    test_torch_mesh_population.py), and so does hier on a model axis (its
    rounds are in test_torch_mesh_model_axis.py)."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.population import ClientPopulation
    from repro_torch.launch import mesh as M
    from repro_torch.models.model import Model
    model = Model(get_arch("paper_lm"))
    pop = ClientPopulation(n_clients=100, cohort=4)
    fake = M.Mesh(shape={"data": 4, "model": 1}, rank=0,
                  device=torch.device("cpu"), backend="gloo", groups={})
    for topo in (ET.Topology.hier(2), ET.Topology.gossip()):
        with pytest.raises(ValueError, match="pins every client"):
            ET.make_round_engine(model, FLConfig(), topo, mesh=fake,
                                 population=pop)
        with pytest.raises(ValueError, match="scenario client dynamics"):
            ET.make_round_engine(model, FLConfig(scenario_dropout=0.1), topo,
                                 mesh=fake)
        with pytest.raises(ValueError, match="needs a mesh"):
            ET.make_round_engine(model, FLConfig(), topo)
    with pytest.raises(AssertionError, match="needs a pod axis"):
        ET.make_round_engine(model, FLConfig(), ET.Topology.hier(2),
                             mesh=fake)
    pods = M.Mesh(shape={"pod": 2, "data": 2, "model": 1}, rank=0,
                  device=torch.device("cpu"), backend="gloo", groups={})
    with pytest.raises(AssertionError, match="control-variate"):
        ET.make_round_engine(model, FLConfig(algorithm="scaffold"),
                             ET.Topology.hier(2), mesh=pods)
    with pytest.raises(ValueError, match="dgc_momentum accumulates"):
        ET.make_round_engine(model, FLConfig(uplink_compressor="topk",
                                             dgc_momentum=0.9),
                             ET.Topology.gossip(), mesh=fake)
    star = ET.make_round_engine(model, FLConfig(), ET.Topology.star(),
                                mesh=fake, population=pop)
    assert [h for h, _ in star.round_fn.hops][:2] == ["rng", "cohort"]
    with pytest.raises(NotImplementedError, match="repro.models.sharding"):
        ET.make_round_engine(model, FLConfig(), ET.Topology.star("pod"),
                             mesh=pods)
    model2 = M.Mesh(shape={"pod": 2, "data": 2, "model": 2}, rank=0,
                    device=torch.device("cpu"), backend="gloo", groups={})
    hier = ET.make_round_engine(model, FLConfig(), ET.Topology.hier(2),
                                mesh=model2)
    assert hier.aux == {"n_pods": 2, "clients_per_pod": 2}
    fsdp = Model(dataclasses.replace(get_arch("paper_lm"), fsdp=True))
    with pytest.raises(NotImplementedError, match="repro.models.sharding"):
        ET.make_round_engine(fsdp, FLConfig(), ET.Topology.hier(2),
                             mesh=model2)
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="give --nproc"):
        train.main(["--hierarchical", "--device", "cpu"])


@pytest.mark.parametrize("kind", ["star", "hier"])
def test_cli_ranks_on_cpu(runs, kind):
    """``launch.train.main`` with ``--nproc 4 --device cpu --dist-backend
    gloo`` in each rank of the group (a process that already is a rank runs
    its own part; the spawn is the fixture's ``run_ranks``): the star, and
    ``--hierarchical`` at pod 2 x data 2 with the cloud hop on round 2;
    rank 0 prints, the other ranks print nothing."""
    _, ranks = runs
    assert [list(d["coords"]) for d in ranks] == [[0, 0], [0, 1], [1, 0],
                                                   [1, 1]]   # pod-major
    lines = str(ranks[0][f"cli/{kind}"]).splitlines()
    assert lines[0].startswith(f"{kind} mesh="), lines
    assert "backend=gloo devices=['cpu', 'cpu', 'cpu', 'cpu']" in lines[0]
    rounds = [ln for ln in lines if ln.startswith("round")]
    assert len(rounds) == 2, lines
    if kind == "hier":
        assert "mesh={'pod': 2, 'data': 2, 'model': 1}" in lines[0]
        assert "pod_divergence=0 " in rounds[1], rounds
    else:
        assert all("selected=4" in ln for ln in rounds), rounds
    assert all(str(d[f"cli/{kind}"]) == "" for d in ranks[1:])


def test_numpy_keys_draw_jax_random():
    """The ranks' :class:`topology_cases.NumpyKey` splits, folds and draws
    (uniforms, 8/16/32-bit masks) exactly as ``jax.random``."""
    import jax.numpy as jnp
    k, j = TC.NumpyKey.seed(0), jax.random.PRNGKey(0)
    np.testing.assert_array_equal(np.asarray(j), np.array(k.k))
    for n in (2, 5):
        np.testing.assert_array_equal(np.asarray(jax.random.split(j, n)),
                                      np.array([x.k for x in k.split(n)]))
    k = k.split(5)[3].fold_in(1).fold_in(0x5eca66)
    j = jax.random.fold_in(jax.random.fold_in(jax.random.split(j, 5)[3], 1),
                           0x5eca66)
    np.testing.assert_array_equal(np.array(k.k), np.asarray(j))
    for shape in ((3, 7), (8, 2048), ()):
        np.testing.assert_array_equal(
            k.uniform(shape, "cpu").numpy(),
            np.asarray(jax.random.uniform(j, shape, jnp.float32)))
    for w in (8, 16, 32):
        np.testing.assert_array_equal(
            k.bits((5, 9), w, "cpu").numpy(),
            np.asarray(jax.random.bits(j, (5, 9), jnp.dtype(f"uint{w}")))
            .astype(np.int64))
