"""The model axis on the star (``repro_torch.models.sharding``,
``--model-parallel``) against the reference.

One subprocess runs the reference's star on 4 host devices, mesh
``(2, 2)`` over ``("data", "model")``, while one gloo group of 4 CPU
ranks runs the port's on the same mesh (tests/model_axis_cases.py): rank
``r`` is client ``r // 2``'s model rank ``r % 2``, trains the client's
whole update and encodes its block of every leaf.  The inputs, the local
objective and the keys are tests/topology_cases.py's, on four paper_lm
leaves that cover every layout at model 2 (dim 0, the last dim, dim 1,
replicated).

Tolerances (test_torch_topology.py's classes):
  * params on every rank, the EF rows put back together from the ranks'
    blocks, SCAFFOLD's c_i and control, ``selected`` and the ledger
    bit-exact against the reference on the identity wire, EF
    ``topk:0.25>>qsgd:8``, SCAFFOLD on ``qsgd:8`` and EF ``>>secagg``
    (held to the reference's clear EF run, which the reference's own
    ``case_secagg_masked_bitexact`` holds equal to its masked one);
    packed ``ternary`` within rtol 1e-6 of each array's scale with the
    supports exact (its mu is a sum in another order); losses within
    rtol 1e-5;
  * 6 clients into 4 slots under ``drop``: params, the store (slab,
    client, stamp, clock) and each round's slot clients bit-exact, every
    rank's replica bit-identical after every round;
  * the degenerate population (n = cohort = capacity = 2) bit-equal to
    the dense star, on the objective and on the port's real tiny model;
  * collective bytes exact: each rank's ``wire`` operand is its blocks'
    payload, ``model`` and ``store`` the rank's f32 blocks;
  * ``spec_for`` equal to the reference's for every leaf of every arch.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as get_arch_j
from repro.models import layers as LJ
from repro.models import sharding as SJ
from repro.models.model import Model as ModelJ
from repro_torch.compress.api import make_compressor
from repro_torch.compress.wire_format import payload_nbytes
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.core import engine as ET
from repro_torch.core.types import FLConfig
from repro_torch.launch import mesh as M
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import sharding as ST
from repro_torch.models.model import Model
import model_axis_cases as MC

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# each leaf's model dim at data 2 x model 2, in leaf order
DIMS = [0, None, 2, 1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's npz and the 4 ranks' npz files."""
    out = tmp_path_factory.mktemp("model_axis")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "model_axis_cases.py"), "ref",
         str(out / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        run_ranks(MC.rank_main, 4, args=(str(out),), timeout=300,
                  start_method="forkserver",
                  preload=["torch", "repro_torch.core.engine",
                           "repro_torch.launch.train", "model_axis_cases"])
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


def _rows_like(ranks, key, want):
    """The (C,)-led state rows of ``key`` put back together from the
    ranks' (1,)-led blocks, each row's block dim read from the whole
    rows ``want`` (a row shaped like the whole is model rank 0's, and
    equals model rank 1's).  A SecAgg context (the mask key, ring index
    and cohort ahead of each leaf's rows, integers) is left out."""
    per = [[a for a in _leaves(d, key) if a.dtype.kind == "f"]
           for d in ranks]
    assert len(per[0]) == len(want) > 0, key
    out = []
    for i, w in enumerate(want):
        rows = []
        for c in range(2):
            a, b = per[2 * c][i], per[2 * c + 1][i]
            if a.shape[1:] == w.shape[1:]:
                np.testing.assert_array_equal(a, b, err_msg=f"{key} {i}")
                rows.append(a)
            else:
                k = [j for j in range(1, a.ndim)
                     if a.shape[j] != w.shape[j]][0]
                rows.append(np.concatenate([a, b], k))
        out.append(np.concatenate(rows))
    return out


def _same(got, want, what, rtol=None):
    """Bit-exact, or within ``rtol`` of each array's largest magnitude with
    the supports exact."""
    assert len(got) == len(want) > 0, what
    for a, e in zip(got, want):
        assert a.shape == e.shape, (what, a.shape, e.shape)
        if rtol is None:
            np.testing.assert_array_equal(a, e, err_msg=what)
        else:
            np.testing.assert_array_equal(a == 0, e == 0, err_msg=what)
            np.testing.assert_allclose(
                a, e, rtol=rtol, atol=rtol * float(np.abs(e).max()),
                err_msg=what)


def _same_metrics(got, want, case):
    """The ledger, ``selected`` and the losses of ``case`` against its
    reference run; a masked run bills its entropy as its wire (masked
    planes are incompressible) and the rest as the clear run."""
    rc = MC.REF_OF.get(case, case)
    for f in ("uplink_wire", "uplink_entropy", "downlink_wire",
              "uplink_dense", "downlink_dense"):
        w = want[f"{rc}/ledger/{f}"]
        if f == "uplink_entropy" and rc != case:
            w = want[f"{rc}/ledger/uplink_wire"]
        np.testing.assert_array_equal(got[f"{case}/ledger/{f}"], w,
                                      err_msg=f"{case} ledger {f}")
    np.testing.assert_array_equal(got[f"{case}/selected"],
                                  want[f"{rc}/selected"])
    np.testing.assert_allclose(got[f"{case}/loss"], want[f"{rc}/loss"],
                               rtol=1e-5, err_msg=f"{case} loss")


class _Shape:
    def __init__(self, shape):
        self.shape = shape


class _Mesh(_Shape):
    """A mesh's shape and axis names, all the reference's spec helpers
    read."""
    @property
    def axis_names(self):
        return tuple(self.shape)


def test_specs_equal_the_reference_for_every_arch(monkeypatch):
    """Every arch's leaves carry the reference's logical axes, in leaf
    order, and ``spec_for`` gives the reference's spec for each at
    ``{data 2, model 2}``, ``{pod 2, data 2, model 2}`` and ``{data 4,
    model 1}``, fsdp off and on, in both FSDP modes; a block and its
    inverse round-trip."""
    meshes = ({"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2},
              {"data": 4, "model": 1})
    for arch in ARCH_IDS:
        mj, mt = ModelJ(get_arch_j(arch)), Model(get_arch(arch))
        defs = jax.tree.leaves(mj.defs, is_leaf=LJ.is_def)
        logical = mt.logical_axes()
        assert list(logical) == list(mt.defs)
        assert [d.logical for d in defs] == list(logical.values()), arch
        for mode in ("extend", "legacy"):
            monkeypatch.setattr(SJ, "FSDP_MODE", mode)
            monkeypatch.setattr(ST, "FSDP_MODE", mode)
            for shape in meshes:
                for fsdp in (False, True):
                    got = ST.tree_specs(
                        {n: d.shape for n, d in mt.defs.items()}, logical,
                        _Shape(shape), fsdp)
                    want = [tuple(SJ.spec_for(d.shape, d.logical,
                                              _Shape(shape), fsdp))
                            for d in defs]
                    assert list(got.values()) == want, (arch, shape, fsdp)
    for shape in meshes:
        for axis in ("data", "pod"):
            assert ST.batch_spec(_Shape(shape), axis) == tuple(
                SJ.batch_spec(_Mesh(shape), axis))
            assert ST.n_clients(_Shape(shape), axis) == \
                SJ.n_clients(_Mesh(shape), axis)
    assert ST.with_prefix({"w": ("model", None)}, "data") == {
        "w": ("data", "model", None)}
    t = torch.arange(2 * 6 * 4).reshape(2, 6, 4)
    for dim in (None, 0, 1, 2):
        blocks = [ST.block(t[None], dim, m, 2, lead=1) for m in range(2)]
        assert blocks[0].is_contiguous()
        assert tuple(blocks[1].shape[1:]) == ST.block_shape(t.shape, dim, 2)
        assert torch.equal(ST.unblock(blocks, dim, lead=1)[0], t)


@pytest.mark.parametrize("case", [c for c, _ in MC.STAR])
def test_star_at_model_2_matches_reference(runs, case):
    """Each chain, 2 rounds at data 2 x model 2, against the reference's
    star on the same mesh: params on every rank, the EF rows put back
    together from the ranks' blocks, SCAFFOLD's c_i (every model rank
    holds its client's whole row) and control, the metrics and the
    ledger.  The masked chain is held to the reference's clear run."""
    ref, ranks = runs
    rc = MC.REF_OF.get(case, case)
    rtol = 1e-6 if case == "ternary" else None
    for r, d in enumerate(ranks):
        _same(_leaves(d, f"{case}/params"), _leaves(ref, f"{rc}/params"),
              f"{case} rank {r} params", rtol)
        _same_metrics(d, ref, case)
    want = _leaves(ref, f"{rc}/comm_state")
    if want:
        _same(_rows_like(ranks, f"{case}/comm_state", want), want,
              f"{case} pipeline rows", rtol)
    if case == "scaffold":
        for r, d in enumerate(ranks):
            _same([a[0] for a in _leaves(d, f"{case}/client_controls")],
                  [a[r // 2] for a in _leaves(ref, f"{case}/client_controls")],
                  f"scaffold c_i rank {r}")
            _same(_leaves(d, f"{case}/control"),
                  _leaves(ref, f"{case}/control"), "scaffold control")


def test_population_drop_matches_reference(runs):
    """6 clients, cohort 2, 4 slots under ``drop``, 3 rounds: each round's
    slot clients, the store (slab, client, stamp, clock), params,
    ``selected`` and the ledger bit-exact on every rank, and every rank's
    replica bit-identical after every round."""
    ref, ranks = runs
    case = "pop_drop"
    digests = [list(d[f"{case}/digests"]) for d in ranks]
    assert len(digests[0]) == MC.POP_ROUNDS
    assert all(x == digests[0] for x in digests)
    for r, d in enumerate(ranks):
        what = f"{case} rank {r}"
        for i in range(MC.POP_ROUNDS):
            np.testing.assert_array_equal(d[f"{case}/client/{i}"],
                                          ref[f"{case}/client/{i}"],
                                          err_msg=f"{what} round {i}")
        for k in ("client", "stamp", "clock", "slab"):
            _same(_leaves(d, f"{case}/store/{k}"),
                  _leaves(ref, f"{case}/store/{k}"), f"{what} {k}")
        _same(_leaves(d, f"{case}/params"), _leaves(ref, f"{case}/params"),
              what)
        _same_metrics(d, ref, case)
    clients = np.stack([ref[f"{case}/client/{i}"]
                        for i in range(MC.POP_ROUNDS)])
    assert len(set(clients.ravel()) - {-1}) > 4     # slots were reused


def test_degenerate_population_equals_dense_star(runs):
    """n = cohort = capacity = 2: params and the slab bit-equal to the
    dense star's params and (put-together) EF rows, on the objective's
    leaves and, as the reference's ``case_population_star_bitexact``, on
    the port's real tiny model over 3 rounds."""
    _, ranks = runs
    for dense, pop in (("ef", "pop_degenerate"),
                       ("tiny_dense", "tiny_pop")):
        rows = _rows_like(ranks, f"{dense}/comm_state",
                          _leaves(ranks[0], f"{pop}/store/slab"))
        for r, d in enumerate(ranks):
            _same(_leaves(d, f"{pop}/params"), _leaves(d, f"{dense}/params"),
                  f"{pop} rank {r}")
            np.testing.assert_array_equal(d[f"{pop}/store/client/0"], [0, 1])
            _same(_leaves(d, f"{pop}/store/slab"), rows, f"{pop} slab")


def test_collective_bytes_are_the_rank_blocks(runs):
    """Per rank and round: the ``wire`` operands are the payloads of its
    blocks (a replicated leaf's whole payload), the identity wire and
    SCAFFOLD's ``dense`` hop all-reduce its f32 blocks and the ``model``
    hop rebuilds them, the population's ``store`` hop is its f32 EF
    blocks; the ledger bills the whole leaves (its gap to the ranks'
    wire sum is the blocks' per-payload overhead)."""
    _, ranks = runs
    blocks = [ST.block_shape(s, dim, 2) for s, dim in
              zip(MC.LEAVES.values(), DIMS)]
    sizes = [int(np.prod(s)) for s in blocks]
    whole = [int(np.prod(s)) for s in MC.LEAVES.values()]
    f32 = 4 * sum(sizes)

    def by_round(d, case, hop, rounds):
        h, rnd, nb = (d[f"{case}/coll/{k}"] for k in ("hop", "round",
                                                      "nbytes"))
        return [int(nb[(h == hop) & (rnd == i)].sum()) for i in range(rounds)]

    for case, kw in MC.STAR + (("pop_drop", MC.POP_FL),):
        rounds = MC.POP_ROUNDS if case == "pop_drop" else MC.ROUNDS
        spec = kw["uplink_compressor"]
        pipe = make_compressor(spec, wire_format=kw.get("wire_format",
                                                        "staged"))
        per = (f32 if spec == "none" else
               sum(payload_nbytes(pipe, n) for n in sizes))
        expect = {"wire": per,
                  "model": f32 if case in ("none", "scaffold") else 0,
                  "dense": f32 if case == "scaffold" else 0,
                  "store": f32 if case == "pop_drop" else 0}
        for d in ranks:
            for hop, want in expect.items():
                assert by_round(d, case, hop, rounds) == [want] * rounds, \
                    (case, hop)
        if spec != "none":
            billed = 2 * sum(pipe.wire_bits(n) for n in whole) / 8
            assert float(ranks[0][f"{case}/ledger/uplink_wire"][0]) \
                == pytest.approx(billed * (2 if case == "scaffold" else 1),
                                 rel=1e-6)


def test_fedsgd_equals_centralized_and_ledger_exact(runs):
    """The reference's ``case_fedsgd_equals_centralized`` and
    ``case_ledger_accounting_exact`` at data 2 x model 2 on the port's
    real tiny model: one FedSGD round on the identity wire equals one
    centralized SGD step over the union batch within 1e-5, and the
    ledger bills 4 bytes x params x C."""
    _, ranks = runs
    n = int(ranks[0]["tiny_fedsgd/n_params"])
    for d in ranks:
        assert float(d["tiny_fedsgd/err"]) < 1e-5
        got = float(d["tiny_fedsgd/ledger/uplink_wire"][0])
        assert abs(got - 4.0 * n * 2) / (4.0 * n * 2) < 1e-6
        _same(_leaves(d, "tiny_fedsgd/params"),
              _leaves(ranks[0], "tiny_fedsgd/params"), "tiny fedsgd")


def test_cli_model_parallel_equals_engine(runs):
    """``train.main(["--nproc", "4", "--model-parallel", "2", ...])`` in
    each rank prints the mesh on rank 0 and nothing on the others, and
    every rank's params equal, bit for bit, the same rounds run through
    ``make_round_engine`` on a ``{data 2, model 2}`` mesh."""
    _, ranks = runs
    text = str(ranks[0]["cli/stdout"])
    assert "star mesh={'data': 2, 'model': 2} ranks=4" in text, text
    assert "round   1" in text
    assert all(str(d["cli/stdout"]) == "" for d in ranks[1:])
    names = [k[len("cli/params/"):] for k in ranks[0]
             if k.startswith("cli/params/")]
    assert len(names) == 12
    for d in ranks:
        for n in names:
            np.testing.assert_array_equal(d[f"cli/params/{n}"],
                                          d[f"engine/params/{n}"], err_msg=n)
            np.testing.assert_array_equal(d[f"cli/params/{n}"],
                                          ranks[0][f"cli/params/{n}"])
    assert str(ranks[0]["mesh"]) == "{'data': 2, 'model': 2}"
    assert [list(d["coords"]) for d in ranks] == [[0, 0], [0, 1], [1, 0],
                                                  [1, 1]]


def test_model_axis_guards():
    """Hier and gossip on a model axis raise naming
    ``repro.models.sharding``; on the star a stage whose state is not
    shaped like its leaf (DGC warm-up's round counter) raises naming
    ``repro.core.aggregation``, while DGC without warm-up builds."""
    model = Model(get_arch("paper_lm"))

    def mesh(shape):
        return M.Mesh(shape=shape, rank=1, device=torch.device("cpu"),
                      backend="gloo", groups={})
    pods = mesh({"pod": 2, "data": 1, "model": 2})
    data = mesh({"data": 2, "model": 2})
    for topo, m in ((ET.Topology.hier(2), pods), (ET.Topology.gossip(), data)):
        with pytest.raises(NotImplementedError,
                           match="repro.models.sharding"):
            ET.make_round_engine(model, FLConfig(), topo, mesh=m)
    dgc = dict(uplink_compressor="topk", dgc_momentum=0.9)
    with pytest.raises(NotImplementedError, match="repro.core.aggregation"):
        ET.make_round_engine(model, FLConfig(**dgc, dgc_warmup_rounds=2),
                             ET.Topology.star(), mesh=data)
    eng = ET.make_round_engine(model, FLConfig(**dgc), ET.Topology.star(),
                               mesh=data)
    st = eng.state_from_params(model.init(0, "cpu"))
    assert tuple(st.comm_state[0]["u"].shape) == (1, 128, 128)   # embed
