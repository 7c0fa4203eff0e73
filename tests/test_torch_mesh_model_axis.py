"""Hier and gossip on the model axis, and UVeQ's and RandMask's
key-carrying payloads across ranks, against the reference.

One subprocess runs the reference's hier on 8 host devices, mesh ``(2, 2,
2)`` over ``("pod", "data", "model")``, and its gossip and star on ``(4,
2)`` over ``("data", "model")``, while one gloo group of 8 CPU ranks runs
the port's on the same meshes (tests/mesh_model_axis_cases.py): every
model rank of a client (a gossip node) trains its whole update and
encodes its block of every leaf, and a key in a payload crosses as its
plane (8 bytes).  The inputs, the local objective and the keys are
tests/topology_cases.py's, on tests/model_axis_cases.py's four paper_lm
leaves (every layout at model 2).

Tolerances (test_torch_topology.py's classes):
  * params on every rank and the pipeline rows put back together from the
    ranks' blocks (EF residuals, DGC's ``u``, ``v`` and warm-up round
    counter, the counter's copies equal on every model rank) bit-exact on
    hier's EF ``topk:0.25>>qsgd:8``, ``uveq:4``, ``randmask`` and DGC
    with warm-up, gossip's EF and ``uveq:4`` on the ring, the star's
    ``randmask``; the ledger exact; losses, ``pod_divergence`` and
    ``consensus`` (reductions in another order) within rtol 1e-5;
  * each rank's collective bytes by hop and round equal to its planes;
    RandMask's planes equal the ledger's bits, UVeQ's 32 bits above them
    per leaf (its 64-bit key plane against the ledger's 32-bit seed);
  * ``train.main`` at ``--nproc 8 --hierarchical --model-parallel 2``
    bit-equal to the engine on the same mesh.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.compress.api import make_compressor as make_j
from repro.compress.wire_format import payload_nbytes as payload_nbytes_j
from repro_torch.compress.api import make_compressor
from repro_torch.compress.wire_format import payload_nbytes, payload_planes
from repro_torch.core import aggregation
from repro_torch.core import engine as ET
from repro_torch.core.rng import Key, PRNGKey
from repro_torch.core.types import FLConfig
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import sharding as ST
import mesh_model_axis_cases as MMC
import model_axis_cases as MC
import topology_cases as TC

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# each leaf's model dim at model 2, in leaf order
DIMS = [0, None, 2, 1]
BLOCKS = [int(np.prod(ST.block_shape(s, d, 2)))
          for s, d in zip(MC.LEAVES.values(), DIMS)]
RANKS = 8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's npz and the 8 ranks' npz files."""
    out = tmp_path_factory.mktemp("mesh_model_axis")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "mesh_model_axis_cases.py"),
         "ref", str(out / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        run_ranks(MMC.rank_main, RANKS, args=(str(out),), timeout=300,
                  start_method="forkserver",
                  preload=["torch", "repro_torch.core.engine",
                           "repro_torch.launch.train",
                           "mesh_model_axis_cases"])
    finally:
        log, _ = ref.communicate(timeout=600)
    assert ref.returncode == 0, log[-3000:]
    return (dict(np.load(out / "ref.npz")),
            [dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)])


def _leaves(d, key):
    out, i = [], 0
    while f"{key}/{i}" in d:
        out.append(d[f"{key}/{i}"])
        i += 1
    return out


def _rows(ranks, key, want, lead):
    """The client-led state rows of ``key`` put back together from the
    ranks' blocks (client k's model ranks are ranks 2k and 2k + 1, each
    row ``lead`` dims of 1 ahead of its block): a row shaped like the
    whole (a replicated leaf's, a warm-up counter) must be the same on
    both model ranks."""
    per = [_leaves(d, key) for d in ranks]
    assert len(per[0]) == len(want) > 0, key
    out = []
    for i, w in enumerate(want):
        whole = w.shape[lead:]
        rows = []
        for k in range(len(ranks) // 2):
            a, b = (per[2 * k + j][i].reshape(per[2 * k + j][i].shape[lead:])
                    for j in (0, 1))
            if a.shape == whole:
                np.testing.assert_array_equal(a, b, err_msg=f"{key} {i}")
                rows.append(a)
            else:
                dim = [j for j in range(a.ndim) if a.shape[j] != whole[j]][0]
                rows.append(np.concatenate([a, b], dim))
        out.append(np.stack(rows).reshape(w.shape))
    return out


def _same(got, want, what):
    assert len(got) == len(want) > 0, what
    for a, e in zip(got, want):
        assert a.shape == e.shape, (what, a.shape, e.shape)
        np.testing.assert_array_equal(a, e, err_msg=what)


def _same_metrics(got, want, case):
    for f in ("uplink_wire", "uplink_entropy", "downlink_wire",
              "uplink_dense", "downlink_dense"):
        np.testing.assert_array_equal(got[f"{case}/ledger/{f}"],
                                      want[f"{case}/ledger/{f}"],
                                      err_msg=f"{case} ledger {f}")
    for k in ("loss", "pod_divergence", "consensus"):
        if f"{case}/{k}" in want:
            np.testing.assert_allclose(got[f"{case}/{k}"], want[f"{case}/{k}"],
                                       rtol=1e-5, atol=1e-12,
                                       err_msg=f"{case} {k}")


def _check_case(runs, case, node_of, lead):
    """Params on every rank against its node's (``node_of(rank)``; None:
    the replicated params), the pipeline rows, the metrics."""
    ref, ranks = runs
    want = _leaves(ref, f"{case}/params")
    for r, d in enumerate(ranks):
        k = node_of(r)
        _same(_leaves(d, f"{case}/params"),
              want if k is None else [w[k] for w in want],
              f"{case} rank {r} params")
        _same_metrics(d, ref, case)
    rows = _leaves(ref, f"{case}/comm_state")
    if rows:
        _same(_rows(ranks, f"{case}/comm_state", rows, lead), rows,
              f"{case} pipeline rows")
    return rows


def test_key_planes_round_trip():
    """A port ``Key`` crosses as one int64 (its digest) and a
    ``NumpyKey`` as its two uint32 words; the rebuilt key draws the same
    values, and a UVeQ or RandMask payload rebuilt from its planes decodes
    bit-equal.  ``payload_nbytes`` counts the key's 8 bytes, as the
    reference's does its ``u32[2]`` key; a payload leaf that is neither a
    tensor nor a key raises naming ``repro.core.aggregation``."""
    k = PRNGKey(5).split(3)[1].fold_in(7)
    p = k.plane()
    assert (p.dtype, p.numel() * p.element_size()) == (torch.int64, 8)
    back = Key.from_plane(p)
    assert back.seed_int() == k.seed_int()
    assert torch.equal(back.uniform((3, 5), "cpu"), k.uniform((3, 5), "cpu"))
    assert torch.equal(back.normal((7,), "cpu"), k.normal((7,), "cpu"))
    nk = TC.NumpyKey.seed(0).split(4)[2].fold_in(3)
    p = nk.plane()
    assert (p.dtype, p.numel() * p.element_size()) == (torch.int32, 8)
    back = TC.NumpyKey.from_plane(p)
    assert back.k == nk.k
    np.testing.assert_array_equal(back.uniform((4, 9), "cpu").numpy(),
                                  nk.uniform((4, 9), "cpu").numpy())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(5000)
                         .astype(np.float32))
    for spec in ("uveq:4", "randmask"):
        pipe = make_compressor(spec)
        for key in (k, nk):
            payload, _ = pipe.encode(pipe.init((5000,)), key, x)
            planes = payload_planes(payload)
            assert sum(t.numel() * t.element_size() for t in planes
                       if t.dtype in (torch.int64, torch.int32)) == 8
            rebuilt = aggregation._rebuild(payload, planes, None)
            assert torch.equal(pipe.decode(rebuilt, 5000),
                               pipe.decode(payload, 5000)), spec
        pj = make_j(spec)
        for n in (256, 3001, 8192, 16384):
            assert payload_nbytes(pipe, n) == payload_nbytes_j(pj, n), \
                (spec, n)
    with pytest.raises(NotImplementedError, match="repro.core.aggregation"):
        aggregation.check_payload(make_compressor("uveq:4"),
                                  {"q": x, "useed": "not a key"})


@pytest.mark.parametrize("case", [c for c, _ in MMC.HIER])
def test_hier_at_model_2_matches_reference(runs, case):
    """Hier at pod 2 x data 2 x model 2 against the reference's on
    ``mesh3``: EF with an edge round, then a ``qsgd8`` cloud round; UVeQ,
    RandMask and DGC with a cloud round every round on the identity pod
    hop.  Every rank's params are its pod's, the pipeline rows on the (G,
    Ce) grid put back together from the blocks (DGC's warm-up counter the
    same on both model ranks), ``pod_divergence`` 0 exactly after the
    cloud rounds, the ledger exact."""
    rows = _check_case(runs, case, lambda r: r // 4, 2)
    assert bool(rows) == (case in ("hier_ef", "hier_dgc"))
    if case == "hier_dgc":
        assert [a.dtype.kind for a in rows].count("i") == len(MC.LEAVES)
    cloud = [(r + 1) % MMC.fl_kw(case)["sync_every"] == 0
             for r in range(MMC.rounds(case))]
    for d in runs[1]:
        div = d[f"{case}/pod_divergence"]
        assert [v == 0.0 for v in div] == cloud, (case, div)


@pytest.mark.parametrize("case", [c for c, _ in MMC.GOSSIP])
def test_gossip_at_model_2_matches_reference(runs, case):
    """Gossip on the ring at data 4 x model 2, 2 rounds from per-node
    params, against the reference's on ``(4, 2)``: every rank's params
    are its node's, the EF rows put back together from the blocks, the
    consensus and the ledger."""
    rows = _check_case(runs, case, lambda r: r // 2, 1)
    assert bool(rows) == (case == "gossip_ef")


def test_star_randmask_at_data_4_model_2_matches_reference(runs):
    """The star at data 4 x model 2 on ``randmask``: each client's model
    ranks encode their blocks with the client's key, whose plane crosses
    with the values; params on every rank and the ledger exact."""
    _check_case(runs, "star_randmask", lambda r: None, 1)
    for d in runs[1]:
        np.testing.assert_array_equal(d["star_randmask/selected"],
                                      runs[0]["star_randmask/selected"])


def test_collective_bytes_are_the_planes(runs):
    """Per rank and round: hier's ``edge`` operands are the payload planes
    of the rank's blocks (a replicated leaf's whole), its ``cloud``
    operands the pod compressor's on the cloud round (on the identity pod
    hop its f32 blocks, rebuilt over ``model``); gossip's ``mix``
    sends its blocks' planes once per ring offset and its ``model`` hop
    moves its f32 blocks; the star's ``wire`` its blocks' planes.  A
    RandMask payload's planes are the ledger's bits (its 64-bit seed
    billed), a UVeQ payload's 32 bits above them at every block (a 64-bit
    key plane against the ledger's 32-bit seed)."""
    _, ranks = runs
    f32 = 4 * sum(BLOCKS)
    for case, _ in MMC.CASES:
        fl = FLConfig(**MMC.fl_kw(case))
        kind, n = MMC.kind(case), MMC.rounds(case)
        pipe = (ET.uplink_pipeline(fl) if kind != "gossip"
                else make_compressor(fl.uplink_compressor,
                                     fraction=fl.topk_fraction))
        per = sum(payload_nbytes(pipe, m) for m in BLOCKS)
        if kind == "hier" and fl.pod_compressor == "none":
            hops = {"edge": per, "cloud": f32, "model": f32}
        elif kind == "hier":
            pod = sum(payload_nbytes(make_compressor(fl.pod_compressor), m)
                      for m in BLOCKS)
            hops = {"edge": per, "cloud": (0, pod), "model": 0}
        else:
            hops = ({"mix": 2 * per, "model": f32} if kind == "gossip"
                    else {"wire": per, "model": 0})
        expect = {h: list(v) if isinstance(v, tuple) else [v] * n
                  for h, v in hops.items()}
        for r, d in enumerate(ranks):
            h, rnd, nb = (d[f"{case}/coll/{k}"] for k in ("hop", "round",
                                                          "nbytes"))
            for hop, want in expect.items():
                got = [int(nb[(h == hop) & (rnd == i)].sum())
                       for i in range(n)]
                assert got == want, (case, r, hop, got, want)
        spec = fl.uplink_compressor
        if spec in ("uveq:4", "randmask"):
            gap = 32 if spec == "uveq:4" else 0
            for m in BLOCKS:
                assert 8 * payload_nbytes(pipe, m) - pipe.wire_bits(m) \
                    == gap, (spec, m)


def test_cli_hierarchical_model_parallel_equals_engine(runs):
    """``train.main(["--nproc", "8", "--hierarchical", "--model-parallel",
    "2", ...])`` in each rank prints the reference's hier mesh (pod 2 x
    data 2 x model 2) on rank 0 and nothing on the others, and every
    rank's params equal, bit for bit, the same cloud round through
    ``make_round_engine`` on that mesh; the ranks' coordinates are
    pod-major and model-minor."""
    _, ranks = runs
    text = str(ranks[0]["cli/stdout"])
    assert ("hier mesh={'pod': 2, 'data': 2, 'model': 2} ranks=8"
            in text), text
    rounds = [ln for ln in text.splitlines() if ln.startswith("round")]
    assert len(rounds) == 1 and "pod_divergence=0 " in rounds[0], text
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
    assert [list(d["coords3"]) for d in ranks] == [
        [g, c, m] for g in (0, 1) for c in (0, 1) for m in (0, 1)]
    assert [list(d["coords42"]) for d in ranks] == [
        [c, m] for c in range(4) for m in (0, 1)]
