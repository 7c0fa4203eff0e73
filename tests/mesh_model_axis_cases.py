"""The cases of tests/test_torch_mesh_model_axis.py, run in processes of
their own.

    python tests/mesh_model_axis_cases.py ref OUT.npz

runs the reference's hier on 8 host devices, mesh ``(2, 2, 2)`` over
``("pod", "data", "model")`` (tests/distributed_cases.py's ``mesh3``),
and its gossip and star on mesh ``(4, 2)`` over ``("data", "model")``,
each engine compiled once with ``ieee_jit``'s options, and writes their
states and metrics.  :func:`rank_main` is one rank of the port's 8-rank
gloo group on the same meshes: on ``(2, 2, 2)`` rank ``r`` is pod
``r // 4``'s client ``(r // 2) % 2``'s model rank ``r % 2``, on ``(4,
2)`` node (client) ``r // 2``'s model rank ``r % 2``.

The inputs, the local objective and the keys are tests/topology_cases.py's
(numpy-made params and batches, a gradient in one rounding in both
packages, :class:`topology_cases.NumpyKey` for ``jax.random``'s draws in
the ranks, crossing the ranks as its key plane), on
tests/model_axis_cases.py's four paper_lm leaves, one of each layout at
model 2.
"""
import contextlib
import io
import os
import sys

import numpy as np

import model_axis_cases as MC
import population_cases as PC
import topology_cases as TC

LEAVES = MC.LEAVES
# rounds a run: 2 where pipeline state carries over (EF, DGC) or the hier
# EF case's cloud round follows an edge round, 1 for the stateless wires
ROUNDS, STATELESS_ROUNDS = 2, 1
# hier at pod 2 x data 2 x model 2: (case, FLConfig knobs).  The EF case
# runs an edge round, then a cloud round quantized with qsgd8; the others
# a cloud round every round on the identity pod hop (an all-reduce of each
# block, then the rebuild over ``model``), whose reference program is the
# cloud branch alone (its round_fn would compile the edge branch too)
HIER = (
    ("hier_ef", dict(uplink_compressor="topk:0.25>>qsgd:8",
                     pod_compressor="qsgd8", sync_every=2)),
    ("hier_uveq", dict(uplink_compressor="uveq:4", pod_compressor="none",
                       sync_every=1)),
    ("hier_randmask", dict(uplink_compressor="randmask", topk_fraction=0.1,
                           pod_compressor="none", sync_every=1)),
    ("hier_dgc", dict(uplink_compressor="topk", topk_fraction=0.25,
                      dgc_momentum=0.9, dgc_warmup_rounds=1,
                      pod_compressor="none", sync_every=1)),
)
# gossip on the ring at data 4 x model 2
GOSSIP = (
    ("gossip_ef", dict(uplink_compressor="topk:0.25>>qsgd:8")),
    ("gossip_uveq", dict(uplink_compressor="uveq:4")),
)
# the star at data 4 x model 2
STAR = (("star_randmask", dict(uplink_compressor="randmask",
                               topk_fraction=0.1)),)
CASES = HIER + GOSSIP + STAR
# the batch fields and client grid of each topology
KEYS = {"hier": ("tokens", "sizes"), "gossip": ("tokens",),
        "star": ("tokens", "sizes", "resources")}
LEAD = {"hier": (2, 2), "gossip": (4,), "star": (4,)}
# the train CLI's rank body at --nproc 8 --hierarchical --model-parallel 2
# (paper_lm at full width, one cloud round), and the engine run it should
# equal
CLI = ["--nproc", "8", "--device", "cpu", "--dist-backend", "gloo",
       "--hierarchical", "--model-parallel", "2", "--sync-every", "1",
       "--rounds", "1", "--seq", "4", "--batch-per-client", "1",
       "--local-steps", "1", "--compressor", "topk:0.05>>qsgd:8"]


def kind(case):
    return case.split("_")[0]


def fl_kw(case):
    return dict(TC.BASE, **dict(CASES)[case])


def rounds(case):
    spec = fl_kw(case)["uplink_compressor"]
    return STATELESS_ROUNDS if spec in ("uveq:4", "randmask") else ROUNDS


def topology(case, Topology):
    """The case's topology, from either package's ``Topology``."""
    k = kind(case)
    if k == "hier":
        return Topology.hier(fl_kw(case)["sync_every"])
    return Topology.gossip() if k == "gossip" else Topology.star()


def node_params(c):
    """Gossip node ``c``'s params."""
    return MC.params_np(10 + c)


def batch(case, r):
    return {k: v for k, v in TC.batch_np(LEAD[kind(case)], r).items()
            if k in KEYS[kind(case)]}


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def ref_main(path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path[:0] = [TC.SRC, TC.HERE]
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_arch
    from repro.core.compat import make_mesh
    from repro.core.engine import Topology, make_round_engine
    from repro.core.types import FLConfig
    from repro.models.model import Model

    model = Model(get_arch("paper_lm"))
    mixer = model.defs["layers"]["b0"]["mixer"]
    model.defs = {"embed": model.defs["embed"],
                  "layers": {"b0": {"mixer": {k: mixer[k]
                                              for k in ("ln", "wk", "wo")}}}}
    model.loss = TC.loss_j
    mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"))
    mesh42 = make_mesh((4, 2), ("data", "model"))
    p0 = MC.params_np(0)
    params = {
        "hier": TC.nested({k: jnp.stack([v, v]) for k, v in p0.items()}),
        "gossip": TC.nested({k: jnp.stack([node_params(c)[k]
                                           for c in range(4)])
                             for k in LEAVES}),
        "star": TC.nested({k: jnp.asarray(v) for k, v in p0.items()})}
    out = {}
    for case, _ in CASES:
        mesh = mesh3 if kind(case) == "hier" else mesh42
        eng = make_round_engine(model, FLConfig(**fl_kw(case)),
                                topology(case, Topology), mesh=mesh,
                                chunk=TC.S)
        st = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                          jax.eval_shape(eng.init_fn, jax.random.PRNGKey(0)))
        st = jax.device_put(dataclasses.replace(
            st, params=params[kind(case)], rng=jax.random.PRNGKey(0)),
            eng.state_shardings)
        every = fl_kw(case).get("sync_every")
        step = jax.jit(eng.programs["cloud"] if every == 1 else eng.round_fn,
                       compiler_options=PC.IEEE,
                       out_shardings=(eng.state_shardings, None))
        ms = []
        for r in range(rounds(case)):
            st, m = step(st, {k: jnp.asarray(v)
                              for k, v in batch(case, r).items()})
            ms.append(m)
        for name in ("params", "comm_state"):
            for i, a in enumerate(jax.tree.leaves(getattr(st, name))):
                out[f"{case}/{name}/{i}"] = np.asarray(a)
        for k in ("loss", "selected", "pod_divergence", "consensus"):
            if k in ms[0]:
                out[f"{case}/{k}"] = np.stack([np.asarray(m[k]) for m in ms])
        TC._ledger_np(jax.tree.map(lambda *x: np.stack(x),
                                   *[m["ledger"] for m in ms]), out, case)
    np.savez(path, **out)


# ---------------------------------------------------------------------------
# the port: one rank of the 8-rank gloo group
# ---------------------------------------------------------------------------

def rank_main(rank, world, init_method, out_dir):
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.convert import store_to_jax
    from repro_torch.core import aggregation
    from repro_torch.core import engine as ET
    from repro_torch.core.types import FLConfig
    from repro_torch.data.synthetic import FedDataConfig, sample_round
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_ranks, make_host_mesh
    from repro_torch.models.model import Model

    dev = init_ranks("gloo", "cpu", rank, world, init_method, timeout=120)
    ET.PRNGKey = TC.NumpyKey.seed
    model = Model(get_arch("paper_lm"))
    model.defs = {k: model.defs[k] for k in LEAVES}
    model.loss = TC.loss_t
    mesh3 = make_host_mesh(model=2, pod=2, data=2, device=dev)
    mesh42 = make_host_mesh(model=2, device=dev)          # (data 4, model 2)
    out = {"coords3": np.asarray([mesh3.axis_index(a)
                                  for a in ("pod", "data", "model")]),
           "coords42": np.asarray([mesh42.axis_index(a)
                                   for a in ("data", "model")])}
    for case, _ in CASES:
        mesh = mesh3 if kind(case) == "hier" else mesh42
        eng = ET.make_round_engine(model, FLConfig(**fl_kw(case)),
                                   topology(case, ET.Topology), mesh=mesh,
                                   chunk=TC.S)
        p = (node_params(mesh.axis_index("data")) if kind(case) == "gossip"
             else MC.params_np(0))
        st = eng.state_from_params({k: torch.from_numpy(v)
                                    for k, v in p.items()})
        aggregation.COLLECTIVES.clear()
        ms, marks = [], []
        for r in range(rounds(case)):
            b = {k: torch.from_numpy(v.astype(np.int64)
                                     if v.dtype == np.int32 else v)
                 for k, v in batch(case, r).items()}
            st, m = eng.round_fn(st, eng.local_batch(b))
            ms.append(m)
            marks.append(len(aggregation.COLLECTIVES))
        for i, a in enumerate(st.params.values()):
            out[f"{case}/params/{i}"] = a.numpy()
        rows = ([] if st.comm_state is None
                else TC._leaves_np(store_to_jax(st.comm_state)))
        for i, a in enumerate(rows):
            out[f"{case}/comm_state/{i}"] = a
        for k in ("loss", "pod_divergence", "consensus", "selected"):
            if k in ms[0]:
                out[f"{case}/{k}"] = np.stack([x[k].numpy() for x in ms])
        for f in ms[0]["ledger"].fields():
            out[f"{case}/ledger/{f}"] = np.stack(
                [getattr(x["ledger"], f).numpy() for x in ms])
        recs = aggregation.COLLECTIVES
        out[f"{case}/coll/hop"] = np.asarray([x.hop for x in recs])
        out[f"{case}/coll/nbytes"] = np.asarray([x.nbytes for x in recs])
        out[f"{case}/coll/round"] = np.searchsorted(
            np.asarray(marks), np.arange(len(recs)), side="right")

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        st, _ = train.main(CLI)
    out["cli/stdout"] = np.asarray(text.getvalue())
    for name, a in st.params.items():
        out[f"cli/params/{name}"] = a.numpy()
    full = Model(get_arch("paper_lm"))
    fl = FLConfig(local_steps=1, local_lr=0.2, hierarchical=True,
                  sync_every=1, uplink_compressor="topk:0.05>>qsgd:8")
    eng = ET.make_round_engine(full, fl, ET.Topology.hier(1), mesh=mesh3,
                               chunk=4)
    data = FedDataConfig(vocab_size=256, num_clients=4, seq_len=4,
                         batch_per_client=1, heterogeneity=1.5, seed=0)

    def data_fn(r):
        return {k: v.reshape((2, 2) + tuple(v.shape[1:]))
                for k, v in sample_round(data, r, dev).items()
                if k in ("tokens", "labels", "mask")}
    st, _ = ET.run_rounds(eng, eng.init_fn(0), data_fn, 1)
    for name, a in st.params.items():
        out[f"engine/params/{name}"] = a.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        ref_main(sys.argv[2])
    else:
        raise SystemExit(f"unknown command {sys.argv[1:]}")
