"""The cases of tests/test_torch_model_axis.py, run in processes of their
own.

    python tests/model_axis_cases.py ref OUT.npz

runs the reference's star on 4 host devices, mesh ``(2, 2)`` over
``("data", "model")`` (each engine compiled once with ``ieee_jit``'s
options; the masked chain is held to the reference's clear one,
``REF_OF``), and writes its states and metrics.  :func:`rank_main` is one
rank of the port's 4-rank gloo group on the same mesh: rank ``r`` is
client ``r // 2``'s model rank ``r % 2``.

The inputs, the local objective and the keys are tests/topology_cases.py's
(numpy-made params and batches, a gradient in one rounding in both
packages, :class:`topology_cases.NumpyKey` for ``jax.random``'s draws in
the ranks), on four paper_lm leaves, one of each layout at model 2:
``embed`` split on dim 0, ``layers.b0.mixer.wk`` on its last dim (a
block that is not a contiguous run of the flattened leaf),
``layers.b0.mixer.wo`` on dim 1 and ``layers.b0.mixer.ln`` replicated.
"""
import contextlib
import io
import os
import sys

import numpy as np

import population_cases as PC
import topology_cases as TC

LEAVES = {"embed": (256, 128), "layers.b0.mixer.ln": (2, 128),
          "layers.b0.mixer.wk": (2, 128, 64),
          "layers.b0.mixer.wo": (2, 128, 128)}
ROUNDS = 2
# (case, FLConfig knobs) of the star at data 2 x model 2
STAR = (
    ("none", dict(algorithm="fedsgd", local_steps=1,
                  uplink_compressor="none")),
    ("ef", dict(uplink_compressor="topk:0.25>>qsgd:8")),
    ("ternary", dict(uplink_compressor="ternary", wire_format="packed")),
    ("scaffold", dict(algorithm="scaffold", uplink_compressor="qsgd:8")),
    ("ef_secagg", dict(uplink_compressor="topk:0.25>>qsgd:8>>secagg")),
)
# the reference run a port case is held to: the masked chain to the
# clear one (the reference's case_secagg_masked_bitexact holds its own
# masked star equal to its clear star at a model axis of 2; compiling the
# masked round here took 28 s of one core)
REF_OF = {"ef_secagg": "ef"}
# 6 clients, cohort 2, 4 slots under drop: hits, misses and evictions
POP = dict(n_clients=6, cohort=2, capacity=4, eviction="drop")
POP_FL = dict(uplink_compressor="topk:0.25>>qsgd:8")
POP_ROUNDS = 3
DEGENERATE = dict(n_clients=2, cohort=2, capacity=2)
KEYS = ("tokens", "sizes", "resources")
# the train CLI at data 2 x model 2 (paper_lm at full width)
CLI = TC.CLI + ["--model-parallel", "2", "--compressor",
                "topk:0.05>>qsgd:8"]


def fl_kw(case):
    return dict(TC.BASE, **dict(STAR)[case])


def params_np(seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for k, s in LEAVES.items()}


def batch(r, torch_out=False):
    b = {k: v for k, v in TC.batch_np((2,), r).items() if k in KEYS}
    if not torch_out:
        return b
    import torch
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in b.items()}


def tiny_cfg():
    """tests/distributed_cases.py's ``tiny_cfg`` in the port."""
    import torch

    from repro_torch.core.types import ArchConfig
    return ArchConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=96,
                      block_pattern=("attn+mlp",), dtype=torch.float32,
                      remat=False)


def tiny_batch(seed, r=0):
    """A (2 clients, 2, 16) token batch (``distributed_cases.make_batch``'s
    fields), numpy-made."""
    import torch
    t = np.random.default_rng([seed, r]).integers(0, 96, (2, 2, 16))
    t = torch.from_numpy(t)
    return {"tokens": t, "labels": t, "mask": torch.ones((2, 2, 16)),
            "sizes": torch.ones((2,)),
            "resources": torch.from_numpy(np.random.default_rng(seed)
                                          .uniform(0, 1, (2, 4))
                                          .astype(np.float32))}


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def ref_main(path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path[:0] = [TC.SRC, TC.HERE]
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_arch
    from repro.core.compat import make_mesh
    from repro.core.engine import Topology, make_round_engine, \
        uplink_pipeline
    from repro.core.population import ClientPopulation
    from repro.core.types import FLConfig
    from repro.models.model import Model

    model = Model(get_arch("paper_lm"))
    mixer = model.defs["layers"]["b0"]["mixer"]
    model.defs = {"embed": model.defs["embed"],
                  "layers": {"b0": {"mixer": {k: mixer[k]
                                              for k in ("ln", "wk", "wo")}}}}
    model.loss = TC.loss_j
    mesh = make_mesh((2, 2), ("data", "model"))
    p0 = TC.nested({k: jnp.asarray(v) for k, v in params_np(0).items()})
    out = {}

    def run(case, fl, rounds, pop=None):
        eng = make_round_engine(model, fl, Topology.star(), mesh=mesh,
                                chunk=TC.S, population=pop)
        st = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                          jax.eval_shape(eng.init_fn, jax.random.PRNGKey(0)))
        st = dataclasses.replace(st, params=p0, rng=jax.random.PRNGKey(0))
        if pop is not None:
            store = pop.make_store(uplink_pipeline(fl),
                                   model.abstract_params())
            st = dataclasses.replace(st, comm_state=store.init())
        st = jax.device_put(st, eng.state_shardings)
        step = jax.jit(eng.round_fn, compiler_options=PC.IEEE,
                       out_shardings=(eng.state_shardings, None))
        ms = []
        for r in range(rounds):
            st, m = step(st, {k: jnp.asarray(v)
                              for k, v in batch(r).items()})
            ms.append(m)
            if pop is not None:
                out[f"{case}/client/{r}"] = np.asarray(
                    st.comm_state["client"])
        for name in ("params", "control", "client_controls"):
            for i, a in enumerate(jax.tree.leaves(getattr(st, name))):
                out[f"{case}/{name}/{i}"] = np.asarray(a)
        if pop is None:
            for i, a in enumerate(jax.tree.leaves(st.comm_state)):
                out[f"{case}/comm_state/{i}"] = np.asarray(a)
        else:
            PC.store_out(out, f"{case}/store",
                         jax.tree.map(np.asarray, st.comm_state),
                         jax.tree.leaves)
        for k in ("loss", "selected"):
            out[f"{case}/{k}"] = np.stack([np.asarray(m[k]) for m in ms])
        TC._ledger_np(jax.tree.map(lambda *x: np.stack(x),
                                   *[m["ledger"] for m in ms]), out, case)

    for case, _ in STAR:
        if case not in REF_OF:
            run(case, FLConfig(**fl_kw(case)), ROUNDS)
    run("pop_drop", FLConfig(**TC.BASE, **POP_FL), POP_ROUNDS,
        ClientPopulation(**POP))
    np.savez(path, **out)


# ---------------------------------------------------------------------------
# the port: one rank of the 4-rank gloo group
# ---------------------------------------------------------------------------

def rank_main(rank, world, init_method, out_dir):
    import torch

    from repro_torch.compress import residual_store as rs_t
    from repro_torch.configs.registry import get_arch
    from repro_torch.convert import store_to_jax
    from repro_torch.core import aggregation
    from repro_torch.core import engine as ET
    from repro_torch.core import population as pop_t
    from repro_torch.core import scenario as scn_t
    from repro_torch.core.population import ClientPopulation
    from repro_torch.core.types import FLConfig
    from repro_torch.data.synthetic import FedDataConfig, sample_round
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_ranks, make_host_mesh
    from repro_torch.models.model import Model

    dev = init_ranks("gloo", "cpu", rank, world, init_method, timeout=120)
    ET.PRNGKey = pop_t.PRNGKey = scn_t.PRNGKey = TC.NumpyKey.seed
    model = Model(get_arch("paper_lm"))
    model.defs = {k: model.defs[k] for k in LEAVES}
    model.loss = TC.loss_t
    mesh = make_host_mesh(model=2, device=dev)          # (data 2, model 2)
    out = {"coords": np.asarray([mesh.axis_index("data"),
                                 mesh.axis_index("model")]),
           "mesh": np.asarray(str(mesh.shape))}
    p0 = {k: torch.from_numpy(v) for k, v in params_np(0).items()}

    def run(case, m, fl, rounds, pop=None, data=None, params=None):
        eng = ET.make_round_engine(m, fl, ET.Topology.star(), mesh=mesh,
                                   chunk=TC.S if data is None else 16,
                                   population=pop)
        st = eng.state_from_params({k: v.clone() for k, v in
                                    (p0 if params is None
                                     else params).items()})
        aggregation.COLLECTIVES.clear()
        ms, marks, digests = [], [], []
        for r in range(rounds):
            b = batch(r, True) if data is None else data(r)
            st, met = eng.round_fn(st, eng.local_batch(b))
            ms.append(met)
            marks.append(len(aggregation.COLLECTIVES))
            if pop is not None:
                digests.append(PC.digest(rs_t._leaves(st.comm_state)))
                out[f"{case}/client/{r}"] = st.comm_state["client"].numpy()
        out[f"{case}/digests"] = np.asarray(digests)
        for name in ("params", "control", "client_controls"):
            v = getattr(st, name)
            for i, a in enumerate([] if v is None else v.values()):
                out[f"{case}/{name}/{i}"] = a.numpy()
        if pop is None:
            rows = ([] if st.comm_state is None
                    else TC._leaves_np(store_to_jax(st.comm_state)))
            for i, a in enumerate(rows):
                out[f"{case}/comm_state/{i}"] = a
        else:
            PC.store_out(out, f"{case}/store", store_to_jax(st.comm_state),
                         TC._leaves_np)
        for k in ("loss", "selected"):
            out[f"{case}/{k}"] = np.stack([x[k].numpy() for x in ms])
        for f in ms[0]["ledger"].fields():
            out[f"{case}/ledger/{f}"] = np.stack(
                [getattr(x["ledger"], f).numpy() for x in ms])
        recs = aggregation.COLLECTIVES
        out[f"{case}/coll/hop"] = np.asarray([x.hop for x in recs])
        out[f"{case}/coll/nbytes"] = np.asarray([x.nbytes for x in recs])
        out[f"{case}/coll/round"] = np.searchsorted(
            np.asarray(marks), np.arange(len(recs)), side="right")
        return st

    for case, _ in STAR:
        run(case, model, FLConfig(**fl_kw(case)), ROUNDS)
    run("pop_degenerate", model, FLConfig(**fl_kw("ef")), ROUNDS,
        ClientPopulation(**DEGENERATE))
    run("pop_drop", model, FLConfig(**TC.BASE, **POP_FL), POP_ROUNDS,
        ClientPopulation(**POP))

    # the reference's distributed cases on the port's real tiny model
    tiny = Model(tiny_cfg())
    tp0 = tiny.init(0, dev)
    fl = FLConfig(algorithm="fedsgd", local_steps=1, local_lr=0.1,
                  uplink_compressor="none", server_opt="fedavg",
                  server_lr=1.0)
    b0 = tiny_batch(1)
    st = run("tiny_fedsgd", tiny, fl, 1, data=lambda r: b0, params=tp0)
    flat = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in b0.items()
            if k in ("tokens", "labels", "mask")}
    params = {k: v.clone().requires_grad_(True) for k, v in tp0.items()}
    grads = torch.autograd.grad(tiny.loss(params, flat, chunk=16)[0],
                                list(params.values()))
    out["tiny_fedsgd/err"] = np.asarray(max(
        float((st.params[k] - (tp0[k] - 0.1 * g)).abs().max())
        for k, g in zip(params, grads)))
    out["tiny_fedsgd/n_params"] = np.asarray(tiny.param_count())
    fl = FLConfig(algorithm="fedavg", local_steps=2, local_lr=0.2,
                  uplink_compressor="topk:0.25>>qsgd:8")
    for case, pop in (("tiny_dense", None),
                      ("tiny_pop", ClientPopulation(**DEGENERATE))):
        run(case, tiny, fl, 3, pop=pop, data=lambda r: tiny_batch(1, r),
            params=tp0)

    # the train CLI's rank body at --nproc 4 --model-parallel 2, and the
    # engine run it should equal
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        st, _ = train.main(CLI)
    out["cli/stdout"] = np.asarray(text.getvalue())
    for name, a in st.params.items():
        out[f"cli/params/{name}"] = a.numpy()
    full = Model(get_arch("paper_lm"))
    fl = FLConfig(local_steps=1, local_lr=0.2,
                  uplink_compressor="topk:0.05>>qsgd:8")
    eng = ET.make_round_engine(full, fl, ET.Topology.star(), mesh=mesh,
                               chunk=4)
    data = FedDataConfig(vocab_size=256, num_clients=2, seq_len=4,
                         batch_per_client=1, heterogeneity=1.5, seed=0)
    st, _ = ET.run_rounds(eng, eng.init_fn(0),
                          lambda r: sample_round(data, r, dev), 2)
    for name, a in st.params.items():
        out[f"engine/params/{name}"] = a.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        ref_main(sys.argv[2])
    else:
        raise SystemExit(f"unknown command {sys.argv[1:]}")
