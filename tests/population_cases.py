"""The cases of tests/test_torch_mesh_population.py, run in processes of
their own.

    python tests/population_cases.py ref OUT.npz

runs the reference's star over a ``ClientPopulation`` on 4 host devices
(mesh ``(4, 1)``, each engine compiled once with ``ieee_jit``'s options)
and writes its states and metrics.  :func:`rank_main` is one rank of the
port's 4-rank gloo group, which runs the port's dense star, the
degenerate population star and the same population runs on the same
inputs, then the train CLI's rank body with ``--trace`` and
``--checkpoint``.

The inputs, the local objective and the keys are tests/topology_cases.py's:
numpy-made params and batches, a gradient in one rounding in both
packages, and :class:`topology_cases.NumpyKey` for ``jax.random``'s draws
in the ranks (the engine's keys, the cohorts, the sketch tail's hash
parameters).
"""
import hashlib
import os
import sys

import numpy as np

import topology_cases as TC

ROUNDS = 4
FL = dict(TC.BASE, uplink_compressor="topk:0.25>>qsgd:8")
# cohort 4 of 12 into 8 slots (hits, misses and LRU evictions under drop)
# and 4 of 1,000,000 under sketch (the stride sampler; evicted rows fold
# into the tail from round 2, and round 3's misses read it)
POPS = {"pop_drop": dict(n_clients=12, cohort=4, capacity=8,
                         eviction="drop"),
        "pop_sketch": dict(n_clients=1_000_000, cohort=4, capacity=8,
                           eviction="sketch", tail_cols=512)}
DEGENERATE = dict(n_clients=4, cohort=4, capacity=4)
STORE_KEYS = ("client", "stamp", "clock", "slab", "tail")
KEYS = ("tokens", "sizes", "resources")
# test_torch_jaxkeys.IEEE_OPTIONS with the CPU fusion emitters off, here so
# that the reference's process does not import torch
IEEE = {"xla_backend_optimization_level": 0,
        "xla_disable_hlo_passes": "algsimp,fusion",
        "xla_cpu_use_fusion_emitters": False}


def store_out(out, key, store, leaves):
    """The store's arrays by field (``leaves`` lists a tree's arrays in
    ``jax.tree.leaves`` order)."""
    for k in STORE_KEYS:
        if k in store:
            for i, a in enumerate(leaves(store[k])):
                out[f"{key}/{k}/{i}"] = np.asarray(a)


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def ref_main(path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path[:0] = [TC.SRC, TC.HERE]
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.compress import residual_store as rs_j
    from repro.configs.registry import get_arch
    from repro.core.compat import make_mesh
    from repro.core.engine import Topology, make_round_engine, \
        uplink_pipeline
    from repro.core.population import ClientPopulation
    from repro.core.types import FLConfig
    from repro.models.model import Model

    # the tail's hash parameters enter the compiled store as constants of
    # their draw (through NumpyKey) instead of a threefry chain
    rs_j.hash_params = lambda rows, seed=17: tuple(
        jnp.asarray(v.astype(np.uint32)) for v in hash_params_np(rows, seed))

    model = Model(get_arch("paper_lm"))
    mixer = model.defs["layers"]["b0"]["mixer"]
    model.defs = {"layers": {"b0": {"mixer": {"wk": mixer["wk"]}}}}
    model.loss = TC.loss_j
    mesh = make_mesh((4, 1), ("data", "model"))
    p0 = TC.nested({k: jnp.asarray(v) for k, v in TC.params_np(0).items()})
    out = {}
    for case, kw in POPS.items():
        fl = FLConfig(**FL)
        pop = ClientPopulation(**kw)
        eng = make_round_engine(model, fl, Topology.star(), mesh=mesh,
                                chunk=TC.S, population=pop)
        store = pop.make_store(uplink_pipeline(fl), model.abstract_params())
        st = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                          jax.eval_shape(eng.init_fn, jax.random.PRNGKey(0)))
        st = jax.device_put(dataclasses.replace(
            st, params=p0, rng=jax.random.PRNGKey(0),
            comm_state=store.init()), eng.state_shardings)
        step = jax.jit(eng.round_fn, compiler_options=IEEE,
                       out_shardings=(eng.state_shardings, None))
        ms = []
        for r in range(ROUNDS):
            b = {k: jnp.asarray(v) for k, v in TC.batch_np((4,), r).items()
                 if k in KEYS}
            st, m = step(st, b)
            ms.append(m)
            # the slots' clients after each round: the cohort's ids where
            # the scatter put them
            out[f"{case}/client/{r}"] = np.asarray(st.comm_state["client"])
        for i, a in enumerate(jax.tree.leaves(st.params)):
            out[f"{case}/params/{i}"] = np.asarray(a)
        store_out(out, f"{case}/store", jax.tree.map(np.asarray,
                                                     st.comm_state),
                  jax.tree.leaves)
        for k in ("loss", "selected"):
            out[f"{case}/{k}"] = np.stack([np.asarray(m[k]) for m in ms])
        TC._ledger_np(jax.tree.map(lambda *x: np.stack(x),
                                   *[m["ledger"] for m in ms]), out, case)
    np.savez(path, **out)


# ---------------------------------------------------------------------------
# the port: one rank of the 4-rank gloo group
# ---------------------------------------------------------------------------

def hash_params_np(rows, seed=17):
    """The reference's ``sketch.hash_params`` through NumpyKey: the
    multipliers and offsets as int64 numpy arrays."""
    k0, k1 = TC.NumpyKey.seed(seed).split(2)
    return (k0.randint_np(1, 1 << 30, (rows,)) * 2 + 1,
            k1.randint_np(0, 1 << 30, (rows,)))


def numpy_hash_params(rows, seed=17):
    """:func:`hash_params_np` in the port's form (uint32 values in int64
    CPU tensors)."""
    import torch
    return tuple(torch.from_numpy(v) for v in hash_params_np(rows, seed))


def digest(tensors) -> str:
    """A digest of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_main(rank, world, init_method, out_dir):
    import contextlib
    import io

    import torch

    from repro_torch.compress import residual_store as rs_t
    from repro_torch.compress import sketch as sk_t
    from repro_torch.configs.registry import get_arch
    from repro_torch.convert import store_to_jax
    from repro_torch.core import aggregation
    from repro_torch.core import engine as ET
    from repro_torch.core import population as pop_t
    from repro_torch.core import scenario as scn_t
    from repro_torch.core.population import ClientPopulation
    from repro_torch.core.types import FLConfig
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_ranks, make_host_mesh
    from repro_torch.models.model import Model

    dev = init_ranks("gloo", "cpu", rank, world, init_method, timeout=120)
    ET.PRNGKey = pop_t.PRNGKey = scn_t.PRNGKey = TC.NumpyKey.seed
    sk_t.hash_params = numpy_hash_params
    model = Model(get_arch("paper_lm"))
    model.defs = {k: model.defs[k] for k in TC.LEAVES}
    model.loss = TC.loss_t
    mesh = make_host_mesh(device=dev)                       # (data 4, model 1)
    p0 = {k: torch.from_numpy(v) for k, v in TC.params_np(0).items()}
    out = {"idx": np.asarray(mesh.axis_index("data"))}

    for case, pop_kw in (("dense", None), ("pop_degenerate", DEGENERATE),
                         *POPS.items()):
        pop = ClientPopulation(**pop_kw) if pop_kw else None
        # the flight recorder on in the partial cohorts: its store counters
        # read every replica
        fl = FLConfig(**FL, telemetry=case in POPS)
        eng = ET.make_round_engine(model, fl, ET.Topology.star(), mesh=mesh,
                                   chunk=TC.S, population=pop)
        out[f"{case}/hops"] = np.asarray([h for h, _ in eng.round_fn.hops])
        st = eng.state_from_params({k: v.clone() for k, v in p0.items()})
        aggregation.COLLECTIVES.clear()
        ms, marks, digests = [], [], []
        for r in range(ROUNDS):
            b = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                     else v)
                 for k, v in TC.batch_np((4,), r).items() if k in KEYS}
            st, m = eng.round_fn(st, eng.local_batch(b))
            ms.append(m)
            marks.append(len(aggregation.COLLECTIVES))
            if pop is not None and st.comm_state is not None:
                digests.append(digest(rs_t._leaves(st.comm_state)))
                out[f"{case}/client/{r}"] = st.comm_state["client"].numpy()
        out[f"{case}/digests"] = np.asarray(digests)
        for i, a in enumerate(st.params.values()):
            out[f"{case}/params/{i}"] = a.numpy()
        if pop is None:
            rows = TC._leaves_np(store_to_jax(st.comm_state))
            for i, a in enumerate(rows):
                out[f"{case}/rows/{i}"] = a
        else:
            store_out(out, f"{case}/store", store_to_jax(st.comm_state),
                      TC._leaves_np)
        for k in ("loss", "selected"):
            out[f"{case}/{k}"] = np.stack([m[k].numpy() for m in ms])
        for f in ms[0]["ledger"].fields():
            out[f"{case}/ledger/{f}"] = np.stack(
                [getattr(m["ledger"], f).numpy() for m in ms])
        if "round_stats" in ms[0]:
            for f in ("store_hits", "store_misses", "store_evictions",
                      "up_stage_bytes"):
                out[f"{case}/rs/{f}"] = np.stack(
                    [getattr(m["round_stats"], f).numpy() for m in ms])
        recs = aggregation.COLLECTIVES
        rounds = np.searchsorted(np.asarray(marks), np.arange(len(recs)),
                                 side="right")
        out[f"{case}/coll/hop"] = np.asarray([r.hop for r in recs])
        out[f"{case}/coll/nbytes"] = np.asarray([r.nbytes for r in recs])
        out[f"{case}/coll/round"] = rounds

    # the train CLI's rank body (--nproc 4 --device cpu --dist-backend
    # gloo) inside this group, traced with a checkpoint and untraced
    for kind, extra in TC.CLI_RUNS:
        for traced in (True, False):
            argv = TC.CLI + extra
            if traced:
                argv = argv + ["--trace", os.path.join(out_dir,
                                                       f"{kind}.jsonl"),
                               "--checkpoint", os.path.join(out_dir,
                                                            f"{kind}.npz")]
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                st, _ = train.main(argv)
            tag = f"cli/{kind}/{'on' if traced else 'off'}"
            out[f"{tag}/stdout"] = np.asarray(text.getvalue())
            for name, a in st.params.items():
                out[f"{tag}/params/{name}"] = a.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        ref_main(sys.argv[2])
    else:
        raise SystemExit(f"unknown command {sys.argv[1:]}")
