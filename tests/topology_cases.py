"""The cases of tests/test_torch_topology.py, run in processes of their own.

    python tests/topology_cases.py ref OUT.npz

runs the reference's star, hierarchical and gossip engines on 4 host
devices (meshes ``(4, 1)`` and ``(2, 2, 1)``; the device count must be set
before jax starts, which the test process must not do) and writes their
states and metrics, each engine compiled once.  :func:`rank_main` is one
rank of the port's 4-rank gloo group (started with ``repro_torch.launch.mesh.run_ranks``), which runs
the port's engines on the same inputs and writes its own.

Both sides take the same numpy-made params and batches and the same local
objective: ``loss(p) = sum_leaves sum(p * c)`` with ``c = p * a + b``
held constant (``stop_gradient`` / ``detach``), ``a`` and ``b`` from the
client's first two tokens, so a gradient is ``c`` in one rounding in both
packages and every later hop (the wire, the aggregation, the server step)
compares bit for bit.  The reference's keys reach the ranks through
:class:`NumpyKey`, ``jax.random``'s default generator (threefry2x32,
partitionable) in numpy, so that the ranks import no JAX; the reference
compiles with :func:`test_torch_jaxkeys.ieee_jit`'s options (one rounding
per op).
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

# paper_lm cut to two leaves (a norm's 128 and a (2, 128, 64) matrix)
LEAVES = {"layers.b0.mixer.wk": (2, 128, 64)}
ROUNDS, B, S = 2, 1, 4
BASE = dict(local_steps=2, local_lr=0.2)
# (case, FLConfig knobs): the star's chains on a (4, 1) mesh
STAR = (
    ("star_fedsgd", dict(algorithm="fedsgd", local_steps=1,
                         uplink_compressor="none")),
    ("star_ef", dict(uplink_compressor="topk:0.25>>qsgd:8")),
    ("star_ternary", dict(uplink_compressor="ternary", wire_format="packed")),
    ("star_scaffold", dict(algorithm="scaffold", uplink_compressor="qsgd:8")),
)
# hier at pod 2 x data 2: EF rows on the (G, Ce) grid, the cloud hop on
# round 2 (sync_every 2)
HIER = ("hier", dict(uplink_compressor="topk:0.25>>qsgd:8",
                     pod_compressor="qsgd8", sync_every=2))
# gossip on the (4, 1) mesh: the ring on QSGD, the power-of-two expander
# with EF rows
GOSSIP = (("gossip_ring", "ring", dict(uplink_compressor="qsgd:8")),
          ("gossip_expander", "expander",
           dict(uplink_compressor="topk:0.25")))
# the port's runs beside those: masked twins (secagg) and telemetry on
# the train CLI's runs: paper_lm at full width, 2 rounds each
CLI = ["--nproc", "4", "--device", "cpu", "--dist-backend", "gloo",
       "--model-parallel", "1", "--rounds", "2", "--seq", "4",
       "--batch-per-client", "1", "--local-steps", "1"]
CLI_RUNS = (("star", ["--compressor", "topk:0.05>>qsgd:8"]),
            ("hier", ["--hierarchical", "--sync-every", "2", "--compressor",
                      "qsgd:8"]))
MASKED = {"star_ef_secagg": "star_ef", "hier_secagg": "hier",
          "gossip_ring_secagg": "gossip_ring"}
TELEMETRY = {"hier_tele": "hier", "gossip_ring_tele": "gossip_ring"}


def fl_kw(case):
    """The FLConfig knobs of any case, the port-only ones included."""
    table = dict(STAR)
    table[HIER[0]] = HIER[1]
    table.update({c: kw for c, _, kw in GOSSIP})
    base = MASKED.get(case) or TELEMETRY.get(case) or case
    kw = dict(BASE, **table[base])
    if case in MASKED:
        kw["uplink_compressor"] += ">>secagg"
    if case in TELEMETRY:
        kw["telemetry"] = True
    return kw


def params_np(seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for k, s in LEAVES.items()}


def nested(flat):
    """Dotted names -> the reference's nested dicts."""
    out = {}
    for key, v in flat.items():
        node = out
        *heads, last = key.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def batch_np(lead, r):
    """Round r's batch over the client grid ``lead``: tokens (lead, B, S),
    sizes in [1, 2) (the star's weights) and resources."""
    rng = np.random.default_rng([7, r])
    fixed = np.random.default_rng(8)
    return {"tokens": rng.integers(0, 256, lead + (B, S)).astype(np.int32),
            "sizes": fixed.uniform(1.0, 2.0, lead).astype(np.float32),
            "resources": fixed.uniform(0.05, 1.0, lead + (4,))
            .astype(np.float32)}


def loss_j(params, batch, chunk=512):
    import jax
    import jax.numpy as jnp
    t = batch["tokens"].astype(jnp.float32)
    a, b = t[0, 0] / 256.0 + 0.5, t[0, 1] / 512.0
    tot = 0.0
    for p in jax.tree.leaves(params):
        tot = tot + jnp.sum(p * (jax.lax.stop_gradient(p) * a + b))
    return tot, {}


def loss_t(params, batch, chunk=512):
    t = batch["tokens"].float()
    a, b = t[0, 0] / 256.0 + 0.5, t[0, 1] / 512.0
    tot = 0.0
    for p in params.values():
        tot = tot + (p * (p.detach() * a + b)).sum()
    return tot, {}


# ---------------------------------------------------------------------------
# jax.random's threefry2x32 in numpy
# ---------------------------------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counts (x1, x2) under key (k1, k2), all
    uint32: ``jax._src.prng``'s five groups of four rounds with a key
    injection after each."""
    u = np.uint32
    ks = (u(k1), u(k2), u(k1) ^ u(k2) ^ u(0x1BD11BDA))
    a = (np.asarray(x1, u) + ks[0]).astype(u)
    b = (np.asarray(x2, u) + ks[1]).astype(u)
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b).astype(u)
            b = ((b << u(r)) | (b >> u(32 - r))).astype(u)
            b = a ^ b
        a = (a + ks[(i + 1) % 3]).astype(u)
        b = (b + ks[(i + 2) % 3] + u(i + 1)).astype(u)
    return a, b


class NumpyKey:
    """A raw ``jax.random`` key (two uint32) behind the port's key
    interface (``split``, ``fold_in``, ``uniform``, ``bits``, ``randint``,
    ``permutation``): the draws of ``jax.random`` under its default
    partitionable threefry, in numpy."""

    def __init__(self, k):
        self.k = (np.uint32(k[0]), np.uint32(k[1]))

    @staticmethod
    def seed(seed):
        return NumpyKey((seed >> 32, seed & 0xFFFFFFFF))

    def plane(self, device=None):
        """The key as a collective moves it: its two uint32 words, as an
        int32 (2,) tensor (8 bytes, the reference's ``u32[2]``)."""
        import torch
        t = torch.from_numpy(np.array(self.k, np.uint32).view(np.int32))
        return t if device is None else t.to(device)

    @classmethod
    def from_plane(cls, plane):
        return cls(plane.cpu().numpy().astype(np.int32).view(np.uint32))

    def split(self, n):
        a, b = threefry2x32(*self.k, np.zeros(n, np.uint32),
                            np.arange(n, dtype=np.uint32))
        return [NumpyKey((a[i], b[i])) for i in range(n)]

    def fold_in(self, data):
        a, b = threefry2x32(*self.k, np.zeros(1, np.uint32),
                            np.asarray([int(data) & 0xFFFFFFFF], np.uint32))
        return NumpyKey((a[0], b[0]))

    def _bits32(self, shape):
        n = int(np.prod(shape))
        a, b = threefry2x32(*self.k, np.zeros(n, np.uint32),
                            np.arange(n, dtype=np.uint32))
        return (a ^ b).reshape(shape)

    def uniform(self, shape, device):
        import torch
        f = ((self._bits32(tuple(shape)) >> np.uint32(9))
             | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
        return torch.from_numpy(np.array(f, np.float32).reshape(shape)) \
            .to(device)

    def bits(self, shape, width, device):
        import torch
        v = self._bits32(tuple(shape)).astype(f"uint{int(width)}")
        return torch.from_numpy(v.astype(np.int64)).to(device)

    def randint(self, low, high, shape, device):
        import torch
        return torch.from_numpy(self.randint_np(low, high, shape)).to(device)

    def randint_np(self, low, high, shape):
        """``jax.random.randint`` in int32 (bounds below 2^31), as int64
        numpy: two words of bits from a split, each reduced mod the span,
        joined with the multiplier ``(2^16 mod span)^2 mod span``, all in
        wrapping uint32."""
        shape = tuple(shape)
        k1, k2 = self.split(2)
        hi = k1._bits32(shape).astype(np.uint64)
        lo = k2._bits32(shape).astype(np.uint64)
        span = np.uint64(high - low if high > low else 1)
        mask = np.uint64(0xFFFFFFFF)
        # jax's (2^16 mod span)^2 mod span, its square wrapping in uint32
        mult = ((np.uint64((1 << 16) % int(span)) ** np.uint64(2)) & mask) \
            % span
        off = (((hi % span) * mult) & mask) + lo % span
        off = (off & mask) % span
        return np.asarray(np.int64(low) + off.astype(np.int64),
                          np.int64).reshape(shape)

    def permutation(self, n, device):
        """``jax.random.permutation(key, n)``: rounds of a stable sort of
        ``arange(n)`` by fresh 32-bit keys, as many as ``jax``'s
        ``_shuffle`` takes (``ceil(3 ln n / ln(2^32 - 1))``)."""
        import torch
        x = np.arange(n, dtype=np.int64)
        key = self
        rounds = int(np.ceil(3 * np.log(max(1, n))
                             / np.log(np.iinfo(np.uint32).max)))
        for _ in range(rounds):
            key, sub = key.split(2)
            x = x[np.argsort(sub._bits32((n,)), kind="stable")]
        return torch.from_numpy(x).to(device)


def _ledger_np(led, out, key):
    for f in ("uplink_wire", "uplink_entropy", "downlink_wire",
              "uplink_dense", "downlink_dense"):
        out[f"{key}/ledger/{f}"] = np.asarray(getattr(led, f),
                                              dtype=np.float32)


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def ref_main(path):
    """The reference's runs, each compiled once with ``ieee_jit``'s options
    and XLA's CPU fusion emitters off (fusion is off already; the option
    only shortens the compile)."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path[:0] = [SRC, HERE]
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_arch
    from repro.core.compat import make_mesh
    from repro.core.engine import Topology, expander_graph, make_round_engine
    from repro.core.types import FLConfig
    from repro.models.model import Model
    from test_torch_jaxkeys import IEEE_OPTIONS

    OPTIONS = dict(IEEE_OPTIONS, xla_cpu_use_fusion_emitters=False)
    model = Model(get_arch("paper_lm"))
    mixer = model.defs["layers"]["b0"]["mixer"]
    model.defs = {"layers": {"b0": {"mixer": {"wk": mixer["wk"]}}}}
    model.loss = loss_j
    mesh4 = make_mesh((4, 1), ("data", "model"))
    mesh22 = make_mesh((2, 2, 1), ("pod", "data", "model"))
    out = {}

    def run(case, topo, mesh, params, lead, keys):
        eng = make_round_engine(model, FLConfig(**fl_kw(case)), topo,
                                mesh=mesh, chunk=S)
        # init_fn's state is zeros but the params and the key: made from
        # its shapes, not run op by op; in and out on the engine's
        # shardings (as RoundRunner pins them), one compilation for both
        # rounds
        st = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                          jax.eval_shape(eng.init_fn, jax.random.PRNGKey(0)))
        st = jax.device_put(dataclasses.replace(
            st, params=params, rng=jax.random.PRNGKey(0)),
            eng.state_shardings)
        step = jax.jit(eng.round_fn, compiler_options=OPTIONS,
                       out_shardings=(eng.state_shardings, None))
        ms = []
        for r in range(ROUNDS):
            b = {k: jnp.asarray(v) for k, v in batch_np(lead, r).items()
                 if k in keys}
            st, m = step(st, b)
            ms.append(m)
        for name in ("params", "comm_state", "control", "client_controls"):
            for i, a in enumerate(jax.tree.leaves(getattr(st, name))):
                out[f"{case}/{name}/{i}"] = np.asarray(a)
        for k in ("loss", "selected", "pod_divergence", "consensus"):
            if k in ms[0]:
                out[f"{case}/{k}"] = np.stack([np.asarray(m[k]) for m in ms])
        _ledger_np(jax.tree.map(lambda *x: np.stack(x),
                                *[m["ledger"] for m in ms]), out, case)
        out[f"{case}/terms"] = np.asarray(
            [eng.terms.get(k, 0.0) for k in ("up_wire", "edge_wire",
                                              "cloud_wire", "mix_wire")])

    p0 = nested({k: jnp.asarray(v) for k, v in params_np(0).items()})
    for case, _ in STAR:
        run(case, Topology.star(), mesh4, p0, (4,),
            ("tokens", "sizes", "resources"))
    pods = jax.tree.map(lambda a: jnp.stack([a, a]), p0)
    run(HIER[0], Topology.hier(HIER[1]["sync_every"]), mesh22, pods,
        (2, 2), ("tokens", "sizes"))
    nodes = nested({k: jnp.stack([params_np(10 + c)[k] for c in range(4)])
                    for k in LEAVES})
    for case, graph, _ in GOSSIP:
        topo = (Topology.gossip() if graph == "ring"
                else Topology.gossip(expander_graph(4)))
        run(case, topo, mesh4, nodes, (4,), ("tokens",))
    np.savez(path, **out)


def _leaves_np(tree):
    """``jax.tree.leaves`` of a numpy tree (dict keys sorted)."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves_np(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [a for v in tree for a in _leaves_np(v)]
    return [] if tree is None else [np.asarray(tree)]


# ---------------------------------------------------------------------------
# the port: one rank of the 4-rank gloo group
# ---------------------------------------------------------------------------

def rank_main(rank, world, init_method, out_dir):
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.convert import store_to_jax
    from repro_torch.core import aggregation
    from repro_torch.core import engine as ET
    from repro_torch.core.engine import Topology, expander_graph, \
        make_round_engine
    from repro_torch.core.types import FLConfig
    from repro_torch.launch.mesh import init_ranks, make_host_mesh
    from repro_torch.models.model import Model

    dev = init_ranks("gloo", "cpu", rank, world, init_method, timeout=120)
    ET.PRNGKey = NumpyKey.seed
    model = Model(get_arch("paper_lm"))
    model.defs = {k: model.defs[k] for k in LEAVES}
    model.loss = loss_t
    mesh4 = make_host_mesh(device=dev)                      # (data 4, model 1)
    mesh22 = make_host_mesh(pod=2, data=2, device=dev)
    out = {}

    def tensors(tree):
        return _leaves_np(store_to_jax(tree))

    def run(case, topo, mesh, params, lead, keys):
        eng = make_round_engine(model, FLConfig(**fl_kw(case)), topo,
                                mesh=mesh, chunk=S)
        st = eng.state_from_params(
            {k: torch.from_numpy(v) for k, v in params.items()})
        aggregation.COLLECTIVES.clear()
        ms, marks = [], []
        for r in range(ROUNDS):
            b = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                     else v)
                 for k, v in batch_np(lead, r).items() if k in keys}
            st, m = eng.round_fn(st, eng.local_batch(b))
            ms.append(m)
            marks.append(len(aggregation.COLLECTIVES))
        for name in ("params", "comm_state", "control", "client_controls"):
            v = getattr(st, name)
            if isinstance(v, dict):
                v = tuple(v.values())
            for i, a in enumerate(tensors(v) if v is not None else []):
                out[f"{case}/{name}/{i}"] = a
        for k in ("loss", "selected", "pod_divergence", "consensus"):
            if k in ms[0]:
                out[f"{case}/{k}"] = np.stack([m[k].numpy() for m in ms])
        for f in ms[0]["ledger"].fields():
            out[f"{case}/ledger/{f}"] = np.stack(
                [getattr(m["ledger"], f).numpy() for m in ms])
        if "round_stats" in ms[0]:
            for f in ms[0]["round_stats"].fields():
                out[f"{case}/rs/{f}"] = np.stack(
                    [getattr(m["round_stats"], f).numpy() for m in ms])
        recs = aggregation.COLLECTIVES
        rounds = np.searchsorted(np.asarray(marks), np.arange(len(recs)),
                                 side="right")
        out[f"{case}/coll/hop"] = np.asarray([r.hop for r in recs])
        out[f"{case}/coll/op"] = np.asarray([r.op for r in recs])
        out[f"{case}/coll/dtype"] = np.asarray([str(r.dtype) for r in recs])
        out[f"{case}/coll/nbytes"] = np.asarray([r.nbytes for r in recs])
        out[f"{case}/coll/numel"] = np.asarray(
            [r.nbytes // torch.empty((), dtype=r.dtype).element_size()
             for r in recs])
        out[f"{case}/coll/round"] = rounds

    p0 = params_np(0)
    for case, _ in STAR + (("star_ef_secagg", None),):
        run(case, Topology.star(), mesh4, p0, (4,),
            ("tokens", "sizes", "resources"))
    for case in (HIER[0], "hier_secagg", "hier_tele"):
        run(case, Topology.hier(HIER[1]["sync_every"]), mesh22, p0, (2, 2),
            ("tokens", "sizes"))
    node = params_np(10 + rank)
    for case, graph, _ in GOSSIP + (("gossip_ring_secagg", "ring", None),
                                    ("gossip_ring_tele", "ring", None)):
        topo = (Topology.gossip() if graph == "ring"
                else Topology.gossip(expander_graph(4)))
        run(case, topo, mesh4, node, (4,), ("tokens",))
    # the train CLI's rank body (--nproc 4 --device cpu --dist-backend
    # gloo) inside this group: the star and --hierarchical
    import contextlib
    import io

    from repro_torch.launch import train
    for kind, extra in CLI_RUNS:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            train.main(CLI + extra)
        out[f"cli/{kind}"] = np.asarray(text.getvalue())
    out["device"] = np.asarray(str(dev))
    out["coords"] = np.asarray([mesh22.axis_index("pod"),
                                mesh22.axis_index("data")])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        ref_main(sys.argv[2])
    else:
        raise SystemExit(f"unknown command {sys.argv[1:]}")
