"""Decentralized / peer-to-peer FL, each node a rank of the ``data`` axis —
the ``Topology.gossip`` binding of the round engine (port of
``repro.core.gossip``).

No central server: every node keeps its own model, and each round does a
local SGD step followed by gossip mixing with its graph neighbours, the
payloads sent point to point (``ppermute`` semantics: one send per directed
edge, zeros where no edge arrives).  BrainTorrent / P2P-FL mix
uncompressed; QuanTimed-DSGD mixes quantized models (``qsgd8``: int8 on
the wire).  Biased pipelines gossip with error feedback, each node's
residual in its own pipeline row.  The mixing matrix (default: the ring,
W = I/2 + (L + R)/4) must be doubly stochastic; ``Topology.gossip``
takes ring offsets and permutations (``engine.expander_graph``,
``engine.erdos_renyi_graph``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.engine import Topology, make_round_engine
from repro_torch.core.types import FLConfig
from repro_torch.models.model import Model


@dataclasses.dataclass
class GossipStep:
    init_fn: Any
    step_fn: Any
    local_batch: Any        # (C, ...) batch -> this rank's node
    n_clients: int
    terms: dict = None
    engine: Any = None      # the underlying RoundEngine (for run_rounds)


def make_gossip_step(model: Model, fl: FLConfig, mesh,
                     chunk: int = 512) -> GossipStep:
    engine = make_round_engine(model, fl, Topology.gossip(), chunk=chunk,
                               mesh=mesh)
    return GossipStep(init_fn=engine.init_fn, step_fn=engine.round_fn,
                      local_batch=engine.local_batch,
                      n_clients=engine.n_clients, terms=engine.terms,
                      engine=engine)
