"""Hierarchical FL: client -> edge (pod) -> cloud (cross-pod), each client
a rank of a (pod, data) mesh — the ``Topology.hier`` binding of the round
engine (port of ``repro.core.hierarchical``).

Hier-Local-QSGD and FedPAQ's periodic averaging on the pod mesh: every
round the clients of a pod aggregate over its ``data`` group (the edge
hop), and every ``sync_every`` rounds the per-pod models also average
over the ``pod`` groups with their own compressor (``pod_compressor``,
the cloud hop).  The edge hop runs the full uplink pipeline statefully:
each rank keeps its own EF / DGC row.  Between cloud syncs the pods'
models diverge, so each rank holds its pod's params and server-optimizer
state.  The factory exposes the edge-only and the edge+cloud programs
separately; the engine's ``round_fn`` alternates them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.engine import Topology, make_round_engine
from repro_torch.core.types import FLConfig
from repro_torch.models.model import Model


@dataclasses.dataclass
class HierFLStep:
    init_fn: Any
    step_edge: Any          # every round
    step_cloud: Any         # every sync_every rounds (edge + pod sync)
    local_batch: Any        # (G, Ce, ...) batch -> this rank's client
    n_pods: int
    clients_per_pod: int
    terms: dict
    engine: Any = None      # the underlying RoundEngine (for run_rounds)


def make_hier_fl_train_step(model: Model, fl: FLConfig, mesh,
                            chunk: int = 512) -> HierFLStep:
    engine = make_round_engine(model, fl, Topology.hier(fl.sync_every),
                               chunk=chunk, mesh=mesh)
    return HierFLStep(init_fn=engine.init_fn,
                      step_edge=engine.programs["edge"],
                      step_cloud=engine.programs["cloud"],
                      local_batch=engine.local_batch,
                      n_pods=engine.aux["n_pods"],
                      clients_per_pod=engine.aux["clients_per_pod"],
                      terms=engine.terms, engine=engine)
