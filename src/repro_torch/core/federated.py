"""``make_fl_train_step``: one FL round on the **star** topology, each
client a rank of the mesh (port of ``repro.core.federated``), as a thin
binding over the round engine: local updating (FedAvg E epochs / FedSGD /
FedProx / SCAFFOLD), client selection, the collective aggregation of the
encoded payloads (:mod:`repro_torch.core.aggregation`), the server
optimizer and the ledger all live in :mod:`repro_torch.core.engine`.

Batch layout (client-major; ``C`` = the clients on the mesh), as in the
reference, cut to a rank's part by ``engine.local_batch``:
  tokens/labels/mask : (C, B_local, S)
  sizes              : (C,)      client dataset sizes (FedAvg weighting)
  resources          : (C, 4)    simulated device profile (FedMCCS)
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.engine import Topology, make_round_engine
from repro_torch.core.types import FLConfig
from repro_torch.models.model import Model


@dataclasses.dataclass
class FLTrainStep:
    init_fn: Any            # seed -> this rank's FLState
    step_fn: Any            # (state, local batch) -> (state, metrics)
    local_batch: Any        # global batch -> this rank's part
    n_clients: int
    terms: dict
    engine: Any = None      # the underlying RoundEngine (for run_rounds)


def make_fl_train_step(model: Model, fl: FLConfig, mesh,
                       chunk: int = 512) -> FLTrainStep:
    engine = make_round_engine(model, fl, Topology.star(model.cfg.client_axis),
                               chunk=chunk, mesh=mesh)
    return FLTrainStep(init_fn=engine.init_fn, step_fn=engine.round_fn,
                       local_batch=engine.local_batch,
                       n_clients=engine.n_clients, terms=engine.terms,
                       engine=engine)
