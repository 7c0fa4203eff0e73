"""Single-device FL simulator — the ``Topology.sim`` binding of the round
engine (port of ``repro.core.simulate``): clients run one after another on
one card, decoupled from any mesh."""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.engine import Topology, make_round_engine
from repro_torch.core.types import FLConfig
from repro_torch.models.model import Model


@dataclasses.dataclass
class SimFL:
    init_fn: Any
    step_fn: Any           # (state, batch) -> (state, metrics)
    n_clients: int
    terms: dict
    engine: Any = None


def make_sim_step(model: Model, fl: FLConfig, n_clients: int,
                  chunk: int = 64, device=None) -> SimFL:
    engine = make_round_engine(model, fl, Topology.sim(n_clients),
                               chunk=chunk, device=device)
    return SimFL(init_fn=engine.init_fn, step_fn=engine.round_fn,
                 n_clients=engine.n_clients, terms=engine.terms,
                 engine=engine)

